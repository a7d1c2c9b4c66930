"""The port's IoU family and variant NMS against the JAX package, on the CPU.

Boxes are drawn with numpy from fixed seeds: overlapping, disjoint, nested
and zero-width pairs.  Tolerances, f32: `bbox_iou` values (every variant,
and alpha-IoU), `box_iou_matrix` and `wh_iou` within 1e-6 (rtol and atol;
the two libraries' arctan, arcsin, cos and exp differ by an ulp or two);
the SIoU and CIoU gradients through autograd against `jax.grad` within
1e-5 (rtol and atol), on the pairs with no zero-width box, where the
derivatives are finite; `nms_variant_single`: the same keep indices and
flags for every variant.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.core import iou as jiou
from dmayolo_tpu.core.nms import NEG_INF, nms_variant_single as jax_nms_variant
from dmayolo_tpu_torch.core import iou as piou
from dmayolo_tpu_torch.core.nms import nms_variant_single

VARIANTS = ["IoU", "GIoU", "DIoU", "CIoU", "SIoU", "EIoU"]


def box_pairs(n=400, seed=0):
    """(n, 4) xyxy pairs: a quarter each overlapping, disjoint, nested, and
    with one zero-width box."""
    rng = np.random.default_rng(seed)
    q = n // 4
    xy1 = rng.uniform(0, 50, (n, 2))
    wh1 = rng.uniform(1, 30, (n, 2))
    b1 = np.concatenate([xy1, xy1 + wh1], 1)
    shift = np.concatenate([rng.uniform(-0.5, 0.5, (q, 2)) * wh1[:q],      # overlapping
                            rng.uniform(31, 60, (q, 2)),                     # disjoint
                            np.zeros((n - 2 * q, 2))], 0)
    wh2 = np.concatenate([rng.uniform(1, 30, (2 * q, 2)),
                          wh1[2 * q:3 * q] * rng.uniform(0.2, 0.9, (q, 2)),  # nested
                          rng.uniform(1, 30, (n - 3 * q, 2))], 0)
    xy2 = xy1 + shift
    xy2[2 * q:3 * q] += (wh1[2 * q:3 * q] - wh2[2 * q:3 * q]) * rng.uniform(0, 1, (q, 2))
    xy2[3 * q:] += rng.uniform(-10, 10, (n - 3 * q, 2))
    wh2[3 * q:, 0] = 0.0  # zero width
    b2 = np.concatenate([xy2, xy2 + wh2], 1)
    return b1.astype(np.float32), b2.astype(np.float32)


def _flags(variant):
    return {} if variant == "IoU" else {variant: True}


@pytest.mark.parametrize("xywh", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bbox_iou_matches_jax(variant, xywh):
    b1, b2 = box_pairs()
    if xywh:
        b1 = np.concatenate([(b1[:, :2] + b1[:, 2:]) / 2, b1[:, 2:] - b1[:, :2]], 1)
        b2 = np.concatenate([(b2[:, :2] + b2[:, 2:]) / 2, b2[:, 2:] - b2[:, :2]], 1)
    want = np.asarray(jiou.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh,
                                    **_flags(variant)))
    got = piou.bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), xywh=xywh,
                        **_flags(variant)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_alpha_iou_matches_jax():
    b1, b2 = box_pairs(seed=1)
    want = np.asarray(jiou.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), alpha=3.0))
    got = piou.bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), alpha=3.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["SIoU", "CIoU"])
def test_bbox_iou_grad_matches_jax(variant):
    b1, b2 = box_pairs(seed=2)
    b1, b2 = b1[:300], b2[:300]  # no zero-width box
    flags = {variant: True}
    want = jax.grad(lambda a, b: jnp.sum(jiou.bbox_iou(a, b, xywh=True, **flags)),
                    argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    t1, t2 = (torch.from_numpy(b).requires_grad_(True) for b in (b1, b2))
    piou.bbox_iou(t1, t2, xywh=True, **flags).sum().backward()
    for g, w in zip((t1.grad, t2.grad), want):
        assert np.isfinite(np.asarray(w)).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_box_iou_matrix_and_wh_iou_match_jax():
    b1, b2 = box_pairs(n=64, seed=3)
    want = np.asarray(jiou.box_iou_matrix(jnp.asarray(b1), jnp.asarray(b2)))
    got = piou.box_iou_matrix(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    assert got.shape == (64, 64)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    wh1, wh2 = b1[:, 2:] - b1[:, :2], (b2[:, 2:] - b2[:, :2])[:40]
    want = np.asarray(jiou.wh_iou(jnp.asarray(wh1), jnp.asarray(wh2)))
    got = piou.wh_iou(torch.from_numpy(wh1), torch.from_numpy(wh2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
def test_nms_variant_single_matches_jax(variant):
    """200 candidates in 8 clusters, a tenth of them dropped (NEG_INF),
    scores without ties; 60 steps run past the last valid pick."""
    rng = np.random.default_rng(4)
    centres = rng.uniform(20, 200, (8, 2))
    c = centres[rng.integers(0, 8, 200)] + rng.normal(0, 4, (200, 2))
    wh = rng.uniform(20, 40, (200, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.permutation(200).astype(np.float32) / 200 + 0.01
    scores[rng.uniform(size=200) < 0.1] = NEG_INF
    want = jax.jit(lambda b, s: jax_nms_variant(b, s, 0.45, 60, class_nms=variant))(
        jnp.asarray(boxes), jnp.asarray(scores))
    got = nms_variant_single(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 60,
                             class_nms=variant)
    w_idx, w_valid = (np.asarray(a) for a in want)
    assert 0 < w_valid.sum() < 60
    np.testing.assert_array_equal(got[1].numpy(), w_valid)
    np.testing.assert_array_equal(got[0].numpy()[w_valid], w_idx[w_valid])
