"""The port's train-mode BN and training loss against the JAX package, on
the CPU, at f32, on inputs drawn with numpy from fixed seeds.

Tolerances:
- BN in train mode, alone: output, input and parameter gradients, and the
  new running statistics within 1e-5 (rtol and atol).  In ConvBN and
  CoorAttention (whose BN normalises a (B, C, H + W, 1) map): 1e-4, the
  convolutions' summation order (as in test_torch_modules.py).
- The BCE family and `targets_from_flat`: within 1e-6.
- `ComputeLoss` on random raw heads and targets (padded rows and one
  zero-width real row in every case): total and items within 1e-5
  relative; d total / d raw within 1e-5 scaled by 1 + max |d total / d raw|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.nn import blocks as jb
from dmayolo_tpu.nn import primitives as jp
from dmayolo_tpu.nn.module import make_vars
from dmayolo_tpu.train import loss as jl
from dmayolo_tpu_torch.nn import blocks as pb
from dmayolo_tpu_torch.nn import primitives as pp
from dmayolo_tpu_torch.train import loss as pl
from dmayolo_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax


def random_vars(jmod, seed=0):
    rng = np.random.default_rng(seed)
    pshape, sshape = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    params, stats = {}, {}
    for k, s in pshape.items():
        if k[-1] == "kernel":
            v = rng.normal(0, int(np.prod(s.shape[:-1])) ** -0.5, s.shape)
        elif k[-1] == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0, 0.5, s.shape)
        params[k] = jnp.asarray(v.astype(np.float32))
    for k, s in sshape.items():
        v = rng.uniform(0.5, 1.5, s.shape) if k[-1] == "var" else rng.normal(0, 0.2, s.shape)
        stats[k] = jnp.asarray(v.astype(np.float32))
    return params, stats


TRAIN_MODULES = [
    ("batchnorm", lambda: jp.BatchNorm2d(8), lambda: pp.BatchNorm2d(8), (4, 6, 5, 8), 1e-5),
    ("convbn", lambda: jb.ConvBN(8, 16, 3, 1), lambda: pb.ConvBN(8, 16, 3, 1), (2, 10, 10, 8),
     1e-4),
    ("coorattention", lambda: jb.CoorAttention(16, 16), lambda: pb.CoorAttention(16, 16),
     (2, 6, 10, 16), 1e-4),
]


@pytest.mark.parametrize("name,jfac,pfac,shape,tol", TRAIN_MODULES,
                         ids=[m[0] for m in TRAIN_MODULES])
def test_train_mode_matches_jax(name, jfac, pfac, shape, tol):
    """Output, d(sum(out * w)) / d(input, params) and the running stats."""
    jmod, pmod = jfac(), pfac()
    params, stats = random_vars(jmod)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)

    def jfwd(p, xin):
        v = make_vars(p, stats, train=True)
        return jmod(v, xin), v.ctx.stats_out

    want, new_stats = jfwd(params, jnp.asarray(x))
    w = rng.normal(size=want.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, xin: jnp.sum(jfwd(p, xin)[0] * w), argnums=(0, 1))(
        params, jnp.asarray(x))

    pmod.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    pmod.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = pmod(xt, torch.float32)
    (out * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(rtol=tol, atol=tol)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), **tol)
    grads = {k: p.grad for k, p in pmod.named_parameters()}
    got_gp, _ = jax_from_state_dict(pmod, {**pmod.state_dict(), **grads})
    assert set(got_gp) == set(gp)
    for k in gp:
        np.testing.assert_allclose(got_gp[k], np.asarray(gp[k]), **tol, err_msg=str(k))
    _, got_stats = jax_from_state_dict(pmod)
    assert set(got_stats) == set(new_stats) and new_stats
    for k in new_stats:
        np.testing.assert_allclose(got_stats[k], np.asarray(new_stats[k]), **tol, err_msg=str(k))


def test_bn_eval_mode_leaves_stats():
    bn = pp.BatchNorm2d(4).eval()
    bn(torch.randn(2, 4, 3, 3), torch.float32)
    assert torch.equal(bn.running_mean, torch.zeros(4)) and torch.equal(bn.running_var,
                                                                        torch.ones(4))


def test_bce_family_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (64, 10)).astype(np.float32)
    t = rng.uniform(size=(64, 10)).astype(np.float32)
    lab = (rng.uniform(size=(64, 10)) < 0.3).astype(np.float32)
    jx, jt, jlab = jnp.asarray(logits), jnp.asarray(t), jnp.asarray(lab)
    px, pt, plab = torch.from_numpy(logits), torch.from_numpy(t), torch.from_numpy(lab)
    pairs = [
        (jl.bce_with_logits(jx, jt, 0.7), pl.bce_with_logits(px, pt, 0.7)),
        (jl.focal_bce_with_logits(jx, jt, 1.5, pos_weight=1.2),
         pl.focal_bce_with_logits(px, pt, 1.5, pos_weight=1.2)),
        (jl.bce_blur_with_logits(jx, jt), pl.bce_blur_with_logits(px, pt)),
        (jl.qfocal_bce_with_logits(jx, jt), pl.qfocal_bce_with_logits(px, pt)),
        (jl.varifocal_with_logits(jx, jt, jlab), pl.varifocal_with_logits(px, pt, plab)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert pl.smooth_bce(0.1) == jl.smooth_bce(0.1)


def test_targets_from_flat_matches_jax():
    rng = np.random.default_rng(3)
    flat = np.concatenate([rng.integers(0, 3, (20, 1)), rng.integers(0, 10, (20, 1)),
                           rng.uniform(size=(20, 4))], 1).astype(np.float32)
    want = jl.targets_from_flat(flat, 3, 6)
    got = pl.targets_from_flat(flat, 3, 6)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


ANCHORS = np.array([[[1.25, 1.625], [2.0, 3.75], [4.125, 2.875]],
                    [[1.875, 3.8125], [3.875, 2.8125], [3.6875, 7.4375]],
                    [[3.625, 2.8125], [4.875, 6.1875], [11.65625, 10.1875]]], np.float32)
HYP = {"box": 0.05, "obj": 1.0, "cls": 0.5, "cls_pw": 1.0, "obj_pw": 1.0, "anchor_t": 4.0,
       "label_smoothing": 0.0, "fl_gamma": 0.0}


def loss_inputs(nc, seed=5, b=2, m=12):
    """Raw heads of a 64 px input (8x8, 4x4 and 2x2 grids, 3 anchors) and
    dense targets: rows 9-11 padded, row 0 of image 1 a real 0-wide box."""
    rng = np.random.default_rng(seed)
    raw = [rng.normal(0, 1.5, (b, g, g, 3, 5 + nc)).astype(np.float32) for g in (8, 4, 2)]
    cls = rng.integers(0, nc, (b, m)).astype(np.float32)
    box = np.concatenate([rng.uniform(0.02, 0.98, (b, m, 2)), rng.uniform(0.02, 0.5, (b, m, 2))],
                         -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[:, 9:] = False
    cls[:, 9:], box[:, 9:] = 0, 0
    box[1, 0, 2] = 0.0
    return raw, (cls, box, mask)


LOSS_CASES = [  # (iou_variant, fl_gamma, nc, label_smoothing)
    ("SIoU", 0.0, 10, 0.0),
    ("CIoU", 0.0, 10, 0.0),
    ("SIoU", 1.5, 10, 0.0),
    ("SIoU", 0.0, 1, 0.0),
    ("SIoU", 0.0, 10, 0.1),
    ("CIoU", 1.5, 1, 0.1),
]


@pytest.mark.parametrize("variant,fl_gamma,nc,smooth", LOSS_CASES,
                         ids=["-".join(map(str, c)) for c in LOSS_CASES])
def test_compute_loss_matches_jax(variant, fl_gamma, nc, smooth):
    raw, (cls, box, mask) = loss_inputs(nc)
    hyp = dict(HYP, fl_gamma=fl_gamma, label_smoothing=smooth)
    jloss = jl.ComputeLoss(ANCHORS, hyp, nc, iou_variant=variant)
    jt = jl.Targets(jnp.asarray(cls), jnp.asarray(box), jnp.asarray(mask))
    (want, want_items), want_g = jax.value_and_grad(lambda r: jloss(r, jt), has_aux=True)(
        [jnp.asarray(r) for r in raw])

    ploss = pl.ComputeLoss(ANCHORS, hyp, nc, iou_variant=variant)
    pr = [torch.from_numpy(r).requires_grad_(True) for r in raw]
    got, got_items = ploss(pr, pl.Targets(*(torch.from_numpy(a) for a in (cls, box, mask))))
    got.backward()
    assert np.isfinite(float(want)) and float(want_items["box"]) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(float(torch.as_tensor(got_items[k]).detach()), float(want_items[k]), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    for g, w in zip(pr, want_g):
        w = np.asarray(w)
        scale = 1 + np.abs(w).max()
        assert np.abs(g.grad.numpy() - w).max() <= 1e-5 * scale


def test_degenerate_label_fails_the_anchor_gate():
    """A real 0-wide label yields no candidate and no NaN (sanitised after
    the gate), as in the JAX package."""
    _, (cls, box, mask) = loss_inputs(10)
    ploss = pl.ComputeLoss(ANCHORS, HYP, 10)
    t = pl.Targets(*(torch.from_numpy(a) for a in (cls, box, mask)))
    for i, g in enumerate((8, 4, 2)):
        cand = ploss._build_targets_level(t, i, g, g)
        k = cand["mask"].reshape(2, 12, -1)
        assert k[1, 0].sum() == 0 and k[:, 9:].sum() == 0
        assert torch.isfinite(cand["tbox"]).all()
