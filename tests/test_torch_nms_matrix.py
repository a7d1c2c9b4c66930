"""The port's "matrix" NMS backend, K2's streaming path and `batched_nms`
against the JAX package on the CPU.

K3 (fixpoint keep flags): the plain versions must equal, flag for flag,
the TPU kernel body of experiments/exp_pallas_fixpoint.py run in interpret
mode (divide-free form) and the JAX `_fixpoint_keep_boxes` /
`_fixpoint_keep(_pairwise_iou(...))` (both forms).

`nms_matrix`, `nms_matrix_blocked`: `keep_valid` and `keep_idx` exactly
equal to the JAX functions, in every slot.  K2 streaming's plain path
(K > 1024): every slot equal to `pallas_batched_nms_core(interpret=True)`.

`batched_nms`: the same detections in the valid slots as the JAX function
(boxes within 1e-5, and 1e-6 relative for merged boxes, whose weighted
means sum in another order; scores and classes exact), the same source
rows.  The invalid slots may differ: the port's "scan" fills them with
the unpicked indices, as K2 does.  At bf16 with `merge`: f32 dets, the
same detection set, boxes within 1e-3 px.

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dmayolo_tpu.core import nms as jnms
from dmayolo_tpu.core.pallas_nms import pallas_batched_nms_core
from dmayolo_tpu_torch.core import nms as tnms
from dmayolo_tpu_torch.core.fixpoint_kernel import MAX_K, fixpoint_keep
from dmayolo_tpu_torch.core.nms_kernel import NEG_INF, nms_greedy, nms_greedy_stream

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "experiments"))
import exp_pallas_fixpoint  # noqa: E402  (imports exp_serve_decomp from there)


def _candidates(kind: str, b: int, k: int, seed: int):
    """Rank-sorted candidates: boxes (b, k, 4), scores (b, k) descending
    with NEG_INF for dropped ones."""
    rng = np.random.default_rng(seed)
    if kind == "clustered":  # near-duplicates around a few centres: deep chains
        centres = rng.uniform(50, 400, (b, 6, 2))
        pick = rng.integers(0, 6, (b, k))
        c = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 4, (b, k, 2))
        wh = rng.uniform(30, 60, (b, k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    elif kind == "threshold":
        # pairs of 10 x 10 boxes shifted by d along x, on a grid 20 px
        # apart: IoU (10 - d) / (10 + d) within a few ulps of 0.45
        pair = np.arange(k) // 2
        d = 10 * (1 - 0.45) / (1 + 0.45) + rng.integers(-20, 21, (b, k)) * 2e-6
        x1 = (pair % 16) * 20.0 + (np.arange(k) % 2) * d
        y1 = np.broadcast_to((pair // 16) * 20.0, (b, k))
        boxes = np.stack([x1, y1, x1 + 10, y1 + 10], -1)
    else:
        xy1 = rng.uniform(0, 500, (b, k, 2))
        boxes = np.concatenate([xy1, xy1 + rng.uniform(4, 150, (b, k, 2))], -1)
    scores = rng.uniform(0.001, 1.0, (b, k))
    if kind == "ties":
        scores = np.round(scores * 8) / 8
    scores = -np.sort(-scores, axis=1)
    scores[scores < 0.3] = NEG_INF
    if kind == "masked_rows":
        scores[1:] = NEG_INF
    return boxes.astype(np.float32), scores.astype(np.float32)


def _tpu_kernel_interpret(boxes, scores, thr):
    """The TPU kernel body, run by Pallas' interpreter with plain BlockSpecs."""
    b, k, _ = boxes.shape
    spec = pl.BlockSpec((1, 1, k), lambda i: (i, 0, 0))
    call = pl.pallas_call(
        functools.partial(exp_pallas_fixpoint._fixpoint_nms_kernel, iou_thres=thr),
        out_shape=jax.ShapeDtypeStruct((b, 1, k), jnp.float32), grid=(b,),
        in_specs=[pl.BlockSpec((1, 4, k), lambda i: (i, 0, 0)), spec],
        out_specs=spec, interpret=True)
    keep = call(jnp.asarray(boxes).transpose(0, 2, 1), jnp.asarray(scores)[:, None, :])
    return np.asarray(keep[:, 0, :] > 0.5)


K3_CASES = [("random", 2, 512, 0), ("clustered", 2, 512, 1), ("ties", 2, 512, 2),
            ("masked_rows", 2, 512, 3), ("random", 2, 77, 4), ("threshold", 2, 512, 5)]


@pytest.mark.parametrize("kind,b,k,seed", K3_CASES)
def test_fixpoint_plain_matches_tpu_kernel_and_jax(kind, b, k, seed):
    boxes, scores = _candidates(kind, b, k, seed)
    jb, jv = jnp.asarray(boxes), jnp.asarray(scores) > NEG_INF / 2
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(scores) > NEG_INF / 2
    thr = 0.45
    # divide-free form: the TPU kernel and the JAX fused-S function
    got = fixpoint_keep(tb, tv, thr, divide=False)
    assert got.dtype == torch.bool and got.shape == (b, k)
    np.testing.assert_array_equal(got.numpy(), _tpu_kernel_interpret(boxes, scores, thr))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnms._fixpoint_keep_boxes(jb, jv, thr)))
    # divide form: the blocked path's _fixpoint_keep over _pairwise_iou
    got = fixpoint_keep(tb, tv, thr, divide=True)
    want = jnms._fixpoint_keep(jnms._pairwise_iou(jb, jb), jv, thr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "masked_rows":
        assert not got[1:].any()


def test_fixpoint_keep_is_greedy():
    """The fixpoint's keep set is greedy NMS's pick set."""
    boxes, scores = _candidates("clustered", 3, 300, 7)
    keep = fixpoint_keep(torch.from_numpy(boxes), torch.from_numpy(scores) > NEG_INF / 2,
                         0.45, divide=True)
    idx, valid = nms_greedy(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 300)
    for i in range(3):
        assert set(idx[i][valid[i]].tolist()) == set(keep[i].nonzero()[:, 0].tolist())


def _assert_keep_equal(got, want):
    gi, gv = (t.numpy() for t in got)
    wi, wv = (np.asarray(a) for a in want)
    assert gi.dtype == np.int32 and gi.shape == wi.shape
    np.testing.assert_array_equal(gv, wv)
    # every slot: kept by descending score, lowest index first on ties
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("kind,k,seed", [("random", 77, 0), ("clustered", 300, 1),
                                         ("ties", 512, 2), ("random", 1100, 3),
                                         ("clustered", 1100, 4)])
def test_nms_matrix_matches_jax(kind, k, seed):
    boxes, scores = _candidates(kind, 2, k, seed)
    got = tnms.nms_matrix(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 300)
    want = jnms.nms_matrix(jnp.asarray(boxes), jnp.asarray(scores), 0.45, 300)
    _assert_keep_equal(got, want)


def test_nms_matrix_blocked_matches_jax_with_ragged_tail():
    boxes, scores = _candidates("random", 3, 700, 11)  # 5 blocks of 128 + 60
    got = tnms.nms_matrix_blocked(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  0.45, 300, block=128)
    want = jnms.nms_matrix_blocked(jnp.asarray(boxes), jnp.asarray(scores), 0.45, 300,
                                   block=128)
    _assert_keep_equal(got, want)


def test_nms_matrix_blocked_cross_block_chain():
    """A 1/3-overlap chain across blocks of 32 resolves as greedy NMS does."""
    k = 96
    i = np.arange(k, dtype=np.float32)
    boxes = np.stack([i * 5, np.zeros(k), i * 5 + 10, np.full(k, 10.0)], -1)[None]
    scores = np.linspace(1, 0.5, k, dtype=np.float32)[None]
    got = tnms.nms_matrix_blocked(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  0.3, k, block=32)
    want = jnms.nms_matrix_blocked(jnp.asarray(boxes), jnp.asarray(scores), 0.3, k,
                                   block=32)
    _assert_keep_equal(got, want)
    greedy = jnms.nms_single(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.3, k)
    np.testing.assert_array_equal(got[0][0][got[1][0]].numpy(),
                                  np.asarray(greedy[0])[np.asarray(greedy[1])])
    assert int(got[1].sum()) == k // 2  # every second box of the chain


@pytest.mark.parametrize("kind,seed", [("random", 0), ("clustered", 1)])
def test_nms_stream_plain_matches_pallas(kind, seed):
    boxes, scores = _candidates(kind, 2, 1500, seed)
    want_idx, want_valid = pallas_batched_nms_core(
        jnp.asarray(boxes), jnp.asarray(scores), iou_thres=0.6, max_det=300,
        interpret=True)
    for fn in (nms_greedy, nms_greedy_stream):  # the router and the variant
        got_idx, got_valid = fn(torch.from_numpy(boxes), torch.from_numpy(scores), 0.6, 300)
        np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        fixpoint_keep(torch.zeros(2, 8, 3), torch.ones(2, 8, dtype=torch.bool), 0.5)
    with pytest.raises(TypeError):
        fixpoint_keep(torch.zeros(2, 8, 4), torch.ones(2, 8), 0.5)
    with pytest.raises(ValueError):
        fixpoint_keep(torch.zeros(2, 8, 4, device="meta"),
                      torch.ones(2, 8, dtype=torch.bool, device="meta"), 0.5)
    with pytest.raises(ValueError):
        nms_greedy_stream(torch.zeros(2, 8, 4, device="meta"), torch.zeros(2, 8, device="meta"))
    assert MAX_K == 512


def _prediction(b, n, nc, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(100, 500, (b, n, 2))
    wh = rng.uniform(8, 60, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1))
    cls = rng.dirichlet(np.ones(nc) * 0.3, size=(b, n))
    return np.concatenate([xy, wh, obj, cls], 2).astype(np.float32)


BATCHED = [
    dict(multi_label=False),
    dict(multi_label=True),
    dict(multi_label=False, class_mask=[1, 0, 1, 1, 0, 1, 1, 1, 0, 1]),
    dict(multi_label=True, class_mask=[1, 0, 1, 1, 0, 1, 1, 1, 0, 1]),
    dict(multi_label=True, agnostic=True),
    dict(multi_label=False, merge=True),
    dict(multi_label=True, merge=True, max_nms=2000),
]


@pytest.mark.parametrize("backend", ["scan", "matrix"])
@pytest.mark.parametrize("kw", BATCHED, ids=lambda kw: "-".join(f"{k}" for k in kw))
def test_batched_nms_matches_jax(kw, backend):
    pred = _prediction(2, 700, 10, 3)
    kw = dict(kw)
    mask = kw.pop("class_mask", None)
    common = dict(conf_thres=0.05, iou_thres=0.45, max_det=300, return_src=True, **kw)
    jd, jv, js = (np.asarray(a) for a in jnms.batched_nms(
        jnp.asarray(pred), class_mask=None if mask is None else jnp.asarray(mask, bool),
        backend=backend, **common))
    td, tv, ts = tnms.batched_nms(
        torch.from_numpy(pred), class_mask=None if mask is None else torch.tensor(mask).bool(),
        backend=backend, **common)
    td, tv, ts = td.numpy(), tv.numpy(), ts.numpy()
    assert td.shape == jd.shape and ts.dtype == np.int32
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > 0
    # merged boxes are weighted means summed in another order: 1e-6 relative
    np.testing.assert_allclose(td[tv][:, :4], jd[jv][:, :4], rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(td[tv][:, 4:], jd[jv][:, 4:])
    np.testing.assert_array_equal(ts[tv], js[jv])
    assert not td[~tv].any()
    if mask is not None:
        assert np.asarray(mask, bool)[td[tv][:, 5].astype(int)].all()


def test_batched_nms_backends_agree():
    """"pallas" (K2, streaming above 1024 candidates), "scan" and "matrix"
    (blocked above 512) give the same detections."""
    pred = torch.from_numpy(_prediction(2, 400, 10, 5))
    outs = [tnms.batched_nms(pred, conf_thres=0.01, iou_thres=0.6, multi_label=True,
                             backend=b) for b in ("pallas", "scan", "matrix")]
    for d, v in outs[1:]:
        assert torch.equal(v, outs[0][1]) and torch.equal(d, outs[0][0])


def test_batched_nms_merge_bf16_matches_jax():
    """merge=True on bf16 predictions: the dets come back f32 with the
    merged boxes as JAX computes them (within 1e-3 px), the same detection
    set.  Every candidate's bf16 score (obj 1.0 times its one class) is
    distinct, so no tie decides which candidates NMS keeps."""
    rng = np.random.default_rng(11)
    b, n, nc = 2, 300, 4
    grid = torch.arange(0.125, 1.0, 2 ** -9).to(torch.bfloat16).unique().float().numpy()
    pred = np.zeros((b, n, 5 + nc), np.float32)
    pred[..., :2] = rng.uniform(100, 400, (b, n, 2))
    pred[..., 2:4] = rng.uniform(20, 80, (b, n, 2))
    pred[..., 4] = 1.0
    for i in range(b):
        pred[i, np.arange(n), 5 + rng.integers(0, nc, n)] = rng.choice(grid, n, replace=False)
    pred = torch.from_numpy(pred).to(torch.bfloat16)
    common = dict(conf_thres=0.25, iou_thres=0.45, max_det=1000, merge=True, backend="scan")
    jd, jv = (np.asarray(a) for a in jnms.batched_nms(
        jnp.asarray(pred.float().numpy()).astype(jnp.bfloat16), **common))
    td, tv = tnms.batched_nms(pred, **common)
    assert jd.dtype == np.float32 and td.dtype == torch.float32
    td, tv = td.numpy(), tv.numpy()
    for i in range(b):
        want = jd[i][jv[i]][np.argsort(-jd[i][jv[i]][:, 4], kind="stable")]
        got = td[i][tv[i]][np.argsort(-td[i][tv[i]][:, 4], kind="stable")]
        assert len(want) > 10 and got.shape == want.shape
        np.testing.assert_array_equal(got[:, 4:], want[:, 4:])
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-3)
