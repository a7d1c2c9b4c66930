"""The plain versions of the port's two kernels against the JAX package's
Pallas kernels (interpret mode) on the CPU.

K2, greedy NMS: `nms_greedy` on CPU tensors must give exactly what
`pallas_batched_nms_core` gives, `keep_idx` in every slot (picks, then the
unpicked indices ascending, then padding) and `keep_valid`, and the same
picks as the scan reference `nms_single`.

K1, 3x3 conv: `conv3x3_s1` on CPU tensors against `conv3x3_s1(...,
interpret=True)` at the shapes of tests/test_pallas_conv.py: f32 within
1e-5 (summation order), bf16 outputs within 2e-2 (one bf16 rounding).
The host side of K1's tensor-core route (channel padding, K-major weight
reorder, tile plan) against the plain conv, f32 within 1e-5.  The f32
route's 3xTF32 arithmetic: the TF32 split (hi with its low 13 mantissa
bits zero, hi + lo within 2^-22 of the value), the split K-major weights
and their padding, and a torch emulation of the kernel's three-product
sum against the plain conv and the Pallas kernel, within 1e-5.

The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.core.nms import nms_single as jax_nms_single
from dmayolo_tpu.core.pallas_nms import pallas_batched_nms_core
from dmayolo_tpu.nn.pallas_conv import conv3x3_s1 as jax_conv3x3
from dmayolo_tpu_torch.core.nms import NEG_INF, nms_single
from dmayolo_tpu_torch.core.nms_kernel import MAX_K, nms_greedy
from dmayolo_tpu_torch.nn.conv3x3 import (MAX_HALO_W, TILE_ROWS, conv3x3_s1, conv3x3_s1_plain,
                                          prepare, prepare_tc, prepare_tf32x3, split_tf32)


def _candidates(kind: str, b: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        # near-duplicates around a few centres: deep suppression chains
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
        scores = np.round(scores * 8) / 8  # many equal scores: lowest index wins
    scores[scores < 0.3] = NEG_INF
    if kind == "masked_rows":
        scores[1:3] = NEG_INF
    if kind == "chain":
        boxes = np.zeros((b, k, 4))
        for i in range(k):
            boxes[:, i] = [i * 5, 0, i * 5 + 10, 10]  # 1/3 overlap chain
        scores = np.tile(np.linspace(1, 0.5, k), (b, 1))
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("kind,b,k,max_det,thr,seed", [
    ("random", 4, 128, 64, 0.45, 0),
    ("clustered", 3, 128, 64, 0.45, 1),
    ("ties", 3, 96, 48, 0.5, 2),
    ("masked_rows", 4, 64, 32, 0.45, 3),
    ("chain", 1, 64, 64, 0.3, 4),
    ("random", 2, 40, 64, 0.45, 5),  # K < max_det: padded slots
    ("random", 2, 512, 100, 0.45, 6),  # the serving K, scores unsorted
    ("clustered", 2, 1024, 100, 0.45, 7),  # the most the kernel's block holds
    # the edges of the kernel's slots a lane (128 lanes): one, two, four
    ("random", 2, 128, 100, 0.45, 10),
    ("random", 2, 129, 100, 0.45, 11),
    ("ties", 2, 200, 300, 0.5, 12),
    ("clustered", 2, 257, 100, 0.45, 13),
    ("random", 3, 31, 16, 0.45, 8),  # fewer candidates than a warp's lanes
    ("threshold", 2, 512, 300, 0.45, 9),  # IoUs within a few ulps of the threshold
])
def test_nms_plain_matches_pallas_and_scan(kind, b, k, max_det, thr, seed):
    boxes, scores = _candidates(kind, b, k, seed)
    want_idx, want_valid = pallas_batched_nms_core(
        jnp.asarray(boxes), jnp.asarray(scores), iou_thres=thr, max_det=max_det,
        interpret=True)
    got_idx, got_valid = nms_greedy(torch.from_numpy(boxes), torch.from_numpy(scores),
                                    thr, max_det)
    assert got_idx.dtype == torch.int32 and got_valid.dtype == torch.bool
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    for i in range(b):
        ri, rv = jax_nms_single(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thr, max_det)
        si, sv = nms_single(torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]),
                            thr, max_det)
        np.testing.assert_array_equal(sv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(si.numpy()[sv.numpy()], np.asarray(ri)[np.asarray(rv)])


def test_nms_all_masked_picks_nothing():
    boxes = np.random.default_rng(0).uniform(0, 100, (2, 128, 4)).astype(np.float32)
    scores = np.full((2, 128), NEG_INF, np.float32)
    idx, valid = nms_greedy(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 16)
    assert not valid.any()
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(16), (2, 1)))


def test_nms_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        nms_greedy(torch.zeros(2, 8, 3), torch.zeros(2, 8))
    with pytest.raises(ValueError):
        nms_greedy(torch.zeros(2, 8, 4, device="meta"), torch.zeros(2, 8, device="meta"))
    assert MAX_K >= 512  # the serving candidate budget fits one block


@pytest.mark.parametrize("variant", ["im2col", "sum9"])
@pytest.mark.parametrize("shape", [
    (2, 32, 32, 16, 24),
    (1, 64, 32, 8, 8),
    (2, 96, 96, 32, 32),
])
def test_conv3x3_plain_matches_pallas_f32(shape, variant):
    b, h, w, c1, c2 = shape
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, h, w, c1)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, c1, c2)) * 0.1).astype(np.float32)
    want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(wt), rh=8, variant=variant,
                                  interpret=True))
    got = conv3x3_s1(torch.from_numpy(x), torch.from_numpy(wt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, w, c2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_conv3x3_plain_matches_pallas_bf16():
    rng = np.random.default_rng(1)
    b, h, w, c = 1, 32, 32, 16
    x = jnp.asarray(rng.normal(size=(b, h, w, c)).astype(np.float32)).astype(jnp.bfloat16)
    wt = jnp.asarray((rng.normal(size=(3, 3, c, c)) * 0.1).astype(np.float32)).astype(jnp.bfloat16)
    want = np.asarray(jax_conv3x3(x, wt, rh=16, interpret=True).astype(jnp.float32))
    got = conv3x3_s1(torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16(),
                     torch.tensor(np.asarray(wt.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_conv3x3_ragged_shape_and_out_dtype():
    """Any H, W is taken (the TPU kernel asserted tile divisibility)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1, 7, 11, 5)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(size=(3, 3, 5, 6)).astype(np.float32))
    got = conv3x3_s1(x, wt, out_dtype=torch.bfloat16)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), padding=1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape", [(1, 7, 11, 5, 6), (2, 37, 53, 12, 70),
                                   (1, 5, 3, 3, 130), (2, 20, 20, 64, 64)])
def test_conv3x3_tensor_core_preparation(shape):
    """The tensor-core route's host side: the channel-padded input and the
    K-major (C2, 9, C1p) weights, through an im2col product in the kernel's
    (tap, c1) K order, give the plain conv on the original tensors; and the
    planned tiles cover every output pixel and channel exactly once."""
    b, h, w, c1, c2 = shape
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(b, h, w, c1)).astype(np.float32))
    wt = torch.from_numpy((rng.normal(size=(3, 3, c1, c2)) * 0.2).astype(np.float32))
    xp, wk, plan = prepare_tc(x, wt)
    c1p = xp.shape[3]
    assert c1p % 8 == 0 and c1p - c1 < 8 and tuple(wk.shape) == (c2, 9, c1p)
    assert xp.is_contiguous() and wk.is_contiguous()
    xpad = torch.nn.functional.pad(xp, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xpad[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 3)
    got = (cols.reshape(b * h * w, 9 * c1p) @ wk.reshape(c2, 9 * c1p).T).reshape(b, h, w, c2)
    np.testing.assert_allclose(got.numpy(), conv3x3_s1_plain(x, wt).numpy(),
                               rtol=1e-5, atol=1e-5)

    assert plan.bm in TILE_ROWS and plan.bn in (64, 128)
    assert plan.th * (plan.tw + 2) <= plan.bm and plan.tw + 2 <= MAX_HALO_W
    cover = np.zeros((b, h, w, c2), np.int32)
    for bi, h0, w0, n0 in plan.tiles():
        cover[bi, h0:h0 + plan.th, w0:w0 + plan.tw, n0:n0 + plan.bn] += 1
    assert (cover == 1).all()
    # never more tiles an image than a fixed 8x16 patch would take
    assert plan.tiles_h * plan.tiles_w <= -(-h // 8) * -(-w // 16)


@pytest.mark.parametrize("shape", [(1, 7, 11, 5, 6), (2, 20, 20, 64, 64), (1, 5, 3, 3, 130)])
def test_conv3x3_tf32x3_preparation(shape):
    """The f32 route's host side: TF32 parts of the weights (hi with its low
    13 mantissa bits zero, hi + lo within 2^-22 of w), K-major (2, C2, 9,
    C1p) with zero-filled channels, C1p a multiple of 4; x zero-padded to
    C1p; 128-row tiles."""
    b, h, w, c1, c2 = shape
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(b, h, w, c1)).astype(np.float32))
    wt = torch.from_numpy((rng.normal(size=(3, 3, c1, c2)) * 0.2).astype(np.float32))
    xp, wk, plan = prepare_tf32x3(x, wt)
    assert prepare(x, wt)[1].shape == wk.shape and prepare(x.bfloat16(), wt)[1].dim() == 3
    c1p = xp.shape[3]
    assert c1p % 4 == 0 and c1p - c1 < 4 and tuple(wk.shape) == (2, c2, 9, c1p)
    assert xp.is_contiguous() and wk.is_contiguous() and plan.bm == 128
    assert torch.equal(xp[..., :c1], x) and not xp[..., c1:].any() and not wk[..., c1:].any()
    hi, lo = wk[0, ..., :c1], wk[1, ..., :c1]
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    want = wt.permute(3, 0, 1, 2).reshape(c2, 9, c1)  # K-major, K = (tap, c1)
    assert ((hi - want).abs() <= 2.0 ** -11 * want.abs()).all()
    assert ((hi + lo - want).abs() <= 2.0 ** -22 * want.abs()).all()


def _tf32x3_emulated(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """K1's f32 route in torch: the prepared inputs split into TF32 parts,
    hi*hi + hi*lo + lo*hi as im2col products in f32 (TF32 products are
    exact in f32)."""
    xp, wk, _ = prepare_tf32x3(x, wt)
    b, h, w, c1p = xp.shape
    c2 = wk.shape[1]
    xpad = torch.nn.functional.pad(xp, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xpad[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 3)
    x_hi, x_lo = (c.reshape(b * h * w, 9 * c1p) for c in split_tf32(cols))
    w_hi, w_lo = (p.reshape(c2, 9 * c1p).T for p in wk)
    return (x_hi @ w_lo + x_lo @ w_hi + x_hi @ w_hi).reshape(b, h, w, c2)


@pytest.mark.parametrize("shape", [
    (2, 32, 32, 16, 24),
    (1, 64, 32, 8, 8),
    (2, 96, 96, 32, 32),
])
def test_conv3x3_tf32x3_emulation_matches_plain_and_pallas(shape):
    b, h, w, c1, c2 = shape
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, h, w, c1)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, c1, c2)) * 0.1).astype(np.float32)
    got = _tf32x3_emulated(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    np.testing.assert_allclose(got, conv3x3_s1_plain(torch.from_numpy(x),
                                                     torch.from_numpy(wt)).numpy(),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(wt), rh=8, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
