"""3x3 stride-1 'same' convolution: the CUDA kernel K1 and its plain version.

Port of `dmayolo_tpu/nn/pallas_conv.py::conv3x3_s1`, as the standalone
function it is there: no model path calls it, and the port's `Conv2d` does
not either.  The kernels live in `csrc/conv3x3_s1.cu`, whose source note
says what bounds them on the card:

* bf16 inputs: an implicit GEMM on the tensor cores (`wgmma`, TMA loads).
  `prepare_tc` does its host side: the input's channels, and the weights'
  C1, zero-padded to a multiple of 8 (TMA needs 16-byte strides; zero
  channels add nothing to the sums), the weights reordered to K-major
  (C2, 9, C1p), and the tile plan (`plan_tc`).
* f32 inputs: the same implicit GEMM as 3xTF32 (hi*hi + hi*lo + lo*hi of
  each operand's TF32 parts, `split_tf32`), exact enough for the 1e-4
  tolerance against the f32 reference.  `prepare_tf32x3` does its host
  side: channels padded to a multiple of 4, the K-major weights split into
  their hi and lo parts, stacked (2, C2, 9, C1p), and a plan of 128-row
  tiles; the kernel splits the activations itself.

`conv3x3_s1` launches a kernel for CUDA tensors and takes the plain
version, `conv3x3_s1_plain` (unfold + one f32 matmul, the `im2col` form),
only for CPU tensors.  Layouts are the JAX ones: x (B, H, W, C1), w HWIO
(3, 3, C1, C2), out (B, H, W, C2).  Unlike the TPU kernel, any H and W is
taken: ragged tiles are masked, not asserted away.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_library

_DTYPES = (torch.float32, torch.bfloat16)
TILE_ROWS = (128, 256)  # rows of a tensor-core tile: two or four m64 wgmma blocks
TF32X3_ROWS = (128,)  # the f32 route's tile rows: its doubled stages fit no more
MAX_HALO_W = 56  # widest haloed patch (TW + 2): the largest tile's buffers fit 227 KB
_SMS = 132  # an H100 SXM's SMs, for the tile-size choice only
# what the wgmma launcher returns when it cannot make a TMA tensor map
_TC_ERRORS = {10001: "cuTensorMapEncodeTiled not found in the driver",
              10002: "cannot make the input's tensor map",
              10003: "cannot make the weights' tensor map",
              10004: "cannot make the output's tensor map"}


def _check(x: torch.Tensor, w: torch.Tensor, out_dtype):
    if x.dim() != 4 or w.shape[:2] != (3, 3) or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"expected x (B, H, W, C1) and w (3, 3, C1, C2), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"conv3x3_s1 takes f32/bf16, got {x.dtype} -> {out_dtype}")
    return out_dtype


def conv3x3_s1_plain(x: torch.Tensor, w: torch.Tensor, out_dtype=None):
    """im2col form: one (B, H*W, 9*C1) x (9*C1, C2) product, summed in f32."""
    out_dtype = _check(x, w, out_dtype)
    b, h, wd, c1 = x.shape
    c2 = w.shape[3]
    w = w.to(x.dtype)  # the weight takes the input's dtype, as in the JAX kernel
    cols = F.unfold(x.permute(0, 3, 1, 2).float(), 3, padding=1)  # (B, C1*9, H*W)
    wm = w.float().permute(2, 0, 1, 3).reshape(c1 * 9, c2)  # rows (c1, dy, dx)
    y = torch.matmul(cols.transpose(1, 2), wm)
    return y.reshape(b, h, wd, c2).to(out_dtype)


class TcPlan(NamedTuple):
    """Tiles of the tensor-core kernel: a th x tw patch of one image for bn
    output channels.  The kernel computes the patch as th rows of tw + 2
    (two junk columns, so that every tap is one shift of the haloed tile):
    th * (tw + 2) <= bm, the tile's rows."""
    batch: int
    h: int
    w: int
    c2: int
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    bm: int
    bn: int
    n_tiles: int

    def tiles(self) -> Iterator[Tuple[int, int, int, int]]:
        """(b, h0, w0, n0) of every tile, in the kernel's order: the C2
        slices of one patch are neighbours."""
        for bid in range(self.batch * self.tiles_h * self.tiles_w * self.n_tiles):
            mt, nt = divmod(bid, self.n_tiles)
            mt, tw_i = divmod(mt, self.tiles_w)
            b, th_i = divmod(mt, self.tiles_h)
            yield b, th_i * self.th, tw_i * self.tw, nt * self.bn


@functools.lru_cache(maxsize=256)
def plan_tc(b: int, h: int, w: int, c2: int, tile_rows=TILE_ROWS) -> TcPlan:
    """The patch that covers an image with the fewest tiles (the widest
    among equals, for longer runs of stores).  BN = 64 for C2 <= 64, else
    128; 256-row tiles at BN 128 (where `tile_rows` offers them), which
    halve the weight reads an output, where they compute at most 10% more
    rows than 128-row tiles and still give the card's SMs half a tile each
    or more."""
    def patch(rows):
        best = None
        for tw in range(min(w, MAX_HALO_W - 2), 0, -1):
            th = min(h, rows // (tw + 2))
            n = -(-h // th) * -(-w // tw)
            if best is None or n < best[0]:
                best = (n, th, tw)
        return best

    bm, bn = tile_rows[0], 64 if c2 <= 64 else 128
    if len(tile_rows) > 1:
        small, big = (patch(rows)[0] for rows in tile_rows)
        if (bn == 128 and big * tile_rows[1] <= 1.1 * small * tile_rows[0]
                and b * big * -(-c2 // bn) >= _SMS // 2):
            bm = tile_rows[1]
    _, th, tw = patch(bm)
    return TcPlan(b, h, w, c2, th, tw, -(-h // th), -(-w // tw), bm, bn, -(-c2 // bn))


def prepare_tc(x: torch.Tensor, w: torch.Tensor):
    """Host side of the tensor-core route, in x's dtype: x (B, H, W, C1p)
    and the weights as K-major wk (C2, 9, C1p), K ordered (tap, c1) with
    tap = 3*dy + dx, C1p = C1 rounded up to a multiple of 8 (zero-filled),
    both contiguous and 16-byte aligned; and the tile plan."""
    b, h, wd, c1 = x.shape
    c2 = w.shape[3]
    pad = -c1 % 8
    wk = w.to(x.dtype).permute(3, 0, 1, 2).reshape(c2, 9, c1)
    if pad:
        x = F.pad(x, (0, pad))
        wk = F.pad(wk, (0, pad))
    x, wk = x.contiguous(), wk.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: TMA needs 16-byte alignment
        x = x.clone()
    return x, wk, plan_tc(b, h, wd, c2)


def split_tf32(t: torch.Tensor):
    """(hi, lo) of an f32 tensor as TF32 parts: hi = tf32(t), lo =
    tf32(t - hi), where tf32() rounds to nearest, ties away from zero, and
    clears the low 13 mantissa bits (`cvt.rna.tf32.f32`).  hi + lo is within
    2^-22 |t| of t; the kernel splits its activations the same way."""
    def tf32(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = tf32(t)
    return hi, tf32(t - hi)


def prepare_tf32x3(x: torch.Tensor, w: torch.Tensor):
    """Host side of the f32 route (3xTF32): x (B, H, W, C1p) f32 and the
    weights as K-major (C2, 9, C1p) hi and lo parts stacked into wk
    (2, C2, 9, C1p), K ordered (tap, c1), C1p = C1 rounded up to a
    multiple of 4 (zero-filled), both contiguous and 16-byte aligned; and
    a plan of 128-row tiles."""
    b, h, wd, c1 = x.shape
    c2 = w.shape[3]
    pad = -c1 % 4
    wk = w.float().permute(3, 0, 1, 2).reshape(c2, 9, c1)
    if pad:
        x = F.pad(x, (0, pad))
        wk = F.pad(wk, (0, pad))
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: TMA needs 16-byte alignment
        x = x.clone()
    return x, torch.stack(split_tf32(wk)), plan_tc(b, h, wd, c2, TF32X3_ROWS)


def prepare(x: torch.Tensor, w: torch.Tensor):
    """The host side of the kernel of x's dtype: `prepare_tc` (bf16) or
    `prepare_tf32x3` (f32)."""
    return prepare_tc(x, w) if x.dtype == torch.bfloat16 else prepare_tf32x3(x, w)


def _fn(name: str, n_int: int):
    fn = getattr(load_library("conv3x3_s1"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch_tc(xp: torch.Tensor, wk: torch.Tensor, plan: TcPlan, out: torch.Tensor) -> int:
    """The tensor-core kernel on `prepare`'s output (bf16, or f32 as
    3xTF32), into `out` (f32 or bf16) on the current stream; returns the
    launcher's code (0: launched).  No launch count: `conv3x3_s1` keeps it."""
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    return _fn("conv3x3_s1_wgmma_launch", 13)(
        xp.data_ptr(), wk.data_ptr(), out.data_ptr(), plan.batch, plan.h, plan.w, xp.shape[3],
        plan.c2, plan.th, plan.tw, plan.tiles_h, plan.tiles_w, plan.bm, plan.bn,
        int(xp.dtype == torch.float32), int(out.dtype == torch.bfloat16), stream)


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None):
    """3x3 / stride-1 / pad-1 NHWC conv, HWIO weights, f32 accumulation.

    Output dtype defaults to x.dtype.  A CPU tensor goes through
    `conv3x3_s1_plain`; a CUDA tensor launches the tensor-core kernel of
    its input dtype (bf16, or f32 as 3xTF32), or raises."""
    out_dtype = _check(x, w, out_dtype)
    if x.device != w.device:
        raise ValueError("x and w must be on one device")
    if x.device.type == "cpu":
        return conv3x3_s1_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_s1 runs on cuda or cpu, not {x.device}")
    out = torch.empty((*x.shape[:3], w.shape[3]), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = launch_tc(*prepare(x, w), out)
    if rc != 0:
        raise RuntimeError(f"conv3x3_s1 kernel launch failed: "
                           f"{_TC_ERRORS.get(rc, f'CUDA error {rc}')}")
    conv3x3_s1.launches += 1
    return out


conv3x3_s1.launches = 0
