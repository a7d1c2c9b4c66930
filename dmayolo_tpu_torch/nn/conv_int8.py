"""int8 convolution for PTQ serving: the CUDA kernel K4, its input
quantize, and their plain versions.

The JAX package computes the same function as XLA ops, not a Pallas
kernel (`dmayolo_tpu/nn/primitives.py::Conv2d._int8_conv`); stock PyTorch
has no int8 conv for CUDA tensors, so the port has its own
(`csrc/conv_int8.cu`, whose source note says what bounds it):

* `quantize_s8`: x (B, H, W, C1) bf16 or f32 -> s8 (B, H, W, C1p),
  clip(round(f32(x) * inv), -127, 127) with inv = f32(1 / f32(s_x)) (the
  product jitted XLA computes for x / s_x), the C1p - C1 pad channels 0;
* `conv_int8`: s8 x (B, H, W, C1p) and s8 weights (C2, kh, kw, C1p) ->
  s32 sums, and the dequant epilogue in the output dtype dt, with scale =
  dt(f32(s_x) * s_w) and bias = dt(bias) (`dequant_params`), rounded as
  the jitted JAX program rounds it: at bf16 each op in turn, bf16(f32(acc))
  * scale -> bf16, + bias -> bf16; at f32 one fused multiply-add,
  fma(f32(acc), scale, bias), since XLA's CPU code generator contracts the
  multiply and the add of its HLO; or the s32 sums themselves
  (`out_dtype=torch.int32`);
* `quantize_conv_int8`: both in one call from the float input, what
  `Int8Conv` (the int8 form of `Conv2d`) runs.

`plan_int8` picks the kernel route from the geometry alone: (a) "1x1"
(stride 1, pad 0), (b) "3x3s1" (pad 1) and (c) "3x3s2" (pad 1) run
`conv_int8_wgmma_kernel` (wgmma s8, TMA loads; a bf16 input quantized
inside it), (d) "general" (any other kernel size, stride, pad or
dilation) `conv_int8_kernel` (mma.sync) on `quantize_s8`'s
output.  f32 inputs, and bf16 ones whose row TMA cannot stride (C1 % 8),
take `quantize_s8` and the route's s8 form.  Each route counts its
launches (`ROUTE_COUNTS`).

C1p is C1 rounded up to a multiple of 16 (`padded_channels`): route (d)
reads K in 16-byte pieces that each lie in one tap, and TMA strides are
multiples of 16 bytes.  `prepare_weight` makes the s8 weights and the
per-output-channel scale once per conv.  Each entry launches its kernels
for CUDA tensors and takes its plain version only for CPU tensors; the
plain conv sums in float64 (exact: every partial sum is an integer far
below 2^53) and converts to int32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_library

INV_127 = float(np.float32(1) / np.float32(127))  # jitted XLA's max|w| / 127: max|w| * f32(1/127)
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
ROUTES = ("1x1", "3x3s1", "3x3s2", "general")  # (a), (b), (c), (d)
_TC_ROUTE = {"1x1": 0, "3x3s1": 1, "3x3s2": 2}  # csrc/conv_int8.cu tc8::Route
ROW = 128  # bytes of an s8 row in shared memory: 128 channels
SMEM_LIMIT = 232448  # an H100's shared memory a block (opt-in)
SMEM_BUDGET = SMEM_LIMIT - 2048  # 1024 of alignment slack, the static barriers and room
MAX_STAGES = 9  # csrc/conv_int8.cu tc8::MAX_STAGES
MAX_HALO_W = 42  # route (b)'s widest haloed patch (TW + 2)
# what the wgmma launcher returns beyond cudaError_t
_TC_ERRORS = {10001: "cuTensorMapEncodeTiled not found in the driver",
              10002: "cannot make the input's tensor map",
              10003: "cannot make the weights' tensor map",
              10005: "the plan does not fit the kernel",
              10006: "the kernel was built with fewer than 168 registers a thread, which "
                     "setmaxnreg needs"}


def padded_channels(c1: int) -> int:
    return -(-c1 // 16) * 16


def reciprocal_f32(s_x: float) -> float:
    """f32(1 / f32(s_x)), the factor that replaces the division by s_x."""
    return float(np.float32(1) / np.float32(s_x))


def prepare_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW f32 weights -> (s8 (C2, kh, kw, C1p), s_w f32 (C2,)): the
    per-output-channel symmetric scale max|w| * f32(1/127), at least 1e-12,
    and round(w / s_w) clipped to [-127, 127] (a true division, as XLA
    keeps it for a traced divisor), the pad channels 0."""
    w = w.detach().float()
    s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)) * INV_127, min=np.float32(1e-12).item())
    wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127).to(torch.int8)
    wq = wq.permute(0, 2, 3, 1)
    pad = padded_channels(w.shape[1]) - w.shape[1]
    if pad:
        wq = F.pad(wq, (0, pad))
    return wq.contiguous(), s_w


def dequant_params(s_x: float, s_w: torch.Tensor, bias: Optional[torch.Tensor], dtype):
    """(scale, bias) of the epilogue in `dtype`: dt(f32(s_x) * s_w) and
    dt(bias) (bias None stays None)."""
    scale = (torch.tensor(np.float32(s_x), device=s_w.device) * s_w).to(dtype)
    return scale, (None if bias is None else bias.detach().float().to(dtype))


def quantize_s8_plain(x: torch.Tensor, inv: float, c1p: int) -> torch.Tensor:
    q = torch.clamp(torch.round(x.float() * np.float32(inv).item()), -127, 127).to(torch.int8)
    pad = c1p - x.shape[-1]
    return F.pad(q, (0, pad)) if pad else q


def quantize_s8(x: torch.Tensor, inv: float, c1p: Optional[int] = None) -> torch.Tensor:
    """x (..., C1) bf16 or f32 -> s8 (..., C1p), C1p = `padded_channels(C1)`
    unless given (a multiple of 8, >= C1)."""
    c1 = x.shape[-1]
    c1p = padded_channels(c1) if c1p is None else c1p
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_s8 takes f32/bf16, got {x.dtype}")
    if c1p % 8 or c1p < c1:
        raise ValueError(f"C1p {c1p} must be a multiple of 8 and at least C1 {c1}")
    if x.device.type == "cpu":
        return quantize_s8_plain(x, inv, c1p)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_s8 runs on cuda or cpu, not {x.device}")
    x = x.contiguous()
    out = torch.empty((*x.shape[:-1], c1p), dtype=torch.int8, device=x.device)
    pixels = x.numel() // c1
    if pixels == 0:
        return out
    fn = _fn("quantize_s8_launch", [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), pixels, c1, c1p, inv,
                int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_s8 kernel launch failed: CUDA error {rc}")
    quantize_s8.launches += 1
    return out


def out_size(size: int, k: int, s: int, p: int, d: int) -> int:
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _check(xq, wq, scale, out_dtype):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv_int8 takes s8 x and weights, got {xq.dtype} and {wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[3] != wq.shape[3] or xq.shape[3] % 16:
        raise ValueError(f"expected x (B, H, W, C1p) and w (C2, kh, kw, C1p), C1p % 16 == 0; got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"conv_int8 writes f32, bf16 or int32, not {out_dtype}")
    if out_dtype != torch.int32 and scale is None:
        raise ValueError("a dequantized output needs the scale")


def conv_int8_plain(xq, wq, scale, bias, stride, padding, dilation, out_dtype):
    """The same function in torch ops: the s8 tensors in float64 through
    `F.conv2d`, the sums as int32, then the epilogue (`dequant_plain`)."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(), None,
                 stride, padding, dilation)
    return dequant_plain(y.permute(0, 2, 3, 1).to(torch.int32), scale, bias, out_dtype)


def dequant_plain(y32, scale, bias, out_dtype):
    """The epilogue on s32 sums: themselves (int32), or dequantized."""
    if out_dtype == torch.int32:
        return y32.contiguous()
    if out_dtype == torch.float32:
        # one rounding of acc * scale + bias: the float64 product of two
        # f32 values is exact, and the sum rounds twice only where it lands
        # on an f32 midpoint, about once in 2^29
        y = y32.float().double() * scale.double()
        if bias is not None:
            y = y + bias.double()
        return y.float().contiguous()
    y = y32.float().to(out_dtype) * scale.to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.contiguous()


def quantize_conv_int8_plain(x, inv, wq, scale, bias, stride, padding, dilation, out_dtype):
    return conv_int8_plain(quantize_s8_plain(x, inv, wq.shape[3]), wq, scale, bias, stride,
                           padding, dilation, out_dtype)


def route_of(kernel, stride, padding, dilation) -> str:
    """The kernel route of a (kh, kw) conv, from its geometry alone."""
    kernel, stride, padding = tuple(kernel), tuple(stride), tuple(padding)
    if kernel == (1, 1) and stride == (1, 1) and padding == (0, 0):
        return "1x1"
    if kernel == (3, 3) and padding == (1, 1) and tuple(dilation) == (1, 1) and stride in (
            (1, 1), (2, 2)):
        return "3x3s1" if stride == (1, 1) else "3x3s2"
    return "general"


class Int8Plan(NamedTuple):
    """How `conv_int8_wgmma_kernel` runs one conv (routes (a)-(c)), or
    route "general" (d) with the rest unused.  Tiles: `tile_rows()` rows
    (pixels) by `bn` output channels; (b) a th x tw patch computed as th
    rows of tw + 2 (two junk columns, so that each tap is one shift of the
    haloed tile), (c) one computed as th rows of tw + 1 (each input phase's
    taps are shifts of its strided tile).  A K-step is one tap's chunk of
    128 channels: `chunks` a tap, `kk` k32 products each; an A load brings
    `a_rows` rows; `cb` the channels of a raw bf16 row (`convert`: the
    input quantized in the kernel).  Stage counts and shared memory in
    bytes."""
    route: str
    b: int
    h: int
    w: int
    cx: int  # the input's channels: C1 (bf16, converted) or C1p (s8)
    c1p: int
    ho: int
    wo: int
    c2: int
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    bn: int
    n_tiles: int
    tiles: int
    chunks: int
    kk: int
    taps: int
    cb: int
    a_rows: int
    a_stages: int
    b_stages: int
    a_bytes: int
    raw_bytes: int
    smem: int
    convert: bool
    res: bool  # the weights resident: b_stages == taps slices, loaded once a block
    s8_tiles: int  # convert: 2 s8 tiles, one quantized while the tensor cores read the other

    def args(self, out_kind: int):
        """The ints of csrc/conv_int8.cu's tc8::Plan, in its order."""
        return [_TC_ROUTE[self.route], *self[1:26], int(self.convert), int(self.res),
                self.s8_tiles, out_kind]

    def tile_rows(self) -> int:
        """A tile's rows: two warpgroups of one m64 block (BN 256) or two."""
        return 128 if self.bn == 256 else 256


@functools.lru_cache(maxsize=512)
def plan_int8(b: int, h: int, w: int, c1: int, c2: int, kernel=(1, 1), stride=(1, 1),
              padding=(0, 0), dilation=(1, 1), in_dtype=torch.int8) -> Int8Plan:
    """The route and tiles of one conv of s8 weights (C2, kh, kw, C1p) on
    an (B, H, W, C1) input of `in_dtype` (s8: already C1p channels)."""
    kernel, stride, padding, dilation = (tuple(v) for v in (kernel, stride, padding, dilation))
    route = route_of(kernel, stride, padding, dilation)
    c1p = padded_channels(c1)
    ho = out_size(h, kernel[0], stride[0], padding[0], dilation[0])
    wo = out_size(w, kernel[1], stride[1], padding[1], dilation[1])
    if route == "general":
        return Int8Plan(route, b, h, w, c1p, c1p, ho, wo, c2, *([0] * 17), False, False, 0)
    convert = in_dtype == torch.bfloat16 and c1 % 8 == 0
    # BN: 64 for C2 <= 64, 128 for C2 <= 128 and the 3x3 routes, else 256
    # (a 1x1 conv's input is quantized once a BN slice: the wider, the
    # fewer; a 3x3 conv's once a haloed or phase tile, and 256-row tiles
    # halve its weight reads)
    bn = 64 if c2 <= 64 else 128 if c2 <= 128 or route != "1x1" else 256
    rows = 128 if bn == 256 else 256  # Int8Plan.tile_rows: two warpgroups of 1 or 2 m64 blocks
    chunks = -(-c1p // ROW)
    cb = 32 if c1p <= 32 else 64 if c1p <= 64 else 128
    kk = cb // 32
    n_tiles = -(-c2 // bn)
    b_bytes = bn * ROW
    taps = 1 if route == "1x1" else 9

    def fit(th, tw):
        """The plan's buffers for one patch (route (a): th = tw = 1), or
        None where they do not fit."""
        if route == "1x1":
            a_rows = s8_rows = rows
        elif route == "3x3s1":
            a_rows = (th + 2) * (tw + 2)
            # what the shifted views of the tile read: 2 rows and 2 pixels past it
            s8_rows = -(-(rows + 2 * (tw + 2) + 2) // 8) * 8
        else:  # a phase's tile; the views read a row and a pixel past the tile
            a_rows = (th + 1) * (tw + 1)
            s8_rows = -(-(rows + (tw + 1) + 1) // 8) * 8
        a_bytes = s8_rows * ROW
        # a raw bf16 stage: the loaded rows, or (a) the tile's (the
        # converters quantize all of them, loaded or not)
        raw_bytes = -(-(rows if route == "1x1" else a_rows) * 2 * cb // 1024) * 1024
        # where the kernel's converter warps quantize into: two tiles, one
        # written while the consumers read the other
        n_s8 = 2 if convert else 0
        s8_tiles = n_s8 * a_bytes
        a_stage = raw_bytes if convert else a_bytes
        room = SMEM_BUDGET - s8_tiles
        # A stages: (b) one haloed tile feeds nine K-steps, so 1 (quantized
        # in the kernel) or 2 at least; (c) a phase's tile feeds 1-4; (a)
        # one, as many as the weight stages.  The taps' weight slices stay
        # resident where one chunk and one N tile cover the conv and they
        # fit: loaded once a block.
        a_min, a_max = {"1x1": (2, 4), "3x3s1": (1 if convert else 2, 2 if convert else 4),
                        "3x3s2": (1 if convert else 2, 2 if convert else 3)}[route]
        res = (chunks == 1 and n_tiles == 1
               and a_min * a_stage + taps * b_bytes <= room)
        if res:
            b_stages = taps
            a_stages = min(a_max, (room - taps * b_bytes) // a_stage)
        elif route != "1x1":
            a_stages = max(a_min, min(a_max, (room - 4 * b_bytes) // a_stage))
            b_stages = min(MAX_STAGES, (room - a_stages * a_stage) // b_bytes)
            if b_stages < 4:  # nine K-steps a load: a shallow weight ring stalls them
                return None
        else:
            a_stages = b_stages = min(4, room // (a_stage + b_bytes))
            if a_stages < 2:
                return None
        smem = 1024 + b_stages * b_bytes + a_stages * a_stage + s8_tiles
        return a_rows, a_stages, b_stages, a_bytes, raw_bytes, smem, res, n_s8

    if route == "1x1":
        th = tw = tiles_h = tiles_w = 1
        m_tiles = -(-(b * h * w) // rows)
        buffers = fit(1, 1)
    else:
        # the patch that covers the map with the fewest tiles (the widest
        # among equals) and fits, computed as th rows of tw + 2 pixels (b)
        # or tw + 1 (c; TMA boxes of 2 (tw + 1) strided pixels, at most 256)
        extra, max_tw = (2, MAX_HALO_W - 2) if route == "3x3s1" else (1, 127)
        cands = []
        for tw in range(min(wo, max_tw), 0, -1):
            th = min(ho, rows // (tw + extra), 127)
            cands.append((-(-ho // th) * -(-wo // tw), -tw, th, tw))
        for _, _, th, tw in sorted(cands):
            buffers = fit(th, tw)
            if buffers is not None:
                break
        tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
        m_tiles = b * tiles_h * tiles_w
    a_rows, a_stages, b_stages, a_bytes, raw_bytes, smem, res, n_s8 = buffers
    return Int8Plan(route, b, h, w, c1 if convert else c1p, c1p, ho, wo, c2, th, tw, tiles_h,
                    tiles_w, bn, n_tiles, m_tiles * n_tiles, chunks, kk, taps, cb, a_rows,
                    a_stages, b_stages, a_bytes, raw_bytes, smem, convert, res, n_s8)


class RouteCount:
    """The launch count of one K4 route, read and zeroed as a wrapper's
    `launches` is."""

    def __init__(self, route: str):
        self.route, self.__name__, self.launches = route, f"conv_int8_{route}", 0


ROUTE_COUNTS = {r: RouteCount(r) for r in ROUTES}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t  # a view at an odd offset: TMA needs 16


def _launch(x, wq, scale, bias, plan: Int8Plan, inv: float, out_dtype, stride, padding,
            dilation):
    """Route `plan.route` on a CUDA input (s8, or bf16 with plan.convert)."""
    b, ho, wo, c2 = plan.b, plan.ho, plan.wo, plan.c2
    out = torch.empty((b, ho, wo, c2), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    wq = _aligned(wq)
    if out_dtype != torch.int32:
        scale = scale.float().contiguous()
        bias = None if bias is None else bias.float().contiguous()
    ptrs = (0 if scale is None else scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.route == "general":
            x = x.contiguous()
            kh, kw = wq.shape[1:3]
            fn = _fn("conv_int8_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16
                     + [ctypes.c_void_p])
            rc = fn(x.data_ptr(), wq.data_ptr(), *ptrs, b, plan.h, plan.w, plan.c1p, ho, wo, c2,
                    kh, kw, stride[0], stride[1], padding[0], padding[1], dilation[0],
                    dilation[1], _OUT_KIND[out_dtype], stream)
        else:
            x = _aligned(x)
            args = plan.args(_OUT_KIND[out_dtype])
            fn = _fn("conv_int8_wgmma_launch", [ctypes.c_void_p] * 6
                     + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
                     f"conv_int8_bn{plan.bn}")
            rc = fn(x.data_ptr(), wq.data_ptr(), *ptrs, (ctypes.c_int * len(args))(*args),
                    len(args), inv, stream)
    if rc != 0:
        raise RuntimeError(f"conv_int8 route {plan.route} launch failed: "
                           f"{_TC_ERRORS.get(rc, f'CUDA error {rc}')}")
    ROUTE_COUNTS[plan.route].launches += 1
    return out


def conv_int8(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], stride=(1, 1), padding=(0, 0), dilation=(1, 1),
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """s8 NHWC conv with s8 (C2, kh, kw, C1p) weights -> (B, Ho, Wo, C2) in
    `out_dtype`: the dequantized output (f32 or bf16; `scale` and `bias`
    are (C2,) values of that dtype, bias may be None) or the int32 sums.
    A CPU tensor goes through `conv_int8_plain`; a CUDA tensor launches the
    route `plan_int8` picks, or raises."""
    _check(xq, wq, scale, out_dtype)
    if xq.device != wq.device:
        raise ValueError("x and w must be on one device")
    if xq.device.type == "cpu":
        return conv_int8_plain(xq, wq, scale, bias, stride, padding, dilation, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"conv_int8 runs on cuda or cpu, not {xq.device}")
    b, h, w, c1p = xq.shape
    plan = plan_int8(b, h, w, c1p, wq.shape[0], tuple(wq.shape[1:3]), tuple(stride),
                     tuple(padding), tuple(dilation), torch.int8)
    return _launch(xq, wq, scale, bias, plan, 0.0, out_dtype, stride, padding, dilation)


def quantize_conv_int8(x: torch.Tensor, inv: float, wq: torch.Tensor,
                       scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                       stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """`quantize_s8` then `conv_int8` in one call: x (B, H, W, C1) bf16 or
    f32, `inv` = f32(1 / f32(s_x)), the rest as `conv_int8`.  On the card,
    routes (a)-(c) quantize a bf16 input inside the conv kernel; f32, C1 %
    8 and route (d) launch `quantize_s8` first.  A CPU tensor takes
    `quantize_conv_int8_plain`."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_conv_int8 takes f32/bf16, got {x.dtype}")
    if x.dim() != 4 or wq.dim() != 4 or wq.shape[3] != padded_channels(x.shape[3]):
        raise ValueError(f"expected x (B, H, W, C1) and w (C2, kh, kw, C1p), got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if x.device.type == "cpu":
        _check(x.new_empty((0, 0, 0, wq.shape[3]), dtype=torch.int8), wq, scale, out_dtype)
        return quantize_conv_int8_plain(x, inv, wq, scale, bias, stride, padding, dilation,
                                        out_dtype)
    b, h, w, c1 = x.shape
    plan = plan_int8(b, h, w, c1, wq.shape[0], tuple(wq.shape[1:3]), tuple(stride),
                     tuple(padding), tuple(dilation), x.dtype)
    if not plan.convert:
        return conv_int8(quantize_s8(x, inv, wq.shape[3]), wq, scale, bias, stride, padding,
                         dilation, out_dtype)
    _check(x.new_empty((0, 0, 0, wq.shape[3]), dtype=torch.int8), wq, scale, out_dtype)
    if x.device != wq.device:
        raise ValueError("x and w must be on one device")
    return _launch(x, wq, scale, bias, plan, inv, out_dtype, stride, padding, dilation)


class Int8Conv:
    """A `Conv2d`'s int8 form for one input scale s_x, as the JAX
    `Conv2d._int8_conv` computes it: the s8 weights and s_w made once from
    the conv's f32 (folded) weights, and the epilogue's scale and bias once
    a compute dtype.  Called as the conv is, on an NCHW view of NHWC
    memory; returns the same view of its (B, Ho, Wo, C2) output."""

    def __init__(self, conv, s_x: float):
        self.s_x = float(s_x)
        self.inv = reciprocal_f32(self.s_x)
        self.key = self._key(conv, self.s_x)
        self.wq, self.s_w = prepare_weight(conv.weight)
        self.bias = None if conv.bias is None else conv.bias.detach().float()
        self.stride, self.padding, self.dilation = conv.s, conv.p, conv.d
        self._epilogue = {}

    @staticmethod
    def _key(conv, s_x):
        return (s_x, *((p.data_ptr(), p._version) for p in (conv.weight, conv.bias)
                       if p is not None))

    def matches(self, conv, s_x: float) -> bool:
        return self.key == self._key(conv, float(s_x))

    def __call__(self, x: torch.Tensor, dtype) -> torch.Tensor:
        if dtype not in self._epilogue:
            self._epilogue[dtype] = dequant_params(self.s_x, self.s_w, self.bias, dtype)
        scale, bias = self._epilogue[dtype]
        xh = x.permute(0, 2, 3, 1)
        if xh.dtype not in (torch.float32, torch.bfloat16):
            xh = xh.float()
        y = quantize_conv_int8(xh, self.inv, self.wq, scale, bias, self.stride, self.padding,
                               self.dilation, dtype)
        return y.permute(0, 3, 1, 2)


def _fn(name: str, argtypes, library: str = "conv_int8"):
    """`name` of the library `library` (route (d) and the quantize in
    "conv_int8", the wgmma kernel's instances a BN each in
    "conv_int8_bn{BN}")."""
    fn = getattr(load_library(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


quantize_s8.launches = 0
