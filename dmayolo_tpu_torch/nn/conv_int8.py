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
  (`out_dtype=torch.int32`).

C1p is C1 rounded up to a multiple of 16 (`padded_channels`): the kernel
reads K in 16-byte pieces that each lie in one tap.  `prepare_weight` makes
the s8 weights and the per-output-channel scale once per conv.  Each entry
launches its kernel for CUDA tensors and takes its plain version only for
CPU tensors; the plain conv sums in float64 (exact: every partial sum is
an integer far below 2^53) and converts to int32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_library

INV_127 = float(np.float32(1) / np.float32(127))  # jitted XLA's max|w| / 127: max|w| * f32(1/127)
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


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
    `F.conv2d`, the sums as int32, then the epilogue."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(), None,
                 stride, padding, dilation)
    y32 = y.permute(0, 2, 3, 1).to(torch.int32)
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


def conv_int8(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], stride=(1, 1), padding=(0, 0), dilation=(1, 1),
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """s8 NHWC conv with s8 (C2, kh, kw, C1p) weights -> (B, Ho, Wo, C2) in
    `out_dtype`: the dequantized output (f32 or bf16; `scale` and `bias`
    are (C2,) values of that dtype, bias may be None) or the int32 sums.
    A CPU tensor goes through `conv_int8_plain`; a CUDA tensor launches the
    kernel, or raises."""
    _check(xq, wq, scale, out_dtype)
    if xq.device != wq.device:
        raise ValueError("x and w must be on one device")
    if xq.device.type == "cpu":
        return conv_int8_plain(xq, wq, scale, bias, stride, padding, dilation, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"conv_int8 runs on cuda or cpu, not {xq.device}")
    b, h, w, c1p = xq.shape
    c2, kh, kw = wq.shape[:3]
    ho = out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = out_size(w, kw, stride[1], padding[1], dilation[1])
    out = torch.empty((b, ho, wo, c2), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    xq, wq = xq.contiguous(), wq.contiguous()
    if out_dtype != torch.int32:
        scale = scale.float().contiguous()
        bias = None if bias is None else bias.float().contiguous()
    fn = _fn("conv_int8_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p])
    with torch.cuda.device(xq.device):
        rc = fn(xq.data_ptr(), wq.data_ptr(), 0 if scale is None else scale.data_ptr(),
                0 if bias is None else bias.data_ptr(), out.data_ptr(), b, h, w, c1p, ho, wo, c2,
                kh, kw, stride[0], stride[1], padding[0], padding[1], dilation[0], dilation[1],
                _OUT_KIND[out_dtype], torch.cuda.current_stream(xq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_int8 kernel launch failed: CUDA error {rc}")
    conv_int8.launches += 1
    return out


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
        xq = quantize_s8(xh, self.inv, self.wq.shape[3])
        y = conv_int8(xq, self.wq, scale, bias, self.stride, self.padding, self.dilation, dtype)
        return y.permute(0, 3, 1, 2)


def _fn(name: str, argtypes):
    fn = getattr(load_library("conv_int8"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


quantize_s8.launches = 0
conv_int8.launches = 0
