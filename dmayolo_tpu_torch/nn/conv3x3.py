"""3x3 stride-1 'same' convolution: the CUDA kernel K1 and its plain version.

Port of `dmayolo_tpu/nn/pallas_conv.py::conv3x3_s1`, as the standalone
function it is there: no model path calls it, and the port's `Conv2d` does
not either.  The kernel (`csrc/conv3x3_s1.cu`) is a tiled direct
convolution with f32 sums; its source note says what bounds it on the card
and what the design does about that.

`conv3x3_s1` launches the kernel for CUDA tensors and takes the plain
version, `conv3x3_s1_plain` (unfold + one f32 matmul, the `im2col` form),
only for CPU tensors.  Layouts are the JAX ones: x (B, H, W, C1), w HWIO
(3, 3, C1, C2), out (B, H, W, C2).  Unlike the TPU kernel, any H and W is
taken: ragged tiles are masked, not asserted away.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_library

_DTYPES = (torch.float32, torch.bfloat16)


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


def _lib():
    lib = load_library("conv3x3_s1")
    fn = lib.conv3x3_s1_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None):
    """3x3 / stride-1 / pad-1 NHWC conv, HWIO weights, f32 accumulation.

    Output dtype defaults to x.dtype.  A CPU tensor goes through
    `conv3x3_s1_plain`; a CUDA tensor launches the kernel, or raises."""
    out_dtype = _check(x, w, out_dtype)
    if x.device != w.device:
        raise ValueError("x and w must be on one device")
    if x.device.type == "cpu":
        return conv3x3_s1_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_s1 runs on cuda or cpu, not {x.device}")
    b, h, wd, c1 = x.shape
    c2 = w.shape[3]
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    out = torch.empty((b, h, wd, c2), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c1, c2,
                int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_s1 kernel launch failed: CUDA error {rc}")
    conv3x3_s1.launches += 1
    return out


conv3x3_s1.launches = 0
