"""HorNet: the recursive gated conv `GnConv`, the `HorBlock` with its
LayerScale, and the CSP `C3HB`.

Port of the HorNet section of `dmayolo_tpu/nn/blocks.py`, attribute
names equal to the JAX path parts.  The LayerNorms (eps 1e-6) and the
MLP (`pwconv1`, `pwconv2`: JAX `Dense`, the port's `Linear`) act on the
channel axis, through the NHWC view that `channels_last` memory makes
contiguous.

bf16 follows JAX's promotions: the f32 LayerScale `gamma1`/`gamma2`
times a bf16 branch is f32, so a HorBlock's residual stream (and its
output) is f32; C3HB's concat promotes to f32 and its `cv3` rounds it.
`gamma1`/`gamma2` stay at their init in training: the reference never
hands them to its optimizer (`train/optim.py` labels them "frozen").

Profiler ranges: "gnconv" (a GnConv's whole forward) and "horblock" (a
HorBlock's, its GnConv included).
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.profiler import record_function

from .blocks import C3, ConvBN
from .primitives import Conv2d, LayerNorm, Linear, Sequential, gelu


class GnConv(nn.Module):
    """Recursive gated conv of `order`: a 1x1 projection to 2c, the first
    c / 2^(order-1) channels the gate `pwa`, the rest through a depthwise
    7x7 conv (with bias) and split by `dims`; then `order - 1` rounds of
    a 1x1 conv (`pws`) times the next split, and a ConvBN out."""

    def __init__(self, c1, c2, ksize=1, stride=1, order=5, s=1.0):
        super().__init__()
        self.order = order
        self.dims = [c1 // 2 ** i for i in range(order)][::-1]
        self.scale = s
        self.proj_in = Conv2d(c1, 2 * c1, 1, bias=True)
        d = sum(self.dims)
        self.dwconv = Conv2d(d, d, 7, p=3, g=d, bias=True)
        self.proj_out = ConvBN(c1, c2, ksize, stride)
        self.pws = Sequential(*[Conv2d(self.dims[i], self.dims[i + 1], 1, bias=True)
                                for i in range(order - 1)])

    def forward(self, x, dtype):
        with record_function("gnconv"):
            fused = self.proj_in(x, dtype)
            pwa, abc = fused[:, :self.dims[0]], fused[:, self.dims[0]:]
            dw_abc = self.dwconv(abc, dtype)
            if self.scale != 1.0:
                dw_abc = dw_abc * self.scale
            dw_list = torch.split(dw_abc, self.dims, dim=1)
            y = pwa * dw_list[0]
            for i in range(self.order - 1):
                y = self.pws[i](y, dtype) * dw_list[i + 1]
            return self.proj_out(y, dtype)


class HorBlock(nn.Module):
    """x + gamma1 * GnConv(LN(x)), then x + gamma2 * MLP(LN(x)), the MLP
    Linear(c, 4c), GELU, Linear(4c, c); `gamma1`, `gamma2` f32 vectors at
    `layer_scale_init`."""

    def __init__(self, dim, layer_scale_init=1e-6):
        super().__init__()
        self.ls_init = layer_scale_init
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.gnconv = GnConv(dim, dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma1 = nn.Parameter(torch.empty(dim))
        self.gamma2 = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.gamma1.fill_(self.ls_init)
            self.gamma2.fill_(self.ls_init)

    def forward(self, x, dtype):
        with record_function("horblock"):
            y = self.gnconv(self.norm1(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), dtype)
            x = x + self.gamma1[:, None, None] * y
            v = self.norm2(x.permute(0, 2, 3, 1))
            v = self.pwconv2(gelu(self.pwconv1(v, dtype)), dtype)
            return x + (self.gamma2 * v).permute(0, 3, 1, 2)


class C3HB(C3):
    """C3 with HorBlocks inside (`shortcut` and `g` unused)."""

    def make_inner(self, c_, n, shortcut, g):
        return Sequential(*[HorBlock(c_) for _ in range(n)])
