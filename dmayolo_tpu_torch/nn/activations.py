"""The learnable activations: FReLU, ACON-C (`AconC`) and Meta-ACON
(`MetaAconC`).  The plain ones (SiLU, Hardswish, LeakyReLU, Mish, ...)
are functions in `nn/primitives.py` (`ACTIVATIONS`).

Port of `dmayolo_tpu/nn/activations.py`.  `p1`, `p2` and `beta` keep the
JAX shape (1, 1, 1, C) (NHWC), so the weight bridge maps them as they
are; the forward views them as (1, C, 1, 1).  These f32 leaves times a
bf16 map give f32, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..parallel import spatial
from .primitives import BatchNorm2d, Conv2d, global_avg_pool


def _nchw(p):
    return p.reshape(1, -1, 1, 1)


class FReLU(nn.Module):
    """Funnel activation: max(x, BN(depthwise k x k conv(x)))."""

    def __init__(self, c1, k=3):
        super().__init__()
        self.conv = Conv2d(c1, c1, k, 1, p=1, g=c1, bias=False)
        self.bn = BatchNorm2d(c1)

    def forward(self, x, dtype):
        return torch.maximum(x, self.bn(self.conv(x, dtype), dtype))


def _acon(x, p1, p2, beta):
    dpx = (_nchw(p1) - _nchw(p2)) * x
    return dpx * torch.sigmoid(beta * dpx) + _nchw(p2) * x


class AconC(nn.Module):
    """ACON-C: (p1 - p2) x sigmoid(beta (p1 - p2) x) + p2 x; p1, p2 drawn
    N(0, 1), beta ones."""

    def __init__(self, c1):
        super().__init__()
        self.p1 = nn.Parameter(torch.empty(1, 1, 1, c1))
        self.p2 = nn.Parameter(torch.empty(1, 1, 1, c1))
        self.beta = nn.Parameter(torch.empty(1, 1, 1, c1))

    def reset_parameters(self, generator: torch.Generator):
        for p in (self.p1, self.p2):
            p.data.copy_(torch.randn(p.shape, generator=generator))
        with torch.no_grad():
            self.beta.fill_(1.0)

    def forward(self, x, dtype):
        return _acon(x, self.p1, self.p2, _nchw(self.beta))


class MetaAconC(nn.Module):
    """Meta-ACON: beta = sigmoid(fc2(fc1(global average pool))), a 1x1
    channel bottleneck to max(r, c1 // r)."""

    def __init__(self, c1, k=1, s=1, r=16):
        super().__init__()
        c2 = max(r, c1 // r)
        self.fc1 = Conv2d(c1, c2, k, s, bias=True)
        self.fc2 = Conv2d(c2, c1, k, s, bias=True)
        self.p1 = nn.Parameter(torch.empty(1, 1, 1, c1))
        self.p2 = nn.Parameter(torch.empty(1, 1, 1, c1))

    def reset_parameters(self, generator: torch.Generator):
        for p in (self.p1, self.p2):
            p.data.copy_(torch.randn(p.shape, generator=generator))

    def forward(self, x, dtype):
        pooled = global_avg_pool(x)
        with spatial.replicated():
            beta = torch.sigmoid(self.fc2(self.fc1(pooled, dtype), dtype))
        return _acon(x, self.p1, self.p2, beta)
