"""Ghost v1 (`GhostConv`, `GhostBottleneck`, `C3Ghost`) and GhostNet v2
(`C3GhostV2` over `Ghostblockv2`, whose first ghost module carries the
DFC attention gate).

Port of the Ghost sections of `dmayolo_tpu/nn/blocks.py`, attribute
names equal to the JAX path parts (`Identity` holds an empty Sequential
slot, as in JAX).  `ConvUnit` is conv -> bn (-> act); `nn/fuse.py` folds
its BN.

bf16 follows JAX's promotions: the DFC gate is resized bilinearly with
f32 weights, so `GhostModuleMul`'s gate and output are f32 (bf16 when the
pooled map is 1 x 1, where the gate is a broadcast), and the next conv
rounds them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..parallel import spatial
from .blocks import C3, ConvBN, DWConv
from .primitives import (
    BatchNorm2d,
    Conv2d,
    Identity,
    Sequential,
    avg_pool,
    bilinear_resize_align_corners,
    global_avg_pool,
    hardswish,
)


# ---------------------------------------------------------------------------
# Ghost v1
# ---------------------------------------------------------------------------

class GhostConv(nn.Module):
    """A ConvBN to c2 / 2, and a depthwise 5x5 ConvBN of it beside it."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBN(c1, c_, k, s, None, g, act)
        self.cv2 = ConvBN(c_, c_, 5, 1, None, c_, act)

    def forward(self, x, dtype):
        y = self.cv1(x, dtype)
        return torch.cat([y, self.cv2(y, dtype)], dim=1)


class GhostBottleneck(nn.Module):
    """GhostConv, (a depthwise stride-2 DWConv), GhostConv, plus the
    shortcut (a DWConv and a 1x1 ConvBN at stride 2, else the input)."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        c_ = c2 // 2
        self.conv = Sequential(GhostConv(c1, c_, 1, 1),
                               DWConv(c_, c_, k, s, act=False) if s == 2 else Identity(),
                               GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = (Sequential(DWConv(c1, c1, k, s, act=False),
                                    ConvBN(c1, c2, 1, 1, act=False))
                         if s == 2 else Identity())

    def forward(self, x, dtype):
        return self.conv(x, dtype) + self.shortcut(x, dtype)


class C3Ghost(C3):
    """C3 with GhostBottlenecks inside."""

    def make_inner(self, c_, n, shortcut, g):
        return Sequential(*[GhostBottleneck(c_, c_) for _ in range(n)])


# ---------------------------------------------------------------------------
# GhostNet v2
# ---------------------------------------------------------------------------

def make_divisible_ghost(x, divisor=4):
    return int(np.ceil(x * 1.0 / divisor) * divisor)


def hard_sigmoid(x):
    return torch.clamp(x + 3.0, 0, 6) * 0.16666667


GHOST_ACTS = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0, 6),
    "sigmoid": torch.sigmoid,
    "hsigmoid": hard_sigmoid,
    "hard_sigmoid": hard_sigmoid,
    "hswish": hardswish,
    "hard_swish": hardswish,
}


class ConvUnit(nn.Module):
    """Conv (no bias) + BN (+ activation `act_type` of `GHOST_ACTS`)."""

    def __init__(self, c1, c2, k=1, s=1, p=0, g=1, use_act=True, act_type="relu"):
        super().__init__()
        if use_act and act_type not in GHOST_ACTS:
            raise NotImplementedError(act_type)
        self.conv = Conv2d(c1, c2, k, s, p=p, g=g, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = act_type if use_act else None

    def forward(self, x, dtype):
        y = self.bn(self.conv(x, dtype), dtype)
        return GHOST_ACTS[self.act](y) if self.act else y


class SE(nn.Module):
    """Squeeze-excite with a hard-sigmoid gate."""

    def __init__(self, c, ratio=4):
        super().__init__()
        mid = make_divisible_ghost(c // ratio)
        self.conv_reduce = Conv2d(c, mid, 1, bias=True)
        self.conv_expand = Conv2d(mid, c, 1, bias=True)

    def forward(self, x, dtype):
        pooled = global_avg_pool(x)
        with spatial.replicated():
            s = torch.relu(self.conv_reduce(pooled, dtype))
            gate = hard_sigmoid(self.conv_expand(s, dtype))
        return x * gate


class GhostModule(nn.Module):
    """A ConvUnit to ceil(c2 / ratio) and its depthwise `dw_size` cheap
    operation, concatenated."""

    def __init__(self, c1, c2, k=1, s=1, ratio=2, dw_size=3, use_act=True, act_type="relu"):
        super().__init__()
        init_ch = math.ceil(c2 / ratio)
        new_ch = init_ch * (ratio - 1)
        self.primary_conv = ConvUnit(c1, init_ch, k, s, p=k // 2, use_act=use_act,
                                     act_type=act_type)
        self.cheap_operation = ConvUnit(init_ch, new_ch, dw_size, 1, p=dw_size // 2, g=init_ch,
                                        use_act=use_act, act_type=act_type)

    def forward(self, x, dtype):
        x1 = self.primary_conv(x, dtype)
        return torch.cat([x1, self.cheap_operation(x1, dtype)], dim=1)


class GhostModuleMul(GhostModule):
    """GhostModule times the DFC attention gate: sigmoid of a 1x1, a
    depthwise 1x5 and a 5x1 ConvUnit on the 2x2 average pool of the input
    (odd sizes floor), resized back bilinearly (align_corners)."""

    def __init__(self, c1, c2, k=1, s=1, ratio=2, dw_size=3, use_act=True, act_type="relu"):
        super().__init__(c1, c2, k, s, ratio, dw_size, use_act, act_type)
        self.short_conv = Sequential(
            ConvUnit(c1, c2, k, s, p=k // 2, use_act=False),
            ConvUnit(c2, c2, (1, 5), 1, p=(0, 2), g=c2, use_act=False),
            ConvUnit(c2, c2, (5, 1), 1, p=(2, 0), g=c2, use_act=False))

    def forward(self, x, dtype):
        res = torch.sigmoid(self.short_conv(avg_pool(x, 2, 2), dtype))
        out = super().forward(x, dtype)
        return out * bilinear_resize_align_corners(res, spatial.global_hw(out))


class Ghostblockv2(nn.Module):
    """GhostModuleMul, (a depthwise stride-s ConvUnit), (SE), GhostModule,
    plus the shortcut (depthwise and 1x1 ConvUnits where the shape
    changes)."""

    def __init__(self, c1, c_mid, c2, k=3, s=1, act_type="relu", use_se=False):
        super().__init__()
        self.ghost1 = GhostModuleMul(c1, c_mid, 1, 1, act_type=act_type)
        self.dw = (ConvUnit(c_mid, c_mid, k, s, p=k // 2, g=c_mid, use_act=False)
                   if s > 1 else None)
        self.se = SE(c_mid) if use_se else None
        self.ghost2 = GhostModule(c_mid, c2, 1, 1, act_type=act_type, use_act=False)
        self.shortcut = (Sequential(ConvUnit(c1, c1, k, s, p=k // 2, g=c1, use_act=False),
                                    ConvUnit(c1, c2, 1, 1, p=0, use_act=False))
                         if c1 != c2 or s != 1 else None)

    def forward(self, x, dtype):
        out = self.ghost1(x, dtype)
        if self.dw is not None:
            out = self.dw(out, dtype)
        if self.se is not None:
            out = self.se(out, dtype)
        out = self.ghost2(out, dtype)
        return (x if self.shortcut is None else self.shortcut(x, dtype)) + out


class C3GhostV2(C3):
    """C3 with Ghostblockv2s (16 middle channels) inside."""

    def make_inner(self, c_, n, shortcut, g):
        return Sequential(*[Ghostblockv2(c_, 16, c_) for _ in range(n)])
