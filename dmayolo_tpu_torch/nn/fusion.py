"""The adaptive fusions: `AddConvBlock` (conv, BN, LeakyReLU 0.1),
`AdaptADD` and `AdaptConcat` (softmax weights over the levels from 1x1
maps), `AdaptAdd2`/`AdaptAdd3` (the yamls' `Adapt_Add2`/`Adapt_Add3`:
BiFPN fast-normalised weighted adds with SiLU) and `ASFF`.

Port of the adaptive / BiFPN fusion section of `dmayolo_tpu/nn/blocks.py`,
attribute names equal to the JAX path parts (`AddConvBlock`'s BN is
`batch_norm`; `nn/fuse.py` folds it).

bf16 follows JAX's promotions: the softmax weights stay in the activation
dtype, so `AdaptADD`, `AdaptConcat` and `ASFF` give bf16 on bf16 inputs;
`AdaptAdd2`/`AdaptAdd3` scale each input by an element of the f32 `w`,
so their sum, and its SiLU, are f32.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .primitives import BatchNorm2d, Conv2d, leaky_relu, max_pool, silu, upsample_nearest


class AddConvBlock(nn.Module):
    """Conv (no bias, 'same' padding for odd k) + BN + LeakyReLU(0.1): the
    reference's `add_conv`."""

    def __init__(self, c1, c2, k=1, s=1):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, p=(k - 1) // 2, bias=False)
        self.batch_norm = BatchNorm2d(c2)

    def forward(self, x, dtype):
        return leaky_relu(self.batch_norm(self.conv(x, dtype), dtype), 0.1)


def _level_weights(weight_levels, maps, dtype):
    """Softmax over the levels of the 1x1 conv of the concatenated weight
    maps: (B, level, H, W) in the activation dtype."""
    return torch.softmax(weight_levels(torch.cat(maps, dim=1), dtype), dim=1)


class AdaptADD(nn.Module):
    """Softmax-weighted add of 2 or 3 levels (the third through a 1x1
    `compress_level` first), then a 3x3 `expand`."""

    def __init__(self, level, out_ch, dimension, dim1, dim2, dim3=1, rfb=False):
        super().__init__()
        self.level = level
        compress_c = 8 if rfb else 16
        self.compress_level = AddConvBlock(dim3, dim1, 1, 1)
        self.weight_map = AddConvBlock(dim1, compress_c, 1, 1)
        self.weight_levels = Conv2d(compress_c * level, level, 1, bias=True)
        self.expand = AddConvBlock(dim1, out_ch, 3, 1)

    def forward(self, xs, dtype):
        inputs = list(xs[:2])
        if self.level == 3:
            inputs.append(self.compress_level(xs[2], dtype))
        w = _level_weights(self.weight_levels, [self.weight_map(x, dtype) for x in inputs],
                           dtype)
        fused = inputs[0] * w[:, 0:1]
        for i in range(1, self.level):
            fused = fused + inputs[i] * w[:, i:i + 1]
        return self.expand(fused, dtype)


class AdaptConcat(nn.Module):
    """Softmax-weighted concat of 2 or 3 levels."""

    def __init__(self, level, dimension, dim1, dim2, dim3=1, rfb=False):
        super().__init__()
        self.level = level
        compress_c = 8 if rfb else 16
        self.weight_map0 = AddConvBlock(dim1, compress_c, 1, 1)
        self.weight_map1 = AddConvBlock(dim2, compress_c, 1, 1)
        self.weight_map2 = AddConvBlock(dim3, compress_c, 1, 1)
        self.weight_levels = Conv2d(compress_c * level, level, 1, bias=True)

    def forward(self, xs, dtype):
        maps = (self.weight_map0, self.weight_map1, self.weight_map2)[:self.level]
        w = _level_weights(self.weight_levels, [m(x, dtype) for m, x in zip(maps, xs)], dtype)
        return torch.cat([xs[i] * w[:, i:i + 1] for i in range(self.level)], dim=1)


class AdaptAdd2(nn.Module):
    """SiLU of the BiFPN fast-normalised weighted sum of 2 inputs (`w`
    f32, ones at init)."""

    n_in = 2

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(self.n_in))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.w.fill_(1.0)

    def weighted_sum(self, xs):
        """sum_i w_i x_i / (sum w + 1e-4), in f32 (each weight a 1-element
        f32 tensor, so the product promotes as JAX's does)."""
        w = self.w / (self.w.sum() + 1e-4)
        y = xs[0] * w[0:1]
        for i in range(1, self.n_in):
            y = y + xs[i] * w[i:i + 1]
        return y

    def forward(self, xs, dtype):
        return silu(self.weighted_sum(xs))


class AdaptAdd3(AdaptAdd2):
    """3 inputs, the first two through one shared 1x1 conv (with bias)."""

    n_in = 3

    def __init__(self, d1, d2, d3):
        super().__init__()
        self.conv = Conv2d(d1, d3, 1, bias=True)

    def forward(self, xs, dtype):
        return silu(self.weighted_sum([self.conv(xs[0], dtype), self.conv(xs[1], dtype),
                                       xs[2]]))


class ASFF(nn.Module):
    """Adaptive spatial feature fusion of 3 levels of fixed widths [512,
    256, 256] (level 0 the smallest map), at the resolution of `level`."""

    def __init__(self, level, rfb=False, vis=False):
        super().__init__()
        self.level = level
        self.dim = [512, 256, 256]
        inter = self.dim[level]
        if level == 0:
            self.stride_level_1 = AddConvBlock(self.dim[1], inter, 3, 2)
            self.stride_level_2 = AddConvBlock(self.dim[2], inter, 3, 2)
            self.expand = AddConvBlock(inter, 1024, 3, 1)
        elif level == 1:
            self.compress_level_0 = AddConvBlock(self.dim[0], inter, 1, 1)
            self.stride_level_2 = AddConvBlock(self.dim[2], inter, 3, 2)
            self.expand = AddConvBlock(inter, 512, 3, 1)
        else:
            self.compress_level_0 = AddConvBlock(self.dim[0], inter, 1, 1)
            if self.dim[1] != self.dim[2]:
                self.compress_level_1 = AddConvBlock(self.dim[1], inter, 1, 1)
            self.expand = AddConvBlock(inter, 256, 3, 1)
        compress_c = 8 if rfb else 16
        self.weight_level_0 = AddConvBlock(inter, compress_c, 1, 1)
        self.weight_level_1 = AddConvBlock(inter, compress_c, 1, 1)
        self.weight_level_2 = AddConvBlock(inter, compress_c, 1, 1)
        self.weight_levels = Conv2d(compress_c * 3, 3, 1, bias=True)

    def forward(self, xs, dtype):
        x0, x1, x2 = xs
        if self.level == 0:
            r = [x0, self.stride_level_1(x1, dtype),
                 self.stride_level_2(max_pool(x2, 3, 2, 1), dtype)]
        elif self.level == 1:
            r = [upsample_nearest(self.compress_level_0(x0, dtype), 2), x1,
                 self.stride_level_2(x2, dtype)]
        else:
            r1 = (upsample_nearest(self.compress_level_1(x1, dtype), 2)
                  if self.dim[1] != self.dim[2] else upsample_nearest(x1, 2))
            r = [upsample_nearest(self.compress_level_0(x0, dtype), 4), r1, x2]
        maps = (self.weight_level_0, self.weight_level_1, self.weight_level_2)
        w = _level_weights(self.weight_levels, [m(t, dtype) for m, t in zip(maps, r)], dtype)
        fused = r[0] * w[:, 0:1] + r[1] * w[:, 1:2] + r[2] * w[:, 2:]
        return self.expand(fused, dtype)
