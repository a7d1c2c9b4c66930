"""The blocks of the flagship `ablation-ca-scconv-sppfcspc`, of YOLOv5
(with Focus, SPP and BottleneckCSP), of the SPD-Conv family (`C3CASPD2`,
`CASPD_ODRTA`), the BiFPN weighted concats and CBAM.  The transformer
blocks (C3TR, C3STR) are in `nn/transformer.py`.

Port of the matching classes of `dmayolo_tpu/nn/blocks.py`.  Attribute
names equal the JAX path parts ("cv1", "conv", "bn", "m", "0", ...), so a
JAX parameter path is a `state_dict` key after the leaf rename of
`utils/weights.py`.  Channels are dim 1 (NCHW in channels_last memory).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .primitives import (
    BatchNorm2d,
    Conv2d,
    Linear,
    Sequential,
    adaptive_avg_pool_h,
    adaptive_avg_pool_w,
    avg_pool,
    global_avg_pool,
    global_max_pool,
    hardswish,
    max_pool,
    resize_nearest,
    silu,
    space_to_depth_2x,
    upsample_nearest,
)


class ConvBN(nn.Module):
    """Conv2d + BN + SiLU, the reference's `Conv`.  After BN folding
    (`nn/fuse.py`) `bn` is an Identity."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, p, g=g, bias=False)
        self.bn = BatchNorm2d(c2)
        if act not in (True, False, None):
            raise ValueError(f"only act=True/False is ported, got {act!r}")
        self.act = act is True

    def forward(self, x, dtype):
        y = self.bn(self.conv(x, dtype), dtype)
        return silu(y) if self.act else y


class Focus(nn.Module):
    """2x2 space-to-depth, then a ConvBN."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = ConvBN(c1 * 4, c2, k, s, p, g, act)

    def forward(self, x, dtype):
        return self.conv(space_to_depth_2x(x), dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (+residual)."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_, c2, 3, 1, g=g)
        self.residual = shortcut and c1 == c2

    def forward(self, x, dtype):
        y = self.cv2(self.cv1(x, dtype), dtype)
        return x + y if self.residual else y


class BottleneckCSP(nn.Module):
    """The CSP stack of YOLOv5's first release.  `bn` normalises a concat,
    so BN folding leaves it a BatchNorm2d (eval mode after `fuse()`)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = ConvBN(2 * c_, c2, 1, 1)
        self.bn = BatchNorm2d(2 * c_)
        self.m = Sequential(*[Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)])

    def forward(self, x, dtype):
        y1 = self.cv3(self.m(self.cv1(x, dtype), dtype), dtype)
        y2 = self.cv2(x, dtype)
        return self.cv4(silu(self.bn(torch.cat([y1, y2], dim=1), dtype)), dtype)


class C3(nn.Module):
    """CSP bottleneck with 3 convs; `make_inner` builds the inner stack, n
    of `block` here."""

    block = Bottleneck

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1)
        self.m = self.make_inner(c_, n, shortcut, g)

    def make_inner(self, c_, n, shortcut, g):
        return Sequential(*[self.block(c_, c_, shortcut, g, e=1.0) for _ in range(n)])

    def forward(self, x, dtype):
        return self.cv3(torch.cat([self.m(self.cv1(x, dtype), dtype),
                                   self.cv2(x, dtype)], dim=1), dtype)


class SPPF(nn.Module):
    """Serial-pool SPP."""

    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_ * 4, c2, 1, 1)

    def forward(self, x, dtype):
        x = self.cv1(x, dtype)
        y1 = max_pool(x, self.k, 1, self.k // 2)
        y2 = max_pool(y1, self.k, 1, self.k // 2)
        y3 = max_pool(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1), dtype)


class SPP(nn.Module):
    """Parallel-pool SPP: max pools of each k in `k` (stride 1, k // 2
    padding) beside the input."""

    def __init__(self, c1, c2, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x, dtype):
        x = self.cv1(x, dtype)
        return self.cv2(torch.cat([x] + [max_pool(x, k, 1, k // 2) for k in self.k], dim=1),
                        dtype)


class Concat(nn.Module):
    """Channel concat."""

    def __init__(self, dimension=1):
        super().__init__()

    def forward(self, xs, dtype):
        return torch.cat(xs, dim=1)


class AdConcat2(nn.Module):
    """BiFPN fast-normalised weighted concat of 2 inputs: the learned `w`
    (f32, ones at init) over sum(w) + 1e-4 scales each input.  Each
    product is taken in f32 and rounded once to the activation dtype, the
    value the JAX package's f32 concat has when the next conv rounds it
    (torch's `w[i] * x` on a bf16 `x` would round `w[i]` to bf16 first)."""

    n_in = 2

    def __init__(self, dimension=1):
        super().__init__()
        self.w = nn.Parameter(torch.ones(self.n_in))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.w.fill_(1.0)

    def forward(self, xs, dtype):
        w = self.w / (self.w.sum() + 1e-4)
        return torch.cat([(x.float() * w[i]).to(x.dtype) for i, x in enumerate(xs)], dim=1)


class AdConcat3(AdConcat2):
    """The 3-input variant."""

    n_in = 3


class ChannelAttentionModule(nn.Module):
    """CBAM's channel gate: one MLP (Linear, ReLU, Linear; the ReLU at
    index 1 holds no parameters) over the global average and max pools."""

    def __init__(self, c1, reduction=16):
        super().__init__()
        mid = c1 // reduction
        self.shared_MLP = nn.ModuleDict({"0": Linear(c1, mid), "2": Linear(mid, c1)})

    def _mlp(self, x, dtype):
        return self.shared_MLP["2"](torch.relu(self.shared_MLP["0"](x, dtype)), dtype)

    def forward(self, x, dtype):
        avg = self._mlp(global_avg_pool(x)[:, :, 0, 0], dtype)
        mx = self._mlp(global_max_pool(x)[:, :, 0, 0], dtype)
        return torch.sigmoid(avg + mx)[:, :, None, None]


class SpatialAttentionModule(nn.Module):
    """CBAM's spatial gate: a 7x7 conv with a bias over the channel mean
    and max."""

    def __init__(self):
        super().__init__()
        self.conv2d = Conv2d(2, 1, 7, 1, p=3, bias=True)

    def forward(self, x, dtype):
        avg = x.mean(dim=1, keepdim=True)
        mx = x.amax(dim=1, keepdim=True)
        return torch.sigmoid(self.conv2d(torch.cat([avg, mx], dim=1), dtype))


class CBAM(nn.Module):
    """Channel, then spatial attention."""

    def __init__(self, c1, c2):
        super().__init__()
        self.channel_attention = ChannelAttentionModule(c1)
        self.spatial_attention = SpatialAttentionModule()

    def forward(self, x, dtype):
        out = self.channel_attention(x, dtype) * x
        return self.spatial_attention(out, dtype) * out


class CoorAttention(nn.Module):
    """Coordinate Attention (CVPR21); the yaml alias `CA`."""

    def __init__(self, c1, c2, reduction=32):
        super().__init__()
        c_ = max(8, c1 // reduction)
        self.conv1 = Conv2d(c1, c_, 1, bias=True)
        self.bn1 = BatchNorm2d(c_)
        self.conv_w = Conv2d(c_, c2, 1, bias=True)
        self.conv_h = Conv2d(c_, c2, 1, bias=True)

    def forward(self, x, dtype):
        h = x.shape[2]
        x_h = adaptive_avg_pool_h(x)                       # (B, C, H, 1)
        x_w = adaptive_avg_pool_w(x).permute(0, 1, 3, 2)   # (B, C, W, 1)
        y = torch.cat([x_h, x_w], dim=2)                   # (B, C, H+W, 1)
        y = hardswish(self.bn1(self.conv1(y, dtype), dtype))
        y_h, y_w = y[:, :, :h], y[:, :, h:]
        a_h = torch.sigmoid(self.conv_h(y_h, dtype))                     # (B, C2, H, 1)
        a_w = torch.sigmoid(self.conv_w(y_w.permute(0, 1, 3, 2), dtype))  # (B, C2, 1, W)
        return x * a_w * a_h


class CABottleneck(nn.Module):
    """Bottleneck with Coordinate Attention on its output (+residual)."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5, reduction=32):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_, c2, 3, 1, g=g)
        self.ca = CoorAttention(c2, c2, reduction)
        self.residual = shortcut and c1 == c2

    def forward(self, x, dtype):
        y = self.ca(self.cv2(self.cv1(x, dtype), dtype), dtype)
        return x + y if self.residual else y


class C3CA(C3):
    """C3 with CABottleneck inside, the DMA head block."""

    block = CABottleneck


class SpaceToDepth(nn.Module):
    """SPD-Conv `space_to_depth`: (B, C, H, W) -> (B, 4C, H/2, W/2)."""

    def __init__(self, dimension=1):
        super().__init__()

    def forward(self, x, dtype):
        return space_to_depth_2x(x)


class SPPFCSPC(nn.Module):
    """Serial-pool CSP-SPP, the DMA neck."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5, k=5):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = k
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(c_, c_, 3, 1)
        self.cv4 = ConvBN(c_, c_, 1, 1)
        self.cv5 = ConvBN(4 * c_, c_, 1, 1)
        self.cv6 = ConvBN(c_, c_, 3, 1)
        self.cv7 = ConvBN(2 * c_, c2, 1, 1)

    def forward(self, x, dtype):
        x1 = self.cv4(self.cv3(self.cv1(x, dtype), dtype), dtype)
        x2 = max_pool(x1, self.k, 1, self.k // 2)
        x3 = max_pool(x2, self.k, 1, self.k // 2)
        x4 = max_pool(x3, self.k, 1, self.k // 2)
        y1 = self.cv6(self.cv5(torch.cat([x1, x2, x3, x4], dim=1), dtype), dtype)
        y2 = self.cv2(x, dtype)
        return self.cv7(torch.cat([y1, y2], dim=1), dtype)


class AvgPool(nn.Module):
    """Parameter-free AvgPool2d(r) slot of SCConv's k2."""

    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x, dtype):
        return avg_pool(x, self.r)


class SCConv(nn.Module):
    """Self-calibrated conv.  k2 is [AvgPool(r), conv3x3, BN], so its keys
    read k2.1.weight and k2.2.running_mean, as the JAX paths do."""

    def __init__(self, c1, c2, stride=1, groups=1, dilation=1, pooling_r=4):
        super().__init__()
        self.pooling_r = pooling_r
        self.k2 = Sequential(AvgPool(pooling_r),
                             Conv2d(c1, c1, 3, 1, d=dilation, g=groups, bias=False),
                             BatchNorm2d(c1))
        self.k3 = Sequential(Conv2d(c1, c1, 3, 1, d=dilation, g=groups, bias=False),
                             BatchNorm2d(c1))
        self.k4 = Sequential(Conv2d(c1, c2, 3, stride, d=dilation, g=groups, bias=False),
                             BatchNorm2d(c2))

    def forward(self, x, dtype):
        h, w = x.shape[2], x.shape[3]
        r = self.pooling_r
        y = self.k2(x, dtype)
        if h % r == 0 and w % r == 0:
            gate = torch.sigmoid(x + upsample_nearest(y, r))
        else:  # the pooled map floors: nearest-resize it back to (h, w)
            gate = torch.sigmoid(x + resize_nearest(y, (h, w)))
        return self.k4(self.k3(x, dtype) * gate, dtype)


class Upsample(nn.Module):
    """nn.Upsample(None, scale, 'nearest') rows of the yamls."""

    def __init__(self, size=None, scale_factor=2, mode="nearest"):
        super().__init__()
        if mode != "nearest":
            raise ValueError("only nearest upsampling is used by the configs")
        self.scale = int(scale_factor)

    def forward(self, x, dtype):
        return upsample_nearest(x, self.scale)
