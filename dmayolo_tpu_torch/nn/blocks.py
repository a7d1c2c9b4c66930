"""The blocks of the flagship `ablation-ca-scconv-sppfcspc`, of YOLOv5
(with Focus, SPP, ASPP, C3SPP, SPPCSPC and BottleneckCSP), of the
SPD-Conv family (`C3CASPD2`, `CASPD_ODRTA`), the DM/SM downsamplers,
ConvMixer (`ConvMix`, `CSPCM`), the BiFPN weighted concats, CBAM, the
experimental blocks (CrossConv, Sum, MixConv2d, Classify) and the hub
rows (MaxPool2d, ZeroPad2d).  The transformer blocks (C3TR, C3STR) are
in `nn/transformer.py`, Ghost v1 and v2 in `nn/ghost.py`, HorNet in
`nn/hornet.py`, the adaptive fusions in `nn/fusion.py`.

Port of the matching classes of `dmayolo_tpu/nn/blocks.py`.  Attribute
names equal the JAX path parts ("cv1", "conv", "bn", "m", "0", ...), so a
JAX parameter path is a `state_dict` key after the leaf rename of
`utils/weights.py`.  Channels are dim 1 (NCHW in channels_last memory).
On the spatial path (`parallel/spatial.py`) a map is this rank's rows:
the blocks that read its height read the global one, and those that
compute on a pooled vector or a gathered column do so in `replicated()`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from .primitives import (
    ACTIVATIONS,
    BatchNorm2d,
    Conv2d,
    Linear,
    Sequential,
    adaptive_avg_pool_h,
    adaptive_avg_pool_w,
    avg_pool,
    gelu,
    global_avg_pool,
    global_max_pool,
    hardswish,
    max_pool,
    resize_nearest,
    silu,
    space_to_depth_2x,
    space_to_rows,
    upsample_nearest,
)


class ConvBN(nn.Module):
    """Conv2d + BN + activation, the reference's `Conv`: `act` True is
    SiLU, False or None none, a string a key of `ACTIVATIONS`.  After BN
    folding (`nn/fuse.py`) `bn` is an Identity."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, p, g=g, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = "silu" if act is True else "identity" if act in (False, None) else act
        if self.act not in ACTIVATIONS:
            raise ValueError(f"unknown activation {act!r}")

    def forward(self, x, dtype):
        return ACTIVATIONS[self.act](self.bn(self.conv(x, dtype), dtype))


class DWConv(ConvBN):
    """ConvBN with groups gcd(c1, c2)."""

    def __init__(self, c1, c2, k=1, s=1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


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


class C3SPP(C3):
    """C3 with an SPP inside.  Note the argument order (c1, c2, k, n, ...)."""

    def __init__(self, c1, c2, k=(5, 9, 13), n=1, shortcut=True, g=1, e=0.5):
        self._k = tuple(k)
        super().__init__(c1, c2, n, shortcut, g, e)

    def make_inner(self, c_, n, shortcut, g):
        return SPP(c_, c_, self._k)


class ASPP(nn.Module):
    """Atrous SPP: the input, a 3x3 max pool and one dilated 3x3 conv a
    rate in `k` ((k - 1) // 2), concatenated.  `m` holds the convs (keys
    "0", "1", ...), each applied to the input."""

    def __init__(self, c1, c2, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.m = Sequential(*[Conv2d(c_, c_, 3, 1, p=(r - 1) // 2, d=(r - 1) // 2, bias=False)
                              for r in k])
        self.cv2 = ConvBN(c_ * (len(k) + 2), c2, 1, 1)

    def forward(self, x, dtype):
        x = self.cv1(x, dtype)
        branches = [x, max_pool(x, 3, 1, 1)] + [m(x, dtype) for m in self.m]
        return self.cv2(torch.cat(branches, dim=1), dtype)


class Contract(nn.Module):
    """Space to channels, the channels ordered (s1, s2, c) as the
    reference's: (B, C, H, W) -> (B, s*s*C, H/s, W/s)."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x, dtype):
        x = space_to_rows(x, self.gain)
        b, c, h, w = x.shape
        s = self.gain
        v = x.permute(0, 2, 3, 1).reshape(b, h // s, s, w // s, s, c)
        v = v.permute(0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)
        return v.permute(0, 3, 1, 2)


class Expand(nn.Module):
    """Channels to space, the inverse of `Contract`."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x, dtype):
        s = self.gain
        crop = None
        if spatial.current() is not None:  # this rank's output rows o read row o // s
            gh = spatial.global_height(x)
            x, lo, o0, o1 = spatial.source_rows(x, gh, gh * s, lambda o: (o // s, o // s + 1))
            crop = slice(o0 - lo * s, o1 - lo * s)
        b, c, h, w = x.shape
        v = x.permute(0, 2, 3, 1).reshape(b, h, w, s, s, c // s ** 2)
        v = v.permute(0, 1, 3, 2, 4, 5).reshape(b, h * s, w * s, c // s ** 2)
        v = v.permute(0, 3, 1, 2)
        return v if crop is None else v[:, :, crop]


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
        avg, mx = global_avg_pool(x)[:, :, 0, 0], global_max_pool(x)[:, :, 0, 0]
        with spatial.replicated():
            return torch.sigmoid(self._mlp(avg, dtype) + self._mlp(mx, dtype))[:, :, None, None]


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
        x_h = adaptive_avg_pool_h(x)                       # (B, C, H, 1)
        x_w = adaptive_avg_pool_w(x).permute(0, 1, 3, 2)   # (B, C, W, 1)
        split = spatial.current() is not None
        if split:  # the small H column whole on every spatial rank
            x_h = spatial.gather_h(x_h)
        h = x_h.shape[2]
        with spatial.replicated():  # BN's moments count the W part once a data rank
            y = torch.cat([x_h, x_w], dim=2)                   # (B, C, H+W, 1)
            y = hardswish(self.bn1(self.conv1(y, dtype), dtype))
            y_h, y_w = y[:, :, :h], y[:, :, h:]
            a_h = torch.sigmoid(self.conv_h(y_h, dtype))                     # (B, C2, H, 1)
            a_w = torch.sigmoid(self.conv_w(y_w.permute(0, 1, 3, 2), dtype))  # (B, C2, 1, W)
        if split:
            a_h = spatial.slice_h(a_h)
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


class BAM(C3CA):
    """The reference's duplicate of C3CA, under its own name."""


class SPPCSPC(nn.Module):
    """CSP-SPP with parallel pools (YOLOv7's)."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5, k=(5, 9, 13)):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(c_, c_, 3, 1)
        self.cv4 = ConvBN(c_, c_, 1, 1)
        self.cv5 = ConvBN(4 * c_, c_, 1, 1)
        self.cv6 = ConvBN(c_, c_, 3, 1)
        self.cv7 = ConvBN(2 * c_, c2, 1, 1)

    def forward(self, x, dtype):
        x1 = self.cv4(self.cv3(self.cv1(x, dtype), dtype), dtype)
        pools = [max_pool(x1, k, 1, k // 2) for k in self.k]
        y1 = self.cv6(self.cv5(torch.cat([x1] + pools, dim=1), dtype), dtype)
        return self.cv7(torch.cat([y1, self.cv2(x, dtype)], dim=1), dtype)


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
        h, w = spatial.global_hw(x)  # `h % r` reads the global height
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


# ---------------------------------------------------------------------------
# the DM/SM downsamplers
# ---------------------------------------------------------------------------

class SM(SpaceToDepth):
    """`space_to_depth` under the name the DM yamls give it."""


class MP(nn.Module):
    """MaxPool2d(k, k)."""

    def __init__(self, k=2):
        super().__init__()
        self.k = k

    def forward(self, x, dtype):
        return max_pool(x, self.k, self.k, 0)


class SMMConv(nn.Module):
    """A 3x3 and a 5x5 ConvBN to c1 / 2 each, concatenated, then 2x2
    space-to-depth: 4 * c2 channels out (c2 = c1 here)."""

    def __init__(self, c1, c2):
        super().__init__()
        c_ = int(c1 / 2)
        self.cv1 = ConvBN(c1, c_, 3, 1)
        self.cv2 = ConvBN(c1, c_, 5, 1)

    def forward(self, x, dtype):
        return space_to_depth_2x(torch.cat([self.cv1(x, dtype), self.cv2(x, dtype)], dim=1))


class DMMConv2(nn.Module):
    """space-to-depth of the input beside a 1x1 ConvBN of its 2x2 max
    pool: 4 * c1 + c2 channels out."""

    def __init__(self, c1, c2):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1)

    def forward(self, x, dtype):
        x1 = self.cv1(max_pool(x, 2, 2, 0), dtype)
        return torch.cat([space_to_depth_2x(x), x1], dim=1)


class DMMConv(nn.Module):
    """space-to-depth of a 3x3 ConvBN beside a 1x1 ConvBN of the 2x2 max
    pool: 5 * c2 channels out."""

    def __init__(self, c1, c2):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1)
        self.cv2 = ConvBN(c1, c2, 3, 1)

    def forward(self, x, dtype):
        x1 = self.cv1(max_pool(x, 2, 2, 0), dtype)
        return torch.cat([space_to_depth_2x(self.cv2(x, dtype)), x1], dim=1)


class DMConv(nn.Module):
    """space-to-depth of a 3x3 ConvBN: 4 * c2 channels out."""

    def __init__(self, c1, c2):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 3, 1)

    def forward(self, x, dtype):
        return space_to_depth_2x(self.cv1(x, dtype))


class DMMixConv2d(nn.Module):
    """Mixed-kernel conv: one conv a kernel size in `k` (groups gcd(c1,
    its channels)), their channels split equally or by equal parameter
    counts, concatenated, then BN and SiLU.  `bn` normalises the concat,
    so BN folding leaves it a BatchNorm2d."""

    def __init__(self, c1, c2, k=(1, 3), s=1, equal_ch=True):
        super().__init__()
        n = len(k)
        if equal_ch:
            idx = np.floor(np.linspace(0, n - 1e-6, c2))
            c_ = [int((idx == g).sum()) for g in range(n)]
        else:
            b = [c2] + [0] * n
            a = np.eye(n + 1, n, k=-1)
            a -= np.roll(a, 1, axis=1)
            a *= np.array(k) ** 2
            a[0] = 1
            c_ = np.linalg.lstsq(a, b, rcond=None)[0].round().astype(int)
        self.m = Sequential(*[Conv2d(c1, int(ci), ki, s, p=ki // 2, g=math.gcd(c1, int(ci)),
                                     bias=False) for ki, ci in zip(k, c_)])
        self.bn = BatchNorm2d(c2)

    def forward(self, x, dtype):
        return silu(self.bn(torch.cat([m(x, dtype) for m in self.m], dim=1), dtype))


class MixConv2d(DMMixConv2d):
    """The experimental MixConv2d: DMMixConv2d's arithmetic."""


# ---------------------------------------------------------------------------
# ConvMixer
# ---------------------------------------------------------------------------

class GELU(nn.Module):
    """The GELU slot of ConvMix's Sequentials (no parameters)."""

    def forward(self, x, dtype):
        return gelu(x)


class ConvMix(nn.Module):
    """ConvMixer block: x + BN(GELU(depthwise k x k conv(x))), then
    BN(GELU(1x1 conv)).  `Resnet` and `Conv_1x1` are [conv, GELU, BN], so
    their keys read Resnet.0 and Resnet.2 as the JAX paths do; a GELU
    sits between conv and BN, so BN folding leaves both BNs."""

    def __init__(self, dim, dim1, kernel_size=9):
        super().__init__()
        self.Resnet = Sequential(Conv2d(dim, dim, kernel_size, 1, p=kernel_size // 2, g=dim,
                                        bias=True), GELU(), BatchNorm2d(dim))
        self.Conv_1x1 = Sequential(Conv2d(dim, dim, 1, bias=True), GELU(), BatchNorm2d(dim))

    def forward(self, x, dtype):
        return self.Conv_1x1(x + self.Resnet(x, dtype), dtype)


class CSPCM(nn.Module):
    """CSP of ConvMix blocks."""

    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1)
        self.m = Sequential(*[ConvMix(c_, c_) for _ in range(n)])

    def forward(self, x, dtype):
        return self.cv3(torch.cat([self.m(self.cv1(x, dtype), dtype), self.cv2(x, dtype)],
                                  dim=1), dtype)


# ---------------------------------------------------------------------------
# the experimental blocks and the hub rows
# ---------------------------------------------------------------------------

class CrossConv(nn.Module):
    """1 x k then k x 1 ConvBN (+residual)."""

    def __init__(self, c1, c2, k=3, s=1, g=1, e=1.0, shortcut=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, (1, k), (1, s))
        self.cv2 = ConvBN(c_, c2, (k, 1), (s, 1), g=g)
        self.residual = shortcut and c1 == c2

    def forward(self, x, dtype):
        y = self.cv2(self.cv1(x, dtype), dtype)
        return x + y if self.residual else y


class Sum(nn.Module):
    """Sum of n inputs; weighted, input i > 0 scaled by 2 sigmoid(w[i -
    1]) (f32 `w`, -arange(1, n) / 2 at init, so the sum promotes to f32
    as JAX's does)."""

    def __init__(self, n, weight=False):
        super().__init__()
        self.n = n
        self.w = nn.Parameter(torch.empty(n - 1)) if weight else None

    def reset_parameters(self, generator=None):
        if self.w is not None:
            with torch.no_grad():
                self.w.copy_(-torch.arange(1.0, self.n) / 2)

    def forward(self, xs, dtype):
        y = xs[0]
        w = None if self.w is None else torch.sigmoid(self.w) * 2
        for i in range(self.n - 1):
            y = y + (xs[i + 1] if w is None else xs[i + 1] * w[i:i + 1])
        return y


class Classify(nn.Module):
    """Second-stage classification head: global average pools of the
    inputs, concatenated, through a conv -> (B, c2)."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, p, g=g, bias=True)

    def forward(self, x, dtype):
        xs = x if isinstance(x, list) else [x]
        z = torch.cat([global_avg_pool(t) for t in xs], dim=1)
        with spatial.replicated():
            return self.conv(z, dtype)[:, :, 0, 0]


class MaxPool2d(nn.Module):
    """nn.MaxPool2d(k, s, p) rows of the hub yamls."""

    def __init__(self, k, s=None, p=0):
        super().__init__()
        self.k, self.s, self.p = k, k if s is None else s, p

    def forward(self, x, dtype):
        return max_pool(x, self.k, self.s, self.p)


class ZeroPad2d(nn.Module):
    """nn.ZeroPad2d(padding) rows: (left, right, top, bottom)."""

    def __init__(self, padding):
        super().__init__()
        self.p = tuple(padding) if isinstance(padding, (list, tuple)) else (padding,) * 4

    def forward(self, x, dtype):
        left, right, top, bottom = self.p
        if spatial.current() is None:
            return F.pad(x, self.p)
        # the top rows belong to the first rank, the bottom ones to the last
        h = spatial.global_height(x)
        x = spatial.source_rows(x, h, h + top + bottom, lambda o: (o - top, o - top + 1))[0]
        return F.pad(x, (left, right, 0, 0))
