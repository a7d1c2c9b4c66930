"""Leaf layers: conv, batchnorm, activations, pooling, resize.

Port of `dmayolo_tpu/nn/primitives.py`.  Feature maps are NCHW tensors in
`channels_last` memory (the JAX package's NHWC, seen through a permute);
conv weights are OIHW.  Every module's forward takes `(x, dtype)`, where
`dtype` is the compute dtype of conv inputs (the JAX `ApplyCtx.dtype`).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

KernelSize = Union[int, Tuple[int, int]]


def _pair(x: KernelSize) -> Tuple[int, int]:
    return (x, x) if isinstance(x, int) else tuple(x)


def autopad(k: KernelSize, p=None):
    """'same' padding for odd kernels."""
    if p is None:
        p = k // 2 if isinstance(k, int) else tuple(x // 2 for x in k)
    return p


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def silu(x):
    return F.silu(x)


def hardswish(x):
    return F.hardswish(x)


# ---------------------------------------------------------------------------
# conv / norm
# ---------------------------------------------------------------------------

class Conv2d(nn.Module):
    """Raw conv.  Weight and input are cast to the compute dtype; the bias
    is added in the output dtype, as the JAX Conv2d does."""

    def __init__(self, c1, c2, k: KernelSize = 1, s: KernelSize = 1, p=None,
                 g: int = 1, d: int = 1, bias: bool = True):
        super().__init__()
        self.k = _pair(k)
        self.s = _pair(s)
        self.p = _pair(autopad(k, p))
        self.g = g
        self.d = _pair(d)
        self.weight = nn.Parameter(torch.empty(c2, c1 // g, *self.k))
        self.bias = nn.Parameter(torch.empty(c2)) if bias else None

    def reset_parameters(self, generator: torch.Generator):
        """torch's default init, U(+-1/sqrt(fan_in)), drawn from `generator`."""
        fan_in = self.weight[0].numel()
        bound = fan_in ** -0.5
        for p in (self.weight, self.bias):
            if p is not None:
                v = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
                p.data.copy_(v)

    def forward(self, x, dtype):
        y = F.conv2d(x.to(dtype), self.weight.to(dtype), None, self.s, self.p,
                     self.d, self.g)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None, :, None, None]
        return y


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BN over (N, H, W) per channel, as the JAX package computes
    it: moments in f32 as E[x^2] - E[x]^2 clamped at 0, output
    `((x - mean) * rsqrt(var + eps) * scale + bias)` in f32, cast to the
    input dtype.  The backward is that formula's derivative; only the
    input (in its own dtype) and two f32 vectors are kept for it."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(min=0)
        rstd = torch.rsqrt(var + eps)
        inv = rstd * scale
        y = ((xf - mean[:, None, None]) * inv[:, None, None] + bias[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, rstd = ctx.saved_tensors
        g = dy.float()
        xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
        dbias = g.sum(dim=(0, 2, 3))
        dscale = (g * xhat).sum(dim=(0, 2, 3))
        n = x.numel() // x.shape[1]
        dx = (g - (dbias / n)[:, None, None] - xhat * (dscale / n)[:, None, None]) \
            * (rstd * scale)[:, None, None]
        return dx.to(x.dtype), dscale, dbias, None


class BatchNorm2d(nn.Module):
    """BatchNorm, eps 1e-3 and momentum 0.03 (the values the reference
    forces on every BN).

    Eval mode (`module.eval()`): the per-channel affine is computed in f32
    and applied in the activation dtype, as the JAX eval path does.  Train
    mode (`module.train()`, the JAX `ctx.train`): batch moments in f32
    (`_BatchNormTrain`), and the running mean and the unbiased variance
    (factor n / (n - 1)) updated in place with momentum 0.03."""

    def __init__(self, c, eps: float = 1e-3, momentum: float = 0.03):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, dtype):
        if self.training:
            y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps)
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
            return y
        a = torch.rsqrt(self.running_var + self.eps) * self.weight
        b = self.bias - self.running_mean * a
        return x * a.to(x.dtype)[None, :, None, None] + b.to(x.dtype)[None, :, None, None]


class Identity(nn.Module):
    """Stands where a BN was folded into its conv."""

    def forward(self, x, dtype):
        return x


class Sequential(nn.Sequential):
    """nn.Sequential whose children take `(x, dtype)`; keys "0", "1", ..."""

    def forward(self, x, dtype):
        for m in self:
            x = m(x, dtype)
        return x


# ---------------------------------------------------------------------------
# pooling / resize (NCHW)
# ---------------------------------------------------------------------------

def max_pool(x, k: int, s: int = 1, p: Optional[int] = None):
    """MaxPool2d(k, s, p); the padding never wins (-inf)."""
    if p is None:
        p = k // 2 if s == 1 else 0
    return F.max_pool2d(x, k, s, p)


def avg_pool(x, k: int, s: Optional[int] = None):
    """AvgPool2d(k, s) without padding."""
    return F.avg_pool2d(x, k, k if s is None else s)


def adaptive_avg_pool_h(x):
    """AdaptiveAvgPool2d((None, 1)): mean over W -> (B, C, H, 1)."""
    return x.mean(dim=3, keepdim=True)


def adaptive_avg_pool_w(x):
    """AdaptiveAvgPool2d((1, None)): mean over H -> (B, C, 1, W)."""
    return x.mean(dim=2, keepdim=True)


def upsample_nearest(x, scale: int):
    """Integer nearest upsample."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def resize_nearest(x, size: Tuple[int, int]):
    """Nearest resize to (H, W) with the JAX package's index rule
    src = dst * in // out, in integers."""
    h, w = x.shape[2], x.shape[3]
    th, tw = size
    if th % h == 0 and tw % w == 0 and th // h == tw // w:
        return upsample_nearest(x, th // h)
    rows = torch.arange(th, device=x.device) * h // th
    cols = torch.arange(tw, device=x.device) * w // tw
    return x[:, :, rows][:, :, :, cols]


def space_to_depth_2x(x):
    """SPD-Conv slice-cat: (B, C, H, W) -> (B, 4C, H/2, W/2), the channel
    blocks in the reference's order: top-left, bottom-left, top-right,
    bottom-right.  A `channels_last` input gives a `channels_last` output,
    so the conv after it reads it as it is."""
    return torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2],
                      x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]], dim=1)

