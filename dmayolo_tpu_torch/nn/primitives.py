"""Leaf layers: conv, batchnorm, linear, layernorm, dropout, activations,
pooling, resize.

Port of `dmayolo_tpu/nn/primitives.py`.  Feature maps are NCHW tensors in
`channels_last` memory (the JAX package's NHWC, seen through a permute);
conv weights are OIHW.  Every module's forward takes `(x, dtype)`, where
`dtype` is the compute dtype of conv inputs (the JAX `ApplyCtx.dtype`).

Inside `parallel.spatial.spatial_scope` a map is this rank's rows of the
global one, and every op here that reads along H takes its spatial form
(`parallel/spatial.py`): a conv or pool runs on its fetched input
interval, a resize reads its source rows by the global index rule at the
global size, an H reduction sums over the spatial group, BN's train
moments run over every rank.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..parallel import spatial
from ..parallel.mesh import with_group
from .conv_int8 import Int8Conv

KernelSize = Union[int, Tuple[int, int]]


def _pair(x: KernelSize) -> Tuple[int, int]:
    return (x, x) if isinstance(x, int) else tuple(x)


def autopad(k: KernelSize, p=None):
    """'same' padding for odd kernels."""
    if p is None:
        p = k // 2 if isinstance(k, int) else tuple(x // 2 for x in k)
    return p


def _no_rows(x, c: int, w: int, dtype, *inputs):
    """The (B, c, 0, w) output of an op whose rows on this spatial rank
    are none, joined to the graph through `inputs` with a zero gradient:
    every rank then runs the same backward, collectives included."""
    y = x.new_zeros((x.shape[0], c, 0, w), dtype=dtype)
    for t in inputs:
        if t is not None:
            y = y + (t.sum() * 0).to(dtype)
    return y.contiguous(memory_format=torch.channels_last)


def _out_size(n: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def silu(x):
    return F.silu(x)


def hardswish(x):
    return F.hardswish(x)


def gelu(x):
    """The exact erf form (JAX `approximate=False`)."""
    return F.gelu(x)


def leaky_relu(x, slope=0.1):
    return F.leaky_relu(x, slope)


def mish(x):
    return x * torch.tanh(F.softplus(x))


# the string activations of the yamls and `ConvBN(act=...)`
ACTIVATIONS = {
    "silu": silu,
    "hardswish": hardswish,
    "leaky0.1": lambda x: leaky_relu(x, 0.1),
    "relu": torch.relu,
    "gelu": gelu,
    "mish": mish,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


# ---------------------------------------------------------------------------
# conv / norm
# ---------------------------------------------------------------------------

class Conv2d(nn.Module):
    """Raw conv.  Weight and input are cast to the compute dtype; the bias
    is added in the output dtype, as the JAX Conv2d does.  A depthwise
    conv (one input channel a group, groups > 1) runs inside the profiler
    range "depthwise conv".

    While `int8` holds an `Int8Conv` (set for one call by
    `DetectionModel.apply(quant=...)`), the conv runs the int8 PTQ path
    instead (`nn/conv_int8.py`), inside the profiler range "int8 conv"."""

    def __init__(self, c1, c2, k: KernelSize = 1, s: KernelSize = 1, p=None,
                 g: int = 1, d: int = 1, bias: bool = True):
        super().__init__()
        self.c1, self.c2 = c1, c2
        self.int8: Optional[Int8Conv] = None
        self._int8_form: Optional[Int8Conv] = None
        self.k = _pair(k)
        self.s = _pair(s)
        self.p = _pair(autopad(k, p))
        self.g = g
        self.d = _pair(d)
        self.weight = nn.Parameter(torch.empty(c2, c1 // g, *self.k))
        self.bias = nn.Parameter(torch.empty(c2)) if bias else None
        self.depthwise = 1 < g == c1

    def reset_parameters(self, generator: torch.Generator):
        """torch's default init, U(+-1/sqrt(fan_in)), drawn from `generator`."""
        fan_in = self.weight[0].numel()
        bound = fan_in ** -0.5
        for p in (self.weight, self.bias):
            if p is not None:
                v = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
                p.data.copy_(v)

    def int8_form(self, s_x: float) -> Int8Conv:
        """The int8 form of this conv for input scale `s_x`, made once and
        kept while the scale and the weights stay as they are."""
        form = self._int8_form
        if form is None or not form.matches(self, s_x):
            form = self._int8_form = Int8Conv(self, s_x)
        return form

    def forward(self, x, dtype):
        sp = spatial.current()
        pad_h = self.p
        if sp is not None and (self.k[0], self.s[0], self.p[0]) != (1, 1, 0):
            # this rank's output rows from their fetched input interval: the
            # float conv with no H padding, the int8 form (whose kernel route
            # the geometry picks) with its own padding and the extra rows
            # dropped
            x, start, n = spatial.window_rows(x, self.k[0], self.s[0], self.p[0], self.d[0],
                                              keep_pad=self.int8 is not None)
            pad_h = (0, self.p[1])
            if self.int8 is not None and n:
                with record_function("int8 conv"):
                    return self.int8(x, dtype)[:, :, start:start + n]
        if sp is not None and x.shape[2] == 0:
            wo = _out_size(x.shape[3], self.k[1], self.s[1], self.p[1], self.d[1])
            return _no_rows(x, self.c2, wo, dtype, x, self.weight, self.bias)
        if self.int8 is not None:
            with record_function("int8 conv"):
                return self.int8(x, dtype)
        with record_function("depthwise conv") if self.depthwise else contextlib.nullcontext():
            y = F.conv2d(x.to(dtype), self.weight.to(dtype), None, self.s, pad_h,
                         self.d, self.g)
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)[None, :, None, None]
        return y


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BN over (N, H, W) per channel, as the JAX package computes
    it: moments in f32 as E[x^2] - E[x]^2 clamped at 0, output
    `((x - mean) * rsqrt(var + eps) * scale + bias)` in f32, cast to the
    input dtype.  The backward is that formula's derivative; only the
    input (in its own dtype) and two f32 vectors are kept for it.  Its
    outputs: y, the mean, and the variance times n / (n - 1) for the
    running statistics.

    Under a data-parallel group (`mesh`), the moments are the global
    batch's: the channel sums, the sums of squares and the count in one
    all-reduce; the backward all-reduces its two channel sums for the
    input's gradient, and returns the rank's own sums as the scale's and
    bias's (the train step sums those over the group)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, mesh=None):
        xf = x.float()
        c = x.shape[1]
        if mesh is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(min=0)
            n = x.numel() // c
            unbiased = var * (n / max(n - 1, 1))
        else:
            sums = torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)),
                              xf.new_full((1,), x.numel() // c)])
            mesh.all_reduce(sums)
            n = sums[2 * c:]
            mean = sums[:c] / n
            var = (sums[c:2 * c] / n - mean.square()).clamp(min=0)
            unbiased = var * (n / (n - 1).clamp(min=1))
        rstd = torch.rsqrt(var + eps)
        inv = rstd * scale
        y = ((xf - mean[:, None, None]) * inv[:, None, None] + bias[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mesh, ctx.n = mesh, n
        ctx.mark_non_differentiable(mean, unbiased)
        return y, mean, unbiased

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, rstd = ctx.saved_tensors
        g = dy.float()
        xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
        dbias = g.sum(dim=(0, 2, 3))
        dscale = (g * xhat).sum(dim=(0, 2, 3))
        n, mesh = ctx.n, ctx.mesh
        gb, gs = dbias, dscale
        if mesh is not None:  # the global sums for the input's gradient
            c = dbias.shape[0]
            both = mesh.all_reduce(torch.cat([dbias, dscale]))
            gb, gs = both[:c], both[c:]
        dx = (g - (gb / n)[:, None, None] - xhat * (gs / n)[:, None, None]) \
            * (rstd * scale)[:, None, None]
        return dx.to(x.dtype), dscale, dbias, None, None


class BatchNorm2d(nn.Module):
    """BatchNorm, eps 1e-3 and momentum 0.03 (the values the reference
    forces on every BN).

    Eval mode (`module.eval()`): the per-channel affine is computed in f32
    and applied in the activation dtype, as the JAX eval path does.  Train
    mode (`module.train()`, the JAX `ctx.train`): batch moments in f32
    (`_BatchNormTrain`), and the running mean and the unbiased variance
    (factor n / (n - 1)) updated in place with momentum 0.03, except in
    the backward's recompute of a rematerialised layer (`remat_layer`
    sets `recomputing`), whose forward has updated them already.  While
    `lend_mesh` lends it a data-parallel group (`mesh`), the batch is the
    global one: moments and n over every rank's rows, as under a JAX
    mesh, where BN is always cross-replica.  Inside a spatial scope the
    group is the spatial context's (`SpatialContext.bn_mesh`): every rank
    for a row-split map, the data subgroup for a replicated one.  Halo rows
    never reach BN: each rank normalises its own rows."""

    def __init__(self, c, eps: float = 1e-3, momentum: float = 0.03):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.recomputing = False
        self.mesh = None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, dtype):
        if self.training:
            sp = spatial.active()
            mesh = self.mesh if sp is None else sp.bn_mesh()
            y, mean, unbiased = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps, mesh)
            if self.recomputing:
                return y
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
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


class Linear(nn.Module):
    """nn.Linear's layout (`weight` (out, in)) with the JAX `Dense`'s
    arithmetic: the product in `dtype`, the bias added in the output
    dtype."""

    def __init__(self, c1, c2, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c2, c1))
        self.bias = nn.Parameter(torch.empty(c2)) if bias else None

    def reset_parameters(self, generator: torch.Generator):
        """U(+-1/sqrt(fan_in)) for the weight and the bias, from `generator`."""
        bound = self.weight.shape[1] ** -0.5
        for p in (self.weight, self.bias):
            if p is not None:
                p.data.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    def forward(self, x, dtype):
        y = torch.matmul(x.to(dtype), self.weight.to(dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5: moments and affine in f32
    (f64 for an f64 input), the result in the input dtype."""

    def __init__(self, c, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, dtype=None):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.layer_norm(xf, self.weight.shape, self.weight, self.bias, self.eps).to(x.dtype)


class _Stochastic(nn.Module):
    """A layer that draws a mask in train mode at a rate above 0, from the
    generator that `lend_generator` gives it for the step, never from the
    global RNG.  While `lend_mesh` lends it a data-parallel group, it draws
    the global batch's numbers (dim 0 times the data axis's size) and takes
    this rank's rows, so a row's mask is the one a single process would
    draw; inside a spatial scope the group is the spatial context's, and
    on a row-split map it also draws the global map's rows and takes its
    own (the ranks of a spatial group draw the same numbers)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.mesh = None

    def draws(self) -> bool:
        return self.training and self.rate > 0.0

    def uniform(self, shape, x, rows: bool = True):
        """Uniform numbers of `shape` for `x`: with a mesh, the global
        tensor's numbers and this rank's batch rows, and where `rows` (a
        mask with x's rows along H) and x is row-split, also its H rows."""
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__}({self.rate}) in train mode draws its "
                               "mask from the step's generator: call it inside "
                               "lend_generator(model, generator)")
        sp = spatial.current()
        mesh = self.mesh if spatial.active() is None else spatial.active().mesh
        if mesh is None:
            return torch.rand(shape, dtype=x.dtype, device=x.device, generator=self.generator)
        n, shape = shape[0], list(shape)
        h = spatial.global_height(x) if sp is not None and rows and len(shape) == 4 else None
        if h is not None:  # a row-split map: the global map's numbers, this rank's rows
            shape[2] = h
        u = torch.rand([n * mesh.n_data] + shape[1:], dtype=x.dtype, device=x.device,
                       generator=self.generator)
        u = u[mesh.data_rank * n:(mesh.data_rank + 1) * n]
        return u if h is None else spatial.rows_of(u, h)


class Dropout(_Stochastic):
    """Each element kept with probability 1 - rate and scaled by
    1 / (1 - rate); the identity in eval mode or at rate 0."""

    def forward(self, x, dtype=None):
        if not self.draws():
            return x
        keep = 1.0 - self.rate
        return torch.where(self.uniform(x.shape, x) < keep, x / keep, 0.0)


class DropPath(_Stochastic):
    """Stochastic depth: each sample (dim 0) kept whole with probability
    1 - rate, as floor(keep + U), and scaled by 1 / keep."""

    def forward(self, x, dtype=None):
        if not self.draws():
            return x
        keep = 1.0 - self.rate
        mask = torch.floor(keep + self.uniform((x.shape[0],) + (1,) * (x.dim() - 1), x,
                                                 rows=False))
        return x / keep * mask


@contextlib.contextmanager
def lend_generator(model: nn.Module, generator: Optional[torch.Generator]):
    """Every Dropout and DropPath of `model` draws from `generator` inside
    the block, and from nothing after it."""
    mods = [m for m in model.modules() if isinstance(m, _Stochastic)]
    for m in mods:
        m.generator = generator
    try:
        yield
    finally:
        for m in mods:
            m.generator = None


@contextlib.contextmanager
def lend_mesh(model: nn.Module, mesh):
    """Every BatchNorm2d, Dropout and DropPath of `model` reduces over, or
    draws for, the global batch of `mesh`'s group inside the block (the
    train step's forwards and backwards, recomputes included); a mesh
    without a group, or None, lends nothing."""
    mesh = with_group(mesh)
    mods = [m for m in model.modules() if isinstance(m, (BatchNorm2d, _Stochastic))]
    for m in mods:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in mods:
            m.mesh = None


# ---------------------------------------------------------------------------
# pooling / resize (NCHW)
# ---------------------------------------------------------------------------

def max_pool(x, k: int, s: int = 1, p: Optional[int] = None):
    """MaxPool2d(k, s, p); the padding never wins (-inf)."""
    if p is None:
        p = k // 2 if s == 1 else 0
    if spatial.current() is not None:
        slab, _, n = spatial.window_rows(x, k, s, p, pad=float("-inf"))
        if n == 0:
            return _no_rows(x, x.shape[1], _out_size(x.shape[3], k, s, p), x.dtype, slab)
        return F.max_pool2d(slab, k, s, (0, p))
    return F.max_pool2d(x, k, s, p)


def avg_pool(x, k: int, s: Optional[int] = None, p: int = 0):
    """AvgPool2d(k, s, p), the padding counted in the mean
    (count_include_pad)."""
    s = k if s is None else s
    if spatial.current() is not None:  # the fetched zero rows are the H padding
        slab, _, n = spatial.window_rows(x, k, s, p)
        if n == 0:
            return _no_rows(x, x.shape[1], _out_size(x.shape[3], k, s, p), x.dtype, slab)
        return F.avg_pool2d(slab, k, s, (0, p), count_include_pad=True)
    return F.avg_pool2d(x, k, s, p, count_include_pad=True)


def adaptive_avg_pool_h(x):
    """AdaptiveAvgPool2d((None, 1)): mean over W -> (B, C, H, 1)."""
    return x.mean(dim=3, keepdim=True)


def adaptive_avg_pool_w(x):
    """AdaptiveAvgPool2d((1, None)): mean over H -> (B, C, 1, W); on
    row-split maps an f32 sum over the spatial group, then the mean."""
    if spatial.current() is not None:
        h = spatial.global_height(x)
        return (spatial.sum_h(x.float().sum(dim=2, keepdim=True)) / h).to(x.dtype)
    return x.mean(dim=2, keepdim=True)


def global_avg_pool(x):
    """AdaptiveAvgPool2d(1) -> (B, C, 1, 1), the same on every spatial
    rank of a row-split map."""
    if spatial.current() is not None:
        hw = spatial.global_height(x) * x.shape[3]
        return (spatial.sum_h(x.float().sum(dim=(2, 3), keepdim=True)) / hw).to(x.dtype)
    return x.mean(dim=(2, 3), keepdim=True)


def global_max_pool(x):
    """AdaptiveMaxPool2d(1) -> (B, C, 1, 1), the same on every spatial
    rank of a row-split map."""
    if spatial.current() is not None:
        return spatial.max_h(x)
    return x.amax(dim=(2, 3), keepdim=True)


def upsample_nearest(x, scale: int):
    """Integer nearest upsample."""
    if spatial.current() is not None:
        h = spatial.global_height(x)
        slab, lo, o0, o1 = spatial.source_rows(x, h, h * scale,
                                               lambda o: (o // scale, o // scale + 1))
        if o1 == o0:
            return _no_rows(x, x.shape[1], x.shape[3] * scale, x.dtype, slab)
        y = F.interpolate(slab, scale_factor=scale, mode="nearest")
        return y[:, :, o0 - lo * scale:o1 - lo * scale]
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def resize_nearest(x, size: Tuple[int, int]):
    """Nearest resize to (H, W) with the JAX package's index rule
    src = dst * in // out, in integers (`size` global on row-split maps)."""
    sp = spatial.current()
    h = spatial.global_height(x) if sp is not None else x.shape[2]
    w = x.shape[3]
    th, tw = size
    if th % h == 0 and tw % w == 0 and th // h == tw // w:
        return upsample_nearest(x, th // h)
    rows = torch.arange(th, device=x.device) * h // th
    cols = torch.arange(tw, device=x.device) * w // tw
    if sp is not None:
        x, lo, o0, o1 = spatial.source_rows(x, h, th,
                                            lambda o: (o * h // th, o * h // th + 1))
        rows = rows[o0:o1] - lo
    return x[:, :, rows][:, :, :, cols]


def bilinear_resize_align_corners(x, size: Tuple[int, int]):
    """F.interpolate(mode="bilinear", align_corners=True) with the JAX
    package's arithmetic: f32 source coordinates and weights, so a bf16
    map comes back f32, as JAX's promotion gives; a 1 x 1 map is
    broadcast and keeps its dtype.  Works on the NHWC view, so a
    `channels_last` map gives a `channels_last` one.  On row-split maps
    `size` is global and each rank computes its output rows."""
    b, c, _, w = x.shape
    sp = spatial.current()
    h = spatial.global_height(x) if sp is not None else x.shape[2]
    th, tw = size
    o0, o1 = 0, th
    ys = torch.linspace(0.0, h - 1.0, th, device=x.device)
    y0 = ys.floor().long()
    y1 = (y0 + 1).clamp(max=h - 1)
    if sp is not None:
        span = (lambda o: (0, 1)) if h == 1 else (lambda o: (int(y0[o]), int(y1[o]) + 1))
        x, lo, o0, o1 = spatial.source_rows(x, h, th, span)
        if o1 == o0:
            return _no_rows(x, c, tw, x.dtype if h == 1 and w == 1 else torch.promote_types(
                x.dtype, torch.float32), x)
        ys, y0, y1 = ys[o0:o1], y0[o0:o1] - lo, y1[o0:o1] - lo
    if h == 1 and w == 1:
        return x.expand(b, c, o1 - o0, tw)
    xs = torch.linspace(0.0, w - 1.0, tw, device=x.device)
    x0 = xs.floor().long()
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (ys - ys.floor())[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    v = x.permute(0, 2, 3, 1)  # (B, H, W, C)
    r0, r1 = v[:, y0], v[:, y1]
    top = r0[:, :, x0] * (1 - wx) + r0[:, :, x1] * wx
    bot = r1[:, :, x0] * (1 - wx) + r1[:, :, x1] * wx
    return (top * (1 - wy) + bot * wy).permute(0, 3, 1, 2)


def space_to_rows(x, s: int):
    """This rank's source rows of an s-to-1 row fold (space-to-depth or
    `Contract`) of a row-split map: output row o reads rows [s o, s o + s)
    (None off the spatial path: the map itself)."""
    if spatial.current() is None:
        return x
    h = spatial.global_height(x)
    if h % s:
        raise ValueError(f"{spatial.current().where()}: a space-to-depth of {s} needs a "
                         f"height that divides, got {h}")
    return spatial.source_rows(x, h, h // s, lambda o: (s * o, s * o + s))[0]


def space_to_depth_2x(x):
    """SPD-Conv slice-cat: (B, C, H, W) -> (B, 4C, H/2, W/2), the channel
    blocks in the reference's order: top-left, bottom-left, top-right,
    bottom-right.  A `channels_last` input gives a `channels_last` output,
    so the conv after it reads it as it is."""
    x = space_to_rows(x, 2)
    return torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2],
                      x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]], dim=1)


class _Recompute:
    """The context of one layer's recompute in the backward: its BNs leave
    their running statistics alone, and its Dropout and DropPath draw from
    the generator they were lent in the forward, restored to the state it
    had when the forward reached the layer, so they draw the same masks.
    The generator's own state is put back on exit."""

    def __init__(self, bns, stochastic, generator, state):
        self.bns, self.stochastic = bns, stochastic
        self.generator, self.state = generator, state

    def __enter__(self):
        for m in self.bns:
            m.recomputing = True
        self.lent = [m.generator for m in self.stochastic]
        for m in self.stochastic:
            m.generator = self.generator
        if self.generator is not None:
            self.after = self.generator.get_state()
            self.generator.set_state(self.state)

    def __exit__(self, *exc):
        if self.generator is not None:
            self.generator.set_state(self.after)
        for m, g in zip(self.stochastic, self.lent):
            m.generator = g
        for m in self.bns:
            m.recomputing = False


def remat_layer(layer: nn.Module, x, dtype):
    """`layer(x, dtype)` whose activations are recomputed in the backward
    instead of kept (`torch.utils.checkpoint`, non-reentrant): the port of
    the JAX `jax.checkpoint` a graph layer.  The recompute reproduces the
    forward exactly (see `_Recompute`)."""
    bns = [m for m in layer.modules() if isinstance(m, BatchNorm2d)]
    stochastic = [m for m in layer.modules() if isinstance(m, _Stochastic)]
    lent = {m.generator for m in stochastic if m.draws()}
    if len(lent) > 1:
        raise RuntimeError("the layer's Dropout and DropPath hold different generators")
    generator = lent.pop() if lent else None
    state = generator.get_state() if generator is not None else None
    return checkpoint(
        layer, x, dtype, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _Recompute(bns, stochastic, generator, state)))
