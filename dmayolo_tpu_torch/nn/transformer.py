"""The transformer blocks: the ViT stack of C3TR and the Swin stack of
C3STR (the TPH-YOLOv5 prediction head).

Port of the matching classes of `dmayolo_tpu/nn/blocks.py`, attribute
names equal to the JAX path parts.  Attention follows the JAX order of
operations: the logits q·kᵀ in f32 (from q and k in the compute dtype),
the bias table, the shift mask and the softmax in f32, the probabilities
cast to the value dtype before the product with v.  A block takes and
gives NCHW in `channels_last` memory; inside, it works on the NHWC view
(`x.permute(0, 2, 3, 1)`), which that memory makes contiguous.

The Swin helpers (relative position index, shift mask) are computed on
the host with numpy per static map size and kept as tensors in caches
keyed by device, outside the `state_dict`: the model is built on the meta
device, and a buffer filled in `__init__` would not survive `to_empty`.

Profiler ranges mark the attention core ("attention": logits, bias, mask,
softmax, the product with v) and the Swin layer's other work
("layernorm", "gelu", "window shuffle": pad, roll, partition and back).

On the spatial path (`parallel/spatial.py`) both blocks run on the whole
map (`whole_map`): attention reads every token, and Swin's padding,
cyclic shift and mask read every row.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..parallel import spatial
from .blocks import C3, ConvBN
from .primitives import Dropout, DropPath, LayerNorm, Linear, Sequential, gelu


def _logits(q, k):
    """q·kᵀ over the last two axes, in f32 from inputs in any dtype (f64
    from f64 inputs)."""
    dt = torch.promote_types(q.dtype, torch.float32)
    return torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2))


# ---------------------------------------------------------------------------
# ViT (C3TR)
# ---------------------------------------------------------------------------

class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (`in_proj_weight` (3C, C),
    `in_proj_bias`, the `out_proj` Linear) over (B, L, C) tokens; the
    scale 1/sqrt(head dim) on the f32 logits."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.h = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * c))
        self.out_proj = Linear(c, c)

    def reset_parameters(self, generator: torch.Generator):
        """in_proj U(+-1/sqrt(c)), its bias zeros (the JAX init)."""
        c = self.in_proj_weight.shape[1]
        bound = c ** -0.5
        with torch.no_grad():
            self.in_proj_weight.copy_(torch.empty(3 * c, c).uniform_(-bound, bound,
                                                                      generator=generator))
            self.in_proj_bias.zero_()

    def forward(self, qkv: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], dtype):
        w = self.in_proj_weight.to(dtype)
        b = self.in_proj_bias.to(dtype)
        wq, wk, wv = w.chunk(3, dim=0)
        bq, bk, bv = b.chunk(3)
        q, k, v = (torch.matmul(t.to(dtype), wt.t()) + bt
                   for t, wt, bt in zip(qkv, (wq, wk, wv), (bq, bk, bv)))
        bsz, n, c = q.shape
        hd = c // self.h

        def split_heads(t):
            return t.reshape(bsz, n, self.h, hd).transpose(1, 2)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        with record_function("attention"):
            attn = torch.softmax(_logits(q, k) / np.sqrt(hd), dim=-1).to(v.dtype)
            out = torch.matmul(attn, v).transpose(1, 2).reshape(bsz, n, c)
        return self.out_proj(out, dtype)


def whole_map(fn, x, dtype):
    """`fn(x, dtype)` on the whole map: on the spatial path the map is
    gathered over the spatial group, `fn` runs replicated, and each rank
    keeps its rows (attention and Swin's windows and shifts read every
    row)."""
    if spatial.current() is None:
        return fn(x, dtype)
    full = spatial.gather_h(x)
    with spatial.replicated():
        y = fn(full, dtype)
    return spatial.slice_h(y)


class TransformerLayer(nn.Module):
    """Pre-LN encoder layer with the reference's extra bias-free q, k, v
    Linears, a ReLU MLP (`fc1`, `fc2`) and Dropout(0.1)."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.ln1 = LayerNorm(c)
        self.q = Linear(c, c, bias=False)
        self.k = Linear(c, c, bias=False)
        self.v = Linear(c, c, bias=False)
        self.ma = MultiheadAttention(c, num_heads)
        self.ln2 = LayerNorm(c)
        self.fc1 = Linear(c, 4 * c, bias=False)
        self.fc2 = Linear(4 * c, c, bias=False)
        self.dropout = Dropout(0.1)

    def forward(self, x, dtype):
        x_ = self.ln1(x)
        x = self.dropout(self.ma((self.q(x_, dtype), self.k(x_, dtype), self.v(x_, dtype)),
                                 dtype)) + x
        x_ = self.ln2(x)
        x_ = self.fc2(self.dropout(torch.relu(self.fc1(x_, dtype))), dtype)
        return x + self.dropout(x_)


class TransformerBlock(nn.Module):
    """The encoder over the H*W tokens of a map, after a learned positional
    term: tokens p become p + linear(p)."""

    def __init__(self, c1, c2, num_heads, num_layers):
        super().__init__()
        self.conv = ConvBN(c1, c2) if c1 != c2 else None
        self.linear = Linear(c2, c2)
        self.tr = Sequential(*[TransformerLayer(c2, num_heads) for _ in range(num_layers)])

    def forward(self, x, dtype):
        if self.conv is not None:
            x = self.conv(x, dtype)
        return whole_map(self._tokens, x, dtype)

    def _tokens(self, x, dtype):
        b, c, h, w = x.shape
        p = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.tr(p + self.linear(p, dtype), dtype)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class C3TR(C3):
    """C3 with a TransformerBlock (4 heads) as its inner stack."""

    def make_inner(self, c_, n, shortcut, g):
        return TransformerBlock(c_, c_, 4, n)


# ---------------------------------------------------------------------------
# Swin (C3STR)
# ---------------------------------------------------------------------------

def _relative_position_index(m: int) -> np.ndarray:
    """Pairwise relative-position index inside an m x m window, (m², m²)."""
    coords = np.stack(np.meshgrid(np.arange(m), np.arange(m), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += m - 1
    rel[:, :, 1] += m - 1
    rel[:, :, 0] *= 2 * m - 1
    return rel.sum(-1)


def _swin_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """The shifted-window mask of a padded (hp, wp) map: -100 between
    positions of different regions, (nW, m², m²) f32."""
    img = np.zeros((hp, wp))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    nh, nw = hp // window, wp // window
    windows = img.reshape(nh, window, nw, window).transpose(0, 2, 1, 3).reshape(
        -1, window * window)
    mask = windows[:, None, :] - windows[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


_INDEX: Dict[Tuple[int, torch.device], torch.Tensor] = {}
_MASKS: Dict[Tuple[int, int, int, int, torch.device], torch.Tensor] = {}


def relative_position_index(m: int, device) -> torch.Tensor:
    """`_relative_position_index(m)` flattened, as an int64 tensor on
    `device`, made once."""
    key = (m, torch.device(device))
    if key not in _INDEX:
        with torch.inference_mode(False):  # usable by autograd whoever makes it first
            _INDEX[key] = torch.as_tensor(_relative_position_index(m).reshape(-1),
                                          device=device)
    return _INDEX[key]


def swin_attn_mask(hp: int, wp: int, window: int, shift: int, device) -> torch.Tensor:
    """`_swin_attn_mask` as an f32 tensor on `device`, made once a size."""
    key = (hp, wp, window, shift, torch.device(device))
    if key not in _MASKS:
        with torch.inference_mode(False):
            _MASKS[key] = torch.as_tensor(_swin_attn_mask(hp, wp, window, shift),
                                          device=device)
    return _MASKS[key]


def window_partition(x, window: int):
    """(B, H, W, C) -> (B * nW, window, window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)


def window_reverse(windows, window: int, h: int, w: int):
    """Inverse of `window_partition`."""
    b = windows.shape[0] // (h * w // window // window)
    x = windows.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    """W-MSA with the relative position bias (`relative_position_bias_table`,
    ((2m-1)², heads), f32), a bias-free `qkv` Linear and the `proj`
    Linear; the scale on q, in q's dtype."""

    def __init__(self, dim, window: int, num_heads, qkv_bias=False):
        super().__init__()
        self.window = window
        self.h = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))

    def reset_parameters(self, generator: torch.Generator):
        """0.02 times a standard normal truncated at +-2 (the JAX init)."""
        t = torch.empty(self.relative_position_bias_table.shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        with torch.no_grad():
            self.relative_position_bias_table.copy_(0.02 * t)

    def forward(self, x, mask: Optional[torch.Tensor], dtype):
        bw, n, c = x.shape  # (B * nW, m², C)
        qkv = self.qkv(x, dtype).reshape(bw, n, 3, self.h, c // self.h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (bw, heads, n, d)
        with record_function("attention"):
            attn = _logits(q * self.scale, k)
            idx = relative_position_index(self.window, x.device)
            bias = self.relative_position_bias_table[idx].reshape(n, n, self.h).permute(2, 0, 1)
            attn = attn + bias[None]
            if mask is not None:
                nw = mask.shape[0]
                attn = (attn.reshape(bw // nw, nw, self.h, n, n) + mask[None, :, None]).reshape(
                    bw, self.h, n, n)
            attn = torch.softmax(attn, dim=-1).to(v.dtype)
            out = torch.matmul(attn, v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out, dtype)


class Mlp(nn.Module):
    """fc1, exact GELU, fc2, with Dropout(`drop`) after each."""

    def __init__(self, c, hidden=None, out=None, drop=0.0):
        super().__init__()
        self.fc1 = Linear(c, hidden or c)
        self.fc2 = Linear(hidden or c, out or c)
        self.drop = Dropout(drop)

    def forward(self, x, dtype):
        h = self.fc1(x, dtype)
        with record_function("gelu"):
            h = gelu(h)
        return self.drop(self.fc2(self.drop(h), dtype))


class SwinTransformerLayer(nn.Module):
    """(S)W-MSA layer on NHWC: LayerNorm, pad at the bottom and right to
    whole windows, roll by (-shift, -shift) with the shift mask, window
    attention, roll back, crop; DropPath (0.1 above 10 heads) on both
    residual branches; a 4x GELU MLP."""

    def __init__(self, c, num_heads, window=7, shift=0):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = LayerNorm(c)
        self.attn = WindowAttention(c, window, num_heads)
        self.drop_path = DropPath(0.1 if num_heads > 10 else 0.0)
        self.norm2 = LayerNorm(c)
        self.mlp = Mlp(c, hidden=int(c * 4))

    def forward(self, x, dtype):
        b, h, w, c = x.shape
        m, s = self.window, self.shift
        shortcut = x
        with record_function("layernorm"):
            x = self.norm1(x)
        pad_b, pad_r = (m - h % m) % m, (m - w % m) % m
        hp, wp = h + pad_b, w + pad_r
        mask = None
        with record_function("window shuffle"):
            if pad_b or pad_r:
                x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
            if s > 0:
                x = torch.roll(x, (-s, -s), dims=(1, 2))
                mask = swin_attn_mask(hp, wp, m, s, x.device)
            x = window_partition(x, m).reshape(-1, m * m, c)
        x = self.attn(x, mask, dtype)
        with record_function("window shuffle"):
            x = window_reverse(x.reshape(-1, m, m, c), m, hp, wp)
            if s > 0:
                x = torch.roll(x, (s, s), dims=(1, 2))
            x = x[:, :h, :w]
        x = shortcut + self.drop_path(x)
        with record_function("layernorm"):
            y = self.norm2(x)
        return x + self.drop_path(self.mlp(y, dtype))


class SwinTransformerBlock(nn.Module):
    """Swin layers with window 8, the shift 0 on even layers and 4 on odd
    ones, after a ConvBN where c1 != c2."""

    def __init__(self, c1, c2, num_heads, num_layers, window=8):
        super().__init__()
        self.conv = ConvBN(c1, c2) if c1 != c2 else None
        self.tr = Sequential(*[SwinTransformerLayer(c2, num_heads, window,
                                                    shift=0 if i % 2 == 0 else window // 2)
                               for i in range(num_layers)])

    def forward(self, x, dtype):
        if self.conv is not None:
            x = self.conv(x, dtype)
        return whole_map(lambda v, dt: self.tr(v.permute(0, 2, 3, 1), dt).permute(0, 3, 1, 2),
                         x, dtype)


class C3STR(C3):
    """C3 with a SwinTransformerBlock (c_ // 32 heads) as its inner stack;
    raises for c_ < 32, where that is no head."""

    def make_inner(self, c_, n, shortcut, g):
        if c_ < 32:
            raise ValueError(f"C3STR needs >= 32 hidden channels for c_//32 attention heads, "
                             f"got c_={c_}: width_multiple too small for this config")
        return SwinTransformerBlock(c_, c_, c_ // 32, n)
