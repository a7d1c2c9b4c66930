"""Conv+BN folding for inference.

Port of `dmayolo_tpu/nn/fuse.py`, done in place on the port's modules:
for every conv whose output feeds a BatchNorm directly,

    W' = W * scale / sqrt(var + eps)        (per out-channel; OIHW, so dim 0)
    b' = (b_conv - mean) * scale / sqrt(var + eps) + bias_bn

and the BN becomes an Identity.  Folded pairs: `ConvBN` (and `DWConv`),
`AddConvBlock` (conv -> batch_norm), GhostNet v2's `ConvUnit` (conv ->
bn), the `CoorAttention` conv1 -> bn1 pair, and Conv2d -> BatchNorm2d
adjacency inside a Sequential (SCConv k2/k3/k4).

Not folded, as in JAX: a BN that normalises a concat (`BottleneckCSP.bn`,
`DMMixConv2d.bn`) or sits after a GELU (`ConvMix`); those run the BN's
eval path.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from .blocks import ConvBN, CoorAttention
from .fusion import AddConvBlock
from .ghost import ConvUnit
from .primitives import BatchNorm2d, Conv2d, Identity, Sequential


def _conv_bn_pairs(model: nn.Module) -> List[Tuple[nn.Module, str, Conv2d]]:
    """(parent, BN attribute name, conv) for every BN fed by a conv."""
    pairs = []
    for m in model.modules():
        if isinstance(m, (ConvBN, ConvUnit)):
            pairs.append((m, "bn", m.conv))
        elif isinstance(m, AddConvBlock):
            pairs.append((m, "batch_norm", m.conv))
        elif isinstance(m, CoorAttention):
            pairs.append((m, "bn1", m.conv1))
        elif isinstance(m, Sequential):
            mods = list(m)
            for j, (a, b) in enumerate(zip(mods, mods[1:])):
                if isinstance(a, Conv2d) and isinstance(b, BatchNorm2d):
                    pairs.append((m, str(j + 1), a))
    return pairs


@torch.no_grad()
def fuse_model(model: nn.Module) -> nn.Module:
    """Fold every conv->BN pair in place; returns `model`.  Idempotent:
    a pair whose BN is already an Identity is skipped."""
    for parent, name, conv in _conv_bn_pairs(model):
        bn = getattr(parent, name)
        if not isinstance(bn, BatchNorm2d):
            continue  # already folded
        inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        conv.weight.mul_(inv[:, None, None, None])
        conv_bias = conv.bias if conv.bias is not None else 0.0
        bias = (conv_bias - bn.running_mean) * inv + bn.bias
        if conv.bias is None:
            conv.bias = nn.Parameter(bias)
        else:
            conv.bias.copy_(bias)
        setattr(parent, name, Identity())
    return model
