"""Module registry for the YAML config system.

Port of `dmayolo_tpu/graph/registry.py`, for the modules the port has.
`CA` is an alias of `CoorAttention`: published configs use it though the
reference never defines it.  A name missing here raises KeyError when a
config is parsed.
"""
from __future__ import annotations

from ..nn import blocks as B
from ..nn import heads as H
from ..nn import transformer as T

# name in yaml -> module class
REGISTRY = {
    "Conv": B.ConvBN,
    "Focus": B.Focus,
    "Bottleneck": B.Bottleneck,
    "BottleneckCSP": B.BottleneckCSP,
    "C3": B.C3,
    "C3TR": T.C3TR,
    "C3STR": T.C3STR,
    "SPP": B.SPP,
    "CABottleneck": B.CABottleneck,
    "C3CA": B.C3CA,
    "SPPF": B.SPPF,
    "CBAM": B.CBAM,
    "Concat": B.Concat,
    "AdConcat2": B.AdConcat2,
    "AdConcat3": B.AdConcat3,
    "CoorAttention": B.CoorAttention,
    "CA": B.CoorAttention,  # alias, see the module docstring
    "SPPFCSPC": B.SPPFCSPC,
    "SCConv": B.SCConv,
    "nn.Upsample": B.Upsample,
    "space_to_depth": B.SpaceToDepth,
    "Detect": H.Detect,
    "TDetect": H.TDetect,
}

# parse_model's channel-rule groups, copied from the JAX registry
WIDTH_GAIN = {
    "Conv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP", "SPPF", "DWConv",
    "MixConv2d", "Focus", "CrossConv", "BottleneckCSP", "C3", "C3TR", "C3STR",
    "C3SPP", "C3Ghost", "ASPP", "CBAM", "CoorAttention", "CA", "CABottleneck",
    "C3CA", "SPPCSPC", "SPPFCSPC", "SCConv", "HorBlock", "C3HB", "GnConv",
    "BAM",
}
INSERT_N = {"BottleneckCSP", "C3", "C3TR", "C3STR", "C3Ghost", "C3CA", "C3HB", "BAM"}
