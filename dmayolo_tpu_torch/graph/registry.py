"""Module registry for the YAML config system.

Port of `dmayolo_tpu/graph/registry.py`, key for key.  `CA` is an alias
of `CoorAttention`: published configs use it though the reference never
defines it.  A name missing here raises KeyError when a config is
parsed.
"""
from __future__ import annotations

from ..nn import blocks as B
from ..nn import fusion as A
from ..nn import ghost as G
from ..nn import heads as H
from ..nn import hornet as HN
from ..nn import transformer as T
from ..nn.primitives import BatchNorm2d

# name in yaml -> module class
REGISTRY = {
    "Conv": B.ConvBN,
    "DWConv": B.DWConv,
    "Focus": B.Focus,
    "Bottleneck": B.Bottleneck,
    "BottleneckCSP": B.BottleneckCSP,
    "C3": B.C3,
    "C3TR": T.C3TR,
    "C3STR": T.C3STR,
    "C3SPP": B.C3SPP,
    "C3Ghost": G.C3Ghost,
    "SPP": B.SPP,
    "ASPP": B.ASPP,
    "SPPF": B.SPPF,
    "CBAM": B.CBAM,
    "TransformerBlock": T.TransformerBlock,
    "Contract": B.Contract,
    "Expand": B.Expand,
    "Concat": B.Concat,
    "GhostConv": G.GhostConv,
    "GhostBottleneck": G.GhostBottleneck,
    "AdaptADD": A.AdaptADD,
    "AdaptConcat": A.AdaptConcat,
    "AdConcat2": B.AdConcat2,
    "AdConcat3": B.AdConcat3,
    "Adapt_Add2": A.AdaptAdd2,
    "Adapt_Add3": A.AdaptAdd3,
    "ASFF": A.ASFF,
    "CoorAttention": B.CoorAttention,
    "CA": B.CoorAttention,  # alias, see the module docstring
    "CABottleneck": B.CABottleneck,
    "C3CA": B.C3CA,
    "BAM": B.BAM,
    "SPPCSPC": B.SPPCSPC,
    "SPPFCSPC": B.SPPFCSPC,
    "SCConv": B.SCConv,
    "GnConv": HN.GnConv,
    "HorBlock": HN.HorBlock,
    "C3HB": HN.C3HB,
    "C3GhostV2": G.C3GhostV2,
    "space_to_depth": B.SpaceToDepth,
    "SM": B.SM,
    "MP": B.MP,
    "SMMConv": B.SMMConv,
    "DMMConv": B.DMMConv,
    "DMMConv2": B.DMMConv2,
    "DMConv": B.DMConv,
    "DMMixConv2d": B.DMMixConv2d,
    "ConvMix": B.ConvMix,
    "CSPCM": B.CSPCM,
    "CrossConv": B.CrossConv,
    "Sum": B.Sum,
    "MixConv2d": B.MixConv2d,
    "Classify": B.Classify,
    "nn.Upsample": B.Upsample,
    "nn.BatchNorm2d": BatchNorm2d,
    "nn.MaxPool2d": B.MaxPool2d,
    "nn.ZeroPad2d": B.ZeroPad2d,
    "Detect": H.Detect,
    "TDetect": H.TDetect,
}

# parse_model's channel-rule groups, copied from the JAX registry (BAM is
# C3CA under another name, so it is in both, as the repaired configs need)
WIDTH_GAIN = {
    "Conv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP", "SPPF", "DWConv",
    "MixConv2d", "Focus", "CrossConv", "BottleneckCSP", "C3", "C3TR", "C3STR",
    "C3SPP", "C3Ghost", "ASPP", "CBAM", "CoorAttention", "CA", "CABottleneck",
    "C3CA", "SPPCSPC", "SPPFCSPC", "SCConv", "HorBlock", "C3HB", "GnConv",
    "BAM",
}
INSERT_N = {"BottleneckCSP", "C3", "C3TR", "C3STR", "C3Ghost", "C3CA", "C3HB", "BAM"}
