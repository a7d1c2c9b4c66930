"""int8 post-training quantization for serving and eval.

Port of `dmayolo_tpu/nn/quant.py`, the same scheme:
  * a per-tensor symmetric input scale a conv, calibrated from
    representative images (max |x| over the calibration batches / 127);
  * a per-output-channel symmetric weight scale from the (folded) f32
    weights;
  * s8 x s8 -> s32 sums on the card's int8 tensor cores (`nn/conv_int8.py`,
    the kernel K4), dequantized in the compute dtype; activations, BN,
    concat and the decode stay float;
  * the stem (C1 < 16), grouped convs and the DFL conv stay float.

Convs are keyed by their qualified module name ("model.2.cv1.conv"); the
JAX package keys them by path tuple, and `jax_conv_paths` maps one to the
other.

    scales = calibrate_act_scales(model.fuse(), batches)  # uint8 NHWC
    raw = model.apply(x, torch.bfloat16, fused=True, quant=scales)
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .primitives import Conv2d


def eligible_conv_paths(model: nn.Module, min_cin: int = 16) -> Dict[str, Conv2d]:
    """{qualified name: Conv2d} of the convs the int8 path takes: one group,
    C1 >= min_cin, and no "dfl" in the name (the DFL expectation conv stays
    float: negligible work, and box regression is the part most sensitive
    to its bins)."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, Conv2d) and m.g == 1 and m.c1 >= min_cin
            and "dfl" not in name.split(".")}


def calibrate_act_scales(model: nn.Module, batches: Iterable, dtype=torch.float32,
                         min_cin: int = 16, exclude: Optional[Iterable[str]] = None
                         ) -> Dict[str, float]:
    """Per-conv input scales from representative batches of the BN-folded
    `model`: {name: max(max |x|, 1e-6) / 127} for every eligible conv not
    in `exclude`, the max taken over the conv's inputs in a forward of each
    batch (uint8 batches are divided by 255 in `dtype`, as serving does).
    Feed the result to `model.apply(quant=...)`."""
    eligible = eligible_conv_paths(model, min_cin=min_cin)
    observed: Dict[str, float] = {}

    def observe(name):
        def hook(_module, args):
            amax = float(args[0].float().abs().max())
            observed[name] = max(observed.get(name, amax), amax)
        return hook

    device = next(model.parameters()).device
    hooks = [m.register_forward_pre_hook(observe(name))
             for name, m in model.named_modules() if isinstance(m, Conv2d)]
    n = 0
    try:
        with torch.inference_mode():
            for b in batches:
                x = torch.as_tensor(np.asarray(b) if not torch.is_tensor(b) else b,
                                    device=device)
                x = x.to(dtype) / 255.0 if x.dtype == torch.uint8 else x.to(dtype)
                model.apply(x, dtype, fused=True)
                n += 1
    finally:
        for h in hooks:
            h.remove()
    if n == 0:
        raise ValueError("int8 calibration needs at least one batch")
    excl = set(exclude) if exclude else set()
    return {name: max(amax, 1e-6) / 127.0 for name, amax in observed.items()
            if name in eligible and name not in excl}


def quant_coverage(model: nn.Module, scales: Dict[str, float]) -> str:
    """One line: how many of the convs run int8."""
    eligible = eligible_conv_paths(model, min_cin=1)
    n_int8 = sum(1 for name in eligible if name in scales)
    return f"int8 convs: {n_int8}/{len(eligible)}"


def jax_conv_paths(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """{conv name: the JAX package's path of that conv} for every Conv2d,
    from `utils/weights.py::jax_paths` (the kernel's path without its
    leaf)."""
    from ..utils.weights import jax_paths

    paths = jax_paths(model)
    return {name: paths[f"{name}.weight"][1][:-1] for name, m in model.named_modules()
            if isinstance(m, Conv2d)}


def scales_to_jax(model: nn.Module, scales: Dict[str, float]) -> Dict[Tuple[str, ...], float]:
    paths = jax_conv_paths(model)
    return {paths[name]: s for name, s in scales.items()}


def scales_from_jax(model: nn.Module, scales: Dict[Tuple[str, ...], float]) -> Dict[str, float]:
    names = {p: name for name, p in jax_conv_paths(model).items()}
    return {names[tuple(p)]: s for p, s in scales.items()}
