"""Weights between the JAX package and the port.

The JAX package keys every leaf by a path tuple that mirrors a torch module
path (`("model", "3", "cv1", "conv", "kernel")`), and the port's module
attribute names equal those path parts, so the map is mechanical:

    JAX leaf                      port key                      layout
    ----------------------------  ----------------------------  -------------
    kernel (4-D)                  .weight (Conv2d)              HWIO <-> OIHW
    kernel (2-D)                  .weight (Linear)              (in, out) <-> (out, in)
    scale                         .weight (BN, LayerNorm)       as is
    bias                          .bias                         as is
    mean / var                    .running_mean/var             as is
    in_proj_kernel                .in_proj_weight               (C, 3C) <-> (3C, C)
    in_proj_bias                  .in_proj_bias                 as is
    relative_position_bias_table  same name                     as is
    w (AdConcat2/3, AdaptAdd2/3,  same name                     as is
      weighted Sum)
    gamma1, gamma2 (HorBlock)     same name                     as is
    p1, p2, beta (AconC,          same name                     as is, (1, 1, 1, C)
      MetaAconC)

`state_dict_from_jax` goes one way, `jax_from_state_dict` the other (a
`.weight` is a kernel or a scale by the type of its module).
`load_jax_checkpoint` reads the JAX `.npz` checkpoint format
(`utils/checkpoint.py`) and the JAX `Trainer`'s Orbax directories
(`<name>_orbax/`, `utils/orbax_ckpt.py`).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..nn.activations import AconC, MetaAconC
from ..nn.blocks import AdConcat2, Sum
from ..nn.fusion import AdaptAdd2
from ..nn.hornet import HorBlock
from ..nn.primitives import BatchNorm2d, Conv2d, LayerNorm, Linear
from ..nn.transformer import MultiheadAttention, WindowAttention
from .checkpoint import load_checkpoint
from .device import resolve_device

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var", "in_proj_bias": "in_proj_bias",
         "relative_position_bias_table": "relative_position_bias_table",
         **{leaf: leaf for leaf in ("w", "gamma1", "gamma2", "p1", "p2", "beta")}}
_AFFINE = {"weight": ("params", "scale"), "bias": ("params", "bias")}
# port leaf -> (JAX tree, JAX leaf), by module type (a subclass takes its
# base's entry)
_TO_JAX = {Conv2d: {"weight": ("params", "kernel"), "bias": ("params", "bias")},
           Linear: {"weight": ("params", "kernel"), "bias": ("params", "bias")},
           BatchNorm2d: {**_AFFINE, "running_mean": ("stats", "mean"),
                         "running_var": ("stats", "var")},
           LayerNorm: _AFFINE,
           MultiheadAttention: {"in_proj_weight": ("params", "in_proj_kernel"),
                                "in_proj_bias": ("params", "in_proj_bias")},
           WindowAttention: {"relative_position_bias_table":
                             ("params", "relative_position_bias_table")},
           AdConcat2: {"w": ("params", "w")},
           AdaptAdd2: {"w": ("params", "w")},
           Sum: {"w": ("params", "w")},
           HorBlock: {g: ("params", g) for g in ("gamma1", "gamma2")},
           AconC: {p: ("params", p) for p in ("p1", "p2", "beta")},
           MetaAconC: {p: ("params", p) for p in ("p1", "p2")}}
_TRANSPOSED = ("kernel", "in_proj_kernel")  # JAX leaves stored (in, out)


def _port_key(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    prefix, leaf = "".join(p + "." for p in path[:-1]), path[-1]
    if leaf == "kernel":
        if arr.ndim == 4:
            return f"{prefix}weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:
            return f"{prefix}weight", arr.T
        raise ValueError(f"{'.'.join(path)}: a {arr.ndim}-D kernel has no port counterpart")
    if leaf == "in_proj_kernel":
        return f"{prefix}in_proj_weight", arr.T
    if leaf not in _LEAF:
        raise ValueError(f"{'.'.join(path)}: no port counterpart for leaf '{leaf}'")
    return f"{prefix}{_LEAF[leaf]}", arr


def _leaves(module: nn.Module) -> Dict[str, Tuple[str, str]]:
    for cls in type(module).__mro__:
        if cls in _TO_JAX:
            return _TO_JAX[cls]
    return {}


def jax_paths(model: nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """Every `state_dict` key of `model` -> (JAX tree "params" or "stats",
    JAX path).  Raises for a tensor with no JAX counterpart."""
    mods = dict(model.named_modules())
    out = {}
    for key in model.state_dict():
        prefix, _, leaf = key.rpartition(".")
        m = mods.get(prefix)
        tree, jleaf = (_leaves(m) if m is not None else {}).get(leaf, (None, None))
        if tree is None:
            raise ValueError(f"{key}: no JAX counterpart")
        out[key] = (tree, (tuple(prefix.split(".")) if prefix else ()) + (jleaf,))
    return out


def to_jax_layout(path: Tuple[str, ...], t: torch.Tensor) -> np.ndarray:
    """A port tensor as the JAX leaf at `path` holds it (f32 on the host,
    an array of its own that no later change to `t` reaches; conv
    kernels OIHW -> HWIO, Linear and in_proj weights transposed)."""
    arr = t.detach().to("cpu", torch.float32, copy=True).numpy()
    if path[-1] not in _TRANSPOSED:
        return arr
    return np.ascontiguousarray(arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T)


def jax_from_state_dict(model: nn.Module, state_dict: Optional[Mapping] = None):
    """The port's `state_dict` (of `model`, or `state_dict` shaped like it,
    such as the EMA copy's) -> JAX (params, stats) flat dicts of numpy
    arrays keyed by path tuples."""
    sd = model.state_dict() if state_dict is None else state_dict
    trees = {"params": {}, "stats": {}}
    for key, (tree, path) in jax_paths(model).items():
        trees[tree][path] = to_jax_layout(path, sd[key])
    return trees["params"], trees["stats"]


def state_dict_from_jax(params: Mapping, stats: Mapping,
                        device="cpu") -> Dict[str, torch.Tensor]:
    """JAX (params, stats) flat dicts -> the port's `state_dict`.

    Values may be numpy arrays or anything `np.asarray` takes; the result
    holds f32 (or the source dtype) tensors on `device`."""
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, stats):
        for path, v in tree.items():
            key, arr = _port_key(tuple(path), np.asarray(v))
            out[key] = torch.from_numpy(np.array(arr, order="C", copy=True)).to(device)
    return out


def _orbax_trees(path) -> Tuple[Dict[str, Dict], dict]:
    """An Orbax train-state directory as `load_checkpoint` gives a
    `.npz`: numpy trees, f16 and bf16 leaves upcast to f32 (f32 leaves
    stay as saved: Orbax does not halve)."""
    from .orbax_ckpt import restore

    trees, meta = restore(path, device="cpu")
    return {name: {k: (v.float() if v.dtype in (torch.float16, torch.bfloat16) else v).numpy()
                   for k, v in tree.items()}
            for name, tree in trees.items() if isinstance(tree, dict)}, meta


def load_jax_checkpoint(path, device=None) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Read a JAX checkpoint -> (state_dict on `device`, meta): a `.npz`,
    or an Orbax directory that `--ckpt-async` wrote (`<name>_orbax`, its
    meta from `<name>_orbax.meta.json`).

    Prefers the EMA trees when present (as the JAX CLIs do) and upcasts
    f16 leaves to f32.  The meta carries the run's `cfg`, `nc` and live
    `anchors`."""
    dev = resolve_device(device)
    trees, meta = _orbax_trees(path) if Path(path).is_dir() else load_checkpoint(path)
    params = trees.get("ema_params") or trees.get("params", {})
    # a fully fused checkpoint may hold no BN statistics at all
    stats = trees.get("ema_stats") or trees.get("stats", {})
    return state_dict_from_jax(params, stats, device=dev), meta
