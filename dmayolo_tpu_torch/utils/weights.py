"""Weights from the JAX package into the port.

The JAX package keys every leaf by a path tuple that mirrors a torch module
path (`("model", "3", "cv1", "conv", "kernel")`), and the port's module
attribute names equal those path parts, so the map is mechanical:

    JAX leaf          port key           layout
    ----------------  -----------------  ---------------
    kernel (4-D)      .weight            HWIO -> OIHW
    scale             .weight            as is
    bias              .bias              as is
    mean / var        .running_mean/var  as is

`load_jax_checkpoint` reads the JAX `.npz` checkpoint format (path parts
joined by "|", one prefix per tree), as `dmayolo_tpu/utils/checkpoint.py`
writes it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .device import resolve_device

SEP = "|"  # path-component separator inside npz keys

_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def _port_key(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    prefix, leaf = "".join(p + "." for p in path[:-1]), path[-1]
    if leaf == "kernel":
        if arr.ndim != 4:
            raise ValueError(f"{'.'.join(path)}: only 4-D conv kernels are ported")
        return f"{prefix}weight", np.transpose(arr, (3, 2, 0, 1))
    if leaf not in _LEAF:
        raise ValueError(f"{'.'.join(path)}: no port counterpart for leaf '{leaf}'")
    return f"{prefix}{_LEAF[leaf]}", arr


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


def load_jax_checkpoint(path, device=None) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Read a JAX `.npz` checkpoint -> (state_dict on `device`, meta).

    Prefers the EMA trees when present (as the JAX CLIs do) and upcasts
    f16 leaves to f32."""
    dev = resolve_device(device)
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    with np.load(path, allow_pickle=False) as z:
        meta = (json.loads(bytes(z["__meta__"]).decode())
                if "__meta__" in z.files else {})
        trees = {}
        for prefix in ("params", "stats", "ema_params", "ema_stats"):
            pre = prefix + SEP
            tree = {}
            for k in z.files:
                if k.startswith(pre):
                    a = z[k]
                    tree[tuple(k[len(pre):].split(SEP))] = (
                        a.astype(np.float32) if a.dtype == np.float16 else a)
            trees[prefix] = tree
    params = trees["ema_params"] or trees["params"]
    # a fully fused checkpoint may hold no BN statistics at all
    stats = trees["ema_stats"] or trees["stats"]
    return state_dict_from_jax(params, stats, device=dev), meta
