"""The reference's own `.pt` checkpoints, read onto the port's model.

Port of `dmayolo_tpu/utils/torch_import.py`.  A reference training
checkpoint is a pickle of `{'model': module, 'ema': module, ...}` whose
classes live in the reference's `models.*` and `utils.*` packages, which
are not installed beside the port.  `load_torch_pt` reads it without them:
a class that cannot be imported becomes a stub, and the weights come back
by walking the pickled module tree (`_parameters`, `_buffers`,
`_modules`), the EMA first.

The port's `state_dict` keys are the reference's, so `import_torch_state`
needs no renames or transposes: it upcasts the f16 tensors the reference
saves, leaves out the keys the port has no tensor for (BN's
`num_batches_tracked`, Detect's `anchors` and `anchor_grid` buffers, the
Swin `relative_position_index`, the fixed DFL conv), and raises on any
missing or mismatched key.  The trained anchors are not a tensor of the
port's model (its `Detect.anchors` is a numpy attribute): `load_torch_pt`
returns them, and the caller sets them on the head after the build.
"""
from __future__ import annotations

import pickle
import types
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn


def _ignored(key: str) -> bool:
    """Reference keys with no tensor in the port's model."""
    return (key.endswith("num_batches_tracked") or key.endswith(".anchors")
            or key.endswith(".anchor_grid") or "relative_position_index" in key
            or key.endswith(".dfl.conv.weight"))


def _stub_pickle_module():
    """A pickle module whose Unpickler makes a stub class for every class
    whose module cannot be imported here.  A pickled `nn.Module` keeps all
    its state in its instance `__dict__`, so a stub carries the weights."""

    class _StubBase:
        pass

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_StubBase,), {"__module__": module})

    mod = types.ModuleType("dmayolo_pt_stub_pickle")
    mod.Unpickler = Unpickler
    mod.load = lambda f, **kw: Unpickler(f, **kw).load()
    return mod


def _walk_module_tree(obj, prefix: str, out: Dict) -> None:
    """`state_dict()` of a (possibly stub-classed) module tree: parameters
    and persistent buffers, depth first over `_modules`."""
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    nonpersist = d.get("_non_persistent_buffers_set") or set()
    for name, p in (d.get("_parameters") or {}).items():
        if p is not None:
            out[prefix + name] = p
    for name, b in (d.get("_buffers") or {}).items():
        if b is not None and name not in nonpersist:
            out[prefix + name] = b
    for name, m in (d.get("_modules") or {}).items():
        if m is not None:
            _walk_module_tree(m, prefix + name + ".", out)


def load_torch_pt(path, ema: bool = True) -> Tuple[Dict, dict, Dict]:
    """Read a reference `.pt` checkpoint without the reference's classes,
    preferring the EMA.  A file that holds a bare `state_dict` is read as
    one.

    Returns (state_dict {key: tensor}, the model's yaml dict or None,
    info {'nc', 'names', 'anchors'}): `anchors` is the trained Detect
    buffer (nl, na, 2) in stride units as f32 numpy, or None."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_stub_pickle_module())
    net = ckpt
    if isinstance(ckpt, dict):
        net = (ckpt.get("ema") if ema else None) or ckpt.get("model") or ckpt
    sd: Dict = {}
    _walk_module_tree(net, "", sd)
    if not sd and isinstance(net, dict):  # a bare state_dict file
        sd = dict(net)
    d = getattr(net, "__dict__", {})
    cfg = d.get("yaml")
    anchors = None
    for k, v in sd.items():
        if k.endswith(".anchors"):
            a = v.detach().cpu().float().numpy() if hasattr(v, "detach") else v
            anchors = np.asarray(a, np.float32)
    info = {"nc": cfg.get("nc") if isinstance(cfg, dict) else None,
            "names": d.get("names"), "anchors": anchors}
    return sd, cfg, info


def import_torch_state(model: nn.Module, state_dict, prefix: str = "",
                       strict: bool = True) -> Dict[str, list]:
    """Load a reference `state_dict` (or module) onto `model` in place,
    upcast to the model's dtypes.

    prefix: a key prefix to strip (such as "module.").  strict: raise on a
    key of the model that the file lacks or holds at another shape.
    Returns a report: the matched, missing, mismatched and unused keys."""
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    sd = {(k[len(prefix):] if prefix and k.startswith(prefix) else k): v
          for k, v in state_dict.items()}
    own = model.state_dict()
    report = {"matched": [], "missing": [], "mismatched": [], "unused": []}
    load = {}
    for key, cur in own.items():
        if key not in sd:
            report["missing"].append(key)
            continue
        val = torch.as_tensor(np.asarray(sd[key]) if not torch.is_tensor(sd[key]) else sd[key])
        if tuple(val.shape) != tuple(cur.shape):
            report["mismatched"].append((key, tuple(val.shape), tuple(cur.shape)))
            continue
        load[key] = val.detach().to(dtype=cur.dtype)
        report["matched"].append(key)
    report["unused"] = [k for k in sd if k not in own and not _ignored(k)]
    if strict and (report["missing"] or report["mismatched"]):
        raise ValueError(f"torch import mismatch: missing={report['missing'][:8]} "
                         f"mismatched={report['mismatched'][:8]}")
    model.load_state_dict(load, strict=False)
    return report
