"""Shared CLI helpers: run dirs, config resolution, the model from a
checkpoint, the device.

Port of `dmayolo_tpu/cli/common.py`.  Configs resolve by path, else by
file name among the port's own copies under `configs/<kind>/`: a
checkpoint written by the JAX CLI records its model yaml as a path into
the JAX package, and where that path does not exist the name finds the
port's byte-identical copy.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# the Trainer owns these; the CLIs take them from here, as JAX's do
from ..train.trainer import check_img_size, load_hyp  # noqa: F401
from ..utils.device import resolve_device

PKG_ROOT = Path(__file__).resolve().parents[1]
CONFIGS = PKG_ROOT / "configs"


def increment_path(path, exist_ok=False, sep=""):
    """runs/train/exp -> exp2, exp3, ... (the first that does not exist)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        for n in range(2, 9999):
            p = Path(f"{path}{sep}{n}")
            if not p.exists():
                return p
    return path


def resolve_config(name, kind: str) -> Path:
    """A model, hyp or data config by path, else by its file name (".yaml"
    added to a bare name) under `configs/<kind>/`."""
    p = Path(name)
    if p.exists():
        return p
    cand = CONFIGS / kind / (p.name if p.suffix else p.name + ".yaml")
    if cand.exists():
        return cand
    raise FileNotFoundError(f"config {name!r} not found (looked in {cand.parent})")


def _set_anchors(model, anchors):
    """Trained (possibly autoanchor-evolved) anchors in stride units onto
    a Detect head, over the yaml's, where the shapes agree; TDetect has
    none."""
    cur = getattr(model.head, "anchors", None)
    if anchors is not None and cur is not None:
        a = np.asarray(anchors, np.float32)
        if a.shape == np.shape(cur):
            model.head.anchors = a


def load_model_from_checkpoint(weights, cfg=None, nc=None, device=None):
    """The model on `device` (None: CUDA) with the weights of `weights`:

    - `.npz` (the JAX format, either package's): the EMA trees where
      present, else the model's; the meta's `cfg`, `nc` and live
      `anchors` over the yaml's (`cfg` and `nc` given here win); a BN-folded
      export (meta `fused`) onto the folded model;
    - `.pt` (the reference's own checkpoint, `utils/torch_import.py`): the
      EMA first; the pickled yaml, nc and trained anchors;
    - no `weights`: `cfg` built with seeded weights (seed 0) and the head
      priors.

    The model is returned in eval mode."""
    from ..graph import DetectionModel
    from ..utils.checkpoint import load_checkpoint
    from ..utils.weights import state_dict_from_jax

    dev = resolve_device(device)
    if weights and str(weights).endswith(".pt"):
        from ..utils.torch_import import import_torch_state, load_torch_pt

        sd, pt_cfg, info = load_torch_pt(weights)
        cfg = cfg or pt_cfg
        if cfg is None:
            raise ValueError(f"{weights} carries no model yaml — pass --cfg")
        if not isinstance(cfg, dict):
            cfg = resolve_config(cfg, "models")
        model = DetectionModel(cfg, nc=nc or info.get("nc"), device=dev)
        import_torch_state(model, sd)
        _set_anchors(model, info.get("anchors"))
        return model.eval()
    if weights:
        trees, meta = load_checkpoint(weights)
        cfg = cfg or meta.get("cfg")
        nc = nc or meta.get("nc")
        if cfg is None:
            raise ValueError(f"checkpoint {weights} has no cfg in its meta — pass --cfg")
        model = DetectionModel(cfg if isinstance(cfg, dict) else resolve_config(cfg, "models"),
                               nc=nc, device=dev)
        params = trees.get("ema_params") or trees["params"]
        stats = trees.get("ema_stats") or trees.get("stats") or {}
        if meta.get("fused"):  # `cli.export`'s npz: the BNs already folded
            model.fuse()
        model.load_state_dict(state_dict_from_jax(params, stats, dev), strict=True)
        _set_anchors(model, meta.get("anchors"))
        return model.eval()
    if not cfg:
        raise ValueError("need --weights or --cfg")
    model = DetectionModel(resolve_config(cfg, "models"), nc=nc, device=dev)
    return model.init_with_priors(torch.Generator().manual_seed(0)).eval()


def setup_device(device) -> torch.device:
    """The entry points' device: None means CUDA, which must exist."""
    return resolve_device(device)
