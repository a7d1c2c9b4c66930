"""Checkpoints in the JAX package's `.npz` format.

One `.npz` holds up to six flat trees, `params`, `stats`, `ema_params`,
`ema_stats`, `opt_mom` and `opt_vel`, each leaf under its prefix and JAX
path joined with "|", plus `__meta__`, a JSON object (epoch, step,
updates, nc, cfg, anchors, ...) stored as uint8 bytes: the layout of
`dmayolo_tpu/utils/checkpoint.py`, so either package reads what the other
writes.  Trees here are dicts of numpy arrays keyed by path tuples.
"""
from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SEP = "|"  # path-component separator inside npz keys
TREES = ("params", "stats", "ema_params", "ema_stats", "opt_mom", "opt_vel")


def _npz(path) -> Path:
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(".npz")


def _half(tree):
    """f32 leaves -> f16 (the reference stores model and EMA in half)."""
    return {k: (v.astype(np.float16) if v.dtype == np.float32 else v) for k, v in tree.items()}


def save_checkpoint(path, *, params, stats, ema_params=None, ema_stats=None,
                    opt_mom=None, opt_vel=None, meta: Optional[Dict] = None,
                    half: bool = False):
    """Write the trees given and `meta` (JSON-serialisable).  `half`
    stores the model and EMA trees as f16; the optimizer trees stay f32."""
    path = _npz(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    cvt = _half if half else (lambda t: t)
    trees = {"params": cvt(params), "stats": cvt(stats)}
    if ema_params is not None:
        trees.update(ema_params=cvt(ema_params), ema_stats=cvt(ema_stats))
    if opt_mom is not None:
        trees.update(opt_mom=opt_mom, opt_vel=opt_vel)
    arrays = {prefix + SEP + SEP.join(k): np.asarray(v)
              for prefix, tree in trees.items() for k, v in tree.items()}
    meta = dict(meta or {})
    meta.setdefault("date", datetime.datetime.now().isoformat())
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path.with_suffix(""), **arrays)


def load_checkpoint(path) -> Tuple[Dict[str, Dict], Dict]:
    """-> ({tree name: tree} for the trees present, meta); f16 leaves
    upcast to f32."""
    with np.load(_npz(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z.files else {}
        trees = {}
        for k in z.files:
            prefix, _, rest = k.partition(SEP)
            if prefix in TREES:
                a = z[k]
                trees.setdefault(prefix, {})[tuple(rest.split(SEP))] = (
                    a.astype(np.float32) if a.dtype == np.float16 else a)
    return trees, meta


def strip_checkpoint(src, dst=None):
    """The finished-run checkpoint: the EMA trees (else the model's) as
    the model, in f16, no optimizer state, self-describing meta."""
    trees, meta = load_checkpoint(src)
    params = trees.get("ema_params") or trees["params"]
    stats = trees.get("ema_stats") or trees["stats"]
    keep = ("epoch", "best_fitness", "nc", "cfg", "anchors")
    save_checkpoint(dst or src, params=params, stats=stats, half=True,
                    meta={k: meta[k] for k in keep if meta.get(k) is not None})
    return dst or src
