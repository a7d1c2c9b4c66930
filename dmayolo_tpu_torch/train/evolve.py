"""Hyperparameter evolution — mutation GA over the 29-key hyp space.

ref: train.py:714-820 (meta bounds, fitness-weighted parent selection,
sigma-scaled gaussian mutation, evolve.csv) and utils/general.py
print_mutation.
"""
from __future__ import annotations

import csv
import random
from pathlib import Path
from typing import Callable, Dict

import numpy as np

# (mutation scale, lower, upper) per key — ref train.py:717-745
META = {
    "lr0": (1, 1e-5, 1e-1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "anchors": (2, 2.0, 10.0),  # anchors per level (ref train.py:731)
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
    "copy_paste": (1, 0.0, 1.0),
}


def mutate(hyp: Dict, evolve_csv: Path, rng: random.Random) -> Dict:
    """One GA mutation: pick parent(s) weighted by fitness, then gaussian
    multiply with p=0.8, sigma=0.2.  ref: train.py:752-778."""
    parent = "single"
    if evolve_csv.exists():
        with open(evolve_csv) as f:
            rows = list(csv.reader(f))
        if len(rows) > 1:
            data = np.array([[float(v) for v in r] for r in rows[1:]])
            n = min(5, len(data))
            top = data[np.argsort(-data[:, 0])][:n]
            w = top[:, 0] - top[:, 0].min() + 1e-6
            if parent == "single" or len(top) == 1:
                x = top[random.choices(range(n), weights=w)[0]]
            else:
                x = (top * w.reshape(n, 1)).sum(0) / w.sum()
            keys = rows[0][1:]
            for i, k in enumerate(keys):
                if k in hyp:
                    hyp[k] = float(x[i + 1])

    mp, s = 0.8, 0.2
    npr = np.random.default_rng(rng.randint(0, 2**31))
    g = np.array([META[k][0] for k in META])
    ng = len(META)
    v = np.ones(ng)
    while (v == 1).all():
        v = (g * (npr.random(ng) < mp) * npr.normal(size=ng) * npr.random() * s + 1).clip(0.3, 3.0)
    out = dict(hyp)
    for i, k in enumerate(META):
        if k in out:
            out[k] = float(np.clip(out[k] * v[i], META[k][1], META[k][2]))
            out[k] = round(out[k], 5)
    return out


def log_generation(evolve_csv: Path, fitness: float, hyp: Dict):
    keys = list(META)
    exists = evolve_csv.exists()
    with open(evolve_csv, "a", newline="") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(["fitness"] + keys)
        w.writerow([f"{fitness:.5f}"] + [hyp.get(k, 0) for k in keys])


def evolve(train_fn: Callable[[Dict], float], base_hyp: Dict, generations: int = 300,
           out_dir="runs/evolve", seed: int = 0, autoanchor: bool = True, mesh=None) -> Dict:
    """Run the GA: train_fn(hyp) -> fitness.  Returns the best hyp found.

    In a group (`mesh` of more than one rank) rank 0 alone mutates (its
    draws, the global `random`'s among them, are the one process's),
    logs `evolve.csv` and writes `hyp_evolve.yaml`; each generation's hyp
    reaches every rank by `mesh.broadcast_object` before `train_fn`, which
    every rank runs on the same global step and whose fitness is one value
    on every rank.  Every rank returns the same best hyp."""
    main = mesh is None or mesh.is_main
    out = Path(out_dir)
    evolve_csv = out / "evolve.csv"
    rng = random.Random(seed)
    if main:
        out.mkdir(parents=True, exist_ok=True)
    base_hyp = dict(base_hyp)
    if autoanchor:
        base_hyp.setdefault("anchors", 3)  # ref train.py:750-751
    else:
        base_hyp.pop("anchors", None)  # ref train.py:748-749
    best_f, best_h = -1.0, dict(base_hyp)
    for gen in range(generations):
        hyp = mutate(dict(base_hyp), evolve_csv, rng) if main else None
        if mesh is not None:
            hyp = mesh.broadcast_object(hyp)
        f = train_fn(hyp)
        if f > best_f:
            best_f, best_h = f, hyp
        if main:
            log_generation(evolve_csv, f, hyp)
            print(f"evolve gen {gen + 1}/{generations}: fitness {f:.5f} (best {best_f:.5f})")
    if main:
        import yaml

        with open(out / "hyp_evolve.yaml", "w") as fo:
            yaml.safe_dump(best_h, fo)
    return best_h
