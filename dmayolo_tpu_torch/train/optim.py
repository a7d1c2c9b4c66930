"""Optimizer policy, LR schedules and EMA.

Port of `dmayolo_tpu/train/optim.py`.  Three parameter groups (BN weights
without decay, conv weights with decay, biases), SGD (nesterov) or Adam
from `torch.optim`, whose update rules are the JAX package's (L2 decay
added to the gradient; Adam's beta1 the fixed hyp momentum), with every
group's lr and SGD's momentum set from `Schedule` before each step.  The
EMA covers parameters and buffers, with the ramped decay.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from ..nn.blocks import AdConcat2
from ..nn.fusion import AdaptAdd2
from ..nn.primitives import BatchNorm2d

GROUPS = ("g0", "g1", "g2")  # BN weights, other weights (decayed), biases


def param_groups(model: nn.Module, train_ungrouped: bool = False) -> Dict[str, str]:
    """Label every parameter name g0 (BN weight, no decay), g1 (other
    weights, and the BiFPN `w` of AdConcat2/3 and AdaptAdd2/3; decay), g2
    (biases, no decay) or "frozen" (any other parameter, which the
    reference never optimizes: the Swin bias tables, `in_proj_weight` and
    `in_proj_bias`, HorBlock's `gamma1`/`gamma2`, the weighted Sum's `w`,
    the ACON `p1`/`p2`/`beta`); `train_ungrouped` puts those in g1."""
    bn = {name for name, m in model.named_modules() if isinstance(m, BatchNorm2d)}
    bifpn = {name for name, m in model.named_modules()
             if isinstance(m, (AdConcat2, AdaptAdd2))}
    labels = {}
    for name, _ in model.named_parameters():
        parent, _, leaf = name.rpartition(".")
        if leaf == "bias":
            labels[name] = "g2"
        elif leaf == "weight":
            labels[name] = "g0" if parent in bn else "g1"
        elif leaf == "w" and parent in bifpn:
            labels[name] = "g1"
        else:
            labels[name] = "g1" if train_ungrouped else "frozen"
    return labels


def one_cycle(y1: float, y2: float, steps: int):
    """Cosine from y1 to y2 over `steps`: the default epoch multiplier."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def linear_lr(lrf: float, epochs: int):
    """Linear from 1 to `lrf` over `epochs`."""
    return lambda x: (1 - x / (epochs - 1)) * (1.0 - lrf) + lrf


class Schedule:
    """Per-iteration lr and momentum with warmup, a function of the step
    (plain floats: the step is known on the host)."""

    def __init__(self, hyp: Dict, epochs: int, steps_per_epoch: int,
                 adam: bool = False, linear: bool = False, nbs: int = 64,
                 batch_size: int = 16, warmup_min_iters: int = 1000,
                 step_scale: int = 1):
        self.lr0 = 3e-4 if adam else hyp["lr0"]
        self.lrf = hyp["lrf"]
        self.momentum = hyp["momentum"]
        self.warmup_momentum = hyp.get("warmup_momentum", 0.8)
        self.warmup_bias_lr = hyp.get("warmup_bias_lr", 0.1)
        self.spe = max(steps_per_epoch, 1)
        # the reference floors warmup at 1000 iterations
        self.nw = max(round(hyp.get("warmup_epochs", 3.0) * self.spe), warmup_min_iters)
        self._lf = linear_lr(self.lrf, epochs) if linear else one_cycle(1.0, self.lrf, epochs)
        self.accumulate = max(round(nbs / batch_size), 1)
        # with accumulation the optimizer steps once per `step_scale` loader
        # batches; the warmup and epoch curves are in batch units
        self.step_scale = float(step_scale)

    def __call__(self, step, batch_units: bool = False) -> Dict[str, float]:
        """Per-group lr and the momentum at optimizer step `step` (scaled
        to batch units by `step_scale`), or, with `batch_units`, at the
        batch counter itself (the warmup accumulate ramp's domain)."""
        step = float(step) if batch_units else float(step) * self.step_scale
        base = self.lr0 * self._lf(math.floor(step / self.spe))
        if step <= self.nw:
            frac = min(max(step / self.nw, 0.0), 1.0)
            lr_main = frac * base
            lr_bias = self.warmup_bias_lr + frac * (base - self.warmup_bias_lr)
            mom = self.warmup_momentum + frac * (self.momentum - self.warmup_momentum)
        else:
            lr_main, lr_bias, mom = base, base, self.momentum
        return {"g0": lr_main, "g1": lr_main, "g2": lr_bias, "frozen": 0.0,
                "momentum": mom}


def make_optimizer(model: nn.Module, labels: Dict[str, str], weight_decay: float,
                   adam: bool = False, momentum: float = 0.937, beta2: float = 0.999,
                   eps: float = 1e-8) -> torch.optim.Optimizer:
    """SGD (nesterov) or Adam over the g0, g1 and g2 groups, in that order,
    decay on g1 only; "frozen" parameters stay out.  `set_schedule` sets
    every group's lr, and SGD's momentum, before each step.  Adam's beta1
    is `momentum` (the hyp momentum), fixed: the reference's warmup ramps
    only SGD's momentum."""
    named = dict(model.named_parameters())
    groups = [{"params": [named[k] for k, g in labels.items() if g == grp], "name": grp,
               "weight_decay": weight_decay if grp == "g1" else 0.0} for grp in GROUPS]
    if adam:
        return torch.optim.Adam(groups, lr=0.0, betas=(momentum, beta2), eps=eps)
    return torch.optim.SGD(groups, lr=0.0, momentum=momentum, nesterov=True)


def set_schedule(optimizer: torch.optim.Optimizer, lrs: Dict[str, float]):
    """Every group's lr, and SGD's momentum, from a `Schedule` value."""
    for group in optimizer.param_groups:
        group["lr"] = lrs[group["name"]]
        if "momentum" in group:
            group["momentum"] = lrs["momentum"]


# ---------------------------------------------------------------------------
# EMA (params AND buffers)
# ---------------------------------------------------------------------------

def ema_decay(updates, decay: float = 0.9999) -> float:
    """Ramped decay d = decay * (1 - e^(-t / 2000))."""
    return decay * (1 - math.exp(-float(updates) / 2000.0))


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, d: float):
    """ema <- d * ema + (1 - d) * model, over the state_dict's floating
    tensors (parameters and BN statistics)."""
    new = model.state_dict()
    pairs = [(v, new[k]) for k, v in ema.state_dict().items() if v.is_floating_point()]
    e_t = [e for e, _ in pairs]
    torch._foreach_mul_(e_t, d)
    torch._foreach_add_(e_t, [n for _, n in pairs], alpha=1 - d)


def labels_to_class_weights(labels, nc: int):
    """Inverse-frequency class weights from per-image (n, 5) label arrays."""
    if len(labels) == 0:
        return np.ones(nc, np.float32)
    classes = np.concatenate([lb[:, 0] for lb in labels], 0).astype(int)
    weights = np.bincount(classes, minlength=nc).astype(np.float32)
    weights[weights == 0] = 1
    weights = 1 / weights
    return weights / weights.sum()


def labels_to_image_weights(labels, nc: int, class_weights) -> np.ndarray:
    """Per-image sampling weight from its class content."""
    counts = np.array(
        [np.bincount(lb[:, 0].astype(int), minlength=nc) for lb in labels],
        dtype=np.float64,
    ) if len(labels) else np.zeros((0, nc))
    return (np.asarray(class_weights).reshape(1, nc) * counts).sum(1) + 1e-6
