"""The training loop, for the anchor-based head (`assignment="anchor"`,
the SIoU `ComputeLoss`) and the anchor-free TDetect (`assignment="tal"`,
`ComputeLossTAL`).

Port of `dmayolo_tpu/train/trainer.py` without the data stack: the caller
passes the loader, a sized iterable of batches with `.images` (uint8
(B, H, W, 3)) and `.targets` (`Targets`, numpy or tensors), the JAX
`DataLoader`'s batch shape, and `nc`; with `autoanchor`, the loader also
has the dataset's `.shapes` and `.labels` (see `train/autoanchor.py`).
The trainer scales the hyp, picks the accumulation, builds the loss, the
schedule and the train state, and runs the epochs: the warmup accumulate
ramp, a `last` checkpoint in the JAX `.npz` format and a CSV row each
epoch.
"""
from __future__ import annotations

import csv
import math
import time
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import yaml

from ..graph import DetectionModel
from ..nn.heads import Detect, TDetect
from ..utils.checkpoint import load_checkpoint, save_checkpoint, strip_checkpoint
from ..utils.device import resolve_device
from ..utils.weights import state_dict_from_jax
from .autoanchor import maybe_autoanchor
from .loss import ComputeLoss, Targets
from .optim import Schedule, param_groups
from .step import init_train_state, load_state_trees, make_train_step, state_trees
from .tal import ComputeLossTAL

NBS = 64  # nominal batch size
HYP_DIR = Path(__file__).resolve().parents[1] / "configs" / "hyp"


def load_hyp(name) -> Dict:
    """A hyp yaml by path, or by bare name from the port's own copies."""
    path = Path(name)
    if not path.exists():
        path = HYP_DIR / (path.name if path.suffix else path.name + ".yaml")
    with open(path, errors="ignore") as f:
        return yaml.safe_load(f)


def check_img_size(imgsz: int, s: int = 32, floor: int = 0) -> int:
    """Round `imgsz` up to a multiple of the model's max stride `s`."""
    new = max(math.ceil(imgsz / s) * s, floor)
    if new != imgsz:
        print(f"WARNING: --img-size {imgsz} must be a multiple of max stride {s}, "
              f"updating to {new}")
    return new


def scale_hyp(hyp: Dict, nl: int, nc: int, img_size: int) -> Dict:
    """The loss gains scaled to the number of levels, classes and the
    image size, as the reference trainer does."""
    h = dict(hyp)
    h["box"] = h.get("box", 0.05) * 3 / nl
    h["cls"] = h.get("cls", 0.5) * nc / 80 * 3 / nl
    h["obj"] = h.get("obj", 1.0) * (img_size / 640) ** 2 * 3 / nl
    return h


class Batch(NamedTuple):
    """One loader batch: uint8 images (B, H, W, 3) and their Targets."""

    images: Any
    targets: Targets


class EarlyStopping:
    """Stop after `patience` epochs without a better fitness."""

    def __init__(self, patience=30):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch, fi):
        if fi >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fi
        return (epoch - self.best_epoch) >= self.patience


class Trainer:
    def __init__(
        self,
        cfg,                      # model yaml path or dict
        loader,                   # sized iterable of Batch-shaped batches
        hyp: Dict,
        nc: int,
        epochs: int = 100,
        batch_size: int = 16,
        img_size: int = 640,
        assignment: str = "anchor",
        adam: bool = False,
        out_dir: str = "runs/train/exp",
        dtype=torch.bfloat16,
        seed: int = 0,
        resume_from: Optional[str] = None,
        pretrained: Optional[str] = None,
        accumulate: Optional[int] = None,
        autoanchor: bool = False,
        nosave: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.epochs = epochs
        self.dtype = dtype
        self.seed = seed
        self.nosave = nosave
        self.out = Path(out_dir)
        self.loader = loader
        self.nc = nc
        # checkpoints are self-describing: the config path, or the dict
        self.cfg_ref = str(cfg) if isinstance(cfg, (str, Path)) else dict(cfg)
        # hyp `anchors` (a count a level or pairs) overrides the yaml's
        self.model = DetectionModel(cfg, nc=nc, anchors=hyp.get("anchors"), device=self.device)
        gs = int(self.model.stride.max())
        img_size = self.img_size = check_img_size(img_size, gs, floor=gs * 2)

        h = scale_hyp(hyp, self.model.head.nl, nc, img_size)

        # the optimizer steps once per `accumulate` loader batches (toward
        # the nominal batch 64), clamped to an epoch's batch count
        self.steps_per_epoch = len(loader)
        self.accumulate = int(accumulate) if accumulate else max(round(NBS / batch_size), 1)
        self.accumulate = max(min(self.accumulate, self.steps_per_epoch), 1)
        self.weight_decay = h.get("weight_decay", 5e-4) * batch_size * self.accumulate / NBS

        # resume: the trained anchors go in before the loss reads them
        head = self.model.head
        resume = load_checkpoint(resume_from) if resume_from else None
        resumed_anchors = False
        if resume is not None and isinstance(head, Detect):
            anc = resume[1].get("anchors")
            if anc is not None and np.shape(anc) == np.shape(head.anchors):
                head.anchors = np.asarray(anc, np.float32)
                resumed_anchors = True
        if assignment not in ("anchor", "tal"):
            raise ValueError(f"unknown assignment {assignment!r}")
        if autoanchor and assignment == "anchor" and not resumed_anchors:
            if not (hasattr(loader, "shapes") and hasattr(loader, "labels")):
                raise ValueError("autoanchor needs the loader's dataset .shapes and .labels")
            maybe_autoanchor(self.model, loader, img_size, thr=h.get("anchor_t", 4.0))
        if assignment == "tal":
            if not isinstance(head, TDetect):
                raise ValueError("assignment 'tal' needs a TDetect head")
            self.loss = ComputeLossTAL(self.model.stride, nc=nc, hyp=h)
        else:
            if not isinstance(head, Detect):
                raise ValueError("assignment 'anchor' needs a Detect head")
            # `anchors: <int>` configs carry placeholder anchors [0, 1, 2,
            # ...] that only autoanchor replaces; a 0-sized anchor makes
            # SIoU NaN
            if float(np.min(head.anchors)) <= 0:
                raise ValueError(
                    "model has placeholder/degenerate anchors (min size 0): this config "
                    "declares `anchors: <int>`; pass autoanchor=True (with a loader that "
                    "has .shapes and .labels) or specify anchor pairs in the yaml")
            self.loss = ComputeLoss(head.anchors, h, nc=nc)
        self.sched = Schedule(
            h, epochs=epochs, steps_per_epoch=self.steps_per_epoch, adam=adam,
            batch_size=batch_size, step_scale=self.accumulate,
        )
        # warmup accumulate ramp: when the cadence is not pinned by the
        # caller and accumulation is in play at all
        self.accum_ramp = accumulate is None and self.accumulate > 1
        self._steps = {}  # accumulate -> train step

        # init / pretrained / resume
        self.model.init_with_priors(torch.Generator().manual_seed(seed))
        if pretrained:
            trees, _ = load_checkpoint(pretrained)
            src = state_dict_from_jax(trees.get("ema_params") or trees["params"],
                                      trees.get("ema_stats") or trees.get("stats", {}))
            own = self.model.state_dict()
            hits = {k: v for k, v in src.items() if k in own and v.shape == own[k].shape}
            self.model.load_state_dict(hits, strict=False)
            n_params = sum(1 for _ in self.model.parameters())
            n_hit = sum(1 for k, _ in self.model.named_parameters() if k in hits)
            print(f"pretrained: matched {n_hit}/{n_params} tensors")
        self.state = init_train_state(self.model, param_groups(self.model),
                                      self.weight_decay, adam=adam, momentum=h["momentum"])
        self.start_epoch = 0
        self.best_fitness = 0.0
        if resume is not None:
            trees, meta = resume
            load_state_trees(self.state, trees, meta)
            self.start_epoch = meta.get("epoch", -1) + 1
            self.best_fitness = meta.get("best_fitness", 0.0)
            print(f"resumed from {resume_from} at epoch {self.start_epoch}")
        self.out.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.out / "results.csv"

    # -------------------------------------------------------------------
    def get_step(self, acc: int):
        """The train step for one accumulate value, made once and kept."""
        if acc not in self._steps:
            self._steps[acc] = make_train_step(self.loss, self.sched, dtype=self.dtype,
                                               accumulate=acc)
        return self._steps[acc]

    def _save(self, name: str, epoch: int):
        meta = {"epoch": epoch, "best_fitness": float(self.best_fitness),
                "step": self.state.step, "updates": self.state.ema_updates,
                "nc": self.nc, "cfg": self.cfg_ref}
        if isinstance(self.model.head, Detect):  # the live anchors, in stride units
            meta["anchors"] = np.asarray(self.model.head.anchors, np.float32).tolist()
        save_checkpoint(self.out / name, meta=meta, half=True, **state_trees(self.state))

    def _log_csv(self, row: Dict):
        new = not self.csv_path.exists()
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if new:
                w.writeheader()
            w.writerow(row)

    def to_device(self, group):
        """A group of loader batches -> images and Targets on the device."""
        cat = (lambda xs: np.concatenate([np.asarray(x) for x in xs])) if len(group) > 1 \
            else (lambda xs: np.asarray(xs[0]))
        images = torch.from_numpy(cat([b.images for b in group])).to(self.device)
        targets = Targets(*(torch.from_numpy(cat([b.targets[i] for b in group])).to(self.device)
                            for i in range(3)))
        return images, targets

    def train(self, log_every: int = 10):
        """Run the epochs; returns the train state."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        t_start = time.time()
        self._pending = []  # the accumulation group, carried across epochs
        # the global batch counter ni drives the ramp and, on that path,
        # the schedule in batch units
        self._ni = self.start_epoch * self.steps_per_epoch
        for epoch in range(self.start_epoch, self.epochs):
            t0 = time.time()
            running, nb, metrics = {}, 0, None
            opt_steps = max(self.steps_per_epoch // self.accumulate, 1)
            for batch in self.loader:
                self._pending.append(batch)
                ni = self._ni
                self._ni += 1
                acc_target = self.accumulate
                if self.accum_ramp and ni <= self.sched.nw:
                    acc_target = int(max(1, min(self.accumulate, round(
                        np.interp(ni, [0, self.sched.nw], [1, self.accumulate])))))
                if len(self._pending) < acc_target:
                    continue
                group, self._pending = self._pending, []
                images, targets = self.to_device(group)
                if self.accum_ramp:
                    metrics = self.get_step(len(group))(self.state, images, targets, gen,
                                                        ni=float(ni))
                else:
                    metrics = self.get_step(self.accumulate)(self.state, images, targets, gen)
                nb += 1
                if nb % log_every == 0 or nb == opt_steps:
                    running = {k: float(v) for k, v in metrics.items()}
                    print(f"epoch {epoch} [{nb}/{opt_steps}] "
                          + " ".join(f"{k}={v:.4f}" for k, v in running.items()), flush=True)
            if metrics is not None:
                running = {k: float(v) for k, v in metrics.items()}
            row = {"epoch": epoch, **{f"train/{k}": v for k, v in running.items()}}
            final_epoch = epoch == self.epochs - 1
            if not self.nosave or final_epoch:
                self._save("last", epoch)
            row["time_s"] = time.time() - t0
            self._log_csv(row)
        # a stripped last is the finished-run marker
        if (self.out / "last.npz").exists():
            strip_checkpoint(self.out / "last")
        print(f"training done in {(time.time() - t_start) / 3600:.2f}h")
        return self.state
