"""The training loop, for the anchor-based head (`assignment="anchor"`,
the SIoU `ComputeLoss`) and the anchor-free TDetect (`assignment="tal"`,
`ComputeLossTAL`).

Port of `dmayolo_tpu/train/trainer.py`.  The batches come from one of two
sources:

  * `data`: a dataset yaml or dict (`nc`, `train`, `val`), read through
    the port's `DetectionDataset` and threaded `DataLoader` with the hyp's
    augmentation; the EMA model is validated (`run_validation`) every
    `val_interval` epochs, `best` kept by fitness, and `EarlyStopping`
    ends the run after `patience` epochs without a better one;
  * `loader`: a sized iterable of in-memory batches with `.images` (uint8
    (B, H, W, 3)) and `.targets` (`Targets`, numpy or tensors), and `nc`;
    with `autoanchor`, the loader also has the dataset's `.shapes` and
    `.labels` (see `train/autoanchor.py`).  No validation.

The trainer scales the hyp, picks the accumulation, builds the loss, the
schedule and the train state, and runs the epochs: the warmup accumulate
ramp (`accum_ramp=False` keeps a fixed cadence), a `last` checkpoint in
the JAX `.npz` format and a row each epoch (`utils/loggers.py`:
`results.csv`, TensorBoard where it imports, `results.png` at the end);
the epoch on which early stopping fires saves `last` and ends the run
without a row or an `epoch{N}` checkpoint, as in JAX.  `callbacks` runs
the reference's hooks at the JAX trainer's points; with `ckpt_async` the
checkpoints are written on a background thread (`utils/async_ckpt.py`),
one at a time, drained before `train` returns.  `device_aug` (HSV and
flip) and `multi_scale` (a bilinear resize of the batch) run on the
model's device.
`mesh` (`parallel/mesh.py`, default `make_mesh()`: the group this process
joined, else world 1) makes the run data-parallel: `batch_size` is the
global batch and must divide by the world size; rank 0's weights are
broadcast before the first step; each rank loads only its rows of every
batch (the loader's process stripe; an in-memory loader's batches are
global and each rank takes its rows) and runs its share of the global
step (`make_train_step(mesh=...)`), so every rank holds the same state
as one process on the whole batch.  Validation is data-parallel too, and
rank 0's fitness decides `best` and early stopping on every rank; only
rank 0 writes checkpoints, `results.csv`, TensorBoard and the plots.
`spatial` (JAX's `Trainer(spatial=)`) on a (data, spatial) mesh
(`make_mesh(n_data, n_spatial)`) splits each image's rows over the
spatial group as well: `batch_size` divides by the data axis, the ranks
of a spatial group load the same images (the data rank's stripe), the
multi-scale resize acts on whole images, and each rank then keeps its H
rows for the step (`make_train_step(spatial=True)`) and the validation;
on a mesh that splits nothing it is the data-parallel run, as in JAX.
`remat` recomputes each graph layer's activations in the backward
(`DetectionModel.remat`); `freeze` keeps model.0 .. model.{freeze - 1}
as they are; `train_ungrouped` optimizes the parameters the reference
leaves out (`param_groups`); `linear_lr` takes the linear epoch schedule
in place of the cosine one.
"""
from __future__ import annotations

import math
import random
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from ..data.datasets import DetectionDataset, check_dataset
from ..data.loader import Batch, DataLoader  # noqa: F401 (Batch: the in-memory batches' type)
from ..eval.metrics import fitness
from ..eval.validator import run_validation
from ..graph import DetectionModel
from ..nn.heads import Detect, TDetect
from ..parallel.mesh import image_rows, local_rows, make_mesh, replicate_tree
from ..utils.async_ckpt import AsyncTrainCheckpointer
from ..utils.callbacks import Callbacks
from ..utils.checkpoint import load_checkpoint, save_checkpoint, strip_checkpoint
from ..utils.device import resolve_device
from ..utils.loggers import Loggers
from ..utils.weights import state_dict_from_jax
from .autoanchor import maybe_autoanchor
from .loss import ComputeLoss, Targets
from .optim import Schedule, labels_to_class_weights, labels_to_image_weights, param_groups
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


MULTI_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5)  # multi_scale's buckets of img_size
METRIC_KEYS = ("metrics/precision", "metrics/recall", "metrics/mAP_0.5",
               "metrics/mAP_0.5:0.95", "fitness")


def resize_batch(images: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> (B, size, size, 3): bilinear with half-pixel
    centres and no antialiasing (cv2's INTER_LINEAR), on the batch's
    device."""
    x = images.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=False)
    return x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


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
        loader=None,              # sized iterable of in-memory batches, or None with `data`
        hyp: Optional[Dict] = None,
        nc: Optional[int] = None,
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
        data=None,                # dataset yaml path or dict, or None with `loader`
        workers: int = 4,
        max_targets: int = 128,
        patience: int = 30,
        val_interval: int = 1,
        noval: bool = False,
        save_period: int = -1,
        device_aug: bool = False,
        multi_scale: bool = False,
        image_weights: bool = False,
        rect: bool = False,
        quad: bool = False,
        cache_images=False,       # False, True or "ram", or "disk"
        single_cls: bool = False,
        linear_lr: bool = False,
        train_ungrouped: bool = False,
        accum_ramp: bool = True,
        freeze: int = 0,
        remat: bool = False,
        ckpt_async: bool = False,
        mesh=None,
        spatial: bool = False,
    ):
        if (loader is None) == (data is None):
            raise ValueError("pass exactly one source of batches: loader= or data=")
        if hyp is None:
            raise ValueError("hyp is required")
        if data is None and (image_weights or rect or quad or cache_images or single_cls):
            raise ValueError("image_weights, rect, quad, cache_images and single_cls "
                             "need the dataset: pass data=")
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.spatial = spatial
        self.device = resolve_device(device if device is not None else self.mesh.device)
        self.is_main = self.mesh.is_main
        if batch_size % self.mesh.n_data:
            raise ValueError(f"batch_size {batch_size} must be divisible by the number of "
                             f"devices ({self.mesh.n_data} on the data axis)")
        self.epochs = epochs
        self.bs = batch_size
        self.dtype = dtype
        self.seed = seed
        self.nosave = nosave
        self.out = Path(out_dir)
        self.workers = workers
        self.max_targets = max_targets
        self.patience = patience
        self.val_interval = val_interval
        self.noval = noval
        self.save_period = save_period
        self.multi_scale = multi_scale
        self.image_weights = image_weights
        self.single_cls = single_cls
        self.data = check_dataset(data) if data is not None else None
        if self.data is not None:
            nc = 1 if single_cls else self.data["nc"]
        elif nc is None:
            raise ValueError("nc is required with an in-memory loader")
        self.nc = nc
        # checkpoints are self-describing: the config path, or the dict
        self.cfg_ref = str(cfg) if isinstance(cfg, (str, Path)) else dict(cfg)
        # hyp `anchors` (a count a level or pairs) overrides the yaml's
        self.model = DetectionModel(cfg, nc=nc, anchors=hyp.get("anchors"), device=self.device)
        gs = int(self.model.stride.max())
        img_size = self.img_size = check_img_size(img_size, gs, floor=gs * 2)

        h = scale_hyp(hyp, self.model.head.nl, nc, img_size)
        # device_aug: HSV and the lr-flip move into the train step; the
        # host pipeline sees those hyp keys zeroed
        self.device_aug = ({"hgain": h.get("hsv_h", 0.015), "sgain": h.get("hsv_s", 0.7),
                            "vgain": h.get("hsv_v", 0.4), "fliplr": h.get("fliplr", 0.5)}
                           if device_aug else None)
        self.train_ds = None
        if self.data is not None:
            host_h = dict(h)
            if device_aug:
                host_h.update(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, fliplr=0.0)
            self.train_ds = DetectionDataset(
                self.data["train"], img_size=img_size, augment=True, hyp=host_h, stride=gs,
                nc=self.data["nc"], batch_size=batch_size, seed=seed, single_cls=single_cls,
                cache_images=(cache_images == "ram" or cache_images is True),
                cache_disk=(cache_images == "disk"),
                rect=rect)  # rectangular training: no mosaic
            loader = DataLoader(self.train_ds, batch_size, max_targets=max_targets,
                                shuffle=not rect, workers=workers, seed=seed, quad=quad,
                                process_index=self.mesh.data_rank,
                                process_count=self.mesh.n_data)
        self.loader = loader
        self._global_batches = self.data is None  # an in-memory loader's: each rank takes its rows

        # the optimizer steps once per `accumulate` loader batches (toward
        # the nominal batch 64), clamped to an epoch's batch count
        self.steps_per_epoch = len(loader)
        self.accumulate = int(accumulate) if accumulate else max(round(NBS / batch_size), 1)
        self.accumulate = max(min(self.accumulate, self.steps_per_epoch), 1)
        if rect and self.accumulate > 1:
            # rect batches differ in shape, so a group cannot be concatenated
            print(f"rect: gradient accumulation disabled (was {self.accumulate}; "
                  "rect batch shapes vary)")
            self.accumulate = 1
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
            ds = self.train_ds if self.train_ds is not None else loader
            if not (hasattr(ds, "shapes") and hasattr(ds, "labels")):
                raise ValueError("autoanchor needs the loader's dataset .shapes and .labels")
            maybe_autoanchor(self.model, ds, img_size, thr=h.get("anchor_t", 4.0))
            head.anchors = self.mesh.broadcast_object(head.anchors)  # rank 0's, everywhere
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
            linear=linear_lr, batch_size=batch_size, step_scale=self.accumulate,
        )
        # warmup accumulate ramp: when asked for, the cadence is not pinned
        # by the caller and accumulation is in play at all
        self.accum_ramp = bool(accum_ramp and accumulate is None and self.accumulate > 1)
        self.freeze = freeze
        if freeze:
            print(f"freezing model.0..model.{freeze - 1}")
        self._steps = {}  # accumulate -> train step
        self._pulled = None  # (optimizer step, the state's trees on the host)

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
        self.model.remat = remat
        self.state = init_train_state(
            self.model, param_groups(self.model, train_ungrouped=train_ungrouped),
            self.weight_decay, adam=adam, momentum=h["momentum"])
        self.start_epoch = 0
        self.best_fitness = 0.0
        if resume is not None:
            trees, meta = resume
            load_state_trees(self.state, trees, meta)
            self.start_epoch = meta.get("epoch", -1) + 1
            self.best_fitness = meta.get("best_fitness", 0.0)
            print(f"resumed from {resume_from} at epoch {self.start_epoch}")
        replicate_tree(self.mesh, self.model)  # rank 0's weights on every rank
        replicate_tree(self.mesh, self.state.ema)
        if self.train_ds is not None:
            self.class_weights = labels_to_class_weights(self.train_ds.labels, nc)
        self.maps = np.zeros(nc)  # per-class mAP, for image-weight resampling
        self.out.mkdir(parents=True, exist_ok=True)
        self.loggers = Loggers(self.out) if self.is_main else None
        self.callbacks = Callbacks()
        self.ckpt_async = ckpt_async
        self._async_ckptr = None
        if self.train_ds is not None and self.is_main:
            try:  # the label statistics plot, inside the JAX trainer's guard
                from ..utils.plots import plot_labels

                lbls = [lb for lb in self.train_ds.labels if len(lb)]
                if lbls:
                    plot_labels(np.concatenate(lbls), self.data["names"], self.out)
            except Exception:
                pass

    # -------------------------------------------------------------------
    def get_step(self, acc: int):
        """The train step for one accumulate value, made once and kept."""
        if acc not in self._steps:
            self._steps[acc] = make_train_step(self.loss, self.sched, dtype=self.dtype,
                                               accumulate=acc, freeze=self.freeze,
                                               device_aug=self.device_aug, mesh=self.mesh,
                                               spatial=self.spatial)
        return self._steps[acc]

    def validate(self, use_ema: bool = True):
        """`run_validation` of the EMA model (or the model) on the val split."""
        if self.data is None:
            raise ValueError("validation needs the Trainer's data=")
        return run_validation(
            self.state.ema if use_ema else self.state.model, self.data["val"],
            img_size=self.img_size, batch_size=self.bs, nc=self.nc, dtype=self.dtype,
            max_targets=self.max_targets, single_cls=self.single_cls, workers=self.workers,
            device=self.device, mesh=self.mesh, spatial=self.spatial)

    def checkpoint_meta(self, epoch: int) -> Dict:
        """The meta a checkpoint of `epoch` carries, as the JAX Trainer's."""
        meta = {"epoch": epoch, "best_fitness": float(self.best_fitness),
                "step": self.state.step, "updates": self.state.ema_updates,
                "nc": self.nc, "cfg": self.cfg_ref}
        if isinstance(self.model.head, Detect):  # the live anchors, in stride units
            meta["anchors"] = np.asarray(self.model.head.anchors, np.float32).tolist()
        return meta

    def _save(self, name: str, epoch: int):
        if not self.is_main:
            return
        meta = self.checkpoint_meta(epoch)
        # one device-to-host pull an optimizer step, shared by its best and last
        if self._pulled is None or self._pulled[0] != self.state.step:
            self._pulled = (self.state.step, state_trees(self.state))
        if self.ckpt_async:
            if self._async_ckptr is None:
                self._async_ckptr = AsyncTrainCheckpointer()
            self._async_ckptr.save(self.out / name, self._pulled[1], meta=meta)
            return
        save_checkpoint(self.out / name, meta=meta, half=True, **self._pulled[1])

    def _log_csv(self, row: Dict):
        step = row.pop("epoch")
        if self.loggers is not None:
            self.loggers.log_metrics(row, step)

    def to_device(self, group):
        """A group of loader batches -> images and Targets on the device
        (this rank's rows of each where the batches are global)."""
        if self._global_batches and self.mesh.distributed:
            group = [Batch(np.asarray(b.images)[rows], Targets(*(np.asarray(t)[rows]
                                                                 for t in b.targets)))
                     for b in group for rows in (local_rows(len(b.images), self.mesh),)]
        cat = (lambda xs: np.concatenate([np.asarray(x) for x in xs])) if len(group) > 1 \
            else (lambda xs: np.asarray(xs[0]))
        images = torch.from_numpy(cat([b.images for b in group])).to(self.device)
        targets = Targets(*(torch.from_numpy(cat([b.targets[i] for b in group])).to(self.device)
                            for i in range(3)))
        return images, targets

    def train(self, log_every: int = 10) -> float:
        """Run the epochs; returns the best fitness (the state stays on
        `self.state`)."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        stopper = EarlyStopping(self.patience)
        gs = int(self.model.stride.max())
        t_start = time.time()
        self._pending = []  # the accumulation group, carried across epochs
        # the global batch counter ni drives the ramp and, on that path,
        # the schedule in batch units
        self._ni = self.start_epoch * self.steps_per_epoch
        self.callbacks.run("on_train_start")
        try:
            for epoch in range(self.start_epoch, self.epochs):
                self.callbacks.run("on_train_epoch_start")
                t0 = time.time()
                running, nb, metrics = {}, 0, None
                opt_steps = max(self.steps_per_epoch // self.accumulate, 1)
                if self.image_weights and self.train_ds is not None:
                    cw = self.class_weights * (1 - self.maps) ** 2 / self.nc
                    self.loader.sample_weights = labels_to_image_weights(self.train_ds.labels,
                                                                         self.nc, cw)
                ms_rng = random.Random(self.seed + epoch)
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
                    if self.multi_scale:  # a bucket of sizes bounds the shapes seen
                        sz = int(round(self.img_size * ms_rng.choice(MULTI_SCALES) / gs) * gs)
                        if sz != images.shape[1]:
                            images = resize_batch(images, sz)
                    if self.spatial:  # whole images up to here; this rank's rows from here
                        images = images[:, image_rows(images.shape[1], self.mesh)]
                    if self.accum_ramp:
                        metrics = self.get_step(len(group))(self.state, images, targets, gen,
                                                            ni=float(ni))
                    else:
                        metrics = self.get_step(self.accumulate)(self.state, images, targets, gen)
                    nb += 1
                    if nb % log_every == 0 or nb == opt_steps:
                        running = {k: float(v) for k, v in metrics.items()}
                        if self.is_main:
                            print(f"epoch {epoch} [{nb}/{opt_steps}] "
                                    + " ".join(f"{k}={v:.4f}" for k, v in running.items()),
                                  flush=True)
                if metrics is not None:
                    running = {k: float(v) for k, v in metrics.items()}
                row = {"epoch": epoch, **{f"train/{k}": v for k, v in running.items()}}
                final_epoch = epoch == self.epochs - 1
                if self.data is not None and ((epoch + 1) % self.val_interval == 0 or final_epoch) \
                        and (not self.noval or final_epoch):
                    res = self.validate()
                    if res.maps is not None:
                        self.maps = res.maps
                    if self.is_main:
                        print(f"epoch {epoch} val: {res.summary()}", flush=True)
                    fi = float(fitness(np.array([[res.mp, res.mr, res.map50, res.map]]))[0])
                    fi = self.mesh.broadcast_object(fi)  # one decision on every rank
                    if fi > self.best_fitness:
                        self.best_fitness = fi
                        if not self.nosave:
                            self._save("best", epoch)
                    row.update(zip(METRIC_KEYS, (res.mp, res.mr, res.map50, res.map, fi)))
                    if stopper(epoch, fi):  # as JAX: `last` saved, no row, no epoch{N}
                        print(f"early stopping at epoch {epoch}")
                        self._save("last", epoch)
                        break
                if not self.nosave or final_epoch:
                    self._save("last", epoch)
                if self.save_period > 0 and (epoch + 1) % self.save_period == 0:
                    self._save(f"epoch{epoch}", epoch)
                self._pulled = None  # the host copy serves only this epoch's saves
                self.callbacks.run("on_model_save")
                row["time_s"] = time.time() - t0
                self._log_csv(row)
                self.callbacks.run("on_fit_epoch_end", row, epoch)
        finally:  # the write in flight lands, also when a step raises
            if self._async_ckptr is not None:
                self._async_ckptr.close()
        # stripped checkpoints mark a finished run
        for name in ("last", "best"):
            if self.is_main and (self.out / f"{name}.npz").exists():
                strip_checkpoint(self.out / name)
        if self.loggers is not None:
            self.loggers.finalize()
        self.mesh.barrier()  # no rank reads a checkpoint before rank 0 has written it
        self.callbacks.run("on_train_end")
        if self.is_main:
            print(f"training done in {(time.time() - t_start) / 3600:.2f}h; "
                  f"best fitness {self.best_fitness:.4f}")
        return self.best_fitness
