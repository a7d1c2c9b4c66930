"""The train step: forward, loss, backward, optimizer and EMA.

Port of `dmayolo_tpu/train/step.py`.  The JAX `TrainState` of flat trees
becomes the model (f32 master weights; BN running statistics as its
buffers), the `torch.optim` optimizer, an EMA copy of the model and two
counters.  Microbatch accumulation sums the gradients of `accumulate`
forwards and backwards, the BN statistics chaining through them in place,
as the JAX `lax.scan` carry does.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..data.device_aug import augment_batch, flip_targets_lr
from ..nn.primitives import lend_generator, lend_mesh
from ..parallel.mesh import Mesh, all_reduce_flat, with_group
from ..parallel.spatial import spatial_scope
from ..utils.weights import jax_from_state_dict, jax_paths, state_dict_from_jax, to_jax_layout
from .loss import Targets
from .optim import Schedule, ema_decay, ema_update, make_optimizer, set_schedule


class TrainState:
    """What a train step reads and advances: the model (train mode), its
    optimizer, the EMA model (eval mode, no grads), the optimizer step
    count and the EMA update count."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 ema: nn.Module, step: int = 0, ema_updates: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.ema = ema
        self.step = step
        self.ema_updates = ema_updates


def init_train_state(model: nn.Module, labels: Dict[str, str], weight_decay: float,
                     adam: bool = False, momentum: float = 0.937) -> TrainState:
    """A fresh state over `model`: the optimizer of `make_optimizer`, the
    EMA a copy of the model as it stands."""
    ema = copy.deepcopy(model).eval().requires_grad_(False)
    optimizer = make_optimizer(model, labels, weight_decay, adam=adam, momentum=momentum)
    return TrainState(model.train(), optimizer, ema)


def _frozen(name: str, freeze: int) -> bool:
    """Layers model.0 .. model.{freeze - 1}."""
    parts = name.split(".")
    return parts[0] == "model" and parts[1].isdigit() and int(parts[1]) < freeze


def make_train_step(loss_fn: Callable, sched: Schedule, dtype=torch.bfloat16,
                    accumulate: int = 1, freeze: int = 0, device_aug: Optional[Dict] = None,
                    mesh: Optional[Mesh] = None, spatial: bool = False):
    """Build the step `(state, images, targets, generator=None, ni=None) ->
    metrics`.

    images: (accumulate * micro_bs, H, W, 3), uint8 (divided by 255 in
    `dtype`) or float; targets: `Targets` with the same leading dim, on the
    images' device.  The step takes `accumulate` microbatches, sums their
    gradients, sets the lr (and SGD momentum) from `sched` at the optimizer
    step count, or at the batch counter `ni` when given (the warmup
    accumulate ramp), steps the optimizer, and updates the EMA.  `freeze`
    leaves the parameters of model.0 .. model.{freeze - 1} and their
    optimizer state exactly as they were.  `generator` is the JAX step's
    rng: every Dropout and DropPath of the model draws its masks from it
    (`lend_generator`; a model with one at a rate above 0 needs it), and
    so does `device_aug`: {'hgain', 'sgain', 'vgain', 'fliplr'} moves the HSV
    jitter and the left-right flip of each uint8 microbatch into the step
    (`data/device_aug.py`, on the images' device), the targets of flipped
    rows mirrored; the host pipeline must then leave them out.

    metrics: loss (total / accumulate) and the loss's items (box, obj and
    cls, or TAL's box, cls and dfl) averaged over the microbatches, as 0-d
    tensors on the device.

    `mesh` (`parallel/mesh.py`) with a group makes this rank's step a share
    of one step over the global batch, as the JAX step under `jit` on a
    mesh: `images` are this rank's rows of each global microbatch
    (`parallel.mesh.local_rows`), BN (`lend_mesh`) and the loss (called
    with `mesh=`) reduce over the group, `device_aug` and the Dropout and DropPath draws take
    this rank's rows of the global batch's numbers, the gradients are SUM
    all-reduced in flat buckets after the last microbatch (before `freeze`
    and the optimizer), and so are the metrics.  Every rank then applies
    the same update.

    With `spatial` and a mesh that splits rows (JAX's `jit_train_step(
    spatial=True)`), `images` are also only this rank's H rows
    (`shard_batch(spatial=True)`): the forward and backward run in the
    spatial scope (`parallel/spatial.py`), BN reduces over every rank, and
    each rank computes its data rank's loss share on the gathered head,
    divided by n_spatial, whose gradient `gather_h`'s adjoint sums back
    over the spatial group.  The loss's normalisers and the batch's draws
    are the data axis's; the gradient and metric sums run over every rank.
    On a (data, spatial) mesh without `spatial` the ranks of a spatial
    group compute the same rows, each a 1 / n_spatial share.
    """
    dp = with_group(mesh)
    data = with_group(mesh.data) if mesh is not None else None
    split = spatial and mesh is not None and mesh.spatial
    share = mesh.n_spatial if mesh is not None else 1

    def step(state: TrainState, imgs: torch.Tensor, targets: Targets,
             generator: Optional[torch.Generator] = None, ni=None) -> Dict:
        model = state.model.train()
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        mb = imgs.shape[0] // accumulate
        rows = None if data is None else (data.rank * mb, mb * data.world)
        total, items = 0.0, {}
        with lend_mesh(model, mesh if split else data), spatial_scope(mesh if split else None):
            for k in range(accumulate):
                sl = slice(k * mb, (k + 1) * mb)
                x = imgs[sl]
                tgt = Targets(*(t[sl] for t in targets))
                if device_aug is not None and x.dtype == torch.uint8:
                    x, flipped = augment_batch(
                        x, generator, hgain=device_aug["hgain"], sgain=device_aug["sgain"],
                        vgain=device_aug["vgain"], fliplr_p=device_aug["fliplr"], dtype=dtype,
                        rows=rows)
                    tgt = Targets(tgt.cls, flip_targets_lr(tgt.box, flipped), tgt.mask)
                else:
                    x = x.to(dtype) / 255.0 if x.dtype == torch.uint8 else x.to(dtype)
                with lend_generator(model, generator):
                    raw = model(x, dtype)
                with record_function("loss"):
                    tot, its = (loss_fn(raw, tgt) if data is None
                                else loss_fn(raw, tgt, mesh=data))
                    if share > 1:
                        tot, its = tot / share, {n: v / share for n, v in its.items()}
                tot.backward()
                total = total + tot.detach()
                items = {n: items.get(n, 0.0) + torch.as_tensor(v).detach()
                         for n, v in its.items()}
        if dp is not None:
            with record_function("gradient all-reduce"):
                all_reduce_flat(dp, [p.grad for p in model.parameters() if p.grad is not None])
            summed = dp.all_reduce(torch.stack([total, *items.values()]))
            total, items = summed[0], dict(zip(items, summed[1:]))
        if freeze:
            for name, p in model.named_parameters():
                if _frozen(name, freeze):
                    p.grad = None  # the optimizer skips it: no update, no state
        with record_function("optimizer"):
            set_schedule(opt, sched(state.step) if ni is None else sched(ni, batch_units=True))
            opt.step()
        state.step += 1
        state.ema_updates += 1
        with record_function("ema"):
            ema_update(state.ema, model, ema_decay(state.ema_updates))
        return {"loss": total / accumulate, **{n: v / accumulate for n, v in items.items()}}

    return step


def state_trees(state: TrainState) -> Dict[str, Dict]:
    """The state as the six JAX checkpoint trees (numpy, JAX layouts):
    params, stats, their EMA, and the optimizer's first and second moment
    (SGD's momentum buffer or Adam's exp_avg; Adam's exp_avg_sq), zeros
    for a parameter with no optimizer state yet."""
    model = state.model
    paths = jax_paths(model)
    params, stats = jax_from_state_dict(model)
    ema_params, ema_stats = jax_from_state_dict(model, state.ema.state_dict())
    opt_mom, opt_vel = {}, {}
    for name, p in model.named_parameters():
        path = paths[name][1]
        st = state.optimizer.state.get(p, {})
        mom = st.get("momentum_buffer", st.get("exp_avg"))
        vel = st.get("exp_avg_sq")
        opt_mom[path] = to_jax_layout(path, torch.zeros_like(p) if mom is None else mom)
        opt_vel[path] = to_jax_layout(path, torch.zeros_like(p) if vel is None else vel)
    return {"params": params, "stats": stats, "ema_params": ema_params,
            "ema_stats": ema_stats, "opt_mom": opt_mom, "opt_vel": opt_vel}


def load_state_trees(state: TrainState, trees: Dict[str, Dict], meta: Dict) -> TrainState:
    """Resume `state` from JAX checkpoint trees and meta (`step`,
    `updates`): model, EMA (the model's trees where the checkpoint has
    none) and, where present, the optimizer moments of every parameter
    the optimizer holds."""
    dev = next(state.model.parameters()).device
    state.model.load_state_dict(state_dict_from_jax(trees["params"], trees["stats"], dev))
    state.ema.load_state_dict(state_dict_from_jax(
        trees.get("ema_params", trees["params"]), trees.get("ema_stats", trees["stats"]), dev))
    state.step = int(meta.get("step", 0))
    state.ema_updates = int(meta.get("updates", 0))
    if "opt_mom" in trees and state.step > 0:
        mom = state_dict_from_jax(trees["opt_mom"], {}, dev)
        vel = state_dict_from_jax(trees["opt_vel"], {}, dev)
        by_param = {p: name for name, p in state.model.named_parameters()}
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                m = torch.empty_like(p).copy_(mom[by_param[p]])
                if "betas" in group:
                    v = torch.empty_like(p).copy_(vel[by_param[p]])
                    state.optimizer.state[p] = {"step": torch.tensor(float(state.step)),
                                                "exp_avg": m, "exp_avg_sq": v}
                else:
                    state.optimizer.state[p] = {"momentum_buffer": m}
    return state
