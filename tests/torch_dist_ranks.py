"""The rank side of the port's data-parallel tests (test_torch_dist.py): the
functions `parallel.mesh.spawn` runs in each rank, and a one-rank group for
the tests that run the distributed path in their own process.  Imports
torch and the port only, so that a rank starts without JAX."""
import os
import tempfile

import numpy as np
import torch


def one_rank_group():
    """A gloo group of one rank on the CPU in this process (its collectives
    are the identity); leave it with `parallel.mesh.close_group()`."""
    from dmayolo_tpu_torch.parallel.mesh import init_group

    path = os.path.join(tempfile.mkdtemp(prefix="dmayolo_one_rank_"), "store")
    return init_group(0, 1, "gloo", "cpu", store_path=path)


def raise_on_rank_1(mesh):
    """Rank 1 raises at once; rank 0 waits for it in a barrier."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier()
    return "rank 0 passed the barrier"


def _rows(mesh, x):
    n = x.shape[0] // mesh.world
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def bn_case(mesh, x, dy):
    """BN's forward, backward and running statistics on this rank's rows
    of (x, dy) inside the group."""
    from dmayolo_tpu_torch.nn.primitives import BatchNorm2d, lend_mesh

    bn = BatchNorm2d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
    xl = torch.from_numpy(_rows(mesh, x)).requires_grad_(True)
    with lend_mesh(bn, mesh):
        y = bn(xl, torch.float32)
        y.backward(torch.from_numpy(_rows(mesh, dy)))
    return {"y": y.detach().numpy(), "dx": xl.grad.numpy(), "dw": bn.weight.grad.numpy(),
            "db": bn.bias.grad.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def loss_case(mesh, kind, preds, targets, **kw):
    """The anchor loss ("anchor") or TAL's ("tal") on this rank's rows:
    its total and items (this rank's shares) and the gradient of its
    predictions."""
    from dmayolo_tpu_torch.train.loss import ComputeLoss, Targets
    from dmayolo_tpu_torch.train.tal import ComputeLossTAL

    loss = (ComputeLoss(kw["anchors"], kw["hyp"], nc=kw["nc"]) if kind == "anchor"
            else ComputeLossTAL(kw["stride"], nc=kw["nc"], hyp=kw["hyp"]))
    ps = [torch.from_numpy(_rows(mesh, p)).requires_grad_(True) for p in preds]
    tg = Targets(*(torch.from_numpy(_rows(mesh, t)) for t in targets))
    total, items = loss(ps, tg, mesh=mesh)
    total.backward()
    return {"total": float(total.detach()),
            "items": {k: float(v.detach()) for k, v in items.items()},
            "grads": [p.grad.numpy() for p in ps]}


def stochastic_case(mesh, shape, rate, seed):
    """Dropout's and DropPath's masks on this rank's rows of ones."""
    from dmayolo_tpu_torch.nn.primitives import Dropout, DropPath, lend_generator, lend_mesh

    model = torch.nn.ModuleList([Dropout(rate), DropPath(rate)]).train()
    x = torch.ones((shape[0] // mesh.world,) + tuple(shape[1:]))
    with lend_mesh(model, mesh), lend_generator(model, torch.Generator().manual_seed(seed)):
        return [m(x).numpy() for m in model]


def device_aug_case(mesh, images, seed):
    """`augment_batch` of this rank's rows, drawing the whole batch's gains
    and flips."""
    from dmayolo_tpu_torch.data.device_aug import augment_batch

    b = images.shape[0] // mesh.world
    x, flipped = augment_batch(torch.from_numpy(_rows(mesh, images)),
                               torch.Generator().manual_seed(seed),
                               rows=(mesh.rank * b, images.shape[0]))
    return x.numpy(), flipped.numpy()


def train_step_case(mesh, cfg, state_dict, hyp, images, targets, accumulate, device_aug,
                    sched_kw, seed=0, remat=False):
    """One f32 train step of the model of `cfg` from `state_dict` on this
    rank's rows of each global microbatch (each graph layer recomputed in
    the backward with `remat`): the metrics and the JAX checkpoint trees of
    the state after it."""
    from dmayolo_tpu_torch.graph import DetectionModel
    from dmayolo_tpu_torch.parallel.mesh import replicate_tree, shard_batch
    from dmayolo_tpu_torch.train import optim as po
    from dmayolo_tpu_torch.train import step as ps
    from dmayolo_tpu_torch.train.loss import ComputeLoss, Targets

    pm = DetectionModel(cfg, device="cpu")
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True)
    replicate_tree(mesh, pm)
    pm.remat = remat
    sched_kw = dict(sched_kw)
    state = ps.init_train_state(pm, po.param_groups(pm), sched_kw.pop("weight_decay"),
                                momentum=hyp["momentum"])
    sched = po.Schedule(hyp, **sched_kw)
    step = ps.make_train_step(ComputeLoss(pm.head.anchors, hyp, nc=cfg["nc"]), sched,
                              dtype=torch.float32, accumulate=accumulate,
                              device_aug=device_aug, mesh=mesh)
    imgs = shard_batch(mesh, images, accumulate)
    tg = shard_batch(mesh, Targets(*targets), accumulate)
    metrics = step(state, imgs, tg, torch.Generator().manual_seed(seed))
    return {k: float(v) for k, v in metrics.items()}, ps.state_trees(state)


def trainer_case(mesh, cfg, state_dict, hyp, batches, out_dir):
    """`Trainer(mesh=...)` over an in-memory epoch of global batches
    (accumulate 2, EMA on): the JAX checkpoint trees of its state, the
    steps taken, and the files this rank wrote."""
    from pathlib import Path

    from dmayolo_tpu_torch.train.loss import Targets
    from dmayolo_tpu_torch.train.step import state_trees
    from dmayolo_tpu_torch.train.trainer import Batch, Trainer

    out = Path(out_dir) / f"rank{mesh.rank}"
    loader = [Batch(im, Targets(*tg)) for im, tg in batches]
    tr = Trainer(cfg, loader, dict(hyp), nc=cfg["nc"], epochs=1, batch_size=len(loader[0].images),
                 img_size=batches[0][0].shape[1], accumulate=2, out_dir=str(out),
                 dtype=torch.float32, seed=0, device="cpu", mesh=mesh, accum_ramp=False)
    tr.model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    tr.state.ema.load_state_dict(tr.model.state_dict())
    tr.train()
    return {"trees": state_trees(tr.state), "step": tr.state.step,
            # TensorBoard's event file is named by its time and process
            "files": sorted("tfevents" if "tfevents" in p.name else p.name
                            for p in out.iterdir())}


def validation_case(mesh, cfg, state_dict, val_dir, out_dir, **kw):
    """`run_validation` at this rank: its result, the COCO entries, and
    the txt files rank 0 wrote."""
    from dmayolo_tpu_torch.eval.validator import run_validation
    from dmayolo_tpu_torch.graph import DetectionModel

    pm = DetectionModel(cfg, device="cpu")
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True)
    jdict = []
    res = run_validation(pm.eval(), val_dir, device="cpu", mesh=mesh, save_json=jdict,
                         save_txt_dir=out_dir, save_conf=True, workers=1, **kw)
    return {"res": res, "json": jdict}


def rank_checks(mesh, cases):
    """Every case of `cases` ({name: (function name, kwargs)}) in turn, in
    one launch: {name: result}."""
    out = {}
    for name, (fn, kw) in cases.items():
        out[name] = globals()[fn](mesh, **kw)
    return out


def as_numpy_state(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def global_rows_of(results, key):
    """The ranks' rows of `key` stacked back into the global batch."""
    return np.concatenate([r[key] for r in results])
