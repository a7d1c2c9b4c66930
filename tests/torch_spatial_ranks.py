"""The rank side of the port's spatial H-sharding tests
(test_torch_spatial.py): functions that `parallel.mesh.spawn` runs in each
rank of a (data, spatial) layout, and that the test process runs on one
process (`mesh=None`) for the references.  Imports torch and the port
only, so that a rank starts without JAX."""
import numpy as np
import torch

from dmayolo_tpu_torch.parallel import spatial as sp
from dmayolo_tpu_torch.parallel.mesh import image_rows, local_rows, make_mesh, shard_batch

# the ops whose spatial forms the collective checks hold, by name
OPS = ("conv_k3s1", "conv_k3s2", "conv_k6s2p2", "conv_dilated", "conv_dw7", "max_pool5",
       "max_pool3s2", "avg_pool4", "avg_pool2s2", "upsample2", "resize_nearest", "bilinear",
       "space_to_depth", "zero_pad", "gather_slice", "global_pools", "ca_train", "dropout",
       "drop_path")


def layout(mesh, n_spatial):
    """The (data, spatial) mesh of this launch's group; None on one
    process."""
    if mesh is None:
        return None
    return make_mesh(mesh.world // n_spatial, n_spatial, device="cpu")


def local_map(mesh, x: np.ndarray) -> torch.Tensor:
    """This rank's data rows and H rows of a global NCHW map, channels_last."""
    t = torch.from_numpy(x)
    if mesh is not None:
        t = t[torch.from_numpy(local_rows(len(x), mesh))]
        t = t[:, :, image_rows(x.shape[2], mesh)]
    return t.contiguous(memory_format=torch.channels_last)


def _op(name, c, seed):
    """(module or None, fn(x) -> y) of an op of the checks."""
    from dmayolo_tpu_torch.nn import primitives as P
    from dmayolo_tpu_torch.nn.blocks import CoorAttention, ZeroPad2d

    gen = torch.Generator().manual_seed(seed)
    conv = {"conv_k3s1": (3, 1, None, 1, 1), "conv_k3s2": (3, 2, None, 1, 1),
            "conv_k6s2p2": (6, 2, 2, 1, 1), "conv_dilated": (3, 1, 2, 2, 1),
            "conv_dw7": (7, 1, 3, 1, c)}.get(name)
    if conv is not None:
        k, s, p, d, g = conv
        m = P.Conv2d(c, c, k, s, p, g=g, d=d)
        m.reset_parameters(gen)
        return m, lambda x: m(x, torch.float32)
    if name == "ca_train":
        m = CoorAttention(c, c, reduction=4)
        for mod in m.modules():
            if isinstance(mod, P.Conv2d):
                mod.reset_parameters(gen)
        with torch.no_grad():
            m.bn1.weight.uniform_(0.5, 1.5, generator=gen)
            m.bn1.bias.uniform_(-0.5, 0.5, generator=gen)
        return m.train(), lambda x: m(x, torch.float32)
    if name in ("dropout", "drop_path"):  # the global map's draws, this rank's rows
        m = (P.Dropout(0.3) if name == "dropout" else P.DropPath(0.5)).train()

        def draw(x):
            with P.lend_generator(m, torch.Generator().manual_seed(seed)):
                return m(x)
        return None, draw
    if name == "zero_pad":
        m = ZeroPad2d((1, 2, 2, 1))
        return None, lambda x: m(x, torch.float32)

    def whole(f):  # a function of the whole map, each rank keeping its rows
        def run(x):
            if sp.current() is None:
                return f(x)
            return sp.slice_h(f(sp.gather_h(x)))
        return run

    return None, {
        "max_pool5": lambda x: P.max_pool(x, 5, 1, 2),
        "max_pool3s2": lambda x: P.max_pool(x, 3, 2, 1),
        "avg_pool4": lambda x: P.avg_pool(x, 4),
        "avg_pool2s2": lambda x: P.avg_pool(x, 2, 2),
        "upsample2": lambda x: P.upsample_nearest(x, 2),
        # SCConv's floor: the pooled map resized back to an uneven height
        "resize_nearest": lambda x: P.resize_nearest(P.avg_pool(x, 4), sp.global_hw(x)),
        "bilinear": lambda x: P.bilinear_resize_align_corners(P.avg_pool(x, 2, 2),
                                                              sp.global_hw(x)),
        "space_to_depth": lambda x: P.space_to_depth_2x(P.upsample_nearest(x, 2)),
        "gather_slice": whole(lambda x: torch.cumsum(x, dim=2) * x),
        "global_pools": lambda x: (x * P.global_avg_pool(x) + P.global_max_pool(x)
                                   + P.adaptive_avg_pool_w(x) * x),
    }[name]


def _cotangent(y: torch.Tensor, mesh, b_global: int) -> torch.Tensor:
    """A fixed function of each element's global (b, c, h, w), this rank's
    rows of it: the ranks' losses sum to the one process's."""
    b0 = 0 if mesh is None else int(local_rows(b_global, mesh)[0])
    h0 = 0
    if mesh is not None and sp.current() is not None:
        h0 = sp.row_bounds(sp.global_height(y), mesh.n_spatial)[mesh.spatial_rank][0]
    b, c, h, w = y.shape
    idx = [torch.arange(n, dtype=torch.float64) + o for n, o in ((b, b0), (c, 0), (h, h0),
                                                                  (w, 0))]
    g = (1.3 * idx[0][:, None, None, None] + 0.7 * idx[1][None, :, None, None]
         + 0.37 * idx[2][None, None, :, None] + 0.11 * idx[3][None, None, None, :])
    return torch.sin(g).float()


def ops_case(mesh, n_spatial, x, seed=0, names=OPS):
    """Each op's output rows, input gradient rows, parameter gradients
    and (CA) BN statistics on this rank of the layout."""
    sm = layout(mesh, n_spatial)
    out = {}
    for i, name in enumerate(names):
        mod, fn = _op(name, x.shape[1], seed + i)
        xl = local_map(sm, x).requires_grad_(True)
        with sp.spatial_scope(sm):
            y = fn(xl)
            loss = (y * _cotangent(y, sm, len(x))).sum()
            loss.backward()
        r = {"y": y.detach().numpy(), "dx": xl.grad.numpy()}
        if mod is not None:
            r["grads"] = {k: p.grad.numpy() for k, p in mod.named_parameters()}
            r["buffers"] = {k: b.numpy().copy() for k, b in mod.named_buffers()}
        out[name] = r
    return out


def _model(cfg, state_dict=None):
    from dmayolo_tpu_torch.graph import DetectionModel

    m = DetectionModel(cfg, device="cpu")
    if state_dict is not None:
        m.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()}, strict=True)
    return m.eval()


def infer_case(mesh, n_spatial, cfg, state_dict, images, kw, augment=False, quant=None,
               fused=False):
    """`make_infer_fn(spatial=True)` on this rank's rows of `images`: the
    global detections and `valid`, and the raw head (this data rank's
    rows, gathered along H)."""
    from dmayolo_tpu_torch.eval.validator import make_infer_fn

    sm = layout(mesh, n_spatial)
    model = _model(cfg, state_dict)
    if fused:
        model.fuse()
    x = torch.from_numpy(images) if sm is None else shard_batch(sm, images, spatial=True)
    infer = make_infer_fn(model, mesh=sm, spatial=True, augment=augment, quant=quant,
                          fused=fused, dtype=torch.float32, **kw)
    before = sp.EXCHANGES[0]
    dets, valid = infer(x)
    exchanges = sp.EXCHANGES[0] - before
    with torch.inference_mode(), sp.spatial_scope(sm):
        raw = model.apply(x.float() / 255.0, torch.float32, fused=fused, quant=quant)
    return {"dets": dets.numpy(), "valid": valid.numpy(), "exchanges": exchanges,
            "raw": [r.numpy() for r in raw]}


def validation_case(mesh, n_spatial, cfg, state_dict, val_dir, **kw):
    """`run_validation(spatial=True)` at this rank: its result."""
    from dmayolo_tpu_torch.eval.validator import run_validation

    sm = layout(mesh, n_spatial)
    return run_validation(_model(cfg, state_dict), val_dir, device="cpu", mesh=sm,
                          spatial=True, workers=1, **kw)


def train_step_case(mesh, n_spatial, cfg, state_dict, hyp, images, targets, accumulate,
                    sched_kw, device_aug=None, seed=0, assignment="anchor"):
    """One f32 train step (`make_train_step(spatial=True)`) on this rank's
    data rows and H rows of each global microbatch: the metrics and the
    JAX checkpoint trees of the state after it."""
    from dmayolo_tpu_torch.parallel.mesh import Mesh, replicate_tree
    from dmayolo_tpu_torch.train import optim as po
    from dmayolo_tpu_torch.train import step as ps
    from dmayolo_tpu_torch.train.loss import ComputeLoss, Targets
    from dmayolo_tpu_torch.train.tal import ComputeLossTAL

    sm = layout(mesh, n_spatial) or Mesh()
    pm = _model(cfg, state_dict)
    replicate_tree(sm, pm)
    sched_kw = dict(sched_kw)
    state = ps.init_train_state(pm, po.param_groups(pm), sched_kw.pop("weight_decay"),
                                momentum=hyp["momentum"])
    sched = po.Schedule(hyp, **sched_kw)
    loss = (ComputeLoss(pm.head.anchors, hyp, nc=cfg["nc"]) if assignment == "anchor"
            else ComputeLossTAL(pm.stride, nc=cfg["nc"], hyp=hyp))
    step = ps.make_train_step(loss, sched, dtype=torch.float32, accumulate=accumulate,
                              device_aug=device_aug, mesh=sm, spatial=True)
    imgs = shard_batch(sm, images, accumulate, spatial=True)
    tg = shard_batch(sm, Targets(*targets), accumulate)
    metrics = step(state, imgs, tg, torch.Generator().manual_seed(seed))
    return {k: float(v) for k, v in metrics.items()}, ps.state_trees(state)


def trainer_case(mesh, n_spatial, cfg, state_dict, hyp, batches, out_dir):
    """`Trainer(mesh=..., spatial=True)` over an in-memory epoch of global
    batches (accumulate 2, EMA on; each rank takes its data rows, then its
    H rows): the JAX checkpoint trees of its state and the steps taken."""
    from pathlib import Path

    from dmayolo_tpu_torch.parallel.mesh import Mesh
    from dmayolo_tpu_torch.train.loss import Targets
    from dmayolo_tpu_torch.train.step import state_trees
    from dmayolo_tpu_torch.train.trainer import Batch, Trainer

    sm = layout(mesh, n_spatial)
    rank = 0 if sm is None else sm.rank
    loader = [Batch(im, Targets(*tg)) for im, tg in batches]
    tr = Trainer(cfg, loader, dict(hyp), nc=cfg["nc"], epochs=1,
                 batch_size=len(loader[0].images), img_size=batches[0][0].shape[1],
                 accumulate=2, out_dir=str(Path(out_dir) / f"rank{rank}"), dtype=torch.float32,
                 seed=0, device="cpu", mesh=sm or Mesh(), spatial=sm is not None,
                 accum_ramp=False)
    tr.model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    tr.state.ema.load_state_dict(tr.model.state_dict())
    tr.train()
    return {"trees": state_trees(tr.state), "step": tr.state.step}


def spread(model, seed: int):
    """Weights and statistics drawn as the JAX tests' `random_vars` draws
    them, so that activations keep their scale through the depth: conv and
    linear kernels N(0, 1 / fan_in), norm scales and running variances
    U(0.5, 1.5), running means N(0, 0.2), the other vectors (biases, layer
    scales, fusion weights) N(0, 0.5).  Returns the model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if not v.is_floating_point():
                continue
            if k.endswith("running_var") or (k.endswith("weight") and v.dim() == 1):
                t = torch.empty(v.shape).uniform_(0.5, 1.5, generator=g)
            elif k.endswith("running_mean"):
                t = torch.randn(v.shape, generator=g) * 0.2
            elif v.dim() >= 2:
                t = torch.randn(v.shape, generator=g) * v[0].numel() ** -0.5
            else:
                t = torch.randn(v.shape, generator=g) * 0.5
            v.copy_(t)
    return model


def zoo_case(mesh, n_spatial, models):
    """The raw head of each (cfg, images) of `models` ({name: ...}) with
    `spread` weights, f32, gathered along H."""
    sm = layout(mesh, n_spatial)
    out = {}
    for i, (name, (cfg, images)) in enumerate(models.items()):
        model = spread(_model(cfg), i)
        x = torch.from_numpy(images) if sm is None else shard_batch(sm, images, spatial=True)
        with torch.inference_mode(), sp.spatial_scope(sm):
            raw = model(x.float() / 255.0, torch.float32)
        out[name] = [r.numpy() for r in raw] if isinstance(raw, list) else raw.numpy()
    return out


def rank_checks(mesh, n_spatial, cases):
    """Every case of `cases` ({name: (function name, kwargs)}) in turn, in
    one launch: {name: result}."""
    return {name: globals()[fn](mesh, n_spatial, **kw) for name, (fn, kw) in cases.items()}


def one_process(cases):
    """The same cases on one process: the references."""
    return {name: globals()[fn](None, 1, **kw) for name, (fn, kw) in cases.items()}
