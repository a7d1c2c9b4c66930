"""Data parallelism: one process a device, each rank on its rows of every
global batch, results equal to one process on the whole batch.

Port of `dmayolo_tpu/parallel/mesh.py`.  Under `jit` on a JAX mesh the
train step is one step over the global batch: BN takes its moments over
the global batch, the losses divide by global counts, and XLA inserts the
gradient all-reduce.  Here each of those is explicit, and none is
`DistributedDataParallel` (whose per-rank losses and averaged gradients
are the mean of per-rank means, not the global step):

  * `BatchNorm2d` (train mode) all-reduces its channel sums and count in
    the forward and its two channel sums in the backward;
  * `ComputeLoss` / `ComputeLossTAL` take their denominators and the batch
    size over the group, so each rank's total is its share: the shares
    sum to the global loss, and their gradients to the global gradient;
  * the train step SUM all-reduces the gradients in a few flat buckets,
    and its metrics;
  * Dropout, DropPath and `device_aug` draw the global batch's numbers and
    take this rank's rows.

The train step lends the group to the model's BNs, Dropouts and DropPaths
(`nn.primitives.lend_mesh`) and passes it to the loss.  Only `all_reduce`, `broadcast` and `barrier` are used,
so one code path serves NCCL and gloo.  A `Mesh` without a group (world
1, `make_mesh()` outside a launch) runs none of it: the plain path.

The JAX mesh's second axis, `spatial`, splits each image's rows (H) over
`n_spatial` ranks: `make_mesh(n_data, n_spatial)` on a group of
n_data x n_spatial ranks, the spatial rank varying fastest (rank = d x
n_spatial + s, the order of JAX's `reshape(n_data, n_spatial)`).  The
ranks of one spatial group hold the same images; `data` is the mesh of
the data axis (its rows, its loader stripe, its loss normalisers), and
`parallel/spatial.py` holds the row partition and its collectives.

Two launches:

  * `torchrun` (`python -m torch.distributed.run --nproc-per-node N`, the
    reference's own DDP launch): `join_torchrun()` joins its group, rank
    r on `cuda:LOCAL_RANK`;
  * `spawn(fn, world)`: W processes on a `FileStore`, NCCL on CUDA (rank r
    on `cuda:r`), gloo on the CPU, gloo with every rank on `cuda:0` only
    when the caller asks (`share_device=True`; NCCL refuses two ranks on
    one device).

Every collective has a timeout (`COLLECTIVE_TIMEOUT_S`): a rank that dies
or hangs fails the run, the counterpart of the rendezvous timeouts that
`dmayolo_tpu/cpu_mesh_flags.py` sets for XLA.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .spatial import row_bounds

COLLECTIVE_TIMEOUT_S = 120.0
GRAD_BUCKET_BYTES = 128 << 20  # the gradient all-reduce's flat buckets

# the device `init_group` gave this process, beside torch.distributed's own
# process-wide group
_GROUP_DEVICE: Optional[torch.device] = None
# the (data, spatial) subgroups of the group, by (n_data, n_spatial): made
# once, on every rank in one order, as `dist.new_group` requires
_SUBGROUPS: dict = {}


@dataclass
class Mesh:
    """This rank's view of a group: rank, world size, device, and the
    process group (None: no group, world 1, and no collective is ever
    issued).  With `n_spatial` > 1 the group is n_data x n_spatial ranks:
    `spatial_group` holds the ranks that split one image's rows,
    `data_group` those of the same spatial rank."""

    rank: int = 0
    world: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: Any = None
    backend: Optional[str] = None
    n_spatial: int = 1
    spatial_group: Any = None
    data_group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def n_data(self) -> int:
        return self.world // self.n_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.n_spatial

    @property
    def spatial(self) -> bool:
        """True where the images' rows are split over ranks."""
        return self.n_spatial > 1 and self.spatial_group is not None

    @property
    def data(self) -> "Mesh":
        """The data axis: this rank's data rank among n_data, over the
        data subgroup (no group where n_data is 1); the mesh itself when
        nothing is split."""
        if self.n_spatial == 1:
            return self
        return Mesh(self.data_rank, self.n_data, self.device,
                    self.data_group if self.n_data > 1 else None, self.backend)

    def wire_device(self) -> torch.device:
        """Where a small host-side collective's tensor lives: the device
        under NCCL, the CPU under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the group, in place; `t` itself."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src` (of this mesh) to every rank, in place."""
        if self.group is not None:
            if self.group is not dist.group.WORLD:
                src = dist.get_global_rank(self.group, src)
            dist.broadcast(t, src, group=self.group)
        return t

    def barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)

    def broadcast_object(self, obj, src: int = 0):
        """A picklable object from rank `src` on every rank, as two tensor
        broadcasts (its length, then its bytes)."""
        if self.group is None:
            return obj
        dev = self.wire_device()
        data = pickle.dumps(obj) if self.rank == src else b""
        n = self.broadcast(torch.tensor([len(data)], dtype=torch.int64, device=dev), src)
        buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
        if self.rank == src:
            buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        self.broadcast(buf, src)
        return pickle.loads(buf.cpu().numpy().tobytes())


def _default_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if _GROUP_DEVICE is not None:
        return _GROUP_DEVICE
    from ..utils.device import resolve_device

    return resolve_device(None)


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1, device=None) -> Mesh:
    """This rank's view of the group that exists: world 1 (no group) when
    there is none.  n_data x n_spatial must be the group's size (`n_data`
    None: the group's size over `n_spatial`); with `n_spatial` > 1 the
    spatial and data subgroups are made (once a layout, on every rank).
    `device`, when given, wins over the one the launch chose (None and no
    group: CUDA)."""
    if n_spatial < 1:
        raise ValueError(f"n_spatial={n_spatial}")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        world, rank, group, backend = 1, 0, None, None
    want = None if n_data is None and n_spatial == 1 else (
        (world // n_spatial if n_data is None else n_data) * n_spatial)
    if want is not None and (want != world or world % n_spatial):
        raise ValueError(f"n_data={n_data} x n_spatial={n_spatial} but the group has {world} "
                         "rank(s): launch that many with torchrun or parallel.mesh.spawn")
    mesh = Mesh(rank, world, _default_device(device), group, backend)
    if n_spatial > 1:
        mesh.n_spatial = n_spatial
        mesh.spatial_group, mesh.data_group = _subgroups(world // n_spatial, n_spatial, rank)
    return mesh


def _subgroups(n_data: int, n_spatial: int, rank: int):
    """This rank's spatial and data subgroups of the (n_data, n_spatial)
    layout, made on first use: every rank creates every subgroup, in the
    same order, each with the collective timeout."""
    key = (n_data, n_spatial)
    if key not in _SUBGROUPS:
        timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
        spatial = [dist.new_group([d * n_spatial + s for s in range(n_spatial)], timeout=timeout)
                   for d in range(n_data)]
        data = [dist.new_group([d * n_spatial + s for d in range(n_data)], timeout=timeout)
                for s in range(n_spatial)]
        _SUBGROUPS[key] = (spatial, data)
    spatial, data = _SUBGROUPS[key]
    return spatial[rank // n_spatial], data[rank % n_spatial]


def init_group(rank: int, world: int, backend: Optional[str] = None, device=None,
               store_path: Optional[str] = None,
               timeout: float = COLLECTIVE_TIMEOUT_S) -> Mesh:
    """Join a group of `world` ranks as `rank` on `device` (None: CUDA),
    over `backend` (None: NCCL on CUDA, gloo on the CPU), on a `FileStore`
    at `store_path`, or on the `env://` variables of torchrun where None.
    Every collective of the group times out after `timeout` seconds."""
    global _GROUP_DEVICE
    dev = _default_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout))
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world)
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(**kw)
    _GROUP_DEVICE = dev
    return make_mesh()


def close_group():
    """Leave the group `init_group` joined (no-op without one)."""
    global _GROUP_DEVICE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _GROUP_DEVICE = None
    _SUBGROUPS.clear()


def under_torchrun() -> bool:
    """True inside a process that torchrun started."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ and "LOCAL_RANK" in os.environ


def join_torchrun(device=None, backend: Optional[str] = None) -> Mesh:
    """Join the group torchrun made: rank r on `cuda:LOCAL_RANK` (or on
    the CPU over gloo when `device` is "cpu")."""
    if not under_torchrun():
        raise RuntimeError("not launched by torchrun (RANK, WORLD_SIZE, LOCAL_RANK unset)")
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device(device) if device is not None else torch.device("cuda", local)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local)
    return init_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), backend, dev)


def with_group(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """`mesh` where it has a group, else None: the layers that reduce over
    the batch take None for the plain path."""
    return mesh if mesh is not None and mesh.distributed else None


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def local_rows(n: int, mesh: Mesh, accumulate: int = 1) -> np.ndarray:
    """The rows of a global batch of `n` that `mesh`'s data rank holds: of
    each of the `accumulate` microbatches, its contiguous block (the ranks
    of one spatial group hold the same rows)."""
    world, rank = mesh.n_data, mesh.data_rank
    if n % (accumulate * world):
        raise ValueError(f"batch {n} does not split into {accumulate} microbatches over "
                         f"{world} ranks")
    mb = n // accumulate
    per = mb // world
    return (np.arange(accumulate)[:, None] * mb + rank * per + np.arange(per)).ravel()


def image_rows(h: int, mesh: Mesh) -> slice:
    """This rank's rows of an image of height `h` (`parallel/spatial.py`'s
    partition; all of them where nothing is split)."""
    if not mesh.spatial:
        return slice(0, h)
    a, b = row_bounds(h, mesh.n_spatial)[mesh.spatial_rank]
    return slice(a, b)


def _tree_map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(fn(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(fn(t) for t in tree)
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _image_part(x: torch.Tensor, mesh: Mesh, spatial: bool) -> torch.Tensor:
    """This rank's H rows (dim 1) of an image batch (B, H, W, C) where
    `spatial` and the mesh splits rows; any other array as it is."""
    if spatial and mesh.spatial and x.dim() == 4:
        return x[:, image_rows(x.shape[1], mesh)]
    return x


def shard_batch(mesh: Mesh, batch, accumulate: int = 1, spatial: bool = False):
    """This rank's rows (`local_rows`) of a global batch, or of each array
    of a tuple, namedtuple or dict of them, as tensors on `mesh.device`.
    With `spatial` (JAX's `P("data", "spatial")`), an image batch (a 4-D
    array, (B, H, W, C)) also keeps only this rank's H rows; targets keep
    their images' rows whole."""

    def take(x):
        x = torch.as_tensor(np.asarray(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
        idx = torch.from_numpy(local_rows(x.shape[0], mesh, accumulate))
        return _image_part(x[idx], mesh, spatial).to(mesh.device)

    return _tree_map(take, batch)


def globalize_batch(mesh: Mesh, local_batch, spatial: bool = False):
    """The global batch from this process's rows: in torch the global
    batch is the ranks' blocks together and no rank materialises it, so
    the local rows are kept, on `mesh.device`; with `spatial`, of an image
    batch (B, H, W, C) only this rank's H rows."""
    x = torch.as_tensor(np.asarray(local_batch))
    return _image_part(x, mesh, spatial).to(mesh.device)


def globalize_targets(mesh: Mesh, local_tree):
    """`globalize_batch` for a tuple, namedtuple or dict of target arrays."""
    return _tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(mesh.device), local_tree)


def gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The global tensor on every rank from each data rank's equal block
    of rows: a SUM all-reduce of a zero-filled buffer in which each rank
    writes its own rows (exact: every other term is 0), over the data
    subgroup (the ranks of one spatial group hold the same rows)."""
    mesh = mesh.data
    if not mesh.distributed:
        return local
    dtype = local.dtype
    wire = torch.uint8 if dtype == torch.bool else (
        torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype)
    n = local.shape[0]
    buf = torch.zeros((n * mesh.world,) + tuple(local.shape[1:]), dtype=wire,
                      device=local.device)
    buf[mesh.rank * n:(mesh.rank + 1) * n] = local.to(wire)
    mesh.all_reduce(buf)
    return buf.to(dtype)


def replicate_tree(mesh: Mesh, tree):
    """Rank 0's parameters and buffers (a module's state_dict) or tensors
    (a dict or list of them) on every rank, in place: one broadcast a
    dtype, flattened."""
    if not mesh.distributed:
        return tree
    tensors = (list(tree.state_dict().values()) if isinstance(tree, torch.nn.Module)
               else list(tree.values()) if isinstance(tree, dict) else list(tree))
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            mesh.broadcast(flat)
            _unflatten_into(flat, ts)
    return tree


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]):
    """Copy the consecutive pieces of `flat` back into `tensors`, in one
    multi-tensor copy."""
    pieces = torch.split(flat, [t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors), [p.view_as(t) for p, t in zip(pieces, tensors)])


def all_reduce_flat(mesh: Mesh, tensors: Sequence[torch.Tensor],
                    bucket_bytes: int = GRAD_BUCKET_BYTES):
    """SUM all-reduce `tensors` in place, flattened into buckets of at most
    `bucket_bytes` (a tensor larger than that is a bucket of its own)."""
    if not mesh.distributed or not tensors:
        return
    buckets, cur, size = [], [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if cur and (size + nb > bucket_bytes or t.dtype != cur[0].dtype):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nb
    if cur:
        buckets.append(cur)
    with torch.no_grad():
        for ts in buckets:
            flat = torch.cat([t.reshape(-1) for t in ts])
            mesh.all_reduce(flat)
            _unflatten_into(flat, ts)


def process_shard_indices(n: int, process_index: Optional[int] = None,
                          process_count: Optional[int] = None,
                          mesh: Optional[Mesh] = None) -> np.ndarray:
    """This rank's sample indices: the rank::world stripe over the dataset
    (the reference's DistributedSampler convention), by data rank: the
    ranks of one spatial group of `mesh` (default `make_mesh()`) take the
    same stripe."""
    if process_index is None or process_count is None:
        m = mesh if mesh is not None else make_mesh(device="cpu")
        process_index = m.data_rank if process_index is None else process_index
        process_count = m.n_data if process_count is None else process_count
    return np.arange(process_index, n, process_count)


# ---------------------------------------------------------------------------
# the spawn launcher
# ---------------------------------------------------------------------------

class RankFailed(RuntimeError):
    """A rank of `spawn` raised or died."""


def rank_devices(world: int, device="cuda", share_device: bool = False) -> List[torch.device]:
    """The device of each rank: `cuda:r` (every rank on `cuda:0` with
    `share_device`), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * world
    if share_device:
        return [torch.device("cuda", dev.index or 0)] * world
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    if world > n:
        raise RuntimeError(f"{world} ranks need {world} visible GPUs, found {n}")
    return [torch.device("cuda", r) for r in range(world)]


def _rank_main(fn, args, rank, world, backend, device, store_path, timeout, threads, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = init_group(rank, world, backend, device, store_path, timeout)
        # by value: torch's queue reducers would share tensors through file
        # descriptors that close with this process
        out = pickle.dumps(fn(mesh, *args))
        results.put(("ok", rank, out))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise SystemExit(1)
    close_group()


def spawn(fn: Callable, world: int, args: Sequence = (), device="cuda",
          backend: Optional[str] = None, share_device: bool = False,
          timeout: float = COLLECTIVE_TIMEOUT_S, threads: Optional[int] = None) -> list:
    """Run `fn(mesh, *args)` on `world` new processes (start
    method "spawn"), one a rank, joined on a `FileStore`; returns each
    rank's return value, by rank.  `fn` and its arguments must pickle.

    device: "cuda" (rank r on `cuda:r`; `share_device` puts every rank on
    `cuda:0`, which needs `backend="gloo"`) or "cpu"; backend: None means
    NCCL on CUDA and gloo on the CPU.  `threads`: torch's thread count in
    each rank.  A rank that raises or dies makes this raise `RankFailed`
    (with its traceback) as soon as the parent sees it, and the other ranks
    are stopped; a rank that hangs in a collective fails the others after
    `timeout` seconds."""
    import multiprocessing as mp

    devs = rank_devices(world, device, share_device)
    backend = backend or ("nccl" if devs[0].type == "cuda" else "gloo")
    if backend == "nccl" and len(set(devs)) < world:
        raise ValueError("NCCL refuses two ranks on one GPU: pass backend='gloo' to share it")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dmayolo_dist_")
    store = os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, tuple(args), r, world, backend, str(devs[r]), store,
                               timeout, threads, results))
             for r in range(world)]
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                kind, rank, value = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    time.sleep(0.5)  # a dying rank's message may still be in flight
                    try:
                        kind, rank, value = results.get(timeout=0.5)
                    except queue_mod.Empty:
                        raise RankFailed(f"rank {dead[0]} died (exit code "
                                         f"{procs[dead[0]].exitcode}) without a result")
                else:
                    continue
            if kind == "error":
                raise RankFailed(f"rank {rank} of {world} raised:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
