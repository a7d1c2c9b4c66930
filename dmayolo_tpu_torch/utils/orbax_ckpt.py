"""The JAX package's Orbax checkpoints, read and written without orbax.

Port of `dmayolo_tpu/utils/orbax_ckpt.py`.  With `--ckpt-async` the JAX
`Trainer` saves `best`, `last` and `epoch{N}` as `<name>_orbax/`
directories (Orbax's `StandardCheckpointHandler`, on every host of a pod
at once), each with `<name>_orbax.meta.json` beside it.  A directory
holds:

- `_METADATA` (JSON): for each leaf its key path (`key_metadata`: the
  keys, each a dict key or a sequence index) and its shape;
- `_CHECKPOINT_METADATA` and `array_metadatas/process_<N>` (JSON);
- an OCDBT store (`utils/ocdbt.py`) of zarr v2 arrays, one a leaf, named
  by the leaf's keys joined with ".": `<name>/.zarray` (dtype, shape,
  chunks, fill value, compressor) and one key a chunk, `<name>/<i.j...>`
  (`<name>/0` for a scalar), zstd-compressed (`utils/zstd.py`).  A leaf
  that was sharded over devices is chunked by shard.

Trees are nested dicts (and lists) of tensors or numpy arrays.  The
`Trainer`'s are `{tree name: {JAX path tuple: leaf}}`; a tuple dict key
is stored as `str(tuple)`, as JAX's key path prints it, and read back
through `ast.literal_eval`, since the keys hold dots.

`restore` reads any such directory; `save` and `AsyncTrainCheckpointer`
write one leaf a chunk, as a one-device save does, which the JAX
package's `restore` reads.  The port's `Trainer(ckpt_async=True)` and
`cli.train --ckpt-async` still write the `.npz` (`utils/async_ckpt.py`),
on purpose: both packages' `--resume` read that file, and neither
package's CLI resumes from an Orbax directory.  `utils/weights.py::
load_jax_checkpoint` takes an Orbax directory too.
"""
from __future__ import annotations

import ast
import itertools
import json
import math
import os
import shutil
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import zstd
from .async_ckpt import BackgroundWriter
from .device import resolve_device
from .ocdbt import OcdbtStore, write_store

# zarr v2 dtype -> (numpy dtype of the stored bytes, torch dtype); numpy
# has no bfloat16, so its bits travel as int16
_DTYPES = {"<f4": (np.float32, torch.float32), "<f2": (np.float16, torch.float16),
           "<i4": (np.int32, torch.int32), "<i8": (np.int64, torch.int64),
           "|u1": (np.uint8, torch.uint8), "|b1": (np.bool_, torch.bool),
           "bfloat16": (np.int16, torch.bfloat16)}
_ZARR_OF = {t: z for z, (_, t) in _DTYPES.items()}
_SEQUENCE, _DICT = 1, 2  # key_type in `_METADATA`
ZSTD_LEVEL = 1  # Orbax's
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def _workers() -> int:
    return min(8, os.cpu_count() or 1)


def meta_path(path) -> Path:
    path = Path(path)
    return path.parent / (path.name + ".meta.json")


# ---------------------------------------------------------------- keys


def _tree_key(km: dict):
    """A `_METADATA` key entry -> the tree's key: a sequence index, a
    tuple where the dict key was one, else the string."""
    key, kind = km["key"], km["key_type"]
    if kind == _SEQUENCE:
        return int(key)
    if kind != _DICT:
        raise ValueError(f"key {key!r}: key_type {kind}")
    if key.startswith("(") and key.endswith(")"):
        value = ast.literal_eval(key)
        if isinstance(value, tuple):
            return value
    return key


def _flatten(tree, keys=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) of a nested dict/list/tuple tree, dict keys sorted as
    JAX flattens them; a path is ((key, key_type), ...)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], keys + ((k, _DICT),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, keys + ((i, _SEQUENCE),))]
    return [(keys, tree)]


def _name(path) -> str:
    return ".".join(str(k) for k, _ in path)


def _insert(tree: dict, path, value) -> None:
    node = tree
    for k, _ in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1][0]] = value


def _build(entries: List[Tuple[tuple, Any]]):
    """The nested tree of (path, leaf) pairs; sequence levels as lists."""
    root: dict = {}
    seq = set()
    for path, value in entries:
        _insert(root, path, value)
        for i, (_, kind) in enumerate(path):
            if kind == _SEQUENCE:
                seq.add(tuple(k for k, _ in path[:i]))

    def fix(node, at):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v, at + (k,)) for k, v in node.items()}
        return [out[i] for i in range(len(out))] if at in seq else out

    return fix(root, ())


# ---------------------------------------------------------------- zarr v2


def _fill(value, zdtype: str, npdtype) -> np.ndarray:
    if isinstance(value, str):
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    if zdtype == "bfloat16":
        return torch.tensor(value, dtype=torch.bfloat16).view(torch.int16).numpy()
    return np.asarray(value, npdtype)


def read_zarr(store: OcdbtStore, name: str) -> Tuple[np.ndarray, str]:
    """The zarr v2 array `name` of `store` as one C-order numpy array
    (bfloat16 as its int16 bits) and its zarr dtype.  A missing chunk
    takes the fill value, and raises where that is null."""
    za = json.loads(store.read(f"{name}/.zarray".encode()))
    if za.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {za.get('zarr_format')}, not 2")
    zd = za["dtype"]
    if zd not in _DTYPES:
        raise ValueError(f"{name}: dtype {zd!r} (read: {sorted(_DTYPES)})")
    comp = za.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp}; zstd and none are read")
    if za.get("filters"):
        raise ValueError(f"{name}: filters {za['filters']} are not read")
    if za.get("order", "C") != "C":
        raise ValueError(f"{name}: order {za['order']!r}; C order is read")
    npd = np.dtype(_DTYPES[zd][0])
    shape, chunks = tuple(za["shape"]), tuple(za["chunks"])
    sep = za.get("dimension_separator", ".")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    out = np.empty(shape, npd)
    whole = chunks == shape
    for idx in itertools.product(*(range(g) for g in grid)):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        try:
            raw = store.read(key.encode())
        except KeyError:
            if za.get("fill_value") is None:
                raise ValueError(f"{name}: chunk {key!r} is missing and the fill value is null") from None
            out[region] = _fill(za["fill_value"], zd, npd)
            continue
        buf = out if whole else np.empty(chunks, npd)
        if comp is None:
            if len(raw) != buf.nbytes:
                raise ValueError(f"{key}: {len(raw)} bytes, the chunk has {buf.nbytes}")
            buf.reshape(-1).view(np.uint8)[:] = np.frombuffer(raw, np.uint8)
        else:
            zstd.decompress_into(raw, buf.reshape(-1).view(np.uint8))
        if not whole:
            out[region] = buf[tuple(slice(0, r.stop - r.start) for r in region)]
    return out, zd


def _zarray(shape, zdtype: str) -> bytes:
    return json.dumps({"chunks": list(shape), "compressor": {"id": "zstd", "level": ZSTD_LEVEL},
                       "dimension_separator": ".", "dtype": zdtype, "fill_value": None,
                       "filters": None, "order": "C", "shape": list(shape), "zarr_format": 2},
                      separators=(",", ":")).encode()


# ---------------------------------------------------------------- restore


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def restore(path, like=None, device=None) -> Tuple[Dict, Dict]:
    """Read the checkpoint directory `path` -> (tree, meta).

    Leaves are tensors on `device` (None: CUDA, which must exist; pass
    "cpu" for the CPU).  `like`, where given, is a tree of the same keys
    whose leaves (tensors, arrays, anything with `shape` and `dtype`) fix
    each leaf's shape, which must match, and its dtype, which the leaf is
    cast to, as Orbax's `StandardRestore` does.  `meta` is the JSON of
    `<path>.meta.json`, `{}` where there is none."""
    dev = resolve_device(device)
    path = Path(path)
    md_path = path / "_METADATA"
    if not md_path.is_file():
        raise FileNotFoundError(f"{path}: no _METADATA (not an Orbax checkpoint, or a save that did not finish)")
    md = json.loads(md_path.read_text())
    if not md.get("use_ocdbt", False) or md.get("use_zarr3", False):
        raise ValueError(f"{path}: use_ocdbt={md.get('use_ocdbt')}, use_zarr3={md.get('use_zarr3')};"
                         " only OCDBT with zarr v2 is read")
    store = OcdbtStore(path)
    leaves = []
    for entry in md["tree_metadata"].values():
        kms = entry["key_metadata"]
        leaves.append((tuple((_tree_key(km), km["key_type"]) for km in kms),
                       ".".join(km["key"] for km in kms)))
    want = None
    if like is not None:
        want = {tuple(k for k, _ in p): leaf for p, leaf in _flatten(like)}
        have = {tuple(k for k, _ in p) for p, _ in leaves}
        odd = sorted(set(want) ^ have, key=str)
        if odd:
            raise ValueError(f"{path}: key {odd[0]} is in "
                             f"{'like' if odd[0] in want else 'the checkpoint'} only")

    def load(item):
        p, name = item
        arr, zd = read_zarr(store, name)
        t = torch.from_numpy(arr)
        if zd == "bfloat16":
            t = t.view(torch.bfloat16)
        if want is not None:
            ref = want[tuple(k for k, _ in p)]
            if tuple(ref.shape) != tuple(t.shape):
                raise ValueError(f"{path}: {name} has shape {tuple(t.shape)}, like asks {tuple(ref.shape)}")
            t = t.to(_torch_dtype(ref.dtype))
        return p, t.to(dev)

    with ThreadPoolExecutor(_workers()) as pool:
        tree = _build(list(pool.map(load, leaves)))
    mp = meta_path(path)
    meta = json.loads(mp.read_text()) if mp.exists() else {}
    return tree, meta


# ---------------------------------------------------------------- save


def _host(leaf, copy: bool) -> np.ndarray:
    """A leaf as a C-order host array (bfloat16 as int16 bits); a copy
    of a tensor where `copy`, so that later changes to it do not reach
    the write."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.to("cpu", copy=copy).contiguous().numpy()
    a = np.asarray(leaf)
    return a if a.flags.c_contiguous else a.copy(order="C")


def _zarr_dtype(leaf, name: str) -> str:
    if isinstance(leaf, torch.Tensor):
        dt = leaf.dtype
    else:
        dt = _torch_dtype(np.asarray(leaf).dtype)
    if dt not in _ZARR_OF:
        raise ValueError(f"{name}: dtype {dt} is not written (written: {sorted(map(str, _ZARR_OF))})")
    return _ZARR_OF[dt]


def _pull(tree, copy: bool) -> List[Tuple[tuple, str, np.ndarray]]:
    """(path, zarr dtype, host array) of every leaf."""
    out = []
    for p, leaf in _flatten(tree):
        name = _name(p)
        zd = _zarr_dtype(leaf, name)
        arr = _host(leaf, copy)
        if arr.size == 0:
            raise ValueError(f"{name}: a zero-size array cannot be saved")
        out.append((p, zd, arr))
    if not out:
        raise ValueError("nothing to save: the tree has no leaves")
    return out


def _write(path: Path, leaves, meta: Optional[Dict]) -> int:
    """Write the directory under a temporary name beside `path`, then put
    it in the place of whatever was at `path`; then the meta."""
    t0 = time.time_ns()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp-{uuid.uuid4().hex}"
    tmp.mkdir()
    try:
        def chunk(item):
            p, zd, arr = item
            key = f"{_name(p)}/{'.'.join('0' * arr.ndim) if arr.ndim else '0'}"
            return key.encode(), zstd.compress(arr.reshape(-1).view(np.uint8), ZSTD_LEVEL)

        def items(pool):
            for p, zd, arr in leaves:
                yield f"{_name(p)}/.zarray".encode(), _zarray(arr.shape, zd)
            yield from pool.map(chunk, leaves)

        with ThreadPoolExecutor(_workers()) as pool:
            nbytes = write_store(tmp, items(pool))
        tree_md = {str(tuple(str(k) for k, _ in p)): {
            "key_metadata": [{"key": str(k), "key_type": kind} for k, kind in p],
            "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False,
                               "write_shape": list(arr.shape)}} for p, _, arr in leaves}
        docs = {
            "_METADATA": {"tree_metadata": tree_md, "use_ocdbt": True, "use_zarr3": False,
                          "store_array_data_equal_to_fill_value": True, "custom_metadata": None},
            "array_metadatas/process_0": {"array_metadatas": [
                {"array_metadata": {"param_name": _name(p), "write_shape": list(arr.shape),
                                    "chunk_shape": list(arr.shape), "ext_metadata": None}}
                for p, _, arr in leaves]},
            "_CHECKPOINT_METADATA": {"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                                     "init_timestamp_nsecs": t0,
                                     "commit_timestamp_nsecs": time.time_ns(),
                                     "custom_metadata": {}}}
        for rel, doc in docs.items():
            (tmp / rel).parent.mkdir(parents=True, exist_ok=True)
            data = json.dumps(doc).encode()
            (tmp / rel).write_bytes(data)
            nbytes += len(data)
        old = None
        if path.exists():
            old = path.parent / f".{path.name}.old-{uuid.uuid4().hex}"
            os.rename(path, old)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old)
    if meta is not None:
        mp = meta_path(path)
        mtmp = mp.with_name(mp.name + ".tmp")
        mtmp.write_text(json.dumps(meta))
        os.replace(mtmp, mp)
    return nbytes


def save(path, tree, meta: Optional[Dict] = None) -> int:
    """Write `tree` (nested dicts/lists of tensors or arrays, on any
    device) as the Orbax checkpoint directory `path`, replacing one that
    is there, and `meta` (JSON-serialisable) as `<path>.meta.json`.
    Returns the bytes of the directory's files."""
    return _write(Path(path), _pull(tree, copy=False), meta)


class AsyncTrainCheckpointer(BackgroundWriter):
    """`save` copies the tree's tensors to the host, then writes on a
    background thread; `wait` blocks until it is on disk, `close` at
    teardown.  At most one write is in flight: `save` waits for the
    previous one.  Numpy leaves are handed over, not copied: nothing may
    write to them afterwards, as `train/step.py::state_trees` gives
    them.  `last_bytes` is the size of the last write."""

    last_bytes = 0

    def save(self, path, tree: Dict, meta: Optional[Dict] = None) -> None:
        self.wait()
        leaves = _pull(tree, copy=True)

        def write():
            self.last_bytes = _write(Path(path), leaves, meta)

        self._start(write)
