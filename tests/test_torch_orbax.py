"""The port's Orbax checkpoints (`utils/orbax_ckpt.py`, `utils/ocdbt.py`,
`utils/zstd.py`) against the JAX package's `utils/orbax_ckpt.py` and
the libraries it stands on, which are test-only here: orbax, tensorstore
(whose own OCDBT code is the oracle for the store) and `zstandard`.

Every comparison of arrays is to the last bit.  The served detections of
the bridge use `tests/test_torch_model.py`'s tolerances: boxes within
1e-3 px, scores within 1e-5, the same classes.

The committed fixture `tests/fixtures/orbax_jax_tiny/` (read on the card
by `chip_smoke.py` as well) is regenerated by running this file:
`JAX_PLATFORMS=cpu python tests/test_torch_orbax.py`.
"""
import json
import os
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from dmayolo_tpu.cpu_mesh_flags import apply_cpu_mesh_flags  # noqa: E402

apply_cpu_mesh_flags(n_devices=8)  # as conftest.py; for a run of this file alone

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import tensorstore as ts  # noqa: E402
import torch  # noqa: E402
import zstandard  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from dmayolo_tpu.utils import orbax_ckpt as jax_orbax  # noqa: E402
from dmayolo_tpu.utils.checkpoint import save_checkpoint as jax_save_npz  # noqa: E402
from dmayolo_tpu_torch.utils import ocdbt, orbax_ckpt, zstd  # noqa: E402
from dmayolo_tpu_torch.utils.weights import load_jax_checkpoint  # noqa: E402

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "orbax_jax_tiny"
TREES = ("params", "stats", "ema_params", "ema_stats", "opt_mom", "opt_vel")


def _mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(8), ("data",))


def _bits(a) -> np.ndarray:
    """An array's bytes as seen by either package (bf16 through int16)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def assert_same_leaf(want, got, where=""):
    w, g = _bits(want), _bits(got)
    assert w.shape == g.shape and w.dtype == g.dtype, (where, w.shape, g.shape, w.dtype, g.dtype)
    assert w.tobytes() == g.tobytes(), where


def _jax_leaves(tree):
    """A JAX tree's leaves by zarr name (keys joined with ".")."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree):
    return {orbax_ckpt._name(p): leaf for p, leaf in orbax_ckpt._flatten(tree)}


def assert_same_tree(want, got):
    """`want` a JAX tree, `got` the port's: the same leaves under the same
    names, bit for bit."""
    w, g = _jax_leaves(want), _port_leaves(got)
    assert sorted(w) == sorted(g)
    for k in w:
        assert_same_leaf(w[k], g[k], k)


def _jax_save(path, tree, meta=None):
    ck = jax_orbax.AsyncTrainCheckpointer()
    ck.save(path, tree, meta=meta)
    ck.close()


def _shard(x, mesh):
    """Split a leaf over the 8 devices where an axis divides by 8 (the
    first such from the last), else replicate it."""
    spec = [None] * x.ndim
    for ax in reversed(range(x.ndim)):
        if x.shape[ax] % 8 == 0:
            spec[ax] = "data"
            break
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def _tiny_cfg(width=0.0625):
    from test_e2e_train import TINY_CFG

    return dict(TINY_CFG, width_multiple=width)


def trainer_trees(seed=0, width=0.0625):
    """Six trees keyed by JAX path tuples from TINY_CFG's parameters (at
    `width`), as the JAX Trainer's state holds them, with values that are
    multiples of 1/16 in [-8, 8) (exact in f32; zstd finds them
    compressible, which keeps the committed fixture small)."""
    from dmayolo_tpu.graph import DetectionModel as JaxModel

    jm = JaxModel(_tiny_cfg(width))
    pshape, sshape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(shapes):
        return {k: (rng.integers(-128, 128, s.shape) / 16).astype(np.float32)
                for k, s in shapes.items()}

    trees = {"params": draw(pshape), "stats": draw(sshape), "ema_params": draw(pshape),
             "ema_stats": draw(sshape), "opt_mom": draw(pshape), "opt_vel": draw(pshape)}
    meta = {"epoch": 0, "best_fitness": 0.0, "step": 3, "updates": 3, "nc": 3,
            "cfg": _tiny_cfg(width), "anchors": np.asarray(jm.head.anchors, np.float32).tolist()}
    return trees, meta


# ------------------------------------------------- the port reads what JAX wrote


def _tree_case(case):
    rng = np.random.default_rng(1)
    f32 = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    if case == "one_device":
        return {"params": {("model", "0", "conv", "kernel"): f32(3, 3, 4, 8),
                           ("model", "0", "bn", "bias"): f32(8)},
                "w": f32(5, 7)}, None
    if case == "sharded":
        mesh = _mesh()
        tree = {"params": {("model", "0", "conv", "kernel"): _shard(f32(3, 3, 4, 16), mesh),
                           ("model", "0", "bn", "bias"): _shard(f32(8), mesh),
                           ("model", "1", "w"): _shard(f32(24, 5), mesh),
                           ("model", "2", "odd"): _shard(f32(5, 3), mesh)}}
        assert len(tree["params"][("model", "0", "bn", "bias")].sharding.device_set) == 8
        return tree, None
    if case == "dtypes":
        return {"bf16": jnp.asarray(rng.standard_normal((4, 8)), jnp.bfloat16),
                "f16": jnp.asarray(rng.standard_normal(9), jnp.float16),
                "i32": jnp.arange(-3, 9, dtype=jnp.int32).reshape(3, 4),
                "scalar_f32": jnp.asarray(1.5, jnp.float32),
                "scalar_i32": jnp.asarray(7, jnp.int32),
                "u8": jnp.arange(6, dtype=jnp.uint8), "bool": jnp.asarray([True, False, True]),
                "seq": [f32(2), f32(3, 1)]}, None
    trees, meta = trainer_trees()
    return {k: {p: jnp.asarray(v) for p, v in t.items()} for k, t in trees.items()}, meta


@pytest.mark.parametrize("case", ["one_device", "sharded", "dtypes", "trainer"])
def test_port_reads_what_jax_wrote(tmp_path, case):
    tree, meta = _tree_case(case)
    _jax_save(tmp_path / "ck", tree, meta)
    want, want_meta = jax_orbax.restore(tmp_path / "ck", tree)
    got, got_meta = orbax_ckpt.restore(tmp_path / "ck", device="cpu")
    assert got_meta == want_meta == (meta or {})
    assert_same_tree(want, got)
    if case == "sharded":  # chunks were assembled: the store holds one a shard
        keys = ocdbt.OcdbtStore(tmp_path / "ck").list()
        assert sum(k.startswith(b"params.('model', '0', 'bn', 'bias')/") for k in keys) == 1 + 8
    if case == "trainer":
        assert set(got) == set(TREES)
        assert all(isinstance(k, tuple) for t in got.values() for k in t)


def test_port_reads_a_directory_saved_twice(tmp_path):
    """Orbax replaces the directory (force=True); the port reads the second."""
    rng = np.random.default_rng(2)
    first = {"a": jnp.asarray(rng.standard_normal(6).astype(np.float32))}
    second = {"a": jnp.asarray(rng.standard_normal(6).astype(np.float32)),
              "b": jnp.ones((2, 2), jnp.float32)}
    ck = jax_orbax.AsyncTrainCheckpointer()
    ck.save(tmp_path / "ck", first, meta={"epoch": 1})
    ck.save(tmp_path / "ck", second, meta={"epoch": 2})
    ck.close()
    got, meta = orbax_ckpt.restore(tmp_path / "ck", device="cpu")
    assert meta == {"epoch": 2}
    assert_same_tree(second, got)


def test_restore_with_like_fixes_dtype(tmp_path):
    tree = {"x": jnp.arange(4, dtype=jnp.float16), "y": jnp.ones(3, jnp.float32)}
    _jax_save(tmp_path / "ck", tree)
    like = {"x": jnp.zeros(4, jnp.float32), "y": jnp.zeros(3, jnp.float32)}
    want, _ = jax_orbax.restore(tmp_path / "ck", like)
    got, _ = orbax_ckpt.restore(tmp_path / "ck", like={"x": torch.zeros(4), "y": np.zeros(3, np.float32)},
                                device="cpu")
    assert_same_tree(want, got)


# ------------------------------------------------- JAX reads what the port wrote


def _port_tree():
    rng = np.random.default_rng(3)
    trees, _ = trainer_trees(seed=3)
    tree = {k: {p: torch.from_numpy(v) for p, v in t.items()} for k, t in trees.items()}
    tree["extra"] = {"bf16": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).bfloat16(),
                     "f16": torch.from_numpy(rng.standard_normal(4).astype(np.float16)),
                     "i32": torch.arange(5, dtype=torch.int32), "u8": torch.arange(3, dtype=torch.uint8),
                     "bool": torch.tensor([True, False]), "scalar": torch.tensor(3, dtype=torch.int32),
                     "seq": [torch.ones(2), torch.zeros(1, 3)]}
    return tree


def _as_jax(tree):
    """The port's tree as JAX holds it (for `like` and comparisons)."""
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_jax(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("with_like", [True, False])
def test_jax_reads_what_the_port_wrote(tmp_path, with_like):
    tree = _port_tree()
    nbytes = orbax_ckpt.save(tmp_path / "ck", tree, meta={"epoch": 4})
    assert nbytes == sum(f.stat().st_size for f in (tmp_path / "ck").rglob("*") if f.is_file())
    got, meta = jax_orbax.restore(tmp_path / "ck", _as_jax(tree) if with_like else None)
    assert meta == {"epoch": 4}
    want, have = _port_leaves(tree), _jax_leaves(got)
    assert sorted(want) == sorted(have)
    for k in want:
        assert_same_leaf(want[k], have[k], k)


def test_port_round_trip_and_async(tmp_path):
    """The port's own writer and reader, through the checkpointer: the
    tensors are copied at `save`, so a later change does not reach the
    write; the directory is replaced whole."""
    tree = _port_tree()
    tree["extra"]["i64"] = torch.arange(-2, 5)  # int64: JAX without x64 has none
    ck = orbax_ckpt.AsyncTrainCheckpointer()
    ck.save(tmp_path / "ck", {"a": torch.zeros(3)}, meta={"epoch": 0})
    ck.save(tmp_path / "ck", tree, meta={"epoch": 1})
    snapshot = {k: v.clone() for k, v in tree["params"].items()}
    for v in tree["params"].values():
        v.add_(1.0)
    ck.wait()
    assert ck.last_bytes > 0
    got, meta = orbax_ckpt.restore(tmp_path / "ck", device="cpu")
    ck.close()
    assert meta == {"epoch": 1} and "a" not in got
    for k, v in snapshot.items():
        assert_same_leaf(v, got["params"][k])
    for k in ("bf16", "f16", "i32", "u8", "bool", "i64", "scalar"):
        assert_same_leaf(tree["extra"][k], got["extra"][k])
    assert [tuple(t.shape) for t in got["extra"]["seq"]] == [(2,), (1, 3)]
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.meta.json"]


def test_async_write_error_surfaces(tmp_path):
    (tmp_path / "file").write_text("")
    ck = orbax_ckpt.AsyncTrainCheckpointer()
    ck.save(tmp_path / "file" / "ck", {"a": torch.zeros(3)})
    with pytest.raises(OSError):
        ck.wait()
    ck.close()


# ------------------------------------------------- the OCDBT reader against tensorstore


def _ts_store(root, compression, node_bytes=300, inline=8, commits=3, sub=""):
    cfg = {"max_decoded_node_bytes": node_bytes, "max_inline_value_bytes": inline,
           "compression": None if compression is None else {"id": "zstd", "level": compression}}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/{sub}", "config": cfg}).result()
    for c in range(commits):
        with ts.Transaction() as txn:
            for i in range(40):
                kv.with_transaction(txn)[f"{sub}k{c % 2}/{i:03d}/x"] = (b"v%d-%d" % (c, i)) * (i % 7)
    return kv


def _ts_view(root):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    keys = sorted(kv.list().result())
    return keys, {k: kv.read(k).result().value for k in keys}


def _height(root):
    m = ts.ocdbt.dump(ts.KvStore.open(f"file://{root}/").result()).result()
    return m["versions"][-1]["root_height"], len(m["versions"])


@pytest.mark.parametrize("compression", [None, 0, 3])
def test_ocdbt_reader_matches_tensorstore(tmp_path, compression):
    """Small nodes (B+tree height >= 2), values inline and indirect,
    several commits: the same keys in order and the same bytes."""
    _ts_store(tmp_path, compression)
    height, versions = _height(tmp_path)
    assert height >= 2 and versions >= 3
    keys, values = _ts_view(tmp_path)
    st = ocdbt.OcdbtStore(tmp_path)
    assert st.list() == keys
    assert {k: st.read(k) for k in keys} == values
    assert any(isinstance(st.ref(k), tuple) for k in keys)  # indirect
    assert any(isinstance(st.ref(k), bytes) for k in keys)  # inline
    assert st.config["compression"] == (None if compression is None else
                                        {"id": "zstd", "level": compression})


def test_ocdbt_reader_reads_merged_process_stores(tmp_path):
    """Two per-process stores under `ocdbt.process_<N>/`, merged by Orbax's
    own merge into the root store, whose nodes point into them."""
    import asyncio

    from orbax.checkpoint._src.serialization import ocdbt_utils, tensorstore_utils

    for i in range(2):
        _ts_store(tmp_path, 1, sub=f"ocdbt.process_{i}/")
    ctx = ts.Context(tensorstore_utils._DEFAULT_OCDBT_TS_CONTEXT)
    from etils import epath

    asyncio.run(ocdbt_utils.merge_ocdbt_per_process_files(epath.Path(tmp_path), ctx, use_zarr3=False,
                                                          enable_validation=False))
    keys, values = _ts_view(tmp_path)
    st = ocdbt.OcdbtStore(tmp_path)
    assert st.list() == keys and len(keys) == 160
    assert {k: st.read(k) for k in keys} == values
    assert {st.ref(k)[0].split("/")[0] for k in keys if isinstance(st.ref(k), tuple)} == {
        "ocdbt.process_0", "ocdbt.process_1"}


def test_tensorstore_reads_the_port_store(tmp_path):
    rng = np.random.default_rng(4)
    items = [(f"k/{i:02d}/{'x' * (i % 3)}".encode(), rng.bytes(int(rng.integers(0, 3000))))
             for i in range(50)]
    nbytes = ocdbt.write_store(tmp_path, reversed(items))
    keys, values = _ts_view(tmp_path)
    assert keys == sorted(k for k, _ in items) and values == dict(items)
    assert nbytes == sum(f.stat().st_size for f in tmp_path.rglob("*") if f.is_file())
    assert ocdbt.OcdbtStore(tmp_path).list() == keys


@pytest.mark.parametrize("which", ["manifest", "node"])
def test_a_flipped_byte_fails_its_crc(tmp_path, which):
    _jax_save(tmp_path / "ck", {"a": jnp.ones(4)})
    if which == "manifest":
        f = tmp_path / "ck" / "manifest.ocdbt"
        at = 20
    else:
        st = ocdbt.OcdbtStore(tmp_path / "ck")
        m = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path / 'ck'}/").result()).result()
        loc = m["versions"][-1]["root"]["location"].split(":")
        f, at = tmp_path / "ck" / loc[2], int(loc[3]) + 20
        assert st.list()
    raw = bytearray(f.read_bytes())
    raw[at] ^= 0x01
    f.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c mismatch"):
        ocdbt.OcdbtStore(tmp_path / "ck")
    with pytest.raises(ValueError, match="crc32c mismatch"):
        orbax_ckpt.restore(tmp_path / "ck", device="cpu")


def test_crc32c_known_value():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


# ------------------------------------------------- refusals


def test_no_root_manifest_raises(tmp_path):
    _jax_save(tmp_path / "ck", {"a": jnp.ones(4)})
    (tmp_path / "ck" / "manifest.ocdbt").unlink()
    with pytest.raises(FileNotFoundError, match="no manifest.ocdbt"):
        orbax_ckpt.restore(tmp_path / "ck", device="cpu")
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        orbax_ckpt.restore(tmp_path / "missing", device="cpu")


def test_numbered_manifest_raises(tmp_path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv["a"] = b"1"
    with pytest.raises(ValueError, match="numbered manifest"):
        ocdbt.OcdbtStore(tmp_path)


def _rewrite(root, edit):
    """Copy the store at `root` with `edit(key, value) -> value or None`
    (None drops the key), through the port's writer, in place."""
    st = ocdbt.OcdbtStore(root)
    items = [(k, edit(k, st.read(k))) for k in st.list()]
    shutil.rmtree(root / "d")
    for p in root.glob("ocdbt.process_*"):
        shutil.rmtree(p)
    (root / "manifest.ocdbt").unlink()
    ocdbt.write_store(root, [(k, v) for k, v in items if v is not None])


def test_missing_chunk(tmp_path):
    """A missing chunk raises where the fill value is null, else takes it."""
    mesh = _mesh()
    x = _shard(jnp.arange(16.0, dtype=jnp.float32), mesh)
    _jax_save(tmp_path / "ck", {"x": x})
    _rewrite(tmp_path / "ck", lambda k, v: None if k == b"x/3" else v)
    with pytest.raises(ValueError, match="missing and the fill value is null"):
        orbax_ckpt.restore(tmp_path / "ck", device="cpu")

    def fill(k, v):
        if k == b"x/.zarray":
            za = json.loads(v)
            za["fill_value"] = "NaN"
            return json.dumps(za).encode()
        return v

    _rewrite(tmp_path / "ck", fill)
    got, _ = orbax_ckpt.restore(tmp_path / "ck", device="cpu")
    want = np.arange(16.0, dtype=np.float32)
    want[6:8] = np.nan
    np.testing.assert_array_equal(got["x"].numpy(), want)


@pytest.mark.parametrize("compressor", [{"id": "zstd", "level": 3}, None])
def test_zarr_grid_with_edge_chunks(tmp_path, compressor):
    """A chunk grid that does not divide the shape (tensorstore's zarr
    code stores edge chunks whole), zstd-compressed or raw."""
    x = np.random.default_rng(6).standard_normal((10, 7, 3)).astype(np.float32)
    arr = ts.open({"driver": "zarr", "path": "x", "create": True,
                   "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
                   "metadata": {"chunks": [4, 3, 2], "shape": list(x.shape), "dtype": "<f4",
                                "compressor": compressor, "fill_value": None}}).result()
    arr.write(x).result()
    got, zd = orbax_ckpt.read_zarr(ocdbt.OcdbtStore(tmp_path), "x")
    assert zd == "<f4" and got.tobytes() == x.tobytes()


def test_like_mismatch_raises(tmp_path):
    _jax_save(tmp_path / "ck", {"a": jnp.ones((2, 3)), "b": jnp.ones(2)})
    with pytest.raises(ValueError, match=r"a has shape \(2, 3\), like asks \(3, 2\)"):
        orbax_ckpt.restore(tmp_path / "ck", like={"a": torch.zeros(3, 2), "b": torch.zeros(2)},
                           device="cpu")
    with pytest.raises(ValueError, match=r"key \('c',\) is in like only"):
        orbax_ckpt.restore(tmp_path / "ck", like={"a": torch.zeros(2, 3), "b": torch.zeros(2),
                                                  "c": torch.zeros(1)}, device="cpu")


def test_restore_needs_cuda_unless_cpu(tmp_path):
    _jax_save(tmp_path / "ck", {"a": jnp.ones(2)})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        orbax_ckpt.restore(tmp_path / "ck")


def test_save_refuses_what_orbax_refuses(tmp_path):
    with pytest.raises(ValueError, match="zero-size"):
        orbax_ckpt.save(tmp_path / "ck", {"a": torch.zeros(0, 3)})
    with pytest.raises(ValueError, match="is not written"):
        orbax_ckpt.save(tmp_path / "ck", {"a": torch.zeros(2, dtype=torch.float64)})
    assert not (tmp_path / "ck").exists() and not list(tmp_path.iterdir())


# ------------------------------------------------- zstd


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_decodes_zstandard(level):
    rng = np.random.default_rng(level)
    data = rng.bytes(5000) + bytes(200_000) + (rng.integers(0, 8, 50_000, dtype=np.uint8)).tobytes()
    for content_size in (True, False):
        frame = zstandard.ZstdCompressor(level=level, write_content_size=content_size).compress(data)
        assert zstd.decompress(frame) == data
        out = np.empty(len(data), np.uint8)
        zstd.decompress_into(frame, out)
        assert out.tobytes() == data
    co = zstandard.ZstdCompressor(level=level).compressobj()  # streamed: no content size
    assert zstd.decompress(co.compress(data) + co.flush()) == data
    assert zstandard.ZstdDecompressor().decompress(zstd.compress(data, level)) == data


def test_zstd_decodes_what_tensorstore_wrote(tmp_path):
    """The zarr chunks and the OCDBT containers of a JAX save: zstd frames
    without a content size."""
    x = np.random.default_rng(5).standard_normal((64, 33)).astype(np.float32)
    _jax_save(tmp_path / "ck", {"x": jnp.asarray(x)})
    st = ocdbt.OcdbtStore(tmp_path / "ck")
    frame = st.read(b"x/0.0")
    assert zstandard.get_frame_parameters(frame).content_size == zstandard.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(frame) == x.tobytes()
    raw = (tmp_path / "ck" / "manifest.ocdbt").read_bytes()
    assert raw[13] == 1  # zstd-compressed
    assert zstd.decompress(raw[14:-4]) == zstandard.ZstdDecompressor().decompressobj().decompress(raw[14:-4])


def test_zstd_beside_an_exported_zstd():
    """A library loaded before libzstd that links zstd in and exports it
    globally (TensorFlow's framework library) does not take the calls
    libzstd makes to itself: level 19 crashed the process so."""
    import subprocess

    code = ("import tensorflow\n"
            "import numpy as np\n"
            "from dmayolo_tpu_torch.utils import zstd\n"
            "rng = np.random.default_rng(19)\n"
            "d = rng.bytes(5000) + bytes(200_000) + rng.integers(0, 8, 50_000, dtype=np.uint8).tobytes()\n"
            "assert zstd.decompress(zstd.compress(d, 19)) == d\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_zstd_refuses_corrupt_frames():
    frame = zstd.compress(bytes(1000))
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(frame[:-3])
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"not zstd at all")


# ------------------------------------------------- the weight bridge


def test_bridge_reads_orbax_like_npz(tmp_path):
    """`load_jax_checkpoint` on a `<name>_orbax` directory: the EMA trees,
    f32 kept, the same state_dict as the `.npz` of the same trees, and a
    model from the meta whose served detections are the JAX model's."""
    from test_torch_model import _match_rows, random_vars, small_cfg

    from dmayolo_tpu.graph import DetectionModel as JaxModel
    from dmayolo_tpu_torch.graph import DetectionModel

    cfg = small_cfg()
    jm = JaxModel(cfg)
    params, stats = random_vars(jm, seed=0)
    ema_params, ema_stats = random_vars(jm, seed=1)
    meta = {"epoch": 2, "step": 7, "nc": cfg["nc"], "cfg": cfg,
            "anchors": np.asarray(jm.head.anchors, np.float32).tolist()}
    trees = {"params": params, "stats": stats, "ema_params": ema_params, "ema_stats": ema_stats,
             "opt_mom": params, "opt_vel": params}
    _jax_save(tmp_path / "last_orbax", trees, meta)
    jax_save_npz(tmp_path / "last.npz", meta=meta, **trees)
    sd, got_meta = load_jax_checkpoint(tmp_path / "last_orbax", device="cpu")
    sd_npz, npz_meta = load_jax_checkpoint(tmp_path / "last.npz", device="cpu")
    assert got_meta == meta and npz_meta["cfg"] == meta["cfg"]
    assert sd.keys() == sd_npz.keys()
    for k in sd:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], sd_npz[k]), k

    pm = DetectionModel(got_meta["cfg"], nc=got_meta["nc"], device="cpu")
    pm.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(pm.head.anchors, np.asarray(got_meta["anchors"], np.float32))
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)

    @jax.jit
    def serve(p, s, v):
        return jm.serve_detections(jm.apply(p, s, v), conf_thres=0.0, backend="scan")

    want_d, want_v = (np.asarray(a) for a in serve(ema_params, ema_stats, jnp.asarray(x)))
    with torch.inference_mode():
        got_d, got_v = pm.serve_detections(pm.apply(torch.from_numpy(x)), conf_thres=0.0,
                                           backend="matrix")
    for b in range(2):
        _match_rows(want_d[b][want_v[b]], got_d[b][got_v[b]].numpy())


# ------------------------------------------------- the committed fixture


def _expected():
    with np.load(FIXTURE / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def _leaf_key(tree, path):
    return tree + "|" + "|".join(path)


def test_fixture_is_what_jax_restores():
    """JAX's `restore` of the committed directory equals `expected.npz`,
    and so does the port's; the leaves were chunked by device."""
    exp = _expected()
    trees, meta = orbax_ckpt.restore(FIXTURE / "last_orbax", device="cpu")
    like = {name: {p: jnp.zeros(tuple(v.shape), jnp.float32) for p, v in t.items()}
            for name, t in trees.items()}
    want, want_meta = jax_orbax.restore(FIXTURE / "last_orbax", like)
    assert meta == want_meta and meta["nc"] == 3
    assert sorted(exp) == sorted(_leaf_key(n, p) for n, t in trees.items() for p in t)
    for name, t in trees.items():
        for p, v in t.items():
            assert_same_leaf(exp[_leaf_key(name, p)], v, _leaf_key(name, p))
            assert_same_leaf(exp[_leaf_key(name, p)], want[name][p], _leaf_key(name, p))
    keys = ocdbt.OcdbtStore(FIXTURE / "last_orbax").list()
    assert len(keys) > 2 * sum(len(t) for t in trees.values())  # chunked


def write_fixture(dest=FIXTURE):
    """Write `tests/fixtures/orbax_jax_tiny/`: a TINY_CFG-shaped train
    state (width 0.0625) saved by the JAX package's checkpointer on the
    8-device CPU mesh, each leaf split over the devices where an axis
    divides by 8, its `.meta.json`, and `expected.npz` of JAX's restore
    (keys `<tree>|<path...>`)."""
    trees, meta = trainer_trees(seed=7)
    mesh = _mesh()
    tree = {k: {p: _shard(jnp.asarray(v), mesh) for p, v in t.items()} for k, t in trees.items()}
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    _jax_save(dest / "last_orbax", tree, meta)
    got, _ = jax_orbax.restore(dest / "last_orbax", tree)
    np.savez_compressed(dest / "expected.npz", **{
        _leaf_key(name, p): np.asarray(v) for name, t in got.items() for p, v in t.items()})


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_fixture()
    print(sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file()), "bytes in", FIXTURE)
