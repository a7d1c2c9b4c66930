"""TFLite in the port without TensorFlow: the FlatBuffers codec
(`utils/flatbuf.py`, `utils/tflite.py`), the program that runs a model
(`cli/tflite_run.py`), the writer (`cli/tflite_export.py`) and the CLI
wiring, against TensorFlow Lite itself, which is test-only here.

The oracle is `tf.lite.Interpreter` with TFLite's reference kernels
(`OpResolverType.BUILTIN_REF`).  Every int8 tensor is compared to the
last bit.  One exception: TF 2.21's reference int8 SUM does not return
the sum (its outputs disagree with the builtin kernel's and with the
arithmetic of `reference_ops::QuantizedMeanOrSum`, which the port and the
builtin kernel share); `reference_run` therefore runs a model op by op,
each a one-op model through BUILTIN_REF, but SUM through the builtin
kernel, and the JAX fixture's int8 artifact (the only one with SUM) is
held to that.  The interpreter runs with `preserve_all_tensors`: without
it, TF 2.21's arena reuse changes the f32 fixture's outputs by 6% of
their scale, where the preserving run, the XNNPACK delegate and the port
agree.  f32 tensors are held to 1e-4 of the reference's largest
magnitude ("scaled").

The committed fixture `tests/fixtures/tflite_jax_tiny/` (also read on the
card by `chip_smoke.py`) holds the JAX package's f32 and int8 artifacts
of the flagship yaml at width 0.0625, depth 0.33, nc 3, 128 px, with
their sidecars, the JAX checkpoint they were exported from, and
`expected.npz`: a seeded uint8 input and the reference's outputs.
`JAX_PLATFORMS=cpu python tests/test_torch_tflite.py` regenerates it.

The port's own f32 artifacts are checked for the TINY_CFG model, the
fixture's flagship (whose JAX artifacts give the JAX comparison without
a conversion here), a small TDetect model (CASPD_ODRTA) and each yaml the
writer covers at a small width and 64 px; its int8 artifacts for the
first two and DMA-full (attention in f32 islands), and at the op level
for the flagship at width 0.5.
"""
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dmayolo_tpu_torch.cli import backends as pbackends  # noqa: E402
from dmayolo_tpu_torch.cli import detect as pdetect  # noqa: E402
from dmayolo_tpu_torch.cli import export as pexport  # noqa: E402
from dmayolo_tpu_torch.cli.export import InferenceProgram  # noqa: E402
from dmayolo_tpu_torch.cli.tflite_export import (RawProgram, export_tflite,  # noqa: E402
                                                 export_tflite_int8, translate)
from dmayolo_tpu_torch.cli.tflite_run import TFLiteProgram  # noqa: E402
from dmayolo_tpu_torch.graph import DetectionModel  # noqa: E402
from dmayolo_tpu_torch.utils import flatbuf  # noqa: E402
from dmayolo_tpu_torch.utils import tflite as T  # noqa: E402
from dmayolo_tpu_torch.utils.weights import load_jax_checkpoint  # noqa: E402

FIXTURE = ROOT / "tests" / "fixtures" / "tflite_jax_tiny"
FLAGSHIP = "ablation-ca-scconv-sppfcspc"
IMGSZ = 128
TOL = 1e-4

tf = pytest.importorskip("tensorflow")
from tensorflow.lite.python import schema_py_generated as S  # noqa: E402
from tensorflow.lite.python.interpreter import OpResolverType  # noqa: E402

warnings.filterwarnings("ignore", message=".*tf.lite.Interpreter is deprecated.*")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _interp(path, resolver="BUILTIN_REF", keep=False):
    it = tf.lite.Interpreter(model_path=str(path),
                             experimental_op_resolver_type=getattr(OpResolverType, resolver),
                             experimental_preserve_all_tensors=keep)
    it.allocate_tensors()
    return it


def tflite_outputs(path, x, resolver="BUILTIN_REF"):
    it = _interp(path, resolver, keep=True)
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    return [it.get_tensor(o["index"]) for o in it.get_output_details()]


def reference_run(path, x, feed=None):
    """Every tensor of the model at `path` on input x, computed op by op by
    TFLite: each op a one-op model through the reference kernels (SUM
    through the builtin kernel, see the module docstring).  With `feed`
    (index -> array, e.g. a `TFLiteProgram` run's), each op reads its
    inputs from `feed` instead: each op alone, on the same operands."""
    m = T.read_model(path)
    g = m.subgraphs[0]
    env = {g.inputs[0]: np.asarray(x)}
    src = env if feed is None else feed
    with tempfile.TemporaryDirectory() as d:
        for k, op in enumerate(g.operators):
            idx = sorted({i for i in op.inputs + op.outputs if i >= 0})
            remap = {i: j for j, i in enumerate(idx)}
            bufs, tensors = [None], []
            for i in idx:
                t = g.tensors[i]
                data = m.buffers[t.buffer] if t.buffer < len(m.buffers) else None
                b = 0
                if data is not None and len(data):
                    bufs.append(np.array(data))
                    b = len(bufs) - 1
                tensors.append(T.Tensor(t.shape, t.type, b, t.name, t.quantization))
            ins = [remap[i] for i in op.inputs if i >= 0 and m.constant(g.tensors[i]) is None]
            out = remap[op.outputs[0]]
            one = T.Operator(op.op, [remap.get(i, -1) for i in op.inputs], [out], op.options,
                             op.version)
            path1 = Path(d) / f"op{k}.tflite"
            T.write_model(T.Model([T.SubGraph(tensors, ins, [out], [one])], bufs), path1)
            int_sum = op.op == "SUM" and g.tensors[op.inputs[0]].type == T.TYPE_OF[
                np.dtype(np.int8)]
            it = _interp(path1, "BUILTIN_WITHOUT_DEFAULT_DELEGATES" if int_sum else "BUILTIN_REF")
            for j in ins:
                it.set_tensor(j, np.asarray(src[idx[j]]))
            it.invoke()
            env[op.outputs[0]] = it.get_tensor(out)
    return env


def assert_close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(got - want).max() / scale)


def assert_int8_equal(prog_env, ref_env, g):
    n = 0
    for i, want in ref_env.items():
        if want.dtype == np.int8:
            got = prog_env[i].numpy()
            assert np.array_equal(got, want), (g.tensors[i].name,
                                               np.abs(got.astype(int) - want).max())
            n += 1
    return n


def _expected():
    with np.load(FIXTURE / "expected.npz") as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------------------- codec


def _schema_model(path):
    return S.ModelT.InitFromObj(S.Model.GetRootAsModel(Path(path).read_bytes(), 0))


@pytest.mark.parametrize("name", ["flagship.tflite", "flagship-int8.tflite"])
def test_read_model_matches_schema_py_generated(name):
    """Field by field against TensorFlow's generated reader."""
    path = FIXTURE / name
    want, got = _schema_model(path), T.read_model(path)
    assert got.version == want.version == 3 and got.description == want.description.decode()
    codes = [(max(c.builtinCode, c.deprecatedBuiltinCode), c.version) for c in want.operatorCodes]
    g, wg = got.subgraphs[0], want.subgraphs[0]
    assert g.inputs == list(wg.inputs) and g.outputs == list(wg.outputs)
    assert g.name == wg.name.decode()
    opt_names = {v: k for k, v in S.BuiltinOptions.__dict__.items() if not k.startswith("_")}
    for op, wop in zip(g.operators, wg.operators, strict=True):
        code, version = codes[wop.opcodeIndex]
        assert (T.OPS[op.op][0], op.version) == (code, version)
        assert op.inputs == list(wop.inputs) and op.outputs == list(wop.outputs)
        if wop.builtinOptions is not None:
            assert T.OPTIONS_BY_TYPE[wop.builtinOptionsType] == opt_names[wop.builtinOptionsType]
            for fid, fname, kind, default in T.OPTIONS[opt_names[wop.builtinOptionsType]][1]:
                camel = "".join(w.capitalize() for w in fname.split("_"))
                camel = camel[0].lower() + camel[1:]
                assert op.options[fname] == getattr(wop.builtinOptions, camel), fname
    for t, wt in zip(g.tensors, wg.tensors, strict=True):
        assert t.shape == list(wt.shape) and t.type == wt.type and t.buffer == wt.buffer
        assert t.name == wt.name.decode()
        wq = wt.quantization
        if wq is None or wq.scale is None:
            assert t.quantization is None
        else:
            assert np.array_equal(t.quantization.scale, wq.scale)
            assert np.array_equal(t.quantization.zero_point, wq.zeroPoint)
            assert t.quantization.quantized_dimension == wq.quantizedDimension
    for b, wb in zip(got.buffers, want.buffers, strict=True):
        assert (b is None and wb.data is None) or bytes(b) == bytes(wb.data)
    assert got.metadata == {m.name.decode(): m.buffer for m in want.metadata}
    for sd in want.signatureDefs:
        ins, outs = got.signatures[sd.signatureKey.decode()]
        assert ins == {t.name.decode(): t.tensorIndex for t in sd.inputs}
        assert outs == {t.name.decode(): t.tensorIndex for t in sd.outputs}


@pytest.mark.parametrize("name", ["flagship.tflite", "flagship-int8.tflite"])
def test_write_model_round_trip(tmp_path, name):
    """write_model(read_model(f)) reads back equal, and tf.lite runs it to
    the same outputs bit for bit."""
    m = T.read_model(FIXTURE / name)
    size = T.write_model(m, tmp_path / name)
    assert size == (tmp_path / name).stat().st_size and size % 16 == 0
    m2 = T.read_model(tmp_path / name)
    assert m2.subgraphs[0].operators == m.subgraphs[0].operators
    for t, t2 in zip(m.subgraphs[0].tensors, m2.subgraphs[0].tensors, strict=True):
        assert (t.shape, t.type, t.buffer, t.name) == (t2.shape, t2.type, t2.buffer, t2.name)
    assert [None if b is None else bytes(b) for b in m.buffers] == \
        [None if b is None else bytes(b) for b in m2.buffers]
    assert (m.signatures, m.metadata, m.description) == (m2.signatures, m2.metadata,
                                                         m2.description)
    x = _expected()["x"]
    for a, b in zip(tflite_outputs(FIXTURE / name, x), tflite_outputs(tmp_path / name, x)):
        assert np.array_equal(a, b)


def test_builder_alignment_and_defaults():
    """A table's absent fields read as their defaults, vectors and strings
    come back, and a 16-aligned vector lands 16-aligned in the file."""
    b = flatbuf.Builder()
    data = b.bytes_vector(np.arange(37, dtype=np.uint8), 16)
    s = b.string("héllo")
    v = b.vector("i64", [-5, 2**40])
    root = b.table([(0, "ref", data), (2, "ref", s), (3, "i16", -7), (5, "ref", v)])
    b.finish(root, b"TEST")
    buf = np.frombuffer(b.output(), np.uint8)
    t = flatbuf.Table.root(buf)
    arr = t.numpy(0, "u8")
    assert arr.tolist() == list(range(37)) and arr.ctypes.data % 16 == buf.ctypes.data % 16
    assert t.string(2) == "héllo" and t.scalar(3, "i16") == -7 and t.scalar(4, "f32", 1.5) == 1.5
    assert t.numpy(5, "i64").tolist() == [-5, 2**40] and t.string(1) is None
    assert bytes(buf[4:8]) == b"TEST"


def _offset_model(offset: int, size: int) -> bytes:
    """A model file whose buffer 1 gives (offset, size) instead of data."""
    b = flatbuf.Builder()
    empty = b.table([])
    far = b.table([(1, "u64", offset), (2, "u64", size)])
    tensor = b.table([(0, "ref", b.vector("i32", [size // 4])), (1, "i8", 0), (2, "u32", 1),
                      (3, "ref", b.string("w"))])
    sub = b.table([(0, "ref", b.refs([tensor])), (1, "ref", b.vector("i32", [])),
                   (2, "ref", b.vector("i32", [])), (3, "ref", b.refs([]))])
    root = b.table([(0, "u32", 3), (1, "ref", b.refs([])), (2, "ref", b.refs([sub])),
                    (4, "ref", b.refs([empty, far]))])
    b.finish(root, T.FILE_ID)
    return b.output()


def test_large_buffer_offsets_are_read(tmp_path):
    """A `Buffer` that gives offset/size into the file's tail (as a
    converter writes a model past 2 GB) reads as inline data does."""
    data = np.arange(64, dtype=np.float32)
    head = _offset_model(0, data.nbytes)
    offset = len(head) + (-len(head)) % 16
    head = _offset_model(offset, data.nbytes)  # the same size: u64 fields
    (tmp_path / "far.tflite").write_bytes(head + bytes(offset - len(head)) + data.tobytes())
    m = T.read_model(tmp_path / "far.tflite")
    assert np.array_equal(m.constant(m.subgraphs[0].tensors[0]), data)


# ------------------------------------------------------ the program, JAX's


def test_program_runs_jax_f32_fixture():
    exp = _expected()
    prog = TFLiteProgram(FIXTURE / "flagship.tflite", device="cpu")
    assert_close(prog(exp["x"])[0].numpy(), exp["f32_out"], what="f32")


def test_program_runs_jax_int8_fixture_bit_for_bit():
    """Every int8 tensor equal to TFLite's kernels' (`reference_run`), and
    the dequantized heads equal to `expected.npz`."""
    exp = _expected()
    path = FIXTURE / "flagship-int8.tflite"
    prog = TFLiteProgram(path, device="cpu")
    env = prog.run(exp["x"], keep_all=True)
    assert assert_int8_equal(env, reference_run(path, exp["x"]), prog.model.subgraphs[0]) > 100
    for k, o in enumerate(prog.outputs):
        assert np.array_equal(env[o].numpy(), exp[f"int8_out{k}"])
    # whole-graph BUILTIN_REF agrees with the op-by-op run up to its first SUM
    it = _interp(path, keep=True)
    it.set_tensor(it.get_input_details()[0]["index"], exp["x"])
    it.invoke()
    g = prog.model.subgraphs[0]
    first_sum = next(k for k, op in enumerate(g.operators) if op.op == "SUM")
    for op in g.operators[:first_sum]:
        o = op.outputs[0]
        assert np.array_equal(env[o].numpy(), it.get_tensor(o)), g.tensors[o].name


def test_jax_fixture_output_order():
    """The int8 heads come out of the subgraph as ':1', ':0', ':2'; the
    backend orders them by the suffix and checks the sidecar's shapes."""
    prog = TFLiteProgram(FIXTURE / "flagship-int8.tflite", device="cpu")
    meta = yaml.safe_load((FIXTURE / "flagship-int8.tflite.meta.yaml").read_text())
    shapes = [prog.tensors[i].shape for i in prog.outputs]
    order = pbackends.raw_head_order(prog.output_names, shapes, meta)
    assert [prog.output_names[i] for i in order] == [f"StatefulPartitionedCall:{k}"
                                                     for k in range(3)]
    unnamed = [f"head{k}" for k in range(3)]
    assert [shapes[i][1:3] for i in pbackends.raw_head_order(unnamed, shapes, meta)] == \
        meta["shapes"]
    with pytest.raises(ValueError, match="mismatch"):
        pbackends.raw_head_order(prog.output_names, shapes, dict(meta, shapes=meta["shapes"][::-1]))


# ------------------------------------------------------------ single ops


def _q(s, z):
    return T.Quantization(np.array([s], np.float32), np.array([z], np.int64))


def one_op_model(op, in_shapes, out_shape, qs, consts=(), options=None, in_type=9):
    """A model of one int8 op: its activation inputs, constant inputs
    (array, quantization or None) after them, one output."""
    tensors, bufs = [], [None]
    for shape, q in zip(in_shapes, qs[:-1]):
        tensors.append(T.Tensor(list(shape), in_type, 0, f"in{len(tensors)}", _q(*q)))
    ins = list(range(len(tensors)))
    for arr, q in consts:
        arr = np.ascontiguousarray(arr)
        bufs.append(arr.reshape(-1).view(np.uint8))
        tensors.append(T.Tensor(list(arr.shape), T.TYPE_OF[arr.dtype], len(bufs) - 1,
                                f"c{len(tensors)}", q))
    tensors.append(T.Tensor(list(out_shape), 9, 0, "out", _q(*qs[-1])))
    out = len(tensors) - 1
    g = T.SubGraph(tensors, ins, [out], [T.Operator(op, list(range(out)), [out],
                                                   dict(options or {}))])
    return T.Model([g], bufs)


def _check_one_op(tmp_path, model, seed=0):
    path = tmp_path / "one.tflite"
    T.write_model(model, path)
    g = model.subgraphs[0]
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-128, 128, g.tensors[i].shape, dtype=np.int8) for i in g.inputs]
    it = _interp(path)
    for i, x in zip(g.inputs, xs):
        it.set_tensor(i, x)
    it.invoke()
    want = it.get_tensor(g.outputs[0])
    prog = TFLiteProgram(model, device="cpu")
    env = dict(prog.constants)
    env.update({i: torch.as_tensor(x) for i, x in zip(g.inputs, xs)})
    (fn, ins, out), = prog.steps
    got = fn(*(env[i] for i in ins)).numpy()
    assert np.array_equal(got, want), np.abs(got.astype(int) - want).max()


@pytest.mark.parametrize("op", ["LOGISTIC", "HARD_SWISH", "RELU"])
@pytest.mark.parametrize("qin", [(0.02, 5), (0.1, -100), (0.003, 127), (0.5, -128)])
def test_int8_table_ops(tmp_path, op, qin):
    """All 256 inputs of LOGISTIC (output fixed at 1/256, -128),
    HARD_SWISH and RELU against the reference kernel."""
    qout = (1 / 256, -128) if op == "LOGISTIC" else (qin[0] * 0.7, 10)
    m = one_op_model(op, [(1, 16, 16, 1)], (1, 16, 16, 1), [qin, qout])
    _check_one_op(tmp_path, m)


@pytest.mark.parametrize("op", ["ADD", "SUB", "MUL"])
@pytest.mark.parametrize("shapes", [((2, 5, 6, 8), (2, 5, 6, 8)), ((2, 5, 6, 8), (1, 1, 1, 8)),
                                    ((1, 4, 2, 4, 2, 8), (1, 4, 1, 4, 1, 8))])
def test_int8_binary_ops(tmp_path, op, shapes):
    m = one_op_model(op, shapes, shapes[0], [(0.05, 3), (0.01, -20), (0.08, -7)])
    _check_one_op(tmp_path, m)


@pytest.mark.parametrize("pool,padding,k,s,hw", [
    ("AVERAGE_POOL_2D", 1, 4, 4, 16), ("AVERAGE_POOL_2D", 0, 3, 2, 9),
    ("MAX_POOL_2D", 0, 5, 1, 6), ("AVERAGE_POOL_2D", 1, (1, 7), (1, 7), 7)])
def test_int8_pools(tmp_path, pool, padding, k, s, hw):
    kh, kw = (k, k) if isinstance(k, int) else k
    sh, sw = (s, s) if isinstance(s, int) else s
    ho = -(-hw // sh) if padding == 0 else (hw - kh) // sh + 1
    wo = -(-hw // sw) if padding == 0 else (hw - kw) // sw + 1
    m = one_op_model(pool, [(2, hw, hw, 8)], (2, ho, wo, 8), [(0.05, 3), (0.05, 3)],
                     options={"padding": padding, "stride_h": sh, "stride_w": sw,
                              "filter_height": kh, "filter_width": kw})
    _check_one_op(tmp_path, m)


@pytest.mark.parametrize("qin,qout", [((0.05, -124), (0.14, -121)), ((0.05, 3), (0.05, 3))])
def test_int8_sum_matches_builtin_kernel(tmp_path, qin, qout):
    """SUM against TFLite's builtin kernel (see the module docstring)."""
    m = one_op_model("SUM", [(1, 4, 4, 16)], (1, 4, 16), [qin, qout],
                     consts=[(np.array([1], np.int32), None)], options={"keep_dims": False})
    path = tmp_path / "sum.tflite"
    T.write_model(m, path)
    x = np.random.default_rng(1).integers(-128, 128, (1, 4, 4, 16), dtype=np.int8)
    it = _interp(path, "BUILTIN_WITHOUT_DEFAULT_DELEGATES")
    it.set_tensor(0, x)
    it.invoke()
    got = TFLiteProgram(m, device="cpu")(x)[0].numpy()
    assert np.array_equal(got, it.get_tensor(2))


def _conv_model(op, c_in, c_out, k, stride, padding, hw, seed=0):
    rng = np.random.default_rng(seed)
    if op == "DEPTHWISE_CONV_2D":
        w = rng.integers(-127, 128, (1, k, k, c_out), dtype=np.int8)
    else:
        w = rng.integers(-127, 128, (c_out, k, k, c_in), dtype=np.int8)
    s_w = rng.uniform(0.001, 0.01, c_out).astype(np.float32)
    s_in, s_out = 0.05, 0.3
    b = rng.integers(-5000, 5000, c_out).astype(np.int32)
    wq = T.Quantization(s_w, np.zeros(c_out, np.int64), 3 if op == "DEPTHWISE_CONV_2D" else 0)
    bq = T.Quantization((np.float32(s_in) * s_w).astype(np.float32), np.zeros(c_out, np.int64))
    ho = -(-hw // stride) if padding == 0 else (hw - k) // stride + 1
    opts = {"padding": padding, "stride_h": stride, "stride_w": stride}
    if op == "DEPTHWISE_CONV_2D":
        opts["depth_multiplier"] = c_out // c_in
    return one_op_model(op, [(2, hw, hw, c_in)], (2, ho, ho, c_out), [(s_in, -17), (s_out, 9)],
                        consts=[(w, wq), (b, bq)], options=opts)


@pytest.mark.parametrize("op,c_in,c_out,k,stride,padding,hw", [
    ("CONV_2D", 8, 12, 3, 1, 0, 9),  # SAME, symmetric: K4's 3x3 s1 route on the card
    ("CONV_2D", 24, 8, 3, 2, 0, 10),  # SAME on an even map: the odd row at the end
    ("CONV_2D", 16, 8, 3, 2, 1, 11),  # VALID
    ("CONV_2D", 5, 16, 6, 2, 0, 16),  # a 6x6 stem, channels padded to 16
    ("CONV_2D", 16, 16, 1, 1, 0, 7),  # 1x1
    ("CONV_2D", 16, 8, 3, 1, 0, 8),  # grouped: a filter of 4 input channels (below)
    ("DEPTHWISE_CONV_2D", 8, 8, 5, 1, 0, 9), ("DEPTHWISE_CONV_2D", 4, 8, 3, 2, 0, 8)])
def test_int8_convs(tmp_path, op, c_in, c_out, k, stride, padding, hw):
    """The per-channel conv: the zero-padded route plus the border
    correction of zp_in, the asymmetric SAME pad, grouped and depthwise."""
    m = _conv_model(op, c_in, c_out, k, stride, padding, hw)
    if op == "CONV_2D" and c_in == 16 and c_out == 8 and stride == 1 and k == 3:
        g = m.subgraphs[0]
        w = g.tensors[1]
        arr = m.constant(w)[..., :4].copy()  # 4 groups of 4 channels
        m.buffers[w.buffer] = arr.reshape(-1).view(np.uint8)
        w.shape = list(arr.shape)
    _check_one_op(tmp_path, m)


@pytest.mark.parametrize("qin,qout", [((0.05, -3), (0.1, 10)), ((0.02, 0), (0.02, 0))])
def test_int8_requantize_and_pad(tmp_path, qin, qout):
    _check_one_op(tmp_path, one_op_model("QUANTIZE", [(2, 5, 5, 8)], (2, 5, 5, 8), [qin, qout]))
    pads = np.array([[0, 0], [1, 2], [0, 1], [0, 0]], np.int32)
    _check_one_op(tmp_path, one_op_model("PAD", [(2, 5, 5, 8)], (2, 8, 6, 8), [qin, qin],
                                         consts=[(pads, None)]))


def test_unknown_op_raises():
    m = one_op_model("LOGISTIC", [(1, 2, 2, 1)], (1, 2, 2, 1), [(0.1, 0), (1 / 256, -128)])
    m.subgraphs[0].operators[0].op = "TANH"
    with pytest.raises(NotImplementedError, match="op TANH"):
        TFLiteProgram(m, device="cpu")


def test_writer_names_the_unmapped_op():
    class Atan(torch.nn.Module):
        def forward(self, x):
            return torch.atan(x.float())

    with pytest.raises(NotImplementedError, match="atan"):
        translate(Atan(), torch.zeros((1, 4, 4, 3), dtype=torch.uint8))


# ------------------------------------------------------ the port's writer


def _flagship_from_fixture():
    sd, meta = load_jax_checkpoint(FIXTURE / "flagship.npz", device="cpu")
    m = DetectionModel(meta["cfg"], device="cpu")
    m.load_state_dict(sd, strict=True)
    return m.eval().fuse()


def _tiny():
    from dmayolo_tpu.graph import DetectionModel as JaxModel
    from dmayolo_tpu_torch.utils.weights import state_dict_from_jax
    from tests.test_e2e_train import TINY_CFG
    from tests.test_torch_model import random_vars

    params, stats = random_vars(JaxModel(TINY_CFG), seed=2)
    m = DetectionModel(TINY_CFG, device="cpu")
    m.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return m.eval().fuse()


def _tdetect():
    from dmayolo_tpu.graph import DetectionModel as JaxModel
    from dmayolo_tpu_torch.utils.weights import state_dict_from_jax
    from tests.test_torch_model import random_vars
    from tests.test_torch_zoo_models import _cfg

    cfg = _cfg("CASPD_ODRTA", depth=0.33, width=0.125)
    params, stats = random_vars(JaxModel(cfg), seed=4)
    m = DetectionModel(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return m.eval().fuse()


def _zoo(name, width):
    """A yaml of the zoo at depth 0.33 and a small width, weights from a
    torch seed (the comparisons here are the port's against itself)."""
    from tests.test_torch_zoo_models import _anchors, _cfg

    def make():
        cfg = _cfg(name, depth=0.33, width=width)
        torch.manual_seed(0)
        return DetectionModel(cfg, anchors=_anchors(cfg), device="cpu").eval().fuse()
    return make


DMA_FULL = "yolov5l-ca-sppfcspc-bifpn-scconv"
# name -> (model, imgsz); the zoo's at the smallest width each builds at
MODELS = {"tiny": (_tiny, IMGSZ), "flagship": (_flagship_from_fixture, IMGSZ),
          "tdetect": (_tdetect, IMGSZ), "yolov5s": (_zoo("yolov5s", 0.125), 64),
          "yolov5n": (_zoo("yolov5n", 0.125), 64), "C3CASPD2": (_zoo("C3CASPD2", 0.125), 64),
          "DMA-full": (_zoo(DMA_FULL, 0.25), 64), "TPH": (_zoo("yolov5l-xs-tph", 0.5), 64),
          "DMA-HorNet": (_zoo("ca-sppfcspc-bifpn-scconv-adapt-hornet", 0.125), 64),
          "CADMM": (_zoo("CADMM", 0.125), 64), "ghostnet": (_zoo("ghostnet", 0.125), 64)}


def _input(imgsz):
    if imgsz == IMGSZ:
        return _expected()["x"]
    return np.random.default_rng(7).integers(0, 256, (1, imgsz, imgsz, 3), dtype=np.uint8)


@pytest.mark.parametrize("name", list(MODELS))
def test_port_f32_artifact_in_tflite(tmp_path, name):
    """tf.lite runs the port's f32 artifact to the port's native f32
    program, and so does `TFLiteProgram`; the flagship's also to the JAX
    package's artifact of the same weights.  Together the models reach
    every handler of the writer and every f32 runner but MAXIMUM and
    MINIMUM (below): GATHER and depthwise convs in ghostnet, layer norm
    (MEAN, RSQRT), FULLY_CONNECTED, BATCH_MATMUL, SOFTMAX and GELU in
    DMA-full and TPH."""
    make, imgsz = MODELS[name]
    m = make()
    path = export_tflite(m, imgsz, 1, tmp_path / f"{name}.tflite")
    x = _input(imgsz)
    with torch.no_grad():
        native = InferenceProgram(m, torch.float32)(torch.as_tensor(x)).numpy()
    got = tflite_outputs(path, x)[0]
    assert_close(got, native, what=name)
    assert_close(TFLiteProgram(path, device="cpu")(x)[0].numpy(), native, what=name)
    if name == "flagship":
        assert_close(got, _expected()["f32_out"], what="against JAX's artifact")


def test_clamp_as_maximum_minimum(tmp_path):
    """A clamp becomes MAXIMUM and MINIMUM."""
    class Clamped(torch.nn.Module):
        def forward(self, x):
            return (x.float() / 255.0).clamp(0.2, 0.7) * 3.0

    x = np.random.default_rng(8).integers(0, 256, (1, 6, 6, 3), dtype=np.uint8)
    path = tmp_path / "clamp.tflite"
    T.write_model(translate(Clamped(), torch.as_tensor(x)), path)
    assert {"MAXIMUM", "MINIMUM"} <= {op.op for op in T.read_model(path).subgraphs[0].operators}
    want = Clamped()(torch.as_tensor(x)).numpy()
    assert_close(tflite_outputs(path, x)[0], want)
    assert_close(TFLiteProgram(path, device="cpu")(x)[0].numpy(), want)


def test_port_f32_artifact_in_f64(tmp_path):
    """The port's f32 artifact of the flagship with every tensor made f64
    (`chip_smoke.float64_model`, what the card's check runs) against the
    native f64 program: the translation apart from f32 rounding (the
    native decode rounds to f32)."""
    import chip_smoke

    m = _flagship_from_fixture()
    path = export_tflite(m, IMGSZ, 1, tmp_path / "f.tflite")
    x = _expected()["x"]
    with torch.no_grad():
        native = InferenceProgram(m.double(), torch.float64)(torch.as_tensor(x)).numpy()
    prog = TFLiteProgram(chip_smoke.float64_model(T.read_model(path)), device="cpu")
    env = prog.run(x, keep_all=True)
    assert {v.dtype for v in env.values() if v.is_floating_point()} == {torch.float64}
    assert_close(env[prog.outputs[0]].numpy(), native, tol=1e-6)


INT8_MODELS = ("tiny", "flagship", "DMA-full")


@pytest.fixture(scope="module")
def port_int8(tmp_path_factory):
    d = tmp_path_factory.mktemp("int8")
    out = {}
    for name in INT8_MODELS:
        make, imgsz = MODELS[name]
        opt = type("Opt", (), dict(data=None, ncalib=8, batch_size=1, imgsz=imgsz))
        batches = pexport.calibration_batches(opt)  # JAX's noise batches, as the fixture's
        m = make()
        out[name] = (m, export_tflite_int8(m, imgsz, 1, batches, d / f"{name}-int8.tflite"),
                     _input(imgsz))
    return out


@pytest.mark.parametrize("name", INT8_MODELS)
def test_port_int8_artifact_bit_for_bit(port_int8, name):
    """Every int8 tensor of the port's int8 artifact equal between
    BUILTIN_REF (preserve_all_tensors) and TFLiteProgram; the flagship's
    heads no further from f32 than 1.5x the JAX artifact's.  DMA-full's
    keeps its attention, layer norms and GELU in f32 between DEQUANTIZE
    and QUANTIZE."""
    m, path, x = port_int8[name]
    exp = _expected()
    prog = TFLiteProgram(path, device="cpu")
    env = prog.run(x, keep_all=True)
    it = _interp(path, keep=True)
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    g = prog.model.subgraphs[0]
    ref = {op.outputs[0]: it.get_tensor(op.outputs[0]) for op in g.operators}
    ops = {op.op for op in g.operators}
    assert "SUM" not in ops
    if name != "DMA-full":
        assert assert_int8_equal(env, ref, g) > 50
    else:
        # the f32 islands' torch ops round unlike TFLite's f32 kernels, and
        # a QUANTIZE after one may land a step apart: the whole graph agrees
        # up to the first island; each op alone, on the program's own
        # operands, agrees to the bit (int8) or within 1e-5 scaled (f32)
        assert {"FULLY_CONNECTED", "BATCH_MATMUL", "SOFTMAX", "GELU", "MEAN"} <= ops
        first = next(k for k, op in enumerate(g.operators)
                     if op.op != "QUANTIZE" and g.tensors[op.outputs[0]].type == T.TYPE_OF[
                         np.dtype(np.float32)])
        assert assert_int8_equal(env, {op.outputs[0]: ref[op.outputs[0]]
                                       for op in g.operators[:first]}, g) > 20
        alone = reference_run(path, x, feed={i: v.numpy() for i, v in env.items()})
        assert assert_int8_equal(env, alone, g) > 300
        for i, want in alone.items():
            if want.dtype == np.float32:
                assert_close(env[i].numpy(), want, tol=1e-5, what=g.tensors[i].name)
    with torch.no_grad():
        f32 = [r.numpy() for r in RawProgram(m)(torch.as_tensor(x).float() / 255.0)]
    ours = [env[o].numpy() for o in prog.outputs]
    err = np.mean([np.abs(a - b).mean() for a, b in zip(ours, f32)])
    assert err < 0.05 * np.mean([np.abs(b).mean() for b in f32])
    if name == "flagship":
        jax_heads = [exp[f"int8_out{k}"] for k in range(3)]
        jax_prog = TFLiteProgram(FIXTURE / "flagship-int8.tflite", device="cpu")
        order = [jax_prog.output_names.index(f"StatefulPartitionedCall:{k}") for k in range(3)]
        jax_err = np.mean([np.abs(jax_heads[o] - b).mean() for o, b in zip(order, f32)])
        assert err <= 1.5 * jax_err, (err, jax_err)


def test_port_int8_ops_within_a_step(tmp_path):
    """The flagship at width 0.5 (64 px): every int8 op of the port's int8
    artifact within one output step of its float op on its own dequantized
    operands (`chip_smoke.int8_op_errors`, which the card runs at full
    width), and its heads within 5% of f32 and within
    `chip_smoke.TFLITE_INT8_NOISE` times the error of the float program
    with 8-bit rounding as noise."""
    import chip_smoke

    m = _zoo(FLAGSHIP, 0.5)()
    rng = np.random.default_rng(9)
    x, *calib = (rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8) for _ in range(3))
    prog = TFLiteProgram(export_tflite_int8(m, 64, 1, calib, tmp_path / "f-int8.tflite"),
                         device="cpu")
    env = prog.run(x, keep_all=True)
    xt = torch.as_tensor(x)
    fprog = TFLiteProgram(translate(RawProgram(m), xt.float(), input_type=T.TYPE_OF[
        np.dtype(np.float32)], raw=True), device="cpu")
    errs = chip_smoke.int8_op_errors(fprog, prog, env)
    assert sum(e["tensors"] for e in errs.values()) > 200
    assert max(e["max_steps"] for e in errs.values()) <= chip_smoke.TFLITE_INT8_OP_STEPS, errs
    with torch.no_grad():
        f32 = RawProgram(m)(xt.float() / 255.0)
    noise = chip_smoke.int8_noise_heads(fprog, prog, env, xt, 24)
    for o, r, n in zip(prog.outputs, f32, noise):
        rel = float((env[o] - r).abs().mean() / r.abs().mean())
        assert rel < 0.05
        assert rel <= chip_smoke.TFLITE_INT8_NOISE * float((n - r).abs().mean() / r.abs().mean())


def test_decode_raw_matches_jax():
    from dmayolo_tpu.cli.backends import decode_raw_np

    rng = np.random.default_rng(3)
    meta = {"strides": [8, 16, 32], "anchors_px": rng.uniform(5, 300, (3, 3, 2)).tolist()}
    raws = [rng.normal(0, 2, (2, s, s, 3, 9)).astype(np.float32) for s in (16, 8, 4)]
    got = pbackends.decode_raw([torch.as_tensor(r) for r in raws], meta).numpy()
    assert_close(got, decode_raw_np(raws, meta), tol=1e-6)


def test_cli_export_to_detect(tmp_path):
    """`cli.export --include tflite --int8` then `cli.detect` on both
    artifacts (3 images through a batch-2 artifact: chunked and padded):
    the f32 artifact's labels equal the native model's."""
    from dmayolo_tpu_torch.data.imageio import imwrite
    from tests.test_torch_tools import assert_same_labels, read_labels

    (tmp_path / "w.npz").write_bytes((FIXTURE / "flagship.npz").read_bytes())
    src = tmp_path / "images"
    src.mkdir()
    rng = np.random.default_rng(5)
    for i in range(3):
        imwrite(src / f"{i}.png", rng.integers(0, 256, (100, 120, 3), dtype=np.uint8))
    outs = pexport.main(["--weights", str(tmp_path / "w.npz"), "--include", "tflite", "--int8",
                         "--imgsz", "64", "--batch-size", "2", "--device", "cpu"])
    assert [o.name for o in outs] == ["w.tflite", "w-int8.tflite"]
    labels = {}
    for tag, w in (("native", tmp_path / "w.npz"), ("f32", outs[0]), ("int8", outs[1])):
        run = pdetect.main(["--weights", str(w), "--source", str(src), "--imgsz", "64",
                            "--conf-thres", "0.01", "--device", "cpu", "--fp32", "--save-txt",
                            "--save-conf", "--nosave", "--project", str(tmp_path), "--name", tag])
        labels[tag] = read_labels(run / "labels")
    assert len(labels["int8"]) == 3
    assert_same_labels(labels["f32"], labels["native"], tol=1e-4)


# ------------------------------------------------------------ the fixture


def write_fixture(dest=FIXTURE):
    """The JAX package's artifacts of the small flagship (width 0.0625,
    depth 0.33, nc 3) at 128 px, from numpy-drawn weights, and
    `expected.npz`: the input and the reference's outputs (the int8
    artifact's through `reference_run`)."""
    import shutil

    import jax

    from dmayolo_tpu.cli import export as jexport
    from dmayolo_tpu.graph import DetectionModel as JaxModel
    from dmayolo_tpu.utils.checkpoint import save_checkpoint
    from dmayolo_tpu_torch.graph import model_config
    from tests.test_torch_model import random_vars

    jax.config.update("jax_platforms", "cpu")
    cfg = yaml.safe_load(open(model_config(FLAGSHIP)))
    cfg.update(depth_multiple=0.33, width_multiple=0.0625, nc=3)
    params, stats = random_vars(JaxModel(cfg), seed=5)
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    save_checkpoint(dest / "flagship.npz", params=params, stats=stats,
                    meta={"cfg": cfg, "nc": 3})
    jexport.main(["--weights", str(dest / "flagship.npz"), "--imgsz", str(IMGSZ), "--include",
                  "tflite", "--int8", "--fp32", "--device", "cpu"])
    x = np.random.default_rng(11).integers(0, 256, (1, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    exp = {"x": x, "f32_out": tflite_outputs(dest / "flagship.tflite", x)[0]}
    path8 = dest / "flagship-int8.tflite"
    env = reference_run(path8, x)
    for k, o in enumerate(T.read_model(path8).subgraphs[0].outputs):
        exp[f"int8_out{k}"] = env[o]
    np.savez_compressed(dest / "expected.npz", **exp)


if __name__ == "__main__":
    write_fixture()
    print(sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file()), "bytes in", FIXTURE)
