"""Write TFLite artifacts of the port's model, without TensorFlow.

`export_tflite` translates the `torch.export` program of
`cli/export.py::InferenceProgram` at f32 (uint8 NHWC in, the decoded
predictions out), after `run_decompositions()` to the core ATen op set,
into TFLite builtin ops, as jax2tf does from the jaxpr: from the graph,
not module by module.  Nodes whose inputs are all constants (the weights,
the bias views, the decode's grids) are evaluated at export.  Each value
carries its layout: the port is NCHW-logical and TFLite NHWC, so a value
is stored as `perm` of its logical dims; a permute only changes the
layout and emits nothing, and a TRANSPOSE is emitted only where an op
needs another layout.  A conv followed by its bias add becomes one
CONV_2D; a symmetric pad that TFLite's SAME (odd pixel at the end) or
VALID does not express becomes PAD + VALID; x * clamp(x + 3, 0, 6) / 6
becomes HARD_SWISH; a mean over H and/or W becomes AVERAGE_POOL_2D.

`export_tflite_int8` writes the raw-head program (uint8 in, the per-scale
raw heads (B, ny, nx, na, no) out, dequantized to f32; decode runs at
load from the sidecar, as in the JAX package) fully quantized to the
TFLite 8-bit spec: the f32 translation runs over the calibration batches
through `TFLiteProgram` to take each tensor's min and max; activations
become asymmetric int8 per tensor (the range widened to hold 0), conv
weights symmetric int8 per output channel in [-127, 127], biases int32
at s_in * s_w[c]; LOGISTIC's output is fixed at (1/256, -128); the ops
that move values without arithmetic (pools, reshapes, slices, pads, the
resize, concatenation) share one (scale, zero point) across their inputs
and output, a requantizing QUANTIZE put in front of an input that cannot
share (a LOGISTIC output).  The uint8 input carries (1/255, 0), which is
the program's x / 255, and one QUANTIZE moves it to int8.  Ops without an
integer form in `cli/tflite_run.py` (the transformer blocks' matmuls,
softmax, layer norm, GELU) stay f32 between a DEQUANTIZE and a QUANTIZE.

An ATen op outside `HANDLERS` raises naming the op.
"""
from __future__ import annotations

import operator
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..utils import tflite as T
from .tflite_run import same_pads

aten = torch.ops.aten
F32, U8, I8 = 0, 3, 9  # TensorType
NHWC = (0, 2, 3, 1)
# op versions other than 1 that TFLite's op resolver asks for: (f32, int8)
VERSIONS = {"BROADCAST_TO": (2, 3), "CONV_2D": (1, 3), "DEPTHWISE_CONV_2D": (1, 3)}


class V:
    """A translated value: a TFLite tensor `idx` holding the logical
    `shape` laid out as `perm` (physical dim i = logical dim perm[i]), or a
    constant (`const`, logical)."""

    __slots__ = ("idx", "shape", "perm", "const")

    def __init__(self, idx=None, shape=(), perm=None, const=None):
        self.idx, self.const = idx, const
        self.shape = tuple(const.shape) if const is not None else tuple(shape)
        self.perm = tuple(range(len(self.shape))) if perm is None else tuple(perm)

    @property
    def phys(self):
        return [self.shape[p] for p in self.perm]


def _inverse(p):
    inv = [0] * len(p)
    for i, v in enumerate(p):
        inv[v] = i
    return tuple(inv)


class Translator:
    """An exported program's graph -> a float TFLite `Model`."""

    def __init__(self, ep: torch.export.ExportedProgram, input_type: int = U8):
        self.ep = ep
        self.input_type = input_type
        self.tensors: List[T.Tensor] = []
        self.buffers: List[Optional[np.ndarray]] = [None]
        self.ops: List[T.Operator] = []
        self.env: Dict[str, object] = {}
        self.skip = set()
        self.node = None

    # -- tensors
    def tensor(self, phys, type_=F32, name="") -> int:
        self.tensors.append(T.Tensor([int(d) for d in phys], type_, 0, name))
        return len(self.tensors) - 1

    def const_tensor(self, arr: np.ndarray, name="") -> int:
        arr = np.ascontiguousarray(arr)
        self.buffers.append(arr.reshape(-1).view(np.uint8))
        self.tensors.append(T.Tensor(list(arr.shape), T.TYPE_OF[arr.dtype], len(self.buffers) - 1,
                                     name))
        return len(self.tensors) - 1

    def emit(self, op, inputs, out_phys, options=None) -> int:
        """One op of float output `out_phys`, named after the node."""
        out = self.tensor(out_phys, F32, self.node.name if self.node else op.lower())
        self.ops.append(T.Operator(op, list(inputs), [out], dict(options or {}),
                                   VERSIONS.get(op, (1, 1))[0]))
        return out

    def materialize(self, v: V, perm=None) -> int:
        """The value's tensor laid out as `perm` (default: as it is)."""
        perm = v.perm if perm is None else tuple(perm)
        if v.const is not None:
            return self.const_tensor(v.const.permute(perm).contiguous().numpy(),
                                     f"{self.node.name}_const" if self.node else "const")
        if perm == v.perm:
            return v.idx
        t = [v.perm.index(p) for p in perm]
        out_phys = [v.shape[p] for p in perm]
        if [d for d in v.phys if d != 1] == [d for d in out_phys if d != 1] and \
                [p for p in v.perm if v.shape[p] != 1] == [p for p in perm if v.shape[p] != 1]:
            return self.reshape(v.idx, out_phys)  # only size-1 dims move
        return self.emit("TRANSPOSE", [v.idx, self.const_tensor(np.array(t, np.int32))], out_phys)

    def reshape(self, idx, phys) -> int:
        return self.emit("RESHAPE", [idx, self.const_tensor(np.array(phys, np.int32))], phys)

    # -- the graph
    def translate(self, outputs_raw: bool = False) -> T.Model:
        gm = self.ep.graph_module
        sig = self.ep.graph_signature
        consts = {**self.ep.state_dict, **self.ep.constants}
        user_inputs = []
        for spec in sig.input_specs:
            if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT:
                user_inputs.append(spec.arg.name)
            else:
                self.env[spec.arg.name] = V(const=consts[spec.target].detach().cpu())
        self._fold_patterns(gm.graph)
        self._fold_constants(gm.graph)
        out_vals = None
        for node in gm.graph.nodes:
            self.node = node
            if node.op == "placeholder":
                if node.name in user_inputs:
                    shape = tuple(node.meta["val"].shape)
                    self.env[node.name] = V(self.tensor(shape, self.input_type, "images"), shape)
                continue
            if node.op == "output":
                out_vals = node.args[0]
                continue
            if node.name in self.skip or node.name in self.env:
                continue
            self.env[node.name] = self.call(node)
        outs = self._outputs(out_vals, outputs_raw)
        g = T.SubGraph(self.tensors, [0], outs, self.ops, "main")
        sigs = {"serving_default": ({"images": 0}, {self.tensors[o].name: o for o in outs})}
        return T.Model([g], self.buffers, "dmayolo_tpu_torch tflite_export", {}, sigs)

    def _outputs(self, out_vals, raw):
        flat = list(out_vals) if isinstance(out_vals, (list, tuple)) else [out_vals]
        if len(flat) == 1 and isinstance(flat[0], (list, tuple)):
            flat = list(flat[0])
        outs = []
        for k, n in enumerate(flat):
            v = self.env[n.name]
            idx = self.materialize(v, tuple(range(len(v.shape))))
            self.tensors[idx].name = f"raw_head:{k}" if raw else f"output:{k}"
            outs.append(idx)
        return outs

    def _fold_constants(self, graph):
        """Evaluate, before the translation, every node that does not
        depend on the input (the input is not in `env` yet): the weights'
        views, the decode's grids (a bias add that follows its conv reads
        one)."""
        for node in graph.nodes:
            if node.op != "call_function" or node.target in SKIPPED:
                continue
            if all(d.name in self.env for d in node.all_input_nodes):
                r = node.target(*_unwrap([self._arg(a) for a in node.args]),
                                **_unwrap({k: self._arg(a) for k, a in node.kwargs.items()}))
                self.env[node.name] = _wrap(r)

    def _fold_patterns(self, graph):
        """HARD_SWISH: div(mul(x, clamp(clamp(add(x, 3), 0), None, 6)), 6)
        with each inner node used once."""
        for node in graph.nodes:
            if node.op != "call_function" or node.target != aten.div.Tensor or node.args[1] != 6:
                continue
            mul = node.args[0]
            if not _is(mul, aten.mul.Tensor) or len(mul.users) != 1:
                continue
            x, c2 = mul.args
            if not _is(c2, aten.clamp.default) or len(c2.users) != 1 or \
                    tuple(c2.args[1:]) != (None, 6):
                c2, x = x, c2
            if not _is(c2, aten.clamp.default) or tuple(c2.args[1:]) != (None, 6):
                continue
            c1 = c2.args[0]
            if not _is(c1, aten.clamp.default) or len(c1.users) != 1 or tuple(c1.args[1:]) != (0,):
                continue
            add = c1.args[0]
            if not _is(add, aten.add.Tensor) or len(add.users) != 1 or add.args != (x, 3):
                continue
            self.skip |= {mul.name, c2.name, c1.name, add.name}
            node.meta["tflite_hard_swish"] = x

    def call(self, node):
        tgt = node.target
        if tgt in SKIPPED:
            return None
        if "tflite_hard_swish" in node.meta:
            x = self.env[node.meta["tflite_hard_swish"].name]
            return V(self.emit("HARD_SWISH", [x.idx], x.phys), x.shape, x.perm)
        args = [self._arg(a) for a in node.args]
        kwargs = {k: self._arg(a) for k, a in node.kwargs.items()}
        if tgt is operator.getitem:
            return args[0][args[1]]
        handler = HANDLERS.get(tgt)
        if handler is None:
            raise NotImplementedError(f"tflite export: no TFLite mapping for ATen op {tgt} "
                                      f"(node {node.name})")
        return handler(self, node, *args, **kwargs)

    def _arg(self, a):
        if isinstance(a, torch.fx.Node):
            return self.env[a.name]
        if isinstance(a, (list, tuple)):
            return type(a)(self._arg(x) for x in a)
        return a

    # -- shared helpers of the handlers
    def same_layout(self, vals: Sequence[V]):
        """Tensors of the values in one layout of the highest rank: the
        first activation's where it has that rank, else identity."""
        rank = max(len(v.shape) for v in vals)
        acts = [v for v in vals if v.const is None and len(v.shape) == rank]
        perm = acts[0].perm if acts else tuple(range(rank))
        idxs = []
        for v in vals:
            if len(v.shape) < rank:
                v = self.unsqueeze_front(v, rank)
            idxs.append(self.materialize(v, perm))
        return idxs, perm

    def unsqueeze_front(self, v: V, rank: int) -> V:
        k = rank - len(v.shape)
        shape = (1,) * k + v.shape
        if v.const is not None:
            return V(const=v.const.reshape(shape))
        perm = tuple(range(k)) + tuple(p + k for p in v.perm)
        return V(self.reshape(v.idx, [shape[p] for p in perm]), shape, perm)

    def view(self, v: V, shape) -> V:
        shape = _resolve_shape(v.shape, shape)
        if v.const is not None:
            return V(const=v.const.reshape(shape))
        if [d for d in v.shape if d != 1] == [d for d in shape if d != 1] and \
                v.perm != tuple(range(len(v.shape))):
            # only size-1 dims come or go: keep the layout of the others
            old_dims = [i for i, d in enumerate(v.shape) if d != 1]
            new_dims = [i for i, d in enumerate(shape) if d != 1]
            remap = dict(zip(old_dims, new_dims))
            order = [remap[p] for p in v.perm if p in remap]
            ones = [i for i, d in enumerate(shape) if d == 1]
            perm = tuple(order + ones) if order else tuple(range(len(shape)))
            if sorted(perm) == list(range(len(shape))):
                return V(self.reshape(v.idx, [shape[p] for p in perm]), shape, perm)
        idx = self.materialize(v, tuple(range(len(v.shape))))
        return V(self.reshape(idx, list(shape)), shape)


def _is(n, target) -> bool:
    return isinstance(n, torch.fx.Node) and n.op == "call_function" and n.target == target


def _unwrap(a):
    if isinstance(a, V):
        return a.const
    if isinstance(a, (list, tuple)):
        return type(a)(_unwrap(x) for x in a)
    if isinstance(a, dict):
        return {k: _unwrap(x) for k, x in a.items()}
    return a


def _wrap(r):
    if torch.is_tensor(r):  # constants live on the host, whatever the program's device
        return V(const=r.detach().cpu())
    if isinstance(r, (list, tuple)):
        return type(r)(_wrap(x) for x in r)
    return r


def _resolve_shape(old, shape):
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([d for d in shape if d != -1]))
        shape[shape.index(-1)] = int(np.prod(old)) // known
    return tuple(int(d) for d in shape)


def _dim(d, rank):
    return d % rank


# ------------------------------------------------------------------ handlers

def _binary(op):
    def h(tr: Translator, node, a, b, alpha=1):
        if alpha != 1:
            raise NotImplementedError(f"tflite export: {node.target} with alpha {alpha}")
        vals = [x if isinstance(x, V) else V(const=torch.tensor(float(x))) for x in (a, b)]
        rank = max(len(v.shape) for v in vals)
        vals = [V(const=v.const.reshape((1,) * (rank - len(v.shape)) + v.shape).float())
                if v.const is not None else v for v in vals]
        shape = tuple(torch.broadcast_shapes(*(v.shape for v in vals)))
        idxs, perm = tr.same_layout(vals)
        return V(tr.emit(op, idxs, [shape[p] for p in perm]), shape, perm)
    return h


def _pow(tr, node, x, e):
    if e != 2:
        raise NotImplementedError(f"tflite export: pow with exponent {e}")
    return V(tr.emit("MUL", [x.idx, x.idx], x.phys), x.shape, x.perm)


def _unary(op, **options):
    def h(tr, node, x, *rest):
        return V(tr.emit(op, [x.idx], x.phys, options), x.shape, x.perm)
    return h


def _gelu(tr, node, x, approximate="none"):
    return V(tr.emit("GELU", [x.idx], x.phys, {"approximate": approximate == "tanh"}),
             x.shape, x.perm)


def _clamp(tr, node, x, lo=None, hi=None):
    idx = x.idx
    for op, bound in (("MAXIMUM", lo), ("MINIMUM", hi)):
        if bound is not None:
            c = tr.const_tensor(np.full([1] * len(x.shape), bound, np.float32))
            idx = tr.emit(op, [idx, c], x.phys)
    return V(idx, x.shape, x.perm)


def _identity(tr, node, x, *args, **kwargs):
    return x


def _to_copy(tr, node, x, dtype=None, **kwargs):
    if dtype in (None, torch.float32) and tr.tensors[x.idx].type == F32:
        return x
    if dtype != torch.float32:
        raise NotImplementedError(f"tflite export: a cast to {dtype}")
    return V(tr.emit("CAST", [x.idx], x.phys), x.shape, x.perm)


def _permute(tr, node, x, dims):
    dims = [_dim(d, len(x.shape)) for d in dims]
    inv = _inverse(dims)
    return V(x.idx, [x.shape[d] for d in dims], [inv[p] for p in x.perm])


def _view(tr, node, x, shape):
    return tr.view(x, shape)


def _unsqueeze(tr, node, x, dim):
    dim = _dim(dim, len(x.shape) + 1)
    return tr.view(x, x.shape[:dim] + (1,) + x.shape[dim:])


def _squeeze(tr, node, x, dims=None):
    rank = len(x.shape)
    dims = range(rank) if dims is None else [dims] if isinstance(dims, int) else dims
    drop = {_dim(d, rank) for d in dims if x.shape[_dim(d, rank)] == 1}
    return tr.view(x, tuple(d for i, d in enumerate(x.shape) if i not in drop))


def _expand(tr, node, x, shape):
    shape = tuple(int(x.shape[i - (len(shape) - len(x.shape))]) if d == -1 else int(d)
                  for i, d in enumerate(shape))
    if len(shape) > len(x.shape):
        x = tr.unsqueeze_front(x, len(shape))
    phys = [shape[p] for p in x.perm]
    return V(tr.emit("BROADCAST_TO", [x.idx, tr.const_tensor(np.array(phys, np.int32))], phys),
             shape, x.perm)


def _slice(tr, node, x, dim=0, start=None, end=None, step=1):
    rank = len(x.shape)
    dim = _dim(dim, rank)
    n = x.shape[dim]
    start = 0 if start is None else (start + n if start < 0 else min(start, n))
    end = n if end is None else (end + n if end < 0 else min(end, n))
    shape = list(x.shape)
    shape[dim] = len(range(start, end, step))
    pd = x.perm.index(dim)
    begin = [0] * rank
    begin[pd] = start
    phys = [shape[p] for p in x.perm]
    if step == 1:
        out = tr.emit("SLICE", [x.idx, tr.const_tensor(np.array(begin, np.int32)),
                                tr.const_tensor(np.array(phys, np.int32))], phys)
    else:
        ends = list(x.phys)
        ends[pd] = end
        strides = [1] * rank
        strides[pd] = step
        out = tr.emit("STRIDED_SLICE", [x.idx] + [tr.const_tensor(np.array(a, np.int32))
                                                  for a in (begin, ends, strides)], phys)
    return V(out, shape, x.perm)


def _select(tr, node, x, dim, index):
    dim = _dim(dim, len(x.shape))
    index = index % x.shape[dim]
    s = _slice(tr, node, x, dim, index, index + 1)
    return tr.view(s, s.shape[:dim] + s.shape[dim + 1:])


def _split(tr, node, x, sizes, dim=0):
    out, start = [], 0
    for n in sizes:
        out.append(_slice(tr, node, x, dim, start, start + n))
        start += n
    return out


def _cat(tr, node, xs, dim=0):
    rank = max(len(v.shape) for v in xs)
    dim = _dim(dim, rank)
    idxs, perm = tr.same_layout(list(xs))
    shape = list(xs[0].shape)
    shape[dim] = sum(v.shape[dim] for v in xs)
    return V(tr.emit("CONCATENATION", idxs, [shape[p] for p in perm],
                     {"axis": perm.index(dim)}), shape, perm)


def _nhwc(tr, x: V) -> int:
    if len(x.shape) != 4:
        raise NotImplementedError(f"tflite export: a 2-D op on a rank-{len(x.shape)} value")
    return tr.materialize(x, NHWC)


def _same_or_valid(h, w, k, s, d, p):
    """The TFLite padding that equals a symmetric pad p, or None."""
    if p == (0, 0):
        return "VALID"
    pads = same_pads(h, k[0], s[0], d[0]), same_pads(w, k[1], s[1], d[1])
    if pads == ((p[0], p[0]), (p[1], p[1])):
        return "SAME"
    return None


def _conv(tr, node, x, w, b, stride, padding, dilation, transposed, out_pad, groups):
    if transposed or w.const is None:
        raise NotImplementedError("tflite export: a transposed conv or a conv of a "
                                  "non-constant filter")
    if len(x.shape) != 4:
        raise NotImplementedError(f"tflite export: a conv on a rank-{len(x.shape)} value")
    bsz, c_in, h, wd = x.shape
    wt = w.const.float()
    c_out, _, kh, kw = wt.shape
    bias = None if b is None else b.const.float()
    # the bias add that follows (y + bias[None, :, None, None]) folds in
    users = list(node.users)
    folded = None
    if bias is None and len(users) == 1 and _is(users[0], aten.add.Tensor):
        other = [a for a in users[0].args if a is not node]
        ov = tr.env.get(other[0].name) if other and isinstance(other[0], torch.fx.Node) else None
        if ov is not None and ov.const is not None and ov.const.numel() == c_out and \
                tuple(ov.const.shape[-3:]) == (c_out, 1, 1):
            bias = ov.const.reshape(c_out).float()
            folded = users[0].name
            tr.skip.add(folded)
    padding, stride, dilation = tuple(padding), tuple(stride), tuple(dilation)
    mode = _same_or_valid(h, wd, (kh, kw), stride, dilation, padding)
    xi = _nhwc(tr, x)
    if mode is None:
        ph, pw = padding
        pads = np.array([[0, 0], [ph, ph], [pw, pw], [0, 0]], np.int32)
        h, wd = h + 2 * ph, wd + 2 * pw
        xi = tr.emit("PAD", [xi, tr.const_tensor(pads)], [bsz, h, wd, c_in])
        mode = "VALID"
    ho = (h + (2 * padding[0] if mode == "SAME" else 0) - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (wd + (2 * padding[1] if mode == "SAME" else 0) - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    opts = {"padding": T.PADDING[mode], "stride_h": stride[0], "stride_w": stride[1],
            "dilation_h_factor": dilation[0], "dilation_w_factor": dilation[1]}
    bias_i = tr.const_tensor((bias if bias is not None else torch.zeros(c_out)).numpy()
                             .astype(np.float32))
    if groups > 1 and groups == c_in and wt.shape[1] == 1:
        wi = tr.const_tensor(wt.permute(1, 2, 3, 0).contiguous().numpy())  # 1HWO
        opts["depth_multiplier"] = c_out // c_in
        out = tr.emit("DEPTHWISE_CONV_2D", [xi, wi, bias_i], [bsz, ho, wo, c_out], opts)
    else:
        wi = tr.const_tensor(wt.permute(0, 2, 3, 1).contiguous().numpy())  # OHWI
        out = tr.emit("CONV_2D", [xi, wi, bias_i], [bsz, ho, wo, c_out], opts)
    v = V(out, (bsz, c_out, ho, wo), NHWC)
    if folded:
        tr.env[folded] = v
    return v


def _pool2d(tr, node, op, x, k, s, padding, ceil_mode=False):
    k = tuple(k) if len(k) == 2 else (k[0], k[0])
    s = tuple(s) if s and len(s) == 2 else (tuple(s) * 2 if s else k)
    padding = tuple(padding) if len(padding) == 2 else tuple(padding) * 2
    if ceil_mode:
        raise NotImplementedError("tflite export: a pool with ceil_mode")
    bsz, c, h, w = x.shape
    mode = _same_or_valid(h, w, k, s, (1, 1), padding)
    if mode is None or (mode == "SAME" and op == "AVERAGE_POOL_2D"):
        raise NotImplementedError(f"tflite export: {op} with padding {padding}")
    ho = (h + 2 * padding[0] - k[0]) // s[0] + 1
    wo = (w + 2 * padding[1] - k[1]) // s[1] + 1
    out = tr.emit(op, [_nhwc(tr, x)], [bsz, ho, wo, c],
                  {"padding": T.PADDING[mode], "stride_h": s[0], "stride_w": s[1],
                   "filter_height": k[0], "filter_width": k[1]})
    return V(out, (bsz, c, ho, wo), NHWC)


def _avg_pool(tr, node, x, k, s=(), padding=(0, 0), ceil_mode=False, count_include_pad=True,
              divisor_override=None):
    if divisor_override is not None:
        raise NotImplementedError("tflite export: avg_pool2d with divisor_override")
    return _pool2d(tr, node, "AVERAGE_POOL_2D", x, k, s, padding, ceil_mode)


def _max_pool(tr, node, x, k, s=(), padding=(0, 0), dilation=(1, 1), ceil_mode=False):
    if tuple(dilation) not in ((1, 1), (1,)):
        raise NotImplementedError("tflite export: a dilated max pool")
    v = _pool2d(tr, node, "MAX_POOL_2D", x, k, s, padding, ceil_mode)
    return (v, None)


def _reduce(op):
    def h(tr, node, x, dims=None, keepdim=False, dtype=None):
        rank = len(x.shape)
        dims = sorted({_dim(d, rank) for d in (range(rank) if dims is None else dims)})
        if op == "MEAN" and keepdim and rank == 4 and set(dims) <= {2, 3}:
            # a spatial mean: the pool over the whole of those dims
            kh = x.shape[2] if 2 in dims else 1
            kw = x.shape[3] if 3 in dims else 1
            return _pool2d(tr, node, "AVERAGE_POOL_2D", x, (kh, kw), (kh, kw), (0, 0))
        axes = np.array([x.perm.index(d) for d in dims], np.int32)
        shape = [1 if i in dims else d for i, d in enumerate(x.shape)]
        if keepdim:
            perm = x.perm
        else:
            kept = [p for p in x.perm if p not in dims]
            remap = {d: i for i, d in enumerate(i for i in range(rank) if i not in dims)}
            perm = tuple(remap[p] for p in kept)
            shape = [d for i, d in enumerate(x.shape) if i not in dims]
        out = tr.emit(op, [x.idx, tr.const_tensor(axes)], [shape[p] for p in perm],
                      {"keep_dims": bool(keepdim)})
        return V(out, shape, perm)
    return h


def _index(tr, node, x, indices):
    """x[..., idx, ...] with one constant 1-D index: GATHER on that dim."""
    dims = [d for d, i in enumerate(indices) if i is not None]
    if len(dims) != 1 or indices[dims[0]].const is None or indices[dims[0]].const.dim() != 1:
        raise NotImplementedError("tflite export: aten.index.Tensor other than one constant "
                                  "1-D index")
    d = dims[0]
    idx = indices[d].const.to(torch.int32).numpy()
    shape = list(x.shape)
    shape[d] = len(idx)
    out = tr.emit("GATHER", [x.idx, tr.const_tensor(idx)], [shape[p] for p in x.perm],
                  {"axis": x.perm.index(d)})
    return V(out, shape, x.perm)


def _upsample_nearest(tr, node, x, output_size, scale_factors=None):
    bsz, c, h, w = x.shape
    if output_size is not None:
        ho, wo = output_size
    else:
        ho, wo = int(h * scale_factors[0]), int(w * scale_factors[1])
    out = tr.emit("RESIZE_NEAREST_NEIGHBOR",
                  [_nhwc(tr, x), tr.const_tensor(np.array([ho, wo], np.int32))],
                  [bsz, ho, wo, c], {"align_corners": False, "half_pixel_centers": False})
    return V(out, (bsz, c, ho, wo), NHWC)


def _constant_pad(tr, node, x, pad, value=0.0):
    if value != 0:
        raise NotImplementedError(f"tflite export: constant_pad_nd with value {value}")
    rank = len(x.shape)
    pads = np.zeros((rank, 2), np.int32)
    for i in range(len(pad) // 2):
        pads[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    if (pads < 0).any():
        raise NotImplementedError("tflite export: a negative pad")
    shape = [d + int(pads[i].sum()) for i, d in enumerate(x.shape)]
    out = tr.emit("PAD", [x.idx, tr.const_tensor(pads[list(x.perm)])], [shape[p] for p in x.perm])
    return V(out, shape, x.perm)


def _softmax(tr, node, x, dim, half_to_float=False):
    dim = _dim(dim, len(x.shape))
    perm = tuple(p for p in x.perm if p != dim) + (dim,)
    idx = tr.materialize(x, perm)
    return V(tr.emit("SOFTMAX", [idx], [x.shape[p] for p in perm], {"beta": 1.0}), x.shape, perm)


def _layer_norm(tr, node, x, normalized_shape, w, b, eps):
    """(x - mean) * rsqrt(var + eps) * w + b over the last dims."""
    rank, k = len(x.shape), len(normalized_shape)
    ident = tuple(range(rank))
    xi = tr.materialize(x, ident)
    phys = list(x.shape)
    axes = tr.const_tensor(np.arange(rank - k, rank, dtype=np.int32))
    red = phys[:rank - k] + [1] * k
    mean = tr.emit("MEAN", [xi, axes], red, {"keep_dims": True})
    d = tr.emit("SUB", [xi, mean], phys)
    var = tr.emit("MEAN", [tr.emit("MUL", [d, d], phys), axes], red, {"keep_dims": True})
    eps_i = tr.const_tensor(np.full([1] * rank, eps, np.float32))
    inv = tr.emit("RSQRT", [tr.emit("ADD", [var, eps_i], red)], red)
    y = tr.emit("MUL", [d, inv], phys)
    if w is not None:
        y = tr.emit("MUL", [y, tr.const_tensor(w.const.float().reshape(
            [1] * (rank - k) + list(normalized_shape)).numpy())], phys)
    if b is not None:
        y = tr.emit("ADD", [y, tr.const_tensor(b.const.float().reshape(
            [1] * (rank - k) + list(normalized_shape)).numpy())], phys)
    return (V(y, x.shape), None, None)


def _mm(tr, node, a, b):
    if b.const is not None and len(a.shape) == 2:
        w = tr.const_tensor(b.const.float().t().contiguous().numpy())
        ai = tr.materialize(a, (0, 1))
        out = tr.emit("FULLY_CONNECTED", [ai, w, -1], [a.shape[0], b.shape[1]],
                      {"keep_num_dims": True})
        return V(out, (a.shape[0], b.shape[1]))
    return _bmm(tr, node, a, b)


def _addmm(tr, node, bias, a, b, beta=1, alpha=1):
    if beta != 1 or alpha != 1 or b.const is None or bias.const is None:
        raise NotImplementedError("tflite export: addmm other than x @ W + b")
    w = tr.const_tensor(b.const.float().t().contiguous().numpy())
    bi = tr.const_tensor(bias.const.float().reshape(-1).numpy())
    out = tr.emit("FULLY_CONNECTED", [tr.materialize(a, (0, 1)), w, bi],
                  [a.shape[0], b.shape[1]], {"keep_num_dims": True})
    return V(out, (a.shape[0], b.shape[1]))


def _bmm(tr, node, a, b):
    rank = len(a.shape)
    ident = tuple(range(rank))
    shape = tuple(a.shape[:-1]) + (b.shape[-1],)
    out = tr.emit("BATCH_MATMUL", [tr.materialize(a, ident), tr.materialize(b, ident)],
                  list(shape))
    return V(out, shape)


HANDLERS = {
    aten.add.Tensor: _binary("ADD"), aten.sub.Tensor: _binary("SUB"),
    aten.mul.Tensor: _binary("MUL"), aten.div.Tensor: _binary("DIV"),
    aten.add.Scalar: _binary("ADD"), aten.sub.Scalar: _binary("SUB"),
    aten.mul.Scalar: _binary("MUL"), aten.div.Scalar: _binary("DIV"),
    aten.pow.Tensor_Scalar: _pow,
    aten.sigmoid.default: _unary("LOGISTIC"), aten.hardswish.default: _unary("HARD_SWISH"),
    aten.relu.default: _unary("RELU"),
    aten.rsqrt.default: _unary("RSQRT"), aten.gelu.default: _gelu, aten.clamp.default: _clamp,
    aten._to_copy.default: _to_copy, aten.clone.default: _identity,
    aten.alias.default: _identity, aten.contiguous.default: _identity,
    aten.permute.default: _permute, aten.view.default: _view, aten.reshape.default: _view,
    aten._unsafe_view.default: _view, aten.unsqueeze.default: _unsqueeze,
    aten.squeeze.dim: _squeeze, aten.squeeze.dims: _squeeze, aten.squeeze.default: _squeeze,
    aten.expand.default: _expand, aten.slice.Tensor: _slice, aten.select.int: _select,
    aten.split_with_sizes.default: _split, aten.cat.default: _cat,
    aten.convolution.default: _conv, aten.avg_pool2d.default: _avg_pool,
    aten.max_pool2d_with_indices.default: _max_pool, aten.mean.dim: _reduce("MEAN"),
    aten.sum.dim_IntList: _reduce("SUM"), aten.upsample_nearest2d.vec: _upsample_nearest,
    aten.constant_pad_nd.default: _constant_pad, aten._softmax.default: _softmax,
    aten.native_layer_norm.default: _layer_norm, aten.mm.default: _mm,
    aten.addmm.default: _addmm, aten.bmm.default: _bmm, aten.index.Tensor: _index,
}
SKIPPED = {aten._assert_tensor_metadata.default}


# ------------------------------------------------------------------ programs

class RawProgram(nn.Module):
    """The int8 artifact's program: f32 NHWC in [0, 1] -> the raw heads."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return tuple(self.model.apply(x, dtype=torch.float32, fused=True))


def translate(program: nn.Module, example: torch.Tensor, input_type=U8, raw=False) -> T.Model:
    with torch.no_grad():
        # one real call first: blocks that cache tables at their first call
        # (the attention's position bias) must not cache export's fake tensors
        program.eval()(example)
        ep = torch.export.export(program, (example,)).run_decompositions()
    return Translator(ep, input_type).translate(outputs_raw=raw)


def export_tflite(model, imgsz: int, batch: int, path) -> Path:
    """The f32 artifact of `cli/export.py::InferenceProgram` (BN-folded
    `model`) at a static (batch, imgsz), traced on the model's device."""
    from .export import InferenceProgram

    dev = next(model.parameters()).device
    x = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.uint8, device=dev)
    tfl = translate(InferenceProgram(model, torch.float32), x)
    T.write_model(tfl, path)
    return Path(path)


# ------------------------------------------------------------ quantization

# ops that move values without arithmetic: their inputs and output share one
# (scale, zero point)
SHARED = {"RESHAPE", "TRANSPOSE", "SLICE", "STRIDED_SLICE", "BROADCAST_TO", "PAD",
          "MAX_POOL_2D", "AVERAGE_POOL_2D", "RESIZE_NEAREST_NEIGHBOR", "CONCATENATION"}
INT8_OPS = SHARED | {"CONV_2D", "DEPTHWISE_CONV_2D", "ADD", "SUB", "MUL", "LOGISTIC",
                     "HARD_SWISH", "RELU"}
LOGISTIC_Q = (1.0 / 256.0, -128)
# the smallest activation scale: below it a rescale's multiplier leaves the
# range QuantizeMultiplier takes (TFLite aborts on such a model)
MIN_SCALE = 1e-6


def act_params(lo: float, hi: float):
    """Asymmetric int8 (scale, zero point) of a range widened to hold 0."""
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    if hi - lo < 255.0 * MIN_SCALE:  # a range that is (nearly) one value
        return MIN_SCALE, int(np.clip(np.round(-128 - lo / MIN_SCALE), -128, 127))
    scale = float(np.float32((hi - lo) / 255.0))
    zp = int(np.clip(np.round(-128 - lo / scale), -128, 127))
    return scale, zp


def _q(scale, zp, dim=0):
    return T.Quantization(np.asarray(np.atleast_1d(scale), np.float32),
                          np.asarray(np.atleast_1d(zp), np.int64), dim)


def quantize_model(fm: T.Model, ranges: Dict[int, tuple]) -> T.Model:
    """The float raw-head model `fm` (f32 input in [0, 1]) with the
    calibrated (min, max) of each activation -> the int8 model."""
    g = fm.subgraphs[0]
    tensors = [T.Tensor(list(t.shape), t.type, t.buffer, t.name) for t in g.tensors]
    buffers = list(fm.buffers)
    ops: List[T.Operator] = []
    is_const = {i for i, t in enumerate(tensors) if fm.constant(t) is not None}
    producer = {op.outputs[0]: op for op in g.operators}

    def new_tensor(like: int, type_, name):
        t = tensors[like]
        tensors.append(T.Tensor(list(t.shape), type_, 0, name))
        return len(tensors) - 1

    def const(arr, name, quant=None):
        arr = np.ascontiguousarray(arr)
        buffers.append(arr.reshape(-1).view(np.uint8))
        tensors.append(T.Tensor(list(arr.shape), T.TYPE_OF[arr.dtype], len(buffers) - 1, name,
                                quant))
        return len(tensors) - 1

    # 1. which float activations are int8, and their params: each its own
    # calibrated range; LOGISTIC's output and the input fixed
    int8_ops = [op for op in g.operators if op.op in INT8_OPS]
    acts = {i for op in int8_ops for i in op.inputs + op.outputs
            if i >= 0 and i not in is_const and tensors[i].type == F32}
    acts |= {g.inputs[0]}
    fixed = {op.outputs[0]: LOGISTIC_Q for op in g.operators if op.op == "LOGISTIC"}
    fixed[g.inputs[0]] = (1.0 / 255.0, -128)
    params = {i: fixed.get(i) or act_params(*ranges.get(i, (0.0, 0.0))) for i in acts}
    readers = {}
    for op in g.operators:
        for i in op.inputs:
            readers[i] = readers.get(i, 0) + 1

    def adopt(i, q) -> bool:
        """Give tensor i the params q where nothing else reads it and its
        producer can write any params (or passes its input's on, which can
        adopt them in turn)."""
        op = producer.get(i)
        if op is None or i in fixed or readers.get(i) != 1:
            return False
        if op.op in SHARED and (op.op == "CONCATENATION" or not adopt(op.inputs[0], q)):
            return False
        params[i] = q
        return True

    # 2. in graph order, forward only: a one-input op of `SHARED` passes its
    # input's params on; a concatenation keeps its own and each input that
    # differs adopts them or is requantized in front of it (an input pulled
    # to the union of the inputs' ranges loses precision that other readers
    # of it would share)
    requant = {}  # (op index, input position) -> the input, requantized for the op
    for k, op in enumerate(g.operators):
        if op.op not in SHARED or op.inputs[0] in is_const:
            continue
        out = op.outputs[0]
        if op.op != "CONCATENATION":
            params[out] = params[op.inputs[0]]
            continue
        for pos, i in enumerate(op.inputs):
            if params[i] != params[out] and not adopt(i, params[out]):
                requant[(k, pos)] = i

    # 3. the input: uint8 carrying x / 255, moved to int8
    x_in = g.inputs[0]
    u8 = new_tensor(x_in, U8, "images")
    tensors[u8].quantization = _q(1.0 / 255.0, 0)
    tensors[x_in].type, tensors[x_in].quantization = I8, _q(*params[x_in])
    ops.append(T.Operator("QUANTIZE", [u8], [x_in]))
    for i in acts - {x_in}:
        tensors[i].type, tensors[i].quantization = I8, _q(*params[i])

    as_f32: Dict[int, int] = {}  # int8 tensor -> a dequantized copy

    def f32_of(i):
        if tensors[i].type != I8:
            return i
        if i not in as_f32:
            as_f32[i] = new_tensor(i, F32, tensors[i].name + "_f32")
            ops.append(T.Operator("DEQUANTIZE", [i], [as_f32[i]]))
        return as_f32[i]

    for k, op in enumerate(g.operators):
        if op.op not in INT8_OPS:
            # stays f32: int8 inputs dequantized, outputs quantized where an
            # int8 op reads them
            ins = [f32_of(i) if i >= 0 else i for i in op.inputs]
            out = op.outputs[0]
            if out in acts:
                f_out = new_tensor(out, F32, tensors[out].name + "_f32")
                ops.append(T.Operator(op.op, ins, [f_out], dict(op.options), op.version))
                ops.append(T.Operator("QUANTIZE", [f_out], [out]))
                as_f32[out] = f_out
            else:
                ops.append(T.Operator(op.op, ins, op.outputs, dict(op.options), op.version))
            continue
        ins = list(op.inputs)
        if op.op in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            w = fm.constant(g.tensors[ins[1]]).astype(np.float64)
            b = fm.constant(g.tensors[ins[2]]).astype(np.float64)
            axis = 0 if op.op == "CONV_2D" else 3
            red = tuple(a for a in range(4) if a != axis)
            s_in = params[ins[0]][0]
            # a channel whose int32 bias (at s_in * s_w) would overflow takes a
            # coarser weight scale
            s_w = np.maximum(np.abs(w).max(axis=red) / 127.0,
                             np.abs(b) / (np.float64(s_in) * (2**31 - 2**24)))
            s_w = np.maximum(s_w, 1e-12).astype(np.float32)
            shape = [1, 1, 1, 1]
            shape[axis] = -1
            wq = np.clip(np.round(w / s_w.astype(np.float64).reshape(shape)), -127, 127)
            s_b = (np.float64(np.float32(s_in)) * s_w.astype(np.float64)).astype(np.float32)
            bq = np.round(b / s_b.astype(np.float64)).astype(np.int32)
            ins[1] = const(wq.astype(np.int8), g.tensors[ins[1]].name,
                           _q(s_w, np.zeros(len(s_w), np.int64), axis))
            ins[2] = const(bq, g.tensors[ins[2]].name, _q(s_b, np.zeros(len(s_b), np.int64)))
        else:
            for pos, i in enumerate(ins):
                if i < 0 or i in is_const and tensors[i].type != F32:
                    continue  # shapes, axes and pads stay int32
                if i in is_const:  # a float constant operand: per-tensor int8
                    c = fm.constant(g.tensors[i]).astype(np.float64)
                    s, z = act_params(c.min(), c.max())
                    q = np.clip(np.round(c / s) + z, -128, 127).astype(np.int8)
                    ins[pos] = const(q, g.tensors[i].name, _q(s, z))
                elif (k, pos) in requant:
                    src = requant[(k, pos)]
                    dst = new_tensor(src, I8, tensors[src].name + "_requant")
                    tensors[dst].quantization = _q(*params[op.outputs[0]])
                    ops.append(T.Operator("QUANTIZE", [src], [dst]))
                    ins[pos] = dst
        ops.append(T.Operator(op.op, ins, list(op.outputs), dict(op.options),
                              VERSIONS.get(op.op, (1, 1))[1]))
    # 4. the raw heads out, dequantized to f32
    outs = []
    for k, o in enumerate(g.outputs):
        f = new_tensor(o, F32, tensors[o].name)
        tensors[o].name = tensors[o].name + "_int8"
        ops.append(T.Operator("DEQUANTIZE", [o], [f]))
        outs.append(f)
    # the float weights, replaced by their int8 forms, lose their buffers
    read = {i for op in ops for i in op.inputs}
    for i, t in enumerate(tensors):
        if i not in read:
            t.buffer = 0
    used = sorted({t.buffer for t in tensors if t.buffer})
    remap = {b: i + 1 for i, b in enumerate(used)}
    for t in tensors:
        t.buffer = remap.get(t.buffer, 0)
    sub = T.SubGraph(tensors, [u8], outs, ops, "main")
    sigs = {"serving_default": ({"images": u8}, {tensors[o].name: o for o in outs})}
    return T.Model([sub], [None] + [buffers[b] for b in used],
                   "dmayolo_tpu_torch tflite_export int8", {}, sigs)


def calibrate(fm: T.Model, batches, device) -> Dict[int, tuple]:
    """(min, max) of every tensor of the float model over the batches
    (uint8 NHWC), run by `TFLiteProgram`."""
    from .tflite_run import TFLiteProgram

    prog = TFLiteProgram(fm, device=device)
    lo: Dict[int, float] = {}
    hi: Dict[int, float] = {}

    def observe(i, t):
        if t.is_floating_point():
            lo[i] = min(lo.get(i, np.inf), float(t.min()))
            hi[i] = max(hi.get(i, -np.inf), float(t.max()))

    for b in batches:
        x = torch.as_tensor(np.asarray(b), device=prog.device).float() / 255.0
        prog.run(x, observe=observe)
    return {i: (lo[i], hi[i]) for i in lo}


def export_tflite_int8(model, imgsz: int, batch: int, batches, path) -> Path:
    """The int8 artifact of the raw-head program, calibrated on `batches`
    (uint8 (batch, imgsz, imgsz, 3) arrays) on the model's device."""
    dev = next(model.parameters()).device
    x = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.float32, device=dev)
    fm = translate(RawProgram(model), x, input_type=F32, raw=True)
    T.write_model(quantize_model(fm, calibrate(fm, batches, dev)), path)
    return Path(path)
