"""TFLite model files, read and written without TensorFlow.

A `.tflite` file is a FlatBuffers buffer (`utils/flatbuf.py`) of the
schema `tensorflow/lite/schema/schema.fbs`, identifier "TFL3".  This
module holds the subset a detector's artifact uses, field ids as in
schema.fbs:

    Model        0 version, 1 operator_codes, 2 subgraphs, 3 description,
                 4 buffers, 5 metadata_buffer, 6 metadata, 7 signature_defs
    SubGraph     0 tensors, 1 inputs, 2 outputs, 3 operators, 4 name
    Tensor       0 shape, 1 type, 2 buffer, 3 name, 4 quantization,
                 5 is_variable, 7 shape_signature
    QuantizationParameters  0 min, 1 max, 2 scale, 3 zero_point,
                 6 quantized_dimension
    Operator     0 opcode_index, 1 inputs, 2 outputs, 3/4 builtin_options
                 (union type, table)
    OperatorCode 0 deprecated_builtin_code (i8), 1 custom_code, 2 version,
                 3 builtin_code (i32)
    Buffer       0 data (aligned to 16), 1 offset, 2 size
    Metadata     0 name, 1 buffer
    SignatureDef 0 inputs, 1 outputs, 2 signature_key, 4 subgraph_index
    TensorMap    0 name, 1 tensor_index

and the builtin option tables of the ops in `OPS`.  Two traps of the
format: an op code past 127 lives only in `builtin_code`, and converters
set `deprecated_builtin_code` to 127 (PLACEHOLDER_FOR_GREATER_OP_CODES)
there, so the reader takes the larger and the writer writes both; and a
model past 2 GB keeps its buffers after the FlatBuffers part of the file,
a `Buffer` then giving `offset`/`size` from the file's start.  The reader
takes both forms; the writer writes data inline (below 2 GB).

`read_model(path)` maps the file (numpy memmap): a buffer's data is a
view of it.  `write_model(model, path)` streams the buffers to the file.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from .flatbuf import Builder, Table

FILE_ID = b"TFL3"
SCHEMA_VERSION = 3

# TensorType -> numpy dtype
TENSOR_TYPES = {0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64, 6: np.bool_,
                7: np.int16, 9: np.int8, 10: np.float64}
TYPE_OF = {np.dtype(v): k for k, v in TENSOR_TYPES.items()}

# BuiltinOptions union members: name -> (union type, fields (id, name, kind, default))
OPTIONS = {
    "Conv2DOptions": (1, [(0, "padding", "i8", 0), (1, "stride_w", "i32", 0),
                          (2, "stride_h", "i32", 0), (3, "fused_activation_function", "i8", 0),
                          (4, "dilation_w_factor", "i32", 1), (5, "dilation_h_factor", "i32", 1),
                          (6, "quantized_bias_type", "i8", 0)]),
    "DepthwiseConv2DOptions": (2, [(0, "padding", "i8", 0), (1, "stride_w", "i32", 0),
                                   (2, "stride_h", "i32", 0), (3, "depth_multiplier", "i32", 0),
                                   (4, "fused_activation_function", "i8", 0),
                                   (5, "dilation_w_factor", "i32", 1),
                                   (6, "dilation_h_factor", "i32", 1)]),
    "Pool2DOptions": (5, [(0, "padding", "i8", 0), (1, "stride_w", "i32", 0),
                          (2, "stride_h", "i32", 0), (3, "filter_width", "i32", 0),
                          (4, "filter_height", "i32", 0),
                          (5, "fused_activation_function", "i8", 0)]),
    "FullyConnectedOptions": (8, [(0, "fused_activation_function", "i8", 0),
                                  (1, "weights_format", "i8", 0), (2, "keep_num_dims", "bool", False),
                                  (3, "asymmetric_quantize_inputs", "bool", False),
                                  (4, "quantized_bias_type", "i8", 0)]),
    "SoftmaxOptions": (9, [(0, "beta", "f32", 0.0)]),
    "ConcatenationOptions": (10, [(0, "axis", "i32", 0), (1, "fused_activation_function", "i8", 0)]),
    "AddOptions": (11, [(0, "fused_activation_function", "i8", 0),
                        (1, "pot_scale_int16", "bool", True)]),
    "ReshapeOptions": (17, []),  # new_shape: the writer passes the shape as an input
    "MulOptions": (21, [(0, "fused_activation_function", "i8", 0)]),
    "PadOptions": (22, []),
    "GatherOptions": (23, [(0, "axis", "i32", 0), (1, "batch_dims", "i32", 0)]),
    "TransposeOptions": (26, []),
    "ReducerOptions": (27, [(0, "keep_dims", "bool", False)]),
    "SubOptions": (28, [(0, "fused_activation_function", "i8", 0),
                        (1, "pot_scale_int16", "bool", True)]),
    "DivOptions": (29, [(0, "fused_activation_function", "i8", 0)]),
    "StridedSliceOptions": (32, [(0, "begin_mask", "i32", 0), (1, "end_mask", "i32", 0),
                                 (2, "ellipsis_mask", "i32", 0), (3, "new_axis_mask", "i32", 0),
                                 (4, "shrink_axis_mask", "i32", 0), (5, "offset", "bool", False)]),
    "CastOptions": (37, [(0, "in_data_type", "i8", 0), (1, "out_data_type", "i8", 0)]),
    "DequantizeOptions": (38, []),
    "MaximumMinimumOptions": (39, []),
    "SliceOptions": (48, []),
    "PowOptions": (56, []),
    "ResizeNearestNeighborOptions": (74, [(0, "align_corners", "bool", False),
                                          (1, "half_pixel_centers", "bool", False)]),
    "QuantizeOptions": (89, []),
    "HardSwishOptions": (91, []),
    "BatchMatMulOptions": (101, [(0, "adj_x", "bool", False), (1, "adj_y", "bool", False),
                                 (2, "asymmetric_quantize_inputs", "bool", False)]),
    "BroadcastToOptions": (104, []),
    "GeluOptions": (116, [(0, "approximate", "bool", False)]),
}
OPTIONS_BY_TYPE = {t: name for name, (t, _) in OPTIONS.items()}

# builtin ops: name -> (code, options table or None)
OPS = {
    "ADD": (0, "AddOptions"), "AVERAGE_POOL_2D": (1, "Pool2DOptions"),
    "CONCATENATION": (2, "ConcatenationOptions"), "CONV_2D": (3, "Conv2DOptions"),
    "DEPTHWISE_CONV_2D": (4, "DepthwiseConv2DOptions"), "DEQUANTIZE": (6, None),
    "FULLY_CONNECTED": (9, "FullyConnectedOptions"), "LOGISTIC": (14, None),
    "MAX_POOL_2D": (17, "Pool2DOptions"), "MUL": (18, "MulOptions"), "RELU": (19, None),
    "RESHAPE": (22, None),
    "SOFTMAX": (25, "SoftmaxOptions"), "PAD": (34, None), "GATHER": (36, "GatherOptions"),
    "TRANSPOSE": (39, None), "MEAN": (40, "ReducerOptions"), "SUB": (41, "SubOptions"),
    "DIV": (42, "DivOptions"), "STRIDED_SLICE": (45, "StridedSliceOptions"),
    "CAST": (53, None), "MAXIMUM": (55, None), "MINIMUM": (57, None),
    "SLICE": (65, None), "SUM": (74, "ReducerOptions"), "RSQRT": (76, None),
    "RESIZE_NEAREST_NEIGHBOR": (97, "ResizeNearestNeighborOptions"),
    "QUANTIZE": (114, None), "HARD_SWISH": (117, None),
    "BATCH_MATMUL": (126, "BatchMatMulOptions"), "BROADCAST_TO": (130, None),
    "GELU": (150, "GeluOptions"),
}
OP_NAMES = {code: name for name, (code, _) in OPS.items()}
PLACEHOLDER_FOR_GREATER_OP_CODES = 127
PADDING = {"SAME": 0, "VALID": 1}


@dataclasses.dataclass
class Quantization:
    scale: np.ndarray  # f32 (n,)
    zero_point: np.ndarray  # i64 (n,)
    quantized_dimension: int = 0


@dataclasses.dataclass
class Tensor:
    shape: List[int]
    type: int
    buffer: int = 0
    name: str = ""
    quantization: Optional[Quantization] = None

    @property
    def dtype(self):
        return np.dtype(TENSOR_TYPES[self.type])


@dataclasses.dataclass
class Operator:
    op: str  # builtin name (OPS), or "CUSTOM:<code>"/"BUILTIN_<n>" for what the subset lacks
    inputs: List[int]
    outputs: List[int]
    options: Dict[str, object] = dataclasses.field(default_factory=dict)
    version: int = 1


@dataclasses.dataclass
class SubGraph:
    tensors: List[Tensor]
    inputs: List[int]
    outputs: List[int]
    operators: List[Operator]
    name: str = "main"


@dataclasses.dataclass
class Model:
    subgraphs: List[SubGraph]
    buffers: List[Optional[np.ndarray]]  # uint8 data, None for an empty buffer
    description: str = ""
    metadata: Dict[str, int] = dataclasses.field(default_factory=dict)  # name -> buffer
    # signature key -> (input names -> tensor, output names -> tensor)
    signatures: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    version: int = SCHEMA_VERSION

    def constant(self, t: Tensor) -> Optional[np.ndarray]:
        """The tensor's data as an array of its type and shape, or None."""
        data = self.buffers[t.buffer] if t.buffer < len(self.buffers) else None
        if data is None or not len(data):
            return None
        return np.frombuffer(data, t.dtype).reshape(t.shape)


# --------------------------------------------------------------------- read


def _read_options(tab: Optional[Table], utype: int) -> Dict[str, object]:
    name = OPTIONS_BY_TYPE.get(utype)
    if name is None or tab is None:
        return {}
    return {fname: tab.scalar(fid, kind, default) for fid, fname, kind, default in OPTIONS[name][1]}


def _read_tensor(t: Table) -> Tensor:
    shape = t.numpy(0, "i32")
    q = t.table(4)
    quant = None
    if q is not None and q.has(2):
        quant = Quantization(np.array(q.numpy(2, "f32")), np.array(q.numpy(3, "i64")),
                             q.scalar(6, "i32", 0))
    return Tensor([int(v) for v in (shape if shape is not None else ())], t.scalar(1, "i8", 0),
                  t.scalar(2, "u32", 0), t.string(3) or "", quant)


def read_model(path: Union[str, Path]) -> Model:
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    root = Table.root(buf)
    codes = []
    for oc in root.tables(1):
        code = max(oc.scalar(0, "i8", 0), oc.scalar(3, "i32", 0))
        custom = oc.string(1)
        codes.append((f"CUSTOM:{custom}" if custom else OP_NAMES.get(code, f"BUILTIN_{code}"),
                      oc.scalar(2, "i32", 1)))
    buffers = []
    for b in root.tables(4):
        data = b.numpy(0, "u8")
        size = b.scalar(2, "u64", 0)
        if (data is None or not len(data)) and size:
            off = b.scalar(1, "u64", 0)
            data = buf[off:off + size]
        buffers.append(data if data is not None and len(data) else None)
    subgraphs = []
    for g in root.tables(2):
        ops = []
        for o in g.tables(3):
            name, version = codes[o.scalar(0, "u32", 0)]
            ops.append(Operator(name, [int(v) for v in o.numpy(1, "i32")],
                                [int(v) for v in o.numpy(2, "i32")],
                                _read_options(o.table(4), o.scalar(3, "u8", 0)), version))
        subgraphs.append(SubGraph([_read_tensor(t) for t in g.tables(0)],
                                  [int(v) for v in g.numpy(1, "i32")],
                                  [int(v) for v in g.numpy(2, "i32")], ops, g.string(4) or ""))
    metadata = {m.string(0): m.scalar(1, "u32", 0) for m in root.tables(6)}
    signatures = {}
    for s in root.tables(7):
        signatures[s.string(2) or ""] = (
            {tm.string(0): tm.scalar(1, "u32", 0) for tm in s.tables(0)},
            {tm.string(0): tm.scalar(1, "u32", 0) for tm in s.tables(1)})
    return Model(subgraphs, buffers, root.string(3) or "", metadata, signatures,
                 root.scalar(0, "u32", 0))


# -------------------------------------------------------------------- write


def _write_options(b: Builder, op: Operator):
    name = OPS[op.op][1]
    if name is None:
        return None
    utype, fields = OPTIONS[name]
    ref = b.table([(fid, kind, op.options.get(fname, default))
                   for fid, fname, kind, default in fields])
    return utype, ref


def write_model(model: Model, path: Union[str, Path]) -> int:
    """Write `model` to `path` as a TFLite file; returns its size."""
    b = Builder()
    buffers = model.buffers
    total = sum(0 if d is None else len(d) for d in buffers)
    if total >= 2**31 - 2**24:
        raise ValueError(f"{path}: {total} bytes of buffers; the writer writes them inline, "
                         "which FlatBuffers' 32-bit offsets limit to 2 GB")
    # big buffers first: written last, they sit at the file's end
    buffer_refs = [None] * len(buffers)
    for i in sorted(range(len(buffers)), key=lambda i: 0 if buffers[i] is None else len(buffers[i])):
        d = buffers[i]
        data_ref = None if d is None or not len(d) else b.bytes_vector(d, 16)
        buffer_refs[i] = data_ref
    buffer_tables = [b.table([(0, "ref", r)]) for r in buffer_refs]
    subgraph_refs = []
    opcode_index: Dict[tuple, int] = {}
    for g in model.subgraphs:
        tensor_refs = []
        for t in g.tensors:
            q = None
            if t.quantization is not None:
                qq = t.quantization
                q = b.table([(2, "ref", b.vector("f32", qq.scale)),
                             (3, "ref", b.vector("i64", qq.zero_point)),
                             (6, "i32", qq.quantized_dimension)])
            tensor_refs.append(b.table([(0, "ref", b.vector("i32", t.shape)), (1, "i8", t.type),
                                        (2, "u32", t.buffer), (3, "ref", b.string(t.name)),
                                        (4, "ref", q)]))
        op_refs = []
        for op in g.operators:
            key = (op.op, op.version)
            if key not in opcode_index:
                opcode_index[key] = len(opcode_index)
            opts = _write_options(b, op)
            op_refs.append(b.table([(0, "u32", opcode_index[key]),
                                    (1, "ref", b.vector("i32", op.inputs)),
                                    (2, "ref", b.vector("i32", op.outputs))]
                                   + ([(3, "union", opts)] if opts is not None else [])))
        subgraph_refs.append(b.table([(0, "ref", b.refs(tensor_refs)),
                                      (1, "ref", b.vector("i32", g.inputs)),
                                      (2, "ref", b.vector("i32", g.outputs)),
                                      (3, "ref", b.refs(op_refs)), (4, "ref", b.string(g.name))]))
    code_refs = []
    for (name, version), _ in sorted(opcode_index.items(), key=lambda kv: kv[1]):
        code = OPS[name][0]
        code_refs.append(b.table([(0, "i8", min(code, PLACEHOLDER_FOR_GREATER_OP_CODES)),
                                  (2, "i32", version), (3, "i32", code)]))
    metadata_refs = [b.table([(0, "ref", b.string(n)), (1, "u32", i)]) for n, i in model.metadata.items()]
    sig_refs = []
    for key, (ins, outs) in model.signatures.items():
        maps = [b.refs([b.table([(0, "ref", b.string(n)), (1, "u32", i)])
                        for n, i in side.items()]) for side in (ins, outs)]
        sig_refs.append(b.table([(0, "ref", maps[0]), (1, "ref", maps[1]),
                                 (2, "ref", b.string(key)), (4, "u32", 0)]))
    root = b.table([(0, "u32", model.version), (1, "ref", b.refs(code_refs)),
                    (2, "ref", b.refs(subgraph_refs)), (3, "ref", b.string(model.description)),
                    (4, "ref", b.refs(buffer_tables)),
                    (6, "ref", b.refs(metadata_refs) if metadata_refs else None),
                    (7, "ref", b.refs(sig_refs) if sig_refs else None)])
    b.finish(root, FILE_ID)
    return b.write(path)
