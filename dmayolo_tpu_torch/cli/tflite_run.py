"""Run a `.tflite` model in torch: `TFLiteProgram(path, device=None)`.

The model file is read by `utils/tflite.py` (no TensorFlow).  At load
every constant goes to the device once and each operator becomes a step
with its parameters worked out (the requantize multipliers, lookup
tables, pads); a call runs the steps in the subgraph's order on tensors
shaped as TFLite's (NHWC activations, OHWI conv weights, 1HWO depthwise
weights) and frees each activation after its last reader.  CUDA by
default; the CPU only when asked.  An op outside `RUNNERS`, or an int8 op
without an integer form here, raises naming the op and the file.

float32 ops are the torch ops of the same function (a conv is
`F.conv2d`).  int8 ops follow TFLite's reference kernels
(BUILTIN_REF) bit for bit, in torch int32/int64 on either device:
activations are asymmetric per tensor, conv weights symmetric per output
channel with int32 bias at scale s_in * s_w[c], and an output is
rescaled by `MultiplyByQuantizedMultiplier` with the (multiplier, shift)
of `QuantizeMultiplier` (gemmlowp's rounding doubling high multiply,
then a rounding right shift).  ADD and SUB take both inputs to a common
scale first (left shift 20); MUL rescales the product; LOGISTIC,
HARD_SWISH and RELU map 256 inputs through a table computed at load by
the reference's own arithmetic (a float sigmoid rounded to 1/256;
HardSwish's int16 fixed point; ReluX's rescale); AVERAGE_POOL_2D rounds the sum of in-bounds raw
values half away from zero; SUM rescales in float as the reference does;
PAD pads with the zero point.

The int8 CONV_2D runs on K4 (`nn/conv_int8.py::conv_int8`, s32 out):
the route pads with zeros, and TFLite's sum over (x - zp_in) * w, where
the padded taps are zero, is the route's sum minus zp_in times the sum
of the weights over the in-bounds taps at each output position (a border
correction computed once a shape, exact in float64).  A pad that is not
symmetric (TFLite's SAME puts the odd row at the end) is applied to the
raw s8 map first, with zeros, and counted in the correction.  Grouped and
depthwise int8 convs, which K4 does not take, run as an exact float64
grouped `F.conv2d`: a choice made by the filter's shape, before any
launch.  On the CPU `conv_int8` is its plain version (`conv_int8_plain`,
float64), against which the card's check holds each of K4's s32 calls.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.conv_int8 import conv_int8, padded_channels
from ..utils.tflite import Model, Tensor, read_model

INT32_MAX = 2**31 - 1
QRANGE = {torch.int8: (-128, 127), torch.uint8: (0, 255), torch.int16: (-32768, 32767)}
_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.int8): torch.int8,
          np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
          np.dtype(np.int64): torch.int64, np.dtype(np.int16): torch.int16,
          np.dtype(np.bool_): torch.bool, np.dtype(np.float16): torch.float16,
          np.dtype(np.float64): torch.float64}


# ------------------------------------------------- TFLite's integer arithmetic

def round_away(x: float) -> int:
    """std::round: half away from zero."""
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


def quantize_multiplier(m: float):
    """QuantizeMultiplier: m = q * 2^shift, q in [0.5, 1) as a Q31 int."""
    if m == 0.0:
        return 0, 0
    q, shift = math.frexp(m)
    q_fixed = round_away(q * (1 << 31))
    if q_fixed == 1 << 31:
        q_fixed //= 2
        shift += 1
    if shift < -31:
        return 0, 0
    if shift > 30:
        return (1 << 31) - 1, 30
    return q_fixed, shift


def _srdhm(a: torch.Tensor, b, bits: int = 31) -> torch.Tensor:
    """gemmlowp SaturatingRoundingDoublingHighMul on int32 (`bits` 31) or
    int16 (`bits` 15) values held in int64.  b is a positive multiplier,
    so the one saturating case (both operands the type's minimum) never
    occurs."""
    ab = a * b
    nudge = torch.where(ab >= 0, 1 << (bits - 1), 1 - (1 << (bits - 1)))
    return torch.div(ab + nudge, 1 << bits, rounding_mode="trunc")


def _rdbpot(x: torch.Tensor, e) -> torch.Tensor:
    """gemmlowp RoundingDivideByPOT: x / 2^e rounded half away from zero."""
    if isinstance(e, int) and e == 0:
        return x
    mask = (torch.ones_like(e) << e) - 1 if torch.is_tensor(e) else (1 << e) - 1
    rem = x & mask
    thr = (mask >> 1) + (x < 0).to(x.dtype)
    return (x >> e) + (rem > thr).to(x.dtype)


def mbqm(x: torch.Tensor, mult, shift) -> torch.Tensor:
    """MultiplyByQuantizedMultiplier (int64 in and out); mult and shift
    ints or per-channel int64 tensors broadcasting against x."""
    if torch.is_tensor(shift):
        left, right = shift.clamp(min=0), (-shift).clamp(min=0)
        return _rdbpot(_srdhm(x << left, mult), right)
    return _rdbpot(_srdhm(x * (1 << max(shift, 0)), mult), max(-shift, 0))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as an int32 accumulator holds them (two's complement)."""
    return ((x + 2**31) & (2**32 - 1)) - 2**31


def activation_range(act: int, scale: float, zp: int, dtype):
    """CalculateActivationRangeQuantized for NONE, RELU and RELU6."""
    lo, hi = QRANGE[dtype]
    if act == 0:
        return lo, hi
    if act == 1:
        return max(lo, zp), hi
    if act == 3:
        return max(lo, zp), min(hi, zp + round_away(6.0 / scale))
    raise NotImplementedError(f"fused activation {act} on an integer op")


def _f32(v) -> np.float32:
    return np.float32(v)


def logistic_table(s_in: float, zp_in: int, s_out: float, zp_out: int) -> np.ndarray:
    """The reference's int8 LOGISTIC table: 1 / (1 + exp(-x)) in float on
    each dequantized input, rounded to the output's scale."""
    out = np.empty(256, np.int64)
    inv = _f32(1.0) / _f32(s_out)
    for i, v in enumerate(range(-128, 128)):
        x = _f32(s_in) * _f32(v - zp_in)
        with np.errstate(over="ignore"):  # past FLT_MAX: inf, as expf gives
            e = _f32(math.exp(-float(x))) if -float(x) < 709.0 else np.float32(np.inf)
        y = _f32(1.0) / (_f32(1.0) + e)
        q = round_away(float(_f32(y * inv))) + zp_out
        out[i] = min(max(q, -128), 127)
    return out


def relu_table(s_in: float, zp_in: int, s_out: float, zp_out: int) -> np.ndarray:
    """The reference's int8 RELU (`ReluX`): x - zp_in rescaled by s_in /
    s_out, plus zp_out, clamped below at zp_out."""
    m, sh = quantize_multiplier(float(np.float64(_f32(s_in)) / np.float64(_f32(s_out))))
    v = torch.arange(-128, 128, dtype=torch.int64) - zp_in
    return (mbqm(v, m, sh) + zp_out).clamp(max(-128, zp_out), 127).numpy()


def _to_int16_multiplier(m32: int) -> int:
    """DownScaleInt32ToInt16Multiplier."""
    if m32 >= INT32_MAX - (1 << 15):
        return 32767
    return (m32 + (1 << 15)) >> 16


def hard_swish_table(s_in: float, zp_in: int, s_out: float, zp_out: int) -> np.ndarray:
    """The reference's int8 HARD_SWISH (`reference_ops::HardSwish`), its
    int16 fixed point evaluated on the 256 inputs."""
    hires = _f32(1.0 / 128.0) * _f32(s_in)
    out_m32, out_exp = quantize_multiplier(float(hires / _f32(s_out)))
    relu_m32, relu_exp = quantize_multiplier(float(hires / _f32(3.0 / 32768.0)))
    out_m, relu_m = _to_int16_multiplier(out_m32), _to_int16_multiplier(relu_m32)
    if out_exp > 0:
        raise NotImplementedError("HARD_SWISH with an output multiplier above 1")

    def sat16(v):
        return v.clamp(-32768, 32767)

    x = sat16(torch.arange(-128, 128, dtype=torch.int64) - zp_in)
    hi = sat16(x * (1 << 7))
    pre = _srdhm(hi, out_m, 15)
    r = hi
    if relu_exp > 0:
        r = sat16(r * (1 << (relu_exp - 1)))
    r = _srdhm(r, relu_m, 15)
    if relu_exp > 0:
        r = sat16(r * 2)
    if relu_exp < 0:
        r = _rdbpot(r, -relu_exp)
    r = (r + (1 << 15)) >> 1
    # SaturatingDoublingHighMul, which truncates; r is in [0, 32767], so
    # it never saturates
    pv = torch.div(r * pre, 1 << 15, rounding_mode="trunc")
    return (_rdbpot(pv, -out_exp) + zp_out).clamp(-128, 127).numpy()


def same_pads(size: int, k: int, stride: int, dilation: int = 1):
    """TFLite SAME: (before, after), the odd one at the end."""
    out = -(-size // stride)
    eff = (k - 1) * dilation + 1
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


# ----------------------------------------------------------------- program

class _Ctx:
    def __init__(self, model: Model, device, path):
        self.model, self.g, self.device, self.path = model, model.subgraphs[0], device, path

    def t(self, i) -> Tensor:
        return self.g.tensors[i]

    def const(self, i) -> Optional[np.ndarray]:
        return None if i < 0 else self.model.constant(self.t(i))

    def dtype(self, i):
        return _TORCH[self.t(i).dtype]

    def q(self, i):
        """(scale, zero point) of a per-tensor quantized tensor."""
        qq = self.t(i).quantization
        if qq is None:
            raise ValueError(f"{self.path}: tensor {self.t(i).name!r} has no quantization")
        return float(qq.scale[0]), int(qq.zero_point[0])

    def fail(self, op, why=""):
        types = "/".join(self.t(i).dtype.name for i in op.inputs if i >= 0)
        raise NotImplementedError(f"{self.path}: op {op.op} ({types}) {why}".rstrip())


def _is_int(dt) -> bool:
    return dt in (torch.int8, torch.uint8, torch.int16)


def _act_f32(y, act):
    if act == 0:
        return y
    if act == 1:
        return torch.relu(y)
    if act == 3:
        return torch.clamp(y, 0, 6)
    raise NotImplementedError(f"fused activation {act}")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _pads2d(op, h, w, kh, kw):
    """(top, bottom, left, right) of a conv or pool's SAME/VALID padding."""
    o = op.options
    if o.get("padding", 0) == 1:
        return 0, 0, 0, 0
    dh, dw = o.get("dilation_h_factor", 1), o.get("dilation_w_factor", 1)
    t, b = same_pads(h, kh, o["stride_h"], dh)
    le, r = same_pads(w, kw, o["stride_w"], dw)
    return t, b, le, r


class _Conv:
    """CONV_2D and DEPTHWISE_CONV_2D, float32 or int8."""

    def __init__(self, ctx: _Ctx, op):
        self.op = op
        o = op.options
        self.stride = (o["stride_h"], o["stride_w"])
        self.dil = (o.get("dilation_h_factor", 1), o.get("dilation_w_factor", 1))
        self.act = o.get("fused_activation_function", 0)
        x_i, w_i = op.inputs[:2]
        b_i = op.inputs[2] if len(op.inputs) > 2 else -1
        w = ctx.const(w_i)
        if w is None:
            ctx.fail(op, "with a non-constant filter")
        c_in = ctx.t(x_i).shape[3]
        if op.op == "DEPTHWISE_CONV_2D":  # 1HWO -> OIHW, one group an input channel
            self.groups = c_in
            w_oihw = np.ascontiguousarray(w[0].transpose(2, 0, 1))[:, None]
        else:  # OHWI; a filter of fewer input channels than the input: grouped
            self.groups = c_in // w.shape[3]
            w_oihw = np.ascontiguousarray(w.transpose(0, 3, 1, 2))
        self.kh, self.kw = w_oihw.shape[2:]
        self.int8 = ctx.t(x_i).dtype == np.int8
        dev = ctx.device
        bias = ctx.const(b_i)
        if not self.int8:
            self.w = torch.tensor(w_oihw, device=dev)
            self.b = None if bias is None else torch.as_tensor(np.array(bias), device=dev)
            return
        s_in, self.zp_in = ctx.q(x_i)
        s_out, self.zp_out = ctx.q(op.outputs[0])
        wq = ctx.t(w_i).quantization
        s_w = np.asarray(wq.scale, np.float64)
        if len(s_w) == 1:
            s_w = np.repeat(s_w, w_oihw.shape[0])
        if np.any(np.asarray(wq.zero_point) != 0):
            ctx.fail(op, "with an asymmetric filter")
        mults = [quantize_multiplier(float(np.float64(s_in) * s / np.float64(s_out)))
                 for s in s_w]
        self.mult = torch.tensor([m for m, _ in mults], dtype=torch.int64, device=dev)
        self.shift = torch.tensor([s for _, s in mults], dtype=torch.int64, device=dev)
        self.lo, self.hi = activation_range(self.act, s_out, self.zp_out, torch.int8)
        self.bias = torch.as_tensor(np.zeros(w_oihw.shape[0], np.int32) if bias is None
                                    else np.array(bias), device=dev).long()
        # K4 takes dense convs (s8 OHWI, channels padded to 16); grouped
        # and depthwise ones run as a float64 grouped conv
        self.k4 = self.groups == 1
        w_oihw64 = torch.as_tensor(w_oihw.astype(np.float64), device=dev)
        if self.k4:
            c1p = padded_channels(c_in)
            wk = torch.tensor(np.array(w), device=dev)
            self.wq = F.pad(wk, (0, c1p - c_in)).contiguous() if c1p != c_in else wk.contiguous()
            self.c1p = c1p
        self.w64 = w_oihw64
        # the border correction reads every input channel's tap alike: the
        # filter summed over its input channels (its group's, where grouped)
        self.wsum = w_oihw64.sum(dim=1, keepdim=True)  # (C2, 1, kh, kw)
        self._border: Dict[tuple, torch.Tensor] = {}

    def __call__(self, x):
        h, w = x.shape[1:3]
        if not self.int8:
            xp, pad, _ = self._padded(x)
            y = F.conv2d(_nchw(xp), self.w, self.b, self.stride, pad, self.dil, self.groups)
            return _act_f32(_nhwc(y), self.act).contiguous()
        if self.k4:
            xk, pad, pads = self.k4_input(x)
            acc = conv_int8(xk, self.wq, None, None, self.stride, pad, self.dil,
                            torch.int32).long()
        else:
            xp, pad, pads = self._padded(x)
            acc = _nhwc(F.conv2d(_nchw(xp).double(), self.w64, None, self.stride, pad, self.dil,
                                 self.groups)).round().long()
        if self.zp_in:
            acc = acc - self.zp_in * self._border_sum(h, w, pads)
        acc = _wrap32(acc + self.bias)  # the reference's int32 accumulator
        acc = mbqm(acc, self.mult, self.shift) + self.zp_out
        return acc.clamp(self.lo, self.hi).to(torch.int8)

    def _padded(self, x):
        """(x as the conv reads it, the symmetric pad left to the conv,
        TFLite's (top, bottom, left, right)): an asymmetric pad applied to
        the map with zeros (for int8, the raw s8 map: counted in the border
        correction)."""
        t, b, le, r = _pads2d(self.op, x.shape[1], x.shape[2], self.kh, self.kw)
        if (t, le) == (b, r):
            return x, (t, le), (t, b, le, r)
        return F.pad(x, (0, 0, le, r, t, b)), (0, 0), (t, b, le, r)

    def k4_input(self, x):
        """(K4's s8 input, its pad, TFLite's pads) for an int8 input: the
        map as `_padded` gives it, its channels padded to C1p."""
        xp, pad, pads = self._padded(x)
        if self.c1p != xp.shape[3]:
            xp = F.pad(xp, (0, self.c1p - xp.shape[3]))
        return xp.contiguous(), pad, pads

    def _border_sum(self, h, w, pads):
        """(Ho, Wo, C2): the filter's sum over the taps inside the h x w
        map at each output position, the map padded by `pads` (top,
        bottom, left, right)."""
        key = (h, w, pads)
        if key not in self._border:
            t, b, le, r = pads
            ones = torch.ones((1, 1, h, w), dtype=torch.float64, device=self.wsum.device)
            s = F.conv2d(F.pad(ones, (le, r, t, b)), self.wsum, None, self.stride, 0, self.dil)
            self._border[key] = _nhwc(s)[0].round().long()
        return self._border[key]


def _binary(ctx: _Ctx, op) -> Callable:
    a_i, b_i = op.inputs
    act = op.options.get("fused_activation_function", 0)
    name = op.op
    if not _is_int(ctx.dtype(a_i)):
        fn = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul, "DIV": torch.div,
              "MAXIMUM": torch.maximum, "MINIMUM": torch.minimum}[name]
        return lambda a, b: _act_f32(fn(a, b), act)
    if name not in ("ADD", "SUB", "MUL") or ctx.dtype(a_i) != torch.int8:
        ctx.fail(op)
    (s1, z1), (s2, z2), (so, zo) = ctx.q(a_i), ctx.q(b_i), ctx.q(op.outputs[0])
    lo, hi = activation_range(act, so, zo, torch.int8)
    if name == "MUL":
        m, sh = quantize_multiplier(float(_f32(s1) * _f32(s2) / _f32(so)))

        def mul(a, b):
            p = (a.long() - z1) * (b.long() - z2)
            return (mbqm(p, m, sh) + zo).clamp(lo, hi).to(torch.int8)
        return mul
    left = 20
    twice = float(_f32(2) * max(_f32(s1), _f32(s2)))
    m1, sh1 = quantize_multiplier(float(s1) / twice)
    m2, sh2 = quantize_multiplier(float(s2) / twice)
    mo, sho = quantize_multiplier(twice / float(_f32(1 << left) * _f32(so)))
    sign = 1 if name == "ADD" else -1

    def addsub(a, b):
        x1 = mbqm((a.long() - z1) * (1 << left), m1, sh1)
        x2 = mbqm((b.long() - z2) * (1 << left), m2, sh2)
        return (mbqm(x1 + sign * x2, mo, sho) + zo).clamp(lo, hi).to(torch.int8)
    return addsub


def _table_op(ctx: _Ctx, op, make) -> Callable:
    (si, zi), (so, zo) = ctx.q(op.inputs[0]), ctx.q(op.outputs[0])
    table = torch.as_tensor(make(si, zi, so, zo), dtype=torch.int8, device=ctx.device)
    return lambda x: table[x.long() + 128]


def _unary(ctx: _Ctx, op) -> Callable:
    dt = ctx.dtype(op.inputs[0])
    if op.op == "LOGISTIC":
        return _table_op(ctx, op, logistic_table) if dt == torch.int8 else torch.sigmoid
    if op.op == "HARD_SWISH":
        return _table_op(ctx, op, hard_swish_table) if dt == torch.int8 else F.hardswish
    if op.op == "RELU":
        return _table_op(ctx, op, relu_table) if dt == torch.int8 else torch.relu
    if _is_int(dt):
        ctx.fail(op)
    if op.op == "GELU":
        approx = "tanh" if op.options.get("approximate") else "none"
        return lambda x: F.gelu(x, approximate=approx)
    if op.op == "SOFTMAX":
        beta = op.options.get("beta", 1.0)
        return lambda x: torch.softmax(x * beta if beta != 1.0 else x, dim=-1)
    return {"RSQRT": torch.rsqrt}[op.op]


def _axes(ctx, op, rank):
    return sorted({int(a) % rank for a in np.atleast_1d(ctx.const(op.inputs[1]))})


def _reduce(ctx: _Ctx, op) -> Callable:
    x_i = op.inputs[0]
    rank = len(ctx.t(x_i).shape)
    axes, keep = _axes(ctx, op, rank), bool(op.options.get("keep_dims", False))
    if not _is_int(ctx.dtype(x_i)):
        fn = torch.sum if op.op == "SUM" else torch.mean
        return lambda x: fn(x, dim=axes, keepdim=keep)
    if op.op != "SUM" or ctx.dtype(x_i) != torch.int8:
        ctx.fail(op)
    (si, zi), (so, zo) = ctx.q(x_i), ctx.q(op.outputs[0])
    n = int(np.prod([ctx.t(x_i).shape[a] for a in axes]))
    scale = _f32(si) / _f32(so)
    bias = _f32(_f32(-zi) * scale) * _f32(n)

    def qsum(x):
        s = x.long().sum(dim=axes, keepdim=keep).to(torch.int32)
        v = s.float() * float(scale)  # f32 product, then an f32 sum: the reference's
        v = v + float(bias)
        v = torch.sign(v) * torch.floor(v.abs() + 0.5)  # TfLiteRound
        return (v.long() + zo).clamp(-128, 127).to(torch.int8)
    return qsum


def _pool(ctx: _Ctx, op) -> Callable:
    o = op.options
    kh, kw, sh, sw = o["filter_height"], o["filter_width"], o["stride_h"], o["stride_w"]
    act = o.get("fused_activation_function", 0)
    dt = ctx.dtype(op.inputs[0])
    is_max = op.op == "MAX_POOL_2D"
    if _is_int(dt):
        if dt != torch.int8:
            ctx.fail(op)
        so, zo = ctx.q(op.outputs[0])
        lo, hi = activation_range(act, so, zo, torch.int8)

    def pool(x):
        _, h, w, _ = x.shape
        t, b, le, r = _pads2d(op, h, w, kh, kw)
        xc = _nchw(x)
        if is_max:
            xf = xc.float() if _is_int(dt) else xc
            xf = F.pad(xf, (le, r, t, b), value=-math.inf) if (t or b or le or r) else xf
            y = F.max_pool2d(xf, (kh, kw), (sh, sw))
        else:
            xf = xc.double() if _is_int(dt) else xc
            xp = F.pad(xf, (le, r, t, b)) if (t or b or le or r) else xf
            s = F.avg_pool2d(xp, (kh, kw), (sh, sw), divisor_override=1)
            ones = torch.ones((1, 1, h, w), dtype=xf.dtype, device=x.device)
            ones = F.pad(ones, (le, r, t, b)) if (t or b or le or r) else ones
            cnt = F.avg_pool2d(ones, (kh, kw), (sh, sw), divisor_override=1)
            if _is_int(dt):  # acc / count rounded half away from zero (C++ division)
                acc, c = s.round().long(), cnt.round().long()
                y = torch.where(acc > 0, torch.div(acc + c // 2, c, rounding_mode="floor"),
                                -torch.div(c // 2 - acc, c, rounding_mode="floor"))
            else:
                y = s / cnt
        y = _nhwc(y)
        if _is_int(dt):
            return y.round().long().clamp(lo, hi).to(torch.int8)
        return _act_f32(y, act).contiguous()
    return pool


def _quantize(ctx: _Ctx, op) -> Callable:
    x_i, y_i = op.inputs[0], op.outputs[0]
    so, zo = ctx.q(y_i)
    odt = ctx.dtype(y_i)
    lo, hi = QRANGE[odt]
    if not _is_int(ctx.dtype(x_i)):
        inv_scale = _f32(so)

        def quant(x):  # round(val / float(scale)) + zp, in f32
            v = x.float() / float(inv_scale)
            v = torch.sign(v) * torch.floor(v.abs() + 0.5)
            return (v.long() + zo).clamp(lo, hi).to(odt)
        return quant
    si, zi = ctx.q(x_i)
    m, sh = quantize_multiplier(float(np.float64(_f32(si)) / np.float64(_f32(so))))
    return lambda x: (mbqm(x.long() - zi, m, sh) + zo).clamp(lo, hi).to(odt)


def _dequantize(ctx: _Ctx, op) -> Callable:
    s, z = ctx.q(op.inputs[0])
    return lambda x: ((x.long() - z).double() * float(_f32(s))).float()


def _cast(ctx: _Ctx, op) -> Callable:
    odt = ctx.dtype(op.outputs[0])
    return lambda x: x.to(odt)


def _shape_of(ctx, i):
    return list(ctx.t(i).shape)


def _reshape(ctx: _Ctx, op) -> Callable:
    shape = _shape_of(ctx, op.outputs[0])
    return lambda x, *_: x.reshape(shape)


def _broadcast(ctx: _Ctx, op) -> Callable:
    shape = _shape_of(ctx, op.outputs[0])
    return lambda x, *_: x.expand(shape)


def _transpose(ctx: _Ctx, op) -> Callable:
    perm = [int(v) for v in ctx.const(op.inputs[1])]
    return lambda x, *_: x.permute(perm)


def _slice(ctx: _Ctx, op) -> Callable:
    begin = [int(v) for v in ctx.const(op.inputs[1])]
    shape = _shape_of(ctx, op.outputs[0])
    idx = tuple(slice(b, b + n) for b, n in zip(begin, shape))
    return lambda x, *_: x[idx]


def _strided_slice(ctx: _Ctx, op) -> Callable:
    o = op.options
    if o.get("ellipsis_mask") or o.get("new_axis_mask") or o.get("offset"):
        ctx.fail(op, "with an ellipsis, new-axis or offset mask")
    begin, end, strides = (list(ctx.const(i)) for i in op.inputs[1:4])
    in_shape = _shape_of(ctx, op.inputs[0])
    idx = []
    for d in range(len(begin)):
        b = None if o.get("begin_mask", 0) >> d & 1 else int(begin[d])
        e = None if o.get("end_mask", 0) >> d & 1 else int(end[d])
        s = int(strides[d])
        if o.get("shrink_axis_mask", 0) >> d & 1:
            idx.append(int(begin[d]) % in_shape[d])
        else:
            idx.append(slice(b, e, s))
    idx = tuple(idx)
    return lambda x, *_: x[idx]


def _pad(ctx: _Ctx, op) -> Callable:
    pads = np.asarray(ctx.const(op.inputs[1])).reshape(-1, 2)
    flat = [int(v) for row in pads[::-1] for v in row]
    dt = ctx.dtype(op.inputs[0])
    value = ctx.q(op.outputs[0])[1] if _is_int(dt) else 0.0
    return lambda x, *_: F.pad(x, flat, value=value)


def _concat(ctx: _Ctx, op) -> Callable:
    axis = op.options.get("axis", 0)
    dt = ctx.dtype(op.outputs[0])
    if _is_int(dt):
        so = ctx.q(op.outputs[0])
        if any(ctx.q(i) != so for i in op.inputs):
            ctx.fail(op, "whose inputs' quantization differs from the output's")
    return lambda *xs: torch.cat(xs, dim=axis)


def _resize_nearest(ctx: _Ctx, op) -> Callable:
    o = op.options
    if o.get("align_corners") or o.get("half_pixel_centers"):
        ctx.fail(op, "with align_corners or half_pixel_centers")
    _, h, w, _ = _shape_of(ctx, op.inputs[0])
    _, ho, wo, _ = _shape_of(ctx, op.outputs[0])
    dev = ctx.device
    # in = min(floor(out * (in / out)), in - 1), the scale a float
    iy = torch.tensor([min(int(math.floor(y * float(_f32(h) / _f32(ho)))), h - 1)
                       for y in range(ho)], device=dev)
    ix = torch.tensor([min(int(math.floor(x * float(_f32(w) / _f32(wo)))), w - 1)
                       for x in range(wo)], device=dev)
    return lambda x, *_: x.index_select(1, iy).index_select(2, ix)


def _fully_connected(ctx: _Ctx, op) -> Callable:
    if _is_int(ctx.dtype(op.inputs[0])):
        ctx.fail(op)
    w = torch.as_tensor(np.array(ctx.const(op.inputs[1])), device=ctx.device)
    b_i = op.inputs[2] if len(op.inputs) > 2 else -1
    b = None if b_i < 0 else torch.as_tensor(np.array(ctx.const(b_i)), device=ctx.device)
    shape = _shape_of(ctx, op.outputs[0])
    act = op.options.get("fused_activation_function", 0)
    return lambda x, *_: _act_f32(F.linear(x, w, b), act).reshape(shape)


def _batch_matmul(ctx: _Ctx, op) -> Callable:
    if _is_int(ctx.dtype(op.inputs[0])):
        ctx.fail(op)
    adj_x, adj_y = op.options.get("adj_x", False), op.options.get("adj_y", False)

    def bmm(a, b):
        return torch.matmul(a.transpose(-1, -2) if adj_x else a,
                            b.transpose(-1, -2) if adj_y else b)
    return bmm


def _gather(ctx: _Ctx, op) -> Callable:
    axis = op.options.get("axis", 0)
    return lambda x, i: x.index_select(axis, i.reshape(-1).long()).reshape(
        _shape_of(ctx, op.outputs[0]))


RUNNERS = {
    "CONV_2D": _Conv, "DEPTHWISE_CONV_2D": _Conv,
    "ADD": _binary, "SUB": _binary, "MUL": _binary, "DIV": _binary,
    "MAXIMUM": _binary, "MINIMUM": _binary,
    "LOGISTIC": _unary, "HARD_SWISH": _unary, "RELU": _unary, "GELU": _unary, "SOFTMAX": _unary,
    "RSQRT": _unary,
    "SUM": _reduce, "MEAN": _reduce,
    "AVERAGE_POOL_2D": _pool, "MAX_POOL_2D": _pool,
    "QUANTIZE": _quantize, "DEQUANTIZE": _dequantize, "CAST": _cast,
    "RESHAPE": _reshape, "BROADCAST_TO": _broadcast, "TRANSPOSE": _transpose,
    "SLICE": _slice, "STRIDED_SLICE": _strided_slice, "PAD": _pad,
    "CONCATENATION": _concat, "RESIZE_NEAREST_NEIGHBOR": _resize_nearest,
    "FULLY_CONNECTED": _fully_connected, "BATCH_MATMUL": _batch_matmul, "GATHER": _gather,
}
# inputs an op reads at run time (the rest are shapes, axes and pads read at load)
_DATA_INPUTS = {"RESHAPE": 1, "BROADCAST_TO": 1, "TRANSPOSE": 1, "SLICE": 1,
                "STRIDED_SLICE": 1, "PAD": 1, "SUM": 1, "MEAN": 1, "CONV_2D": 1,
                "DEPTHWISE_CONV_2D": 1, "FULLY_CONNECTED": 1, "RESIZE_NEAREST_NEIGHBOR": 1}


class TFLiteProgram:
    """A `.tflite` model's first subgraph as torch steps on one device.

    `program(x)` takes the input (numpy or a tensor of the model's input
    dtype and shape) and returns the outputs as tensors in the subgraph's
    order; `run(x)` returns every tensor the steps computed, by index (the
    checks compare them with TFLite's own)."""

    def __init__(self, path: Union[str, Path, Model], device=None):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        if isinstance(path, Model):  # a model in memory (the int8 export's calibration)
            self.path, self.model = "<model>", path
        else:
            self.path = Path(path)
            self.model = read_model(self.path)
        model = self.model
        if len(model.subgraphs) != 1:
            raise NotImplementedError(f"{path}: {len(model.subgraphs)} subgraphs; the program "
                                      "runs models of one")
        g = model.subgraphs[0]
        ctx = _Ctx(model, self.device, self.path)
        unknown = sorted({op.op for op in g.operators} - set(RUNNERS))
        if unknown:
            raise NotImplementedError(f"{path}: op {unknown[0]} is not in the program's op set "
                                      f"({', '.join(unknown)})")
        self.tensors = g.tensors
        self.inputs, self.outputs = list(g.inputs), list(g.outputs)
        self.output_names = [g.tensors[i].name for i in self.outputs]
        self.input_shape = list(g.tensors[self.inputs[0]].shape)
        self.input_dtype = _TORCH[g.tensors[self.inputs[0]].dtype]
        self.constants: Dict[int, torch.Tensor] = {}
        self.steps = []
        for op in g.operators:
            n_data = _DATA_INPUTS.get(op.op, len(op.inputs))
            ins = [i for i in op.inputs[:n_data]]
            for i in ins:
                if i >= 0 and i not in self.constants:
                    c = model.constant(g.tensors[i])
                    if c is not None:
                        self.constants[i] = torch.as_tensor(np.array(c), device=self.device)
            self.steps.append((RUNNERS[op.op](ctx, op), ins, op.outputs[0]))
        last = {}
        for k, (_, ins, _) in enumerate(self.steps):
            for i in ins:
                last[i] = k
        keep = set(self.outputs) | set(self.constants)
        self._free = [{i for i in ins if last.get(i) == k and i not in keep}
                      for k, (_, ins, _) in enumerate(self.steps)]

    def _input(self, x) -> torch.Tensor:
        x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), device=self.device)
        if list(x.shape) != self.input_shape or x.dtype != self.input_dtype:
            raise ValueError(f"{self.path}: the input is {self.input_dtype} "
                             f"{self.input_shape}, got {x.dtype} {list(x.shape)}")
        return x

    def run(self, x, keep_all: bool = False, observe=None) -> Dict[int, torch.Tensor]:
        """Every tensor the steps computed, by index: the outputs (and,
        with `keep_all`, the rest); `observe(index, tensor)` sees each as
        it is computed (the int8 export's calibration)."""
        env: Dict[int, torch.Tensor] = dict(self.constants)
        env[self.inputs[0]] = self._input(x)
        if observe is not None:
            observe(self.inputs[0], env[self.inputs[0]])
        with torch.inference_mode():
            for (fn, ins, out), free in zip(self.steps, self._free):
                env[out] = fn(*(env[i] for i in ins))
                if observe is not None:
                    observe(out, env[out])
                if not keep_all:
                    for i in free:
                        del env[i]
        return env

    def __call__(self, x) -> List[torch.Tensor]:
        env = self.run(x)
        return [env[i] for i in self.outputs]
