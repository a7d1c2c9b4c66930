"""The spatial H-sharding: each image's rows split over the ranks of a
spatial group, with the halo exchanges and reductions that the ops which
read along H need.

Port of the `spatial` axis of `dmayolo_tpu/parallel/mesh.py`.  Under
`jit`, GSPMD shards H (`P("data", "spatial")`) and inserts every halo
exchange itself; here each op that reads along H asks for what it needs.

**The partition.**  A map of global height H over n ranks: rank r owns
rows [r c, min(H, (r + 1) c)) with c = ceil(H / n), GSPMD's ceil split
(`row_bounds`); a rank may own no row of a map of fewer than n rows.
Every map is split by this one rule, whatever its height: a strided op's
output rows are not its input rows over the stride, so its input
interval is fetched by the global index rule.

**The collectives** run on the spatial group and are SUM all-reduces
only (NCCL and gloo both have them, also for CUDA tensors under gloo),
each with the group's `COLLECTIVE_TIMEOUT_S`.  Each that moves rows is an
autograd `Function` with its exact adjoint, the group captured in its
`ctx` at forward time (a backward runs on the autograd thread, where a
thread-local context would be empty):

  * `global_height`: the map's height, the sum of the ranks' heights
    (one all-reduce of one integer, asked by every op that needs it);
  * `fetch_rows`: global rows [lo, hi) of a row-split map, rows outside
    [0, H) as the op's pad value.  Each rank writes its top and bottom T
    rows (T the farthest any rank reaches into another) into its slot of
    one zero buffer, and one all-reduce gives every rank every edge.  The
    adjoint writes each halo row's gradient into its owner's slot, one
    all-reduce, and each owner adds its slot;
  * `gather_h` (the whole map on every spatial rank; adjoint the
    reduce-scatter: all-reduce, own rows) and `slice_h` (this rank's rows
    of a whole map; adjoint the zero pad);
  * `sum_h` (the sum over the spatial group; adjoint the same sum) and
    `max_h` (the global max pool; adjoint to the global ties, split
    evenly as torch's `amax` splits them).

**Split, gathered and replicated.**  Inside `spatial_scope(mesh)` every
map is row-split, and `nn/primitives.py` takes each op's spatial form:
convs (any kernel, stride, padding, dilation and groups, the int8 form
included) and pools fetch their input interval, resizes take their
source rows by the global index rule at global sizes, H reductions sum
over the group, BN's train moments run over the whole group.  Inside
`replicated()` a tensor is the same on every spatial rank (a gathered
map, a pooled vector) and the ops run as on one process, BN's moments
over the data subgroup only (the spatial ranks hold copies).  Gradients
of replicated work are partial on each rank (each sees only its own
rows' downstream) and sum to the whole over the group, as the train
step's gradient all-reduce sums them.

The ops taken whole (`gather_h`, the op, `slice_h`): CoorAttention's H
column (B, C, H, 1) through `conv1`, `bn1` and `conv_h`; C3TR's
`TransformerBlock` (attention over every token); C3STR's
`SwinTransformerBlock` (window padding, the cyclic shift that wraps the
first rank's rows onto the last, the mask); the head's raw levels before
decode, NMS and the loss; TTA's input image (scale and flip), re-split at
the scaled height.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# `fetch_rows` calls (the ops that read along H), and those of them that
# moved rows (the halo exchanges), for the counts a caller reads around a
# forward
FETCHES = [0]
EXCHANGES = [0]


def row_bounds(h: int, n: int) -> List[Tuple[int, int]]:
    """[a, b) of each of `n` ranks for a map of `h` rows: GSPMD's ceil
    split, rank r on [r c, min(h, (r + 1) c)), c = ceil(h / n)."""
    c = -(-h // n)
    return [(min(h, r * c), min(h, (r + 1) * c)) for r in range(n)]


class SpatialContext:
    """The spatial group of a forward: its mesh, rank and size, the depth
    of `replicated()` blocks, and the graph layer being run (for errors)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.spatial_group
        self.n = mesh.n_spatial
        self.rank = mesh.spatial_rank
        self.replicated = 0
        self.layer = "input"

    def where(self) -> str:
        return f"layer {self.layer}"

    def bn_mesh(self):
        """The group BN's train moments run over: every rank (data x
        spatial) for a row-split map, the data subgroup for a replicated
        one (None where that is one rank)."""
        m = self.mesh if not self.replicated else self.mesh.data
        return m if m.distributed else None


_CTX: Optional[SpatialContext] = None


@contextlib.contextmanager
def spatial_scope(mesh):
    """Within the block every map is this rank's rows of the global one
    (a mesh that splits no rows, or None, changes nothing).  The train
    step holds it over the backward too, whose recomputed layers run the
    spatial forms again."""
    global _CTX
    if mesh is None or not mesh.spatial:
        yield None
        return
    prev, _CTX = _CTX, SpatialContext(mesh)
    try:
        yield _CTX
    finally:
        _CTX = prev


def active() -> Optional[SpatialContext]:
    """The spatial context, also inside `replicated()`."""
    return _CTX


def current() -> Optional[SpatialContext]:
    """The spatial context where maps are row-split; None on one process
    and inside `replicated()`."""
    return _CTX if _CTX is not None and _CTX.replicated == 0 else None


@contextlib.contextmanager
def replicated():
    """Within the block tensors are whole and the same on every spatial
    rank: the ops run as on one process."""
    ctx = _CTX
    if ctx is None:
        yield
        return
    ctx.replicated += 1
    try:
        yield
    finally:
        ctx.replicated -= 1


def set_layer(name: str):
    """Name the graph layer being run, for the errors of its ops."""
    if _CTX is not None:
        _CTX.layer = name


def _wire(dtype):
    """The dtype a tensor travels in: bf16 and f16 as f32 (exact), bool as
    uint8."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return torch.uint8 if dtype == torch.bool else dtype


def _all_reduce(sp: SpatialContext, t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, group=sp.group)
    return t


def global_height(x: torch.Tensor, dim: int = 2, sp: Optional[SpatialContext] = None) -> int:
    """The global size of a row-split map along `dim`: one all-reduce of
    the ranks' sizes (every spatial rank calls it at the same op).  Raises,
    naming the layer, where this rank's rows are not the partition's."""
    sp = sp or _CTX
    n = x.shape[dim]
    t = torch.tensor([n], dtype=torch.int64, device=sp.mesh.wire_device())
    h = int(_all_reduce(sp, t).item())
    a, b = row_bounds(h, sp.n)[sp.rank]
    if b - a != n:
        raise ValueError(f"{sp.where()}: spatial rank {sp.rank} of {sp.n} holds "
                         f"{n} rows of a map of {h}, the partition gives it {b - a}")
    return h


def global_hw(x: torch.Tensor) -> Tuple[int, int]:
    """(H, W) of a NCHW map: H global where maps are row-split."""
    sp = current()
    return (global_height(x, 2, sp) if sp is not None else x.shape[2]), x.shape[3]


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

def _reach(parts, spans) -> int:
    """T: the most rows any rank needs from another, counted from the
    owner's edge that faces it."""
    t = 0
    for s, (lo, hi) in enumerate(spans):
        for u, (a, b) in enumerate(parts):
            g0, g1 = max(lo, a), min(hi, b)
            if u != s and g1 > g0:
                t = max(t, b - g0 if u < s else g1 - a)
    return t


def _pieces(h: int, parts, t: int, r: int, lo: int, hi: int):
    """Global rows [lo, hi) of rank r's slab, in order: ("pad", n), ("own",
    i0, i1) local rows, ("edge", u, side, i0, i1) rows of rank u's top
    (side 0) or bottom (side 1) slot."""
    out = []
    if lo < min(hi, 0):
        out.append(("pad", min(hi, 0) - lo))
    for u, (a, b) in enumerate(parts):
        g0, g1 = max(lo, a), min(hi, b)
        if g1 <= g0:
            continue
        if u == r:
            out.append(("own", g0 - a, g1 - a))
        elif u < r:
            off = t - (b - a)
            out.append(("edge", u, 1, g0 - a + off, g1 - a + off))
        else:
            out.append(("edge", u, 0, g0 - a, g1 - a))
    if max(lo, h) < hi:
        out.append(("pad", hi - max(lo, h)))
    return out


def _length(p) -> int:
    return p[1] if p[0] == "pad" else p[-1] - p[-2]


class _Fetch(torch.autograd.Function):
    """fetch_rows on the NHWC view (rows on dim 1)."""

    @staticmethod
    def forward(ctx, x, sp, h, spans, pad):
        b, hl, w, c = x.shape
        parts = row_bounds(h, sp.n)
        t = _reach(parts, spans)
        pieces = _pieces(h, parts, t, sp.rank, *spans[sp.rank])
        FETCHES[0] += 1
        buf = None
        if t:
            buf = x.new_zeros((sp.n, 2, b, t, w, c), dtype=_wire(x.dtype))
            k = min(t, hl)
            if k:
                buf[sp.rank, 0, :, :k] = x[:, :k]
                buf[sp.rank, 1, :, t - k:] = x[:, hl - k:]
            _all_reduce(sp, buf)
            EXCHANGES[0] += 1
        out = []
        for p in pieces:
            if p[0] == "pad":
                out.append(x.new_full((b, p[1], w, c), pad))
            elif p[0] == "own":
                out.append(x[:, p[1]:p[2]])
            else:
                out.append(buf[p[1], p[2], :, p[3]:p[4]].to(x.dtype))
        ctx.sp, ctx.t, ctx.pieces, ctx.shape, ctx.dtype = sp, t, pieces, x.shape, x.dtype
        return torch.cat(out, 1) if out else x.new_empty((b, 0, w, c))

    @staticmethod
    def backward(ctx, gy):
        sp, t, (b, hl, w, c) = ctx.sp, ctx.t, ctx.shape
        wire = _wire(ctx.dtype)
        gx = gy.new_zeros((b, hl, w, c), dtype=wire)
        buf = gy.new_zeros((sp.n, 2, b, t, w, c), dtype=wire) if t else None
        pos = 0
        for p in ctx.pieces:
            n = _length(p)
            seg = gy[:, pos:pos + n]
            pos += n
            if p[0] == "own":
                gx[:, p[1]:p[2]] += seg
            elif p[0] == "edge":
                buf[p[1], p[2], :, p[3]:p[4]] += seg
        if t:
            _all_reduce(sp, buf)
            k = min(t, hl)
            if k:
                gx[:, :k] += buf[sp.rank, 0, :, :k]
                gx[:, hl - k:] += buf[sp.rank, 1, :, t - k:]
        return gx.to(ctx.dtype), None, None, None, None


def fetch_rows(x: torch.Tensor, h: int, spans: Sequence[Tuple[int, int]], pad: float = 0.0,
               sp: Optional[SpatialContext] = None) -> torch.Tensor:
    """Global rows [lo, hi) of the row-split NCHW map `x` (global height
    `h`), where `spans` holds every rank's [lo, hi) (each rank serves the
    others' requests, so all must be known); rows outside [0, h) are `pad`.
    One all-reduce, none where no rank reaches past its own rows."""
    sp = sp or _CTX
    y = _Fetch.apply(x.permute(0, 2, 3, 1), sp, h, [tuple(s) for s in spans], float(pad))
    return y.permute(0, 3, 1, 2)


def window_rows(x: torch.Tensor, k: int, s: int, p: int, d: int = 1, pad: float = 0.0,
                keep_pad: bool = False):
    """The input slab of this rank's output rows of a windowed op along H
    (kernel k, stride s, padding p, dilation d) on the row-split map `x`.
    Returns (slab, start, n): run the op with no H padding on the slab for
    its n output rows; with `keep_pad` the slab begins earlier so that the
    op with its own padding p gives them from output row `start` on (the
    rows before it and after start + n are dropped).  Rows outside the map
    are `pad`."""
    sp = _CTX
    h = global_height(x, 2, sp)
    ho = (h + 2 * p - d * (k - 1) - 1) // s + 1
    if ho < 1:
        raise ValueError(f"{sp.where()}: a map of {h} rows is too short for a window of {k} "
                         f"(stride {s}, padding {p}, dilation {d})")
    q = -(-p // s) if keep_pad else 0
    spans = []
    for o0, o1 in row_bounds(ho, sp.n):
        if o1 <= o0:
            spans.append((0, 0))
            continue
        lo = o0 * s - q * s if keep_pad else o0 * s - p
        spans.append((lo, (o1 - 1) * s - p + d * (k - 1) + 1))
    o0, o1 = row_bounds(ho, sp.n)[sp.rank]
    return fetch_rows(x, h, spans, pad, sp), q, o1 - o0


def source_rows(x: torch.Tensor, h: int, h_out: int, src_of) -> Tuple[torch.Tensor, int, int, int]:
    """The source slab of this rank's rows of an output of `h_out` rows
    whose row o reads source rows [src_of(o)[0], src_of(o)[1]) of `x`
    (global height `h`; a resize, a pad or a depth-to-space; the source
    interval grows with o).  Returns (slab, lo, o0, o1): the slab holds
    global source rows from lo on (outside the map: zeros), and this
    rank's output rows are [o0, o1)."""
    sp = _CTX
    spans = []
    bounds = row_bounds(h_out, sp.n)
    for o0, o1 in bounds:
        spans.append((src_of(o0)[0], src_of(o1 - 1)[1]) if o1 > o0 else (0, 0))
    o0, o1 = bounds[sp.rank]
    return fetch_rows(x, h, spans, 0.0, sp), spans[sp.rank][0], o0, o1


# ---------------------------------------------------------------------------
# gathers and reductions
# ---------------------------------------------------------------------------

def _rows_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.dim() == 4 and dim == 2 else x.movedim(dim, 1)


def _rows_back(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if x.dim() == 4 and dim == 2 else x.movedim(1, dim)


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, dim):
        h = global_height(x, dim, sp)
        parts = row_bounds(h, sp.n)
        xr = _rows_first(x, dim)
        cap = parts[0][1] - parts[0][0]
        buf = xr.new_zeros((sp.n, xr.shape[0], cap) + tuple(xr.shape[2:]), dtype=_wire(x.dtype))
        buf[sp.rank, :, :xr.shape[1]] = xr
        _all_reduce(sp, buf)
        y = torch.cat([buf[u, :, :b - a] for u, (a, b) in enumerate(parts)], 1).to(x.dtype)
        ctx.sp, ctx.dim, ctx.rows, ctx.dtype = sp, dim, parts[sp.rank], x.dtype
        return _rows_back(y, dim)

    @staticmethod
    def backward(ctx, gy):
        g = _rows_first(gy, ctx.dim).to(_wire(ctx.dtype)).contiguous()
        _all_reduce(ctx.sp, g)
        a, b = ctx.rows
        return _rows_back(g[:, a:b].to(ctx.dtype), ctx.dim), None, None


class _SliceH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, dim):
        rows = row_bounds(x.shape[dim], sp.n)[sp.rank]
        ctx.shape, ctx.dim, ctx.rows = x.shape, dim, rows
        return x.narrow(dim, rows[0], rows[1] - rows[0]).clone()

    @staticmethod
    def backward(ctx, gy):
        g = gy.new_zeros(ctx.shape)
        a, b = ctx.rows
        g.narrow(ctx.dim, a, b - a).copy_(gy)
        return g, None, None


class _SumH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _all_reduce(sp, x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce(ctx.sp, gy.clone(memory_format=torch.contiguous_format)), None


class _MaxH(torch.autograd.Function):
    """The max over (H, W) of a row-split map, (B, C, 1, 1); the gradient
    goes to the global ties, evenly."""

    @staticmethod
    def forward(ctx, x, sp):
        b, c = x.shape[:2]
        xf = x.float()
        local = (xf.amax(dim=(2, 3)) if x.shape[2] else
                 xf.new_full((b, c), float("-inf")))
        buf = xf.new_zeros((sp.n, b, c))
        buf[sp.rank] = local
        m = _all_reduce(sp, buf).amax(0)
        ties = xf == m[:, :, None, None]
        count = _all_reduce(sp, ties.sum(dim=(2, 3)).float())
        ctx.save_for_backward(ties, count)
        ctx.sp, ctx.dtype = sp, x.dtype
        return m.to(x.dtype)[:, :, None, None]

    @staticmethod
    def backward(ctx, gy):
        ties, count = ctx.saved_tensors
        g = _all_reduce(ctx.sp, gy.float().reshape(count.shape).clone())
        return (ties * (g / count)[:, :, None, None]).to(ctx.dtype), None


def gather_h(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The whole map on every spatial rank from each rank's rows along
    `dim` (two all-reduces: the height, then the rows)."""
    return _GatherH.apply(x, _CTX, dim)


def slice_h(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """This rank's rows along `dim` of a map that every spatial rank holds
    whole."""
    return _SliceH.apply(x, _CTX, dim)


def sum_h(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the spatial group (f32 in, f32 out)."""
    return _SumH.apply(x, _CTX)


def max_h(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveMaxPool2d(1) of a row-split map, (B, C, 1, 1)."""
    return _MaxH.apply(x, _CTX)


def rows_of(x: torch.Tensor, h: int, dim: int = 2) -> torch.Tensor:
    """This rank's rows along `dim` of a tensor computed whole with no
    gradient to route (a mask drawn for the global map)."""
    a, b = row_bounds(h, _CTX.n)[_CTX.rank]
    return x.narrow(dim, a, b - a)
