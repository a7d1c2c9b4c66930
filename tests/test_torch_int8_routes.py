"""K4's routes on the CPU (`nn/conv_int8.py`): the kernel runs only on the
card, so what is held here is its host side and its geometry.

* `plan_int8` maps every int8-eligible conv of the flagship, yolov5s and
  C3CASPD2 to its route from the geometry alone: (a) "1x1" (stride 1, pad
  0), (b) "3x3s1" (pad 1), (c) "3x3s2" (pad 1); CASMM's 5x5 convs and the
  other odd geometries to (d) "general".
* Each plan fits the kernel: the checks `conv_int8_wgmma_launch` makes,
  shared memory within an H100's, TMA boxes within 256, the s8 tile long
  enough for every shifted view, and tiles that cover every output once.
* A torch emulation of the kernel's tiles: each A load filled as TMA fills
  its box (zeros outside the input, the rows it does not load left as
  junk), each K-step's view shifted as the wgmma descriptor moves, in the
  kernel's step order (route (c): the taps by input phase), the sums
  scattered through the tile-row-to-output map: equal to the plain conv.
* The quantize's arithmetic as the kernel does it (clip, then add 1.5 *
  2^23, the low byte) equal to `quantize_s8_plain`, ties and NaN
  included; the epilogue's bf16 product of two bf16 values exact in f32.
* `quantize_conv_int8`'s plain version equal to the jitted JAX
  `_int8_conv` at every case of tests/test_torch_int8.py, f32 and bf16.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu_torch.graph import DetectionModel, model_config
from dmayolo_tpu_torch.nn import conv_int8 as ci
from dmayolo_tpu_torch.nn.quant import eligible_conv_paths
from tests.test_torch_int8 import CASES, DTYPES, _jax_conv_int8, _jax_int8_parts

ROUTE_OF = {(1, 1, 0): "1x1", (3, 1, 1): "3x3s1", (3, 2, 1): "3x3s2"}  # (k, s, p), d 1
# int8 convs a route, at 640 px: (a), (b), (c), (d)
MODEL_ROUTES = {"ablation-ca-scconv-sppfcspc": (70, 43, 6, 0), "yolov5s": (42, 11, 6, 0),
                "C3CASPD2": (86, 39, 3, 0), "CASMM": None}


def _sites(name, imgsz=640):
    """{(H, W, C1, C2, k, s, p, d): count} of a full-width model's
    int8-eligible convs in one forward, by hooks on the meta device."""
    import yaml

    with open(model_config(name)) as f:
        cfg = yaml.safe_load(f)
    model = DetectionModel(cfg, nc=10, device="meta")
    sites = collections.Counter()

    def hook(conv, args, _):
        _, c, h, w = args[0].shape
        sites[(h, w, c, conv.c2, conv.k[0], conv.s[0], conv.p[0], conv.d[0])] += 1

    handles = [m.register_forward_hook(hook) for m in eligible_conv_paths(model).values()]
    try:
        model.apply(torch.empty(1, imgsz, imgsz, 3, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return sites


@pytest.mark.parametrize("name", list(MODEL_ROUTES))
def test_plan_routes_the_models_convs(name):
    sites = _sites(name)
    got = collections.Counter()
    for (h, w, c1, c2, k, s, p, d), n in sites.items():
        for dt in (torch.bfloat16, torch.float32, torch.int8):
            plan = ci.plan_int8(128, h, w, c1, c2, (k, k), (s, s), (p, p), (d, d), dt)
            want = ROUTE_OF.get((k, s, p), "general") if d == 1 or k == 1 else "general"
            assert plan.route == want, (name, (h, w, c1, c2, k, s, p, d), dt)
            # a bf16 input is quantized in the kernel where TMA can stride its rows
            assert plan.convert == (dt == torch.bfloat16 and want != "general" and c1 % 8 == 0)
        got[plan.route] += n
    if MODEL_ROUTES[name] is None:  # CASMM: four 5x5 convs on route (d)
        assert got["general"] == 4
    else:
        assert tuple(got[r] for r in ci.ROUTES) == MODEL_ROUTES[name]


@pytest.mark.parametrize("geometry", [((5, 5), (1, 1), (2, 2), (1, 1)),
                                      ((3, 3), (1, 1), (2, 2), (2, 2)),
                                      ((1, 1), (2, 2), (0, 0), (1, 1)),
                                      ((3, 3), (1, 1), (0, 0), (1, 1)),
                                      ((3, 3), (2, 2), (0, 0), (1, 1)),
                                      ((1, 1), (1, 1), (1, 1), (1, 1)),
                                      ((3, 1), (1, 1), (1, 0), (1, 1)),
                                      ((3, 3), (3, 3), (1, 1), (1, 1))])
def test_odd_geometries_take_route_d(geometry):
    plan = ci.plan_int8(2, 11, 13, 32, 64, *geometry, torch.bfloat16)
    assert plan.route == "general" and not plan.convert


# ---------------------------------------------------------------------------
# the plans against the kernel's limits
# ---------------------------------------------------------------------------

# a 3x3 conv's K-steps in csrc/conv_int8.cu's order (S2_TAPS, S2_FIRST,
# S2_LAST): route (b) tap by tap; route (c) by input phase (dy % 2, dx % 2)
S2_TAPS = (0, 2, 6, 8, 1, 7, 3, 5, 4)
S2_FIRST, S2_LAST = (0, 4, 6, 8), (3, 5, 7, 8)


def _steps(plan):
    """(weight tap, new A load, last use of it, row shift, phase) of each
    K-step of a chunk."""
    out = []
    for i in range(plan.taps):
        if plan.route == "1x1":
            out.append((0, True, True, 0, None))
        elif plan.route == "3x3s1":
            out.append((i, i == 0, i == 8, (i // 3) * (plan.tw + 2) + i % 3, None))
        else:
            tap = S2_TAPS[i]
            dy, dx = divmod(tap, 3)
            out.append((tap, i in S2_FIRST, i in S2_LAST, (dy // 2) * (plan.tw + 1) + dx // 2,
                        (dy % 2, dx % 2)))
    return out


def _check_limits(plan):
    """What `conv_int8_wgmma_launch` and the TMA boxes require."""
    rows, rows_s8 = plan.tile_rows(), plan.a_bytes // ci.ROW
    assert plan.route in ("1x1", "3x3s1", "3x3s2")
    assert plan.bn in (64, 128, 256) and plan.n_tiles == -(-plan.c2 // plan.bn)
    assert plan.cb in (32, 64, 128) and plan.kk == (plan.cb // 32 if plan.chunks == 1 else 4)
    assert plan.chunks == -(-plan.c1p // ci.ROW) and plan.taps == (1 if plan.route == "1x1" else 9)
    assert 1 <= plan.a_stages <= ci.MAX_STAGES and 1 <= plan.b_stages <= ci.MAX_STAGES
    assert plan.a_bytes % 1024 == 0 and plan.raw_bytes % 1024 == 0
    assert plan.smem <= ci.SMEM_LIMIT - 1024  # the static barriers fit beside it
    stage = plan.raw_bytes if plan.convert else plan.a_bytes
    assert plan.smem == (1024 + plan.b_stages * plan.bn * ci.ROW + plan.a_stages * stage
                         + plan.s8_tiles * plan.a_bytes)
    assert plan.s8_tiles == (2 if plan.convert else 0)
    if plan.res:
        assert plan.b_stages == plan.taps and plan.chunks == 1 and plan.n_tiles == 1
    if plan.convert:  # the raw rows the converters read
        raw_rows = rows if plan.route == "1x1" else plan.a_rows
        assert plan.raw_bytes >= raw_rows * 2 * plan.cb and plan.cx % 8 == 0
    # every view the K-steps take lies in the s8 tile, and the loads fill it
    assert plan.a_rows <= rows_s8
    assert max(shift for *_, shift, _ in _steps(plan)) + rows <= rows_s8
    if plan.route == "3x3s1":
        assert plan.th * (plan.tw + 2) <= rows and plan.a_rows == (plan.th + 2) * (plan.tw + 2)
        assert plan.tw + 2 <= 256 and plan.th + 2 <= 256  # the box
    elif plan.route == "3x3s2":
        assert plan.th * (plan.tw + 1) <= rows and plan.a_rows == (plan.th + 1) * (plan.tw + 1)
        assert 2 * plan.tw + 2 <= 256 and 2 * plan.th + 2 <= 256  # the strided box
    else:
        assert plan.a_rows == rows
    assert plan.tiles == plan.n_tiles * (
        -(-(plan.b * plan.ho * plan.wo) // rows) if plan.route == "1x1"
        else plan.b * plan.tiles_h * plan.tiles_w)


@pytest.mark.parametrize("name", ["ablation-ca-scconv-sppfcspc", "yolov5s", "C3CASPD2"])
def test_plans_fit_the_kernel(name):
    for (h, w, c1, c2, k, s, p, d) in _sites(name):
        for b in (1, 8, 128):
            for dt in (torch.bfloat16, torch.int8):
                plan = ci.plan_int8(b, h, w, c1, c2, (k, k), (s, s), (p, p), (d, d), dt)
                _check_limits(plan)
                assert len(plan.args(1)) == 30  # csrc/conv_int8.cu tc8::PLAN_INTS


# ---------------------------------------------------------------------------
# the kernel's tiles, emulated
# ---------------------------------------------------------------------------

def _load(plan, xq, tile, chunk, phase, rng):
    """One A load as the kernel's s8 tile holds it: the rows TMA brings
    (zeros outside the input), the rest junk."""
    b_, h0, w0, m0 = tile
    rows_s8 = plan.a_bytes // ci.ROW
    buf = torch.from_numpy(rng.integers(-127, 128, (rows_s8, ci.ROW))).long()  # junk
    c0, c1 = chunk * ci.ROW, min((chunk + 1) * ci.ROW, xq.shape[3])
    B, H, W = xq.shape[:3]

    def pixel(b, y, x):
        v = torch.zeros(ci.ROW, dtype=torch.long)
        if 0 <= b < B and 0 <= y < H and 0 <= x < W:
            v[:c1 - c0] = xq[b, y, x, c0:c1]
        return v

    if plan.route == "1x1":
        for r in range(plan.tile_rows()):
            m = m0 + r
            buf[r] = pixel(m // (H * W), m // W % H, m % W) if m < B * H * W else 0
    elif plan.route == "3x3s1":
        for i in range(plan.th + 2):
            for j in range(plan.tw + 2):
                buf[i * (plan.tw + 2) + j] = pixel(b_, h0 - 1 + i, w0 - 1 + j)
    else:
        py, px = phase
        for i in range(plan.th + 1):
            for j in range(plan.tw + 1):
                buf[i * (plan.tw + 1) + j] = pixel(b_, 2 * h0 - 1 + py + 2 * i,
                                                   2 * w0 - 1 + px + 2 * j)
    return buf


def _out_row(plan, tile, r):
    """The output pixel (b, y, x) of tile row r, or None (csrc out_row)."""
    b_, h0, w0, m0 = tile
    if plan.route == "1x1":
        m = m0 + r
        if m >= plan.b * plan.ho * plan.wo:
            return None
        return m // (plan.ho * plan.wo), m // plan.wo % plan.ho, m % plan.wo
    full = plan.tw + (2 if plan.route == "3x3s1" else 1)
    th, tw = divmod(r, full)
    y, x = h0 + th, w0 + tw
    if th >= plan.th or tw >= plan.tw or y >= plan.ho or x >= plan.wo:
        return None
    return b_, y, x


def _emulate(plan, xq, wq, seed=0):
    rng = np.random.default_rng(seed)
    rows = plan.tile_rows()
    wk = torch.zeros(plan.n_tiles * plan.bn, plan.taps, plan.chunks * ci.ROW, dtype=torch.long)
    wk[:plan.c2, :, :plan.c1p] = wq.long().reshape(plan.c2, plan.taps, plan.c1p)
    out = torch.zeros(plan.b, plan.ho, plan.wo, plan.c2, dtype=torch.long)
    hits = torch.zeros(plan.b, plan.ho, plan.wo, plan.c2, dtype=torch.long)
    for t in range(plan.tiles):
        nt, mt = t % plan.n_tiles, t // plan.n_tiles
        tw_i, rest = mt % max(plan.tiles_w, 1), mt // max(plan.tiles_w, 1)
        tile = (rest // max(plan.tiles_h, 1), rest % max(plan.tiles_h, 1) * plan.th,
                tw_i * plan.tw, mt * rows)
        acc = torch.zeros(rows, plan.bn, dtype=torch.long)
        for chunk in range(plan.chunks):
            for tap, loads, _, shift, phase in _steps(plan):
                if loads:
                    a = _load(plan, xq, tile, chunk, phase, rng)
                cols = slice(chunk * ci.ROW, (chunk + 1) * ci.ROW)
                acc += a[shift:shift + rows] @ wk[nt * plan.bn:(nt + 1) * plan.bn, tap, cols].T
        n0, n1 = nt * plan.bn, min((nt + 1) * plan.bn, plan.c2)
        for r in range(rows):
            o = _out_row(plan, tile, r)
            if o is not None:
                out[o][n0:n1] = acc[r, :n1 - n0]
                hits[o][n0:n1] += 1
    return out, hits


EMULATED = [(2, 5, 7, 24, 45, 1, 1, 0), (1, 9, 13, 136, 300, 1, 1, 0), (3, 23, 1, 48, 8, 1, 1, 0),
            (1, 300, 1, 16, 24, 3, 2, 1), (1, 300, 1, 16, 24, 3, 1, 1),
            (2, 9, 11, 24, 45, 3, 1, 1), (1, 1, 37, 40, 24, 3, 1, 1), (1, 13, 50, 136, 130, 3, 1, 1),
            (2, 9, 11, 24, 45, 3, 2, 1), (1, 9, 1, 136, 300, 3, 2, 1), (1, 17, 15, 16, 200, 3, 2, 1),
            (1, 33, 41, 32, 64, 3, 2, 1)]


@pytest.mark.parametrize("dt", ["bf16", "s8"])
@pytest.mark.parametrize("shape", EMULATED)
def test_kernel_tiles_emulated(shape, dt):
    b, h, w, c1, c2, k, s, p = shape
    rng = np.random.default_rng(sum(shape))
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, ci.padded_channels(c1)))).to(torch.int8)
    xq[..., c1:] = 0  # the pad channels, as quantize_s8 writes them
    wq = torch.from_numpy(rng.integers(-127, 128, (c2, k, k, ci.padded_channels(c1)))).to(
        torch.int8)
    wq[..., c1:] = 0
    plan = ci.plan_int8(b, h, w, c1, c2, (k, k), (s, s), (p, p), (1, 1),
                        torch.bfloat16 if dt == "bf16" else torch.int8)
    _check_limits(plan)
    got, hits = _emulate(plan, xq, wq)
    want = ci.conv_int8_plain(xq, wq, None, None, (s, s), (p, p), (1, 1), torch.int32)
    assert (hits == 1).all()  # every output once
    assert torch.equal(got, want.long())


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def test_quantize_by_magic_add_equals_rint_and_clip():
    """q8: clip(v * inv) to +-127 first, then + 1.5 * 2^23 in f32; the
    sum's low byte is rint half-to-even of the clipped product."""
    rng = np.random.default_rng(5)
    inv = np.float32(1) / np.float32(0.0137)
    x = np.concatenate([rng.normal(0, 3, 200_000), (np.arange(-300, 300) + 0.5) / inv,
                        [0.0, -0.0, 1e30, -1e30, np.inf, -np.inf, np.nan]]).astype(np.float32)
    for dt in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dt)
        v = xt.float().numpy()
        with np.errstate(invalid="ignore", over="ignore"):
            y = np.fmin(np.fmax(v * inv, np.float32(-127)), np.float32(127))  # NaN -> -127
            y = np.where(np.isnan(v), np.float32(-127), y).astype(np.float32)
            q = ((y + np.float32(12582912.0)).view(np.uint32) & 0xFF).astype(np.uint8).view(
                np.int8)
        want = ci.quantize_s8_plain(xt[~torch.isnan(xt)].reshape(1, -1), float(inv),
                                    ci.padded_channels(int((~np.isnan(v)).sum())))
        assert np.array_equal(q[~np.isnan(v)], want[0, :int((~np.isnan(v)).sum())].numpy())
        assert (q[np.isnan(v)] == -127).all()


def test_epilogue_bf16_product_is_exact_in_f32():
    """The epilogue multiplies bf16(f32(acc)) by the bf16 scale as one bf16
    multiply: that equals the f32 product then its bf16 rounding because
    the product of two bf16 values (8 significant bits each) is exact in
    f32."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, 100_000)).float().bfloat16()
    s = torch.from_numpy(rng.uniform(1e-6, 1e-1, 100_000)).float().bfloat16()
    assert torch.equal((a.float() * s.float()).double(), a.double() * s.double())
    assert torch.equal((a.float() * s.float()).bfloat16(), (a.double() * s.double()).bfloat16())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_quantize_conv_int8_plain_matches_jax(case, dt):
    """The float-input entry on a CPU tensor (its plain version) equals the
    jitted JAX program: the s32 sums, and the dequantized output in dt."""
    x, w, b, s_x, k, s, p, d = CASES[case]()
    tdt, jdt = DTYPES[dt]
    x = np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    _, _, y32_want = (np.asarray(a) for a in _jax_int8_parts(
        jnp.asarray(x), jnp.asarray(w), s_x, s, p, d, jdt))
    wq, s_w = ci.prepare_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    xt = torch.from_numpy(x.copy()).to(tdt)
    inv = ci.reciprocal_f32(s_x)
    geo = ((s, s), (p, p), (d, d))
    y32 = ci.quantize_conv_int8(xt, inv, wq, None, None, *geo, torch.int32)
    np.testing.assert_array_equal(y32.numpy(), y32_want)
    scale, bias = ci.dequant_params(s_x, s_w, torch.from_numpy(b), tdt)
    y = ci.quantize_conv_int8(xt, inv, wq, scale, bias, *geo, tdt)
    assert y.dtype == tdt
    np.testing.assert_array_equal(y.float().numpy(), _jax_conv_int8(x, w, b, s_x, k, s, p, d, jdt))
