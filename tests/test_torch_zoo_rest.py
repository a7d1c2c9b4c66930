"""The rest of the zoo's modules in the port against the JAX package, on
the CPU: ConvBN's string activations, DWConv, Ghost v1 (GhostConv,
GhostBottleneck at stride 1 and 2, C3Ghost), GhostNet v2 (ConvUnit with
each activation, SE, GhostModule, GhostModuleMul with its DFC gate on
even, odd and 1 x 1-pooled maps, Ghostblockv2 plain and with dw, SE and
shortcut, C3GhostV2), HorNet (GnConv, HorBlock, C3HB), ConvMixer
(ConvMix, CSPCM), the DM/SM downsamplers (SM, MP, SMMConv, DMMConv,
DMMConv2, DMConv), the adaptive fusions (AddConvBlock, AdaptADD and
AdaptConcat on 2 and 3 levels, Adapt_Add2/3, ASFF at each level), the
experimental and hub blocks (C3SPP, ASPP, SPPCSPC, BAM, Contract,
Expand, CrossConv, Sum plain and weighted, DMMixConv2d and MixConv2d on
both channel splits, Classify, MaxPool2d, ZeroPad2d, nn.BatchNorm2d) and
the learnable activations (FReLU, AconC, MetaAconC).

Parameters and inputs are numpy-drawn from fixed seeds
(`tests/test_torch_zoo_blocks.py::zoo_vars`), the JAX side under
`jax.jit`.  Tolerances:
- f32: rtol = atol = 1e-4, the other blocks' (`tests/test_torch_modules.py`).
- bf16 (inputs and compute dtype bf16 in both packages): the output dtype
  is JAX's (f32 where JAX promotes: GhostModuleMul's bilinear gate,
  HorBlock's LayerScale, Adapt_Add2/3's f32 weights, the weighted Sum, the
  ACON parameters), and the port's bf16 output is no further from JAX's
  bf16 one than twice JAX's own bf16-to-f32 distance plus bf16's rounding
  (2^-8), relative to the output's largest magnitude (the rule of
  `tests/test_torch_spd.py::test_bf16_raw_head_matches_jax`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.nn import activations as ja
from dmayolo_tpu.nn import blocks as jb
from dmayolo_tpu.nn import primitives as jp
from dmayolo_tpu.nn.fuse import fuse_params
from dmayolo_tpu.nn.module import make_vars
from dmayolo_tpu_torch.nn import activations as pa
from dmayolo_tpu_torch.nn import blocks as pb
from dmayolo_tpu_torch.nn import fusion as pf
from dmayolo_tpu_torch.nn import ghost as pg
from dmayolo_tpu_torch.nn import hornet as ph
from dmayolo_tpu_torch.nn import primitives as pp
from dmayolo_tpu_torch.nn.fuse import fuse_model
from dmayolo_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_modules import TOL, nchw, nhwc
from tests.test_torch_zoo_blocks import _x, port_with, zoo_vars

ACTS = ("leaky0.1", "mish", "hardswish", "relu", "gelu", "sigmoid", "identity")

# (name, JAX module factory, port module factory, input NHWC shape, or a
# list of shapes for a block that takes a list)
MAP_BLOCKS = [
    *[(f"convbn_{a}", (lambda a: lambda: jb.ConvBN(16, 24, 3, 1, None, 1, a))(a),
       (lambda a: lambda: pb.ConvBN(16, 24, 3, 1, None, 1, a))(a), (2, 6, 8, 16)) for a in ACTS],
    ("dwconv_s2", lambda: jb.DWConv(16, 32, 3, 2), lambda: pb.DWConv(16, 32, 3, 2), (2, 8, 10, 16)),
    # Ghost v1
    ("ghostconv", lambda: jb.GhostConv(16, 32, 3, 2), lambda: pg.GhostConv(16, 32, 3, 2),
     (2, 8, 8, 16)),
    ("ghostbottleneck", lambda: jb.GhostBottleneck(32, 32), lambda: pg.GhostBottleneck(32, 32),
     (2, 6, 6, 32)),
    ("ghostbottleneck_s2", lambda: jb.GhostBottleneck(16, 32, 3, 2),
     lambda: pg.GhostBottleneck(16, 32, 3, 2), (2, 8, 8, 16)),
    ("c3ghost", lambda: jb.C3Ghost(32, 32, 2), lambda: pg.C3Ghost(32, 32, 2), (2, 6, 6, 32)),
    # GhostNet v2
    *[(f"convunit_{a}", (lambda a: lambda: jb.ConvUnit(16, 24, 3, 2, 1, act_type=a))(a),
       (lambda a: lambda: pg.ConvUnit(16, 24, 3, 2, 1, act_type=a))(a), (2, 8, 8, 16))
      for a in ("relu", "relu6", "sigmoid", "hsigmoid", "hswish")],
    ("se", lambda: jb.SE(32), lambda: pg.SE(32), (2, 5, 6, 32)),
    ("ghostmodule", lambda: jb.GhostModule(16, 24), lambda: pg.GhostModule(16, 24), (2, 6, 6, 16)),
    ("ghostmodulemul_even", lambda: jb.GhostModuleMul(16, 24), lambda: pg.GhostModuleMul(16, 24),
     (2, 8, 12, 16)),
    ("ghostmodulemul_odd", lambda: jb.GhostModuleMul(16, 24), lambda: pg.GhostModuleMul(16, 24),
     (2, 7, 9, 16)),
    ("ghostmodulemul_1x1_gate", lambda: jb.GhostModuleMul(16, 24),
     lambda: pg.GhostModuleMul(16, 24), (2, 3, 2, 16)),
    ("ghostblockv2", lambda: jb.Ghostblockv2(16, 16, 16), lambda: pg.Ghostblockv2(16, 16, 16),
     (2, 6, 8, 16)),
    ("ghostblockv2_dw_se_shortcut", lambda: jb.Ghostblockv2(16, 16, 24, 3, 2, use_se=True),
     lambda: pg.Ghostblockv2(16, 16, 24, 3, 2, use_se=True), (2, 8, 8, 16)),
    ("c3ghostv2", lambda: jb.C3GhostV2(32, 32, 2), lambda: pg.C3GhostV2(32, 32, 2),
     (2, 6, 10, 32)),
    # HorNet (c divisible by 16: GnConv's split)
    ("gnconv", lambda: jb.GnConv(32, 32), lambda: ph.GnConv(32, 32), (2, 6, 8, 32)),
    ("gnconv_k3_s2", lambda: jb.GnConv(32, 40, 3, 2), lambda: ph.GnConv(32, 40, 3, 2),
     (2, 8, 8, 32)),
    ("horblock", lambda: jb.HorBlock(32), lambda: ph.HorBlock(32), (2, 6, 8, 32)),
    ("c3hb", lambda: jb.C3HB(64, 64, 2), lambda: ph.C3HB(64, 64, 2), (2, 6, 6, 64)),
    # ConvMixer
    ("convmix", lambda: jb.ConvMix(16, 16), lambda: pb.ConvMix(16, 16), (2, 10, 12, 16)),
    ("cspcm", lambda: jb.CSPCM(32, 32, 2), lambda: pb.CSPCM(32, 32, 2), (2, 8, 8, 32)),
    # DM/SM downsamplers
    ("sm", lambda: jb.SM(), lambda: pb.SM(), (2, 6, 8, 16)),
    ("mp", lambda: jb.MP(2), lambda: pb.MP(2), (2, 6, 8, 16)),
    ("smmconv", lambda: jb.SMMConv(16, 16), lambda: pb.SMMConv(16, 16), (2, 6, 8, 16)),
    ("dmmconv2", lambda: jb.DMMConv2(16, 8), lambda: pb.DMMConv2(16, 8), (2, 6, 8, 16)),
    ("dmmconv", lambda: jb.DMMConv(16, 8), lambda: pb.DMMConv(16, 8), (2, 6, 8, 16)),
    ("dmconv", lambda: jb.DMConv(16, 8), lambda: pb.DMConv(16, 8), (2, 6, 8, 16)),
    # the adaptive fusions
    ("addconvblock_s2", lambda: jb.AddConvBlock(16, 24, 3, 2),
     lambda: pf.AddConvBlock(16, 24, 3, 2), (2, 8, 8, 16)),
    ("adaptadd_2", lambda: jb.AdaptADD(2, 24, 1, 16, 16), lambda: pf.AdaptADD(2, 24, 1, 16, 16),
     [(2, 6, 8, 16)] * 2),
    ("adaptadd_3", lambda: jb.AdaptADD(3, 24, 1, 16, 16, 8),
     lambda: pf.AdaptADD(3, 24, 1, 16, 16, 8), [(2, 6, 8, 16), (2, 6, 8, 16), (2, 6, 8, 8)]),
    ("adaptconcat_2", lambda: jb.AdaptConcat(2, 1, 16, 24), lambda: pf.AdaptConcat(2, 1, 16, 24),
     [(2, 6, 8, 16), (2, 6, 8, 24)]),
    ("adaptconcat_3", lambda: jb.AdaptConcat(3, 1, 16, 24, 8),
     lambda: pf.AdaptConcat(3, 1, 16, 24, 8), [(2, 6, 8, 16), (2, 6, 8, 24), (2, 6, 8, 8)]),
    ("adapt_add2", lambda: jb.AdaptAdd2(), lambda: pf.AdaptAdd2(), [(2, 6, 8, 16)] * 2),
    ("adapt_add3", lambda: jb.AdaptAdd3(16, 16, 24), lambda: pf.AdaptAdd3(16, 16, 24),
     [(2, 6, 8, 16), (2, 6, 8, 16), (2, 6, 8, 24)]),
    *[(f"asff_{lv}", (lambda lv: lambda: jb.ASFF(lv))(lv), (lambda lv: lambda: pf.ASFF(lv))(lv),
       [(1, 2, 2, 512), (1, 4, 4, 256), (1, 8, 8, 256)]) for lv in range(3)],
    # experimental and hub blocks
    ("c3spp", lambda: jb.C3SPP(16, 32), lambda: pb.C3SPP(16, 32), (2, 8, 8, 16)),
    ("aspp", lambda: jb.ASPP(16, 24), lambda: pb.ASPP(16, 24), (2, 10, 10, 16)),
    ("sppcspc", lambda: jb.SPPCSPC(16, 24), lambda: pb.SPPCSPC(16, 24), (2, 8, 10, 16)),
    ("bam", lambda: jb.BAM(32, 32, 1), lambda: pb.BAM(32, 32, 1), (2, 6, 8, 32)),
    ("contract", lambda: jb.Contract(2), lambda: pb.Contract(2), (2, 6, 8, 8)),
    ("expand", lambda: jb.Expand(2), lambda: pb.Expand(2), (2, 3, 4, 16)),
    ("crossconv", lambda: jb.CrossConv(16, 16, 3, 1, 1, 1.0, True),
     lambda: pb.CrossConv(16, 16, 3, 1, 1, 1.0, True), (2, 6, 8, 16)),
    ("sum", lambda: jb.Sum(3), lambda: pb.Sum(3), [(2, 4, 6, 16)] * 3),
    ("sum_weighted", lambda: jb.Sum(3, True), lambda: pb.Sum(3, True), [(2, 4, 6, 16)] * 3),
    ("dmmixconv2d", lambda: jb.DMMixConv2d(16, 24), lambda: pb.DMMixConv2d(16, 24),
     (2, 6, 8, 16)),
    ("mixconv2d_equal_params", lambda: jb.MixConv2d(16, 32, (3, 5, 7), 1, False),
     lambda: pb.MixConv2d(16, 32, (3, 5, 7), 1, False), (2, 8, 8, 16)),
    ("classify", lambda: jb.Classify(16, 10), lambda: pb.Classify(16, 10), (2, 5, 6, 16)),
    ("classify_list", lambda: jb.Classify(24, 10), lambda: pb.Classify(24, 10),
     [(2, 5, 6, 16), (2, 3, 3, 8)]),
    ("maxpool2d_2_1_0", lambda: jb.MaxPool2d(2, 1, 0), lambda: pb.MaxPool2d(2, 1, 0),
     (2, 5, 6, 8)),
    ("maxpool2d_3_2_1", lambda: jb.MaxPool2d(3, 2, 1), lambda: pb.MaxPool2d(3, 2, 1),
     (2, 7, 6, 8)),
    ("zeropad2d", lambda: jb.ZeroPad2d([0, 1, 2, 3]), lambda: pb.ZeroPad2d([0, 1, 2, 3]),
     (2, 5, 6, 8)),
    ("batchnorm2d_row", lambda: jp.BatchNorm2d(16), lambda: pp.BatchNorm2d(16), (2, 5, 6, 16)),
    # learnable activations
    ("frelu", lambda: ja.FReLU(16), lambda: pa.FReLU(16), (2, 6, 8, 16)),
    ("aconc", lambda: ja.AconC(16), lambda: pa.AconC(16), (2, 6, 8, 16)),
    ("metaaconc", lambda: ja.MetaAconC(32), lambda: pa.MetaAconC(32), (2, 6, 8, 32)),
]
IDS = [m[0] for m in MAP_BLOCKS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=1):
    """NHWC numpy input(s): one array, or a list for a list shape."""
    if isinstance(shape, list):
        return [_x(s, seed + i) for i, s in enumerate(shape)]
    return _x(shape, seed)


@functools.lru_cache(maxsize=None)
def _jax_fn(name, bf16):
    jfac = MAP_BLOCKS[IDS.index(name)][1]
    jmod = jfac()
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return jmod, jax.jit(lambda p, s, x: jmod(make_vars(p, s, dtype=dt), x))


def _run_jax(name, params, stats, x, bf16=False):
    _, fn = _jax_fn(name, bf16)
    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if bf16 else jnp.asarray
    return fn(params, stats, [cast(a) for a in x] if isinstance(x, list) else cast(x))


def _to_port(x, dtype=torch.float32):
    if isinstance(x, list):
        return [nchw(a).to(dtype) for a in x]
    return nchw(x).to(dtype)


def _as_nhwc(t):
    """The port's output as the JAX layout: NCHW maps to NHWC, (B, C) as is."""
    return t.detach().float().numpy() if t.dim() == 2 else nhwc(t.float())


@pytest.mark.parametrize("name,jfac,pfac,shape", MAP_BLOCKS, ids=IDS)
def test_map_block_matches_jax(name, jfac, pfac, shape):
    jmod, _ = _jax_fn(name, False)
    params, stats = zoo_vars(jmod)
    x = _inputs(shape)
    want = np.asarray(_run_jax(name, params, stats, x))
    got = port_with(pfac(), params, stats)(_to_port(x), torch.float32)
    if got.dim() == 4:
        assert tuple(got.shape) == (want.shape[0], want.shape[3], want.shape[1], want.shape[2])
    np.testing.assert_allclose(_as_nhwc(got), want, **TOL)


@pytest.mark.parametrize("name,jfac,pfac,shape", MAP_BLOCKS, ids=IDS)
def test_map_block_bf16_dtype_and_values(name, jfac, pfac, shape):
    jmod, _ = _jax_fn(name, True)
    params, stats = zoo_vars(jmod, seed=2)
    x = _inputs(shape, seed=3)
    want = _run_jax(name, params, stats, x, bf16=True)
    f32 = np.asarray(_run_jax(name, params, stats, x))
    # the port sees the same bf16 inputs
    xb = ([np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) for a in x]
          if isinstance(x, list) else
          np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)))
    with torch.inference_mode():
        got = port_with(pfac(), params, stats)(_to_port(xb, torch.bfloat16), torch.bfloat16)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    w = np.asarray(want.astype(jnp.float32))
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(_as_nhwc(got) - w).max()) / scale
    ref = float(np.abs(w - f32).max()) / scale
    assert err <= 2 * ref + 2 ** -8, (err, ref)


# ---------------------------------------------------------------------------
# BN folding of the new pairs, init
# ---------------------------------------------------------------------------

# (JAX module, port module, input) whose BNs `fuse_params` folds or keeps
FUSE_CASES = {
    "addconvblock": (lambda: jb.AdaptADD(3, 24, 1, 16, 16, 8),
                     lambda: pf.AdaptADD(3, 24, 1, 16, 16, 8),
                     [(2, 6, 8, 16), (2, 6, 8, 16), (2, 6, 8, 8)]),
    "convunit": (lambda: jb.Ghostblockv2(16, 16, 24, 3, 2, use_se=True),
                 lambda: pg.Ghostblockv2(16, 16, 24, 3, 2, use_se=True), (2, 8, 8, 16)),
    "convmix": (lambda: jb.CSPCM(32, 32, 1), lambda: pb.CSPCM(32, 32, 1), (2, 8, 8, 32)),
    "dmmixconv2d": (lambda: jb.DMMixConv2d(16, 24), lambda: pb.DMMixConv2d(16, 24),
                    (2, 6, 8, 16)),
}


@pytest.mark.parametrize("case", list(FUSE_CASES))
def test_fuse_folds_the_new_pairs_as_jax(case):
    """`fuse_model` folds AddConvBlock's conv -> batch_norm and ConvUnit's
    conv -> bn, and leaves ConvMix's BNs (after a GELU) and DMMixConv2d's
    (over a concat) BatchNorm2d in eval mode, as `fuse_params` keeps their
    scales and statistics; the folded block equals JAX's folded one."""
    jfac, pfac, shape = FUSE_CASES[case]
    jmod = jfac()
    params, stats = zoo_vars(jmod)
    fp, fs = fuse_params(jmod, params, stats)
    pmod = fuse_model(port_with(pfac(), params, stats))
    assert set(pmod.state_dict()) == set(state_dict_from_jax(fp, fs))
    kept = [m for m in pmod.modules() if isinstance(m, pp.BatchNorm2d)]
    if case in ("addconvblock", "convunit"):
        assert not kept and not fs
    else:
        assert kept and len(kept) == len({k[:-1] for k in fs})
    x = _inputs(shape, seed=2)
    jx = [jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
    want = np.asarray(jmod(make_vars(fp, fs, fused=True), jx))
    np.testing.assert_allclose(_as_nhwc(pmod(_to_port(x), torch.float32)), want, **TOL)


def test_new_parameters_take_the_jax_init():
    """`reset_parameters` gives HorBlock's gammas 1e-6, the Adapt_Add
    weights 1, the weighted Sum's w -arange(1, n) / 2 and ACON's beta 1,
    as JAX's init does; p1 and p2 are drawn."""
    g = torch.Generator().manual_seed(0)
    cases = ((jb.HorBlock(32), ph.HorBlock(32)),
             (jb.AdaptAdd3(16, 16, 24), pf.AdaptAdd3(16, 16, 24)),
             (jb.Sum(4, True), pb.Sum(4, True)), (ja.AconC(16), pa.AconC(16)))
    for jmod, pmod in cases:
        params, _ = jax.jit(jmod.init)(jax.random.PRNGKey(0))
        for m in pmod.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(g)
        own = dict(pmod.named_parameters())
        for path, v in params.items():
            if path[-1] in ("gamma1", "gamma2", "w", "beta"):
                np.testing.assert_array_equal(own[".".join(path)].detach().numpy(),
                                              np.asarray(v))


def test_bilinear_resize_matches_jax():
    """The DFC gate's resize: f32 weights (a bf16 map comes back f32), the
    1 x 1 case a broadcast in the map's own dtype."""
    for shape, size in (((2, 3, 4, 5), (7, 9)), ((1, 2, 2, 3), (5, 3)), ((2, 1, 1, 4), (3, 5))):
        x = _x(shape, 4)
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = jb._bilinear_resize_align_corners(jnp.asarray(x).astype(jdt), size)
            got = pp.bilinear_resize_align_corners(nchw(x).to(tdt), size)
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_allclose(nhwc(got.float()), np.asarray(want.astype(jnp.float32)),
                                       rtol=1e-6, atol=1e-6)
