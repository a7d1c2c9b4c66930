"""The zoo's new modules in the port against the JAX package, module by
module, on the CPU: Focus, SPP, BottleneckCSP, AdConcat2/3, CBAM, the
ViT stack (MultiheadAttention, TransformerLayer, TransformerBlock, C3TR)
and the Swin stack (WindowAttention with and without the shift mask,
SwinTransformerLayer at shift 0 and 4 on maps that divide by the window
and maps that do not, SwinTransformerBlock, C3STR); then Dropout and
DropPath against their definitions (the JAX package draws its masks from
`jax.random`, which the port cannot reproduce bit for bit).

Parameters and inputs are drawn with numpy from fixed seeds, given to the
JAX module as its flat dicts and to the port's through
`state_dict_from_jax`.  Tolerance: f32, rtol = atol = 1e-4, as for the
other blocks (`tests/test_torch_modules.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.nn import blocks as jb
from dmayolo_tpu.nn.fuse import fuse_params
from dmayolo_tpu.nn.module import make_vars
from dmayolo_tpu_torch.nn import blocks as pb
from dmayolo_tpu_torch.nn import primitives as pp
from dmayolo_tpu_torch.nn import transformer as pt
from dmayolo_tpu_torch.nn.fuse import fuse_model
from dmayolo_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_modules import TOL, nchw, nhwc


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def zoo_vars(jmod, seed=0):
    """Numpy-drawn (params, stats) with the JAX module's paths and shapes:
    kernels (conv, Dense, in_proj) N(0, 1/fan_in), BN and LayerNorm scales
    U(0.5, 1.5), the BiFPN `w` U(0.5, 1.5) (a sum near 0 would blow the
    normalised weights up), the rest N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    pshape, sshape = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    params, stats = {}, {}
    for k, s in pshape.items():
        if k[-1] in ("kernel", "in_proj_kernel"):
            v = rng.normal(0, int(np.prod(s.shape[:-1])) ** -0.5, s.shape)
        elif k[-1] in ("scale", "w"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0, 0.5, s.shape)
        params[k] = jnp.asarray(v.astype(np.float32))
    for k, s in sshape.items():
        v = rng.uniform(0.5, 1.5, s.shape) if k[-1] == "var" else rng.normal(0, 0.2, s.shape)
        stats[k] = jnp.asarray(v.astype(np.float32))
    return params, stats


def port_with(pmod, params, stats):
    pmod.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return pmod.eval()


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# map blocks: NHWC in JAX, NCHW channels_last in the port
# ---------------------------------------------------------------------------

# (name, JAX module factory, port module factory, input NHWC shape)
MAP_BLOCKS = [
    ("focus", lambda: jb.Focus(3, 16, 3), lambda: pb.Focus(3, 16, 3), (2, 12, 16, 3)),
    ("spp_5_9_13", lambda: jb.SPP(16, 16), lambda: pb.SPP(16, 16), (2, 10, 10, 16)),
    ("spp_3_5_7", lambda: jb.SPP(16, 24, [3, 5, 7]), lambda: pb.SPP(16, 24, [3, 5, 7]),
     (2, 6, 10, 16)),
    ("bottleneckcsp", lambda: jb.BottleneckCSP(16, 24, 2), lambda: pb.BottleneckCSP(16, 24, 2),
     (2, 8, 8, 16)),
    ("bottleneckcsp_noshortcut", lambda: jb.BottleneckCSP(16, 16, 1, False),
     lambda: pb.BottleneckCSP(16, 16, 1, False), (2, 8, 8, 16)),
    ("cbam", lambda: jb.CBAM(32, 32), lambda: pb.CBAM(32, 32), (2, 6, 10, 32)),
    ("transformerblock_conv", lambda: jb.TransformerBlock(16, 32, 4, 2),
     lambda: pt.TransformerBlock(16, 32, 4, 2), (2, 5, 6, 16)),
    ("c3tr", lambda: jb.C3TR(32, 32, 2), lambda: pt.C3TR(32, 32, 2), (2, 4, 6, 32)),
    ("swinblock_conv", lambda: jb.SwinTransformerBlock(32, 64, 2, 2),
     lambda: pt.SwinTransformerBlock(32, 64, 2, 2), (2, 12, 20, 32)),
    ("c3str_divides", lambda: jb.C3STR(64, 64, 2), lambda: pt.C3STR(64, 64, 2), (2, 16, 16, 64)),
    ("c3str_pads", lambda: jb.C3STR(64, 64, 2), lambda: pt.C3STR(64, 64, 2), (2, 10, 20, 64)),
]


@pytest.mark.parametrize("name,jfac,pfac,shape", MAP_BLOCKS, ids=[m[0] for m in MAP_BLOCKS])
def test_map_block_matches_jax(name, jfac, pfac, shape):
    jmod, pmod = jfac(), pfac()
    params, stats = zoo_vars(jmod)
    x = _x(shape)
    want = np.asarray(jmod(make_vars(params, stats), jnp.asarray(x)))
    got = port_with(pmod, params, stats)(nchw(x), torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert tuple(got.shape) == (want.shape[0], want.shape[3], want.shape[1], want.shape[2])
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_bottleneckcsp_bn_is_not_folded():
    """`bn` normalises a concat of two convs: no conv feeds it alone, so
    `fuse_model` leaves it a BatchNorm2d (eval mode), as `fuse_params`
    keeps its scale and statistics; the fused block equals JAX's."""
    jmod, pmod = jb.BottleneckCSP(16, 24, 2), pb.BottleneckCSP(16, 24, 2)
    params, stats = zoo_vars(jmod)
    fp, fs = fuse_params(jmod, params, stats)
    assert ("bn", "scale") in fp and ("bn", "mean") in fs
    pmod = fuse_model(port_with(pmod, params, stats))
    assert isinstance(pmod.bn, pp.BatchNorm2d) and not pmod.bn.training
    assert isinstance(pmod.cv1.bn, pp.Identity) and isinstance(pmod.cv4.bn, pp.Identity)
    assert set(pmod.state_dict()) == set(state_dict_from_jax(fp, fs))
    x = _x((2, 8, 8, 16), 2)
    want = np.asarray(jmod(make_vars(fp, fs, fused=True), jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(pmod(nchw(x), torch.float32)), want, **TOL)


@pytest.mark.parametrize("n_in", [2, 3])
def test_adconcat_matches_jax(n_in):
    jmod = jb.AdConcat2() if n_in == 2 else jb.AdConcat3()
    pmod = pb.AdConcat2() if n_in == 2 else pb.AdConcat3()
    params, stats = zoo_vars(jmod)
    xs = [_x((2, 4, 6, c), 3 + c) for c in (8, 16, 24)[:n_in]]
    want = np.asarray(jmod(make_vars(params, stats), [jnp.asarray(x) for x in xs]))
    got = port_with(pmod, params, stats)([nchw(x) for x in xs], torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_in", [2, 3])
def test_adconcat_bf16_is_the_jax_value_rounded_once(n_in):
    """On bf16 inputs JAX's f32 weight times the bf16 map promotes to f32,
    and the next conv rounds the product to bf16.  The port keeps its
    concat in bf16 and takes each product in f32 first, so its values are
    JAX's rounded once to bf16, exactly.  (torch's own `w[i] * x` would
    not be: it rounds the 0-d f32 weight to bf16 before the product, off
    in a tenth to a fifth of the elements here.)"""
    jmod = jb.AdConcat2() if n_in == 2 else jb.AdConcat3()
    pmod = pb.AdConcat2() if n_in == 2 else pb.AdConcat3()
    params, stats = {("w",): jnp.asarray([0.61, 1.37, 0.9][:n_in], jnp.float32)}, {}
    xs = [_x((2, 8, 8, 16), 7 + i) for i in range(n_in)]
    xb = [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]
    want = jmod(make_vars(params, stats, dtype=jnp.bfloat16), xb)
    assert want.dtype == jnp.float32
    want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    got = port_with(pmod, params, stats)(
        [nchw(np.asarray(x.astype(jnp.float32))).bfloat16() for x in xb], torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(got.float()), want)
    w = pmod.w / (pmod.w.sum() + 1e-4)
    naive = torch.cat([w[i] * nchw(np.asarray(x.astype(jnp.float32))).bfloat16()
                       for i, x in enumerate(xb)], 1)
    assert (nhwc(naive.float()) != want).mean() > 0.05


def test_c3str_needs_32_hidden_channels():
    with pytest.raises(ValueError, match="32 hidden channels"):
        pt.C3STR(32, 32, 1)
    with pytest.raises(ValueError, match="32 hidden channels"):
        jb.C3STR(32, 32, 1)
    pt.C3STR(64, 64, 1)


# ---------------------------------------------------------------------------
# token modules and the Swin layer: the same layout in both packages
# ---------------------------------------------------------------------------

def _shift_mask(hp, wp, shift):
    return jnp.asarray(jb._swin_attn_mask(hp, wp, 8, shift))


# (name, JAX module factory, port module factory, input shape, JAX call, port call)
TOKEN_MODULES = [
    ("linear", lambda: jb.Dense(16, 24), lambda: pp.Linear(16, 24), (2, 5, 16), None, None),
    ("linear_nobias", lambda: jb.Dense(16, 24, bias=False),
     lambda: pp.Linear(16, 24, bias=False), (3, 16), None, None),
    ("layernorm", lambda: jb.LayerNorm(24), lambda: pp.LayerNorm(24), (2, 5, 24), None, None),
    ("mlp", lambda: jb.Mlp(16, 64), lambda: pt.Mlp(16, 64), (2, 5, 16), None, None),
    ("multihead_attention", lambda: jb.MultiheadAttention(32, 4),
     lambda: pt.MultiheadAttention(32, 4), (2, 7, 32),
     lambda m, v, x: m(v, (x, 0.5 * x, -x)), lambda m, x, d: m((x, 0.5 * x, -x), d)),
    ("transformer_layer", lambda: jb.TransformerLayer(32, 4), lambda: pt.TransformerLayer(32, 4),
     (2, 9, 32), None, None),
    ("window_attention", lambda: jb.WindowAttention(64, 8, 2), lambda: pt.WindowAttention(64, 8, 2),
     (8, 64, 64), lambda m, v, x: m(v, x, None), lambda m, x, d: m(x, None, d)),
    # two images of 2 x 2 windows (a padded 16 x 16 map), shift 4
    ("window_attention_mask", lambda: jb.WindowAttention(64, 8, 2),
     lambda: pt.WindowAttention(64, 8, 2), (8, 64, 64),
     lambda m, v, x: m(v, x, _shift_mask(16, 16, 4)),
     lambda m, x, d: m(x, pt.swin_attn_mask(16, 16, 8, 4, x.device), d)),
]
# Swin layers on NHWC maps: 16 x 24 divides by the window (2 x 3 windows),
# 12 x 20 does not (padded to 16 x 24); shift 0 and 4; 16 heads (drop path
# 0.1, the identity in eval mode) on one
for (h, w) in ((16, 24), (12, 20)):
    for shift in (0, 4):
        TOKEN_MODULES.append(
            (f"swin_layer_{h}x{w}_shift{shift}",
             (lambda s: lambda: jb.SwinTransformerLayer(64, 2, 8, s))(shift),
             (lambda s: lambda: pt.SwinTransformerLayer(64, 2, 8, s))(shift),
             (2, h, w, 64), None, None))
TOKEN_MODULES.append(("swin_layer_16_heads", lambda: jb.SwinTransformerLayer(128, 16, 8, 4),
                      lambda: pt.SwinTransformerLayer(128, 16, 8, 4), (1, 9, 10, 128), None,
                      None))


@pytest.mark.parametrize("name,jfac,pfac,shape,jcall,pcall", TOKEN_MODULES,
                         ids=[m[0] for m in TOKEN_MODULES])
def test_token_module_matches_jax(name, jfac, pfac, shape, jcall, pcall):
    jmod, pmod = jfac(), pfac()
    params, stats = zoo_vars(jmod)
    x = _x(shape)
    jcall = jcall or (lambda m, v, x: m(v, x))
    pcall = pcall or (lambda m, x, d: m(x, d))
    want = np.asarray(jcall(jmod, make_vars(params, stats), jnp.asarray(x)))
    got = pcall(port_with(pmod, params, stats), torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_swin_helpers_match_jax():
    for m in (4, 8):
        np.testing.assert_array_equal(pt._relative_position_index(m),
                                      jb._relative_position_index(m))
        np.testing.assert_array_equal(pt.relative_position_index(m, "cpu").numpy(),
                                      jb._relative_position_index(m).reshape(-1))
    for hp, wp in ((8, 8), (16, 24), (24, 24)):
        for shift in (2, 4):
            np.testing.assert_array_equal(pt._swin_attn_mask(hp, wp, 8, shift),
                                          jb._swin_attn_mask(hp, wp, 8, shift))
    # cached once a size and device
    assert pt.swin_attn_mask(16, 24, 8, 4, "cpu") is pt.swin_attn_mask(16, 24, 8, 4, "cpu")
    x = jnp.asarray(_x((2, 16, 24, 5)))
    xt = torch.from_numpy(np.asarray(x))
    win = pt.window_partition(xt, 8)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jb.window_partition(x, 8)))
    np.testing.assert_array_equal(pt.window_reverse(win, 8, 16, 24).numpy(), np.asarray(x))


def test_bf16_attention_logits_are_f32():
    """In bf16 the logits are taken in f32 from the bf16 q and k, as JAX's
    `preferred_element_type=float32` does: the window attention's output
    equals JAX's bf16 one to within a bf16 ulp of the output."""
    jmod, pmod = jb.WindowAttention(64, 8, 2), pt.WindowAttention(64, 8, 2)
    params, stats = zoo_vars(jmod, seed=3)
    x = _x((4, 64, 64), 4)
    want = np.asarray(jmod(make_vars(params, stats, dtype=jnp.bfloat16),
                           jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = port_with(pmod, params, stats)(torch.from_numpy(x).bfloat16(), None, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.detach().float().numpy() - want)
    assert err.max() <= 2 ** -7 * np.abs(want).max(), err.max()


def test_swin_on_the_meta_device():
    """The stride probe runs the model on meta tensors: pad, roll, the
    mask and the index work there, and the block keeps channels_last."""
    with torch.device("meta"):
        m = pt.C3STR(64, 64, 2)
        y = m(torch.empty(1, 64, 12, 20).to(memory_format=torch.channels_last), torch.float32)
    assert y.shape == (1, 64, 12, 20) and y.is_meta


def test_weights_round_trip_for_the_new_leaves():
    """JAX -> port -> JAX is the identity on a module with every new leaf:
    Dense kernels, LayerNorm scales, in_proj, the bias table, AdConcat w;
    HorBlock's gamma1/gamma2, Adapt_Add2/3's and the weighted Sum's w, the
    ACON p1/p2/beta."""
    from dmayolo_tpu.nn import activations as ja
    from dmayolo_tpu_torch.nn import activations as pa
    from dmayolo_tpu_torch.nn import fusion as pf
    from dmayolo_tpu_torch.nn import hornet as ph

    for jmod, pmod in ((jb.C3TR(32, 32, 1), pt.C3TR(32, 32, 1)),
                       (jb.C3STR(64, 64, 1), pt.C3STR(64, 64, 1)),
                       (jb.AdConcat3(), pb.AdConcat3()), (jb.CBAM(32, 32), pb.CBAM(32, 32)),
                       (jb.C3HB(64, 64, 2), ph.C3HB(64, 64, 2)),
                       (jb.AdaptAdd2(), pf.AdaptAdd2()),
                       (jb.AdaptAdd3(16, 16, 24), pf.AdaptAdd3(16, 16, 24)),
                       (jb.Sum(3, True), pb.Sum(3, True)), (ja.AconC(16), pa.AconC(16)),
                       (ja.MetaAconC(32), pa.MetaAconC(32))):
        params, stats = zoo_vars(jmod)
        port_with(pmod, params, stats)
        p2, s2 = jax_from_state_dict(pmod)
        assert set(p2) == set(params) and set(s2) == set(stats)
        for k, v in params.items():
            np.testing.assert_array_equal(p2[k], np.asarray(v))


# ---------------------------------------------------------------------------
# Dropout and DropPath against their definitions
# ---------------------------------------------------------------------------

def _stochastic(cls, rate, seed=0):
    m = cls(rate).train()
    m.generator = torch.Generator().manual_seed(seed)
    return m


@pytest.mark.parametrize("cls", [pp.Dropout, pp.DropPath])
def test_stochastic_identity_in_eval_and_at_rate_0(cls):
    x = torch.from_numpy(_x((4, 3, 5, 6)))
    assert cls(0.3).eval()(x) is x
    assert cls(0.0).train()(x) is x  # no generator needed: nothing drawn
    with pytest.raises(RuntimeError, match="generator"):
        cls(0.3).train()(x)


def test_dropout_definition():
    rate, x = 0.3, torch.from_numpy(_x((64, 32, 16), 2)) + 5.0  # no zeros in x
    y = _stochastic(pp.Dropout, rate)(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01  # 32,768 draws: 5 sigma 0.013
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=0, atol=0)
    np.testing.assert_array_equal(_stochastic(pp.Dropout, rate)(x).numpy(), y.numpy())
    assert not torch.equal(_stochastic(pp.Dropout, rate, seed=1)(x), y)


def test_droppath_definition():
    rate, x = 0.25, torch.from_numpy(_x((4096, 3, 2, 2), 3)) + 5.0
    y = _stochastic(pp.DropPath, rate)(x)
    kept = (y != 0).flatten(1)
    assert bool((kept.all(1) | ~kept.any(1)).all())  # whole samples
    share = kept.all(1).float().mean().item()
    assert abs(share - (1 - rate)) < 0.035  # 4096 samples: 5 sigma 0.034
    rows = kept.all(1)
    torch.testing.assert_close(y[rows], x[rows] / (1 - rate), rtol=0, atol=0)
    np.testing.assert_array_equal(_stochastic(pp.DropPath, rate)(x).numpy(), y.numpy())


def test_lend_generator_reaches_every_layer_and_leaves():
    m = pt.SwinTransformerLayer(128, 16, 8, 0).train()
    assert m.drop_path.rate == 0.1
    g = torch.Generator().manual_seed(0)
    with pp.lend_generator(m, g):
        assert m.drop_path.generator is g and m.mlp.drop.generator is g
    assert m.drop_path.generator is None and m.mlp.drop.generator is None
