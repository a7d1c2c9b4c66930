"""The port's leaf layers, blocks, Detect head and BN folding against the
JAX package, module by module, on the CPU.

Parameters and inputs are drawn with numpy from fixed seeds, given to the
JAX module as its flat dicts and to the port's module through
`state_dict_from_jax`.  Tolerance: f32, rtol = atol = 1e-4 (the two
frameworks sum convolutions in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.nn import blocks as jb
from dmayolo_tpu.nn import heads as jh
from dmayolo_tpu.nn import primitives as jp
from dmayolo_tpu.nn.fuse import fuse_params
from dmayolo_tpu.nn.module import make_vars
from dmayolo_tpu_torch.nn import blocks as pb
from dmayolo_tpu_torch.nn import heads as ph
from dmayolo_tpu_torch.nn import primitives as pp
from dmayolo_tpu_torch.nn.fuse import fuse_model
from dmayolo_tpu_torch.utils.weights import state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


def random_vars(jmod, seed=0):
    """Numpy-drawn (params, stats) with the JAX module's paths and shapes."""
    rng = np.random.default_rng(seed)
    pshape, sshape = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    params, stats = {}, {}
    for k, s in pshape.items():
        if k[-1] == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.normal(0, fan_in ** -0.5, s.shape)
        elif k[-1] == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0, 0.5, s.shape)
        params[k] = jnp.asarray(v.astype(np.float32))
    for k, s in sshape.items():
        v = rng.uniform(0.5, 1.5, s.shape) if k[-1] == "var" else rng.normal(0, 0.2, s.shape)
        stats[k] = jnp.asarray(v.astype(np.float32))
    return params, stats


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def port_with(pmod, params, stats):
    pmod.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return pmod.eval()


# (name, JAX module factory, port module factory, input NHWC shape)
MODULES = [
    ("conv3x3_s2_bias", lambda: jp.Conv2d(8, 16, 3, 2), lambda: pp.Conv2d(8, 16, 3, 2), (2, 12, 12, 8)),
    ("conv6x6_stem", lambda: jp.Conv2d(3, 8, 6, 2, 2, bias=False),
     lambda: pp.Conv2d(3, 8, 6, 2, 2, bias=False), (2, 16, 16, 3)),
    ("batchnorm", lambda: jp.BatchNorm2d(8), lambda: pp.BatchNorm2d(8), (2, 6, 6, 8)),
    ("convbn", lambda: jb.ConvBN(8, 16, 3, 1), lambda: pb.ConvBN(8, 16, 3, 1), (2, 10, 10, 8)),
    ("bottleneck", lambda: jb.Bottleneck(16, 16), lambda: pb.Bottleneck(16, 16), (2, 8, 8, 16)),
    ("c3", lambda: jb.C3(16, 24, 2), lambda: pb.C3(16, 24, 2), (2, 8, 8, 16)),
    ("c3_noshortcut", lambda: jb.C3(16, 16, 1, False), lambda: pb.C3(16, 16, 1, False), (2, 8, 8, 16)),
    ("sppf", lambda: jb.SPPF(16, 16), lambda: pb.SPPF(16, 16), (2, 8, 8, 16)),
    ("coorattention", lambda: jb.CoorAttention(16, 16), lambda: pb.CoorAttention(16, 16), (2, 6, 10, 16)),
    ("sppfcspc", lambda: jb.SPPFCSPC(16, 16), lambda: pb.SPPFCSPC(16, 16), (2, 8, 8, 16)),
    ("scconv_blocked_gate", lambda: jb.SCConv(8, 16, 2), lambda: pb.SCConv(8, 16, 2), (2, 16, 16, 8)),
    ("scconv_resize_gate", lambda: jb.SCConv(8, 16, 2), lambda: pb.SCConv(8, 16, 2), (2, 6, 10, 8)),
    ("upsample", lambda: jb.Upsample(None, 2, "nearest"), lambda: pb.Upsample(None, 2, "nearest"),
     (2, 4, 6, 8)),
]


@pytest.mark.parametrize("name,jfac,pfac,shape", MODULES, ids=[m[0] for m in MODULES])
def test_module_matches_jax(name, jfac, pfac, shape):
    jmod, pmod = jfac(), pfac()
    params, stats = random_vars(jmod)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jmod(make_vars(params, stats), jnp.asarray(x)))
    got = nhwc(port_with(pmod, params, stats)(nchw(x), torch.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


FUSED = [m for m in MODULES if m[0] in ("convbn", "c3", "coorattention", "sppfcspc",
                                         "scconv_blocked_gate", "scconv_resize_gate")]


@pytest.mark.parametrize("name,jfac,pfac,shape", FUSED, ids=[m[0] for m in FUSED])
def test_fused_module_matches_jax(name, jfac, pfac, shape):
    """BN folding: the port's in-place fold against the JAX dict fold."""
    jmod, pmod = jfac(), pfac()
    params, stats = random_vars(jmod)
    fp, fs = fuse_params(jmod, params, stats)
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = np.asarray(jmod(make_vars(fp, fs, fused=True), jnp.asarray(x)))
    pmod = fuse_model(port_with(pmod, params, stats))
    assert set(pmod.state_dict()) == set(state_dict_from_jax(fp, fs))
    got = nhwc(pmod(nchw(x), torch.float32))
    np.testing.assert_allclose(got, want, **TOL)
    # folding twice changes nothing
    again = nhwc(fuse_model(pmod)(nchw(x), torch.float32))
    np.testing.assert_array_equal(again, got)


def test_concat_matches_jax():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(2, 4, 4, c)).astype(np.float32) for c in (8, 16)]
    want = np.asarray(jb.Concat(1)(None, [jnp.asarray(x) for x in xs]))
    got = nhwc(pb.Concat(1)([nchw(x) for x in xs], torch.float32))
    np.testing.assert_array_equal(got, want)


POOLS = [
    ("silu", jp.silu, pp.silu, (2, 5, 5, 8)),
    ("hardswish", jp.hardswish, pp.hardswish, (2, 5, 5, 8)),
    ("max_pool5", lambda x: jp.max_pool(x, 5, 1, 2), lambda x: pp.max_pool(x, 5, 1, 2), (2, 7, 9, 4)),
    ("avg_pool4", lambda x: jp.avg_pool(x, 4), lambda x: pp.avg_pool(x, 4), (2, 10, 13, 4)),
    ("pool_h", jp.adaptive_avg_pool_h, pp.adaptive_avg_pool_h, (2, 5, 7, 4)),
    ("pool_w", jp.adaptive_avg_pool_w, pp.adaptive_avg_pool_w, (2, 5, 7, 4)),
    ("upsample3", lambda x: jp.upsample_nearest(x, 3), lambda x: pp.upsample_nearest(x, 3), (2, 3, 4, 4)),
    ("resize_ragged", lambda x: jp.resize_nearest(x, (7, 10)),
     lambda x: pp.resize_nearest(x, (7, 10)), (2, 2, 3, 4)),
    ("resize_integer", lambda x: jp.resize_nearest(x, (6, 8)),
     lambda x: pp.resize_nearest(x, (6, 8)), (2, 3, 4, 4)),
]


@pytest.mark.parametrize("name,jfn,pfn,shape", POOLS, ids=[p[0] for p in POOLS])
def test_function_matches_jax(name, jfn, pfn, shape):
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(pfn(nchw(x))), want, rtol=1e-6, atol=1e-6)


def _detect_pair(nc=3):
    anchors = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]]
    ch = (8, 16, 32)
    jd, pd = jh.Detect(nc, anchors, ch), ph.Detect(nc, anchors, ch)
    stride = np.asarray([8.0, 16.0, 32.0], np.float32)
    for d in (jd, pd):
        d.stride = stride
        d.anchors = d.anchors / stride.reshape(-1, 1, 1)
    return jd, pd


def test_detect_raw_and_decode_match_jax():
    jd, pd = _detect_pair()
    params, stats = random_vars(jd)
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=(2, s, s, c)).astype(np.float32) for s, c in ((8, 8), (4, 16), (2, 32))]
    want = jd(make_vars(params, stats), [jnp.asarray(x) for x in xs])
    got = port_with(pd, params, stats)([nchw(x) for x in xs], torch.float32)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape  # (B, ny, nx, na, no)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    raw = [torch.tensor(np.asarray(w)) for w in want]
    np.testing.assert_allclose(pd.decode(raw).numpy(), np.asarray(jd.decode(want)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ref_order", [True, False])
def test_decode_parts_matches_jax(ref_order):
    jd, pd = _detect_pair(nc=4)
    rng = np.random.default_rng(6)
    raw = [rng.normal(0, 2, size=(2, s, s, 3, 9)).astype(np.float32) for s in (8, 4, 2)]
    mask = np.array([True, False, True, True])
    want = jd.decode_parts([jnp.asarray(r) for r in raw], jnp.asarray(mask), ref_order=ref_order)
    got = pd.decode_parts([torch.from_numpy(r) for r in raw], torch.from_numpy(mask),
                          ref_order=ref_order)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_bias_init_matches_jax():
    jd, pd = _detect_pair()
    params, stats = random_vars(jd)
    port_with(pd, params, stats)
    jd.bias_init(params)
    pd.bias_init()
    for i in range(3):
        np.testing.assert_allclose(pd.m[i].bias.detach().numpy(),
                                   np.asarray(params[("m", str(i), "bias")]), rtol=1e-6, atol=1e-6)
