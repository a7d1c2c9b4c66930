"""The SPD-Conv family in the port against the JAX package, on the CPU.

`space_to_depth_2x`, `CABottleneck` and `C3CA` module by module; then the
author's two SPD models, `C3CASPD2` (anchor-based Detect, `anchors: 4`)
and `CASPD_ODRTA` (anchor-free TDetect), at depth 0.33, width 0.125, nc
10, with the same numpy-drawn weights in both packages.  C3CASPD2 gets the
same explicit anchors in both through `anchors=` (its yaml's are
placeholders that autoanchor replaces).

Tolerances: raw head f32 rtol = atol = 1e-4 (convolution summation
order); decode, decode_parts and decode_topk 1e-5; served and evaluated
detections: the same sets, boxes within 1e-3 px, scores within 1e-5; the
bf16 raw head: see `test_bf16_raw_head_matches_jax` (each layer rounds its
output to bf16, and the two packages round different f32 sums).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmayolo_tpu.eval.validator import make_infer_fn as jax_make_infer_fn
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.nn import blocks as jb
from dmayolo_tpu.nn import primitives as jp
from dmayolo_tpu.nn.fuse import fuse_params
from dmayolo_tpu.nn.module import make_vars
from dmayolo_tpu_torch.core.nms import nms_parts
from dmayolo_tpu_torch.eval.validator import make_infer_fn
from dmayolo_tpu_torch.graph import DetectionModel, model_config
from dmayolo_tpu_torch.nn import blocks as pb
from dmayolo_tpu_torch.nn import primitives as pp
from dmayolo_tpu_torch.nn.fuse import fuse_model
from dmayolo_tpu_torch.nn.heads import Detect, TDetect
from dmayolo_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_model import _match_rows
from tests.test_torch_model import random_vars as model_vars
from tests.test_torch_modules import TOL, nchw, nhwc, port_with, random_vars

SPD = ("C3CASPD2", "CASPD_ODRTA")
# C3CASPD2's anchors in the tests, pixels, P2-P5 (4 an level)
ANCHORS = [[4, 5, 8, 10, 12, 9, 10, 16], [16, 30, 33, 23, 30, 61, 24, 40],
           [62, 45, 59, 119, 80, 70, 70, 90], [116, 90, 156, 198, 373, 326, 200, 250]]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spd_cfg(name):
    with open(model_config(name)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(depth_multiple=0.33, width_multiple=0.125, nc=10)
    return cfg


def _anchors(name):
    return ANCHORS if name == "C3CASPD2" else None


@functools.cache
def _pair(name):
    jm = JaxModel(spd_cfg(name), anchors=_anchors(name))
    params, stats = model_vars(jm, seed=4)
    pm = DetectionModel(spd_cfg(name), anchors=_anchors(name), device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    jfwd = jax.jit(lambda p, s, v: jm.apply(p, s, v))
    return name, jm, params, stats, pm, jfwd


@pytest.fixture(scope="module", params=SPD)
def pair(request):
    return _pair(request.param)


def _images(size, seed=1, b=2):
    return np.random.default_rng(seed).uniform(0, 1, (b, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SPD)
def test_spd_yaml_is_the_jax_packages(name):
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert (model_config(name).read_bytes()
            == (root / "dmayolo_tpu" / "configs" / "models" / f"{name}.yaml").read_bytes())


def test_space_to_depth_matches_jax_and_stays_channels_last():
    x = np.random.default_rng(0).normal(size=(2, 6, 10, 5)).astype(np.float32)
    want = np.asarray(jp.space_to_depth_2x(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    assert xt.is_contiguous(memory_format=torch.channels_last)
    got = pb.SpaceToDepth(1)(xt, torch.float32)
    assert got.shape == (2, 20, 3, 5)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(got), want)
    np.testing.assert_array_equal(nhwc(pp.space_to_depth_2x(xt)), want)


# (name, JAX module factory, port module factory, input channels)
BLOCKS = [
    ("cabottleneck", lambda: jb.CABottleneck(16, 16), lambda: pb.CABottleneck(16, 16), 16),
    ("cabottleneck_widen", lambda: jb.CABottleneck(8, 16, e=1.0),
     lambda: pb.CABottleneck(8, 16, e=1.0), 8),
    ("c3ca", lambda: jb.C3CA(16, 24, 2, False), lambda: pb.C3CA(16, 24, 2, False), 16),
]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name,jfac,pfac,c1", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(name, jfac, pfac, c1, fused):
    jmod, pmod = jfac(), pfac()
    params, stats = random_vars(jmod)
    x = np.random.default_rng(1).normal(size=(2, 6, 10, c1)).astype(np.float32)
    pmod = port_with(pmod, params, stats)
    if fused:
        params, stats = fuse_params(jmod, params, stats)
        pmod = fuse_model(pmod)
        assert set(pmod.state_dict()) == set(state_dict_from_jax(params, stats))
    want = np.asarray(jmod(make_vars(params, stats, fused=fused), jnp.asarray(x)))
    got = nhwc(pmod(nchw(x), torch.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the two models
# ---------------------------------------------------------------------------

def _shapes_of(tree):
    return {k: tuple(s.shape) for k, s in tree.items()}


@pytest.mark.parametrize("name", SPD)
def test_full_width_spd_model_builds_like_jax(name):
    """Full width, nc 10: the same strides, anchors (C3CASPD2's
    placeholders in stride units) and state_dict keys and shapes as the
    JAX model's trees; no forward."""
    path = model_config(name)
    jm = JaxModel(str(path), nc=10)
    pm = DetectionModel(path, nc=10, device="cpu")
    np.testing.assert_array_equal(pm.stride, jm.stride)
    np.testing.assert_array_equal(pm.stride, [4, 8, 16, 32])
    assert type(pm.head).__name__ == type(jm.head).__name__
    if name == "C3CASPD2":
        np.testing.assert_array_equal(pm.head.anchors, jm.head.anchors)
        assert pm.head.anchors.shape == (4, 4, 2)
    pshape, sshape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = {}
    for k, s in {**_shapes_of(pshape), **_shapes_of(sshape)}.items():
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}[k[-1]]
        want[".".join(k[:-1]) + "." + leaf] = (s if k[-1] != "kernel"
                                               else (s[3], s[2], s[0], s[1]))
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want


@pytest.mark.parametrize("anchors", [3, 3.2, ANCHORS], ids=["int", "float", "pairs"])
def test_anchors_override_matches_jax(anchors):
    """`anchors=` replaces the yaml's: a number n gives round(n) placeholder
    anchors a level, pairs are used as they are (in stride units after the
    probe)."""
    jm = JaxModel(spd_cfg("C3CASPD2"), anchors=anchors)
    pm = DetectionModel(spd_cfg("C3CASPD2"), anchors=anchors, device="cpu")
    assert pm.head.na == jm.head.na == (3 if anchors in (3, 3.2) else 4)
    np.testing.assert_array_equal(pm.head.anchors, jm.head.anchors)
    assert pm.head.m[0].weight.shape[0] == pm.head.na * 15


@pytest.mark.parametrize("size,fused", [(64, False), (96, False), (64, True)])
def test_raw_head_matches_jax(pair, size, fused):
    name, jm, params, stats, pm, jfwd = pair
    x = _images(size)
    unfused = [r.detach() for r in pm.apply(torch.from_numpy(x))]
    if fused:
        params, stats = fuse_params(jm, params, stats)
        pm = copy.deepcopy(pm).fuse()
        want = jax.jit(lambda p, s, v: jm.apply(p, s, v, fused=True))(
            params, stats, jnp.asarray(x))
    else:
        want = jfwd(params, stats, jnp.asarray(x))
    got = pm.apply(torch.from_numpy(x), fused=fused)
    assert len(got) == 4
    for w, g, u in zip(want, got, unfused):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
        # the BN-folded model against the unfolded one
        np.testing.assert_allclose(g.detach().numpy(), u.numpy(), **TOL)


def _raw(pair, size=64, seed=2):
    name, jm, params, stats, pm, jfwd = pair
    raw = jfwd(params, stats, jnp.asarray(_images(size, seed)))
    return raw, [torch.tensor(np.asarray(r)) for r in raw]


def test_decode_matches_jax(pair):
    name, jm, params, stats, pm, _ = pair
    jraw, praw = _raw(pair)
    np.testing.assert_allclose(pm.decode(praw).numpy(), np.asarray(jax.jit(jm.decode)(jraw)),
                               rtol=1e-5, atol=1e-5)
    want, got = jax.jit(jm.decode_parts)(jraw), pm.decode_parts(praw)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    if name == "CASPD_ODRTA":
        assert pm.decode(praw).shape[-1] == 4 + 10
        want = jax.jit(lambda r: jm.decode_topk(r, k=64, conf_thres=0.3))(jraw)
        got = pm.decode_topk(praw, k=64, conf_thres=0.3)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _serve_sets_equal(want, got, b=2):
    want_d, want_v = (np.asarray(a) for a in want)
    got_d, got_v = got
    assert got_d.shape == want_d.shape and not got_d[~got_v].any()
    for i in range(b):
        _match_rows(want_d[i][want_v[i]], got_d[i][got_v[i]].numpy())


@pytest.mark.parametrize("backend", ["scan", "matrix", "pallas"])
@pytest.mark.parametrize("max_nms", [64, 512], ids=["k64", "k512"])
def test_serve_detections_matches_jax(pair, backend, max_nms):
    """Both serving tails at conf 0.1.  A 64 px TDetect head has 340
    candidates: k 64 (64 * 4 <= 340) takes the lazy route in both packages,
    k 512 the eager one; the lazy route equals the eager tail at the same
    k.  The anchor head (1,360 candidates) is always eager."""
    name, jm, params, stats, pm, _ = pair
    jraw, praw = _raw(pair, seed=3)
    kw = dict(conf_thres=0.1, max_nms=max_nms)
    want = jax.jit(lambda r: jm.serve_detections(r, backend="scan", **kw))(jraw)
    lazy0 = pm.lazy_tails
    got = pm.serve_detections(praw, backend=backend, **kw)
    lazy = name == "CASPD_ODRTA" and max_nms == 64
    assert pm.lazy_tails == lazy0 + lazy
    _serve_sets_equal(want, got)
    if lazy:  # the eager tail at the same k
        eager = nms_parts(*pm.decode_parts(praw), backend=backend, **kw)
        for i in range(2):
            _match_rows(eager[0][i][eager[1][i]].numpy(), got[0][i][got[1][i]].numpy())


@pytest.mark.parametrize("name,augment", [("C3CASPD2", False), ("CASPD_ODRTA", False),
                                          ("CASPD_ODRTA", True)])
def test_make_infer_fn_matches_jax(name, augment):
    """The eval protocol (conf 0.001, IoU 0.6, multi-label), plain and with
    TTA over TDetect's four levels: TDetect's decode gets the obj = 1
    column in both packages."""
    name, jm, params, stats, pm, _ = _pair(name)
    x = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, augment=augment)
    want = jax_make_infer_fn(jm, params, stats, dtype=jnp.float32, **kw)(jnp.asarray(x))
    got = make_infer_fn(pm, dtype=torch.float32, nms_backend="matrix", **kw)(
        torch.from_numpy(x))
    assert int(got[1].sum()) > 0
    _serve_sets_equal(want, got)


def test_heads_are_the_configs():
    assert isinstance(DetectionModel(spd_cfg("C3CASPD2"), device="cpu").head, Detect)
    assert isinstance(DetectionModel(spd_cfg("CASPD_ODRTA"), device="cpu").head, TDetect)


def test_tdetect_bias_priors_match_jax():
    from dmayolo_tpu.nn import heads as jh
    from dmayolo_tpu_torch.nn import heads as ph

    jmod, pmod = jh.TDetect(10, ch=(16, 32, 64, 128)), ph.TDetect(10, ch=(16, 32, 64, 128))
    jmod.stride = pmod.stride = np.asarray([4, 8, 16, 32], np.float32)
    params, stats = random_vars(jmod)
    want = state_dict_from_jax(jmod.bias_init(dict(params)), stats)
    pmod = port_with(pmod, params, stats)
    pmod.bias_init()
    for k, v in pmod.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)


def test_bf16_raw_head_matches_jax():
    """The small TDetect model in bf16 in both packages: the port's bf16
    head is as close to JAX's bf16 head as JAX's bf16 head is to its own f32
    one, twice over, plus bf16's rounding (2^-8), all relative to the
    head's largest magnitude per level."""
    name, jm, params, stats, pm, jfwd = _pair("CASPD_ODRTA")
    x = _images(64, seed=6)
    want = jax.jit(lambda p, s, v: jm.apply(p, s, v.astype(jnp.bfloat16), dtype=jnp.bfloat16))(
        params, stats, jnp.asarray(x))
    f32 = jfwd(params, stats, jnp.asarray(x))
    with torch.inference_mode():
        got = pm.apply(torch.from_numpy(x).to(torch.bfloat16), dtype=torch.bfloat16)
    for w, g, f in zip(want, got, f32):
        w, f = np.asarray(w.astype(jnp.float32)), np.asarray(f)
        assert g.dtype == torch.bfloat16
        scale = float(np.abs(w).max())
        err = float(np.abs(g.float().numpy() - w).max()) / scale
        ref = float(np.abs(w - f).max()) / scale
        assert err <= 2 * ref + 2 ** -8, (err, ref)
