"""int8 PTQ serving and eval in the port (`nn/quant.py`, the int8 branch of
`Conv2d`, `nn/conv_int8.py`) against the JAX package under `jax.jit`, on
the CPU, where K4 and the quantize run their plain versions.

* Eligibility key for key on four full-width models (built without
  weights), calibration within rel 1e-6, including `exclude`.
* Per conv: x_q, w_q and the s32 sums equal to the jitted JAX program's
  (its lines replayed under jit), and the outputs equal to the JAX
  `Conv2d` under jit, at f32 and bf16.  The cases hold 1x1, 3x3 s2 on odd
  maps, C2 = 45, C1 = 24 (a padded channel tail) with k 5 and d 2, sums
  above 2^24 at f32-then-bf16 double-rounding points, and inputs where
  x / s_x and x * f32(1 / s_x) round differently (jitted XLA multiplies).
* The small flagship's int8 raw head at f32 and bf16 (tolerances below).
* A tiny model trained in the port: int8 mAP50 within 0.05 of float at
  f32 and bf16; `cli.val --int8` prints JAX's calibration line on the same
  checkpoint; TTA and `--no-fuse` refuse as JAX's do.
"""
import contextlib
import copy
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmayolo_tpu.cli import val as jval
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.nn import primitives as jp
from dmayolo_tpu.nn import quant as jq
from dmayolo_tpu.nn.fuse import fuse_params
from dmayolo_tpu.nn.module import make_vars
from dmayolo_tpu_torch.cli import val as pval
from dmayolo_tpu_torch.data.datasets import check_dataset
from dmayolo_tpu_torch.data.synthetic import generate
from dmayolo_tpu_torch.eval.validator import run_validation
from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.nn import conv_int8 as ci
from dmayolo_tpu_torch.nn import primitives as pp
from dmayolo_tpu_torch.nn import quant as pq
from dmayolo_tpu_torch.train.trainer import Trainer
from dmayolo_tpu_torch.utils.checkpoint import save_checkpoint
from dmayolo_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_e2e_train import HYP, TINY_CFG
from tests.test_torch_model import random_vars, small_cfg
from tests.test_torch_zoo_models import DMA_HORNET, _anchors, _cfg

FLAGSHIP = "ablation-ca-scconv-sppfcspc"
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# eligibility and calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,excluded", [(FLAGSHIP, ()), ("yolov5s", ()),
                                           ("C3CASPD2", ("c1 < 16", "c1 16")),
                                           (DMA_HORNET, ("grouped",))])
def test_eligible_convs_match_jax(name, excluded):
    """Key for key at full width, at the rule's C1 >= 16 and at the
    coverage line's C1 >= 1; the exclusions each model exercises show."""
    cfg = _cfg(name)
    jm = JaxModel(dict(cfg), anchors=_anchors(cfg))
    pm = DetectionModel(dict(cfg), anchors=_anchors(cfg), device="meta")
    paths = pq.jax_conv_paths(pm)
    for min_cin in (16, 1):
        want = jq.eligible_conv_paths(jm, min_cin=min_cin)
        got = pq.eligible_conv_paths(pm, min_cin=min_cin)
        assert {paths[n] for n in got} == set(want) and len(got) == len(want)
    convs = {n: m for n, m in pm.named_modules() if isinstance(m, pp.Conv2d)}
    elig = pq.eligible_conv_paths(pm)
    assert "c1 < 16" not in excluded or any(m.g == 1 and 1 < m.c1 < 16 for m in convs.values())
    assert "c1 16" not in excluded or any(m.c1 == 16 for m in elig.values())
    assert "grouped" not in excluded or any(m.g > 1 and m.c1 >= 16 for m in convs.values())


def test_dfl_conv_stays_float():
    """No yaml has a DFL conv module (both packages take the expectation
    as a function), so the rule is held on a two-conv tree."""
    from dmayolo_tpu.nn.module import Module

    jroot = Module()
    for name, c2 in (("dfl", 1), ("conv", 4)):
        jroot.add(name, jp.Conv2d(16, c2))
    proot = torch.nn.ModuleDict({"dfl": pp.Conv2d(16, 1), "conv": pp.Conv2d(16, 4)})
    assert list(jq.eligible_conv_paths(jroot)) == [("conv",)]
    assert list(pq.eligible_conv_paths(proot)) == ["conv"]


@functools.cache
def _small_pair():
    """The small flagship (width 0.125) in both packages, BN folded, with
    the same numpy-drawn weights."""
    jm = JaxModel(small_cfg())
    params, stats = random_vars(jm, seed=3)
    fp, fs = fuse_params(jm, params, stats)
    pm = DetectionModel(small_cfg(), device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return jm, fp, fs, pm.fuse()


def _batches(n=2, b=1, size=64, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("n_excluded", [0, 3])
def test_calibration_matches_jax(n_excluded):
    jm, fp, fs, pm = _small_pair()
    names = sorted(pq.eligible_conv_paths(pm))
    exclude = names[1:1 + n_excluded]
    paths = pq.jax_conv_paths(pm)
    want = jq.calibrate_act_scales(jm, fp, fs, _batches(), dtype=jnp.float32,
                                   exclude=[paths[n] for n in exclude])
    got = pq.scales_to_jax(pm, pq.calibrate_act_scales(pm, _batches(), exclude=exclude))
    assert set(got) == set(want) and len(got) == len(names) - n_excluded
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6 * v, k
    assert pq.quant_coverage(pm, pq.scales_from_jax(pm, want)) == jq.quant_coverage(jm, want)


# ---------------------------------------------------------------------------
# one conv
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _jax_int8_parts(x, w, s_x, s, p, d, dt):
    """x_q, w_q and the s32 sums of `Conv2d._int8_conv`, its lines as they
    are, jitted with s_x a constant as `make_infer_fn` jits them."""
    w = w.astype(jnp.float32)
    s_w = jnp.max(jnp.abs(w), axis=(0, 1, 2), keepdims=True) / 127.0
    s_w = jnp.maximum(s_w, 1e-12)
    w_q = jnp.clip(jnp.round(w / s_w), -127, 127).astype(jnp.int8)
    x_q = jnp.clip(jnp.round(x.astype(dt).astype(jnp.float32) / s_x), -127, 127).astype(jnp.int8)
    y32 = jax.lax.conv_general_dilated(
        x_q, w_q, window_strides=(s, s), padding=[(p, p), (p, p)], rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    return x_q, w_q, y32


def _jax_conv_int8(x, w, b, s_x, k, s, p, d, jdt):
    """The JAX `Conv2d` itself on its int8 path, under jit."""
    jc = jp.Conv2d(w.shape[2], w.shape[3], k, s, p, d=d)
    f = jax.jit(lambda prm, v: jc(make_vars(prm, {}, dtype=jdt, quant={(): s_x}), v))
    return np.asarray(f({("kernel",): w, ("bias",): b}, jnp.asarray(x).astype(jdt)).astype(jnp.float32))


def _tie_case():
    """A 1x1 conv (C1 2112 -> 8) whose sums sit above 2^24 at the points
    where s32 -> f32 -> bf16 rounds twice (and where s32 -> f32 rounds):
    integer x at s_x 1 and integer weights of max 127 quantize to
    themselves, and channel 0's sum is 127 * (sum of x but the last) + the
    last x."""
    c1, c2 = 2112, 8
    targets = [2 ** 24 + 2 ** 16 + 1, 2 ** 24 + 2 ** 16 - 1, 2 ** 24 + 2 ** 16 + 3,
               2 ** 25 + 2 ** 17 + 1, 2 ** 25 + 2 ** 17 + 2, 2 ** 24 + 1, 2 ** 24 + 3,
               2 ** 25 + 3, 2 ** 25 + 2, 33_000_001, 20_000_001, 2 ** 24 + 2 ** 17 + 2 ** 16 + 1]
    targets += [-t for t in targets[:4]]
    x = np.zeros((1, 4, 4, c1), np.float32)
    for i, t in enumerate(targets):
        sign, t = (1, t) if t > 0 else (-1, -t)
        s, last = divmod(t, 127)
        full, rest = divmod(s, 127)
        row = np.zeros(c1, np.float32)
        row[:full] = 127
        row[full] = rest
        row[-1] = last
        x[0, i // 4, i % 4] = sign * row
    w = np.full((1, 1, c1, c2), 127, np.float32)
    w[0, 0, -1] = np.arange(1, c2 + 1)
    b = np.linspace(-3, 3, c2).astype(np.float32)
    return x, w, b, 1.0, 1, 1, 0, 1


def _boundary_x(shape, s_x, seed):
    """Inputs drawn at random, with every value where f32 x / s_x and
    x * f32(1 / f32(s_x)) round to different integers placed first."""
    rng = np.random.default_rng(seed)
    cand = (rng.uniform(-1, 1, 4_000_000) * 127 * s_x).astype(np.float32)
    inv = np.float32(1) / np.float32(s_x)
    split = cand[np.round(cand / np.float32(s_x)) != np.round(cand * inv)]
    x = rng.normal(0, 40 * s_x, shape).astype(np.float32).ravel()
    x[:len(split)] = split[:len(x)]
    return x.reshape(shape), len(split)


def _case(c1, c2, k, s, p, d, hw, seed):
    rng = np.random.default_rng(seed)
    s_x = float(rng.uniform(0.01, 0.05))
    x, n_split = _boundary_x((2, *hw, c1), s_x, seed)
    w = rng.normal(0, (k * k * c1) ** -0.5, (k, k, c1, c2)).astype(np.float32)
    b = rng.normal(0, 0.5, c2).astype(np.float32)
    assert n_split > 0
    return x, w, b, s_x, k, s, p, d


CASES = {"1x1": lambda: _case(32, 48, 1, 1, 0, 1, (8, 8), 0),
         "3x3 s2 odd": lambda: _case(32, 64, 3, 2, 1, 1, (9, 11), 1),
         "C2 45": lambda: _case(64, 45, 1, 1, 0, 1, (5, 7), 2),
         "C1 24 k5 d2 pad": lambda: _case(24, 40, 5, 1, 4, 2, (13, 11), 3),
         "sums above 2^24": _tie_case}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_int8_conv_matches_jax(case, dt):
    x, w, b, s_x, k, s, p, d = CASES[case]()
    tdt, jdt = DTYPES[dt]
    x = np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32))  # what a dt input holds
    xq_w, wq_w, y32_w = (np.asarray(a) for a in _jax_int8_parts(
        jnp.asarray(x), jnp.asarray(w), s_x, s, p, d, jdt))
    conv = pp.Conv2d(w.shape[2], w.shape[3], k, s, p, d=d)
    conv.load_state_dict({"weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                          "bias": torch.from_numpy(b)})
    form = conv.int8_form(s_x)
    xt = torch.from_numpy(x.copy()).to(tdt)
    xq = ci.quantize_s8(xt, form.inv)
    np.testing.assert_array_equal(xq[..., :x.shape[-1]].numpy(), xq_w)
    np.testing.assert_array_equal(form.wq[..., :w.shape[2]].permute(1, 2, 3, 0).numpy(), wq_w)
    y32 = ci.conv_int8(xq, form.wq, None, None, (s, s), (p, p), (d, d), torch.int32)
    np.testing.assert_array_equal(y32.numpy(), y32_w)
    if case == "sums above 2^24":
        assert np.abs(y32_w).max() > 2 ** 25 and (np.abs(y32_w) > 2 ** 24).sum() >= 14
    conv.int8 = form
    with torch.inference_mode():
        got = conv(xt.permute(0, 3, 1, 2), tdt).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    want = _jax_conv_int8(x, w, b, s_x, k, s, p, d, jdt)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_int8_form_is_made_once_a_scale():
    conv = pp.Conv2d(16, 8, 3)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    a = conv.int8_form(0.5)
    assert conv.int8_form(0.5) is a and conv.int8_form(0.25) is not a
    b = conv.int8_form(0.25)
    with torch.no_grad():
        conv.weight.mul_(2)  # a fold or a load changes the weights: a new form
    assert conv.int8_form(0.25) is not b


# ---------------------------------------------------------------------------
# the small flagship's int8 raw head
# ---------------------------------------------------------------------------

# Where the port's float ops differ from XLA's in the last bits (f32) or
# in a bf16 rounding (bf16), an activation that sits on a quantize
# rounding boundary takes the other integer, and the difference, one quant
# step of the next int8 conv's input, travels on.  Bounds, relative to the
# head's max |value|: the share of values off by more than `close`, and
# the largest difference.  At f32 the only float conv is the stem and the
# head comes out equal to the bit here; the bounds leave room for a flip
# and still refuse a float head (JAX's int8 and float heads differ at
# 99.97% of the values, by up to 0.017).  At bf16 the two packages' float
# heads already differ at 59% of the values (up to 0.0088), and flips
# follow: the int8 heads differ by up to 0.0176, as much as JAX's int8 and
# float heads (0.0196), so no bound on the difference tells int8 from
# float there.  What does: the change the int8 convs make to the head
# (int8 head minus float head, in each package) correlates between the
# two packages, 1 at f32 and 0.56 at bf16 here, against 0 for a float
# head and 0.26 for calibration scales 10% off.
HEAD_TOL = {"f32": dict(close=1e-6, share=0.01, worst=0.005, corr=1 - 1e-6),
            "bf16": dict(close=2e-2, share=0.01, worst=0.025, corr=0.4)}


@pytest.mark.parametrize("dt", list(DTYPES))
def test_small_flagship_int8_head_matches_jax(dt):
    jm, fp, fs, pm = _small_pair()
    tdt, jdt = DTYPES[dt]
    jscales = jq.calibrate_act_scales(jm, fp, fs, _batches(), dtype=jnp.float32)
    scales = pq.scales_from_jax(pm, jscales)
    x = np.random.default_rng(11).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    want, want_float = (jax.jit(lambda p, s, v, q=q: jm.apply(  # the scales are constants
        p, s, v.astype(jdt), dtype=jdt, fused=True, quant=q))(fp, fs, jnp.asarray(x))
        for q in (jscales, None))
    with torch.inference_mode():
        got, plain = (pm.apply(torch.from_numpy(x).to(tdt), tdt, fused=True, quant=q)
                      for q in (scales, None))
    tol = HEAD_TOL[dt]
    for w, g in zip(want, got):
        w, g = np.asarray(w.astype(jnp.float32)), g.float().numpy()
        spread = np.abs(w).max()
        err = np.abs(g - w) / spread
        assert (err > tol["close"]).mean() <= tol["share"] and err.max() <= tol["worst"], \
            (dt, float((err > tol["close"]).mean()), float(err.max()))
    # the int8 convs change the head as JAX's do
    def flat(heads):
        return np.concatenate([np.asarray(h.float() if isinstance(h, torch.Tensor)
                                          else h.astype(jnp.float32)).ravel() for h in heads])

    ours, theirs = flat(got) - flat(plain), flat(want) - flat(want_float)
    assert ours.any() and np.corrcoef(ours, theirs)[0, 1] >= tol["corr"], \
        (dt, float(np.corrcoef(ours, theirs)[0, 1]) if ours.any() else 0.0)
    assert all(m.int8 is None for m in pm.modules() if isinstance(m, pp.Conv2d))


# ---------------------------------------------------------------------------
# a tiny model trained in the port
# ---------------------------------------------------------------------------

IMG = 128  # the JAX test's 256 px takes 80 s to train here; at 128 px, 30 s


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8")
    data = generate(tmp / "shapes", n_train=48, n_val=24, img_size=IMG, seed=2)
    tr = Trainer(TINY_CFG, data=str(data), hyp=HYP, epochs=32, batch_size=8, img_size=IMG,
                 out_dir=str(tmp / "exp"), dtype=torch.float32, workers=2, max_targets=32,
                 val_interval=100, seed=0, accumulate=1, device="cpu")
    # the JAX test's warmup_min_iters=60 (the port's Trainer keeps the
    # reference's 1000)
    tr.sched.nw = max(round(HYP["warmup_epochs"] * tr.sched.spe), 60)
    tr.train(log_every=100)
    return tr, data, tmp


def _calibration_images(data, n):
    from dmayolo_tpu_torch.data.datasets import _scan_images
    from dmayolo_tpu_torch.data.imageio import imread
    from dmayolo_tpu_torch.data.letterbox import letterbox_host

    files = _scan_images(check_dataset(str(data))["train"])[:n]
    return np.stack([letterbox_host(imread(f), IMG, auto=False)[0][..., ::-1] for f in files])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_int8_val_matches_float(trained, dt):
    tr, data, _ = trained
    model = copy.deepcopy(tr.state.ema).fuse()
    scales = pq.calibrate_act_scales(model, [_calibration_images(data, 16)])
    assert len(scales) >= 5
    kw = dict(img_size=IMG, batch_size=8, nc=3, dtype=DTYPES[dt][0], fused=True,
              max_targets=64, device="cpu")
    val = check_dataset(str(data))["val"]
    r_float = run_validation(model, val, **kw)
    r_int8 = run_validation(model, val, quant=scales, **kw)
    assert r_float.map50 > 0.15, f"fixture undertrained: {r_float.summary()}"
    assert abs(r_float.map50 - r_int8.map50) < 0.05, (r_float.summary(), r_int8.summary())


def _ckpt(trained):
    tr, data, tmp = trained
    path = tmp / "trained.npz"
    if not path.exists():
        params, stats = jax_from_state_dict(tr.state.ema)
        save_checkpoint(tmp / "trained", params=params, stats=stats, meta={})
        with open(tmp / "tiny.yaml", "w") as f:
            yaml.safe_dump(TINY_CFG, f)
    return path, tmp / "tiny.yaml"


def _argv(trained, name, *flags):
    _, data, tmp = trained
    ckpt, cfg = _ckpt(trained)
    return ["--weights", str(ckpt), "--cfg", str(cfg), "--data", str(data), "--img", str(IMG),
            "--batch-size", "8", "--fp32", "--device", "cpu", "--project", str(tmp / name),
            "--name", "exp", "--exist-ok", *flags]


def _printed(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


def test_int8_val_cli_prints_jax_calibration_line(trained):
    argv = ["--int8", "--ncalib", "8"]
    res, printed = _printed(pval.main, _argv(trained, "port", *argv))
    _, jprinted = _printed(jval.main, _argv(trained, "jax", *argv))
    line = [ln for ln in printed.splitlines() if ln.startswith("int8 calibration:")]
    jline = [ln for ln in jprinted.splitlines() if ln.startswith("int8 calibration:")]
    assert line == jline and line[0] == "int8 calibration: 8 images, int8 convs: 23/24"
    assert res.map50 > 0.15


@pytest.mark.parametrize("flag,err", [("--augment", ValueError), ("--no-fuse", SystemExit)])
def test_int8_val_cli_refuses_as_jax(trained, flag, err):
    argv = ["--int8", "--ncalib", "8", flag]
    with pytest.raises(err) as want:
        jval.main(_argv(trained, "jax_refused", *argv))
    with pytest.raises(err) as got:
        pval.main(_argv(trained, "port_refused", *argv))
    assert str(got.value) == str(want.value)
