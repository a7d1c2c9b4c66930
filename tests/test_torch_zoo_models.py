"""The zoo's models in the port against the JAX package, on the CPU.

- Every one of the 69 yamls builds from the port's own byte-identical
  copy, and its `state_dict` maps through `jax_paths` one to one onto the
  JAX model's parameter and statistic paths and shapes
  (`jax.eval_shape(init)`), with the same strides: at width 0.5 (C3STR
  needs c_ >= 32) and depth min(yaml's, 0.33) (depth repeats blocks the
  sweep already holds); the port's model on the meta device, no forward.
  The port's `REGISTRY` has exactly the JAX registry's keys.
- The raw head at f32 of one model of each family, from the same
  numpy-drawn weights: DMA-full (`yolov5l-ca-sppfcspc-bifpn-scconv`:
  BiFPN AdConcat2/3, C3STR on P3-P5) at 160 px (Swin maps of 3 x 3, 2 x 2
  and 1 x 1 windows, all padded), TPH (`yolov5l-xs-tph`: C3STR on P2-P5)
  at 128 px (4 x 4 windows at P2), `yolov5s-transformer` (C3TR, SPP),
  `yolov5l-xs-tr-cbam-spp-bifpn` (C3TR, CBAM, SPP, AdConcat), `yolov5-p7`
  (Focus, SPP, five scales) at 256 px and `yolov5-panet`
  (BottleneckCSP); and at 128 px, width 0.25, DMA-HorNet
  (`ca-sppfcspc-bifpn-scconv-adapt-hornet`: C3HB on P3-P5, AdConcat),
  CADMM (DMMConv), ghostnet (C3GhostV2), `yolo_cspcm` (CSPCM), C3CASPD6
  (Adapt_Add2/3), `yolov5s-ghost` (GhostConv, C3Ghost) and `yolov3-tiny`
  (ZeroPad2d, MaxPool2d).  Tolerance rtol = atol = 1e-4 (the flagship's).
  The yamls' placeholder anchors (`anchors: 3` or `4`) are replaced by
  the same explicit pairs in both packages.
- DMA-full's fused serving detections (`serve_detections` on "scan"):
  the same sets as JAX's, boxes within 1e-3 px, scores within 1e-5.
  BN folding of ghostnet (ConvUnit), `adaptca` (AddConvBlock) and
  `yolo_cspcm` (ConvMix's BNs stay) keeps what JAX keeps, and the fused
  head equals the unfused one.
- The bf16 serving tail of the small ghostnet: both packages' bf16 raw
  heads within bf16 tolerance, and on JAX's bf16 head, with the
  objectness logits made distinct (no tie decides the set),
  `serve_detections` gives JAX's detection sets (tolerances in the test).
  The lazy decode (`decode_topk`) of ghostnet's anchor head equals JAX's.
- `param_groups` labels equal JAX's, path by path, on DMA-full,
  DMA-HorNet (HorBlock gammas frozen) and C3CASPD6 (Adapt_Add w in g1).
- A port-written `.npz` of DMA-full and of DMA-HorNet loads in JAX and
  gives the port's raw head.
- One train step (forward, SIoU loss, backward in train mode) of DMA-full,
  `yolov5s-transformer` and DMA-HorNet against JAX's, every Dropout and
  DropPath rate set to 0 in both packages on the module objects (JAX
  draws its masks from `jax.random`; `test_torch_zoo_blocks.py` holds the
  port's to their definitions): loss and items within 1e-4 relative,
  every gradient within 1e-4 scaled by 1 + max |g|, BN statistics within
  1e-5, as `tests/test_torch_train_step.py` holds the flagship's step.

The JAX side runs under `jax.jit` (op by op, the DMA-full step took 85 s
of the CPU against 13 s compiled).
"""
import functools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmayolo_tpu.cli.common import load_hyp as jax_load_hyp
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.nn import primitives as jp
from dmayolo_tpu.nn.fuse import fuse_params
from dmayolo_tpu.train import loss as jl
from dmayolo_tpu.train import optim as jo
from dmayolo_tpu_torch.graph import DetectionModel, model_config
from dmayolo_tpu_torch.nn import primitives as pp
from dmayolo_tpu_torch.train import loss as pl
from dmayolo_tpu_torch.train import optim as po
from dmayolo_tpu_torch.utils.checkpoint import save_checkpoint
from dmayolo_tpu_torch.utils.weights import jax_from_state_dict, jax_paths, state_dict_from_jax
from tests.test_torch_model import _match_rows
from tests.test_torch_zoo_blocks import zoo_vars
from tests.torch_train_common import batch, close_scaled

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
# every yaml of the JAX package
ZOO = ["C3CA", "C3CASC", "C3CASPD", "C3CASPD2", "C3CASPD3", "C3CASPD4", "C3CASPD5",
       "C3CASPD6", "CADM", "CADMM", "CADMM2", "CASMM", "CASMMsiou", "CASPD_ODRTA", "CMCA",
       "CSPCM", "ConvMix", "DM", "SCconv", "ablation-ca", "ablation-ca-scconv",
       "ablation-ca-scconv-bifpn", "ablation-ca-scconv-sppfcspc",
       "ablation-ca-scconv-sppfcspc-bifpn", "adaptadd", "adaptca", "adaptconcat", "ca",
       "ca-sppfcspc-bifpn-scconv-adapt-gnconv", "ca-sppfcspc-bifpn-scconv-adapt-hornet",
       "ca-str", "enhance", "ghostnet", "hornet", "hornet2", "hornet3", "model", "spdconv",
       "spdconv2", "test", "yolo_convmix", "yolo_cspcm", "yolop2", "yolop2bifpn", "yolov3",
       "yolov3-spp", "yolov3-tiny", "yolov5-bifpn", "yolov5-fpn", "yolov5-p2", "yolov5-p6",
       "yolov5-p7", "yolov5-panet", "yolov5l", "yolov5l-ca-sppfcspc-bifpn",
       "yolov5l-ca-sppfcspc-bifpn-scconv", "yolov5l-xs-tph", "yolov5l-xs-tr-cbam-spp-bifpn",
       "yolov5l6", "yolov5m", "yolov5m6", "yolov5n", "yolov5n6", "yolov5s", "yolov5s-ghost",
       "yolov5s-transformer", "yolov5s6", "yolov5x", "yolov5x6"]
DMA_FULL, TPH = "yolov5l-ca-sppfcspc-bifpn-scconv", "yolov5l-xs-tph"
DMA_HORNET = "ca-sppfcspc-bifpn-scconv-adapt-hornet"
# (depth, width, input side) of each family's model in the raw-head test
FAMILIES = {DMA_FULL: (0.33, 0.25, 160), TPH: (0.33, 0.5, 128),
            "yolov5s-transformer": (0.33, 0.25, 128),
            "yolov5l-xs-tr-cbam-spp-bifpn": (0.33, 0.25, 128),
            "yolov5-p7": (0.33, 0.125, 256), "yolov5-panet": (0.33, 0.125, 128),
            DMA_HORNET: (0.33, 0.25, 128), "CADMM": (0.33, 0.25, 128),
            "ghostnet": (0.33, 0.25, 128), "yolo_cspcm": (0.33, 0.25, 128),
            "C3CASPD6": (0.33, 0.25, 128), "yolov5s-ghost": (0.33, 0.25, 128),
            "yolov3-tiny": (0.33, 0.25, 128)}
BASE_ANCHORS = [[4, 5, 8, 10, 12, 9, 10, 16], [16, 30, 33, 23, 30, 61, 24, 40],
                [62, 45, 59, 119, 80, 70, 70, 90], [116, 90, 156, 198, 373, 326, 200, 250],
                [300, 320, 400, 380, 500, 460, 620, 600]]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the args that give channel counts parse_model passes on without the
# width gain (the adaptive fusions' dims and AdaptADD's out_ch, SMMConv's
# and the DM convs' widths), by position: at a width below the yaml's
# `_cfg` scales them as the gain scales the other rows, else the narrow
# model does not build (in the JAX package either)
RAW_DIMS = {"Adapt_Add3": (0, 1, 2), "AdaptConcat": (1, 2, 3), "AdaptADD": (0, 2, 3, 4),
            "SMMConv": (0,), "DMConv": (0,), "DMMConv": (0,), "DMMConv2": (0,)}


def _cfg(name, depth=None, width=None, nc=10):
    with open(model_config(name)) as f:
        cfg = yaml.safe_load(f)
    cfg["nc"] = nc
    if depth is not None:
        cfg["depth_multiple"] = depth
    if width is not None:
        gain = width / cfg["width_multiple"]
        cfg["width_multiple"] = width
        for row in cfg["backbone"] + cfg["head"]:
            for j in RAW_DIMS.get(row[2], ()):
                if j < len(row[3]):
                    row[3][j] = math.ceil(row[3][j] * gain / 8) * 8
    return cfg


def _anchors(cfg):
    """Explicit pairs where the yaml has placeholders (`anchors: n`), else
    None: the head's levels, n anchors each."""
    if not isinstance(cfg["anchors"], int):
        return None
    levels = len(cfg["head"][-1][0])
    return [row[:2 * cfg["anchors"]] for row in BASE_ANCHORS[:levels]]


# ---------------------------------------------------------------------------
# the 69 yamls
# ---------------------------------------------------------------------------

def test_the_zoo_is_every_yaml_of_ported_modules():
    """ZOO is exactly the JAX package's yamls whose modules the port
    registers, which is every one of them, and the port ships a
    byte-identical copy of each (and no other)."""
    from dmayolo_tpu_torch.graph.registry import REGISTRY

    buildable, every = [], []
    for path in sorted((ROOT / "dmayolo_tpu" / "configs" / "models").glob("*.yaml")):
        every.append(path.stem)
        cfg = yaml.safe_load(path.read_text())
        if all(row[2] in REGISTRY for row in cfg["backbone"] + cfg["head"]):
            buildable.append(path.stem)
            assert model_config(path.stem).read_bytes() == path.read_bytes()
    assert sorted(buildable) == sorted(ZOO) == sorted(every) and len(ZOO) == 69
    ported = sorted(p.stem for p in model_config(ZOO[0]).parent.glob("*.yaml"))
    assert ported == sorted(every)


def test_registry_has_the_jax_keys():
    """The port's REGISTRY and channel-rule groups equal the JAX ones key
    for key, each name mapped to the class of the same name."""
    from dmayolo_tpu.graph import registry as jr
    from dmayolo_tpu_torch.graph import registry as pr

    assert set(pr.REGISTRY) == set(jr.REGISTRY)
    assert pr.WIDTH_GAIN == jr.WIDTH_GAIN and pr.INSERT_N == jr.INSERT_N
    for key, cls in jr.REGISTRY.items():
        assert pr.REGISTRY[key].__name__ == cls.__name__, key


@functools.cache
def _built_like_jax(cfg_text):
    """(strides, head type, anchors, {(tree, JAX path): shape}) of the
    JAX model and of the port's, for one config (yamls that differ only
    in depth and width give one config at the sweep's depth and width,
    built once)."""
    cfg = yaml.safe_load(cfg_text)
    anchors = _anchors(cfg)
    jm = JaxModel(dict(cfg), anchors=anchors)
    pm = DetectionModel(dict(cfg), anchors=anchors, device="meta")
    pshape, sshape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = {("params", k): tuple(v.shape) for k, v in pshape.items()}
    want.update({("stats", k): tuple(v.shape) for k, v in sshape.items()})
    sd, got = pm.state_dict(), {}
    for key, (tree, path) in jax_paths(pm).items():
        shape = tuple(sd[key].shape)
        if path[-1] == "kernel":
            shape = (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape[::-1]
        elif path[-1] == "in_proj_kernel":
            shape = shape[::-1]
        got[(tree, path)] = shape
    return [(m.stride, type(m.head).__name__, getattr(m.head, "anchors", None), shapes)
            for m, shapes in ((jm, want), (pm, got))]


@pytest.mark.parametrize("name", ZOO)
def test_yaml_builds_like_jax(name):
    cfg = _cfg(name, width=0.5)
    cfg["depth_multiple"] = min(cfg["depth_multiple"], 0.33)
    (j_stride, j_head, j_anchors, want), (p_stride, p_head, p_anchors, got) = \
        _built_like_jax(yaml.safe_dump(cfg, sort_keys=True))
    np.testing.assert_array_equal(p_stride, j_stride)
    assert p_head == j_head
    if j_anchors is not None:
        np.testing.assert_array_equal(p_anchors, j_anchors)
    assert got == want


def test_every_parameter_is_initialised():
    """`reset_parameters` reaches every parameter and statistic after the
    meta-device build (a tensor it skipped would hold `to_empty`'s
    garbage): DMA-full and a C3TR model, at small width, finite, the JAX
    init's constants where it has them."""
    for name, width in ((DMA_FULL, 0.25), ("yolov5s-transformer", 0.25)):
        pm = DetectionModel(_cfg(name, 0.33, width), device="cpu")
        pm.init_with_priors(torch.Generator().manual_seed(1))
        for key, t in pm.state_dict().items():
            assert bool(torch.isfinite(t).all()), key
        for key, t in pm.named_parameters():
            if key.endswith(".w"):
                assert bool((t == 1).all()), key
            elif key.endswith("in_proj_bias"):
                assert not t.any(), key
            elif key.endswith("relative_position_bias_table"):
                assert 0 < float(t.abs().max()) <= 0.04, key


# ---------------------------------------------------------------------------
# one model of each family, raw head at f32
# ---------------------------------------------------------------------------

@functools.cache
def _pair(name):
    depth, width, size = FAMILIES[name]
    cfg = _cfg(name, depth, width)
    jm = JaxModel(dict(cfg), anchors=_anchors(cfg))
    params, stats = zoo_vars(jm, seed=4)
    pm = DetectionModel(dict(cfg), anchors=_anchors(cfg), device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    jfwd = jax.jit(lambda p, s, v: jm.apply(p, s, v))
    return jm, params, stats, pm, size, jfwd


def _images(size, seed=1, b=2):
    return np.random.default_rng(seed).uniform(0, 1, (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_raw_head_matches_jax(name):
    jm, params, stats, pm, size, jfwd = _pair(name)
    x = _images(size)
    want = jfwd(params, stats, jnp.asarray(x))
    with torch.inference_mode():
        got = pm.apply(torch.from_numpy(x))
    assert len(got) == len(want) == len(pm.stride)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_dma_full_fused_serving_matches_jax():
    """BN-folded on both sides (BottleneckCSP-free, so every BN folds),
    then the serving tail on "scan": the same detection sets."""
    jm, params, stats, pm, size, _ = _pair(DMA_FULL)
    fp, fs = fuse_params(jm, params, stats)
    x = _images(size, seed=2)

    @jax.jit
    def serve(p, s, v):
        return jm.serve_detections(jm.apply(p, s, v, fused=True), conf_thres=0.25,
                                   backend="scan")

    want_d, want_v = (np.asarray(a) for a in serve(fp, fs, jnp.asarray(x)))
    import copy

    fused = copy.deepcopy(pm).fuse()
    assert not any(isinstance(m, pp.BatchNorm2d) for m in fused.modules())
    with torch.inference_mode():
        got_d, got_v = fused.serve_detections(fused.apply(torch.from_numpy(x), fused=True),
                                              conf_thres=0.25, backend="scan")
    assert int(want_v.sum()) > 0
    for b in range(len(x)):
        _match_rows(want_d[b][want_v[b]], got_d[b][got_v[b]].numpy())


def _shape_init(jm):
    """The JAX model with an `init` that gives shapes only: `param_groups`
    reads the init's paths, not its values, and an eager init of every
    leaf costs 20 s of the CPU here."""
    init = jm.init
    jm.init = lambda key: jax.eval_shape(init, key)
    return jm


def test_dma_full_param_groups_match_jax():
    """AdConcat `w` in g1 (JAX's `bifpn_w_paths`); Linear and LayerNorm
    weights g1, their biases g2; the Swin bias tables, `in_proj_weight`
    and `in_proj_bias` frozen: JAX labels `in_proj_bias` frozen too, since
    its leaf is not `bias` (dmayolo_tpu/train/optim.py:50-60)."""
    jm, params, stats, pm, size, _ = _pair(DMA_FULL)
    want = jo.param_groups(_shape_init(jm))
    paths = jax_paths(pm)
    got = {paths[k][1]: g for k, g in po.param_groups(pm).items()}
    assert got == want
    frozen = {k[-1] for k, g in got.items() if g == "frozen"}
    assert frozen == {"relative_position_bias_table"}
    assert all(got[k] == "g1" for k in got if k[-1] == "w") and any(k[-1] == "w" for k in got)
    tr_jm, _, _, tr, _, _ = _pair("yolov5s-transformer")
    tr_got = {jax_paths(tr)[k][1]: g for k, g in po.param_groups(tr).items()}
    assert tr_got == jo.param_groups(_shape_init(tr_jm))
    assert {k[-1] for k, g in tr_got.items() if g == "frozen"} == {"in_proj_kernel",
                                                                   "in_proj_bias"}


@pytest.mark.parametrize("name,frozen_leaves", [(DMA_HORNET, {"gamma1", "gamma2"}),
                                                 ("C3CASPD6", set())])
def test_new_models_param_groups_match_jax(name, frozen_leaves):
    """HorBlock's gamma1/gamma2 frozen (leaves JAX labels neither bias,
    scale, kernel nor BiFPN w); Adapt_Add2/3's w in g1 beside AdConcat's."""
    jm, params, stats, pm, size, _ = _pair(name)
    want = jo.param_groups(_shape_init(jm))
    paths = jax_paths(pm)
    got = {paths[k][1]: g for k, g in po.param_groups(pm).items()}
    assert got == want
    assert {k[-1] for k, g in got.items() if g == "frozen"} == frozen_leaves
    assert all(got[k] == "g1" for k in got if k[-1] == "w") and any(k[-1] == "w" for k in got)


def _npz_loads_in_jax(name, tmp_path):
    from dmayolo_tpu.utils.checkpoint import load_checkpoint as jax_load

    jm, _, _, pm, size, jfwd = _pair(name)
    params, stats = jax_from_state_dict(pm)
    save_checkpoint(tmp_path / "model", params=params, stats=stats, meta={"epoch": 0})
    trees, meta = jax_load(tmp_path / "model.npz")
    x = _images(size, seed=3)
    want = jfwd(trees["params"], trees["stats"], jnp.asarray(x))
    with torch.inference_mode():
        got = pm.apply(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_port_written_npz_loads_in_jax(tmp_path):
    _npz_loads_in_jax(DMA_FULL, tmp_path)


def test_port_written_npz_of_dma_hornet_loads_in_jax(tmp_path):
    _npz_loads_in_jax(DMA_HORNET, tmp_path)


# ---------------------------------------------------------------------------
# BN folding, the lazy decode and the bf16 serving tail of the new families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,folded", [("ghostnet", "ConvUnit"), ("adaptca", "AddConvBlock"),
                                         ("yolo_cspcm", "ConvBN")])
def test_fused_model_keeps_what_jax_keeps(name, folded):
    """`fuse()` folds every ConvUnit and AddConvBlock BN and leaves
    ConvMix's (after a GELU), as `fuse_params` does: the same leaves on
    both sides; the fused raw head equals the unfused one (f32, 1e-4)."""
    import copy

    cfg = _cfg(name, 0.33, 0.25)
    jm = JaxModel(dict(cfg), anchors=_anchors(cfg))
    params, stats = zoo_vars(jm, seed=5)
    fp, fs = fuse_params(jm, params, stats)
    pm = DetectionModel(dict(cfg), anchors=_anchors(cfg), device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    fused = copy.deepcopy(pm).fuse()
    assert set(fused.state_dict()) == set(state_dict_from_jax(fp, fs))
    assert any(type(m).__name__ == folded for m in pm.modules())
    kept = [m for m in fused.modules() if isinstance(m, pp.BatchNorm2d)]
    assert len(kept) == (2 * sum(type(m).__name__ == "ConvMix" for m in pm.modules()))
    x = torch.from_numpy(_images(128, seed=7))
    with torch.inference_mode():
        for a, b in zip(pm.apply(x), fused.apply(x, fused=True)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


def test_detect_decode_topk_matches_jax():
    """`decode_topk` on an anchor head (ghostnet's Detect over P2-P5):
    JAX's `decode_scores` / `decode_at` values, as sets (the top-k's order
    among equal scores is unspecified)."""
    jm, params, stats, pm, size, jfwd = _pair("ghostnet")
    x = _images(size, seed=8)
    raw = jfwd(params, stats, jnp.asarray(x))
    wb, ws, wc = (np.asarray(a) for a in jax.jit(
        lambda r: jm.decode_topk(r, k=256, conf_thres=0.1))(raw))
    gb, gs, gc = pm.decode_topk([torch.from_numpy(np.asarray(r)) for r in raw], k=256,
                                conf_thres=0.1)
    assert int((ws > 0.1).sum()) > 100
    np.testing.assert_allclose(gs.numpy(), ws, rtol=0, atol=1e-6)  # sorted scores
    for b in range(len(x)):
        keep = ws[b] > 0.1
        want = np.concatenate([wb[b], ws[b][:, None], wc[b][:, None]], 1)[keep]
        got = np.concatenate([gb[b].numpy(), gs[b].numpy()[:, None], gc[b].numpy()[:, None]],
                             1)[gs[b].numpy() > 0.1]
        _match_rows(want, got)


def test_bf16_serve_detections_matches_jax():
    """The small ghostnet at bf16.  Its raw heads: the port's within twice
    JAX's own bf16-to-f32 distance plus 2^-8 of JAX's bf16 head, relative
    to each level's largest value.  The tail: on JAX's bf16 head, with the
    objectness logits replaced by distinct bf16 values (a ramp over
    [-3, 3], a random permutation of the candidates, so that no two scores
    tie and no tie decides the set), `serve_detections` ("scan", conf
    0.25, IoU 0.45, max_det 300) gives JAX's detection sets in bf16:
    every box within 1e-3 px and every score within 1e-5 of JAX's
    (`tests/test_torch_model.py::_match_rows`)."""
    jm, params, stats, pm, size, jfwd = _pair("ghostnet")
    x = _images(size, seed=9)
    bf = jax.jit(lambda p, s, v: jm.apply(p, s, v.astype(jnp.bfloat16), dtype=jnp.bfloat16))
    want = bf(params, stats, jnp.asarray(x))
    f32 = jfwd(params, stats, jnp.asarray(x))
    with torch.inference_mode():
        got = pm.apply(torch.from_numpy(x).to(torch.bfloat16), dtype=torch.bfloat16)
    for w, g, f in zip(want, got, f32):
        w, f = np.asarray(w.astype(jnp.float32)), np.asarray(f)
        assert g.dtype == torch.bfloat16
        scale = float(np.abs(w).max())
        assert float(np.abs(g.float().numpy() - w).max()) / scale <= (
            2 * float(np.abs(w - f).max()) / scale + 2 ** -8)
    # 600 live candidates (above the top-512 cut, so that the cut and the
    # max_det cut both fall among them), their objectness logits distinct
    # bf16 values in [0.1, 6]; every other candidate's -8 (under the gate)
    rng = np.random.default_rng(0)
    raw = [np.array(w.astype(jnp.float32)) for w in want]
    sizes = [r[..., 4].size for r in raw]
    obj = np.full(sum(sizes), -8.0, np.float32)
    levels = np.unique(np.asarray(jnp.asarray(np.linspace(0.1, 6.0, 4000, dtype=np.float32))
                                  .astype(jnp.bfloat16).astype(jnp.float32)))
    obj[rng.choice(obj.size, 600, replace=False)] = rng.choice(levels, 600, replace=False)
    for r, part in zip(raw, np.split(obj, np.cumsum(sizes)[:-1])):
        r[..., 4] = part.reshape(r[..., 4].shape)
    raw_b = [jnp.asarray(r).astype(jnp.bfloat16) for r in raw]
    _, scores, _ = jax.jit(jm.decode_parts)(raw_b)
    live = np.asarray(scores)[np.asarray(scores) > 0.25]
    assert len(live) > 512 and len(np.unique(live)) == len(live)  # no tie above the gate
    wd, wv = (np.asarray(a) for a in jax.jit(
        lambda r: jm.serve_detections(r, conf_thres=0.25, backend="scan"))(raw_b))
    pd, pv = pm.serve_detections([torch.from_numpy(np.asarray(r.astype(jnp.float32)))
                                  .to(torch.bfloat16) for r in raw_b],
                                 conf_thres=0.25, backend="scan")
    assert int(wv.sum()) > 50
    for b in range(len(x)):
        _match_rows(wd[b][wv[b]].astype(np.float32), pd[b][pv[b]].float().numpy())


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def _no_dropout(jm, pm):
    """Every Dropout and DropPath rate 0, in both packages."""
    n = 0
    for m in jm.iter_modules():
        if isinstance(m, (jp.Dropout, jp.DropPath)):
            m.rate, n = 0.0, n + 1
    for m in pm.modules():
        if isinstance(m, (pp.Dropout, pp.DropPath)):
            m.rate, n = 0.0, n - 1
    return n


# DMA-HorNet's step at 160 px: at 128 px its P5 maps are 4 x 4 and the
# SPPFCSPC max pools there route the gradient by a near-tie that the two
# packages' f32 forwards (2e-5 of the activations apart at its input) fall
# on either side of: the port's SPPFCSPC backward on JAX's own input and
# incoming gradient equals JAX's within 3e-7, while JAX's on the port's
# input differs by 1.3% of the largest gradient, and so does the backbone
# below it (up to 2.9e-3 scaled).  At 160 px (5 x 5) the step holds at
# 2.7e-5
STEP_IMG = {DMA_HORNET: 160}


@pytest.mark.parametrize("name", [DMA_FULL, "yolov5s-transformer", DMA_HORNET])
def test_one_train_step_matches_jax(name):
    depth, width, _ = FAMILIES[name]
    cfg = _cfg(name, depth, width)
    jm = JaxModel(dict(cfg))
    params, stats = zoo_vars(jm, seed=6)
    pm = DetectionModel(dict(cfg), device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    assert _no_dropout(jm, pm) == 0
    hyp = jax_load_hyp("scratch")
    imgs, tg = batch(0, n=2, img=STEP_IMG.get(name, 128))
    jloss = jl.ComputeLoss(jm.head.anchors, hyp, nc=10)

    def lossfn(p):
        x = jnp.asarray(imgs).astype(jnp.float32) / 255.0
        raw, new_stats = jm.apply(p, stats, x, train=True, dtype=jnp.float32,
                                  rng=jax.random.PRNGKey(0))
        total, items = jloss(raw, jl.Targets(*(jnp.asarray(a) for a in tg)))
        return total, (items, new_stats)

    (want, (w_items, w_stats)), w_grads = jax.jit(jax.value_and_grad(lossfn, has_aux=True))(
        params)

    pm.train()
    ploss = pl.ComputeLoss(pm.head.anchors, hyp, nc=10)
    x = torch.from_numpy(imgs).to(torch.float32) / 255.0
    total, items = ploss(pm(x, torch.float32), pl.Targets(*(torch.from_numpy(a) for a in tg)))
    total.backward()
    assert abs(float(total.detach()) - float(want)) <= 1e-4 * abs(float(want))
    for k in ("box", "obj", "cls"):
        assert abs(float(items[k].detach()) - float(w_items[k])) <= 1e-4 * abs(float(w_items[k]))
    grads = {k: p.grad for k, p in pm.named_parameters()}
    got, _ = jax_from_state_dict(pm, {**pm.state_dict(), **grads})
    assert set(got) == set(w_grads)
    for k, g in w_grads.items():
        close_scaled(got[k], g, 1e-4, k)
    _, got_stats = jax_from_state_dict(pm)
    for k, s in w_stats.items():
        np.testing.assert_allclose(got_stats[k], np.asarray(s), rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))


def test_train_step_draws_dropout_from_its_generator():
    """The step lends its generator to every Dropout and DropPath: one
    seed gives one loss, another seed another (DMA-full small, every
    DropPath at rate 0.5 so that a batch of 2 draws differently); without
    a generator a drawing layer raises."""
    from dmayolo_tpu_torch.train import step as ps

    cfg = _cfg(DMA_FULL, 0.33, 0.25)
    pm = DetectionModel(dict(cfg), device="cpu").init_with_priors(
        torch.Generator().manual_seed(0))
    drop = [m for m in pm.modules() if isinstance(m, pp.DropPath)]
    assert drop
    for m in drop:
        m.rate = 0.5
    hyp = jax_load_hyp("scratch")
    sched = po.Schedule(hyp, epochs=1, steps_per_epoch=1, batch_size=2, warmup_min_iters=1)
    step = ps.make_train_step(pl.ComputeLoss(pm.head.anchors, hyp, nc=10), sched,
                              dtype=torch.float32)
    imgs, tg = batch(0, n=2, img=64)
    args = (torch.from_numpy(imgs), pl.Targets(*(torch.from_numpy(a) for a in tg)))

    def loss(seed):
        import copy

        state = ps.init_train_state(copy.deepcopy(pm), po.param_groups(pm), 5e-4)
        g = None if seed is None else torch.Generator().manual_seed(seed)
        out = float(step(state, *args, g)["loss"])
        assert all(m.generator is None for m in state.model.modules()
                   if isinstance(m, pp.DropPath))
        return out

    assert loss(3) == loss(3) != loss(4)
    with pytest.raises(RuntimeError, match="generator"):
        loss(None)
