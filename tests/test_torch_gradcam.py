"""The port's Grad-CAM (dmayolo_tpu_torch/eval/gradcam.py, cli/gradcam.py)
against the JAX package's, on the CPU at f32.

The mini net of tests/test_gradcam.py (a Concat skip across the split
point, so the tail reads a saved activation), with a Detect head and with
a TDetect head, both packages on the same numpy-drawn weights:

- split plus tail equals the full forward, at three split points;
- the CAM of the best P2 candidate at layer 9, and of the best candidate
  at layer 2 (the skip's source, read again by the tail), equals JAX's:
  within 1e-4 for gradcam (the weights are gradient means, normalised to
  [0, 1]) and 1e-3 for gradcampp (its alpha divides by 2 g^2 + sum A g^3,
  which amplifies the two autodiffs' rounding where that sum is small);
- `resolve_target_layer` and `upsample_cam` give JAX's values;
- `cli.gradcam` writes an overlay an image and a CAM a detection, the
  CAMs those of `cam_for_detection` for its kept detections.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmayolo_tpu.eval.gradcam as jg
from dmayolo_tpu.core.nms import batched_nms as jax_batched_nms
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dmayolo_tpu_torch.cli import gradcam as pcli
from dmayolo_tpu_torch.data.imageio import imwrite
from dmayolo_tpu_torch.eval import gradcam as pg
from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.utils.weights import state_dict_from_jax

from test_gradcam import CFG
from test_torch_model import random_vars

TOL = {"gradcam": 1e-4, "gradcampp": 1e-3}


def tdetect_cfg():
    cfg = copy.deepcopy(CFG)
    cfg["head"][-1] = [[9, 5], 1, "TDetect", ["nc"]]
    return cfg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["Detect", "TDetect"])
def pair(request):
    cfg = CFG if request.param == "Detect" else tdetect_cfg()
    jm = JaxModel(cfg)
    params, stats = random_vars(jm, seed=1)
    pm = DetectionModel(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    x = np.random.default_rng(0).uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    return cfg, jm, params, stats, pm, x


def best_candidate(dec: np.ndarray, nc: int, n: int):
    """The highest-scoring of the first n candidates and its class."""
    if dec.shape[-1] == nc + 4:
        conf = dec[0, :n, 4:].max(-1)
        cls = dec[0, :n, 4:].argmax(-1)
    else:
        conf = dec[0, :n, 4] * dec[0, :n, 5:].max(-1)
        cls = dec[0, :n, 5:].argmax(-1)
    cand = int(conf.argmax())
    return cand, int(cls[cand])


def test_split_tail_equals_full_forward(pair):
    _, _, _, _, pm, x = pair
    xt = torch.as_tensor(x)
    with torch.no_grad():
        full = pm.decode(pm.apply(xt))
        for layer_i in (2, 5, 9):  # before the skip's save, the backbone's end, the head
            feat, saved = pg.split_forward(pm, xt, layer_i)
            out = pm.decode(pg.tail_forward(pm, feat, saved, layer_i))
            np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["gradcam", "gradcampp"])
def test_cam_matches_jax(pair, method):
    cfg, jm, params, stats, pm, x = pair
    dec = np.asarray(jm.decode(jm.apply(params, stats, jnp.asarray(x))))
    # layer 9 feeds only the first level (P2, 32x32 cells) of the head;
    # layer 2 feeds both, once through layer 3 and once through layer 8's
    # skip, where the tail reads the target's own saved entry
    n0 = (3 if dec.shape[-1] == cfg["nc"] + 5 else 1) * 32 * 32
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    for layer_i, n in ((9, n0), (2, dec.shape[1])):
        cand, cls = best_candidate(dec, cfg["nc"], n)
        # a cache a layer: JAX's caches the grad function of its first layer
        want = jg.cam_for_detection(jm, params, stats, xj, layer_i, cand, cls, method=method,
                                    _cache={})
        got = pg.cam_for_detection(pm, xt, layer_i, cand, cls, method=method, _cache={})
        assert got.shape == want.shape and want.max() > 0
        np.testing.assert_allclose(got, want, atol=TOL[method], rtol=0)


def test_resolve_target_layer_and_upsample(pair):
    _, jm, _, _, pm, _ = pair
    for t in ("model_9_cv3_act", "4", " model_0_conv "):
        assert pg.resolve_target_layer(pm, t) == jg.resolve_target_layer(jm, t)
    for bad in ("10", "-1"):
        with pytest.raises(ValueError, match="out of range"):
            pg.resolve_target_layer(pm, bad)
    cam = np.random.default_rng(2).uniform(0, 1, (7, 9))
    for size in ((28, 36), (5, 40), (7, 9)):
        np.testing.assert_array_equal(pg.upsample_cam(cam, size), jg.upsample_cam(cam, size))


def test_cli_gradcam(pair, tmp_path):
    cfg, jm, params, stats, pm, _ = pair
    ckpt = tmp_path / "w.npz"
    jax_save_checkpoint(ckpt, params=params, stats=stats, meta={"cfg": cfg, "nc": cfg["nc"]})
    img = (np.random.default_rng(4).uniform(0, 1, (96, 160, 3)) * 255).astype(np.uint8)
    imwrite(tmp_path / "a.png", img)
    res = pcli.main(["--model-path", str(ckpt), "--img-path", str(tmp_path / "a.png"),
                     "--output-dir", str(tmp_path / "out"), "--img-size", "128",
                     "--target-layer", "9", "--max-dets", "3", "--conf-thres", "0.0",
                     "--method", "gradcampp", "--device", "cpu"])
    (r,) = res
    assert len(r["cams"]) == 3 and r["out"].exists()
    assert len(list(r["out"].parent.glob("a_det*.jpg"))) == 3
    # the CLI's detections are JAX's batched_nms of the same letterboxed input
    from dmayolo_tpu.data.augment import letterbox

    lb = letterbox(img, (128, 128), auto=False)[0]
    x = jnp.asarray(lb[:, :, ::-1].astype(np.float32) / 255.0)[None]
    dec = jm.decode(jm.apply(params, stats, x))
    if dec.shape[-1] == cfg["nc"] + 4:
        dec = jnp.concatenate([dec[..., :4], jnp.ones_like(dec[..., :1]), dec[..., 4:]], -1)
    dets, valid, srcs = jax_batched_nms(dec, conf_thres=0.0, iou_thres=0.45, max_det=3,
                                        return_src=True)
    np.testing.assert_allclose(r["dets"], np.asarray(dets[0])[:3], atol=1e-3, rtol=0)
    cache = {}
    for j, cam in enumerate(r["cams"]):
        want = jg.cam_for_detection(jm, params, stats, x, 9, int(srcs[0, j]),
                                    int(dets[0, j, 5]), method="gradcampp", _cache=cache)
        np.testing.assert_allclose(cam, want, atol=TOL["gradcampp"], rtol=0)
