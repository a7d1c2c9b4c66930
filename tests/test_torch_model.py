"""The port's DetectionModel and serving tail against the JAX package.

A small model of the flagship's shape (ablation-ca-scconv-sppfcspc at depth
0.33, width 0.125, nc 10: the same Conv stem, SCConv, C3, CA, SPPFCSPC and
Detect modules) runs in both packages with the same numpy-drawn weights.
At 64 px every SCConv gate takes the blocked-upsample branch; at 96 px the
last one (6x6 input, pooled by 4) takes the nearest-resize branch.

Tolerances: raw head f32 rtol = atol = 1e-4 (convolution summation order);
decode_parts 1e-5; served detections: same count and classes, boxes within
1e-3 px, scores within 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.nn.fuse import fuse_params
from dmayolo_tpu.utils.checkpoint import save_checkpoint
from dmayolo_tpu_torch.graph import DetectionModel, model_config
from dmayolo_tpu_torch.serve.batcher import MicroBatcher
from dmayolo_tpu_torch.utils.weights import load_jax_checkpoint, state_dict_from_jax

FLAGSHIP = "ablation-ca-scconv-sppfcspc"


def small_cfg():
    with open(model_config(FLAGSHIP)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(depth_multiple=0.33, width_multiple=0.125, nc=10)
    return cfg


def random_vars(jmod, seed=0):
    """Numpy-drawn (params, stats) with the JAX model's paths and shapes;
    biases spread wide so detection scores rarely tie."""
    rng = np.random.default_rng(seed)
    pshape, sshape = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    params, stats = {}, {}
    for k, s in pshape.items():
        if k[-1] == "kernel":
            v = rng.normal(0, int(np.prod(s.shape[:-1])) ** -0.5, s.shape)
        elif k[-1] == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0, 1.0, s.shape)
        params[k] = jnp.asarray(v.astype(np.float32))
    for k, s in sshape.items():
        v = rng.uniform(0.5, 1.5, s.shape) if k[-1] == "var" else rng.normal(0, 0.2, s.shape)
        stats[k] = jnp.asarray(v.astype(np.float32))
    return params, stats


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(small_cfg())
    params, stats = random_vars(jm)
    pm = DetectionModel(small_cfg(), device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return jm, params, stats, pm


def _images(size, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (2, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("fused", [False, True])
def test_raw_head_matches_jax(pair, size, fused):
    jm, params, stats, pm = pair
    x = _images(size)
    if fused:
        params, stats = fuse_params(jm, params, stats)
        pm = copy.deepcopy(pm).fuse()
    want = jax.jit(lambda p, s, v: jm.apply(p, s, v, fused=fused))(params, stats, jnp.asarray(x))
    got = pm.apply(torch.from_numpy(x), fused=fused)
    assert len(got) == 3
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_decode_parts_matches_jax(pair):
    jm, params, stats, pm = pair
    raw = jax.jit(jm.apply)(params, stats, jnp.asarray(_images(96)))
    want = jm.decode_parts(raw)
    got = pm.decode_parts([torch.tensor(np.asarray(r)) for r in raw])
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _match_rows(want: np.ndarray, got: np.ndarray):
    """Every JAX detection has one port detection within tolerance (rows
    with equal scores may come out in either order)."""
    assert len(want) == len(got)
    free = list(range(len(got)))
    for row in want:
        hits = [j for j in free
                if np.allclose(got[j, :4], row[:4], atol=1e-3, rtol=0)
                and abs(got[j, 4] - row[4]) <= 1e-5 and got[j, 5] == row[5]]
        assert hits, f"no port detection matches {row}"
        free.remove(hits[0])


@pytest.mark.parametrize("backend", ["pallas", "scan", "matrix"])
def test_serve_detections_matches_jax(pair, backend):
    """End to end at conf 0.0: all 252 candidates of a 64 px image are live,
    fewer than max_det = 300, so the padded slots run too."""
    jm, params, stats, pm = pair
    x = _images(64, seed=2)

    @jax.jit
    def serve(p, s, v):
        return jm.serve_detections(jm.apply(p, s, v), conf_thres=0.0, backend="scan")

    want_d, want_v = (np.asarray(a) for a in serve(params, stats, jnp.asarray(x)))
    with torch.inference_mode():
        got_d, got_v = pm.serve_detections(pm.apply(torch.from_numpy(x)), conf_thres=0.0,
                                           backend=backend)
    assert got_d.shape == (2, 300, 6) and got_v.shape == (2, 300)
    assert not got_d[~got_v].any()  # invalid slots are zeroed
    for b in range(2):
        _match_rows(want_d[b][want_v[b]], got_d[b][got_v[b]].numpy())


def test_full_width_flagship_builds_like_jax():
    """Full width, nc 10: same strides, anchors, and state_dict keys and
    shapes as the JAX model's parameter tree (no forward)."""
    path = model_config(FLAGSHIP)
    jm = JaxModel(str(path), nc=10)
    pm = DetectionModel(path, nc=10, device="cpu")
    np.testing.assert_array_equal(pm.stride, jm.stride)
    np.testing.assert_array_equal(pm.head.anchors, jm.head.anchors)
    pshape, sshape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = {}
    for tree in (pshape, sshape):
        for k, s in tree.items():
            key = ".".join(k[:-1]) + "." + {"kernel": "weight", "scale": "weight",
                                            "bias": "bias", "mean": "running_mean",
                                            "var": "running_var"}[k[-1]]
            shape = s.shape if k[-1] != "kernel" else (s.shape[3], s.shape[2], s.shape[0], s.shape[1])
            want[key] = tuple(shape)
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == want


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    model = DetectionModel(small_cfg(), device="cpu")
    save_checkpoint(tmp_path / "w.npz", params={("a", "bias"): np.zeros(2, np.float32)}, stats={})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionModel(small_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionModel(small_cfg(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        MicroBatcher(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_jax_checkpoint(tmp_path / "w.npz")


def test_unknown_module_raises_keyerror():
    cfg = small_cfg()
    cfg["backbone"][1] = [-1, 1, "C3Unknown", [128]]  # in neither package's registry
    with pytest.raises(KeyError, match="C3Unknown"):
        DetectionModel(cfg, device="cpu")


def test_load_jax_checkpoint_prefers_ema_and_upcasts(tmp_path, pair):
    jm, params, stats, _ = pair
    ema = {k: v * 0.5 for k, v in params.items()}
    save_checkpoint(tmp_path / "w.npz", params=params, stats=stats, ema_params=ema,
                    ema_stats=stats, meta={"nc": 10}, half=True)
    sd, meta = load_jax_checkpoint(tmp_path / "w.npz", device="cpu")
    assert meta["nc"] == 10
    want = state_dict_from_jax({k: np.asarray(v, np.float16).astype(np.float32)
                                for k, v in ema.items()},
                               {k: np.asarray(v, np.float16).astype(np.float32)
                                for k, v in stats.items()})
    assert set(sd) == set(want)
    for k in want:
        assert sd[k].dtype == torch.float32
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    DetectionModel(small_cfg(), device="cpu").load_state_dict(sd, strict=True)
