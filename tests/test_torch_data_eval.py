"""The port's `run_validation` (dmayolo_tpu_torch/eval/validator.py)
against the JAX package's on the same files and weights, on the CPU at f32.

The set: 8 JAX-generated VisDrone-analog images at 96 px, the val size, so
no resize enters.  Its labels are the small flagship-shaped model's own
detections (seeded numpy weights, both packages; thin boxes, clipped to
the image), a third of them moved by a seeded jitter of 15% of their
size, a few dropped and a few made up, so that P, R and the
mAPs land mid-range and test something.  Held: P, R, mAP@.5, mAP@.75 and
mAP@.5:.95 within 1e-6 of JAX's, on the three NMS backends, with rect
batches, single_cls and hybrid labels; the txt rows and COCO entries
within 1e-3 px (of JAX's, on detections that agree to 1e-5); the device
rule and the options that are not ported.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.data.synthetic import generate_visdrone_analog
from dmayolo_tpu.eval.validator import run_validation as jax_run_validation
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu_torch.data.datasets import DetectionDataset
from dmayolo_tpu_torch.data.loader import DataLoader
from dmayolo_tpu_torch.eval.validator import make_infer_fn, run_validation
from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_model import random_vars, small_cfg
from torch_dist_ranks import one_rank_group

from dmayolo_tpu_torch.parallel.mesh import close_group

SIZE = 96
METRICS = ("mp", "mr", "map50", "map75", "map")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(small_cfg())
    params, stats = random_vars(jm, seed=3)
    pm = DetectionModel(small_cfg(), device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return jm, params, stats, pm.eval()


def pseudo_label(root, split, pm, seed=0):
    """Rewrite the split's labels as the model's detections, jittered."""
    rng = np.random.default_rng(seed)
    ds = DetectionDataset(str(root / "images" / split), img_size=SIZE, nc=10)
    infer = make_infer_fn(pm, 0.2, 0.6, 12, dtype=torch.float32)
    for batch in DataLoader(ds, 4, shuffle=False, drop_last=False, workers=1):
        dets, valid = infer(batch.images)
        for i, idx in enumerate(batch.indices):
            d = dets[i][valid[i]].numpy().astype(np.float64)
            d = d[rng.uniform(size=len(d)) > 0.15]  # some missed
            jit = rng.uniform(size=len(d)) < 0.35  # moved by 15% of the box's size
            wh = np.tile(d[jit, 2:4] - d[jit, 0:2], 2)
            d[jit, :4] += rng.normal(0, 0.15, wh.shape) * wh
            extra = rng.uniform(0, SIZE - 20, (2, 2))
            made_up = np.concatenate([extra, extra + rng.uniform(6, 20, (2, 2)),
                                      np.ones((2, 1)), rng.integers(0, 10, (2, 1))], 1)
            d = np.concatenate([d, made_up])
            xy = np.clip(d[:, :4], 0, SIZE)
            rows = [(int(c), (x1 + x2) / 2 / SIZE, (y1 + y2) / 2 / SIZE, (x2 - x1) / SIZE,
                     (y2 - y1) / SIZE) for (x1, y1, x2, y2), c in zip(xy, d[:, 5])
                    if x2 > x1 and y2 > y1]
            lb = root / "labels" / split / (ds.im_files[idx].rsplit("/", 1)[1].rsplit(".", 1)[0] + ".txt")
            lb.write_text("".join(f"{c} {x:.6f} {y:.6f} {w:.6f} {h:.6f}\n" for c, x, y, w, h in rows))
    (root / "labels" / f"{split}.cache.npz").unlink()


@pytest.fixture(scope="module")
def val_set(tmp_path_factory, models):
    root = tmp_path_factory.mktemp("val")
    generate_visdrone_analog(root, n_train=0, n_val=8, img_size=SIZE, seed=4,
                             min_objects=10, max_objects=30)
    pseudo_label(root, "val", models[3])
    return str(root / "images" / "val")


def _txt_rows(d):
    return {p.name: np.loadtxt(p, ndmin=2) for p in sorted(d.iterdir())}


@pytest.mark.parametrize("backend,opts", [
    ("scan", {"save": True}),
    ("matrix", {"rect": True, "pad": 0.0}),
    ("pallas", {"single_cls": True}),
    ("matrix", {"save_hybrid": True}),
])
def test_run_validation_matches_jax(models, val_set, tmp_path, backend, opts):
    jm, params, stats, pm = models
    kw = dict(img_size=SIZE, batch_size=4, **opts)
    save = kw.pop("save", False)
    jj, pj = [], []
    # JAX's "pallas" needs the TPU; its greedy result is "scan"'s
    want = jax_run_validation(jm, params, stats, val_set, dtype=jnp.float32,
                              nms_backend="scan" if backend == "pallas" else backend,
                              **(dict(save_json=jj, save_txt_dir=tmp_path / "j", save_conf=True)
                                 if save else {}), **kw)
    got = run_validation(pm, val_set, dtype=torch.float32, device="cpu", workers=2,
                         nms_backend=backend,
                         **(dict(save_json=pj, save_txt_dir=tmp_path / "p", save_conf=True)
                            if save else {}), **kw)
    assert got.nt == want.nt > 0
    for name in METRICS:
        assert abs(getattr(got, name) - getattr(want, name)) <= 1e-6, name
    assert 0.05 < want.map50 < 1.0
    np.testing.assert_allclose(got.maps, want.maps, rtol=0, atol=1e-6)
    assert set(got.speed_ms) == set(want.speed_ms) | {"loader_wait"}
    if not save:
        return
    # the txt rows (xywhn) and COCO entries of detections that agree to 1e-5
    a, b = _txt_rows(tmp_path / "p"), _txt_rows(tmp_path / "j")
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-3 / SIZE + 1e-5)
    assert len(pj) == len(jj) and got.used_image_ids == want.used_image_ids
    for e, f in zip(pj, jj):
        assert (e["image_id"], e["category_id"]) == (f["image_id"], f["category_id"])
        np.testing.assert_allclose(e["bbox"], f["bbox"], rtol=0, atol=2e-3)
        assert abs(e["score"] - f["score"]) <= 1e-4


def test_run_validation_device_and_refusals(models, val_set):
    pm = models[3]
    if not torch.cuda.is_available():  # device None means CUDA, never a silent CPU run
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_validation(pm, val_set, img_size=SIZE)
    # data-parallel eval is ported (tests/test_torch_dist.py at world 2): in
    # a group of one, every row goes through the gather and the result is
    # the plain one
    want = run_validation(pm, val_set, img_size=SIZE, batch_size=4, device="cpu",
                          dtype=torch.float32, workers=1)
    mesh = one_rank_group()
    try:
        got = run_validation(pm, val_set, img_size=SIZE, batch_size=4, device="cpu",
                             dtype=torch.float32, workers=1, mesh=mesh)
    finally:
        close_group()
    assert got.summary() == want.summary() and want.nt > 0
    np.testing.assert_array_equal(got.maps, want.maps)
    # `spatial` on a mesh that splits no rows is the data-parallel run, as
    # in JAX (the split itself: tests/test_torch_spatial.py); int8 with TTA
    # keeps JAX's refusal
    mesh = one_rank_group()
    try:
        got = run_validation(pm, val_set, img_size=SIZE, batch_size=4, device="cpu",
                             dtype=torch.float32, workers=1, mesh=mesh, spatial=True)
    finally:
        close_group()
    assert got.summary() == want.summary()
    np.testing.assert_array_equal(got.maps, want.maps)
    with pytest.raises(ValueError, match="with TTA"):
        run_validation(pm, val_set, img_size=SIZE, device="cpu", quant={}, augment=True)
