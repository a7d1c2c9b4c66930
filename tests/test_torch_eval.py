"""The port's eval protocol against the JAX package on the CPU.

The small flagship-shaped model of tests/test_torch_model.py runs in both
packages with the same numpy-drawn weights, at f32 and 64 px:

* `make_infer_fn` (conf 0.001, IoU 0.6, multi-label, max_det 300,
  max_nms 30,000; K = 2,520 candidates, so "matrix" takes the blocked path
  and "pallas" the streaming one), plain, with TTA and with hybrid labels:
  the same detections, boxes within 1e-3 px, scores within 1e-5;
* TTA's `scale_img` within 1e-5 (both antialias when they shrink);
* the numpy copies (metrics, COCO JSON, COCOeval) equal on random input;
* the mAP end to end: JAX `run_validation` on a synthetic dataset against
  the port's `make_infer_fn`, `_match_batch` and `_summarize` on the same
  batches: P, R, mAP@.5, mAP@.75 and mAP@.5:.95 within 1e-6.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.data.datasets import DetectionDataset, check_dataset
from dmayolo_tpu.data.loader import DataLoader
from dmayolo_tpu.data.synthetic import generate
from dmayolo_tpu.eval import coco_json as jcoco
from dmayolo_tpu.eval import cocoeval as jcocoeval
from dmayolo_tpu.eval import metrics as jmetrics
from dmayolo_tpu.eval.tta import scale_img as jax_scale_img
from dmayolo_tpu.eval.validator import make_infer_fn as jax_make_infer_fn
from dmayolo_tpu.eval.validator import run_validation
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu_torch.core import boxes as tboxes
from dmayolo_tpu_torch.eval import coco_json as tcoco
from dmayolo_tpu_torch.eval import cocoeval as tcocoeval
from dmayolo_tpu_torch.eval import metrics as tmetrics
from dmayolo_tpu_torch.eval.tta import scale_img
from dmayolo_tpu_torch.eval.validator import _match_batch, _summarize, make_infer_fn
from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_model import _match_rows, random_vars, small_cfg
from torch_dist_ranks import one_rank_group

from dmayolo_tpu_torch.parallel.mesh import close_group

PROTOCOL = dict(conf_thres=0.001, iou_thres=0.6, max_det=300)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(small_cfg())
    params, stats = random_vars(jm, seed=3)
    pm = DetectionModel(small_cfg(), device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return jm, params, stats, pm


def _images_u8(b, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3), dtype=np.uint8)


def _targets(b, m, seed):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 10, (b, m)).astype(np.float32)
    xy = rng.uniform(0.2, 0.8, (b, m, 2))
    box = np.concatenate([xy, rng.uniform(0.05, 0.3, (b, m, 2))], -1).astype(np.float32)
    mask = rng.uniform(0, 1, (b, m)) < 0.7
    return cls, box, mask


@pytest.mark.parametrize("augment,hybrid,backend", [
    (False, False, "scan"), (False, False, "matrix"), (False, False, "pallas"),
    (True, False, "matrix"), (False, True, "scan")])
def test_make_infer_fn_matches_jax(models, augment, hybrid, backend):
    jm, params, stats, pm = models
    x = _images_u8(2, 64, seed=4)
    tgt = _targets(2, 5, seed=5) if hybrid else ()
    kw = dict(PROTOCOL, augment=augment, hybrid=hybrid, max_nms=30000)
    want_d, want_v = (np.asarray(a) for a in jax_make_infer_fn(
        jm, params, stats, dtype=jnp.float32, **kw)(jnp.asarray(x), *map(jnp.asarray, tgt)))
    got_d, got_v = make_infer_fn(pm, dtype=torch.float32, nms_backend=backend, **kw)(
        torch.from_numpy(x), *map(torch.from_numpy, tgt))
    assert got_d.shape == (2, 300, 6) and got_d.dtype == torch.float32
    assert want_v.sum() > 100
    for b in range(2):
        _match_rows(want_d[b][want_v[b]], got_d[b][got_v[b]].numpy())


def test_make_infer_fn_refuses_what_is_not_ported(models):
    pm = models[3]
    # data-parallel eval is ported (tests/test_torch_dist.py at world 2):
    # a group of one gives the plain detections
    x = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    want = make_infer_fn(pm, **PROTOCOL)(x)
    mesh = one_rank_group()
    try:
        got = make_infer_fn(pm, mesh=mesh, **PROTOCOL)(x)
    finally:
        close_group()
    assert mesh.distributed and mesh.world == 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert torch.equal(got[1], want[1])
    # `spatial` on a mesh that splits no rows is the data-parallel path, as
    # in JAX (the split itself: tests/test_torch_spatial.py)
    mesh = one_rank_group()
    try:
        sp = make_infer_fn(pm, mesh=mesh, spatial=True, **PROTOCOL)(x)
    finally:
        close_group()
    torch.testing.assert_close(sp[0], want[0], rtol=0, atol=0)
    assert torch.equal(sp[1], want[1])
    with pytest.raises(ValueError, match="with TTA"):  # int8 is ported; TTA takes none
        make_infer_fn(pm, quant={}, augment=True, **PROTOCOL)


@pytest.mark.parametrize("ratio", [0.83, 0.67, 0.5])
@pytest.mark.parametrize("hw", [(64, 64), (96, 160)])
def test_scale_img_matches_jax(ratio, hw):
    x = np.random.default_rng(0).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_scale_img(jnp.asarray(x), ratio, 32))
    got = scale_img(torch.from_numpy(x), ratio, 32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_boxes_match_jax():
    from dmayolo_tpu.core import boxes as jboxes

    x = np.random.default_rng(1).uniform(-20, 700, (3, 7, 4)).astype(np.float32)
    j, t = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jboxes.xywh2xyxy(j), tboxes.xywh2xyxy(t)),
        (jboxes.xyxy2xywh(j), tboxes.xyxy2xywh(t)),
        (jboxes.xywhn2xyxy(j / 700, 640, 480, 3, 5), tboxes.xywhn2xyxy(t / 700, 640, 480, 3, 5)),
        (jboxes.xyxy2xywhn(j, 640, 480, clip=True, eps=1e-3),
         tboxes.xyxy2xywhn(t, 640, 480, clip=True, eps=1e-3)),
        (jboxes.xyn2xy(j[..., :2] / 700, 640, 480, 2, 1), tboxes.xyn2xy(t[..., :2] / 700, 640, 480, 2, 1)),
        (jboxes.clip_boxes(j, (480, 640)), tboxes.clip_boxes(t, (480, 640))),
        (jboxes.scale_boxes((640, 640), j, (375, 500)), tboxes.scale_boxes((640, 640), t, (375, 500))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    for args in [((375, 500), 640, True), ((1080, 1920), (640, 640), False),
                 ((90, 150), 320, False, False, False)]:
        assert tboxes.letterbox_params(*args) == jboxes.letterbox_params(*args)
    assert (tboxes.letterbox_params((375, 500), 640, False, True)
            == jboxes.letterbox_params((375, 500), 640, False, True))


def _random_eval_input(seed):
    rng = np.random.default_rng(seed)
    n = 60
    xy = rng.uniform(0, 300, (n, 2))
    dets = np.concatenate([xy, xy + rng.uniform(5, 80, (n, 2)), rng.uniform(0, 1, (n, 1)),
                           rng.integers(0, 4, (n, 1))], 1)
    labels = np.concatenate([rng.integers(0, 4, (25, 1)), dets[:25, :4]
                             + rng.normal(0, 6, (25, 4))], 1)
    return dets, labels


def test_metrics_copy_matches_jax():
    dets, labels = _random_eval_input(0)
    iouv = np.linspace(0.5, 0.95, 10)
    want = jmetrics.process_batch(dets, labels, iouv)
    got = tmetrics.process_batch(dets, labels, iouv)
    np.testing.assert_array_equal(got, want)
    assert want.any()
    np.testing.assert_array_equal(tmetrics.box_iou_np(dets[:, :4], labels[:, 1:]),
                                  jmetrics.box_iou_np(dets[:, :4], labels[:, 1:]))
    for w, g in zip(jmetrics.ap_per_class(want, dets[:, 4], dets[:, 5], labels[:, 0]),
                    tmetrics.ap_per_class(got, dets[:, 4], dets[:, 5], labels[:, 0])):
        np.testing.assert_array_equal(g, w)
    r = np.random.default_rng(1).uniform(0, 1, 30)
    for w, g in zip(jmetrics.compute_ap(np.sort(r), r), tmetrics.compute_ap(np.sort(r), r)):
        np.testing.assert_array_equal(g, w)
    x = np.random.default_rng(2).uniform(0, 1, (5, 7))
    np.testing.assert_array_equal(tmetrics.fitness(x), jmetrics.fitness(x))
    jc, tc = jmetrics.ConfusionMatrix(4), tmetrics.ConfusionMatrix(4)
    for seed in range(3):
        d, lb = _random_eval_input(seed)
        jc.process_batch(d, lb)
        tc.process_batch(d, lb)
    np.testing.assert_array_equal(tc.matrix, jc.matrix)
    for w, g in zip(jc.tp_fp(), tc.tp_fp()):
        np.testing.assert_array_equal(g, w)


def test_coco_json_and_cocoeval_copies_match_jax(tmp_path):
    files = ["a/000000042.jpg", "b/frame_0001.jpg", "b/7.jpg"]
    assert tcoco.image_id_map(files) == jcoco.image_id_map(files)
    assert tcoco.coco80_to_coco91_class() == jcoco.coco80_to_coco91_class()
    gt = {"images": [], "annotations": [], "categories": [{"id": c} for c in range(4)]}
    jd, td = [], []
    for i in range(3):
        dets, labels = _random_eval_input(10 + i)
        gt["images"].append({"id": i})
        for j, (c, x1, y1, x2, y2) in enumerate(labels):
            gt["annotations"].append({"id": len(gt["annotations"]) + 1, "image_id": i,
                                      "category_id": int(c), "bbox": [x1, y1, x2 - x1, y2 - y1],
                                      "area": (x2 - x1) * (y2 - y1), "iscrowd": int(j == 0)})
        jcoco.append_coco_json(jd, dets, class_map=list(range(4)), image_id=i)
        tcoco.append_coco_json(td, dets, class_map=list(range(4)), image_id=i)
    assert td == jd
    want = jcocoeval.NpCOCOeval(gt, jd).evaluate().summarize(verbose=False)
    got = tcocoeval.NpCOCOeval(gt, td).evaluate().summarize(verbose=False)
    np.testing.assert_array_equal(got, want)
    assert want[0] > 0
    pred, anno = tmp_path / "pred.json", tmp_path / "anno.json"
    tcoco.write_coco_json(td, pred)
    anno.write_text(json.dumps(gt))
    assert tcoco.evaluate_coco(pred, anno) == jcoco.evaluate_coco(pred, anno)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    return check_dataset(str(generate(root, n_train=0, n_val=8, img_size=64, seed=0)))["val"]


@pytest.mark.parametrize("hybrid", [False, True])
def test_map_end_to_end_matches_jax(models, synthetic, hybrid):
    """64 px images at imgsz 64: no resize, the same batches in both."""
    jm, params, stats, pm = models
    kw = dict(PROTOCOL, max_nms=30000)
    want = run_validation(jm, params, stats, synthetic, img_size=64, batch_size=8,
                          dtype=jnp.float32, save_hybrid=hybrid, **kw)
    ds = DetectionDataset(synthetic, img_size=64, augment=False, stride=int(jm.stride.max()),
                          nc=10, batch_size=8, pad=0.5)
    infer = make_infer_fn(pm, dtype=torch.float32, hybrid=hybrid, nms_backend="matrix", **kw)
    acc = []
    for batch in DataLoader(ds, 8, max_targets=256, shuffle=False, drop_last=False):
        t = batch.targets
        dets, valid = infer(batch.images, *((t.cls, t.box, t.mask) if hybrid else ()))
        stats_b, _ = _match_batch(dets.numpy(), valid.numpy(), batch.images.shape[1:3],
                                  t.cls, t.box, t.mask)
        acc += stats_b
    got = _summarize(acc, pm.nc)
    assert got.nt == want.nt > 0
    for name in ("mp", "mr", "map50", "map75", "map"):
        assert abs(getattr(got, name) - getattr(want, name)) <= 1e-6, name
    if hybrid:  # the labels joined the candidates: a real score
        assert want.map50 > 0.5
    np.testing.assert_allclose(got.maps, want.maps, rtol=0, atol=1e-6)
