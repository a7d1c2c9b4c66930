"""The port's letterbox and MicroBatcher on the CPU.

letterbox: the same geometry as the JAX (cv2) letterbox, and pixels within
1 of it.  cv2.INTER_LINEAR interpolates uint8 images in fixed point (11-bit
weights); the port interpolates in f32 and rounds, so a pixel may land on
the other side of a .5 boundary.

MicroBatcher: three requests of different sizes answered from one batch,
each equal to the same serve step run on its own letterboxed image.
"""
import threading

import numpy as np
import pytest
import torch

from dmayolo_tpu.data.augment import letterbox as cv2_letterbox
from dmayolo_tpu_torch.data.letterbox import letterbox
from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.serve.batcher import MicroBatcher, _buckets, _scale_to_native


@pytest.mark.parametrize("shape,new,auto", [
    ((1080, 1920, 3), 640, False),
    ((375, 500, 3), 640, False),
    ((90, 150, 3), 320, False),   # upscale
    ((640, 640, 3), 640, False),  # no resize, no pad
    ((375, 500, 3), 640, True),   # stride-rounded padding
])
def test_letterbox_matches_cv2(shape, new, auto):
    rng = np.random.default_rng(0)
    # smooth content (a ramp plus noise), as photographs are
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    img = (((yy * 3 + xx * 2)[..., None] + rng.integers(0, 60, shape)) % 256).astype(np.uint8)
    want, wr, wpad = cv2_letterbox(img, new, auto=auto)
    got, gr, gpad = letterbox(img, new, auto=auto)
    assert gr == wr and gpad == wpad
    assert tuple(got.shape) == want.shape and got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1


CFG = {
    "nc": 3,
    "depth_multiple": 0.33,
    "width_multiple": 0.25,
    "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                [116, 90, 156, 198, 373, 326]],
    "backbone": [
        [-1, 1, "Conv", [64, 6, 2, 2]],
        [-1, 1, "SCConv", [128, 2]],
        [-1, 2, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 1, "Conv", [512, 3, 2]],
    ],
    "head": [[[2, 3, 4], 1, "Detect", ["nc", "anchors"]]],
}
IMGSZ = 128


def test_microbatcher_answers_three_requests():
    model = DetectionModel(CFG, device="cpu").init_with_priors(torch.Generator().manual_seed(0))
    batcher = MicroBatcher(model, imgsz=IMGSZ, max_batch=4, max_wait_ms=500.0,
                           conf_thres=0.001, max_nms=256, dtype=torch.float32,
                           device="cpu")
    assert batcher.model is not model and batcher.model.fused and not model.fused
    batcher.warmup()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8)
            for s in ((100, 160, 3), (128, 128, 3), (300, 90, 3))]
    try:
        reqs = [None] * 3
        threads = [threading.Thread(target=lambda i=i: reqs.__setitem__(i, batcher.submit(imgs[i])))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        outs = [r.result(timeout=120) for r in reqs]
        with pytest.raises(ValueError):
            batcher.submit(np.zeros((8, 8), np.uint8))
    finally:
        batcher.close()
    assert batcher.stats_counters["requests"] == 3
    assert sum(batcher.stats_counters["batch_hist"].values()) == batcher.stats_counters["batches"]
    for img, out in zip(imgs, outs):
        lb = letterbox(img, (IMGSZ, IMGSZ), auto=False)[0]
        dets, valid = batcher._serve(lb[None])
        want = dets[0][valid[0]].numpy().copy()
        want[:, :4] = _scale_to_native(want[:, :4], (IMGSZ, IMGSZ), img.shape[:2])
        assert out.shape == want.shape and out.shape[1] == 6 and len(out) > 0
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-3)
        assert np.isfinite(out).all()
        assert (out[:, [0, 2]] >= 0).all() and (out[:, [0, 2]] <= img.shape[1]).all()
        assert (out[:, [1, 3]] >= 0).all() and (out[:, [1, 3]] <= img.shape[0]).all()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(imgs[0])


def test_buckets_are_powers_of_two_up_to_max():
    assert _buckets(32) == [1, 2, 4, 8, 16, 32]
    assert _buckets(6) == [1, 2, 4, 6]
