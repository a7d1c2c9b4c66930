"""The port's autoanchor (`train/autoanchor.py`) and the Trainer's
`autoanchor` hook against the JAX package, on the CPU.

Both packages draw from the same random sources (the global NumPy state
for the jitter and scipy's k-means, `default_rng(seed)` for the GA), so
under one global seed they must give the same recall and the same anchors,
to the last bit.  The dataset is boxes drawn from a numpy seed on images
of several shapes (h, w).
"""
import numpy as np
import pytest
import torch
import yaml

from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.train import autoanchor as ja
from dmayolo_tpu_torch.graph import DetectionModel, model_config
from dmayolo_tpu_torch.train import autoanchor as pa
from dmayolo_tpu_torch.train.loss import Targets
from dmayolo_tpu_torch.train.trainer import Batch, Trainer, load_hyp

IMG, NC, B, M = 64, 10, 2, 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Labelled:
    """A dataset's `.shapes` (N, 2) as (h, w) and `.labels` [cls, x, y, w,
    h] rows, normalised; iterated, the loader batches of the Trainer."""

    def __init__(self, n=40, seed=0, batches=()):
        rng = np.random.default_rng(seed)
        self.shapes = np.stack([rng.integers(300, 1200, n), rng.integers(300, 1200, n)], 1)
        self.labels = []
        for i in range(n):
            k = int(rng.integers(0, 12))  # some images have no label
            wh = rng.lognormal(-2.5, 0.7, (k, 2)).clip(0.005, 0.9)
            xy = rng.uniform(0.1, 0.9, (k, 2))
            self.labels.append(np.concatenate(
                [rng.integers(0, NC, (k, 1)), xy, wh], 1).astype(np.float32))
        self.batches = list(batches)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def spd_cfg(name="C3CASPD2"):
    with open(model_config(name)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(depth_multiple=0.33, width_multiple=0.125, nc=NC)
    return cfg


def _batches(n=1, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cls = rng.integers(0, NC, (B, M)).astype(np.float32)
        box = np.concatenate([rng.uniform(0.2, 0.8, (B, M, 2)), rng.uniform(0.05, 0.4, (B, M, 2))],
                             -1).astype(np.float32)
        out.append(Batch(rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
                         Targets(cls, box, np.ones((B, M), bool))))
    return out


@pytest.mark.parametrize("img_size,thr", [(640, 4.0), (1024, 3.0)])
def test_check_anchors_matches_jax(img_size, thr):
    ds = Labelled()
    anchors = np.array([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                        [116, 90, 156, 198, 373, 326]], np.float64)
    np.random.seed(3)
    want = ja.check_anchors(anchors, ds.shapes.astype(np.float64), ds.labels, img_size, thr)
    np.random.seed(3)
    got = pa.check_anchors(anchors, ds.shapes.astype(np.float64), ds.labels, img_size, thr)
    assert got == want
    assert 0.0 < got[0] <= 1.0
    wh = pa.dataset_wh(ds.shapes.astype(np.float64), ds.labels, img_size)
    np.testing.assert_array_equal(
        wh, ja.dataset_wh(ds.shapes.astype(np.float64), ds.labels, img_size))
    k = anchors.reshape(-1, 2)
    assert pa.anchor_fitness(k, wh, 1 / thr) == ja.anchor_fitness(k, wh, 1 / thr)


@pytest.mark.parametrize("n,gen,seed", [(9, 30, 0), (16, 60, 2)])
def test_kmean_anchors_matches_jax(n, gen, seed):
    ds = Labelled(seed=1)
    shapes = ds.shapes.astype(np.float64)
    np.random.seed(5)
    want = ja.kmean_anchors(shapes, ds.labels, n=n, gen=gen, seed=seed)
    np.random.seed(5)
    got = pa.kmean_anchors(shapes, ds.labels, n=n, gen=gen, seed=seed)
    assert got.shape == (n, 2)
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got.prod(1)) >= 0).all()  # sorted by area


def test_maybe_autoanchor_replaces_placeholders_like_jax():
    """`anchors: 4` placeholders ([0..7] a level) are degenerate: both
    packages re-cluster them, whatever the recall says, and write the same
    anchors (stride units) into the head."""
    ds = Labelled(seed=2)
    jm = JaxModel(spd_cfg())
    pm = DetectionModel(spd_cfg(), device="cpu")
    assert float(pm.head.anchors.min()) <= 0
    np.random.seed(7)
    want = ja.maybe_autoanchor(jm, ds, 640, verbose=False)
    np.random.seed(7)
    got = pa.maybe_autoanchor(pm, ds, 640, verbose=False)
    assert got == want and 0.0 < got <= 1.0
    assert pm.head.anchors.shape == (4, 4, 2) and pm.head.anchors.dtype == np.float32
    np.testing.assert_array_equal(pm.head.anchors, jm.head.anchors)
    assert float(pm.head.anchors.min()) > 0
    # good anchors stay: the recall is above the threshold now
    before = pm.head.anchors.copy()
    assert pa.maybe_autoanchor(pm, ds, 640, bpr_thresh=0.0, verbose=False) is not None
    np.testing.assert_array_equal(pm.head.anchors, before)
    # a head without anchors is left alone
    assert pa.maybe_autoanchor(DetectionModel(spd_cfg("CASPD_ODRTA"), device="cpu"), ds, 640,
                               verbose=False) is None


def test_trainer_autoanchor_hook(tmp_path):
    """The Trainer re-clusters the placeholders on the loader's labels
    before the loss reads them (the anchors JAX's maybe_autoanchor gives
    under the same seed), saves them in `last.npz`, and a resumed run takes
    the checkpoint's anchors without clustering again."""
    ds = Labelled(seed=3, batches=_batches())
    kw = dict(nc=NC, epochs=1, batch_size=B, img_size=IMG, dtype=torch.float32, device="cpu",
              accumulate=1, autoanchor=True)
    np.random.seed(11)
    tr = Trainer(spd_cfg(), ds, load_hyp("scratch"), out_dir=str(tmp_path), **kw)
    jm = JaxModel(spd_cfg())
    np.random.seed(11)
    ja.maybe_autoanchor(jm, ds, IMG, thr=load_hyp("scratch")["anchor_t"])
    np.testing.assert_array_equal(tr.model.head.anchors, jm.head.anchors)
    np.testing.assert_array_equal(tr.loss.anchors.numpy(), jm.head.anchors)
    tr.train()
    np.random.seed(12)  # another draw would cluster other anchors
    resumed = Trainer(spd_cfg(), ds, load_hyp("scratch"), out_dir=str(tmp_path / "r"),
                      resume_from=str(tmp_path / "last.npz"), **dict(kw, epochs=2))
    np.testing.assert_array_equal(resumed.model.head.anchors, jm.head.anchors)


def test_trainer_hyp_anchors_override(tmp_path):
    """hyp `anchors: 3` gives three placeholder anchors a level, which the
    Trainer's autoanchor clusters as JAX's model built with anchors=3."""
    ds = Labelled(seed=4, batches=_batches())
    hyp = dict(load_hyp("scratch"), anchors=3)
    np.random.seed(13)
    tr = Trainer(spd_cfg(), ds, hyp, nc=NC, epochs=1, batch_size=B, img_size=IMG, device="cpu",
                 out_dir=str(tmp_path), autoanchor=True)
    jm = JaxModel(spd_cfg(), anchors=3)
    np.random.seed(13)
    ja.maybe_autoanchor(jm, ds, IMG, thr=hyp["anchor_t"])
    assert tr.model.head.na == 3 and tr.model.head.anchors.shape == (4, 3, 2)
    np.testing.assert_array_equal(tr.model.head.anchors, jm.head.anchors)


def test_trainer_placeholder_anchors_need_autoanchor(tmp_path):
    kw = dict(nc=NC, epochs=1, batch_size=B, img_size=IMG, device="cpu", out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="autoanchor=True"):
        Trainer(spd_cfg(), _batches(), load_hyp("scratch"), **kw)
    with pytest.raises(ValueError, match=r"\.shapes and \.labels"):
        Trainer(spd_cfg(), _batches(), load_hyp("scratch"), autoanchor=True, **kw)
