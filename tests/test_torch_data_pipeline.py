"""The port's data pipeline (dmayolo_tpu_torch/data/: synthetic,
datasets, augment, loader, device_aug, tools; eval/coco_json's GT builder)
against the JAX package's on the same files, on the CPU.

The inputs are drawn once a module by the JAX generator (160 px, 8 train
and 8 val images), so both packages read the same JPEGs.  What is held:

- the port's generators write label files byte-equal to the JAX ones'
  (the same numpy draws); their images differ by the raster's boundary
  pixels and JPEG: mean absolute difference under 4 levels;
- `DetectionDataset`: files, labels, shapes, rect batch shapes equal; the
  label cache of either package read by the other;
- `get(i, Random(k))`: labels equal always.  Images: augment off, through
  the area resize (160 -> 128 px), within 1 level; with the VisDrone hyp
  (mosaic, warp, mixup, HSV, flip) within 24 levels at most and 1 on
  average (a 1-level difference of a warped pixel can move its hue by a
  few levels through the HSV tables); with the photometric, cutout and
  9-mosaic paths on, and with copy_paste on polygon labels, labels equal;
- `DataLoader`: order, indices and targets equal to JAX's, images within
  the bounds above; the batches equal bytes at 1 and 3 workers; quad and
  image-weight sampling equal;
- `device_aug` within 1e-6 of JAX's given the same gains and flips;
- `build_coco_gt_from_yolo`, `autosplit`, `dataset_stats`, `extract_boxes`
  equal.
"""
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.data import datasets as jd
from dmayolo_tpu.data import device_aug as jda
from dmayolo_tpu.data import loader as jl
from dmayolo_tpu.data import synthetic as js
from dmayolo_tpu.data import tools as jt
from dmayolo_tpu.eval.coco_json import build_coco_gt_from_yolo as jax_coco_gt
from dmayolo_tpu_torch.data import datasets as pd
from dmayolo_tpu_torch.data import device_aug as pda
from dmayolo_tpu_torch.data import loader as pl
from dmayolo_tpu_torch.data import synthetic as ps
from dmayolo_tpu_torch.data import tools as pt
from dmayolo_tpu_torch.data.imageio import imread
from dmayolo_tpu_torch.eval.coco_json import build_coco_gt_from_yolo as port_coco_gt
from dmayolo_tpu_torch.train.trainer import load_hyp

NATIVE, IMG = 160, 128
GEN = dict(n_train=8, n_val=8, img_size=NATIVE, min_objects=10, max_objects=30, seed=2)
AUG_MAX, AUG_MEAN = 24, 1.0  # augmented images: the bound stated above


def absdiff(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("vda")
    js.generate_visdrone_analog(d, **GEN)
    return d


def fresh(root, tmp_path, split="train"):
    """A copy of the split's images and labels, without a label cache."""
    dst = tmp_path / "copy"
    for kind in ("images", "labels"):
        shutil.copytree(root / kind / split, dst / kind / split)
    return str(dst / "images" / split)


@pytest.mark.parametrize("kind", ["shapes", "visdrone"])
def test_generators_write_jax_labels(tmp_path, kind):
    if kind == "shapes":
        args = dict(n_train=3, n_val=2, img_size=96, seed=1)
        js.generate(tmp_path / "j", **args)
        ps.generate(tmp_path / "p", **args)
    else:
        args = dict(n_train=2, n_val=2, img_size=192, seed=3)
        js.generate_visdrone_analog(tmp_path / "j", **args)
        ps.generate_visdrone_analog(tmp_path / "p", workers=2, **args)
    for split in ("train", "val"):
        ours = sorted((tmp_path / "p" / "labels" / split).iterdir())
        ref = sorted((tmp_path / "j" / "labels" / split).iterdir())
        assert [f.name for f in ours] == [f.name for f in ref]
        for a, b in zip(ours, ref):
            assert a.read_bytes() == b.read_bytes(), a.name
        for a, b in zip(sorted((tmp_path / "p" / "images" / split).iterdir()),
                        sorted((tmp_path / "j" / "images" / split).iterdir())):
            assert absdiff(imread(a), imread(b)).mean() < 4


def assert_same_dataset(ours, ref):
    assert ours.im_files == ref.im_files and ours.label_files == ref.label_files
    np.testing.assert_array_equal(ours.shapes, ref.shapes)
    assert len(ours.labels) == len(ref.labels)
    for a, b in zip(ours.labels, ref.labels):
        np.testing.assert_array_equal(a, b)
    if ref.rect:
        np.testing.assert_array_equal(ours.batch_shapes, ref.batch_shapes)
        np.testing.assert_array_equal(ours.batch_index, ref.batch_index)


@pytest.mark.parametrize("rect", [False, True])
def test_dataset_equal(root, tmp_path, rect):
    kw = dict(img_size=IMG, rect=rect, batch_size=3, pad=0.5, nc=10)
    ref = jd.DetectionDataset(fresh(root, tmp_path / "j"), **kw)
    ours = pd.DetectionDataset(fresh(root, tmp_path / "p"), **kw)
    for ds, own in ((ours, tmp_path / "p"), (ref, tmp_path / "j")):
        ds.im_files = [f.replace(str(own), "") for f in ds.im_files]
        ds.label_files = [f.replace(str(own), "") for f in ds.label_files]
    assert_same_dataset(ours, ref)


def test_label_caches_read_across(root, tmp_path, monkeypatch):
    path = fresh(root, tmp_path)
    ref = jd.DetectionDataset(path, img_size=IMG, nc=10)  # writes the cache

    def no_scan(*a):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(pd, "verify_image_label", no_scan)
    assert_same_dataset(pd.DetectionDataset(path, img_size=IMG, nc=10), ref)
    monkeypatch.undo()
    (tmp_path / "copy" / "labels" / "train.cache.npz").unlink()
    ours = pd.DetectionDataset(path, img_size=IMG, nc=10)  # the port writes it
    monkeypatch.setattr(jd, "verify_image_label", no_scan)
    assert_same_dataset(jd.DetectionDataset(path, img_size=IMG, nc=10), ours)


def hyp_all_paths():
    h = load_hyp("visdrone")
    h.update(mosaic9=0.5, cutout=0.7, blur=0.5, median_blur=0.5, to_gray=0.3,
             brightness_contrast=0.5, flipud=0.5, degrees=5.0, shear=2.0, perspective=1e-4)
    return h


@pytest.mark.parametrize("hyp", ["off", "visdrone", "all"])
def test_get_equal(root, hyp):
    path = str(root / "images" / "train")
    h = {"off": None, "visdrone": load_hyp("visdrone"), "all": hyp_all_paths()}[hyp]
    kw = dict(img_size=IMG, augment=h is not None, hyp=h, nc=10)
    ref, ours = jd.DetectionDataset(path, **kw), pd.DetectionDataset(path, **kw)
    for i in range(len(ref)):
        im_r, lb_r = ref.get(i, random.Random(17 + i))
        im_o, lb_o = ours.get(i, random.Random(17 + i))
        np.testing.assert_array_equal(lb_o, lb_r)
        assert im_o.shape == im_r.shape and im_o.dtype == np.uint8
        d = absdiff(im_o, im_r)
        if h is None:
            assert d.max() <= 1, i
        elif hyp == "visdrone":
            assert d.max() <= AUG_MAX and d.mean() <= AUG_MEAN, (i, d.max(), d.mean())


def test_copy_paste_on_polygons(root, tmp_path):
    """Polygon label rows (each box as its four corners): copy_paste pastes
    mirrored copies; the labels equal JAX's."""
    path = fresh(root, tmp_path)
    for f in (tmp_path / "copy" / "labels" / "train").iterdir():
        rows = np.loadtxt(f, ndmin=2)
        with open(f, "w") as out:
            for c, x, y, w, h in rows:
                xs = np.clip([x - w / 2, x + w / 2, x + w / 2, x - w / 2], 0, 1)
                ys = np.clip([y - h / 2, y - h / 2, y + h / 2, y + h / 2], 0, 1)
                out.write(f"{int(c)} " + " ".join(f"{a:.6f} {b:.6f}" for a, b in zip(xs, ys)) + "\n")
    h = load_hyp("visdrone")
    h.update(copy_paste=0.5, mixup=0.0)
    ref = jd.DetectionDataset(path, img_size=IMG, augment=True, hyp=h, nc=10)
    (tmp_path / "copy" / "labels" / "train.cache.npz").unlink()
    ours = pd.DetectionDataset(path, img_size=IMG, augment=True, hyp=h, nc=10)
    for i in range(4):
        np.testing.assert_array_equal(ours.get(i, random.Random(i))[1], ref.get(i, random.Random(i))[1])


def batches(loader):
    return [(b.indices, np.asarray(b.images), [np.asarray(t) for t in b.targets]) for b in loader]


@pytest.mark.parametrize("mode", ["plain", "quad", "weights"])
def test_loader_equal(root, mode):
    path = str(root / "images" / "train")
    h = load_hyp("visdrone")
    kw = dict(max_targets=40, seed=5, quad=mode == "quad")
    ref_ds = jd.DetectionDataset(path, img_size=IMG, augment=True, hyp=h, nc=10)
    ours_ds = pd.DetectionDataset(path, img_size=IMG, augment=True, hyp=h, nc=10)
    ref = jl.DataLoader(ref_ds, 4, workers=2, **kw)
    one, three = pl.DataLoader(ours_ds, 4, workers=1, **kw), pl.DataLoader(ours_ds, 4, workers=3, **kw)
    if mode == "weights":
        w = np.arange(1, len(ref_ds) + 1, dtype=np.float64)
        ref.sample_weights = one.sample_weights = three.sample_weights = w
    for _ in range(2):  # two epochs: the epoch enters every sample's rng
        r, a, b = batches(ref), batches(one), batches(three)
        assert len(r) == len(a) == len(b) == 2
        for (ir, xr, tr), (ia, xa, ta), (ib, xb, tb) in zip(r, a, b):
            assert ir == ia == ib
            np.testing.assert_array_equal(xa, xb)  # the same bytes at 1 and 3 workers
            for u, v, w_ in zip(tr, ta, tb):
                np.testing.assert_array_equal(v, u)
                np.testing.assert_array_equal(w_, u)
            d = absdiff(xa, xr)
            assert d.max() <= AUG_MAX and d.mean() <= AUG_MEAN


def test_collate_and_pad():
    rng = np.random.default_rng(0)
    samples = [(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                rng.uniform(0, 1, (n, 5)).astype(np.float32)) for n in (0, 3, 7)]
    ref, ours = jl.collate(samples, 5, [0, 1, 2]), pl.collate(samples, 5, [0, 1, 2])
    np.testing.assert_array_equal(ours.images, ref.images)
    for a, b in zip(ours.targets, ref.targets):
        np.testing.assert_array_equal(a, np.asarray(b))
    ri, rt, rv = jl.pad_to_batch(ref.images, ref.targets, 5)
    oi, ot, ov = pl.pad_to_batch(ours.images, ours.targets, 5)
    np.testing.assert_array_equal(oi, ri)
    np.testing.assert_array_equal(ov, rv)
    for a, b in zip(ot, rt):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the process stripe (data-parallel loading): each rank's rows of every
    # batch are the JAX loader's, a short last batch wrap-padded as JAX's
    ds = _Indexed(10)
    for r in range(2):
        ours = pl.DataLoader(ds, 4, max_targets=5, seed=3, drop_last=False, workers=2,
                             process_index=r, process_count=2)
        ref = jl.DataLoader(ds, 4, max_targets=5, seed=3, drop_last=False, workers=2,
                            process_index=r, process_count=2)
        got, want = list(ours), list(ref)
        assert [b.indices for b in got] == [b.indices for b in want]
        assert all(len(b.indices) == 2 for b in got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.images, w.images)
    with pytest.raises(ValueError, match="divisible"):
        pl.DataLoader(ds, 5, process_count=2)


class _Indexed:
    """A dataset whose image i is filled with i and holds one label."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, rng):
        return (np.full((4, 4, 3), i, np.uint8),
                np.array([[i % 3, 0.5, 0.5, 0.1, 0.1]], np.float32))


def test_device_aug():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    gains_in = (0.4, 0.3, 0.5)
    xj, fj = jda.augment_batch(jnp.asarray(img), key, *gains_in, fliplr_p=0.5)
    # JAX's own draws, replayed: the gains and flips it used
    k_hsv, k_flip = jax.random.split(key)
    gains = np.asarray(jax.random.uniform(k_hsv, (3, 3), minval=-1.0, maxval=1.0)) \
        * np.array(gains_in) + 1
    flipped = np.array(jax.random.bernoulli(k_flip, 0.5, (3,)))
    np.testing.assert_array_equal(flipped, np.asarray(fj))
    xp = pda.apply_hsv_flip(torch.from_numpy(img), torch.from_numpy(gains).float(),
                            torch.from_numpy(flipped))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-6, rtol=0)
    box = rng.uniform(0, 1, (3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        pda.flip_targets_lr(torch.from_numpy(box), torch.from_numpy(flipped)).numpy(),
        np.asarray(jda.flip_targets_lr(jnp.asarray(box), jnp.asarray(flipped))))
    x, f = pda.augment_batch(torch.from_numpy(img), torch.Generator().manual_seed(0))
    assert x.shape == (3, 24, 32, 3) and x.dtype == torch.float32 and f.shape == (3,)
    assert 0 <= float(x.min()) and float(x.max()) <= 1


def test_coco_gt_and_tools(root, tmp_path):
    val = str(root / "images" / "val")
    assert port_coco_gt(val, nc=10, names=list("abcdefghij")) == \
        jax_coco_gt(val, nc=10, names=list("abcdefghij"))
    assert port_coco_gt(val, nc=10, single_cls=True) == jax_coco_gt(val, nc=10, single_cls=True)
    for mod, sub in ((jt, "j"), (pt, "p")):
        shutil.copytree(root, tmp_path / sub)
        (tmp_path / sub / "labels" / "train.cache.npz").unlink(missing_ok=True)
        (tmp_path / sub / "labels" / "val.cache.npz").unlink(missing_ok=True)
    for split in ("train", "val"):
        shutil.rmtree(tmp_path / "p" / "images" / split)
        shutil.copytree(tmp_path / "j" / "images" / split, tmp_path / "p" / "images" / split)
    outs = {}
    for mod, sub in ((jt, "j"), (pt, "p")):
        d = tmp_path / sub
        lists = mod.autosplit(d / "images", weights=(0.5, 0.3, 0.2), seed=1)
        texts = [p.read_text() if p.exists() else "" for p in lists]
        yml = d / "data.yaml"
        yml.write_text(f"path: {d}\ntrain: images/train\nval: images/val\nnc: 10\n")
        stats = mod.dataset_stats(yml)
        crops = mod.extract_boxes(d / "images" / "val")
        outs[sub] = (texts, stats, sorted(p.relative_to(crops) for p in crops.rglob("*.jpg")))
    assert outs["p"] == outs["j"]
