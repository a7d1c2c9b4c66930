"""The port's Trainer built from a dataset yaml (dmayolo_tpu_torch/train/
trainer.py, `data=`), on the CPU at f32 with the small flagship-shaped
model at 64 px on a JAX-generated shapes set (8 train, 4 val images).

- Validation fires every epoch (`run_validation` of the EMA model on the
  val split); the CSV carries the metrics columns; `last.npz` is read by
  the JAX `load_checkpoint`: its meta, and the port's EMA trees in f16 as
  the model (a finished run's checkpoint is stripped).
- Fitness, `best.npz` and `EarlyStopping`: with the validation scripted to
  a fitness sequence, `best.npz` holds the best epoch, the run stops where
  the JAX `EarlyStopping` stops on the same sequence (patience 1), and the
  JAX `load_checkpoint` reads `best.npz`.
- One test each for `image_weights` (the loader's weights equal the JAX
  functions'), `multi_scale` (the sizes the step sees follow the seeded
  draw; the device resize within 1 level of cv2's INTER_LINEAR),
  `device_aug` (the host hyp's HSV and flip zeroed, the step augments) and
  `rect` (no accumulation, unshuffled batches); and one each for `quad`,
  `cache_images` ("ram" and "disk"), `single_cls`, `save_period` and
  `val_interval`.
"""
import csv
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dmayolo_tpu.data.synthetic import generate
from dmayolo_tpu.train import optim as jo
from dmayolo_tpu.train.trainer import EarlyStopping as JaxEarlyStopping
from dmayolo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from dmayolo_tpu_torch.eval.validator import ValResult
from dmayolo_tpu_torch.train import trainer as ptr
from dmayolo_tpu_torch.train.step import state_trees
from dmayolo_tpu_torch.train.trainer import Trainer, load_hyp, resize_batch

from test_torch_model import small_cfg

IMG, B = 64, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return str(generate(tmp_path_factory.mktemp("shapes"), n_train=8, n_val=4, img_size=IMG,
                        seed=1))


def make(data_yaml, out, **kw):
    args = dict(epochs=1, batch_size=B, img_size=IMG, adam=True, dtype=torch.float32,
                device="cpu", out_dir=str(out), workers=2)
    args.update(kw)
    return Trainer(small_cfg(), data=data_yaml, hyp=load_hyp("scratch"), **args)


def seen_shapes(tr):
    """Record the images' shape and dtype of every step of `tr`."""
    shapes = []
    get = tr.get_step

    def recording(acc):
        step = get(acc)

        def run(state, images, targets, *a, **k):
            shapes.append((tuple(images.shape), images.dtype))
            return step(state, images, targets, *a, **k)
        return run

    tr.get_step = recording
    return shapes


def test_validates_each_epoch_and_saves(data_yaml, tmp_path, monkeypatch):
    calls = []
    real = ptr.run_validation
    monkeypatch.setattr(ptr, "run_validation", lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    tr = make(data_yaml, tmp_path, epochs=2)
    assert tr.nc == 3 and tr.data["nc"] == 3
    tr.train()
    assert calls == [tr.data["val"]] * 2
    rows = list(csv.DictReader(open(tmp_path / "results.csv")))
    assert len(rows) == 2 and all(r["metrics/mAP_0.5"] != "" for r in rows)
    assert {"metrics/precision", "metrics/recall", "metrics/mAP_0.5:0.95", "fitness"} <= set(rows[0])
    trees, meta = jax_load_checkpoint(tmp_path / "last")
    assert set(trees) == {"params", "stats"}  # stripped: the EMA as the model
    assert meta["epoch"] == 1 and meta["nc"] == 3
    want = state_trees(tr.state)
    for tree in ("params", "stats"):
        for k, v in want["ema_" + tree].items():
            np.testing.assert_array_equal(np.asarray(trees[tree][k], np.float32),
                                          v.astype(np.float16).astype(np.float32))


def test_best_and_early_stopping(data_yaml, tmp_path, monkeypatch):
    seq = [0.2, 0.5, 0.4, 0.45, 0.6, 0.7]
    stopper, stop_at = JaxEarlyStopping(1), None
    for e, fi in enumerate(seq):
        if stopper(e, fi):
            stop_at = e
            break
    assert stop_at == 2
    it = iter(seq)
    monkeypatch.setattr(Trainer, "validate", lambda self: ValResult(map50=0.0, map=next(it) / 0.9,
                                                                    maps=np.zeros(3)))
    tr = make(data_yaml, tmp_path, epochs=len(seq), patience=1)
    tr.train()
    rows = list(csv.DictReader(open(tmp_path / "results.csv")))
    assert [int(r["epoch"]) for r in rows] == list(range(stop_at))  # JAX: no row on the stop epoch
    np.testing.assert_allclose([float(r["fitness"]) for r in rows], seq[:stop_at], rtol=1e-12)
    _, best = jax_load_checkpoint(tmp_path / "best")
    _, last = jax_load_checkpoint(tmp_path / "last")
    assert best["epoch"] == 1 and best["best_fitness"] == pytest.approx(0.5, rel=1e-12)
    assert last["epoch"] == stop_at and tr.best_fitness == pytest.approx(0.5, rel=1e-12)


def test_image_weights(data_yaml, tmp_path, monkeypatch):
    monkeypatch.setattr(Trainer, "validate",
                        lambda self: ValResult(maps=np.array([0.1, 0.7, 0.3])))
    tr = make(data_yaml, tmp_path, epochs=2, image_weights=True)
    tr.train()
    labels = tr.train_ds.labels
    cw = jo.labels_to_class_weights(labels, 3)
    np.testing.assert_allclose(tr.class_weights, cw, rtol=1e-6)
    want = jo.labels_to_image_weights(labels, 3, cw * (1 - np.array([0.1, 0.7, 0.3])) ** 2 / 3)
    np.testing.assert_allclose(tr.loader.sample_weights, want, rtol=1e-6)


def test_multi_scale(data_yaml, tmp_path):
    tr = make(data_yaml, tmp_path, multi_scale=True, noval=True, nosave=True, accumulate=1)
    shapes = seen_shapes(tr)
    tr.train()
    import random
    rng = random.Random(tr.seed + 0)
    sizes = [int(round(IMG * rng.choice(ptr.MULTI_SCALES) / 32) * 32) for _ in shapes]
    assert [s[0][1:3] for s in shapes] == [(z, z) for z in sizes]
    x = np.random.default_rng(0).integers(0, 256, (2, 48, 40, 3), dtype=np.uint8)
    got = resize_batch(torch.from_numpy(x), 32).numpy()
    for i in range(2):
        want = cv2.resize(x[i], (32, 32), interpolation=cv2.INTER_LINEAR)
        assert np.abs(got[i].astype(int) - want).max() <= 1


def test_device_aug(data_yaml, tmp_path):
    tr = make(data_yaml, tmp_path, device_aug=True, noval=True)
    h = load_hyp("scratch")
    assert tr.device_aug == {"hgain": h["hsv_h"], "sgain": h["hsv_s"], "vgain": h["hsv_v"],
                             "fliplr": h["fliplr"]}
    assert all(tr.train_ds.hyp[k] == 0.0 for k in ("hsv_h", "hsv_s", "hsv_v", "fliplr"))
    shapes = seen_shapes(tr)
    tr.train()
    state = tr.state
    assert shapes and all(dt == torch.uint8 for _, dt in shapes)  # augmented inside the step
    assert state.step > 0


def test_rect(data_yaml, tmp_path):
    tr = make(data_yaml, tmp_path, rect=True, noval=True, nosave=True)
    assert tr.accumulate == 1 and not tr.loader.shuffle and not tr.train_ds.mosaic
    shapes = seen_shapes(tr)
    tr.train()
    want = [tuple(tr.train_ds.batch_shapes[j]) for j in range(len(tr.loader))]
    assert [s[0][1:3] for s in shapes] == want


@pytest.mark.parametrize("option", ["quad", "cache_ram", "cache_disk", "single_cls",
                                    "save_period", "val_interval"])
def test_options(data_yaml, tmp_path, monkeypatch, option):
    """Each of the remaining data options, set alone, does what it says."""
    epochs = {"save_period": 2, "val_interval": 3}.get(option, 1)
    kw = {"quad": dict(quad=True), "cache_ram": dict(cache_images="ram"),
          "cache_disk": dict(cache_images="disk"), "single_cls": dict(single_cls=True),
          "save_period": dict(save_period=1), "val_interval": dict(val_interval=2)}[option]
    validated = []
    monkeypatch.setattr(Trainer, "validate", lambda self: validated.append(1) or ValResult(
        maps=np.zeros(self.nc)))
    tr = make(data_yaml, tmp_path / "run", epochs=epochs, **kw)
    shapes = seen_shapes(tr)
    tr.train()
    if option == "quad":  # every item at twice the size: one image upscaled or four tiled
        assert tr.loader.quad and all(s[0][1:3] == (2 * IMG, 2 * IMG) for s in shapes)
    elif option == "cache_ram":
        assert tr.train_ds.cache_images and len(tr.train_ds._im_cache) == len(tr.train_ds)
    elif option == "cache_disk":  # the resized images beside the originals
        images = Path(tr.train_ds.im_files[0]).parent
        assert len(list(images.glob(f"*.{IMG}.npy"))) == len(tr.train_ds)
        for f in images.glob("*.npy"):
            f.unlink()  # the module's dataset stays as it was
    elif option == "single_cls":
        assert tr.nc == 1 and all((lb[:, 0] == 0).all() for lb in tr.train_ds.labels if len(lb))
    elif option == "save_period":
        assert {p.name for p in (tmp_path / "run").glob("epoch*.npz")} == {"epoch0.npz",
                                                                          "epoch1.npz"}
    # every epoch validates; with val_interval 2, epochs 1 and 2 of 0-2
    # (the interval's and the final one)
    assert len(validated) == (2 if option == "val_interval" else epochs)
    with pytest.raises(ValueError, match="need the dataset"):  # not with in-memory batches
        Trainer(small_cfg(), [], load_hyp("scratch"), nc=3, device="cpu",
                out_dir=str(tmp_path / "mem"), **({} if option in ("save_period", "val_interval")
                                                  else kw), image_weights=True)
