"""The training extras (callbacks, loggers, plots, async checkpoints)
against the JAX package, on the CPU.

* The hooks a short data-built `Trainer` run fires, in order and with
  their rows, equal the JAX trainer's (JAX's step stubbed: the order is
  the trainer's, not the step's; validation scripted on both, at
  `val_interval` 2 so the CSV header widens).
* `Loggers`: `results.csv` equal to JAX's byte for byte for the same rows,
  the widened header rewritten; TensorBoard scalars where it imports.
* Every plot writes its PNG here; the module imports, and `Loggers`
  finalizes, without matplotlib (the card's machine has none).
* `ckpt_async`: the checkpoints equal the synchronous run's array for
  array, the JAX trainer resumes from them, and `cli.train --ckpt-async`
  runs.
"""
import builtins
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmayolo_tpu.eval.validator import ValResult as JaxValResult
from dmayolo_tpu.train.trainer import Trainer as JaxTrainer
from dmayolo_tpu.utils import callbacks as jcallbacks
from dmayolo_tpu.utils import loggers as jloggers
from dmayolo_tpu_torch.cli import train as ptrain
from dmayolo_tpu_torch.data.loader import Batch
from dmayolo_tpu_torch.data.synthetic import generate
from dmayolo_tpu_torch.eval.validator import ValResult
from dmayolo_tpu_torch.train.step import state_trees
from dmayolo_tpu_torch.train.trainer import Trainer
from dmayolo_tpu_torch.utils import callbacks as pcallbacks
from dmayolo_tpu_torch.utils import loggers as ploggers
from dmayolo_tpu_torch.utils import plots
from dmayolo_tpu_torch.utils.async_ckpt import AsyncTrainCheckpointer
from dmayolo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tests.test_e2e_train import HYP, TINY_CFG

IMG, BS = 64, 8  # BS: the JAX trainer shards the batch over the 8 host devices
FITNESS = [0.2, 0.5, 0.4]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    root = tmp_path_factory.mktemp("extras")
    return root, generate(root / "data", n_train=16, n_val=8, img_size=IMG, seed=1)


def _record(cb, log):
    for hook in cb.get_registered_actions():
        cb.register_action(hook, "log", lambda *a, hook=hook, **k: log.append((hook, a)))


def _scripted(result_type):
    it = iter(FITNESS)
    return lambda self, use_ema=True: result_type(map50=0.0, map=next(it) / 0.9,
                                                  maps=np.zeros(self.nc))


KW = dict(epochs=3, batch_size=BS, img_size=IMG, workers=1, max_targets=16, val_interval=2,
          seed=0, accumulate=1)


def test_hooks_and_rows_as_jax(shapes, monkeypatch):
    root, data = shapes
    assert pcallbacks.HOOKS == jcallbacks.HOOKS
    monkeypatch.setattr(Trainer, "validate", _scripted(ValResult))
    tr = Trainer(TINY_CFG, data=str(data), hyp=HYP, out_dir=str(root / "port"),
                 dtype=torch.float32, device="cpu", **KW)
    plog = []
    _record(tr.callbacks, plog)
    tr.train()
    keys = [k[len("train/"):] for k in plog[-2][1][0] if k.startswith("train/")]

    monkeypatch.setattr(JaxTrainer, "validate", _scripted(JaxValResult))
    jt = JaxTrainer(TINY_CFG, str(data), HYP, out_dir=str(root / "jax"), dtype=jnp.float32,
                    warmup_min_iters=1, **KW)
    # the JAX step stubbed with the port step's metric keys: this test is
    # about the trainer around the step
    jt.jstep = lambda state, *a: (state, {k: jnp.float32(1.0) for k in keys})
    jlog = []
    _record(jt.callbacks, jlog)
    jt.train()

    assert [h for h, _ in plog] == [h for h, _ in jlog]
    assert [h for h, _ in plog] == ["on_train_start"] + [
        "on_train_epoch_start", "on_model_save", "on_fit_epoch_end"] * 3 + ["on_train_end"]
    for (h, pa), (_, ja) in zip(plog, jlog):
        if h == "on_fit_epoch_end":
            assert list(pa[0]) == list(ja[0]) and pa[1] == ja[1]
    prow, jrow = ((root / d / "results.csv").read_text().splitlines() for d in ("port", "jax"))
    assert prow[0] == jrow[0] and prow[0].endswith("time_s,metrics/precision,metrics/recall,"
                                                   "metrics/mAP_0.5,metrics/mAP_0.5:0.95,fitness")
    assert [r.split(",")[0] for r in prow[1:]] == ["0", "1", "2"]
    assert [r.count(",") for r in prow] == [r.count(",") for r in jrow]
    assert (root / "port" / "results.png").exists() and (root / "port" / "labels.png").exists()


ROWS = [{"train/box": 0.1, "train/obj": 0.2, "time_s": 1.5},
        {"train/box": 0.09, "train/obj": 0.19, "time_s": 1.4, "metrics/mAP_0.5": 0.3,
         "fitness": 0.25},
        {"train/box": 0.08, "train/obj": 0.18, "time_s": 1.3},
        {"train/box": 0.07, "time_s": 1.2, "x/lr0": 0.01}]


def test_results_csv_as_jax(tmp_path):
    texts = []
    for mod, d in ((jloggers, "jax"), (ploggers, "port")):
        lg = mod.Loggers(tmp_path / d, use_tb=False)
        headers = []
        for step, row in enumerate(ROWS):
            lg.log_metrics(dict(row), step)
            headers.append((tmp_path / d / "results.csv").read_text().splitlines()[0])
        lg.close()
        texts.append(((tmp_path / d / "results.csv").read_text(), headers))
        assert not (tmp_path / d / "results.csv.tmp").exists()
    assert texts[0] == texts[1]
    assert ploggers.KEYS == jloggers.KEYS
    headers = texts[1][1]
    assert headers[0] == "epoch,train/box,train/obj,time_s"
    assert headers[1] == headers[2] == headers[0] + ",metrics/mAP_0.5,fitness"
    assert headers[3] == headers[1] + ",x/lr0"


def test_tensorboard_scalars(tmp_path):
    pytest.importorskip("tensorboard")
    lg = ploggers.Loggers(tmp_path)
    assert lg.tb is not None
    lg.log_metrics(dict(ROWS[0]), 0)
    lg.log_image("batch", np.zeros((8, 8, 3), np.uint8))
    lg.finalize()
    assert list(tmp_path.glob("events.out.tfevents.*"))
    assert (tmp_path / "results.png").exists()


@pytest.fixture
def curves():
    rng = np.random.default_rng(0)
    px = np.linspace(0, 1, 101)
    py = np.sort(rng.uniform(0, 1, (101, 3)), 0)[::-1]
    return px, py, rng.uniform(0, 1, (3, 10))


def test_each_plot_writes_its_png(tmp_path, curves):
    pytest.importorskip("matplotlib")
    px, py, ap = curves
    names = ["a", "b", "c"]
    plots.plot_pr_curve(px, py, ap, tmp_path / "pr.png", names)
    plots.plot_mc_curve(px, py.T, tmp_path / "f1.png", names, ylabel="F1")
    plots.plot_confusion_matrix(np.random.default_rng(1).integers(0, 9, (4, 4)).astype(float), 3,
                                names, tmp_path / "confusion.png")
    labels = np.concatenate([np.random.default_rng(2).integers(0, 3, (40, 1)),
                             np.random.default_rng(3).uniform(0.1, 0.9, (40, 4))], 1)
    plots.plot_labels(labels, names, tmp_path)
    lg = ploggers.Loggers(tmp_path / "run", use_tb=False)
    for step, row in enumerate(ROWS):
        lg.log_metrics(dict(row), step)
    plots.plot_results(tmp_path / "run" / "results.csv")
    (tmp_path / "evolve.csv").write_text("fitness,lr0,momentum\n0.1,0.01,0.9\n0.3,0.02,0.93\n")
    assert plots.plot_evolve(tmp_path / "evolve.csv") == tmp_path / "evolve.png"
    f = plots.feature_visualization(np.zeros((1, 4, 4, 3), np.float32), "Conv", 0,
                                    save_dir=tmp_path)
    pngs = ["pr.png", "f1.png", "confusion.png", "labels.png", "run/results.png", "evolve.png",
            f.name]
    for name in pngs:
        assert (tmp_path / name).stat().st_size > 1000, name


def test_image_grid_draws_boxes(tmp_path):
    from dmayolo_tpu_torch.data.imageio import imread

    images = [np.full((32, 48, 3), 100, np.uint8) for _ in range(3)]
    targets = [np.array([[0, 0.5, 0.5, 0.5, 0.5]]), np.zeros((0, 5)),
               np.array([[1, 0.25, 0.5, 0.25, 0.25]])]
    plots.plot_image_grid(images, targets, ["x", "y"], tmp_path / "grid.png")
    grid = imread(tmp_path / "grid.png")[..., ::-1]  # RGB
    assert grid.shape == (64, 96, 3)
    assert (grid[8, 12:36] == (255, 60, 60)).all()  # the first image's box top edge
    assert (grid[16, 48:] == 100).all()  # the second image, top right: no box
    assert (grid[32 + 12, 6:18] == (255, 60, 60)).all()  # the third's box, bottom left
    assert (grid[32:, 48:] == 255).all()  # the empty cell


def test_plots_module_and_loggers_without_matplotlib(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    importlib.reload(plots)
    with pytest.raises(RuntimeError, match="matplotlib"):
        plots.plot_labels(np.zeros((1, 5)), (), tmp_path)
    lg = ploggers.Loggers(tmp_path, use_tb=False)
    lg.log_metrics(dict(ROWS[0]), 0)
    lg.finalize()  # no plot, no error: the JAX guard
    assert (tmp_path / "results.csv").exists() and not (tmp_path / "results.png").exists()


# ---------------------------------------------------------------------------
# async checkpoints
# ---------------------------------------------------------------------------

def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cls = rng.integers(0, 3, (BS, 4)).astype(np.float32)
        box = np.concatenate([rng.uniform(0.2, 0.8, (BS, 4, 2)),
                              rng.uniform(0.1, 0.4, (BS, 4, 2))], -1).astype(np.float32)
        out.append(Batch(rng.integers(0, 256, (BS, IMG, IMG, 3), dtype=np.uint8),
                         (cls, box, np.ones((BS, 4), bool))))
    return out


def _run(tmp_path, name, ckpt_async):
    tr = Trainer(TINY_CFG, _batches(), hyp=HYP, nc=3, epochs=2, batch_size=BS, img_size=IMG,
                 out_dir=str(tmp_path / name), dtype=torch.float32, device="cpu", seed=0,
                 accumulate=1, save_period=1, ckpt_async=ckpt_async)
    tr.train()
    return tmp_path / name


def _same_checkpoint(a, b):
    (ta, ma), (tb, mb) = load_checkpoint(a), load_checkpoint(b)
    assert set(ta) == set(tb)
    for tree in ta:
        assert set(ta[tree]) == set(tb[tree])
        for k in ta[tree]:
            np.testing.assert_array_equal(ta[tree][k], tb[tree][k])
    ma.pop("date"), mb.pop("date")
    assert ma == mb


def test_async_checkpoints_equal_sync_and_jax_resumes(tmp_path, shapes):
    sync, asyn = _run(tmp_path, "sync", False), _run(tmp_path, "async", True)
    for name in ("epoch0.npz", "epoch1.npz", "last.npz"):
        _same_checkpoint(sync / name, asyn / name)
    assert not list(asyn.glob("*.tmp.npz"))
    trees, meta = load_checkpoint(asyn / "epoch0.npz")
    assert set(trees) == {"params", "stats", "ema_params", "ema_stats", "opt_mom", "opt_vel"}
    _, data = shapes
    jt = JaxTrainer(TINY_CFG, str(data), HYP, epochs=2, batch_size=BS, img_size=IMG,
                    out_dir=str(tmp_path / "jax"), dtype=jnp.float32, workers=1,
                    resume_from=str(asyn / "epoch0.npz"))
    assert jt.start_epoch == 1 and int(jt.state.opt.step) == meta["step"] == 3
    for k, v in trees["ema_params"].items():
        np.testing.assert_array_equal(np.asarray(jt.state.ema_params[k], np.float32), v)


def test_async_save_is_untouched_by_later_steps(tmp_path):
    # the trees are handed over uncopied: `state_trees` must give arrays of
    # their own, also on the CPU, where a tensor's numpy view is its memory
    tr = Trainer(TINY_CFG, _batches(1), hyp=HYP, nc=3, epochs=1, batch_size=BS, img_size=IMG,
                 out_dir=str(tmp_path / "run"), dtype=torch.float32, device="cpu", seed=0)
    trees = state_trees(tr.state)
    before = {name: {k: v.copy() for k, v in tree.items()} for name, tree in trees.items()}
    save_checkpoint(tmp_path / "want", half=True, **before)
    ck = AsyncTrainCheckpointer()
    ck.save(tmp_path / "got", trees)
    with torch.no_grad():
        for t in [*tr.state.model.state_dict().values(), *tr.state.ema.state_dict().values()]:
            if t.is_floating_point():
                t.add_(1)
    ck.close()
    _same_checkpoint(tmp_path / "want.npz", tmp_path / "got.npz")


def test_async_write_error_surfaces(tmp_path):
    ck = AsyncTrainCheckpointer()
    (tmp_path / "block").write_text("a file where a directory should be")
    ck.save(tmp_path / "block" / "x", {"params": {("a",): np.zeros(2, np.float32)},
                                       "stats": {}})
    with pytest.raises(OSError):
        ck.close()
    ck.close()  # raised once


def test_cli_train_ckpt_async(shapes):
    root, data = shapes
    cfg = root / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_CFG))
    argv = ["--cfg", str(cfg), "--data", str(data), "--epochs", "1", "--batch-size", str(BS),
            "--imgsz", str(IMG), "--project", str(root / "runs"), "--exist-ok", "--workers", "1",
            "--noautoanchor", "--fp32", "--device", "cpu"]
    for name, flags in (("sync", []), ("async", ["--ckpt-async"])):
        ptrain.main(argv + ["--name", name, *flags])
    _same_checkpoint(root / "runs" / "sync" / "last.npz", root / "runs" / "async" / "last.npz")
    assert yaml.safe_load((root / "runs" / "async" / "opt.yaml").read_text())["ckpt_async"]
