"""The port's CLI core (dmayolo_tpu_torch/cli/, utils/torch_import.py,
utils/model_info.py, train/autobatch.py, train/evolve.py) against the JAX
package's, on the CPU at f32.

- One JAX and one port `cli.train.main` run on the same tiny flagship-
  shaped model and shapes set (8 images at 64 px, bs 8, one optimizer step
  an epoch, `--freeze 3 --save-period 1 --patience 1`), each with its
  validation scripted to the fitness sequence 0.2, 0.5, 0.4: the return
  value (F1: the best fitness, 0.5), the CSV rows and the checkpoints on
  the stop epoch (F2: `last` saved, no row, no `epoch2.npz`), the
  `opt.yaml` keys, and the frozen layers are JAX's; the port resumes the
  JAX run from its `epoch1.npz` and continues its step count.
- F3: a BaseException raised in one request's preprocessing reaches that
  request only, and one raised in the device batch reaches that batch
  only, in both packages' MicroBatcher; the next request is served.
- `check_img_size`, `increment_path` and `resolve_config` (a meta `cfg`
  path that does not exist resolves by name) give JAX's values; the
  hyp, data and anchors yamls are byte-identical copies.
- `load_model_from_checkpoint` on a JAX-written `.npz` (evolved anchors,
  a cfg path that does not exist) and on a reference-layout `.pt` (f16,
  stub classes, EMA first, anchors x1.3): both packages load each file,
  their raw heads agree within 1e-4 and their anchors exactly.
- `describe()` lines and `param_count` equal JAX's; GFLOPs: the gap is
  stated in `test_flops_gap`.
- `cli.val.main` against JAX's on one checkpoint and a pseudo-labelled
  set: P, R, mAP@.5, mAP@.5:.95 within 1e-6, the `--save-txt` files, the
  `study.csv` rows; the options that are not ported raise, naming their
  item.
- `param_groups(train_ungrouped=True)`, the `linear_lr` schedule, the
  fixed cadence of `accum_ramp=False`: JAX's labels and values.
- `autobatch` makes JAX's decisions on the fake memory curves of
  tests/test_autobatch.py; `--batch-size -1` on the CPU gives the default.
- `evolve`: JAX's `evolve.csv` and `hyp_evolve.yaml` from one stub
  `train_fn` and seed.
"""
import csv
import random
import shutil
import sys
import types
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
import yaml

import dmayolo_tpu.cli.common as jcommon
import dmayolo_tpu.cli.train as jtrain
import dmayolo_tpu.cli.val as jval
import dmayolo_tpu.serve.batcher as jbatcher
from dmayolo_tpu.data.synthetic import generate, generate_visdrone_analog
from dmayolo_tpu.eval.validator import ValResult as JaxValResult
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.train import autobatch as jab
from dmayolo_tpu.train import evolve as jevolve
from dmayolo_tpu.train import optim as jo
from dmayolo_tpu.train.trainer import Trainer as JaxTrainer
from dmayolo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from dmayolo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dmayolo_tpu.utils.model_info import flops as jax_flops
from dmayolo_tpu.utils.model_info import param_count as jax_param_count
from dmayolo_tpu_torch.cli import common as pcommon
from dmayolo_tpu_torch.cli import model as pmodel_cli
from dmayolo_tpu_torch.cli import train as ptrain
from dmayolo_tpu_torch.cli import val as pval
from dmayolo_tpu_torch.eval.validator import ValResult
from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.graph.model import load_model, model_config
from dmayolo_tpu_torch.nn.primitives import Conv2d
from dmayolo_tpu_torch.serve import batcher as pbatcher
from dmayolo_tpu_torch.train import autobatch as pab
from dmayolo_tpu_torch.train import evolve as pevolve
from dmayolo_tpu_torch.train import optim as po
from dmayolo_tpu_torch.train.loss import Targets
from dmayolo_tpu_torch.train.trainer import Trainer
from dmayolo_tpu_torch.utils.model_info import flops as port_flops
from dmayolo_tpu_torch.utils.model_info import param_count as port_param_count
from dmayolo_tpu_torch.utils.weights import jax_paths, state_dict_from_jax, to_jax_layout

from test_torch_data_eval import SIZE as VAL_SIZE
from test_torch_data_eval import pseudo_label
from test_torch_model import random_vars, small_cfg

ROOT = Path(__file__).resolve().parents[1]
IMG, BS = 64, 8  # BS: the JAX Trainer shards the batch over the 8 CPU devices
FITNESS = [0.2, 0.5, 0.4]  # patience 1: JAX's EarlyStopping stops at epoch 2
STOP = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(nc=3):
    cfg = small_cfg()
    cfg["nc"] = nc
    return cfg


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    """The shapes set (nc 3) and the tiny model's yaml on disk."""
    root = tmp_path_factory.mktemp("shapes")
    data = generate(str(root / "data"), n_train=8, n_val=4, img_size=IMG, seed=1)
    cfg = root / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(tiny_cfg()))
    return root, str(data), str(cfg)


def train_argv(shapes, name):
    root, data, cfg = shapes
    return ["--cfg", cfg, "--data", data, "--epochs", "5", "--batch-size", str(BS),
            "--imgsz", str(IMG), "--project", str(root / "runs"), "--name", name,
            "--exist-ok", "--workers", "1", "--noautoanchor", "--fp32", "--patience", "1",
            "--save-period", "1", "--freeze", "3"]


def scripted(result_type):
    it = iter(FITNESS)
    return lambda self, use_ema=True: result_type(map50=0.0, map=next(it) / 0.9,
                                                  maps=np.zeros(self.nc))


@pytest.fixture(scope="module")
def runs(shapes):
    """One JAX and one port CLI training run, validation scripted."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTrainer, "validate", scripted(JaxValResult))
        out["jax"] = jtrain.main(train_argv(shapes, "jax"))
        mp.setattr(Trainer, "validate", scripted(ValResult))
        out["port"] = ptrain.main(train_argv(shapes, "port") + ["--device", "cpu"])
    return {k: (v, shapes[0] / "runs" / k) for k, v in out.items()}


def csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_f1_train_returns_best_fitness_as_jax(runs):
    (j, _), (p, _) = runs["jax"], runs["port"]
    assert isinstance(p, float) and p == j == pytest.approx(FITNESS[1], rel=1e-12)


def test_f2_stop_epoch_as_jax(runs):
    (_, jdir), (_, pdir) = runs["jax"], runs["port"]
    jrows, prows = csv_rows(jdir / "results.csv"), csv_rows(pdir / "results.csv")
    assert [int(r["epoch"]) for r in prows] == [int(r["epoch"]) for r in jrows] \
        == list(range(STOP))
    np.testing.assert_allclose([float(r["fitness"]) for r in prows],
                               [float(r["fitness"]) for r in jrows], rtol=1e-12)
    names = {p.name for p in pdir.glob("*.npz")}
    assert names == {p.name for p in jdir.glob("*.npz")} \
        == {"epoch0.npz", "epoch1.npz", "last.npz", "best.npz"}
    for name, epoch in (("last", STOP), ("best", 1)):
        _, jm = jax_load_checkpoint(jdir / name)
        _, pm = jax_load_checkpoint(pdir / name)
        assert jm["epoch"] == pm["epoch"] == epoch
        assert pm["best_fitness"] == jm["best_fitness"]


def test_opt_yaml_keys_are_jax(runs):
    (_, jdir), (_, pdir) = runs["jax"], runs["port"]
    jopt = yaml.safe_load((jdir / "opt.yaml").read_text())
    popt = yaml.safe_load((pdir / "opt.yaml").read_text())
    assert list(popt) == list(jopt)
    differ = {k for k in jopt if popt[k] != jopt[k]}
    assert differ == {"name"}
    assert yaml.safe_load((pdir / "hyp.yaml").read_text()) == \
        yaml.safe_load((jdir / "hyp.yaml").read_text())


def test_freeze_keeps_the_same_layers_as_jax(runs, shapes):
    """`--freeze 3`: model.0-2's parameters in epoch1.npz are the init's
    (f16) in both packages, and they alone have no momentum."""
    (_, jdir), (_, pdir) = runs["jax"], runs["port"]
    jm = JaxModel(shapes[2], nc=3)
    jinit, _ = jm.init_with_priors(jax.random.PRNGKey(0))
    pm = DetectionModel(shapes[2], nc=3, device="cpu").init_with_priors(
        torch.Generator().manual_seed(0))
    sd = pm.state_dict()
    pinit = {path: to_jax_layout(path, sd[key]) for key, (tree, path) in jax_paths(pm).items()
             if tree == "params"}
    for d, init in ((jdir, {k: np.asarray(v) for k, v in jinit.items()}), (pdir, pinit)):
        trees, _ = jax_load_checkpoint(d / "epoch1")  # the model in f16, not the EMA
        frozen = {k for k in trees["params"] if int(k[1]) < 3}
        assert frozen and all(
            np.array_equal(trees["params"][k], init[k].astype(np.float16).astype(np.float32))
            for k in frozen), d.name
        # SGD's momentum (f32) is the only trace a warmup step leaves on
        # most weights: zero exactly where the layers are frozen
        assert {k for k, v in trees["opt_mom"].items() if not np.any(v)} == frozen, d.name


def test_resume_a_jax_run(runs, tmp_path, monkeypatch):
    """`--resume` on the JAX run's `epoch1.npz`: the port restores the
    run's opt.yaml and hyp.yaml, goes on at epoch 2 and continues JAX's
    optimizer step count, appending to its CSV."""
    _, jdir = runs["jax"]
    run = tmp_path / "jax"
    shutil.copytree(jdir, run)
    _, meta = jax_load_checkpoint(run / "epoch1")
    monkeypatch.setattr(Trainer, "validate", lambda self, use_ema=True: ValResult(
        maps=np.zeros(self.nc)))
    best = ptrain.main(["--resume", str(run / "epoch1.npz"), "--device", "cpu"])
    assert best == pytest.approx(FITNESS[1], rel=1e-12)  # the run's best, from its meta
    trees, last = jax_load_checkpoint(run / "last")
    assert last["epoch"] == 4 and "opt_mom" not in trees  # finished: stripped
    epochs = [int(r["epoch"]) for r in csv_rows(run / "results.csv")]
    assert epochs == [0, 1, 2, 3, 4]
    _, e4 = jax_load_checkpoint(run / "epoch4")
    assert e4["step"] == meta["step"] + 3 and e4["updates"] == meta["updates"] + 3


# ---------------------------------------------------------------------------
# F3: MicroBatcher forwards any exception to its waiters and keeps serving
# ---------------------------------------------------------------------------

class Boom(BaseException):
    """Not an Exception: the dispatcher must still forward it."""


BAD_SHAPE = (13, 17, 3)


def batchers():
    cfg = tiny_cfg()
    jm = JaxModel(cfg)
    params, stats = jm.init_with_priors(jax.random.PRNGKey(0))
    jb = jbatcher.MicroBatcher(jm, params, stats, imgsz=IMG, max_batch=2, max_wait_ms=100.0,
                               dtype=jnp.float32)
    pm = DetectionModel(cfg, device="cpu").init_with_priors(torch.Generator().manual_seed(0))
    pb = pbatcher.MicroBatcher(pm, imgsz=IMG, max_batch=2, max_wait_ms=100.0,
                               dtype=torch.float32, device="cpu")
    return (jbatcher, jb), (pbatcher, pb)


def test_f3_base_exception_reaches_only_its_request(monkeypatch):
    rng = np.random.default_rng(0)
    good = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    bad = rng.integers(0, 256, BAD_SHAPE, dtype=np.uint8)
    for mod, b in batchers():
        real = mod.letterbox

        def failing(img, *a, real=real, **k):
            if img.shape == BAD_SHAPE:
                raise Boom("preprocessing")
            return real(img, *a, **k)

        monkeypatch.setattr(mod, "letterbox", failing)
        try:
            reqs = [b.submit(good), b.submit(bad)]
            assert reqs[0].result(timeout=120).shape[1] == 6
            with pytest.raises(Boom, match="preprocessing"):
                reqs[1].result(timeout=120)
            # an error in the device batch reaches that batch's waiters
            serve, calls = b._serve, []

            def once(*a, **k):
                calls.append(1)
                if len(calls) == 1:
                    raise Boom("device batch")
                return serve(*a, **k)

            b._serve = once
            with pytest.raises(Boom, match="device batch"):
                b(good, timeout=120)
            assert b(good, timeout=120).shape[1] == 6  # and the next is served
            assert b._thread.is_alive()
        finally:
            b.close()
        assert not b._thread.is_alive()


# ---------------------------------------------------------------------------
# common helpers and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("imgsz,s,floor", [(1996, 32, 0), (640, 32, 0), (100, 64, 0),
                                           (64, 32, 128), (1537, 32, 64)])
def test_check_img_size_as_jax(imgsz, s, floor, capsys):
    assert pcommon.check_img_size(imgsz, s, floor) == jcommon.check_img_size(imgsz, s, floor)
    out = capsys.readouterr().out.splitlines()
    assert len(out) in (0, 2) and (not out or out[0] == out[1])


def test_increment_path_as_jax(tmp_path):
    run = tmp_path / "exp"
    for _ in range(3):
        p, j = pcommon.increment_path(run), jcommon.increment_path(run)
        assert p == j
        p.mkdir()
    assert pcommon.increment_path(run, exist_ok=True) == run
    assert pcommon.increment_path(tmp_path / "r", sep="_") == tmp_path / "r"


@pytest.mark.parametrize("name,kind", [
    ("yolov5s", "models"), ("CASPD_ODRTA.yaml", "models"), ("visdrone", "hyp"),
    ("scratch-low.yaml", "hyp"), ("VisDrone.yaml", "data"),
    # a JAX checkpoint's meta `cfg`: a path into the JAX package elsewhere
    ("/nowhere/dmayolo_tpu/configs/models/ablation-ca-scconv-sppfcspc.yaml", "models")])
def test_resolve_config_as_jax(name, kind):
    p, j = pcommon.resolve_config(name, kind), jcommon.resolve_config(name, kind)
    assert p == ROOT / "dmayolo_tpu_torch" / "configs" / kind / j.name
    assert p.read_bytes() == j.read_bytes()


def test_resolve_config_existing_path_and_missing(shapes):
    cfg = shapes[2]
    assert pcommon.resolve_config(cfg, "models") == jcommon.resolve_config(cfg, "models")
    for mod in (pcommon, jcommon):
        with pytest.raises(FileNotFoundError):
            mod.resolve_config("no-such-model", "models")


CONFIG_COPIES = sorted(str(p.relative_to(ROOT / "dmayolo_tpu" / "configs"))
                       for p in (ROOT / "dmayolo_tpu" / "configs").rglob("*.yaml")
                       if p.parent.name != "models")


@pytest.mark.parametrize("rel", CONFIG_COPIES)
def test_configs_are_byte_copies(rel):
    ours = ROOT / "dmayolo_tpu_torch" / "configs" / rel
    assert ours.read_bytes() == (ROOT / "dmayolo_tpu" / "configs" / rel).read_bytes()


def test_load_hyp_as_jax():
    assert pcommon.load_hyp("visdrone") == jcommon.load_hyp("visdrone")
    assert pcommon.load_hyp("finetune.yaml") == jcommon.load_hyp("finetune.yaml")


# ---------------------------------------------------------------------------
# checkpoints: JAX .npz and the reference's .pt
# ---------------------------------------------------------------------------

NPZ_CFG = "/nowhere/dmayolo_tpu/configs/models/yolov5n.yaml"  # JAX's meta path, moved


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """A JAX-written checkpoint of yolov5n (nc 10): seeded numpy weights,
    evolved anchors in its meta, its `cfg` a path that does not exist."""
    jm = JaxModel(jcommon.resolve_config(NPZ_CFG, "models"), nc=10)
    params, stats = random_vars(jm, seed=5)
    anchors = np.asarray(jm.head.anchors, np.float32) * np.float32(1.1)
    path = tmp_path_factory.mktemp("npz") / "evolved.npz"
    jax_save_checkpoint(path, params=params, stats=stats, ema_params=params, ema_stats=stats,
                        meta={"cfg": NPZ_CFG, "nc": 10, "anchors": anchors.tolist()})
    return path, anchors


def heads_agree(jm, params, stats, pm, tol=1e-4):
    x = np.random.default_rng(9).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = jm.apply(params, stats, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
    np.testing.assert_array_equal(np.asarray(pm.head.anchors), np.asarray(jm.head.anchors))


def test_load_npz_as_jax(npz):
    path, anchors = npz
    jm, params, stats = jcommon.load_model_from_checkpoint(str(path))
    pm = pcommon.load_model_from_checkpoint(str(path), device="cpu")
    assert not pm.training and pm.nc == jm.nc == 10
    np.testing.assert_array_equal(pm.head.anchors, anchors)
    heads_agree(jm, params, stats, pm)


def reference_pt(pm, path, anchor_scale=1.3):
    """Write `pm`'s weights as the reference's training checkpoint: {'model':
    module, 'ema': module}, f16, of classes that cannot be imported when
    the file is read, with the model's `yaml`, BN `num_batches_tracked`,
    and Detect's `anchors` (stride units, x `anchor_scale`) and
    `anchor_grid` buffers; 'model' holds other weights, so a reader that
    takes it over the EMA shows."""
    mod = types.ModuleType("reference_models_stub")
    exec("import torch.nn as nn\n"
         "class Model(nn.Module):\n    pass\n"
         "class Layer(nn.Module):\n    pass\n", mod.__dict__)
    sys.modules[mod.__name__] = mod
    try:
        def tree(sd, scale):
            root = mod.Model()
            buffers = {k for k, _ in pm.named_buffers()}
            for key, v in sd.items():
                *parents, leaf = key.split(".")
                m = root
                for part in parents:
                    if not hasattr(m, part):
                        m.add_module(part, mod.Layer())
                    m = getattr(m, part)
                if key in buffers:
                    m.register_buffer(leaf, v.clone())
                    if leaf == "running_var":
                        m.register_buffer("num_batches_tracked", torch.tensor(7))
                else:
                    m.register_parameter(leaf, nn.Parameter(v.clone() * scale))
            head = root.model.get_submodule(str(len(pm.model) - 1))
            a = torch.from_numpy(np.asarray(pm.head.anchors, np.float32) * anchor_scale)
            head.register_buffer("anchors", a)
            head.register_buffer("anchor_grid", torch.zeros(1))
            root.yaml = dict(pm.yaml)
            root.names = [f"c{i}" for i in range(pm.nc)]
            return root.half()

        sd = pm.state_dict()
        torch.save({"epoch": 3, "model": tree(sd, 0.5), "ema": tree(sd, 1.0)}, path)
    finally:
        del sys.modules[mod.__name__]


def test_load_pt_as_jax(npz, tmp_path):
    path, _ = npz
    src = pcommon.load_model_from_checkpoint(str(path), device="cpu")
    pt = tmp_path / "best.pt"
    reference_pt(src, pt)
    jm, params, stats = jcommon.load_model_from_checkpoint(str(pt))
    pm = pcommon.load_model_from_checkpoint(str(pt), device="cpu")
    want_anchors = (np.asarray(src.head.anchors, np.float32) * 1.3).astype(np.float16)
    np.testing.assert_array_equal(pm.head.anchors, want_anchors.astype(np.float32))
    heads_agree(jm, params, stats, pm)
    # the EMA, in f16, not the 'model' entry
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), src.state_dict()[k].half().float().numpy())


def test_import_torch_state_is_strict(npz):
    from dmayolo_tpu_torch.utils.torch_import import import_torch_state

    pm = pcommon.load_model_from_checkpoint(str(npz[0]), device="cpu")
    sd = dict(pm.state_dict())
    report = import_torch_state(pm, {**sd, "model.0.bn.num_batches_tracked": torch.tensor(1),
                                     "model.9.extra": torch.zeros(1)})
    assert report["unused"] == ["model.9.extra"] and not report["missing"]
    sd.pop("model.0.conv.weight")
    with pytest.raises(ValueError, match="missing"):
        import_torch_state(pm, sd)


# ---------------------------------------------------------------------------
# model info
# ---------------------------------------------------------------------------

DESCRIBED = ("CASPD_ODRTA", "ca-sppfcspc-bifpn-scconv-adapt-hornet", "ghostnet", "yolov3-tiny",
             "yolov5s-transformer")


@pytest.mark.parametrize("name", DESCRIBED)
def test_describe_and_param_count_as_jax(name):
    path = model_config(name)
    jm, pm = JaxModel(str(path)), load_model(str(path), device="meta")
    assert pm.describe().splitlines() == jm.describe().splitlines()
    pshape, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert port_param_count(pm) == jax_param_count(pshape)


def test_model_cli_prints_describe_and_info(shapes, capsys):
    m = pmodel_cli.main(["--cfg", shapes[2], "--imgsz", str(IMG), "--verbose", "--profile",
                         "--fused", "--device", "cpu"])
    out = capsys.readouterr().out
    jm = JaxModel(shapes[2])
    pshape, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert jm.describe() in out and m.fused
    assert f"26 layers, {jax_param_count(pshape):,} parameters" in out  # before the fold
    assert out.count(" SCConv ") >= 4  # the profile's table


def test_flops_gap(shapes):
    """The stated gap.  The port counts every kernel tap of every conv at
    every output (FlopCounterMode: 2 a multiply-add, padding included,
    products and convs only); XLA's cost analysis counts only the taps
    that fall on real pixels and adds the elementwise operations.  So
    port - padding taps = XLA's conv count, and XLA's count exceeds that
    by its elementwise share: 2-5% of XLA's count for this model at 64
    px (3.2% measured), while the padding makes the port's the larger by
    ~19% at 64 px."""
    cfg = tiny_cfg()
    jm = JaxModel(cfg)
    params, stats = jm.init_with_priors(jax.random.PRNGKey(0))
    pm = DetectionModel(cfg, device="cpu")
    every, real = [0.0], [0.0]

    def hook(m, inp, out):
        n, _, h, w = inp[0].shape
        taps = F.conv2d(torch.ones(1, 1, h, w), torch.ones(1, 1, *m.k), None, m.s, m.p, m.d)
        per_tap = 2 * n * m.weight.shape[0] * m.weight.shape[1]
        every[0] += per_tap * out.shape[2] * out.shape[3] * m.k[0] * m.k[1]
        real[0] += per_tap * float(taps.sum())

    hooks = [m.register_forward_hook(hook) for m in pm.modules() if isinstance(m, Conv2d)]
    with torch.no_grad():
        pm(torch.zeros(1, IMG, IMG, 3), torch.float32)
    for h in hooks:
        h.remove()
    got = port_flops(pm, IMG) * 1e9
    want = jax_flops(jm, params, stats, IMG) * 1e9
    assert got == every[0]
    elementwise = (want - real[0]) / want
    assert 0.02 < elementwise < 0.05, elementwise
    assert 1.1 < got / want < 1.3


# ---------------------------------------------------------------------------
# val CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def val_ckpt(tmp_path_factory):
    """The data-eval test's model as a JAX-format checkpoint, and its
    pseudo-labelled VisDrone-analog set as a data yaml."""
    root = tmp_path_factory.mktemp("valcli")
    cfg_path = root / "model.yaml"
    cfg_path.write_text(yaml.safe_dump(small_cfg()))
    jm = JaxModel(str(cfg_path))
    params, stats = random_vars(jm, seed=3)
    ckpt = root / "best.npz"
    jax_save_checkpoint(ckpt, params=params, stats=stats,
                        meta={"cfg": str(cfg_path), "nc": 10})
    pm = DetectionModel(str(cfg_path), device="cpu")
    pm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    generate_visdrone_analog(root, n_train=0, n_val=8, img_size=VAL_SIZE, seed=4,
                             min_objects=10, max_objects=30)
    pseudo_label(root, "val", pm.eval())
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "train": "images/val",
                                    "val": "images/val", "nc": 10,
                                    "names": [f"c{i}" for i in range(10)]}))
    return root, str(ckpt), str(data)


METRICS = ("mp", "mr", "map50", "map")


def val_argv(val_ckpt, name, *extra):
    root, ckpt, data = val_ckpt
    return ["--weights", ckpt, "--data", data, "--imgsz", str(VAL_SIZE), "--batch-size", "4",
            "--fp32", "--project", str(root / "val"), "--name", name, "--exist-ok", *extra]


@pytest.mark.parametrize("fuse", [False, True])
def test_val_cli_matches_jax(val_ckpt, fuse):
    """P, R, mAP@.5 and mAP@.5:.95 within 1e-6 of JAX's, and the txt
    rows.  With the BNs folded (the default) P is held to 1e-5: the folded
    weights are the same in both packages, but their convs round apart,
    and P, read off the precision curve at the confidence of the best
    mean F1, moves with the scores (2.1e-6 here)."""
    extra = ("--save-txt", "--save-conf", "--verbose") + (() if fuse else ("--no-fuse",))
    name = f"fuse{int(fuse)}"
    want = jval.main(val_argv(val_ckpt, "jax_" + name, *extra))
    got = pval.main(val_argv(val_ckpt, "port_" + name, *extra, "--device", "cpu"))
    assert got.nt == want.nt > 0 and 0.05 < want.map50 < 1.0
    for metric in METRICS:
        tol = 1e-5 if fuse and metric == "mp" else 1e-6
        assert abs(getattr(got, metric) - getattr(want, metric)) <= tol, metric
    out = val_ckpt[0] / "val"
    a = {p.name: np.loadtxt(p, ndmin=2) for p in sorted((out / ("port_" + name) / "labels").iterdir())}
    b = {p.name: np.loadtxt(p, ndmin=2) for p in sorted((out / ("jax_" + name) / "labels").iterdir())}
    assert list(a) == list(b) and len(a) == 8
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-3 / VAL_SIZE + 1e-5)


def test_val_cli_study_matches_jax(val_ckpt):
    study = ("--task", "study", "--imgsz", "256", "--no-fuse")  # one row, at 256 px
    want = jval.main(val_argv(val_ckpt, "jax_study", *study))
    got = pval.main(val_argv(val_ckpt, "port_study", *study, "--device", "cpu"))
    out = val_ckpt[0] / "val"
    pr, jr = (list(csv.reader(open(out / d / "study.csv"))) for d in ("port_study", "jax_study"))
    assert pr[0] == jr[0] == ["imgsz", "P", "R", "mAP50", "mAP", "ms_img"]
    assert len(pr) == len(jr) == 2 and [r[0] for r in pr] == [r[0] for r in jr]
    for p, j in zip(pr[1:], jr[1:]):
        np.testing.assert_allclose([float(v) for v in p[1:5]], [float(v) for v in j[1:5]],
                                   rtol=0, atol=1e-6)
    assert [r[0] for r in got] == [r[0] for r in want] == [256]


def test_val_cli_save_json(val_ckpt):
    res = pval.main(val_argv(val_ckpt, "json", "--save-json", "--device", "cpu"))
    out = val_ckpt[0] / "val" / "json"
    assert (out / "best_predictions.json").exists() and (out / "coco_gt.json").exists()
    assert res.used_image_ids and len(res.used_image_ids) == 8


@pytest.mark.parametrize("flags,item", [
    # int8 is ported: what it refuses is the unfused path, with JAX's words
    pytest.param(("--int8", "--no-fuse"), "requires the fused", id="flags0-item 14"),
    # --devices is ported (tests/test_torch_dist.py): what it refuses is a
    # batch that does not divide over the devices
    pytest.param(("--devices", "3"), "divisible", id="flags1-item 13"),
    # --spatial-shard is ported (tests/test_torch_spatial.py): on an odd
    # --devices it prints JAX's words and falls back to the data axis, over
    # which the batch of 4 does not divide
    pytest.param(("--spatial-shard", "--devices", "3"), "divisible", id="flags2-item 13")])
def test_val_cli_refusals(val_ckpt, flags, item, capsys):
    err = {"--int8": SystemExit}.get(flags[0], ValueError)
    with pytest.raises(err, match=item):
        pval.main(val_argv(val_ckpt, "refused", *flags, "--device", "cpu"))
    if "--spatial-shard" in flags:
        assert "falling back to pure data parallelism" in capsys.readouterr().out


def test_val_cli_spatial_shard(val_ckpt):
    """`--spatial-shard --devices 2` splits each image's rows over two CPU
    ranks (1 data x 2 spatial): the result of one process; on one device
    the flag changes nothing, as in JAX."""
    want = pval.main(val_argv(val_ckpt, "sp_plain", "--device", "cpu"))
    one = pval.main(val_argv(val_ckpt, "sp_one", "--spatial-shard", "--device", "cpu"))
    two = pval.main(val_argv(val_ckpt, "sp_two", "--spatial-shard", "--devices", "2",
                             "--device", "cpu"))
    assert want.nt > 0
    for res in (one, two):
        assert res.nt == want.nt
        for name in ("mp", "mr", "map50", "map75", "map"):
            assert abs(getattr(res, name) - getattr(want, name)) <= 1e-6, name


@pytest.mark.parametrize("flags,item", [  # --ckpt-async is ported (test_torch_train_extras.py)
    pytest.param(("--spatial-shard",), "item 13b", id="flags1-item 13")])
def test_train_cli_refusals(shapes, flags, item, capsys):
    """`--spatial-shard` refuses nothing now: as JAX's, it passes
    `spatial=True` to a `Trainer` on the default mesh, which is data-only,
    says so, and trains as without it."""
    plain = ptrain.main(train_argv(shapes, "sp_plain") + ["--epochs", "1", "--device", "cpu"])
    capsys.readouterr()
    got = ptrain.main(train_argv(shapes, "sp_flag") + [*flags, "--epochs", "1", "--device", "cpu"])
    assert "not split along H" in capsys.readouterr().out
    assert got == plain
    root = shapes[0] / "runs"
    want, _ = jax_load_checkpoint(root / "sp_plain" / "last.npz")
    have, _ = jax_load_checkpoint(root / "sp_flag" / "last.npz")
    for tree in ("params", "stats"):
        for k, v in want[tree].items():
            np.testing.assert_array_equal(np.asarray(have[tree][k]), np.asarray(v), str(k))


def test_cli_device_is_cuda_unless_asked(val_ckpt, shapes):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    for main, argv in ((pval.main, val_argv(val_ckpt, "nodevice")),
                       (ptrain.main, train_argv(shapes, "nodevice")),
                       (pmodel_cli.main, ["--cfg", shapes[2]])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


def test_resolve_remat_as_jax():
    for args in ((True, False, 640), (False, True, 1536), (False, False, 1024),
                 (False, False, 1023), (True, True, 320)):
        assert ptrain.resolve_remat(*args) == jtrain.resolve_remat(*args)


def test_get_latest_run(tmp_path):
    import os

    for name, t in (("a", 100), ("b", 300), ("c", 200)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "last.npz").write_bytes(b"")
        os.utime(tmp_path / name / "last.npz", (t, t))
    assert ptrain.get_latest_run(str(tmp_path)) == jtrain.get_latest_run(str(tmp_path)) \
        == tmp_path / "b" / "last.npz"
    assert ptrain.get_latest_run(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# Trainer options: param groups, linear_lr, the fixed cadence
# ---------------------------------------------------------------------------

UNGROUPED_CFG = {
    "nc": 3, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                [116, 90, 156, 198, 373, 326]],
    "backbone": [[-1, 1, "Conv", [16, 6, 2, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "C3TR", [32]], [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "C3STR", [64]],
                 [-1, 1, "Conv", [64, 3, 2]]],
    "head": [[[2, 4, 5], 1, "Detect", ["nc", "anchors"]]],
}


@pytest.mark.parametrize("ungrouped", [False, True])
def test_param_groups_as_jax(ungrouped):
    jm = JaxModel(UNGROUPED_CFG)
    pm = DetectionModel(UNGROUPED_CFG, device="meta")
    want = jo.param_groups(jm, train_ungrouped=ungrouped)
    got = po.param_groups(pm, train_ungrouped=ungrouped)
    paths = jax_paths(pm)
    assert {paths[k][1]: v for k, v in got.items()} == want
    assert ("frozen" in want.values()) != ungrouped


def test_linear_lr_as_jax(tmp_path):
    hyp = pcommon.load_hyp("scratch")
    tr = Trainer(tiny_cfg(), _Loader(6, 2), hyp, nc=3, epochs=7, batch_size=2, img_size=IMG,
                 linear_lr=True, dtype=torch.float32, device="cpu", out_dir=str(tmp_path))
    want = jo.Schedule(hyp, epochs=7, steps_per_epoch=tr.steps_per_epoch, linear=True,
                       batch_size=2, step_scale=tr.accumulate)
    for step in (0, 1, 5, 999, 1001, 1500, 3000):
        g, w = tr.sched(step), want(step)
        for k in ("g0", "g1", "g2", "momentum"):
            assert g[k] == pytest.approx(float(w[k]), rel=1e-6), (step, k)
    cosine = po.Schedule(hyp, epochs=7, steps_per_epoch=tr.steps_per_epoch,
                         batch_size=2, step_scale=tr.accumulate)
    assert tr.sched(3000)["g1"] != pytest.approx(cosine(3000)["g1"], rel=1e-3)


def jax_fixed_cadence(n_batches, epochs, acc):
    """Optimizer steps of the JAX Trainer's loop with accum_ramp off: the
    pending group carried across epochs, a step at each `acc` batches
    (dmayolo_tpu/train/trainer.py:444-461)."""
    steps, pending = 0, 0
    for _ in range(epochs):
        for _ in range(n_batches):
            pending += 1
            if pending >= acc:
                steps, pending = steps + 1, 0
    return steps


class _Loader:
    """An in-memory loader of `n` batches of `bs` 64 px images, 4 rows."""

    def __init__(self, n, bs):
        rng = np.random.default_rng(0)
        box = np.tile(np.array([0.5, 0.5, 0.3, 0.3], np.float32), (bs, 4, 1))
        self.batches = [Namespace(images=rng.integers(0, 256, (bs, IMG, IMG, 3), np.uint8),
                                  targets=Targets(np.zeros((bs, 4), np.float32), box,
                                                  np.ones((bs, 4), bool)))
                        for _ in range(n)]

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


@pytest.mark.parametrize("accum_ramp", [False, True])
def test_accum_ramp_off_keeps_jax_fixed_cadence(tmp_path, accum_ramp):
    tr = Trainer(tiny_cfg(), _Loader(6, 2), pcommon.load_hyp("scratch"), nc=3, epochs=2,
                 batch_size=2, img_size=IMG, accum_ramp=accum_ramp, dtype=torch.float32,
                 device="cpu", out_dir=str(tmp_path), nosave=True)
    assert tr.accumulate == 6 and tr.accum_ramp == accum_ramp
    tr.train()
    fixed = jax_fixed_cadence(6, 2, 6)
    assert (tr.state.step == fixed) != accum_ramp  # the ramp steps more often in warmup
    assert tr.state.step >= fixed


# ---------------------------------------------------------------------------
# autobatch and evolve
# ---------------------------------------------------------------------------

G = 1024 ** 3
TABLE = {1: 13.0 * G, 2: 14.0 * G, 4: 15.25 * G, 8: 14.25 * G}


def _over(bs):
    raise KeyError(bs)


# (memory curve: bs -> bytes, or KeyError where the step does not fit;
# autobatch kwargs) — the cases of tests/test_autobatch.py
AUTOBATCH_CASES = {
    "linear_1G": (lambda bs: int(0.1 * G + 0.05 * G * bs), dict(hbm_bytes=1 * G)),
    "linear_4G": (lambda bs: int(0.1 * G + 0.05 * G * bs), dict(hbm_bytes=4 * G)),
    "multiple_of_8": (lambda bs: int(100e6) + int(50e6) * bs,
                      dict(hbm_bytes=int(1.2e9), multiple_of=8)),
    "non_monotonic": (lambda bs: int(TABLE[bs]) if bs in TABLE else _over(bs),
                      dict(hbm_bytes=16 * G)),
    "fails_above_8": (lambda bs: int(1 * G + 0.5 * G * bs) if bs <= 8 else _over(bs),
                      dict(hbm_bytes=16 * G)),
    "smallest_fails": (_over, dict(hbm_bytes=16 * G, default=7)),
    "over_budget_refused": (lambda bs: int(2.5 * G * bs), dict(hbm_bytes=16 * G, multiple_of=8)),
    "tight_fit": (lambda bs: int(1.9 * G * bs), dict(hbm_bytes=16 * G, multiple_of=8)),
    "no_budget": (_over, dict(hbm_bytes=None, default=16)),
}


def _jax_lower(mem, calls):
    def lower(bs):
        calls.append(bs)
        try:
            m = mem(bs)
        except KeyError:
            raise RuntimeError("compile failed") from None

        class MA:
            temp_size_in_bytes, argument_size_in_bytes = m, 0
            output_size_in_bytes = alias_size_in_bytes = 0

        return Namespace(compile=lambda: Namespace(memory_analysis=lambda: MA()))
    return lower


def _port_measure(mem, calls):
    """Out of memory from bs 16 up; below, another RuntimeError (a
    kernel's size limit): both mean the step does not run there."""
    def measure(bs):
        calls.append(bs)
        try:
            return mem(bs)
        except KeyError:
            raise (torch.OutOfMemoryError if bs >= 16 else RuntimeError)("no") from None
    return measure


@pytest.mark.parametrize("case", list(AUTOBATCH_CASES))
def test_autobatch_decisions_as_jax(case, monkeypatch):
    mem, kw = AUTOBATCH_CASES[case]
    if kw["hbm_bytes"] is None:  # the CPU: no budget, nothing probed
        monkeypatch.setattr(pab, "device_memory_budget", lambda device=None: None)
    results = []
    for fn, wrap in ((jab.autobatch, _jax_lower), (pab.autobatch, _port_measure)):
        calls = []
        try:
            results.append((fn(wrap(mem, calls), **kw), calls))
        except RuntimeError as e:
            results.append((str(e), calls))
    assert results[0] == results[1]


def test_batch_size_minus_one_on_cpu_is_the_default(shapes):
    opt = ptrain.build_parser().parse_args(train_argv(shapes, "ab") + ["--device", "cpu"])
    assert ptrain.autobatch_size(opt, pcommon.load_hyp(opt.hyp)) == 16
    jm = JaxModel(shapes[2], nc=3)
    assert jab.find_train_batch_size(jm, None, {}, img_size=IMG) == 16


def test_evolve_as_jax(tmp_path):
    base = pcommon.load_hyp("scratch")

    def train_fn(h):
        return round(h["lr0"] * 10 + h["momentum"] - h["weight_decay"] * 100, 5)

    for mod, d in ((jevolve, tmp_path / "jax"), (pevolve, tmp_path / "port")):
        random.seed(123)  # mutate's parent choice draws from the global random
        mod.evolve(train_fn, base, generations=4, out_dir=str(d), seed=0)
    for name in ("evolve.csv", "hyp_evolve.yaml"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert len((tmp_path / "port" / "evolve.csv").read_text().splitlines()) == 5


def test_evolve_cli_runs_the_trainer(shapes, monkeypatch):
    """`--evolve 2`: two generations through `_make_trainer`, each one's
    fitness logged, the evolved hyp returned."""
    seq = iter([0.3, 0.6])
    monkeypatch.setattr(Trainer, "validate", lambda self, use_ema=True: ValResult(
        map=next(seq) / 0.9, maps=np.zeros(self.nc)))
    argv = train_argv(shapes, "evolve") + ["--epochs", "1", "--evolve", "2", "--device", "cpu"]
    best = ptrain.main(argv)
    rows = list(csv.reader(open(shapes[0] / "runs" / "evolve" / "evolve.csv")))
    assert [float(r[0]) for r in rows[1:]] == [0.3, 0.6]
    assert best["lr0"] == pytest.approx(float(rows[2][rows[0].index("lr0")]))

