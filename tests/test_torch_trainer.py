"""The port's Trainer, schedule, parameter groups and checkpoints against
the JAX package, on the CPU at f32, with the small flagship-shaped model of
test_torch_model.py at 64 px and an in-memory loader.

- The warmup accumulate ramp: the optimizer steps and EMA updates over 24
  batches a epoch, two epochs, equal the reference rule (`ref_cadence_steps`,
  a copy of the one in tests/test_accum_ramp.py); with the ramp off, one
  step each `accumulate` batches.
- `Schedule` (every group's lr and the momentum, by step and in batch
  units, one-cycle and linear, SGD and Adam) within 1e-6 relative or 1e-8
  absolute (JAX computes the bias lr's warmup blend in f32, to 4e-9);
  `param_groups` equal to the JAX labels; the class and image weights
  within 1e-6; `EarlyStopping` equal; the EMA decay within 1e-7 (JAX's is
  f32).
- Checkpoints: the port's `last.npz` read by the JAX `load_checkpoint`
  (meta and trees; the EMA in f16), the JAX model on those trees giving
  the port's raw head within 1e-4 (rtol and atol); a mid-run checkpoint
  resuming the port's Trainer at the next epoch with its weights, step
  count and anchors.
- `pretrained`: a JAX checkpoint of the model at another nc (EMA trees or
  only the model's) loads into the Trainer; every tensor of matching shape
  equals the checkpoint's exactly (the EMA's where present), and the head
  convs, whose shapes differ, keep the seeded init exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.train import optim as jo
from dmayolo_tpu.train.trainer import EarlyStopping as JaxEarlyStopping
from dmayolo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from dmayolo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.train import optim as po
from dmayolo_tpu_torch.train.loss import Targets
from dmayolo_tpu_torch.train.trainer import Batch, EarlyStopping, Trainer, load_hyp
from dmayolo_tpu_torch.utils.weights import jax_paths, load_jax_checkpoint, state_dict_from_jax
from tests.test_torch_model import random_vars, small_cfg
from tests.torch_train_common import batch, one_torch_thread  # noqa: F401


def ref_cadence_steps(n_batches, nw, A):
    """The reference's stepping rule (train.py:409-412, 448-454)."""
    pending, steps = 0, 0
    for ni in range(n_batches):
        pending += 1
        a = max(1, min(A, round(float(np.interp(ni, [0, nw], [1, A])))))
        if pending >= a:
            steps += 1
            pending = 0
    return steps


def loader(n=24, bs=2):
    return [Batch(imgs, Targets(*tg)) for imgs, tg in
            (batch(i, n=bs, img=64) for i in range(n))]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    tr = Trainer(small_cfg(), loader(), load_hyp("scratch"), nc=10, epochs=2, batch_size=2,
                 img_size=64, out_dir=str(out), dtype=torch.float32, device="cpu")
    tr.train()
    state = tr.state
    return tr, state, out


def test_trainer_matches_reference_cadence(trained):
    tr, state, out = trained
    assert tr.accum_ramp and tr.accumulate == 24  # round(64 / 2), clamped to an epoch
    assert tr.sched.nw == 1000  # the reference's warmup floor
    want = ref_cadence_steps(2 * 24, tr.sched.nw, tr.accumulate)
    assert state.step == state.ema_updates == want
    assert want > 2 * 24 // tr.accumulate  # the ramp added steps
    assert abs(tr.loss.hyp["obj"] - 1.0 * (64 / 640) ** 2) < 1e-12  # hyp scaled as JAX's
    assert abs(tr.loss.hyp["cls"] - 0.5 * 10 / 80) < 1e-12
    rows = (out / "results.csv").read_text().splitlines()
    assert rows[0].split(",")[:2] == ["epoch", "train/loss"] and len(rows) == 3
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r.split(","))


def test_fixed_cadence_opt_out(tmp_path):
    tr = Trainer(small_cfg(), loader(n=8), load_hyp("scratch"), nc=10, epochs=1, batch_size=2,
                 img_size=64, out_dir=str(tmp_path), dtype=torch.float32, accumulate=4,
                 nosave=True, device="cpu")
    assert not tr.accum_ramp
    tr.train()
    assert tr.state.step == 8 // 4


def test_last_checkpoint_loads_in_jax(trained):
    tr, state, out = trained
    trees, meta = jax_load_checkpoint(out / "last.npz")
    assert set(trees) == {"params", "stats"}  # stripped: the EMA as the model
    assert meta["epoch"] == 1 and meta["nc"] == 10 and meta["cfg"] == tr.cfg_ref
    np.testing.assert_allclose(np.asarray(meta["anchors"]), tr.model.head.anchors)
    ema = {k: v for k, v in state.ema.state_dict().items()}
    for key, (tree, path) in jax_paths(state.ema).items():
        want = ema[key].numpy().astype(np.float16).astype(np.float32)
        if path[-1] == "kernel":
            want = want.transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(np.asarray(trees[tree][path]), want)

    jm = JaxModel(meta["cfg"])
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jm.apply(trees["params"], trees["stats"], jnp.asarray(x))
    pm = DetectionModel(small_cfg(), device="cpu")
    pm.load_state_dict(load_jax_checkpoint(out / "last.npz", device="cpu")[0], strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_trainer_resumes_from_its_checkpoint(trained, tmp_path):
    tr, state, _ = trained
    tr.out = tmp_path
    tr._save("mid", epoch=0)
    again = Trainer(small_cfg(), loader(n=2), load_hyp("scratch"), nc=10, epochs=2,
                    batch_size=2, img_size=64, out_dir=str(tmp_path / "b"),
                    dtype=torch.float32, resume_from=str(tmp_path / "mid.npz"), device="cpu")
    assert again.start_epoch == 1
    assert (again.state.step, again.state.ema_updates) == (state.step, state.ema_updates)
    for (k, a), b in zip(again.state.model.state_dict().items(), state.model.state_dict().values()):
        torch.testing.assert_close(a, b.half().float(), rtol=0, atol=0, msg=k)
    for p in again.state.optimizer.param_groups[1]["params"]:
        assert torch.isfinite(again.state.optimizer.state[p]["momentum_buffer"]).all()


@pytest.mark.parametrize("with_ema", [False, True])
def test_pretrained_loads_what_matches(tmp_path, capsys, with_ema):
    jm = JaxModel(dict(small_cfg(), nc=5))  # another head width
    params, stats = random_vars(jm, seed=3)
    trees = dict(params=params, stats=stats)
    if with_ema:
        trees.update(zip(("ema_params", "ema_stats"), random_vars(jm, seed=4)))
    jax_save_checkpoint(tmp_path / "pre.npz", meta={"nc": 5}, **trees)
    kw = dict(nc=10, epochs=1, batch_size=2, img_size=64, dtype=torch.float32, device="cpu")
    init = Trainer(small_cfg(), loader(n=1), load_hyp("scratch"), out_dir=str(tmp_path / "a"),
                   **kw).model.state_dict()
    capsys.readouterr()
    tr = Trainer(small_cfg(), loader(n=1), load_hyp("scratch"), out_dir=str(tmp_path / "b"),
                 pretrained=str(tmp_path / "pre.npz"), **kw)
    src = state_dict_from_jax(trees["ema_params" if with_ema else "params"],
                              trees["ema_stats" if with_ema else "stats"])
    got = tr.model.state_dict()
    detect = len(small_cfg()["backbone"]) + len(small_cfg()["head"]) - 1  # the last layer
    head = {f"model.{detect}.m.{i}.{leaf}" for i in range(3) for leaf in ("weight", "bias")}
    assert {k for k in got if src[k].shape != got[k].shape} == head
    for k, v in got.items():
        torch.testing.assert_close(v, init[k] if k in head else src[k], rtol=0, atol=0, msg=k)
    for k, v in tr.state.ema.state_dict().items():  # the EMA starts from the loaded model
        torch.testing.assert_close(v, got[k], rtol=0, atol=0, msg=k)
    n = sum(1 for _ in tr.model.parameters())
    assert f"pretrained: matched {n - 6}/{n} tensors" in capsys.readouterr().out


def test_placeholder_anchors_raise(tmp_path):
    cfg = small_cfg()
    cfg["anchors"] = 3
    with pytest.raises(ValueError, match="placeholder"):
        Trainer(cfg, loader(n=1), load_hyp("scratch"), nc=10, out_dir=str(tmp_path),
                device="cpu")


def test_trainer_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(small_cfg(), loader(n=1), load_hyp("scratch"), nc=10, out_dir=str(tmp_path))


@pytest.mark.parametrize("adam,linear,batch_units", [(False, False, False), (True, False, True),
                                                     (False, True, True), (True, True, False)])
def test_schedule_matches_jax(adam, linear, batch_units):
    hyp = load_hyp("visdrone")
    kw = dict(epochs=40, steps_per_epoch=24, adam=adam, linear=linear, batch_size=4,
              warmup_min_iters=100, step_scale=16)
    js, ps = jo.Schedule(hyp, **kw), po.Schedule(hyp, **kw)
    assert ps.nw == js.nw
    for step in (0, 1, 3, 6, 7, 50, 99, 100, 101, 500, 959):
        want = js(jnp.asarray(step), batch_units=batch_units)
        got = ps(step, batch_units=batch_units)
        for k in ("g0", "g1", "g2", "frozen", "momentum"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k} at {step}")


def test_param_groups_match_jax():
    jm = JaxModel(small_cfg())
    # param_groups reads only the paths of an init: shapes stand in for it
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jm.init = lambda key: tuple({k: np.zeros(s.shape, s.dtype) for k, s in t.items()}
                                for t in shapes)
    pm = DetectionModel(small_cfg(), device="cpu")
    paths = jax_paths(pm)
    got = {paths[k][1]: g for k, g in po.param_groups(pm).items()}
    assert got == jo.param_groups(jm)
    assert set(got.values()) == {"g0", "g1", "g2"}


def test_class_and_image_weights_match_jax():
    rng = np.random.default_rng(8)
    labels = [np.concatenate([rng.integers(0, 10, (n, 1)), rng.uniform(size=(n, 4))], 1)
              for n in (0, 3, 7, 12)]
    cw = po.labels_to_class_weights(labels, 10)
    np.testing.assert_allclose(cw, jo.labels_to_class_weights(labels, 10), rtol=1e-6)
    np.testing.assert_allclose(po.labels_to_image_weights(labels, 10, cw),
                               jo.labels_to_image_weights(labels, 10, cw), rtol=1e-6)


def test_early_stopping_matches_jax():
    fits = [0.1, 0.3, 0.2, 0.3, 0.25, 0.1, 0.05, 0.4, 0.1, 0.1, 0.1]
    mine, ref = EarlyStopping(patience=3), JaxEarlyStopping(patience=3)
    assert [mine(e, f) for e, f in enumerate(fits)] == [ref(e, f) for e, f in enumerate(fits)]


def test_ema_decay_matches_jax():
    for t in (0, 1, 10, 2000, 10 ** 5):
        np.testing.assert_allclose(po.ema_decay(t), float(jo.ema_decay(jnp.asarray(t))),
                                   rtol=1e-6, atol=1e-7)
