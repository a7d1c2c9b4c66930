"""Shared set-up of the port's train-step tests (test_torch_train_*.py):
the small flagship-shaped model of test_torch_model.py in both packages
with the same numpy-drawn weights, seeded batches, the JAX step, and the
comparison of a port TrainState with a JAX one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.cli.common import load_hyp as jax_load_hyp
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.train import loss as jl
from dmayolo_tpu.train import optim as jo
from dmayolo_tpu.train import step as js
from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.train import loss as pl
from dmayolo_tpu_torch.train import optim as po
from dmayolo_tpu_torch.train import step as ps
from dmayolo_tpu_torch.train.trainer import load_hyp
from dmayolo_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_model import random_vars, small_cfg

M = 6  # target rows an image
# the trajectories: 96 px (64 px leaves 2x2 maps at P5, where a 1e-7
# change of the weights moves JAX's own gradients by up to 2% within two
# steps), microbatch 2, 2 microbatches a step
IMG, MB, ACC = 96, 2, 2
SPE, EPOCHS, WARMUP = 4, 5, 6  # schedule: batches an epoch, epochs, warmup floor
# lr 10x below the scratch hyp's: at 0.01 (bias warmup 0.1) a 1e-7 change
# of the initial weights moves JAX's own loss by 3e-3 in ten steps
TRAJECTORY_HYP = {"lr0": 0.001, "warmup_bias_lr": 0.01}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for a module: at these sizes one thread is as
    fast as eight, and several test workers' spinning thread pools slow
    each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(i, n=MB * ACC, img=IMG):
    """Seeded uint8 images and Targets (numpy): rows 4-5 padded in every
    other image."""
    rng = np.random.default_rng(100 + i)
    imgs = rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8)
    cls = rng.integers(0, 10, (n, M)).astype(np.float32)
    box = np.concatenate([rng.uniform(0.05, 0.95, (n, M, 2)), rng.uniform(0.05, 0.6, (n, M, 2))],
                         -1).astype(np.float32)
    mask = np.ones((n, M), bool)
    mask[::2, 4:] = False
    return imgs, (cls, box * mask[..., None], mask)


class Pair:
    """The JAX model and weights, and the port's model built from them."""

    def __init__(self, seed=0, **hyp):
        self.jm = JaxModel(small_cfg())
        self.params, self.stats = random_vars(self.jm, seed)
        self.hyp = jax_load_hyp("scratch")
        assert self.hyp == load_hyp("scratch")
        self.hyp.update(hyp)
        self.anchors = self.jm.head.anchors

    def port_model(self):
        pm = DetectionModel(small_cfg(), device="cpu")
        pm.load_state_dict(state_dict_from_jax(self.params, self.stats), strict=True)
        np.testing.assert_array_equal(pm.head.anchors, self.anchors)
        return pm

    def jax_step(self, adam, freeze, acc=ACC, wd=5e-4):
        sched = jo.Schedule(self.hyp, epochs=EPOCHS, steps_per_epoch=SPE, adam=adam,
                            batch_size=MB, warmup_min_iters=WARMUP, step_scale=acc)
        loss = jl.ComputeLoss(self.anchors, self.hyp, nc=10)
        return jax.jit(js.make_train_step(self.jm, loss, sched, jo.param_groups(self.jm), wd,
                                          adam=adam, dtype=jnp.float32, accumulate=acc,
                                          freeze=freeze))

    def port_step(self, adam, freeze, acc=ACC):
        sched = po.Schedule(self.hyp, epochs=EPOCHS, steps_per_epoch=SPE, adam=adam,
                            batch_size=MB, warmup_min_iters=WARMUP, step_scale=acc)
        return ps.make_train_step(pl.ComputeLoss(self.anchors, self.hyp, nc=10), sched,
                                  dtype=torch.float32, accumulate=acc, freeze=freeze)

    def port_state(self, adam, wd=5e-4):
        pm = self.port_model()
        return ps.init_train_state(pm, po.param_groups(pm), wd, adam=adam,
                                   momentum=self.hyp["momentum"])


def jax_run(step, state, i):
    imgs, tg = batch(i)
    return step(state, jnp.asarray(imgs), jl.Targets(*(jnp.asarray(a) for a in tg)),
                jax.random.PRNGKey(i))


def port_run(step, state, i):
    imgs, tg = batch(i)
    return step(state, torch.from_numpy(imgs), pl.Targets(*(torch.from_numpy(a) for a in tg)))


def close_scaled(got, want, tol, what):
    """|got - want| <= tol * (1 + max |want|), per tensor."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * (1 + float(np.abs(want).max() if want.size else 0.0)), (what, err)


def assert_states_close(pstate, jstate, tol=1e-4, opt_tol=3e-4):
    """Model and EMA trees within `tol`, the optimizer's within `opt_tol`
    (sums of gradients: in JAX alone a 1e-7 change of the weights moves
    the SGD momentum buffers by up to 5e-5 scaled in ten steps), and both
    counters."""
    got = ps.state_trees(pstate)
    want = {"params": jstate.params, "stats": jstate.stats, "ema_params": jstate.ema_params,
            "ema_stats": jstate.ema_stats, "opt_mom": jstate.opt.mom, "opt_vel": jstate.opt.vel}
    for name, tree in want.items():
        assert set(got[name]) == set(tree), name
        for k, v in tree.items():
            close_scaled(got[name][k], v, opt_tol if name.startswith("opt") else tol, (name, k))
    assert pstate.step == int(jstate.opt.step)
    assert pstate.ema_updates == int(jstate.ema_updates)


class Trajectory:
    """Ten steps in both packages from the same weights and batches,
    `ACC` microbatches each, EMA on; each package's state after step 5 is
    also written as a checkpoint after step `MID`, the JAX one by the JAX
    writer and the port's by the port's."""

    STEPS, MID = 10, 8

    def __init__(self, pair, adam, freeze, tmp):
        from dmayolo_tpu.utils.checkpoint import save_checkpoint as jax_save
        from dmayolo_tpu_torch.utils.checkpoint import save_checkpoint

        self.pair, self.adam, self.freeze = pair, adam, freeze
        self.jstep = pair.jax_step(adam, freeze)
        self.pstep = pair.port_step(adam, freeze)
        self.jax_ckpt, self.port_ckpt = tmp / "jax_mid.npz", tmp / "port_mid.npz"
        # one package after the other: interleaved, each one's idle worker
        # threads slow the other's
        jstate, want = js.init_train_state(pair.params, pair.stats), []
        for i in range(self.STEPS):
            if i == self.MID:
                jax_save(self.jax_ckpt, params=jstate.params, stats=jstate.stats,
                         ema_params=jstate.ema_params, ema_stats=jstate.ema_stats,
                         opt_mom=jstate.opt.mom, opt_vel=jstate.opt.vel,
                         meta={"step": int(jstate.opt.step),
                               "updates": int(jstate.ema_updates)})
            jstate, jm = jax_run(self.jstep, jstate, i)
            want.append({k: float(v) for k, v in jm.items()})
        self.jstate = jax.block_until_ready(jstate)
        self.pstate, got = pair.port_state(adam), []
        for i in range(self.STEPS):
            if i == self.MID:
                save_checkpoint(self.port_ckpt, meta={"step": self.pstate.step,
                                                      "updates": self.pstate.ema_updates},
                                **ps.state_trees(self.pstate))
            got.append({k: float(v) for k, v in port_run(self.pstep, self.pstate, i).items()})
        self.losses = list(zip(got, want))

    def check_trajectory(self, tol=1e-4):
        """The loss and items at every step, then the whole final state."""
        for i, (got, want) in enumerate(self.losses):
            for k in ("loss", "box", "obj", "cls"):
                assert abs(got[k] - want[k]) <= tol * abs(want[k]), (i, k, got[k], want[k])
        assert_states_close(self.pstate, self.jstate, tol)
        if self.freeze:  # the frozen layers are the initial weights, exactly
            trees = ps.state_trees(self.pstate)
            for k, v in self.pair.params.items():
                if k[0] == "model" and int(k[1]) < self.freeze:
                    np.testing.assert_array_equal(trees["params"][k], np.asarray(v))
                    assert not trees["opt_mom"][k].any() and not trees["opt_vel"][k].any()

    def check_jax_resumed_in_port(self, tol=1e-4):
        """The JAX state after step `MID`, resumed in the port, steps on as
        JAX did."""
        from dmayolo_tpu_torch.utils.checkpoint import load_checkpoint

        pstate = self.pair.port_state(self.adam)
        ps.load_state_trees(pstate, *load_checkpoint(self.jax_ckpt))
        assert pstate.step == self.MID
        for i in range(self.MID, self.STEPS):
            port_run(self.pstep, pstate, i)
        assert_states_close(pstate, self.jstate, tol)

    def check_port_resumed_in_jax(self, tol=1e-4):
        """The port's state after step `MID`, resumed in JAX, steps on as
        the port did."""
        from dmayolo_tpu.train.optim import OptState
        from dmayolo_tpu.utils.checkpoint import load_checkpoint as jax_load

        trees, meta = jax_load(self.port_ckpt)
        jstate = js.TrainState(
            params=trees["params"], stats=trees["stats"],
            opt=OptState(jnp.asarray(meta["step"], jnp.int32), trees["opt_mom"], trees["opt_vel"]),
            ema_params=trees["ema_params"], ema_stats=trees["ema_stats"],
            ema_updates=jnp.asarray(meta["updates"], jnp.int32))
        for i in range(self.MID, self.STEPS):
            jstate, _ = jax_run(self.jstep, jstate, i)
        assert_states_close(self.pstate, jstate, tol)
