"""The port's train step against the JAX package on the CPU, at f32: the
small flagship-shaped model of test_torch_model.py (depth 0.33, width
0.125, nc 10) with the same numpy-drawn weights and batches.

- One forward and backward in train mode, batch 4 at 64 px: loss and items
  within 1e-4 relative; every parameter's gradient within 1e-4 scaled by
  1 + max |g| (per tensor), compared through `jax_from_state_dict`; the
  new BN running statistics within 1e-5 (rtol and atol).
- Ten SGD steps (nesterov, weight decay, warmup schedule) at 96 px,
  accumulate 2 microbatches of 2, EMA on, model.0 frozen, lr0 0.001: the
  loss and items at every step within 1e-4 relative; the final
  parameters, BN statistics and EMA within 1e-4 scaled by 1 + max |x| (per
  tensor), the momentum buffers within 3e-4 scaled; the frozen layer
  exactly as it was.  Then the checkpoint after step 8, written by each
  package, resumed in the other: its last two steps within the same
  tolerances.  `torch_train_common.py` gives the measurements behind the
  image size, the lr and the buffers' tolerance.

test_torch_train_adam.py holds the same trajectory with Adam.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.train import loss as jl
from dmayolo_tpu_torch.train import loss as pl
from dmayolo_tpu_torch.utils.weights import jax_from_state_dict
from tests.torch_train_common import (TRAJECTORY_HYP, Pair, Trajectory, batch, close_scaled,
                                      one_torch_thread)  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def sgd(tmp_path_factory):
    return Trajectory(Pair(**TRAJECTORY_HYP), adam=False, freeze=1,
                      tmp=tmp_path_factory.mktemp("sgd"))


def test_one_step_matches_jax(pair):
    imgs, tg = batch(0, n=4, img=64)
    jloss = jl.ComputeLoss(pair.anchors, pair.hyp, nc=10)
    jt = jl.Targets(*(jnp.asarray(a) for a in tg))

    def lossfn(p):
        x = jnp.asarray(imgs).astype(jnp.float32) / 255.0
        raw, new_stats = pair.jm.apply(p, pair.stats, x, train=True, dtype=jnp.float32)
        total, items = jloss(raw, jt)
        return total, (items, new_stats)

    (want, (w_items, w_stats)), w_grads = jax.jit(jax.value_and_grad(lossfn, has_aux=True))(
        pair.params)

    pm = pair.port_model().train()
    ploss = pl.ComputeLoss(pair.anchors, pair.hyp, nc=10)
    x = torch.from_numpy(imgs).to(torch.float32) / 255.0
    total, items = ploss(pm(x, torch.float32), pl.Targets(*(torch.from_numpy(a) for a in tg)))
    total.backward()
    assert abs(float(total.detach()) - float(want)) <= 1e-4 * abs(float(want))
    for k in ("box", "obj", "cls"):
        assert abs(float(items[k].detach()) - float(w_items[k])) <= 1e-4 * abs(float(w_items[k]))
    grads = {k: p.grad for k, p in pm.named_parameters()}
    got, _ = jax_from_state_dict(pm, {**pm.state_dict(), **grads})
    assert set(got) == set(w_grads)
    for k, g in w_grads.items():
        close_scaled(got[k], g, 1e-4, k)
    _, got_stats = jax_from_state_dict(pm)
    assert set(got_stats) == set(w_stats)
    for k, s in w_stats.items():
        np.testing.assert_allclose(got_stats[k], np.asarray(s), rtol=1e-5, atol=1e-5,
                                   err_msg=str(k))


def test_sgd_trajectory_matches_jax(sgd):
    sgd.check_trajectory()


def test_sgd_jax_checkpoint_resumes_in_port(sgd):
    sgd.check_jax_resumed_in_port()


def test_sgd_port_checkpoint_resumes_in_jax(sgd):
    sgd.check_port_resumed_in_jax()
