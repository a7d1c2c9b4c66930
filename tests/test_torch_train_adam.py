"""The port's train step with Adam against the JAX package on the CPU, at
f32: ten steps of the small flagship-shaped model of test_torch_model.py
at 96 px, accumulate 2 microbatches of 2, EMA on, lr 3e-4 (Adam's) with
bias warmup from 0.01.  The loss and items at every step within 1e-4
relative; the final parameters, BN statistics and EMA within 1e-4 scaled
by 1 + max |x| (per tensor), Adam's exp_avg and exp_avg_sq within 3e-4
scaled.  Then the checkpoint after step 8, written by each package,
resumed in the other: its last two steps within the same tolerances.

model.0 to model.10 (through SPPFCSPC) are frozen.  Adam moves each
parameter by about lr a step whatever its gradient's size, so two things
upstream there would move a parameter by lr on a rounding difference, in
either package: CoorAttention's `conv1.bias` feeds a train-mode BN, so its
gradient is zero in exact arithmetic and rounding noise in practice; and
SPPFCSPC's 5x5 max pools cover the whole 3x3 map at P5, where a near-tie
routes a window's gradient to another element (measured: with model.0-9
frozen, the two packages' losses part by 1e-4 from step 8).
"""
import pytest

from tests.torch_train_common import TRAJECTORY_HYP, Pair, Trajectory, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def adam(tmp_path_factory):
    return Trajectory(Pair(**TRAJECTORY_HYP), adam=True, freeze=11,
                      tmp=tmp_path_factory.mktemp("adam"))


def test_adam_trajectory_matches_jax(adam):
    adam.check_trajectory()


def test_adam_jax_checkpoint_resumes_in_port(adam):
    adam.check_jax_resumed_in_port()


def test_adam_port_checkpoint_resumes_in_jax(adam):
    adam.check_port_resumed_in_jax()
