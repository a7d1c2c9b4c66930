"""Rematerialisation (`DetectionModel.remat`, `nn/primitives.py::remat_layer`,
the Trainer's `remat`) on the CPU at f32.

A tiny model with a ViT stack (C3TR: Dropout 0.1) and a Swin stack
(C3STR at 352 hidden channels, 11 heads: DropPath 0.1) takes one train
step (forward, loss, backward, Adam, EMA) with and without remat from one
state and one lent generator: the gradients, the updated weights and the
BN running statistics must agree within 1e-6, and the generator end in
the same state.  The two traps are shown to matter: a recompute that
draws from the generator where the forward left it gives other masks and
other gradients, and one that updates the BN statistics again moves them.
"""
import copy
from argparse import Namespace

import numpy as np
import pytest
import torch

from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.nn import primitives
from dmayolo_tpu_torch.nn.primitives import DropPath, Dropout, lend_generator
from dmayolo_tpu_torch.train.loss import ComputeLoss, Targets
from dmayolo_tpu_torch.train.optim import Schedule, param_groups
from dmayolo_tpu_torch.train.step import init_train_state, make_train_step
from dmayolo_tpu_torch.train.trainer import Trainer, load_hyp

TOL = 1e-6
IMG, B = 64, 4
CFG = {
    "nc": 3, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                [116, 90, 156, 198, 373, 326]],
    "backbone": [[-1, 1, "Conv", [16, 6, 2, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "C3", [32]], [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "C3TR", [64]],
                 [-1, 1, "Conv", [128, 3, 2]], [-1, 1, "Conv", [704, 3, 2]],
                 [-1, 1, "C3STR", [704]]],
    "head": [[[4, 5, 7], 1, "Detect", ["nc", "anchors"]]],
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    model = DetectionModel(CFG, device="cpu").init_with_priors(torch.Generator().manual_seed(1))
    rates = sorted((type(m).__name__, m.rate) for m in model.modules()
                   if isinstance(m, (Dropout, DropPath)) and m.rate > 0)
    assert rates == [("DropPath", 0.1), ("Dropout", 0.1)]
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8))
    box = torch.from_numpy(np.concatenate([rng.uniform(0.2, 0.8, (B, 6, 2)),
                                           rng.uniform(0.05, 0.3, (B, 6, 2))], -1)
                           .astype(np.float32))
    targets = Targets(torch.from_numpy(rng.integers(0, 3, (B, 6)).astype(np.float32)), box,
                      torch.ones(B, 6, dtype=torch.bool))
    return model, images, targets


def one_step(setup, remat, seed=5):
    """One Adam step from `setup`'s model; returns the grads (read before
    the optimizer), the state's tensors after it, and the generator's
    state."""
    model, images, targets = setup
    model = copy.deepcopy(model)
    model.remat = remat
    hyp = load_hyp("scratch")
    state = init_train_state(model, param_groups(model), 5e-4, adam=True)
    grads = {}
    by_param = {p: n for n, p in model.named_parameters()}

    def read_grads(opt, *_):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    grads[by_param[p]] = p.grad.clone()

    state.optimizer.register_step_pre_hook(read_grads)
    step = make_train_step(ComputeLoss(model.head.anchors, hyp, nc=3),
                           Schedule(hyp, epochs=10, steps_per_epoch=10, adam=True),
                           dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    metrics = step(state, images, targets, gen)
    return (grads, {k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.state_dict().items()}, gen.get_state(),
            float(metrics["loss"]))


def max_err(a, b):
    assert set(a) == set(b)
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


@pytest.fixture(scope="module")
def plain(setup):
    return one_step(setup, remat=False)


def test_remat_step_equals_the_plain_step(setup, plain):
    grads, model_sd, ema_sd, gen_state, loss = one_step(setup, remat=True)
    assert grads and max_err(grads, plain[0]) <= TOL
    assert max_err(model_sd, plain[1]) <= TOL  # weights and BN running statistics
    assert max_err(ema_sd, plain[2]) <= TOL
    assert torch.equal(gen_state, plain[3]) and abs(loss - plain[4]) <= TOL
    moved = [k for k in model_sd if k.endswith("running_mean")
             and not torch.equal(model_sd[k], setup[0].state_dict()[k])]
    assert moved  # the statistics did update (once)


def test_masks_were_drawn(setup, plain):
    """The lent generator drew (its state moved) and another seed gives
    another step: the check above would see wrong masks."""
    fresh = torch.Generator().manual_seed(5).get_state()
    assert not torch.equal(plain[3], fresh)
    other = one_step(setup, remat=False, seed=6)
    assert max_err(other[0], plain[0]) > 1e-4


def test_recompute_without_the_generator_restored_differs(setup, plain, monkeypatch):
    enter = primitives._Recompute.__enter__

    def no_restore(self):
        enter(self)
        if self.generator is not None:
            self.generator.set_state(self.after)  # draw on from where the forward left it

    monkeypatch.setattr(primitives._Recompute, "__enter__", no_restore)
    grads = one_step(setup, remat=True)[0]
    assert max_err(grads, plain[0]) > 1e-4


def test_recompute_updating_bn_statistics_differs(setup, plain, monkeypatch):
    enter = primitives._Recompute.__enter__

    def update_again(self):
        enter(self)
        for m in self.bns:
            m.recomputing = False

    monkeypatch.setattr(primitives._Recompute, "__enter__", update_again)
    model_sd = one_step(setup, remat=True)[1]
    stats = [k for k in model_sd if "running_" in k]
    assert max(float((model_sd[k] - plain[1][k]).abs().max()) for k in stats) > 1e-4


def test_remat_only_in_train_mode_with_grad(setup, monkeypatch):
    import dmayolo_tpu_torch.graph.model as gm

    model, images, _ = setup
    model = copy.deepcopy(model)
    model.remat = True
    x = images.float() / 255
    calls, real = [], gm.remat_layer

    def counting(layer, inp, dtype):
        calls.append(1)
        return real(layer, inp, dtype)

    monkeypatch.setattr(gm, "remat_layer", counting)
    with lend_generator(model, torch.Generator().manual_seed(0)):
        with torch.no_grad():
            model.eval()(x, torch.float32)
            model.train()(x, torch.float32)
        assert not calls
        model.train()(x, torch.float32)
    assert len(calls) == len(model.model)


def test_trainer_remat_option(setup, tmp_path):
    _, images, targets = setup
    b = Namespace(images=images.numpy(), targets=Targets(*(t.numpy() for t in targets)))
    tr = Trainer(CFG, [b, b], load_hyp("scratch"), nc=3, epochs=1, batch_size=B,
                 img_size=IMG, dtype=torch.float32, device="cpu", out_dir=str(tmp_path),
                 nosave=True, remat=True, accumulate=1)
    assert tr.model.remat and tr.state.model is tr.model
    tr.train()
    assert tr.state.step == 2
