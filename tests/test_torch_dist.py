"""The port's data parallelism (`parallel/mesh.py`) at world 2, over gloo in
two CPU processes, against one process on the whole batch and against the
JAX package on a 2-device mesh.

Every rank-side check runs in one launch of `parallel.mesh.spawn` (module
fixture `world2`, one torch thread a rank; `tests/torch_dist_ranks.py`),
while this process computes the references:

- the loader's process stripe reassembles JAX's global batches, and
  `process_shard_indices` partitions (as tests/test_multihost_io.py);
- BN's forward, backward and running statistics at one image a rank equal
  one process's (1e-5); the anchor loss and TAL's with ranks of different
  target counts, one with none: the ranks' totals and items sum to one
  process's, their gradients are its rows (1e-5);
- Dropout, DropPath and `device_aug` draw the global batch's numbers: each
  rank's masks, gains and flips are one process's rows, exactly;
- one f32 train step of test_train_step.py's tiny model at 64 px,
  accumulate 2 (one image a rank a microbatch), `device_aug` on, against
  JAX's `jit_train_step(mesh=make_mesh(n_data=2))` on the same weights and
  batch at test_torch_train_step.py's tolerances (loss and items 1e-4
  relative; parameters, BN statistics and EMA 1e-4 scaled by 1 + max |x|;
  the momentum buffers 3e-4), and, with random HSV gains and flips,
  with and without remat, against the port's own step in one process
  (1e-5);
- `run_validation(mesh=...)` over 6 images at batch 4 (the last batch's
  block of rank 1 is empty): P, R and mAP within 1e-6 of one process and of
  JAX's `run_validation(mesh=make_mesh(n_data=2))`, the COCO entries and
  the txt rows (rank 0's) as theirs;

then `cli.val --devices 2 --device cpu` against JAX's 2-device mesh, and
a rank that raises failing the launch at once.  Every launch's collectives
time out after `COLLECTIVE_TIMEOUT_S` (120 s).
"""
import concurrent.futures
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_ranks as ranks
from dmayolo_tpu.data.datasets import DetectionDataset as JaxDataset
from dmayolo_tpu.data.datasets import check_dataset as jax_check_dataset
from dmayolo_tpu.data.loader import DataLoader as JaxLoader
from dmayolo_tpu.data.synthetic import generate, generate_visdrone_analog
from dmayolo_tpu.eval.validator import run_validation as jax_run_validation
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.parallel import mesh as jmesh
from dmayolo_tpu.train import loss as jl
from dmayolo_tpu.train import optim as jo
from dmayolo_tpu.train import step as js
from dmayolo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dmayolo_tpu_torch.cli import val as pval
from dmayolo_tpu_torch.data.datasets import DetectionDataset
from dmayolo_tpu_torch.data.loader import DataLoader
from dmayolo_tpu_torch.parallel import mesh as pmesh
from dmayolo_tpu_torch.train.loss import Targets
from dmayolo_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_data_eval import SIZE, pseudo_label
from test_torch_model import random_vars, small_cfg
from torch_train_common import close_scaled, one_torch_thread  # noqa: F401

TIMEOUT = pmesh.COLLECTIVE_TIMEOUT_S  # 120 s a collective
METRICS = ("mp", "mr", "map50", "map75", "map")
# test_train_step.py's tiny model and hyp
HYP = {"box": 0.05, "obj": 1.0, "cls": 0.5, "cls_pw": 1.0, "obj_pw": 1.0, "anchor_t": 4.0,
       "label_smoothing": 0.0, "fl_gamma": 0.0, "lr0": 0.01, "lrf": 0.1, "momentum": 0.937,
       "weight_decay": 0.0005, "warmup_epochs": 3.0, "warmup_momentum": 0.8,
       "warmup_bias_lr": 0.1}
ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]]
TINY_CFG = {"nc": 4, "depth_multiple": 0.33, "width_multiple": 0.25, "anchors": ANCHORS,
            "backbone": [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]],
                         [-1, 1, "C3", [128]], [-1, 1, "Conv", [256, 3, 2]],
                         [-1, 1, "C3", [256]], [-1, 1, "Conv", [512, 3, 2]],
                         [-1, 1, "C3", [512]], [-1, 1, "SPPF", [512, 5]]],
            "head": [[[4, 6, 7], 1, "Detect", ["nc", "anchors"]]]}
IMG, ACC, BS = 64, 2, 4  # the step: 2 microbatches of 2, one image a rank each
# gains of 1 and every row flipped: HSV and the flip run, and the draws
# (jax.random against torch's generator) cannot differ
EXACT_AUG = {"hgain": 0.0, "sgain": 0.0, "vgain": 0.0, "fliplr": 1.0}
RANDOM_AUG = {"hgain": 0.015, "sgain": 0.7, "vgain": 0.4, "fliplr": 0.5}
SCHED = dict(epochs=3, steps_per_epoch=10, batch_size=BS, step_scale=ACC)
ONE = pmesh.Mesh(device=torch.device("cpu"))  # one process, no group


def _targets(rng, b, m, counts, nc=4):
    cls = rng.integers(0, nc, (b, m)).astype(np.float32)
    box = np.concatenate([rng.uniform(0.2, 0.8, (b, m, 2)), rng.uniform(0.05, 0.3, (b, m, 2))],
                         -1).astype(np.float32)
    mask = np.arange(m)[None] < np.asarray(counts)[:, None]
    return cls, box * mask[..., None], mask


def _cases(tmp):
    """The inputs of every rank-side check, and what this process needs
    for its references."""
    rng = np.random.default_rng(0)
    jm = JaxModel(TINY_CFG)
    params, stats = random_vars(jm, seed=1)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params, stats).items()}
    images = rng.integers(0, 256, (BS, IMG, IMG, 3), dtype=np.uint8)
    targets = _targets(rng, BS, 6, [3, 5, 0, 2])
    # ranks with different target counts, rank 1 with none
    loss_tg = _targets(rng, 4, 5, [3, 5, 0, 0])
    preds = [rng.normal(0, 1.5, (4, s, s, 3, 9)).astype(np.float32) for s in (8, 4, 2)]
    raw_tal = [rng.normal(0, 1.5, (4, s, s, 4 * 16 + 4)).astype(np.float32) for s in (8, 4, 2)]
    # the eval: the data-eval test's model on 6 pseudo-labelled images
    vjm = JaxModel(small_cfg())
    vparams, vstats = random_vars(vjm, seed=3)
    from dmayolo_tpu_torch.graph import DetectionModel

    vpm = DetectionModel(small_cfg(), device="cpu")
    vpm.load_state_dict(state_dict_from_jax(vparams, vstats), strict=True)
    generate_visdrone_analog(tmp, n_train=0, n_val=6, img_size=SIZE, seed=4, min_objects=10,
                             max_objects=30)
    pseudo_label(tmp, "val", vpm.eval())
    val_dir = str(tmp / "images" / "val")
    val_kw = dict(cfg=small_cfg(), state_dict=ranks.as_numpy_state(vpm), val_dir=val_dir,
                  img_size=SIZE, batch_size=4, dtype=torch.float32)
    step_kw = dict(cfg=TINY_CFG, state_dict=sd, hyp=HYP, images=images, targets=targets,
                   accumulate=ACC, sched_kw=dict(SCHED, weight_decay=HYP["weight_decay"]))
    cases = {
        "bn": ("bn_case", dict(x=rng.normal(0.3, 2.0, (2, 8, 5, 7)).astype(np.float32),
                               dy=rng.normal(0, 1, (2, 8, 5, 7)).astype(np.float32))),
        "anchor": ("loss_case", dict(kind="anchor", preds=preds, targets=loss_tg,
                                     anchors=np.asarray(jm.head.anchors), hyp=HYP, nc=4)),
        "tal": ("loss_case", dict(kind="tal", preds=raw_tal, targets=loss_tg,
                                  stride=[8.0, 16.0, 32.0], hyp={"cls_pw": 1.0}, nc=4)),
        "stochastic": ("stochastic_case", dict(shape=(4, 3, 5, 5), rate=0.4, seed=9)),
        "device_aug": ("device_aug_case", dict(images=images, seed=11)),
        "step_exact_aug": ("train_step_case", dict(step_kw, device_aug=EXACT_AUG)),
        "step_random_aug": ("train_step_case", dict(step_kw, device_aug=RANDOM_AUG)),
        "step_remat": ("train_step_case", dict(step_kw, device_aug=RANDOM_AUG, remat=True)),
        "val": ("validation_case", dict(val_kw, out_dir=str(tmp / "w2_txt"))),
        "trainer": ("trainer_case", dict(
            cfg=TINY_CFG, state_dict=sd, hyp=HYP, out_dir=str(tmp / "trainer"),
            batches=[(rng.integers(0, 256, (BS, IMG, IMG, 3), dtype=np.uint8),
                      _targets(rng, BS, 6, [2, 4, 0, 1])) for _ in range(4)])),
    }
    ref = dict(jm=jm, params=params, stats=stats, vjm=vjm, vparams=vparams, vstats=vstats,
               val_dir=val_dir, images=images, targets=targets)
    return cases, ref


def _jax_step(ref):
    """JAX's step on a 2-device mesh, as tests/test_train_step.py runs it."""
    jm = ref["jm"]
    sched = jo.Schedule(HYP, **SCHED)
    step = js.make_train_step(jm, jl.ComputeLoss(jm.head.anchors, HYP, nc=4), sched,
                              jo.param_groups(jm), HYP["weight_decay"], dtype=jnp.float32,
                              accumulate=ACC, device_aug=EXACT_AUG)
    mesh = jmesh.make_mesh(n_data=2)
    jstep = js.jit_train_step(step, mesh=mesh, donate=False)
    with mesh:
        state = jmesh.replicate_tree(mesh, js.init_train_state(ref["params"], ref["stats"]))
        imgs = jmesh.shard_batch(mesh, ref["images"])
        tg = jl.Targets(*(jax.device_put(jnp.asarray(t), NamedSharding(mesh, P("data")))
                          for t in ref["targets"]))
        state, metrics = jstep(state, imgs, tg, jax.random.PRNGKey(0))
    return jax.block_until_ready(state), {k: float(v) for k, v in metrics.items()}


def _cli_argv(tmp, ref):
    """`cli.val --devices 2 --device cpu` on the eval's model (a JAX
    checkpoint) and images."""
    cfg_path = tmp / "model.yaml"
    cfg_path.write_text(yaml.safe_dump(small_cfg()))
    ckpt = tmp / "best.npz"
    jax_save_checkpoint(ckpt, params=ref["vparams"], stats=ref["vstats"],
                        meta={"cfg": str(cfg_path), "nc": 10})
    data = tmp / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(tmp), "train": "images/val",
                                    "val": "images/val", "nc": 10,
                                    "names": [f"c{i}" for i in range(10)]}))
    return ["--weights", str(ckpt), "--data", str(data), "--imgsz", str(SIZE), "--batch-size",
            "4", "--fp32", "--no-fuse", "--save-json", "--save-txt", "--save-conf",
            "--project", str(tmp / "cli"), "--name", "w2", "--devices", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    cases, ref = _cases(tmp)
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        jax_step = ex.submit(_jax_step, ref)  # its compile, beside the rest
        launch = ex.submit(pmesh.spawn, ranks.rank_checks, 2, args=(cases,), device="cpu",
                           threads=1, timeout=TIMEOUT)
        cli = ex.submit(pval.main, _cli_argv(tmp, ref))  # a launch of its own
        # the references, while the ranks run
        w1_dirs = {"val": str(tmp / "w1_txt"), "trainer": str(tmp / "trainer_w1")}
        one = {name: getattr(ranks, fn)(ONE, **(dict(kw, out_dir=w1_dirs[name])
                                                if name in w1_dirs else kw))
               for name, (fn, kw) in cases.items()}
        jj = []
        jax_val = jax_run_validation(
            ref["vjm"], ref["vparams"], ref["vstats"], ref["val_dir"], img_size=SIZE,
            batch_size=4, dtype=jnp.float32, mesh=jmesh.make_mesh(n_data=2), save_json=jj)
        jax_state, jax_metrics = jax_step.result()
        got, cli_res = launch.result(), cli.result()
    return dict(got=got, one=one, jax_state=jax_state, jax_metrics=jax_metrics,
                jax_val=jax_val, jax_json=jj, tmp=tmp, ref=ref, cli=cli_res)


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# the mesh and the loader (this process only)
# ---------------------------------------------------------------------------

def test_process_shard_indices_partition():
    n, world = 103, 4
    seen = np.concatenate([pmesh.process_shard_indices(n, r, world) for r in range(world)])
    assert sorted(seen.tolist()) == list(range(n))
    for r in range(world):
        np.testing.assert_array_equal(pmesh.process_shard_indices(n, r, world),
                                      jmesh.process_shard_indices(n, r, world))
    np.testing.assert_array_equal(pmesh.process_shard_indices(7), np.arange(7))  # no group


def test_loader_local_slices_reassemble_jax_global_batch(tmp_path):
    """The ranks' rows of each batch are JAX's global batch's dataset
    indices in order (a short last batch wrap-padded with its own rows, as
    JAX's), and the bytes of the port's own batches at one process."""
    data = jax_check_dataset(generate(str(tmp_path / "shapes"), n_train=18, n_val=2,
                                      img_size=64))
    world, bs = 4, 8
    want = list(JaxLoader(JaxDataset(data["train"], img_size=64, augment=False), bs,
                          max_targets=8, shuffle=True, seed=7, workers=1, drop_last=False))
    ds = DetectionDataset(data["train"], img_size=64, augment=False)
    whole = list(DataLoader(ds, bs, max_targets=8, shuffle=True, seed=7, workers=1,
                            drop_last=False))
    views = [list(DataLoader(ds, bs, max_targets=8, shuffle=True, seed=7, workers=2,
                             drop_last=False, process_index=r, process_count=world))
             for r in range(world)]
    assert len(want) == len(whole) == 3 and all(len(v) == len(want) for v in views)
    for j, (w, one) in enumerate(zip(want, whole)):
        rows = [v[j] for v in views]
        assert all(len(r.indices) == bs // world for r in rows)
        idx = sum((r.indices for r in rows), [])
        n = len(w.indices)  # the last batch is short (2 of 8): its rows wrap round
        assert idx[:n] == list(w.indices) == list(one.indices)
        assert idx == np.resize(w.indices, bs).tolist()
        np.testing.assert_array_equal(np.concatenate([r.images for r in rows])[:n], one.images)
        for i in range(3):
            np.testing.assert_array_equal(np.concatenate([r.targets[i] for r in rows])[:n],
                                          one.targets[i])


def test_mesh_without_a_group():
    m = pmesh.make_mesh(device="cpu")
    assert (m.world, m.rank, m.distributed, m.is_main) == (1, 0, False, True)
    assert pmesh.with_group(m) is None and pmesh.with_group(None) is None
    x = torch.arange(24.0).reshape(6, 4)
    assert torch.equal(pmesh.gather_rows(m, x), x)
    assert torch.equal(pmesh.shard_batch(m, x, accumulate=2), x)
    assert torch.equal(pmesh.globalize_batch(m, x.numpy()), x)
    tg = pmesh.globalize_targets(m, Targets(x.numpy(), x.numpy(), x.numpy() > 3))
    assert isinstance(tg, Targets) and torch.equal(tg.mask, x > 3)
    # no group: nothing to split rows over (the split: tests/test_torch_spatial.py)
    assert torch.equal(pmesh.shard_batch(m, x[:, None, :, None], spatial=True),
                       x[:, None, :, None])
    assert (m.n_data, m.data_rank, m.spatial_rank, m.spatial, m.data) == (1, 0, 0, False, m)
    with pytest.raises(ValueError, match="n_spatial=2"):
        pmesh.make_mesh(n_spatial=2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        pmesh.make_mesh(n_data=2, device="cpu")
    # rank 1 of 2 takes its block of 2 rows of each of 2 microbatches of 4
    m2 = pmesh.Mesh(rank=1, world=2)
    np.testing.assert_array_equal(pmesh.local_rows(8, m2, accumulate=2), [2, 3, 6, 7])
    # rank 3 of a 2 x 2 layout: data rank 1, spatial rank 1, so the same rows
    # as rank 1 of 2, and the bottom rows of an image
    m4 = pmesh.Mesh(rank=3, world=4, n_spatial=2, spatial_group=object())
    assert (m4.n_data, m4.data_rank, m4.spatial_rank) == (2, 1, 1)
    np.testing.assert_array_equal(pmesh.local_rows(8, m4, accumulate=2), [2, 3, 6, 7])
    assert pmesh.image_rows(13, m4) == slice(7, 13)
    np.testing.assert_array_equal(pmesh.process_shard_indices(7, mesh=m4), [1, 3, 5])
    with pytest.raises(ValueError, match="split"):
        pmesh.local_rows(6, m2, accumulate=2)


# ---------------------------------------------------------------------------
# world 2 against one process
# ---------------------------------------------------------------------------

def test_bn_world2_equals_one_process(world2):
    got, one = [r["bn"] for r in world2["got"]], world2["one"]["bn"]
    for key in ("y", "dx"):
        _close(ranks.global_rows_of(got, key), one[key], 1e-5, key)
    for key in ("dw", "db"):  # each rank's own sums, which the step adds up
        _close(got[0][key] + got[1][key], one[key], 1e-5, key)
    for r in got:
        for key in ("running_mean", "running_var"):
            _close(r[key], one[key], 1e-6, key)


@pytest.mark.parametrize("kind", ["anchor", "tal"])
def test_loss_world2_equals_one_process(world2, kind):
    got, one = [r[kind] for r in world2["got"]], world2["one"][kind]
    assert one["total"] > 0
    _close(got[0]["total"] + got[1]["total"], one["total"], 1e-5, "total")
    for k, v in one["items"].items():
        _close(got[0]["items"][k] + got[1]["items"][k], v, 1e-5, k)
    for i, g in enumerate(one["grads"]):
        close_scaled(np.concatenate([r["grads"][i] for r in got]), g, 1e-5, (kind, i))


def test_draws_are_the_global_batch_rows(world2):
    got, one = world2["got"], world2["one"]
    for i in range(2):  # Dropout, DropPath
        np.testing.assert_array_equal(
            np.concatenate([r["stochastic"][i] for r in got]), one["stochastic"][i])
    x, flipped = one["device_aug"]
    np.testing.assert_array_equal(np.concatenate([r["device_aug"][0] for r in got]), x)
    np.testing.assert_array_equal(np.concatenate([r["device_aug"][1] for r in got]), flipped)
    assert 0 < flipped.sum() < len(flipped)


def _states_close(got, want, tol, opt_tol):
    for name, tree in want.items():
        assert set(got[name]) == set(tree), name
        for k, v in tree.items():
            close_scaled(got[name][k], v, opt_tol if name.startswith("opt") else tol, (name, k))


@pytest.mark.parametrize("case", ["step_random_aug", "step_remat"])
def test_train_step_world2_equals_one_process(world2, case):
    """Random HSV gains and flips (each row's are the one-process step's),
    and the same step with every layer recomputed in the backward (its BN
    collectives issued again, in the same order on each rank), against the
    plain step in one process."""
    want_m, want = world2["one"]["step_random_aug"]
    for got_m, got in (r[case] for r in world2["got"]):
        for k, v in want_m.items():
            assert abs(got_m[k] - v) <= 1e-5 * abs(v), k
        _states_close(got, want, 1e-5, 1e-5)


def test_trainer_world2_equals_one_process(world2):
    """`Trainer(mesh=...)` over an in-memory epoch of global batches (each
    rank takes its rows): one process's state, and only rank 0 writes."""
    want = world2["one"]["trainer"]
    assert want["step"] == 2 and {"last.npz", "results.csv"} <= set(want["files"])
    for r, got in enumerate(r["trainer"] for r in world2["got"]):
        assert got["step"] == want["step"]
        _states_close(got["trees"], want["trees"], 1e-5, 1e-5)
        assert got["files"] == (want["files"] if r == 0 else [])


def test_train_step_matches_jax_mesh(world2):
    jstate, jm = world2["jax_state"], world2["jax_metrics"]
    want = {"params": jstate.params, "stats": jstate.stats, "ema_params": jstate.ema_params,
            "ema_stats": jstate.ema_stats, "opt_mom": jstate.opt.mom, "opt_vel": jstate.opt.vel}
    want = {n: {k: np.asarray(v) for k, v in t.items()} for n, t in want.items()}
    for got_m, got in (r["step_exact_aug"] for r in world2["got"]):
        for k in ("loss", "box", "obj", "cls"):
            assert abs(got_m[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, got_m[k], jm[k])
        _states_close(got, want, 1e-4, 3e-4)
        for k, s in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k], s, rtol=1e-5, atol=1e-5, err_msg=str(k))
    assert int(jstate.opt.step) == 1


def _json_close(a, b):
    assert len(a) == len(b) > 0
    for e, f in zip(a, b):
        assert (e["image_id"], e["category_id"]) == (f["image_id"], f["category_id"])
        np.testing.assert_allclose(e["bbox"], f["bbox"], rtol=0, atol=2e-3)
        assert abs(e["score"] - f["score"]) <= 1e-4


def _txt(d):
    return {p.name: np.loadtxt(p, ndmin=2) for p in sorted(d.iterdir())}


def test_run_validation_world2(world2):
    one, jax_val = world2["one"]["val"], world2["jax_val"]
    assert one["res"].nt == jax_val.nt > 0 and 0.05 < one["res"].map50 < 1.0
    for r in world2["got"]:
        res = r["val"]["res"]
        assert res.nt == one["res"].nt
        for name in METRICS:
            assert abs(getattr(res, name) - getattr(one["res"], name)) <= 1e-6, name
            assert abs(getattr(res, name) - getattr(jax_val, name)) <= 1e-6, name
        _json_close(r["val"]["json"], one["json"])
        _json_close(r["val"]["json"], world2["jax_json"])
    tmp = world2["tmp"]
    a, b = _txt(tmp / "w2_txt"), _txt(tmp / "w1_txt")  # written by rank 0 alone
    assert list(a) == list(b) and len(a) == 6
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)


def test_cli_val_devices_2(world2):
    """`cli.val --devices 2 --device cpu` (run by the fixture, alongside the
    other launch): JAX's mesh result, rank 0's JSON and txt files."""
    res, jax_val, out = world2["cli"], world2["jax_val"], world2["tmp"] / "cli" / "w2"
    assert res.nt == jax_val.nt > 0
    for name in METRICS:
        assert abs(getattr(res, name) - getattr(jax_val, name)) <= 1e-6, name
    with open(out / "best_predictions.json") as f:
        _json_close(json.load(f), world2["jax_json"])
    a, b = _txt(out / "labels"), _txt(world2["tmp"] / "w1_txt")
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)


def test_a_failing_rank_fails_the_launch():
    t0 = time.perf_counter()
    with pytest.raises(pmesh.RankFailed, match="(?s)rank 1 of 2 raised.*on purpose"):
        pmesh.spawn(ranks.raise_on_rank_1, 2, device="cpu", threads=1, timeout=TIMEOUT)
    assert time.perf_counter() - t0 < TIMEOUT / 4  # at once, not at the timeout
