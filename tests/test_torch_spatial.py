"""The port's spatial H-sharding (`parallel/spatial.py`) over gloo in CPU
processes, at 1 data x 2 spatial and at 2 data x 2 spatial, against one
process on the whole batch and against the JAX package's
`(data, spatial)` mesh on its 8-device CPU platform.

Each layout runs every rank-side check in one launch of
`parallel.mesh.spawn` (module fixture `runs`, one torch thread a rank;
`tests/torch_spatial_ranks.py`), while this process computes the
references:

- each op's spatial form and the adjoint of its collectives, at a height
  of 13 (uneven over 2): convs (k 3 s 1, k 3 s 2, the 6x6 s 2 p 2 stem,
  dilated, depthwise 7x7), max and average pools, the nearest upsample,
  `resize_nearest` and the bilinear resize back to the uneven height,
  space-to-depth, the zero pad, `gather_h`/`slice_h`, the global pools,
  CA in train mode, Dropout and DropPath (the global map's draws): output
  rows, input gradient rows and the parameters' gradients (summed over
  the ranks) against one process, and CA's BN statistics, `running_var`
  included;
- `make_infer_fn(spatial=True)` at f32 on the small flagship and on
  JAX's `tests/test_mesh_val.py` model: the raw head within 1e-5 and the
  detections of one process (in the same slots, boxes to an f32 rounding),
  and at 2 x 2 those of JAX's `make_infer_fn(mesh=make_mesh(n_data=2,
  n_spatial=2), spatial=True)` (test_torch_eval.py's match);
- TTA at 160 x 128, whose P5 rows (5, then 4 at the 0.83 and 0.67 scales)
  split unevenly, against one process and at 2 x 2 against JAX's spatial
  TTA;
- int8 on the plain K4 at 2 x 2: the head equal to one process's exactly
  on a model with no H reduction, and the flagship's within 1e-5;
- `run_validation(spatial=True)`: P, R and mAP of one process;
- the f32 train step (accumulate 2, `device_aug` on) against one process
  (chip_smoke.py's `TRAIN_F32_TOL`) and at 2 x 2 against JAX's
  `jit_train_step(spatial=True)` on a (2 data x 2 spatial) mesh (its loss
  and BN statistics; its gradients are off, so the state is held to JAX's
  one-device step); the small flagship's step (CA, SCConv, SPPFCSPC) and
  `Trainer(spatial=True)` over an in-memory epoch at 2 x 2;
- all 69 yamls at 1 x 2 (depth 0.33, width 0.125 where it builds, 128 px;
  test_torch_zoo_models.py's sizes for its families; weights drawn as
  `random_vars` draws them), the raw head within 1e-5 of one process, one
  case a yaml from one launch.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_spatial_ranks as sranks
from dmayolo_tpu.data.synthetic import generate_visdrone_analog
from dmayolo_tpu.eval.validator import make_infer_fn as jax_make_infer_fn
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.parallel import mesh as jmesh
from dmayolo_tpu.train import loss as jl
from dmayolo_tpu.train import optim as jo
from dmayolo_tpu.train import step as js
from dmayolo_tpu_torch.graph import DetectionModel
from dmayolo_tpu_torch.nn.quant import calibrate_act_scales
from dmayolo_tpu_torch.parallel import mesh as pmesh
from dmayolo_tpu_torch.utils.weights import state_dict_from_jax

from test_mesh_val import CFG as MESH_VAL_CFG
from test_torch_data_eval import SIZE, pseudo_label
from test_torch_dist import ACC, BS, EXACT_AUG, HYP, IMG, SCHED, TINY_CFG, _targets
from test_torch_model import _match_rows, random_vars, small_cfg
from test_torch_zoo_models import FAMILIES, ZOO, _cfg
from torch_train_common import close_scaled, one_torch_thread  # noqa: F401

TIMEOUT = pmesh.COLLECTIVE_TIMEOUT_S
LAYOUTS = {"1x2": 2, "2x2": 4}  # ranks of each layout; n_spatial 2
METRICS = ("mp", "mr", "map50", "map75", "map")
KW = dict(conf_thres=0.01, iou_thres=0.6, max_det=50, max_nms=512)  # test_mesh_val.py's
TTA_KW = dict(conf_thres=0.01, iou_thres=0.6, max_det=50, max_nms=2000)
STEP_SCHED = dict(SCHED, weight_decay=HYP["weight_decay"])


def _zoo(rng):
    """{yaml: (cfg, images)} of the sweep: each yaml at the narrowest of
    its width, 0.25 and 0.5 that builds (C3STR and HorNet need wider
    rows)."""
    models = {}
    for name in ZOO:
        depth, width, size = FAMILIES.get(name, (0.33, 0.125, 128))
        for w in (width, 0.25, 0.5):
            cfg = _cfg(name, depth=depth, width=w)
            try:
                DetectionModel(cfg, device="meta")
                break
            except Exception:  # too narrow for this yaml's blocks
                continue
        models[name] = (cfg, rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8))
    return models


def _cases(tmp):
    """The rank-side cases of each layout, and what the references need."""
    rng = np.random.default_rng(0)
    flag_jm = JaxModel(small_cfg())
    fp, fs = random_vars(flag_jm, seed=3)
    flag_sd = {k: v.numpy() for k, v in state_dict_from_jax(fp, fs).items()}
    mv_jm = JaxModel(dict(MESH_VAL_CFG), nc=3)
    mp, ms = random_vars(mv_jm, seed=5)
    mv_sd = {k: v.numpy() for k, v in state_dict_from_jax(mp, ms).items()}
    tiny_jm = JaxModel(TINY_CFG)
    tp, ts = random_vars(tiny_jm, seed=1)
    tiny_sd = {k: v.numpy() for k, v in state_dict_from_jax(tp, ts).items()}

    x_ops = rng.normal(0.2, 1.5, (2, 8, 13, 9)).astype(np.float32)
    img128 = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    img_tta = rng.integers(0, 256, (2, 160, 128, 3), dtype=np.uint8)
    step_imgs = rng.integers(0, 256, (BS, IMG, IMG, 3), dtype=np.uint8)
    step_tg = _targets(rng, BS, 6, [3, 5, 0, 2])
    flag_imgs = rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    flag_tg = _targets(rng, 2, 6, [4, 2], nc=10)

    # int8: the scales of one process's fused models
    int8 = {}
    for key, cfg, sd in (("int8_flag", small_cfg(), flag_sd),
                         ("int8_plain", dict(MESH_VAL_CFG), mv_sd)):
        m = sranks._model(cfg, sd).fuse()
        int8[key] = dict(cfg=cfg, state_dict=sd, images=img_tta, kw=KW, fused=True,
                         quant=calibrate_act_scales(m, [img_tta]))

    generate_visdrone_analog(tmp, n_train=0, n_val=6, img_size=SIZE, seed=4, min_objects=10,
                             max_objects=30)
    pseudo_label(tmp, "val", sranks._model(small_cfg(), flag_sd))
    val_kw = dict(cfg=small_cfg(), state_dict=flag_sd, val_dir=str(tmp / "images" / "val"),
                  img_size=SIZE, batch_size=4, dtype=torch.float32)
    tiny_step = dict(cfg=TINY_CFG, state_dict=tiny_sd, hyp=HYP, images=step_imgs,
                     targets=step_tg, accumulate=ACC, sched_kw=STEP_SCHED,
                     device_aug=EXACT_AUG)
    trainer = dict(cfg=TINY_CFG, state_dict=tiny_sd, hyp=HYP, out_dir=str(tmp / "trainer"),
                   batches=[(rng.integers(0, 256, (BS, IMG, IMG, 3), dtype=np.uint8),
                             _targets(rng, BS, 6, [2, 4, 0, 1])) for _ in range(4)])
    common = {
        "ops": ("ops_case", dict(x=x_ops)),
        "infer_flag": ("infer_case", dict(cfg=small_cfg(), state_dict=flag_sd, images=img128,
                                          kw=KW)),
        "infer_meshval": ("infer_case", dict(cfg=dict(MESH_VAL_CFG), state_dict=mv_sd,
                                             images=img128, kw=KW)),
        "tta": ("infer_case", dict(cfg=small_cfg(), state_dict=flag_sd, images=img_tta,
                                   kw=TTA_KW, augment=True)),
        "val": ("validation_case", val_kw),
        "step_tiny": ("train_step_case", tiny_step),
    }
    models = _zoo(rng)
    cases = {  # the sweep in the 1 x 2 launch, int8 and the flagship's step in the 2 x 2
        "1x2": dict(common, zoo=("zoo_case", dict(models=models))),
        "2x2": dict(common, **{k: ("infer_case", v) for k, v in int8.items()},
                    trainer=("trainer_case", trainer),
                    step_flag=("train_step_case", dict(
                        cfg=small_cfg(), state_dict=flag_sd, hyp=HYP, images=flag_imgs,
                        targets=flag_tg, accumulate=1, sched_kw=dict(STEP_SCHED, batch_size=2,
                                                                      step_scale=1)))),
    }
    ref = dict(flag=(flag_jm, fp, fs), meshval=(mv_jm, mp, ms), tiny=(tiny_jm, tp, ts),
               img128=img128, img_tta=img_tta, step_imgs=step_imgs, step_tg=step_tg)
    return cases, ref


def _jax_infer(ref, key):
    """JAX's spatial `make_infer_fn` on a (2 data x 2 spatial) mesh: "tta"
    is the small flagship's TTA on the 160 x 128 images."""
    tta = key == "tta"
    jm, params, stats = ref["flag" if tta else key]
    mesh = jmesh.make_mesh(n_data=2, n_spatial=2)
    with mesh:
        infer = jax_make_infer_fn(jm, params, stats, dtype=jnp.float32, mesh=mesh,
                                  spatial=True, augment=tta, **(TTA_KW if tta else KW))
        dets, valid = infer(jnp.asarray(ref["img_tta" if tta else "img128"]))
    return np.asarray(dets), np.asarray(valid)


def _jax_step(ref, spatial):
    """JAX's step on a (2 data x 2 spatial) mesh with `spatial`, else on
    one device (which its data-parallel mesh equals exactly)."""
    jm, params, stats = ref["tiny"]
    sched = jo.Schedule(HYP, **SCHED)
    step = js.make_train_step(jm, jl.ComputeLoss(jm.head.anchors, HYP, nc=4), sched,
                              jo.param_groups(jm), HYP["weight_decay"], dtype=jnp.float32,
                              accumulate=ACC, device_aug=EXACT_AUG)
    if spatial:
        mesh = jmesh.make_mesh(n_data=2, n_spatial=2)
        jstep = js.jit_train_step(step, mesh=mesh, spatial=True, donate=False)
        with mesh:
            state = jmesh.replicate_tree(mesh, js.init_train_state(params, stats))
            imgs = jmesh.shard_batch(mesh, ref["step_imgs"], spatial=True)
            tg = jl.Targets(*(jax.device_put(jnp.asarray(t), NamedSharding(mesh, P("data")))
                              for t in ref["step_tg"]))
            state, metrics = jstep(state, imgs, tg, jax.random.PRNGKey(0))
    else:
        state, metrics = jax.jit(step)(js.init_train_state(params, stats),
                                       jnp.asarray(ref["step_imgs"]),
                                       jl.Targets(*(jnp.asarray(t) for t in ref["step_tg"])),
                                       jax.random.PRNGKey(0))
    state = jax.block_until_ready(state)
    trees = {"params": state.params, "stats": state.stats, "ema_params": state.ema_params,
             "ema_stats": state.ema_stats, "opt_mom": state.opt.mom, "opt_vel": state.opt.vel}
    return ({k: float(v) for k, v in metrics.items()},
            {n: {k: np.asarray(v) for k, v in t.items()} for n, t in trees.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    cases, ref = _cases(tmp)
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        launches = {name: ex.submit(pmesh.spawn, sranks.rank_checks, world, args=(2, cases[name]),
                                    device="cpu", threads=1, timeout=TIMEOUT)
                    for name, world in LAYOUTS.items()}
        jax_steps = {k: ex.submit(_jax_step, ref, k == "spatial_step")
                     for k in ("spatial_step", "step")}
        jax_infer = {k: ex.submit(_jax_infer, ref, k) for k in ("flag", "meshval", "tta")}
        one = sranks.one_process(dict(cases["1x2"], **cases["2x2"]))
        got = {name: f.result() for name, f in launches.items()}
        jx = {k: f.result() for k, f in dict(jax_steps, **jax_infer).items()}
    return dict(got=got, one=one, jax=jx)


def _rows(results, key, world, n_spatial=2, case="ops", op=None):
    """The ranks' (data rows, H rows) of an NCHW result put back together."""
    out = []
    for d in range(world // n_spatial):
        parts = [results[d * n_spatial + s][case] for s in range(n_spatial)]
        if op is not None:
            parts = [p[op] for p in parts]
        out.append(np.concatenate([p[key] for p in parts], 2))
    return np.concatenate(out, 0)


# ---------------------------------------------------------------------------
# the collectives' forward and adjoint, op by op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", sranks.OPS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_op_and_its_adjoint_equal_one_process(runs, layout, op):
    got, want = runs["got"][layout], runs["one"]["ops"][op]
    world = LAYOUTS[layout]
    close_scaled(_rows(got, "y", world, op=op), want["y"], 1e-6, "y")
    close_scaled(_rows(got, "dx", world, op=op), want["dx"], 1e-6, "dx")
    for k, g in want.get("grads", {}).items():  # each rank's share; the step sums them
        close_scaled(sum(r["ops"][op]["grads"][k] for r in got), g, 1e-6, k)
    for k, b in want.get("buffers", {}).items():  # CA's BN: the whole batch's statistics
        for r in got:
            np.testing.assert_allclose(r["ops"][op]["buffers"][k], b, rtol=1e-6, atol=1e-7,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def _dets_close(got, want_dets, want_valid):
    """The same detections in the same slots: boxes to 1e-5 or an f32
    rounding of their pixel coordinates, scores to 1e-5, classes equal."""
    np.testing.assert_array_equal(got["valid"], want_valid)
    np.testing.assert_allclose(got["dets"], want_dets, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", ["infer_flag", "infer_meshval", "tta"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_infer_equals_one_process(runs, layout, case):
    """The detections of the global batch on every rank, and each data
    rank's raw head (whole along H) as one process's rows."""
    got, want = runs["got"][layout], runs["one"][case]
    assert want["valid"].sum() > 0
    n_data = LAYOUTS[layout] // 2
    b = len(want["dets"]) // n_data
    for rank, r in enumerate(got):
        _dets_close(r[case], want["dets"], want["valid"])
        d = rank // 2
        for lev, (g, w) in enumerate(zip(r[case]["raw"], want["raw"])):
            np.testing.assert_allclose(g, w[d * b:(d + 1) * b], rtol=0, atol=1e-5,
                                       err_msg=str(lev))
        assert r[case]["exchanges"] > 0 and want["exchanges"] == 0


@pytest.mark.parametrize("case,key", [("infer_flag", "flag"), ("infer_meshval", "meshval"),
                                      ("tta", "tta")])
def test_infer_matches_jax_spatial_mesh(runs, case, key):
    """2 x 2 against JAX's `make_infer_fn(spatial=True)` on a (2 data x 2
    spatial) mesh of its CPU platform; TTA at 160 x 128 too."""
    dets, valid = runs["jax"][key]
    assert valid.sum() > 0
    for r in runs["got"]["2x2"]:
        for b in range(len(dets)):  # test_torch_eval.py's match against JAX
            _match_rows(dets[b][valid[b]], r[case]["dets"][b][r[case]["valid"][b]])


@pytest.mark.parametrize("case", ["int8_flag", "int8_plain"])
def test_int8_equals_one_process(runs, case):
    """int8 on the plain K4 at 2 x 2: one process's detections and raw
    head; with no reduction along H (test_mesh_val.py's model) the int8
    head is bit-equal (the s32 sums are exact, and so is every op between
    the convs)."""
    want = runs["one"][case]
    assert want["valid"].sum() > 0
    for rank, r in enumerate(runs["got"]["2x2"]):
        _dets_close(r[case], want["dets"], want["valid"])
        d = rank // 2
        for g, w in zip(r[case]["raw"], want["raw"]):
            w = w[d:d + 1]  # one image a data rank
            if case == "int8_plain":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_run_validation_equals_one_process(runs, layout):
    want = runs["one"]["val"]
    assert want.nt > 0 and 0.05 < want.map50 < 1.0
    for r in runs["got"][layout]:
        assert r["val"].nt == want.nt
        for name in METRICS:
            assert abs(getattr(r["val"], name) - getattr(want, name)) <= 1e-6, name


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _states_close(got, want, tol, opt_tol):
    for name, tree in want.items():
        assert set(got[name]) == set(tree), name
        for k, v in tree.items():
            close_scaled(got[name][k], v, opt_tol if name.startswith("opt") else tol, (name, k))


@pytest.mark.parametrize("layout,case", [("1x2", "step_tiny"), ("2x2", "step_tiny"),
                                         ("2x2", "step_flag")])
def test_train_step_equals_one_process(runs, layout, case):
    """Within chip_smoke.py's `TRAIN_F32_TOL`: the loss and items 1e-4
    relative, the parameters, EMA and BN statistics 1e-5 and the optimizer
    moments (the gradients) 1e-3, scaled by 1 + max |x|."""
    want_m, want = runs["one"][case]
    for got_m, got in (r[case] for r in runs["got"][layout]):
        for k, v in want_m.items():
            assert abs(got_m[k] - v) <= 1e-4 * abs(v), k
        _states_close(got, want, 1e-5, 1e-3)


def test_trainer_equals_one_process(runs):
    """`Trainer(mesh=make_mesh(2, 2), spatial=True)` over an in-memory
    epoch of global batches: one process's state after its two optimizer
    steps."""
    want = runs["one"]["trainer"]
    assert want["step"] == 2
    for got in (r["trainer"] for r in runs["got"]["2x2"]):
        assert got["step"] == want["step"]
        _states_close(got["trees"], want["trees"], 1e-5, 1e-3)


def test_train_step_matches_jax_spatial_step(runs):
    """2 x 2 against JAX's `jit_train_step(spatial=True)` on a (2 data x
    2 spatial) mesh: its loss, items and BN statistics (the forward).  Its
    gradients are not the global step's on the JAX CPU platform (the k > 1
    convs' momentum buffers up to 0.28 scaled from its own one-device and
    data-parallel steps, which agree exactly; ROADMAP.md, Queue 3), so the
    parameters and the optimizer state are held to JAX's one-device step
    on the same global batch, at test_torch_dist.py's tolerances."""
    jm, spatial_trees = runs["jax"]["spatial_step"]
    _, want = runs["jax"]["step"]
    for got_m, got in (r["step_tiny"] for r in runs["got"]["2x2"]):
        for k in ("loss", "box", "obj", "cls"):
            assert abs(got_m[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, got_m[k], jm[k])
        for k, s in spatial_trees["stats"].items():
            np.testing.assert_allclose(got["stats"][k], s, rtol=1e-5, atol=1e-5, err_msg=str(k))
        _states_close(got, want, 1e-4, 3e-4)


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_every_yaml_runs_split(runs, name):
    """The raw head at 1 x 2 within 1e-5 (scaled by 1 + max |x|) of one
    process's, each level varying over its cells (the input reaches it)."""
    got = [r["zoo"][name] for r in runs["got"]["1x2"]]
    want = runs["one"]["zoo"][name]
    for w in want:
        assert w.reshape(w.shape[0], w.shape[1] * w.shape[2], -1).std(1).mean() > 1e-4
    for g in got:
        for lev, (a, b) in enumerate(zip(g, want)):
            close_scaled(a, b, 1e-5, f"{name} level {lev}")
