"""The port's TAL path (`train/tal.py`) and the Trainer's `assignment="tal"`
against the JAX package, on the CPU.

Inputs are drawn from numpy seeds: a 64 px image's four TDetect levels
(strides 4-32, 340 cells), 2 images, 6 target rows each with padding rows.
The assigner's outputs must equal JAX's (labels and the foreground mask
exactly, boxes and scores within 1e-5), including the tie cases: a target
covering fewer than 10 cell centres, and one covering many whose
predictions miss it, so their metrics tie at exactly 0 and the top-k's
tie order decides which cells it takes.  ComputeLossTAL: total and items
within 1e-5 relative, every gradient within 1e-5 scaled by 1 + its
largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.train import loss as jl
from dmayolo_tpu.train import tal as jt
from dmayolo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from dmayolo_tpu_torch.graph import DetectionModel, model_config
from dmayolo_tpu_torch.nn.heads import make_anchor_points
from dmayolo_tpu_torch.train import tal as pt
from dmayolo_tpu_torch.train.loss import Targets
from dmayolo_tpu_torch.train.trainer import Batch, Trainer, load_hyp
from dmayolo_tpu_torch.utils.weights import load_jax_checkpoint

SHAPES = [(16, 16), (8, 8), (4, 4), (2, 2)]
STRIDES = [4.0, 8.0, 16.0, 32.0]
IMG, NC, B, M = 64, 10, 2, 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points():
    pts, st = make_anchor_points(SHAPES, STRIDES)
    return (pts * st).numpy()  # (A, 2) pixels


def assigner_inputs(seed, ties=False):
    """pd_scores (B, A, nc), pd_bboxes (B, A, 4) xyxy px, anc (A, 2) px,
    gt_labels (B, M), gt_bboxes (B, M, 4) xyxy px, mask (B, M).  With
    `ties`, image 0 has two targets: a 6 px box (a few cell centres inside)
    and a 40 x 32 px box in the top-left corner whose cells' predictions
    lie far outside it, every one but three: its top-k takes those three
    and seven of the cells whose metric is exactly 0, the lowest indices
    among them, which lie inside it (the first row of P2)."""
    rng = np.random.default_rng(seed)
    anc = _points()
    a = len(anc)
    scores = rng.uniform(0, 1, (B, a, NC)).astype(np.float32)
    ltrb = rng.uniform(2, 20, (B, a, 4))
    pd = np.concatenate([anc - ltrb[..., :2], anc + ltrb[..., 2:]], -1).astype(np.float32)
    xy = rng.uniform(8, 56, (B, M, 2))
    wh = rng.uniform(6, 40, (B, M, 2))
    gt = np.concatenate([xy - wh / 2, xy + wh / 2], -1).clip(0, IMG).astype(np.float32)
    labels = rng.integers(0, NC, (B, M)).astype(np.float32)
    mask = np.ones((B, M), bool)
    mask[1, 4:] = False
    gt[~mask] = 0.0
    if ties:
        mask[0, 2:] = False
        gt[0, 2:] = 0.0
        gt[0, 0] = [44, 44, 50, 50]
        gt[0, 1] = [0, 0, 40, 32]
        inside = (anc[:, 0] < 40) & (anc[:, 1] < 32)
        far = np.array([0, 0, 1, 1], np.float32)  # a 1 px box in the corner
        idx = np.flatnonzero(inside)
        pd[0, idx[3:]] = far
    return scores, pd, anc, labels, gt, mask


def _jax_assign(inputs, **kw):
    s, p, a, lab, g, m = inputs
    out = jt.TaskAlignedAssigner(topk=10, num_classes=NC, **kw)(
        jnp.asarray(s), jnp.asarray(p), jnp.asarray(a), jnp.asarray(lab), jnp.asarray(g),
        jnp.asarray(m))
    return [np.asarray(o) for o in out]


def _port_assign(inputs, **kw):
    s, p, a, lab, g, m = (torch.from_numpy(np.asarray(x)) for x in inputs)
    out = pt.TaskAlignedAssigner(topk=10, num_classes=NC, **kw)(s, p, a, lab, g, m)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True), (3, True)])
def test_assigner_matches_jax(seed, ties):
    inputs = assigner_inputs(seed, ties)
    want, got = _jax_assign(inputs), _port_assign(inputs)
    labels, boxes, scores, fg = got
    np.testing.assert_array_equal(fg, want[3])
    np.testing.assert_array_equal(labels, want[0])
    np.testing.assert_allclose(boxes, want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scores, want[2], rtol=1e-5, atol=1e-5)
    assert fg.any()
    if ties:
        # the 6 px target covers fewer than 10 cells; the large one takes 10,
        # seven of them picked by the tie order among zero metrics
        anc = inputs[2]
        for j, (x1, y1, x2, y2) in enumerate(inputs[4][0, :2]):
            inside = (anc[:, 0] > x1) & (anc[:, 0] < x2) & (anc[:, 1] > y1) & (anc[:, 1] < y2)
            assert (inside.sum() < 10) == (j == 0)
        assert (boxes[0][fg[0]] == inputs[4][0, 1]).all(-1).sum() == 10


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_mask_is_lax_top_k_set(seed):
    """Many ties (integers 0-3 and runs of zeros): the mask holds exactly
    the indices `jax.lax.top_k` returns, the lowest first among equals."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (3, 5, 50)).astype(np.float32)
    x[0, :, 10:] = 0.0
    _, idx = jax.lax.top_k(jnp.asarray(x), 10)
    want = np.zeros(x.shape, bool)
    np.put_along_axis(want, np.asarray(idx), True, axis=-1)
    np.testing.assert_array_equal(pt.topk_mask(torch.from_numpy(x), 10).numpy(), want)


def raw_and_targets(seed, b=B):
    rng = np.random.default_rng(seed)
    raw = [np.concatenate([rng.normal(0, 1.5, (b, ny, nx, 64)),
                           rng.normal(-1, 1.5, (b, ny, nx, NC))], -1).astype(np.float32)
           for ny, nx in SHAPES]
    cls = rng.integers(0, NC, (b, M)).astype(np.float32)
    box = np.concatenate([rng.uniform(0.2, 0.8, (b, M, 2)), rng.uniform(0.05, 0.5, (b, M, 2))],
                         -1).astype(np.float32)
    mask = np.ones((b, M), bool)
    mask[-1, 3:] = False
    return raw, (cls, box * mask[..., None], mask)


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_loss_tal_matches_jax(seed):
    raw, tg = raw_and_targets(seed)
    jloss = jt.ComputeLossTAL(STRIDES, nc=NC, hyp={"cls_pw": 1.0})

    def f(r):
        return jloss(r, jl.Targets(*(jnp.asarray(t) for t in tg)))

    (jtotal, jitems), jgrads = jax.value_and_grad(f, has_aux=True)([jnp.asarray(r) for r in raw])
    praw = [torch.tensor(r, requires_grad=True) for r in raw]
    ptotal, pitems = pt.ComputeLossTAL(STRIDES, nc=NC, hyp={"cls_pw": 1.0})(
        praw, Targets(*(torch.from_numpy(t) for t in tg)))
    ptotal.backward()
    assert set(pitems) == set(jitems) == {"box", "cls", "dfl"}
    np.testing.assert_allclose(float(ptotal.detach()), float(jtotal), rtol=1e-5)
    for k in jitems:
        assert float(pitems[k]) > 0
        np.testing.assert_allclose(float(pitems[k]), float(jitems[k]), rtol=1e-5)
    for g, w in zip(praw, jgrads):
        w = np.asarray(w)
        assert float(np.abs(g.grad.numpy() - w).max()) <= 1e-5 * (1 + float(np.abs(w).max()))


def test_compute_loss_tal_without_targets_is_finite():
    """A batch with no target at all: the score sum is exactly 0 and the
    loss divides by 1, as JAX's does."""
    raw, (cls, box, mask) = raw_and_targets(4)
    mask[:] = False
    tg = (cls, box * 0, mask)
    want = jt.ComputeLossTAL(STRIDES, nc=NC)([jnp.asarray(r) for r in raw],
                                             jl.Targets(*(jnp.asarray(t) for t in tg)))
    got = pt.ComputeLossTAL(STRIDES, nc=NC)([torch.from_numpy(r) for r in raw],
                                            Targets(*(torch.from_numpy(t) for t in tg)))
    assert float(got[1]["box"]) == float(got[1]["dfl"]) == 0.0
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)


def test_alpha_beta_from_arguments_then_environment(monkeypatch):
    monkeypatch.delenv("YA", raising=False)
    monkeypatch.delenv("YB", raising=False)
    a = pt.ComputeLossTAL(STRIDES, nc=NC).assigner
    assert (a.alpha, a.beta) == (0.5, 6.0)
    monkeypatch.setenv("YA", "0.7")
    monkeypatch.setenv("YB", "4")
    for mod in (pt, jt):
        a = mod.ComputeLossTAL(STRIDES, nc=NC).assigner
        assert (a.alpha, a.beta) == (0.7, 4.0)
        a = mod.ComputeLossTAL(STRIDES, nc=NC, alpha=1.0, beta=2.0).assigner
        assert (a.alpha, a.beta) == (1.0, 2.0)
    inputs = assigner_inputs(5)
    got, want = _port_assign(inputs, alpha=0.7, beta=4.0), _jax_assign(inputs, alpha=0.7, beta=4.0)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


def odrta_cfg():
    with open(model_config("CASPD_ODRTA")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(depth_multiple=0.33, width_multiple=0.125, nc=NC)
    return cfg


def test_trainer_tal_checkpoint_is_read_by_jax(tmp_path):
    """One Trainer epoch of two batches with assignment "tal": finite
    box, cls and dfl items in the CSV; `last.npz` has no anchors, and JAX's
    model on its trees gives the port's raw head on them within 1e-4; the
    run resumes."""
    rng = np.random.default_rng(0)
    loader = []
    for i in range(2):
        raw, tg = raw_and_targets(10 + i)
        loader.append(Batch(rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8), tg))
    kw = dict(nc=NC, epochs=1, batch_size=B, img_size=IMG, assignment="tal",
              dtype=torch.float32, device="cpu", accumulate=1)
    tr = Trainer(odrta_cfg(), loader, load_hyp("scratch"), out_dir=str(tmp_path), **kw)
    assert isinstance(tr.loss, pt.ComputeLossTAL)
    tr.train()
    state = tr.state
    assert state.step == 2
    header, row = (tmp_path / "results.csv").read_text().splitlines()[:2]
    assert {"train/box", "train/cls", "train/dfl", "train/loss"} <= set(header.split(","))
    assert all(np.isfinite(float(v)) for v in row.split(","))

    trees, meta = jax_load_checkpoint(tmp_path / "last.npz")
    assert "anchors" not in meta
    jm = JaxModel(odrta_cfg())
    x = rng.uniform(0, 1, (1, IMG, IMG, 3)).astype(np.float32)
    # the finished run's `last` is stripped: the EMA's trees as the model's
    want = jax.jit(jm.apply)({k: jnp.asarray(v, jnp.float32) for k, v in trees["params"].items()},
                             {k: jnp.asarray(v, jnp.float32) for k, v in trees["stats"].items()},
                             jnp.asarray(x))
    sd, _ = load_jax_checkpoint(tmp_path / "last.npz", device="cpu")
    pm = DetectionModel(odrta_cfg(), device="cpu")
    pm.load_state_dict(sd, strict=True)
    got = pm.apply(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)

    resumed = Trainer(odrta_cfg(), loader, load_hyp("scratch"), out_dir=str(tmp_path / "r"),
                      resume_from=str(tmp_path / "last.npz"), **dict(kw, epochs=2))
    assert resumed.start_epoch == 1


def test_trainer_assignment_must_fit_the_head(tmp_path):
    loader = [Batch(np.zeros((B, IMG, IMG, 3), np.uint8), raw_and_targets(0)[1])]
    kw = dict(nc=NC, epochs=1, batch_size=B, img_size=IMG, device="cpu", out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="Detect head"):
        Trainer(odrta_cfg(), loader, load_hyp("scratch"), assignment="anchor", **kw)
    with pytest.raises(ValueError, match="unknown assignment"):
        Trainer(odrta_cfg(), loader, load_hyp("scratch"), assignment="atss", **kw)
