"""The blocked "matrix" NMS in one launch of K3's blocked entry, and the
cluster plan of K2 streaming, against the JAX package on the CPU.

`nms_matrix_blocked` now goes through `fixpoint_keep_blocked`, whose plain
version stops each image at `max_det` keepers.  Its `keep_idx` and
`keep_valid` must equal `dmayolo_tpu.core.nms.nms_matrix_blocked` (which
walks every block and takes the first `max_det` keepers by `lax.top_k`)
in every slot, wherever the stop falls.  `plan_stream`, the host side of
K2's cluster kernel, is pure arithmetic on the card's numbers.

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmayolo_tpu.core import nms as jnms
from dmayolo_tpu_torch.core import nms as tnms
from dmayolo_tpu_torch.core.fixpoint_kernel import (MAX_K, fixpoint_keep_blocked,
                                                    fixpoint_keep_blocked_plain,
                                                    fixpoint_keep_plain)
from dmayolo_tpu_torch.core.nms_kernel import (_CLUSTER_STATIC, NEG_INF, plan_stream,
                                               stream_smem)


def _candidates(kind: str, b: int, k: int, seed: int):
    """Rank-sorted candidates: boxes (b, k, 4), scores (b, k) descending
    with NEG_INF for dropped ones."""
    rng = np.random.default_rng(seed)
    if kind == "chain":  # each box overlaps its neighbours by 1/3
        i = np.arange(k, dtype=np.float32)
        boxes = np.broadcast_to(np.stack([i * 5, np.zeros(k), i * 5 + 10, np.full(k, 10.0)],
                                         -1), (b, k, 4))
        scores = np.broadcast_to(np.linspace(1, 0.5, k), (b, k))
        return boxes.astype(np.float32), scores.astype(np.float32)
    if kind == "clustered":  # near-duplicates around a few centres: few keepers
        centres = rng.uniform(50, 400, (b, 4, 2))
        pick = rng.integers(0, 4, (b, k))
        c = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 3, (b, k, 2))
        wh = rng.uniform(40, 60, (b, k, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    else:
        xy1 = rng.uniform(0, 500, (b, k, 2))
        boxes = np.concatenate([xy1, xy1 + rng.uniform(4, 150, (b, k, 2))], -1)
    scores = -np.sort(-rng.uniform(0.001, 1.0, (b, k)), axis=1)
    scores[scores < 0.3] = NEG_INF
    if kind == "masked_rows":
        scores[1:] = NEG_INF
    return boxes.astype(np.float32), scores.astype(np.float32)


# (kind, b, k, block, max_det, seed, where the max_det-th keeper falls)
BLOCKED_CASES = [
    ("random", 3, 700, 128, 20, 0, "first"),
    ("random", 3, 700, 128, 150, 1, "middle"),
    ("random", 3, 700, 128, 700, 2, "never"),      # ragged last block of 60
    ("clustered", 2, 1100, 512, 300, 3, "never"),  # every block walked, few keepers
    ("masked_rows", 3, 600, 256, 600, 4, "never"),
    ("chain", 1, 96, 32, 20, 5, "middle"),         # 1/3-overlap chain across blocks
    ("random", 2, 1100, 1024, 100, 6, "first"),    # a block above 512 runs as 512
]


@pytest.mark.parametrize("kind,b,k,block,max_det,seed,where", BLOCKED_CASES)
def test_nms_matrix_blocked_truncated_matches_jax(kind, b, k, block, max_det, seed, where):
    boxes, scores = _candidates(kind, b, k, seed)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    valid = ts > NEG_INF / 2
    thr = 0.3 if kind == "chain" else 0.45  # the chain's IoU is 1/3
    keep, walked, ki, kv = fixpoint_keep_blocked(tb, valid, thr, max_det, min(block, MAX_K))
    n_blocks = -(-k // min(block, MAX_K))
    live = valid.any(1)
    if where == "first":
        assert (walked[live] == 1).all()
    elif where == "middle":
        assert ((walked[live] > 1) & (walked[live] < n_blocks)).all()
    else:
        assert (walked == n_blocks).all() and (keep.sum(1) < max_det).all()
    assert (keep.sum(1) <= max_det).all() and not (keep & ~valid).any()

    got = tnms.nms_matrix_blocked(tb, ts, thr, max_det, block=block)
    want = jnms.nms_matrix_blocked(jnp.asarray(boxes), jnp.asarray(scores), thr, max_det,
                                   block=block)
    gi, gv = (t.numpy() for t in got)
    wi, wv = (np.asarray(a) for a in want)
    assert gi.dtype == np.int32 and gi.shape == wi.shape == (b, max_det)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)
    if kind == "masked_rows":
        assert not gv[1:].any()
    if kind == "chain":  # every second box of the chain, the first max_det of them
        np.testing.assert_array_equal(gi[0][gv[0]], np.arange(0, 2 * max_det, 2))


def test_blocked_plain_is_the_truncated_greedy_keep_set():
    """The blocked plain version's flags are the first max_det of the
    one-block fixpoint's, and it walks only the blocks it needs."""
    boxes, scores = _candidates("random", 4, 512, 7)
    tb, valid = torch.from_numpy(boxes), torch.from_numpy(scores) > NEG_INF / 2
    full = fixpoint_keep_plain(tb, valid, 0.45, divide=True)
    for max_det in (0, 1, 37, 512):
        keep, walked, *_ = fixpoint_keep_blocked_plain(tb, valid, 0.45, max_det, block=64)
        want = full & (full.cumsum(1) <= max_det)
        assert torch.equal(keep, want)
        # a block is walked while the image has fewer than max_det keepers
        before = torch.cat([torch.zeros(4, 1, dtype=torch.long),
                            want.cumsum(1)[:, 63:-1:64]], 1)
        assert torch.equal(walked, (before < max_det).sum(1).to(torch.int32))


# the H100's numbers: 132 SMs, 227 KB a block, and the clusters of each
# size it holds at once (cudaOccupancyMaxActiveClusters at K = 1025)
H100 = dict(n_sm=132, max_clusters={1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15},
            smem_bytes=232448)


@pytest.mark.parametrize("b,k", [(32, 1025), (32, 4096), (32, 30000), (2, 30000),
                                 (128, 2000), (1, 90000), (2, 100000), (32, 500000)])
def test_plan_stream_covers_k_and_fits_shared_memory(b, k):
    plan = plan_stream(b, k, **H100)
    capacity = (H100["smem_bytes"] - _CLUSTER_STATIC) // 20 * 8
    if k > capacity:
        assert plan is None  # the global-memory kernel's route
        return
    c, piece = plan
    assert 1 <= c <= 8
    assert c * piece >= k > (c - 1) * piece  # every candidate, no empty block
    assert stream_smem(k, c) == piece * 20 + -(-piece // 32) * 4
    assert stream_smem(k, c) + _CLUSTER_STATIC <= H100["smem_bytes"]
    if (b, k) == (32, 30000):  # the eval: 3 blocks an image, 96 SMs in one wave
        assert plan == (3, 10000)
    if b <= 2:  # a few images: the most blocks an image
        assert c == 8 or k <= 4096


def test_plan_stream_routes_by_capacity_and_raises_without_occupancy():
    assert plan_stream(2, 100000, **H100) is None
    small = dict(H100, smem_bytes=48 * 1024)
    assert plan_stream(32, 30000, **small) is None
    assert plan_stream(32, 4000, **small) == (2, 2000)
    with pytest.raises(RuntimeError):
        plan_stream(32, 30000, 132, {c: 0 for c in range(1, 9)}, H100["smem_bytes"])
    # a size whose clusters do not all fit at once pays for a second wave
    assert plan_stream(32, 30000, 132, {3: 31, 4: 30, 8: 15}, H100["smem_bytes"]) == (4, 7500)


def test_fixpoint_keep_blocked_rejects_bad_input():
    ok = torch.zeros(2, 8, 4), torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        fixpoint_keep_blocked(torch.zeros(2, 8, 3), ok[1], 0.5, 300)
    with pytest.raises(ValueError):
        fixpoint_keep_blocked(ok[0], torch.ones(2, 9, dtype=torch.bool), 0.5, 300)
    with pytest.raises(TypeError):
        fixpoint_keep_blocked(ok[0], torch.ones(2, 8), 0.5, 300)
    with pytest.raises(ValueError):
        fixpoint_keep_blocked(torch.zeros(2, 8, 4, device="meta"),
                              torch.ones(2, 8, dtype=torch.bool, device="meta"), 0.5, 300)
    with pytest.raises(ValueError):
        fixpoint_keep_blocked(ok[0], ok[1].to("meta"), 0.5, 300)
    for block in (0, MAX_K + 1):
        with pytest.raises(ValueError):
            fixpoint_keep_blocked(*ok, 0.5, 300, block)
    with pytest.raises(ValueError):
        fixpoint_keep_blocked(*ok, 0.5, -1)
    keep, walked, keep_idx, keep_valid = fixpoint_keep_blocked(*ok, 0.5, 300)
    assert keep.dtype == torch.bool and keep.shape == (2, 8)
    assert walked.dtype == torch.int32 and walked.tolist() == [1, 1]
    assert keep_idx.dtype == torch.int32 and keep_idx.shape == (2, 300)
    assert keep_idx[:, :8].tolist() == [list(range(8))] * 2 and not keep_idx[:, 8:].any()
    assert keep_valid[:, :8].all() and not keep_valid[:, 8:].any()
