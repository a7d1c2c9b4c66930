"""Greedy-NMS keep flags by the suppression DAG: the CUDA kernel K3, its
blocked entry, and their plain versions.

Port of `experiments/exp_pallas_fixpoint.py::pallas_fixpoint_keep`, the
kernel form of the "matrix" NMS backend (`core/nms.py::nms_matrix`).  For
rank-sorted candidates, candidate j is kept when no kept candidate i < j
overlaps it; the map T(k)_j = NOT any_{i<j} S_ij k_i is antitone, so
iterating it from both sides brackets the greedy answer and meets it in
as many steps as the longest suppression chain.

Two comparison forms, as in the JAX package:
  * `_fixpoint_keep(_pairwise_iou(b, b), ...)`: iou = inter / union > t
    (the blocked path, `nms_matrix_blocked`);
  * `_fixpoint_keep_boxes`: inter > t * union, divide-free
    (`nms_matrix`, K <= 512).
They agree except on pairs exactly at the threshold; each call site keeps
its own form, so both stay exact against the JAX package.

Two entries of one kernel source (`csrc/nms_fixpoint.cu`), each launching
it for CUDA tensors and taking its plain version only for CPU tensors:
  * `fixpoint_keep`: one block of K <= 512 candidates an image;
  * `fixpoint_keep_blocked`: any K, `nms_matrix_blocked`'s block loop in
    one launch (the per-block keep flags, then the keepers' suppression
    of later blocks), stopping at `max_det` keepers.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import load_library
from .nms_kernel import NEG_INF

MAX_K = 512  # the kernel's block of candidates, the block size of both "matrix" forms


def _pairwise_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) xyxy -> (..., M, N) IoU."""
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    ix1 = torch.maximum(b1[..., :, None, 0], b2[..., None, :, 0])
    iy1 = torch.maximum(b1[..., :, None, 1], b2[..., None, :, 1])
    ix2 = torch.minimum(b1[..., :, None, 2], b2[..., None, :, 2])
    iy2 = torch.minimum(b1[..., :, None, 3], b2[..., None, :, 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    return inter / (a1[..., :, None] + a2[..., None, :] - inter + 1e-7)


def _suppression_matrix(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_thres: float) -> torch.Tensor:
    """(B, K, K) 0/1 f32 S_ij = i suppresses j, by the divide-free test
    inter > t * union, straight from the boxes."""
    a1 = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    ix1 = torch.maximum(boxes[..., :, None, 0], boxes[..., None, :, 0])
    iy1 = torch.maximum(boxes[..., :, None, 1], boxes[..., None, :, 1])
    ix2 = torch.minimum(boxes[..., :, None, 2], boxes[..., None, :, 2])
    iy2 = torch.minimum(boxes[..., :, None, 3], boxes[..., None, :, 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = a1[..., :, None] + a1[..., None, :] - inter + 1e-7
    return _rank_valid(inter > iou_thres * union, valid)


def _rank_valid(test: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """S = test & (i < j) & valid_i, as 0/1 f32: its matvecs sum at most
    K ones, exact in f32."""
    rank = torch.arange(test.shape[-1], device=test.device)
    return (test & (rank[None, :, None] < rank[None, None, :])
            & valid[:, :, None]).float()


def _fixpoint(S: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The bracket iteration on a (B, K, K) suppression matrix."""
    k = S.shape[-1]

    def T(kvec):
        sup = torch.einsum("bij,bi->bj", S, kvec.float())
        return (sup < 0.5) & valid

    lo = T(valid)  # one step from all-true: the lower bracket
    hi = T(lo)     # the upper bracket
    i = 0
    while i < k and bool((lo != hi).any()):
        # T is antitone: T(hi) refines lo upward, T(lo) refines hi
        # downward; one stacked matvec advances both
        sup = torch.einsum("bij,bik->bjk", S, torch.stack([hi, lo], -1).float())
        lo, hi = (sup[..., 0] < 0.5) & valid, (sup[..., 1] < 0.5) & valid
        i += 1
    return lo  # == hi at the fixpoint


def _fixpoint_keep(iou: torch.Tensor, valid: torch.Tensor,
                   iou_thres: float) -> torch.Tensor:
    """Greedy keep flags (B, K) from a dense (B, K, K) IoU of rank-sorted
    candidates and their liveness (B, K)."""
    return _fixpoint(_rank_valid(iou > iou_thres, valid), valid)


def _fixpoint_keep_boxes(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_thres: float) -> torch.Tensor:
    """`_fixpoint_keep` with S built from the boxes by the divide-free test."""
    return _fixpoint(_suppression_matrix(boxes, valid, iou_thres), valid)


def fixpoint_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_thres: float, divide: bool) -> torch.Tensor:
    """The kernel's function in tensor ops, in the form `divide` names."""
    if divide:
        return _fixpoint_keep(_pairwise_iou(boxes, boxes), valid, iou_thres)
    return _fixpoint_keep_boxes(boxes, valid, iou_thres)


def _suppressed_by(bboxes, keep_blk, tail, iou_thres: float):
    """(B, T) bool: tail candidates whose IoU with a kept box of the block
    is above the threshold.  The kept boxes are gathered to the front
    (the rest masked), so the IoU has max-keepers rows, not C."""
    n = int(keep_blk.sum(1).max())
    if n == 0:
        return torch.zeros(tail.shape[:2], dtype=torch.bool, device=tail.device)
    order = torch.sort(keep_blk.to(torch.uint8), dim=1, descending=True, stable=True)
    rows = order.indices[:, :n]
    kept = torch.gather(bboxes, 1, rows[..., None].expand(-1, -1, 4))
    kmask = order.values[:, :n].bool()
    return ((_pairwise_iou(kept, tail) > iou_thres) & kmask[..., None]).any(1)


def _blocked_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                   max_det: int, block: int):
    """`fixpoint_keep_blocked_plain`, plus the candidates found alive
    (valid, not suppressed by an earlier block's keeper) in the blocks
    walked: what the kernel tests, for counting its work."""
    b, k, _ = boxes.shape
    keep = torch.zeros((b, k), dtype=torch.bool, device=boxes.device)
    alive_all = torch.zeros_like(keep)
    suppressed = torch.zeros_like(keep)
    count = torch.zeros(b, dtype=torch.long, device=boxes.device)
    walked = torch.zeros(b, dtype=torch.int32, device=boxes.device)
    for start in range(0, k, block):
        active = count < max_det
        if not bool(active.any()):
            break
        end = min(start + block, k)
        bboxes = boxes[:, start:end]
        alive = valid[:, start:end] & ~suppressed[:, start:end] & active[:, None]
        keep_blk = fixpoint_keep_plain(bboxes, alive, iou_thres, divide=True)
        # only the first max_det keepers of an image count; later ones drop
        keep_blk &= keep_blk.cumsum(1) <= (max_det - count)[:, None]
        keep[:, start:end] = keep_blk
        alive_all[:, start:end] = alive
        walked += active.to(torch.int32)
        count += keep_blk.sum(1)
        if end < k:
            suppressed[:, end:] |= _suppressed_by(bboxes, keep_blk, boxes[:, end:], iou_thres)
    return keep, walked, alive_all


def _keep_to_idx(keep: torch.Tensor, scores: torch.Tensor, max_det: int):
    """Keep flags -> (keep_idx, keep_valid) of width max_det: the kept
    candidates by descending score, the lowest index first among equal
    scores (as `lax.top_k`; `torch.topk` promises no order among ties),
    then the others in ascending order, then 0 past K."""
    keep_scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    kk = min(max_det, keep_scores.shape[1])
    top_scores, keep_idx = torch.sort(keep_scores, dim=1, descending=True, stable=True)
    top_scores, keep_idx = top_scores[:, :kk], keep_idx[:, :kk]
    if kk < max_det:  # K < max_det: pad to the fixed width
        pad = max_det - kk
        keep_idx = torch.nn.functional.pad(keep_idx, (0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=NEG_INF)
    return keep_idx.to(torch.int32), top_scores > NEG_INF / 2


def fixpoint_keep_blocked_plain(boxes: torch.Tensor, valid: torch.Tensor,
                                iou_thres: float, max_det: int, block: int = MAX_K):
    """The blocked kernel's function in tensor ops: `nms_matrix_blocked`'s
    loop (per block, the divide-form fixpoint of the candidates still
    alive, then the block's keepers suppress later blocks), truncated at
    max_det keepers an image.  Returns (keep (B, K) bool, walked (B,)
    int32, the blocks walked before max_det keepers, keep_idx (B, max_det)
    int32, keep_valid (B, max_det) bool), as `fixpoint_keep_blocked`."""
    keep, walked, _ = _blocked_plain(boxes, valid, iou_thres, max_det, block)
    # the keepers in index order: _keep_to_idx with every keeper at one score
    return (keep, walked, *_keep_to_idx(keep, torch.ones_like(keep, dtype=torch.float32),
                                        max_det))


def _lib():
    lib = load_library("nms_fixpoint")
    if lib.nms_fixpoint_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.nms_fixpoint_launch.argtypes = [ptr, ptr, i32, i32, ctypes.c_float, i32,
                                            ptr, ptr]
        lib.nms_fixpoint_blocked_launch.argtypes = [ptr, ptr, i32, i32, i32, i32,
                                                    ctypes.c_float, ptr, ptr, ptr, ptr, ptr,
                                                    ptr, ptr]
        lib.nms_fixpoint_launch.restype = lib.nms_fixpoint_blocked_launch.restype = i32
        lib.nms_fixpoint_shared_list_max.argtypes = []
        lib.nms_fixpoint_shared_list_max.restype = i32
        lib.shared_list_max = lib.nms_fixpoint_shared_list_max()
    return lib


def _check(name: str, boxes: torch.Tensor, valid: torch.Tensor) -> bool:
    """Shape, type and device checks; True when the plain version should
    run (a CPU tensor)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"expected boxes (B, K, 4) and valid (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"{name} takes a bool valid mask")
    if boxes.device != valid.device:
        raise ValueError("boxes and valid must be on one device")
    if boxes.device.type == "cpu":
        return True
    if boxes.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {boxes.device}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 boxes")
    return False


def _aligned(boxes: torch.Tensor) -> torch.Tensor:
    boxes = boxes.contiguous()
    return boxes.clone() if boxes.data_ptr() % 16 else boxes  # one float4 a box


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def fixpoint_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                  divide: bool = False) -> torch.Tensor:
    """Greedy-NMS keep flags of rank-sorted candidates.

    Args:
        boxes: (B, K, 4) f32 xyxy, sorted by score, class offset applied.
        valid: (B, K) bool candidate liveness.
        divide: compare inter / union > t (True) or inter > t * union.
    Returns keep (B, K) bool.  A CPU tensor goes through
    `fixpoint_keep_plain`; a CUDA tensor launches the kernel, or raises."""
    if _check("fixpoint_keep", boxes, valid):
        return fixpoint_keep_plain(boxes, valid, iou_thres, divide)
    b, k, _ = boxes.shape
    if not 0 < k <= MAX_K:
        raise ValueError(f"fixpoint_keep takes 1 to {MAX_K} candidates per "
                         f"image, got K={k}")
    boxes, valid = _aligned(boxes), valid.contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return keep
    fn = _lib().nms_fixpoint_launch
    with torch.cuda.device(boxes.device):
        rc = fn(boxes.data_ptr(), valid.data_ptr(), b, k, float(iou_thres),
                int(divide), keep.data_ptr(), _stream(boxes.device))
    if rc != 0:
        raise RuntimeError(f"fixpoint_keep kernel launch failed: CUDA error {rc}")
    fixpoint_keep.launches += 1
    return keep


def fixpoint_keep_blocked(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                          max_det: int, block: int = MAX_K):
    """Greedy-NMS keep flags of any number of rank-sorted candidates, in
    blocks of `block` (1 to 512), divide form, up to the first `max_det`
    keepers an image; later flags are False.

    Args as `fixpoint_keep`, plus `max_det` >= 0.  Returns (keep (B, K)
    bool, walked (B,) int32, the blocks walked an image, keep_idx (B,
    max_det) int32, keep_valid (B, max_det) bool): the keepers in index
    order, then the other indices ascending, which for rank-sorted
    candidates is `nms_matrix_blocked`'s output.  A CPU tensor goes through
    `fixpoint_keep_blocked_plain`; a CUDA tensor launches the kernel once,
    with no host sync, or raises."""
    if not 0 < block <= MAX_K:
        raise ValueError(f"fixpoint_keep_blocked takes blocks of 1 to {MAX_K} "
                         f"candidates, got {block}")
    if max_det < 0:
        raise ValueError(f"max_det must be >= 0, got {max_det}")
    if _check("fixpoint_keep_blocked", boxes, valid):
        return fixpoint_keep_blocked_plain(boxes, valid, iou_thres, max_det, block)
    b, k, _ = boxes.shape
    dev = boxes.device
    if b == 0 or k == 0:
        return fixpoint_keep_blocked_plain(boxes, valid, iou_thres, max_det, block)
    # the kernel writes every flag and slot
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    walked = torch.empty(b, dtype=torch.int32, device=dev)
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=dev)
    keep_valid = torch.empty((b, max_det), dtype=torch.bool, device=dev)
    boxes, valid = _aligned(boxes), valid.contiguous()
    lib = _lib()
    list_box = list_area = None
    if max_det > lib.shared_list_max:  # the keeper list in global memory
        list_box = torch.empty((b, max_det, 4), dtype=torch.float32, device=dev)
        list_area = torch.empty((b, max_det), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.nms_fixpoint_blocked_launch(
            boxes.data_ptr(), valid.data_ptr(), b, k, block, max_det, float(iou_thres),
            None if list_box is None else list_box.data_ptr(),
            None if list_area is None else list_area.data_ptr(),
            keep.data_ptr(), walked.data_ptr(), keep_idx.data_ptr(), keep_valid.data_ptr(),
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fixpoint_keep_blocked kernel launch failed: CUDA error {rc}")
    fixpoint_keep_blocked.launches += 1
    return keep, walked, keep_idx, keep_valid


fixpoint_keep.launches = 0
fixpoint_keep_blocked.launches = 0
