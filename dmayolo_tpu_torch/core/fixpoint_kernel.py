"""Greedy-NMS keep flags by the suppression-DAG fixpoint: the CUDA kernel
K3 and its plain versions.

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

`fixpoint_keep` launches the kernel (`csrc/nms_fixpoint.cu`) for CUDA
tensors and takes the plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import load_library

MAX_K = 512  # the block size of both "matrix" forms; one thread a candidate


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


def _lib():
    lib = load_library("nms_fixpoint")
    fn = lib.nms_fixpoint_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fixpoint_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                  divide: bool = False) -> torch.Tensor:
    """Greedy-NMS keep flags of rank-sorted candidates.

    Args:
        boxes: (B, K, 4) f32 xyxy, sorted by score, class offset applied.
        valid: (B, K) bool candidate liveness.
        divide: compare inter / union > t (True) or inter > t * union.
    Returns keep (B, K) bool.  A CPU tensor goes through
    `fixpoint_keep_plain`; a CUDA tensor launches the kernel, or raises."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"expected boxes (B, K, 4) and valid (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError("fixpoint_keep takes a bool valid mask")
    if boxes.device != valid.device:
        raise ValueError("boxes and valid must be on one device")
    if boxes.device.type == "cpu":
        return fixpoint_keep_plain(boxes, valid, iou_thres, divide)
    if boxes.device.type != "cuda":
        raise ValueError(f"fixpoint_keep runs on cuda or cpu, not {boxes.device}")
    if boxes.dtype != torch.float32:
        raise TypeError("fixpoint_keep takes float32 boxes")
    b, k, _ = boxes.shape
    if not 0 < k <= MAX_K:
        raise ValueError(f"fixpoint_keep takes 1 to {MAX_K} candidates per "
                         f"image, got K={k}")
    boxes, valid = boxes.contiguous(), valid.contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return keep
    fn = _lib()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = fn(boxes.data_ptr(), valid.data_ptr(), b, k, float(iou_thres),
                int(divide), keep.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fixpoint_keep kernel launch failed: CUDA error {rc}")
    fixpoint_keep.launches += 1
    return keep


fixpoint_keep.launches = 0
