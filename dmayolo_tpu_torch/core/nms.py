"""Fixed-shape batched NMS for the serving path.

Port of the serving half of `dmayolo_tpu/core/nms.py`: candidate
selection by exact top-k with sub-threshold scores masked to NEG_INF, then
greedy class-offset NMS per image, with fixed (B, max_det, 6) outputs and
a validity mask.

Backends of `nms_from_topk`:
  * "pallas": the CUDA kernel K2 (`core/nms_kernel.py`); the name is the
    JAX package's, where this backend is its Pallas kernel;
  * "scan": the plain greedy loop (`nms_greedy_plain`) on any device;
  * "matrix": not ported yet (ROADMAP.md, Queue 2, with kernel K3).
"""
from __future__ import annotations

import torch

from .nms_kernel import NEG_INF, nms_greedy, nms_greedy_plain

MAX_WH = 4096.0  # class-offset stride, the reference's max_wh

__all__ = ["MAX_WH", "NEG_INF", "nms_from_topk", "nms_parts", "nms_single"]


def nms_single(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int = 300):
    """Greedy NMS on one image: boxes (K, 4), scores (K,) with NEG_INF for
    dropped candidates -> (keep_idx (max_det,) int32, keep_valid (max_det,)).

    The valid slots equal the JAX `nms_single`; invalid slots hold the
    unpicked indices, as the kernel's do."""
    keep_idx, keep_valid = nms_greedy_plain(boxes[None], scores[None],
                                            iou_thres, max_det)
    return keep_idx[0], keep_valid[0]


def _top_k_candidates(scores: torch.Tensor, k: int):
    """Exact top-k, sorted by descending score."""
    return torch.topk(scores, k, dim=1, largest=True, sorted=True)


def nms_parts(boxes, scores, cls, conf_thres: float = 0.25,
              iou_thres: float = 0.45, agnostic: bool = False,
              max_det: int = 300, max_nms: int = 512, backend: str = "pallas"):
    """NMS over `Detect.decode_parts` outputs: boxes (B, N, 4) xyxy pixels,
    scores (B, N) best-class confidence, cls (B, N) best class (float).
    Returns (dets (B, max_det, 6), valid (B, max_det))."""
    cand = torch.where(scores > conf_thres, scores, torch.full_like(scores, NEG_INF))
    k = min(max_nms, cand.shape[1])
    top_scores, top_idx = _top_k_candidates(cand, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, top_idx)
    return nms_from_topk(top_boxes, top_scores, top_cls, iou_thres=iou_thres,
                         agnostic=agnostic, max_det=max_det, backend=backend)


def nms_from_topk(top_boxes, top_scores, top_cls, iou_thres: float = 0.45,
                  agnostic: bool = False, max_det: int = 300,
                  backend: str = "pallas"):
    """NMS over candidates already conf-gated and sorted by score:
    top_boxes (B, K, 4), top_scores (B, K), top_cls (B, K)."""
    offset = 0.0 if agnostic else MAX_WH
    nms_boxes = top_boxes + (top_cls * offset)[..., None]
    if backend == "pallas":
        keep_idx, keep_valid = nms_greedy(nms_boxes, top_scores, iou_thres, max_det)
    elif backend == "scan":
        keep_idx, keep_valid = nms_greedy_plain(nms_boxes, top_scores, iou_thres,
                                                max_det)
    elif backend == "matrix":
        raise NotImplementedError(
            "the 'matrix' NMS backend is not ported yet (ROADMAP.md, Queue 2, K3)")
    else:
        raise ValueError(f"unknown NMS backend {backend!r}")
    idx = keep_idx.long()
    out_boxes = torch.gather(top_boxes, 1, idx[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(top_scores, 1, idx)
    out_cls = torch.gather(top_cls, 1, idx)
    dets = torch.cat([out_boxes, out_scores[..., None], out_cls[..., None]], dim=-1)
    return torch.where(keep_valid[..., None], dets, torch.zeros_like(dets)), keep_valid
