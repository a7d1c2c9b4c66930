"""Fixed-shape batched NMS: the serving tail and the eval protocol.

Port of `dmayolo_tpu/core/nms.py`: candidate selection by exact top-k with
sub-threshold scores masked to NEG_INF, then greedy class-offset NMS per
image, with fixed (B, max_det, 6) outputs and a validity mask.

NMS backends (`nms_from_topk`, `batched_nms`):
  * "matrix": the suppression-DAG fixpoint through the CUDA kernel K3
    (`core/fixpoint_kernel.py`); one (K, K) fixpoint for K <= 512, else
    block-sequential (`nms_matrix_blocked`, one launch of K3's blocked
    entry);
  * "pallas": greedy NMS through the CUDA kernel K2 (`core/nms_kernel.py`),
    its streaming variant above 1024 candidates; the name is the JAX
    package's, where this backend is its Pallas kernel;
  * "scan": the plain greedy loop (`nms_greedy_plain`) on any device.
All three give the same detections.  Invalid slots of "scan" and
"pallas" hold the unpicked indices, as K2's do.
"""
from __future__ import annotations

import torch

from .boxes import xywh2xyxy
from .fixpoint_kernel import (MAX_K, _fixpoint_keep, _fixpoint_keep_boxes,  # noqa: F401
                              _keep_to_idx, _pairwise_iou, _suppression_matrix,
                              fixpoint_keep, fixpoint_keep_blocked)
from .iou import bbox_iou
from .nms_kernel import NEG_INF, nms_greedy, nms_greedy_plain

MAX_WH = 4096.0  # class-offset stride, the reference's max_wh
_MERGE_GATE_MAX = 3000  # the reference's merge-NMS candidate-count gate

__all__ = ["MAX_WH", "NEG_INF", "batched_nms", "nms_from_topk", "nms_matrix",
           "nms_matrix_blocked", "nms_parts", "nms_single", "nms_variant_single"]


def nms_single(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int = 300):
    """Greedy NMS on one image: boxes (K, 4), scores (K,) with NEG_INF for
    dropped candidates -> (keep_idx (max_det,) int32, keep_valid (max_det,)).

    The valid slots equal the JAX `nms_single`; invalid slots hold the
    unpicked indices, as the kernel's do."""
    keep_idx, keep_valid = nms_greedy_plain(boxes[None], scores[None],
                                            iou_thres, max_det)
    return keep_idx[0], keep_valid[0]


def nms_variant_single(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                       max_det: int = 300, class_nms: str = "SIoU"):
    """Greedy NMS on one image with a selectable IoU variant of `bbox_iou`
    (IoU, GIoU, DIoU, CIoU, SIoU or EIoU): boxes (K, 4) xyxy, scores (K,)
    with NEG_INF for dropped candidates -> (keep_idx (max_det,) int32,
    keep_valid (max_det,)).  A plain loop, as the JAX `lax.scan`: each
    step picks the first highest live score and suppresses the candidates
    whose IoU with it exceeds `iou_thres`; an invalid step keeps its pick's
    index with `keep_valid` False."""
    key = class_nms.lower()
    flags = {v: key == v.lower() for v in ("GIoU", "DIoU", "CIoU", "SIoU", "EIoU")}
    live = scores.clone()
    keep_idx = torch.zeros(max_det, dtype=torch.int32, device=scores.device)
    keep_valid = torch.zeros(max_det, dtype=torch.bool, device=scores.device)
    for t in range(max_det):
        best = torch.argmax(live)
        valid = live[best] > NEG_INF / 2
        suppress = (bbox_iou(boxes[best][None], boxes, **flags) > iou_thres) & valid
        suppress[best] = valid
        live = torch.where(suppress, torch.full_like(live, NEG_INF), live)
        keep_idx[t], keep_valid[t] = best, valid
    return keep_idx, keep_valid


def _top_k_candidates(scores: torch.Tensor, k: int):
    """Exact top-k, sorted by descending score."""
    return torch.topk(scores, k, dim=1, largest=True, sorted=True)


def nms_matrix_blocked(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_thres: float, max_det: int = 300, block: int = 256):
    """Exact greedy NMS, block-sequential: rank-sorted candidates in blocks
    of `block` (a larger block runs as 512: the keeps are the same).  Per
    block, (1) the fixpoint (divide form) resolves the keeps given earlier
    suppression, (2) the block's keepers suppress the lower-ranked
    candidates of later blocks.  Both steps of every block run in one
    launch of K3's blocked entry (`fixpoint_keep_blocked`), with no host
    sync, and stop at `max_det` keepers: the outputs hold only the first
    `max_det` keepers, as the JAX function's `lax.top_k` does.  The kernel
    writes the outputs too: for rank-sorted candidates, descending score
    with the lowest index first among ties is index order."""
    *_, keep_idx, keep_valid = fixpoint_keep_blocked(boxes, scores > NEG_INF / 2, iou_thres,
                                                     max_det, min(block, MAX_K))
    return keep_idx, keep_valid


def nms_matrix(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_det: int = 300, block: int = 512):
    """Greedy NMS by the suppression-DAG fixpoint.

    For K <= `block`, one (B, K, K) fixpoint (K3, divide-free form); beyond
    that, `nms_matrix_blocked`.  Both are exact greedy NMS.

    Args:
        boxes: (B, K, 4) xyxy sorted by score, class offset applied.
        scores: (B, K), NEG_INF for invalid.
    Returns (keep_idx (B, max_det) int32, keep_valid (B, max_det) bool).
    """
    if boxes.shape[1] > block:
        return nms_matrix_blocked(boxes, scores, iou_thres, max_det, block)
    keep = fixpoint_keep(boxes, scores > NEG_INF / 2, iou_thres, divide=False)
    return _keep_to_idx(keep, scores, max_det)


def _nms_idx(nms_boxes, scores, iou_thres: float, max_det: int, backend: str):
    if backend == "pallas":
        return nms_greedy(nms_boxes, scores, iou_thres, max_det)
    if backend == "scan":
        return nms_greedy_plain(nms_boxes, scores, iou_thres, max_det)
    if backend == "matrix":
        return nms_matrix(nms_boxes, scores, iou_thres, max_det)
    raise ValueError(f"unknown NMS backend {backend!r}")


def nms_parts(boxes, scores, cls, conf_thres: float = 0.25,
              iou_thres: float = 0.45, agnostic: bool = False,
              max_det: int = 300, max_nms: int = 512, backend: str = "matrix"):
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


def _gather_dets(top_boxes, top_scores, top_cls, keep_idx):
    idx = keep_idx.long()
    out_boxes = torch.gather(top_boxes, 1, idx[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(top_scores, 1, idx)
    out_cls = torch.gather(top_cls, 1, idx)
    return out_boxes, out_scores, out_cls


def _dets(out_boxes, out_scores, out_cls, keep_valid):
    dets = torch.cat([out_boxes, out_scores[..., None], out_cls[..., None]], dim=-1)
    return torch.where(keep_valid[..., None], dets, torch.zeros_like(dets))


def nms_from_topk(top_boxes, top_scores, top_cls, iou_thres: float = 0.45,
                  agnostic: bool = False, max_det: int = 300,
                  backend: str = "matrix"):
    """NMS over candidates already conf-gated and sorted by score:
    top_boxes (B, K, 4), top_scores (B, K), top_cls (B, K)."""
    offset = 0.0 if agnostic else MAX_WH
    nms_boxes = top_boxes + (top_cls * offset)[..., None]
    keep_idx, keep_valid = _nms_idx(nms_boxes, top_scores, iou_thres, max_det, backend)
    parts = _gather_dets(top_boxes, top_scores, top_cls, keep_idx)
    return _dets(*parts, keep_valid), keep_valid


def select_candidates(prediction: torch.Tensor, conf_thres: float,
                      multi_label: bool = False, max_nms: int = 30000,
                      class_mask=None):
    """The candidate half of `batched_nms`: the top-`max_nms` candidates by
    conf = obj * cls, sorted.  Returns (top_boxes (B, K, 4) xyxy,
    top_scores (B, K) with NEG_INF below `conf_thres`, top_cls (B, K),
    src_row (B, K) the candidate's row of `prediction`)."""
    nc = prediction.shape[2] - 5
    multi_label = bool(multi_label) and nc > 1
    boxes_xyxy = xywh2xyxy(prediction[..., :4])  # (B, N, 4)
    cls_scores = prediction[..., 5:] * prediction[..., 4:5]  # (B, N, nc)
    neg = torch.tensor(NEG_INF, dtype=prediction.dtype, device=prediction.device)

    if multi_label:
        if class_mask is not None:
            cls_scores = torch.where(class_mask[None, None, :], cls_scores,
                                     torch.zeros_like(cls_scores))
        b, n, _ = cls_scores.shape
        flat_scores = cls_scores.reshape(b, n * nc)
        cand_scores = torch.where(flat_scores > conf_thres, flat_scores, neg)
        cand_cls = torch.arange(nc, dtype=prediction.dtype,
                                device=prediction.device).repeat(n).expand(b, -1)
    else:
        best_cls = torch.argmax(cls_scores, dim=-1)  # first maximum, as jnp.argmax
        best_score = torch.amax(cls_scores, dim=-1)
        keep = best_score > conf_thres
        if class_mask is not None:
            keep = keep & class_mask[best_cls]
        cand_scores = torch.where(keep, best_score, neg)
        cand_cls = best_cls.to(prediction.dtype)

    k = min(max_nms, cand_scores.shape[1])
    top_scores, top_idx = _top_k_candidates(cand_scores, k)  # (B, K)
    # multi-label: the source box is candidate row // nc, gathered without
    # the nc-fold (B, N * nc, 4) copy
    src_row = top_idx // nc if multi_label else top_idx
    top_boxes = torch.gather(boxes_xyxy, 1, src_row[..., None].expand(-1, -1, 4))
    return top_boxes, top_scores, torch.gather(cand_cls, 1, top_idx), src_row



def batched_nms(prediction: torch.Tensor, conf_thres: float = 0.25,
                iou_thres: float = 0.45, multi_label: bool = False,
                agnostic: bool = False, max_det: int = 300,
                max_nms: int = 30000, class_mask=None, backend: str = "scan",
                return_src: bool = False, merge: bool = False):
    """Full post-processing: (B, N, 5+nc) decoded predictions ->
    (dets (B, max_det, 6) [x1, y1, x2, y2, conf, cls], valid (B, max_det)),
    and with `return_src` the candidate's source row (B, max_det).

    conf = obj * cls; `multi_label` makes every (box, class) pair above
    `conf_thres` a candidate; `class_mask` (nc,) bool keeps only those
    classes (multi-label: per pair; single-label: the best class is picked
    first, and a box whose best class is excluded is dropped); `max_nms`
    is the pre-NMS candidate budget; `merge` replaces each kept box by the
    conf-weighted mean of the candidates overlapping it, for images with
    1 < n < 3000 live candidates.
    """
    top_boxes, top_scores, top_cls, src_row = select_candidates(
        prediction, conf_thres, multi_label, max_nms, class_mask)
    offset = 0.0 if agnostic else MAX_WH
    nms_boxes = top_boxes + (top_cls * offset)[..., None]
    keep_idx, keep_valid = _nms_idx(nms_boxes, top_scores, iou_thres, max_det, backend)
    out_boxes, out_scores, out_cls = _gather_dets(top_boxes, top_scores, top_cls,
                                                  keep_idx)
    if merge:
        # each kept box becomes the conf-weighted mean of every candidate
        # overlapping it above iou_thres (overlap on class-offset boxes,
        # mean over the raw boxes); picks with no second supporting
        # candidate are dropped.  Only inside the 1 < n < 3000 gate on the
        # live candidate count n; outside it the picks pass unmerged.
        live = top_scores > NEG_INF / 2
        n_live = live.sum(-1)
        gate = (n_live > 1) & (n_live < _MERGE_GATE_MAX)
        kept_off = torch.gather(nms_boxes, 1, keep_idx.long()[..., None].expand(-1, -1, 4))
        overlap = (_pairwise_iou(kept_off, nms_boxes) > iou_thres) & live[:, None, :]
        w = overlap.float() * top_scores.clamp(min=0.0)[:, None, :]
        merged = torch.einsum("bdk,bkc->bdc", w, top_boxes.float()) / (
            w.sum(-1, keepdim=True) + 1e-12)
        # the dets come back in f32, as JAX's `jnp.where` promotes them
        out_boxes = torch.where(gate[:, None, None], merged, out_boxes.to(merged.dtype))
        keep_valid = torch.where(gate[:, None], keep_valid & (overlap.sum(-1) > 1),
                                 keep_valid)
    dets = _dets(out_boxes, out_scores, out_cls, keep_valid)
    if return_src:
        # source candidate index in decode order: traces a kept detection
        # back to its anchor cell
        src = torch.gather(src_row, 1, keep_idx.long())
        return dets, keep_valid, src.to(torch.int32)
    return dets, keep_valid
