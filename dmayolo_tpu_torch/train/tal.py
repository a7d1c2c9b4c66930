"""Anchor-free training loss for TDetect: the task-aligned assigner, CIoU
box loss, BCE class loss and distribution focal loss.

Port of `dmayolo_tpu/train/tal.py`: dense (B, M, A) assignment over M
target rows and A cells, fixed shapes, no host sync.  Its top-k picks, per
target, the `topk` cells of highest alignment metric with the lowest index
first among equal metrics, as `jax.lax.top_k` does: the many cells whose
metric is exactly 0 tie, and which of them a target takes decides the
assignment.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.boxes import xywh2xyxy
from ..core.iou import bbox_iou
from ..nn.heads import dfl_expectation, dist2bbox, make_anchor_points
from ..parallel.mesh import with_group
from .loss import Targets, bce_with_logits


def bbox2dist(anchor_points, bbox, reg_max):
    """xyxy boxes -> (l, t, r, b) distances from the points, clamped to
    [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


def select_candidates_in_gts(xy_centers, gt_bboxes, eps=1e-9):
    """(A, 2) cell centres x (B, M, 4) xyxy targets -> (B, M, A): the centre
    lies inside the box by more than `eps` on all four sides."""
    x, y = xy_centers[:, 0], xy_centers[:, 1]
    g = gt_bboxes[..., None, :]  # (B, M, 1, 4)
    d = torch.minimum(torch.minimum(x - g[..., 0], y - g[..., 1]),
                      torch.minimum(g[..., 2] - x, g[..., 3] - y))
    return d > eps


def _ciou_pairwise(gt, pd):
    """CIoU of (B, M, 4) targets and (B, A, 4) predictions -> (B, M, A),
    clamped at 0."""
    return bbox_iou(gt[:, :, None, :], pd[:, None, :, :], CIoU=True).clamp(min=0.0)


def topk_mask(metric: torch.Tensor, k: int) -> torch.Tensor:
    """(..., A) -> bool (..., A): the `k` largest entries of each row, the
    lowest index first among equal values (the set `jax.lax.top_k` picks):
    every entry above the k-th value, then the first entries equal to it."""
    kth = torch.topk(metric, k, dim=-1, sorted=True).values[..., -1:]
    above = metric > kth
    eq = metric == kth
    room = k - above.sum(-1, keepdim=True)
    return above | (eq & (torch.cumsum(eq, -1) <= room))


class TaskAlignedAssigner:
    """Task-aligned assignment: per target, its `topk` cells inside the box
    of highest score**alpha * CIoU**beta; a cell claimed by several targets
    goes to the one it overlaps most."""

    def __init__(self, topk=10, num_classes=80, alpha=0.5, beta=6.0, eps=1e-9):
        self.topk = topk
        self.nc = num_classes
        self.alpha = alpha
        self.beta = beta
        self.eps = eps

    @torch.no_grad()
    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt):
        """pd_scores (B, A, nc) sigmoid scores, pd_bboxes (B, A, 4) xyxy
        pixels, anc_points (A, 2) pixels, gt_labels (B, M), gt_bboxes
        (B, M, 4) xyxy pixels, mask_gt (B, M) bool -> (target_labels (B, A),
        target_bboxes (B, A, 4), target_scores (B, A, nc), fg_mask (B, A)
        bool)."""
        b, a, _ = pd_scores.shape
        m = gt_bboxes.shape[1]
        labels = gt_labels.long()

        bbox_scores = torch.gather(pd_scores.transpose(1, 2), 1,
                                   labels[:, :, None].expand(-1, -1, a))  # (B, M, A)
        overlaps = _ciou_pairwise(gt_bboxes, pd_bboxes)
        align = bbox_scores.pow(self.alpha) * overlaps.pow(self.beta)
        del bbox_scores
        mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes)
        metric = align * mask_in_gts

        # a target row that is padding takes no cell
        mask_pos = (topk_mask(metric, self.topk) & mask_in_gts
                    & mask_gt[:, :, None]).to(metric.dtype)
        del metric, mask_in_gts

        # a cell claimed by several targets goes to the one of highest CIoU
        multi = mask_pos.sum(1, keepdim=True) > 1  # (B, 1, A)
        best = torch.argmax(overlaps, dim=1)  # (B, A), the first maximum
        is_max = (torch.arange(m, device=best.device)[None, :, None] == best[:, None, :])
        mask_pos = torch.where(multi, is_max.to(mask_pos.dtype), mask_pos)
        fg_mask = mask_pos.sum(1)  # (B, A)
        target_gt_idx = torch.argmax(mask_pos, dim=1)  # (B, A)

        target_labels = torch.gather(labels, 1, target_gt_idx)
        target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(-1, -1, 4))
        target_scores = F.one_hot(target_labels, self.nc).float()
        target_scores = torch.where(fg_mask[..., None] > 0, target_scores,
                                    torch.zeros_like(target_scores))

        # scale each cell's target by its alignment, normalised per target
        align = align * mask_pos
        pos_align = align.amax(-1, keepdim=True)  # (B, M, 1)
        pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)
        norm = (align * pos_overlaps / (pos_align + self.eps)).amax(-2)[..., None]
        return target_labels, target_bboxes, target_scores * norm, fg_mask > 0


class ComputeLossTAL:
    """Anchor-free loss of a TDetect head: box (CIoU) 7.5, cls (BCE) 0.5,
    dfl 1.5, each divided by the sum of the target scores.  The assigner's
    alpha and beta: the arguments, else the `YA` / `YB` environment
    variables, else 0.5 / 6.0."""

    def __init__(self, stride: Sequence[float], nc: int, reg_max: int = 16,
                 hyp: Optional[Dict] = None, alpha: Optional[float] = None,
                 beta: Optional[float] = None):
        self.stride = [float(s) for s in stride]
        self.nc = nc
        self.reg_max = reg_max
        self.cls_pw = (hyp or {}).get("cls_pw", 1.0)
        if alpha is None:
            alpha = float(os.getenv("YA", 0.5))
        if beta is None:
            beta = float(os.getenv("YB", 6.0))
        self.assigner = TaskAlignedAssigner(topk=10, num_classes=nc, alpha=alpha, beta=beta)

    def __call__(self, raw: Sequence[torch.Tensor], targets: Targets, mesh=None):
        """raw: TDetect's maps (B, ny, nx, 4 * reg_max + nc) -> (total,
        {"box", "cls", "dfl"}), total = the items' sum times B.

        With `mesh`'s data-parallel group, B is this rank's rows, and the
        score sum and B are the global batch's: the total and the items are
        this rank's shares, which sum over the ranks to the global ones."""
        b = raw[0].shape[0]
        mesh = with_group(mesh)
        world = 1 if mesh is None else mesh.world
        dev = raw[0].device
        shapes = [(x.shape[1], x.shape[2]) for x in raw]
        anchor_points, stride_tensor = make_anchor_points(shapes, self.stride, device=dev)
        no = 4 * self.reg_max + self.nc
        flat = torch.cat([x.reshape(b, -1, no).float() for x in raw], dim=1)  # (B, A, no)
        pred_dist, pred_scores = flat[..., :4 * self.reg_max], flat[..., 4 * self.reg_max:]
        a = pred_dist.shape[1]

        img_h, img_w = shapes[0][0] * self.stride[0], shapes[0][1] * self.stride[0]
        scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=dev)
        gt_bboxes = xywh2xyxy(targets.box.float() * scale) * targets.mask[..., None]

        pred_dist4 = pred_dist.reshape(b, a, 4, self.reg_max)
        pred_bboxes = dist2bbox(dfl_expectation(pred_dist4, self.reg_max), anchor_points[None],
                                xywh=False)  # feature units
        _, tb, ts, fg = self.assigner(
            torch.sigmoid(pred_scores.detach()), pred_bboxes.detach() * stride_tensor[None],
            anchor_points * stride_tensor, targets.cls, gt_bboxes, targets.mask.bool())
        tb = tb / stride_tensor[None]  # feature units
        # divided by the raw score sum, as the reference; only a batch with
        # no target at all (sum exactly 0) divides by 1
        raw_sum = ts.sum()
        if mesh is not None:  # the global batch's sum (the targets carry no gradient)
            mesh.all_reduce(raw_sum)
        ts_sum = torch.where(raw_sum > 0, raw_sum, torch.ones_like(raw_sum))

        lcls = bce_with_logits(pred_scores, ts, self.cls_pw).sum() / ts_sum

        weight = ts.sum(-1) * fg  # (B, A)
        iou = bbox_iou(pred_bboxes, tb, CIoU=True)
        lbox = ((1.0 - iou) * weight).sum() / ts_sum

        target_ltrb = bbox2dist(anchor_points[None], tb, self.reg_max - 1)  # (B, A, 4)
        tl_bin = target_ltrb.floor().long()
        tr_bin = tl_bin + 1
        wl = tr_bin.float() - target_ltrb
        wr = 1.0 - wl
        logp = F.log_softmax(pred_dist4, dim=-1)
        ce_l = -torch.gather(logp, -1, tl_bin[..., None])[..., 0]
        ce_r = -torch.gather(logp, -1, tr_bin.clamp(0, self.reg_max - 1)[..., None])[..., 0]
        ldfl = ((ce_l * wl + ce_r * wr).mean(-1) * weight).sum() / ts_sum

        lbox, lcls, ldfl = lbox * 7.5, lcls * 0.5, ldfl * 1.5
        return (lbox + lcls + ldfl) * (b * world), {"box": lbox, "cls": lcls, "dfl": ldfl}
