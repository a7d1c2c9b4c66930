"""Anchor-based training loss (SIoU box + BCE objectness and class).

Port of `dmayolo_tpu/train/loss.py`: dense targets (B, M, 5) with a mask,
the anchor-ratio gate and the 5-cell neighbour expansion as boolean masks
over a fixed (B, M, na, 5) candidate grid, per-candidate predictions by
`gather`, and the objectness target as a scatter-max of the detached IoU.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.iou import bbox_iou
from ..parallel.mesh import with_group


def smooth_bce(eps: float = 0.1):
    """Positive and negative label targets for label smoothing `eps`."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits, targets, pos_weight: float = 1.0):
    """Elementwise BCE-with-logits with positive-class weighting, in f32
    (torch `BCEWithLogitsLoss(pos_weight=...)` without the reduction)."""
    logits, targets = logits.float(), targets.float()
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def focal_bce_with_logits(logits, targets, gamma: float, alpha: float = 0.25,
                          pos_weight: float = 1.0):
    """Focal loss, used when hyp `fl_gamma` > 0."""
    loss = bce_with_logits(logits, targets, pos_weight)
    pred_prob = torch.sigmoid(logits.float())
    p_t = targets * pred_prob + (1 - targets) * (1 - pred_prob)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * (1.0 - p_t) ** gamma


def bce_blur_with_logits(logits, targets, alpha: float = 0.05, pos_weight: float = 1.0):
    """BCEBlur: down-weights missing-label false positives."""
    loss = bce_with_logits(logits, targets, pos_weight)
    dx = torch.sigmoid(logits.float()) - targets
    return loss * (1 - torch.exp((dx - 1) / (alpha + 1e-4)))


def qfocal_bce_with_logits(logits, targets, gamma: float = 1.5, alpha: float = 0.25,
                           pos_weight: float = 1.0):
    """Quality focal loss."""
    loss = bce_with_logits(logits, targets, pos_weight)
    pred_prob = torch.sigmoid(logits.float())
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * (targets - pred_prob).abs() ** gamma


def varifocal_with_logits(pred_score, gt_score, label, alpha: float = 0.75,
                          gamma: float = 2.0):
    """Varifocal loss, summed."""
    pred_score = pred_score.float()
    weight = alpha * torch.sigmoid(pred_score) ** gamma * (1 - label) + gt_score * label
    return torch.sum(bce_with_logits(pred_score, gt_score) * weight)


class Targets(NamedTuple):
    """Dense targets: cls (B, M), xywh normalised 0-1 (B, M, 4), mask (B, M)."""

    cls: torch.Tensor
    box: torch.Tensor
    mask: torch.Tensor


def targets_from_flat(flat, batch_size: int, max_targets: int) -> Targets:
    """Reference-style (n, 6) [img, cls, x, y, w, h] rows -> dense Targets
    (at most `max_targets` rows an image), on the CPU."""
    flat = np.asarray(flat)
    cls = np.zeros((batch_size, max_targets), np.float32)
    box = np.zeros((batch_size, max_targets, 4), np.float32)
    mask = np.zeros((batch_size, max_targets), bool)
    for b in range(batch_size):
        rows = flat[flat[:, 0] == b][:max_targets]
        n = len(rows)
        cls[b, :n] = rows[:, 1]
        box[b, :n] = rows[:, 2:6]
        mask[b, :n] = True
    return Targets(torch.from_numpy(cls), torch.from_numpy(box), torch.from_numpy(mask))


# the 5-cell neighbour offsets (x, y), g = 0.5
_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


class ComputeLoss:
    """Anchor-based YOLOv5 loss with SIoU regression (the DMA default).

    Args:
        anchors: (nl, na, 2) in stride units (the built model's head).
        hyp: hyperparameters (box, obj, cls, cls_pw, obj_pw, anchor_t,
             label_smoothing, fl_gamma).
        nc: class count.
        iou_variant: 'SIoU' (the default) or another `bbox_iou` flag.
    """

    def __init__(self, anchors, hyp: Dict, nc: int, iou_variant: str = "SIoU"):
        self.anchors = torch.as_tensor(np.asarray(anchors, np.float32))
        self.nl, self.na = self.anchors.shape[:2]
        self.nc = nc
        self.hyp = dict(hyp)
        self.gr = 1.0
        self.balance = {3: [4.0, 1.0, 0.4]}.get(self.nl, [4.0, 1.0, 0.25, 0.06, 0.02])
        self.cp, self.cn = smooth_bce(self.hyp.get("label_smoothing", 0.0))
        self.iou_variant = iou_variant
        self._on_device = {}  # device -> (anchors, offsets): copied once

    def _constants(self, device):
        if device not in self._on_device:
            self._on_device[device] = (self.anchors.to(device),
                                       torch.tensor(_OFFSETS, device=device))
        return self._on_device[device]

    def __call__(self, preds: Sequence[torch.Tensor], targets: Targets, mesh=None):
        """preds: list of (B, ny, nx, na, 5 + nc) raw logits.  Returns
        (total, {"box", "obj", "cls"}), total = (lbox + lobj + lcls) * bs.

        With `mesh`'s data-parallel group, B is this rank's rows of the
        global batch, and the matched counts, the objectness mean's cell
        count and bs are the global batch's (taken over the group with no
        gradient through them): the total and the items are this rank's
        shares, which sum over the ranks to the global ones."""
        hyp = self.hyp
        mesh = with_group(mesh)
        world = 1 if mesh is None else mesh.world
        bs = preds[0].shape[0] * world
        lbox = lobj = lcls = 0.0
        fl_gamma = hyp.get("fl_gamma", 0.0)

        cands = [self._build_targets_level(targets, i, p.shape[1], p.shape[2])
                 for i, p in enumerate(preds)]
        counts = torch.stack([c["mask"].sum() for c in cands])
        if mesh is not None:
            mesh.all_reduce(counts)
        denoms = counts.clamp(min=1.0)

        for i, p in enumerate(preds):
            b, ny, nx, na, no = p.shape
            p = p.float()
            cand = cands[i]
            m = cand["mask"]  # (B, K)
            denom = denoms[i]

            pf = p.reshape(b, ny * nx * na, no)
            idx = (cand["gj"] * nx + cand["gi"]) * na + cand["a"]  # (B, K)
            ps = torch.gather(pf, 1, idx[..., None].expand(-1, -1, no))  # (B, K, no)

            # box: IoU variant in cell-offset space
            pxy = torch.sigmoid(ps[..., 0:2]) * 2 - 0.5
            pwh = (torch.sigmoid(ps[..., 2:4]) * 2) ** 2 * cand["anc"]
            iou = bbox_iou(torch.cat([pxy, pwh], dim=-1), cand["tbox"], xywh=True,
                           **{self.iou_variant: True})  # (B, K)
            lbox = lbox + torch.sum((1.0 - iou) * m) / denom

            # objectness target: scatter-max of the detached, clamped IoU
            score = iou.detach().clamp(min=0.0) * m
            s_total = ny * nx * na
            flat_idx = (torch.arange(b, device=p.device)[:, None] * s_total + idx).reshape(-1)
            flat_obj = torch.zeros(b * s_total, device=p.device).scatter_reduce(
                0, flat_idx, score.reshape(-1), reduce="amax").reshape(b, s_total)
            tobj = (1.0 - self.gr) + self.gr * flat_obj
            tobj = torch.where(flat_obj > 0, tobj, torch.zeros_like(tobj))
            obj_bce = (focal_bce_with_logits(pf[..., 4], tobj, fl_gamma, pos_weight=hyp["obj_pw"])
                       if fl_gamma > 0 else bce_with_logits(pf[..., 4], tobj, hyp["obj_pw"]))
            obj_mean = (torch.mean(obj_bce) if mesh is None
                        else obj_bce.sum() / (obj_bce.numel() * world))
            lobj = lobj + obj_mean * self.balance[i]

            # classification
            if self.nc > 1:
                hot = cand["cls"][..., None] == torch.arange(self.nc, device=p.device)
                t = torch.where(hot, self.cp, self.cn)
                cls_bce = (focal_bce_with_logits(ps[..., 5:], t, fl_gamma,
                                                 pos_weight=hyp["cls_pw"])
                           if fl_gamma > 0 else bce_with_logits(ps[..., 5:], t, hyp["cls_pw"]))
                lcls = lcls + torch.sum(cls_bce * m[..., None]) / (denom * self.nc)

        lbox = lbox * hyp["box"]
        lobj = lobj * hyp["obj"]
        lcls = lcls * hyp["cls"]
        total = (lbox + lobj + lcls) * bs
        return total, {"box": lbox, "obj": lobj, "cls": lcls}

    def _build_targets_level(self, targets: Targets, i: int, ny: int, nx: int):
        """Dense build_targets for one level: a fixed (B, M * na * 5)
        candidate set with its mask and per-candidate (gj, gi, a, tbox,
        anchor, cls)."""
        dev = targets.box.device
        anchors, off = self._constants(dev)
        anchors = anchors[i]  # (na, 2) stride units
        tb = targets.box.float()
        gxy = torch.stack([tb[..., 0] * nx, tb[..., 1] * ny], dim=-1)  # grid units
        gwh = torch.stack([tb[..., 2] * nx, tb[..., 3] * ny], dim=-1)
        tmask = targets.mask.bool()
        # padded rows get unit wh so their (masked) candidates stay finite
        gwh = torch.where(tmask[..., None], gwh, torch.ones_like(gwh))

        # anchor-ratio gate (B, M, na); a real 0-wide label fails it
        # (max(r, 1/r) = inf) and is sanitised only after the gate
        r = gwh[:, :, None, :] / anchors[None, None]
        a_mask = torch.amax(torch.maximum(r, 1.0 / r), dim=-1) < self.hyp["anchor_t"]
        a_mask = a_mask & tmask[:, :, None]
        gwh = torch.where(gwh > 0, gwh, torch.ones_like(gwh))

        # neighbour-offset masks (B, M, 5)
        gx, gy = gxy[..., 0], gxy[..., 1]
        jm = (gx % 1 < 0.5) & (gx > 1)
        km = (gy % 1 < 0.5) & (gy > 1)
        lm = ((nx - gx) % 1 < 0.5) & ((nx - gx) > 1)
        mm = ((ny - gy) % 1 < 0.5) & ((ny - gy) > 1)
        off_mask = torch.stack([torch.ones_like(jm), jm, km, lm, mm], dim=-1)

        valid = a_mask[..., None] & off_mask[:, :, None, :]  # (B, M, na, 5)
        shape = tuple(valid.shape)

        gij = torch.floor(gxy[:, :, None, None, :] - off[None, None, None])  # (B, M, 1, 5, 2)
        gij = gij.expand(shape + (2,))
        # indices clamped for gather and scatter; tbox keeps the unclamped cell
        gi = gij[..., 0].clamp(0, nx - 1).long()
        gj = gij[..., 1].clamp(0, ny - 1).long()
        txy = gxy[:, :, None, None, :] - gij
        twh = gwh[:, :, None, None, :].expand(shape + (2,))
        tbox = torch.cat([txy, twh], dim=-1)

        B, M = targets.cls.shape
        K = M * self.na * 5
        anc = anchors[None, None, :, None, :].expand(shape + (2,))
        cls = targets.cls[:, :, None, None].expand(shape).long()
        a = torch.arange(self.na, device=dev)[None, None, :, None].expand(shape)
        return {
            "mask": valid.reshape(B, K).float(),
            "gi": gi.reshape(B, K),
            "gj": gj.reshape(B, K),
            "a": a.reshape(B, K),
            "tbox": tbox.reshape(B, K, 4),
            "anc": anc.reshape(B, K, 2),
            "cls": cls.reshape(B, K),
        }
