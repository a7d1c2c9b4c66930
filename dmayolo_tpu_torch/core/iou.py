"""IoU family: IoU / GIoU / DIoU / CIoU / SIoU / EIoU / alpha-IoU.

Port of `dmayolo_tpu/core/iou.py`, with its eps placement (eps added to
the heights only, then once more to the union), which the loss parity
depends on.  Elementwise and broadcasting over (..., 4) boxes.
"""
from __future__ import annotations

import math

import torch


def bbox_iou(box1, box2, xywh: bool = False, GIoU: bool = False,
             DIoU: bool = False, CIoU: bool = False, SIoU: bool = False,
             EIoU: bool = False, alpha: float = 1.0, eps: float = 1e-7):
    """Elementwise IoU between broadcastable (..., 4) boxes.

    `xywh=True` means boxes are (cx, cy, w, h), else (x1, y1, x2, y2).  At
    most one variant flag may be set.  `alpha != 1` applies the alpha-IoU
    power to the plain-IoU result."""
    if xywh:
        b1_x1, b1_x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
        b1_y1, b1_y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
        b2_x1, b2_x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
        b2_y1, b2_y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = (box1[..., i] for i in range(4))
        b2_x1, b2_y1, b2_x2, b2_y2 = (box2[..., i] for i in range(4))

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))

    # union: eps on the heights, then once more on the union
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps

    iou = inter / union
    if not (GIoU or DIoU or CIoU or SIoU or EIoU):
        return iou.pow(alpha) if alpha != 1.0 else iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)  # convex width
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)  # convex height

    if SIoU:  # https://arxiv.org/abs/2205.12740
        s_cw = (b2_x1 + b2_x2 - b1_x1 - b1_x2) * 0.5
        s_ch = (b2_y1 + b2_y2 - b1_y1 - b1_y2) * 0.5
        sigma = torch.sqrt(s_cw ** 2 + s_ch ** 2) + eps
        sin_alpha_1 = s_cw.abs() / sigma
        sin_alpha_2 = s_ch.abs() / sigma
        threshold = math.sqrt(2.0) / 2
        sin_alpha = torch.where(sin_alpha_1 > threshold, sin_alpha_2, sin_alpha_1)
        angle_cost = torch.cos(torch.arcsin(sin_alpha.clamp(-1.0, 1.0)) * 2 - math.pi / 2)
        rho_x = (s_cw / (cw + eps)) ** 2
        rho_y = (s_ch / (ch + eps)) ** 2
        gamma = angle_cost - 2
        distance_cost = 2 - torch.exp(gamma * rho_x) - torch.exp(gamma * rho_y)
        omiga_w = (w1 - w2).abs() / torch.maximum(w1, w2)
        omiga_h = (h1 - h2).abs() / torch.maximum(h1, h2)
        shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
        return iou - 0.5 * (distance_cost + shape_cost)

    if CIoU or DIoU or EIoU:
        c2 = cw ** 2 + ch ** 2 + eps  # convex diagonal squared
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
        if DIoU:
            return iou - rho2 / c2
        if EIoU:  # https://arxiv.org/abs/2101.08158
            cw2 = cw ** 2 + eps
            ch2 = ch ** 2 + eps
            return iou - (rho2 / c2 + (w2 - w1) ** 2 / cw2 + (h2 - h1) ** 2 / ch2)
        # CIoU: aspect-ratio penalty, its weight a constant of the graph
        v = (4 / math.pi ** 2) * (torch.arctan(w2 / h2) - torch.arctan(w1 / h1)) ** 2
        a = (v / (v - iou + (1 + eps))).detach()
        return iou - (rho2 / c2 + v * a)

    # GIoU
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


def box_iou_matrix(boxes1, boxes2, eps: float = 1e-7):
    """Pairwise plain IoU between (N, 4) and (M, 4) xyxy boxes -> (N, M),
    with the area-only eps of the reference's `box_iou`."""
    inter_wh = (torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
                - torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])).clamp(min=0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    area1 = torch.prod(boxes1[:, 2:] - boxes1[:, :2], dim=-1)
    area2 = torch.prod(boxes2[:, 2:] - boxes2[:, :2], dim=-1)
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def wh_iou(wh1, wh2, eps: float = 1e-7):
    """IoU of (N, 2) and (M, 2) width-heights of co-centred boxes -> (N, M)."""
    wh1, wh2 = wh1[:, None], wh2[None]
    inter = torch.prod(torch.minimum(wh1, wh2), dim=2)
    return inter / (torch.prod(wh1, dim=2) + torch.prod(wh2, dim=2) - inter + eps)
