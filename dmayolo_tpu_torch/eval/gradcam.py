"""Grad-CAM and Grad-CAM++ for the detection models.

Port of `dmayolo_tpu/eval/gradcam.py` (a working replacement for the
reference's main_gradcam.py, whose imports do not exist upstream).  The
graph is split at the target layer and torch autograd differentiates the
detection score of one NMS-kept box with respect to that layer's
activation.  The earlier layers' saved activations are detached, which is
what forward and backward hooks give: only paths through the target
activation contribute to d score / d activation.

    gradcam   : w_c = GAP(dS/dA_c);            cam = relu(sum_c w_c A_c)
    gradcampp : alpha = g^2 / (2 g^2 + sum_HW A g^3), w_c = sum(alpha relu(g)),
                cam as above.

The model runs in float32 as it is (unfolded, or folded if fuse() was
called); activations are (B, C, H, W) inside, the CAM (H, W) numpy.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _run(layers, out, y: Dict[int, torch.Tensor], save):
    for mod in layers:
        f = mod.f
        if f != -1:
            out = (y[f % mod.i] if isinstance(f, int)
                   else [out if j == -1 else y[j % mod.i] for j in f])
        out = mod(out, torch.float32)
        if mod.i in save:
            y[mod.i] = out
    return out


def split_forward(model, x: torch.Tensor, layer_i: int):
    """Run layers 0..layer_i of (B, H, W, 3) f32 images.  Returns (the
    output of layer_i, the saved activations {index: tensor})."""
    y: Dict[int, torch.Tensor] = {}
    out = _run(model.model[:layer_i + 1], x.permute(0, 3, 1, 2), y, model.save)
    return out, y


def tail_forward(model, feat: torch.Tensor, saved: Dict[int, torch.Tensor], layer_i: int):
    """Run layers layer_i+1.. from `feat`, reading skip inputs from `saved`
    except the target layer's own entry, which is `feat` (it must stay on
    the graph).  Returns the raw head."""
    y = dict(saved)
    if layer_i in model.save:
        y[layer_i] = feat
    return _run(model.model[layer_i + 1:], feat, y, model.save)


def detection_score(model, dec: torch.Tensor, cand: int, cls: int) -> torch.Tensor:
    """NMS confidence of one decoded candidate: obj * cls for Detect's
    (5 + nc) rows, the class probability alone for TDetect's (4 + nc) rows
    (obj is 1 there, as detect's obj = 1 column)."""
    det = dec[0, cand]
    if dec.shape[-1] == model.nc + 4:
        return det[4 + cls]
    return det[4] * det[5 + cls]


def cam_for_detection(model, x: torch.Tensor, layer_i: int, cand_idx: int, cls_idx: int,
                      method: str = "gradcam", _cache: Optional[dict] = None) -> np.ndarray:
    """CAM heatmap (H_feat, W_feat) in [0, 1] for one kept detection.

    Args:
        x: (1, H, W, 3) float32 input in [0, 1], on the model's device.
        cand_idx: flat candidate index of the detection in decode order.
        cls_idx: its class id (score = obj * cls, as the NMS confidence).
        _cache: a dict kept across calls: the split forward runs once per
            input (held by identity, so a new image is never served stale
            activations) and layer.
    """
    _cache = _cache if _cache is not None else {}
    if _cache.get("x_obj") is not x or _cache.get("layer_i") != layer_i:
        with torch.no_grad():
            feat, saved = split_forward(model, x, layer_i)
        _cache.update(x_obj=x, layer_i=layer_i, feat=feat,
                      saved={k: v.detach() for k, v in saved.items()})
    feat = _cache["feat"].detach().requires_grad_(True)
    with torch.enable_grad():
        dec = model.decode(tail_forward(model, feat, _cache["saved"], layer_i))
        (grads,) = torch.autograd.grad(detection_score(model, dec, cand_idx, cls_idx), feat)
    a = feat[0].detach().permute(1, 2, 0).float().cpu().numpy()  # (H, W, C)
    g = grads[0].permute(1, 2, 0).float().cpu().numpy()

    if method == "gradcampp":
        g2, g3 = g * g, g * g * g
        denom = 2.0 * g2 + np.sum(a * g3, axis=(0, 1), keepdims=True)
        alpha = np.where(np.abs(denom) > 1e-12, g2 / (denom + 1e-12), 0.0)
        w = np.sum(alpha * np.maximum(g, 0.0), axis=(0, 1))
    else:
        w = g.mean(axis=(0, 1))

    cam = np.maximum((a * w).sum(axis=-1), 0.0)
    rng = cam.max() - cam.min()
    if rng > 1e-12:
        cam = (cam - cam.min()) / rng
    else:
        cam = np.zeros_like(cam)
    return cam


def resolve_target_layer(model, target: str) -> int:
    """A reference-style layer address ('model_17_cv3_act') or a plain
    index string -> the layer index, checked against the graph."""
    t = target.strip()
    if t.startswith("model_"):
        t = t.split("_")[1]
    i = int(t)
    if not 0 <= i < len(model.model) - 1:
        raise ValueError(f"target layer {i} out of range (0..{len(model.model) - 2}; "
                         "the head itself cannot be a CAM target)")
    return i


def upsample_cam(cam: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear cam -> (H, W), half-pixel centres, edges clamped."""
    h, w = cam.shape
    th, tw = size
    yy = (np.arange(th) + 0.5) * h / th - 0.5
    xx = (np.arange(tw) + 0.5) * w / tw - 0.5
    y0 = np.clip(np.floor(yy).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xx).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xx - x0, 0.0, 1.0)[None, :]
    top = cam[y0][:, x0] * (1 - fx) + cam[y0][:, x1] * fx
    bot = cam[y1][:, x0] * (1 - fx) + cam[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy
