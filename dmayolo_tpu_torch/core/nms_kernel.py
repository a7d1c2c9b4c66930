"""Greedy NMS per image: the CUDA kernel K2 and its plain version.

Port of `dmayolo_tpu/core/pallas_nms.py::pallas_batched_nms_core`.  The
kernel (`csrc/nms_greedy.cu`) holds one image's candidates in shared memory
and runs the whole pick/suppress loop in one thread block; its source note
says what bounds it on the card and what the design does about that.

`nms_greedy` launches the kernel for CUDA tensors and takes the plain
version, `nms_greedy_plain`, only for CPU tensors.  Both return what the
JAX function returns: `keep_idx` holds the picks in pick order, then the
unpicked indices in ascending order, then zeros when K < max_det;
`keep_valid` marks the picks.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import load_library

NEG_INF = -1e10
# candidates that fit one block's shared memory (28 bytes each); larger
# candidate sets need the streaming variant (ROADMAP.md, Queue 2, K2)
MAX_K = 1024


def nms_greedy_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thres: float = 0.45, max_det: int = 300):
    """The kernel's arithmetic as a loop of tensor ops over the batch.

    Args:
        boxes: (B, K, 4) f32 xyxy, class offset applied.
        scores: (B, K) f32, dropped candidates at NEG_INF.
    Returns (keep_idx (B, max_det) int32, keep_valid (B, max_det) bool).
    """
    b, k, _ = boxes.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    live = scores.clone()
    rank = torch.full((b, k), -1, dtype=torch.int32, device=boxes.device)
    lanes = torch.arange(k, device=boxes.device)
    for t in range(max_det):
        best = torch.argmax(live, dim=1, keepdim=True)  # first max: lowest index
        valid = live.gather(1, best) > NEG_INF / 2
        sel = lanes[None, :] == best
        iw = torch.clamp(torch.minimum(x2.gather(1, best), x2)
                         - torch.maximum(x1.gather(1, best), x1), min=0.0)
        ih = torch.clamp(torch.minimum(y2.gather(1, best), y2)
                         - torch.maximum(y1.gather(1, best), y1), min=0.0)
        inter = iw * ih
        iou = inter / (areas.gather(1, best) + areas - inter + 1e-7)
        suppress = ((iou > iou_thres) | sel) & valid
        live = torch.where(suppress, torch.full_like(live, NEG_INF), live)
        rank = torch.where(sel & valid, torch.full_like(rank, t), rank)
    order = torch.argsort(torch.where(rank >= 0, rank, torch.full_like(rank, 2**30)),
                          dim=1, stable=True)
    keep_idx = order[:, :max_det]
    keep_valid = rank.gather(1, keep_idx) >= 0
    if k < max_det:  # fixed output width even when candidates < max_det
        pad = max_det - k
        keep_idx = torch.nn.functional.pad(keep_idx, (0, pad))
        keep_valid = torch.nn.functional.pad(keep_valid, (0, pad))
    return keep_idx.to(torch.int32), keep_valid


def _lib():
    lib = load_library("nms_greedy")
    fn = lib.nms_greedy_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def nms_greedy(boxes: torch.Tensor, scores: torch.Tensor,
               iou_thres: float = 0.45, max_det: int = 300):
    """Greedy NMS per image (see the module docstring for the outputs).

    A CPU tensor goes through `nms_greedy_plain`; a CUDA tensor launches
    the kernel, or raises."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"expected boxes (B, K, 4) and scores (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores must be on one device")
    if boxes.device.type == "cpu":
        return nms_greedy_plain(boxes, scores, iou_thres, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_greedy runs on cuda or cpu, not {boxes.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms_greedy takes float32 boxes and scores")
    b, k, _ = boxes.shape
    if not 0 < k <= MAX_K:
        raise ValueError(
            f"nms_greedy holds at most {MAX_K} candidates per image in shared "
            f"memory, got K={k}; the streaming variant for larger K is "
            "ROADMAP.md Queue 2, K2")
    boxes, scores = boxes.contiguous(), scores.contiguous()
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=boxes.device)
    keep_valid = torch.empty((b, max_det), dtype=torch.bool, device=boxes.device)
    if b == 0 or max_det == 0:
        return keep_idx, keep_valid
    fn = _lib()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = fn(boxes.data_ptr(), scores.data_ptr(), b, k, max_det,
                float(iou_thres), keep_idx.data_ptr(), keep_valid.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"nms_greedy kernel launch failed: CUDA error {rc}")
    nms_greedy.launches += 1
    return keep_idx, keep_valid


nms_greedy.launches = 0
