"""Greedy NMS per image: the CUDA kernel K2 and its plain version.

Port of `dmayolo_tpu/core/pallas_nms.py::pallas_batched_nms_core`.  Two
kernels in `csrc/nms_greedy.cu` run the whole pick/suppress loop of one
image in one thread block: for K <= 1024 (serving) the candidates sit in
shared memory; above that (the eval protocol's K = 30,000) the streaming
variant, `nms_greedy_stream`, reads them from global memory.  The source
note says what bounds them on the card and what the designs do about it.

`nms_greedy` launches a kernel for CUDA tensors, the streaming one above
`MAX_K`, and takes the plain version, `nms_greedy_plain`, only for CPU
tensors.  All return what the JAX function returns: `keep_idx` holds the
picks in pick order, then the unpicked indices in ascending order, then
zeros when K < max_det; `keep_valid` marks the picks.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import load_library

NEG_INF = -1e10
# candidates that fit one block's shared memory (28 bytes each); larger
# candidate sets go to the streaming variant
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
    if lib.nms_greedy_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.nms_greedy_launch.argtypes = [ptr, ptr, i32, i32, i32, ctypes.c_float,
                                          ptr, ptr, ptr]
        lib.nms_greedy_stream_launch.argtypes = [ptr, ptr, i32, i32, i32,
                                                 ctypes.c_float, ptr, ptr, ptr, ptr]
        lib.nms_greedy_launch.restype = lib.nms_greedy_stream_launch.restype = i32
    return lib


def _check(name, boxes, scores):
    """Shape and device checks; True when the plain version should run."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"expected boxes (B, K, 4) and scores (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores must be on one device")
    if boxes.device.type == "cpu":
        return True
    if boxes.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {boxes.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 boxes and scores")
    if boxes.shape[1] == 0:
        raise ValueError(f"{name} needs at least one candidate per image")
    return False


def _launch(name, boxes, scores, iou_thres, max_det, scratch):
    b, k, _ = boxes.shape
    boxes, scores = boxes.contiguous(), scores.contiguous()
    if boxes.data_ptr() % 16:  # the streaming kernel reads a box as one float4
        boxes = boxes.clone()
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=boxes.device)
    keep_valid = torch.empty((b, max_det), dtype=torch.bool, device=boxes.device)
    if b == 0 or max_det == 0:
        return keep_idx, keep_valid, False
    lib = _lib()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        if scratch:
            live = torch.empty((b, k), dtype=torch.float32, device=boxes.device)
            rc = lib.nms_greedy_stream_launch(
                boxes.data_ptr(), scores.data_ptr(), b, k, max_det, float(iou_thres),
                live.data_ptr(), keep_idx.data_ptr(), keep_valid.data_ptr(), stream)
        else:
            rc = lib.nms_greedy_launch(
                boxes.data_ptr(), scores.data_ptr(), b, k, max_det, float(iou_thres),
                keep_idx.data_ptr(), keep_valid.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return keep_idx, keep_valid, True


def nms_greedy(boxes: torch.Tensor, scores: torch.Tensor,
               iou_thres: float = 0.45, max_det: int = 300):
    """Greedy NMS per image (see the module docstring for the outputs).

    A CPU tensor goes through `nms_greedy_plain`; a CUDA tensor launches
    the shared-memory kernel, or `nms_greedy_stream` above MAX_K
    candidates, or raises."""
    if _check("nms_greedy", boxes, scores):
        return nms_greedy_plain(boxes, scores, iou_thres, max_det)
    if boxes.shape[1] > MAX_K:
        return nms_greedy_stream(boxes, scores, iou_thres, max_det)
    keep_idx, keep_valid, launched = _launch("nms_greedy", boxes, scores,
                                             iou_thres, max_det, scratch=False)
    nms_greedy.launches += launched
    return keep_idx, keep_valid


def nms_greedy_stream(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_thres: float = 0.45, max_det: int = 300):
    """Greedy NMS per image through the streaming kernel, for any K.

    A CPU tensor goes through `nms_greedy_plain`; a CUDA tensor launches
    the kernel, or raises."""
    if _check("nms_greedy_stream", boxes, scores):
        return nms_greedy_plain(boxes, scores, iou_thres, max_det)
    keep_idx, keep_valid, launched = _launch("nms_greedy_stream", boxes, scores,
                                             iou_thres, max_det, scratch=True)
    nms_greedy_stream.launches += launched
    return keep_idx, keep_valid


nms_greedy.launches = 0
nms_greedy_stream.launches = 0
