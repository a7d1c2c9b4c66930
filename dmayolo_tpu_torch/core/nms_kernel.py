"""Greedy NMS per image: the CUDA kernel K2 and its plain version.

Port of `dmayolo_tpu/core/pallas_nms.py::pallas_batched_nms_core`.  Three
kernels in `csrc/nms_greedy.cu` run the whole pick/suppress loop of one
image, routed by K:
  * K <= 1024 (serving): a block of four warps an image, each lane
    holding up to 8 candidates in registers, with one barrier a step;
  * above that, `nms_greedy_stream`: a thread-block cluster an image, the
    candidates spread over its blocks' shared memory (`plan_stream` picks
    the cluster size), up to the capacity of 8 blocks (about 90,000);
  * beyond the capacity: one block an image reading the candidates from
    global memory.
The source note says what bounds them on the card and what the designs
do about it.

`nms_greedy` launches a kernel for CUDA tensors, the streaming ones above
`MAX_K`, and takes the plain version, `nms_greedy_plain`, only for CPU
tensors.  All return what the JAX function returns: `keep_idx` holds the
picks in pick order, then the unpicked indices in ascending order, then
zeros when K < max_det; `keep_valid` marks the picks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.cuda_build import load_library

NEG_INF = -1e10
# candidates one block of four warps holds in registers; larger candidate
# sets go to the streaming variant
MAX_K = 1024
CLUSTER_SIZES = tuple(range(1, 9))  # 8: the largest portable cluster
CLUSTER_THREADS = 1024  # threads of a cluster kernel's block
# shared memory a cluster kernel's block keeps for its static arrays
_CLUSTER_STATIC = 1024
# the fixed part of a cluster kernel's step (block barrier, pushing the
# winner, waiting for the cluster's), counted in candidates a thread
# passes over; fitted to one image's time by cluster size on the H100
# (chip_smoke.py, "one_image_ms_by_cluster")
_CLUSTER_STEP = 8


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


def stream_smem(k: int, cluster: int) -> int:
    """Dynamic shared memory of a cluster kernel's block: its slice of the
    candidates, 20 bytes each (box and live score), and a picked bitmap."""
    piece = -(-k // cluster)
    return piece * 20 + -(-piece // 32) * 4


def plan_stream(b: int, k: int, n_sm: int, max_clusters, smem_bytes: int):
    """The cluster size of K2 streaming for B images of K candidates.

    Args:
        n_sm: the card's SM count.
        max_clusters: {cluster size: clusters the card holds at once}
            (`cudaOccupancyMaxActiveClusters`) for the sizes that fit.
        smem_bytes: the shared memory a block may opt into.
    Returns (cluster, slice), each block holding `slice` candidates, or
    None when K is above what 8 blocks hold (the global-memory kernel's
    route).  Of the sizes that fit, the one with the least time a step:
    rounds (waves of clusters, or blocks sharing an SM) times the
    candidates a thread passes over plus the step's fixed part.  Raises
    when K fits but the card holds no cluster of any fitting size."""
    fits = cluster_sizes(k, smem_bytes)
    if not fits:
        return None
    usable = [c for c in fits if max_clusters.get(c, 0) > 0]
    if not usable:
        raise RuntimeError(f"no cluster of {fits} blocks fits the card for K={k} "
                           f"(occupancy {max_clusters})")

    def cost(c):
        rounds = max(-(-b // max_clusters[c]), -(-b * c // n_sm))
        per_thread = -(-(-(-k // c)) // CLUSTER_THREADS)
        return rounds * (per_thread + _CLUSTER_STEP)

    c = min(usable, key=lambda c: (cost(c), c))
    return c, -(-k // c)


def _device_limits(device):
    """(SM count, shared memory a block may opt into) of the card."""
    n_sm, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = _lib().nms_greedy_device_limits(ctypes.byref(n_sm), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"K2 streaming: device query failed: CUDA error {rc}")
    return n_sm.value, smem.value


def cluster_sizes(k: int, smem_bytes: int):
    """The cluster sizes whose blocks hold K candidates in shared memory."""
    return [c for c in CLUSTER_SIZES if stream_smem(k, c) + _CLUSTER_STATIC <= smem_bytes]


def cluster_occupancy(device, k: int):
    """{cluster size: clusters the card holds at once} for the sizes whose
    blocks hold K candidates (`cudaOccupancyMaxActiveClusters`)."""
    occ = {}
    with torch.cuda.device(device):
        for c in cluster_sizes(k, _device_limits(device)[1]):
            n = ctypes.c_int()
            rc = _lib().nms_greedy_cluster_occupancy(k, c, ctypes.byref(n))
            if rc != 0:
                raise RuntimeError(f"K2 streaming: occupancy query for clusters of "
                                   f"{c} failed: CUDA error {rc}")
            occ[c] = n.value
    return occ


@functools.lru_cache(maxsize=64)
def _stream_plan_on(device_index: int, b: int, k: int):
    device = torch.device("cuda", device_index)
    n_sm, smem = _device_limits(device)
    return plan_stream(b, k, n_sm, cluster_occupancy(device, k), smem)


def _stream_plan(device: torch.device, b: int, k: int):
    """`plan_stream` with this card's numbers, cached by (device, B, K)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _stream_plan_on(index, b, k)


def _lib():
    lib = load_library("nms_greedy")
    if lib.nms_greedy_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.nms_greedy_launch.argtypes = [ptr, ptr, i32, i32, i32, ctypes.c_float,
                                          ptr, ptr, ptr]
        lib.nms_greedy_stream_launch.argtypes = [ptr, ptr, i32, i32, i32,
                                                 ctypes.c_float, ptr, ptr, ptr, ptr]
        lib.nms_greedy_cluster_launch.argtypes = [ptr, ptr, i32, i32, i32, ctypes.c_float,
                                                  i32, ptr, ptr, ptr]
        lib.nms_greedy_cluster_occupancy.argtypes = [i32, i32, ptr]
        lib.nms_greedy_device_limits.argtypes = [ptr, ptr]
        for fn in (lib.nms_greedy_launch, lib.nms_greedy_stream_launch,
                   lib.nms_greedy_cluster_launch, lib.nms_greedy_cluster_occupancy,
                   lib.nms_greedy_device_limits):
            fn.restype = i32
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


def _launch(name, boxes, scores, iou_thres, max_det, route):
    """Launches the kernel of `route`: "shared" (the group kernel),
    "global", or a cluster size (int).  Returns (keep_idx, keep_valid,
    launched)."""
    b, k, _ = boxes.shape
    boxes, scores = boxes.contiguous(), scores.contiguous()
    if boxes.data_ptr() % 16:  # the kernels read a box as one float4
        boxes = boxes.clone()
    keep_idx = torch.empty((b, max_det), dtype=torch.int32, device=boxes.device)
    keep_valid = torch.empty((b, max_det), dtype=torch.bool, device=boxes.device)
    if b == 0 or max_det == 0:
        return keep_idx, keep_valid, False
    lib = _lib()
    args = (boxes.data_ptr(), scores.data_ptr(), b, k, max_det, float(iou_thres))
    outs = (keep_idx.data_ptr(), keep_valid.data_ptr())
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        if route == "shared":
            rc = lib.nms_greedy_launch(*args, *outs, stream)
        elif route == "global":
            live = torch.empty((b, k), dtype=torch.float32, device=boxes.device)
            rc = lib.nms_greedy_stream_launch(*args, live.data_ptr(), *outs, stream)
        else:
            rc = lib.nms_greedy_cluster_launch(*args, route, *outs, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({route}): CUDA error {rc}")
    return keep_idx, keep_valid, True


def nms_greedy(boxes: torch.Tensor, scores: torch.Tensor,
               iou_thres: float = 0.45, max_det: int = 300):
    """Greedy NMS per image (see the module docstring for the outputs).

    A CPU tensor goes through `nms_greedy_plain`; a CUDA tensor launches
    the group kernel, or `nms_greedy_stream` above MAX_K candidates, or
    raises."""
    if _check("nms_greedy", boxes, scores):
        return nms_greedy_plain(boxes, scores, iou_thres, max_det)
    if boxes.shape[1] > MAX_K:
        return nms_greedy_stream(boxes, scores, iou_thres, max_det)
    keep_idx, keep_valid, launched = _launch("nms_greedy", boxes, scores,
                                             iou_thres, max_det, "shared")
    nms_greedy.launches += launched
    return keep_idx, keep_valid


def nms_greedy_stream(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_thres: float = 0.45, max_det: int = 300):
    """Greedy NMS per image through a streaming kernel, for any K: the
    cluster kernel up to the capacity of 8 blocks' shared memory, the
    global-memory kernel above it (`plan_stream`).

    A CPU tensor goes through `nms_greedy_plain`; a CUDA tensor launches
    the kernel, or raises.  `launches` counts both kernels,
    `cluster_launches` the cluster kernel's alone."""
    if _check("nms_greedy_stream", boxes, scores):
        return nms_greedy_plain(boxes, scores, iou_thres, max_det)
    b, k, _ = boxes.shape
    plan = _stream_plan(boxes.device, b, k)
    route = "global" if plan is None else plan[0]
    keep_idx, keep_valid, launched = _launch("nms_greedy_stream", boxes, scores,
                                             iou_thres, max_det, route)
    nms_greedy_stream.launches += launched
    nms_greedy_stream.cluster_launches += launched and plan is not None
    return keep_idx, keep_valid


nms_greedy.launches = 0
nms_greedy_stream.launches = 0
nms_greedy_stream.cluster_launches = 0
