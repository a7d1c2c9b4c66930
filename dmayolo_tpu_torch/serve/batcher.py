"""Micro-batching inference: coalesce concurrent requests into one device
batch.

Port of `dmayolo_tpu/serve/batcher.py::MicroBatcher`.  One dispatcher
thread drains the request queue:

- requests wait at most `max_wait_ms` for co-riders;
- every image is letterboxed on the batcher's device to one (imgsz, imgsz)
  square;
- the batch is padded up to a power-of-two bucket (1, 2, 4, ..., max_batch);
- the serve step is the bench path: uint8 / 255 in the compute dtype, the
  BN-folded forward, `decode_parts` and `nms_parts` (the "matrix" backend,
  kernel K3, by default);
- results are letterbox-inverted to each request's native pixel space on
  the host.

A request whose image fails preprocessing fails alone; an error in the
device batch goes to every request of that batch, and serving goes on.
"""
from __future__ import annotations

import copy
import queue
import threading
import time
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.letterbox import letterbox
from ..eval.validator import _scale_to_native
from ..utils.device import resolve_device

_STOP = object()


class _Request:
    __slots__ = ("img", "shape0", "event", "dets", "error")

    def __init__(self, img: np.ndarray):
        self.img = img
        self.shape0 = img.shape[:2]
        self.event = threading.Event()
        self.dets: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until this request's batch has run.  Returns (n, 6)
        [x1, y1, x2, y2, conf, cls] in the image's native pixel space."""
        if not self.event.wait(timeout):
            raise TimeoutError("inference result not ready")
        if self.error is not None:
            raise self.error
        return self.dets


def _buckets(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class MicroBatcher:
    """Request-coalescing wrapper around one serve step.

    Args:
        model: a DetectionModel with UNFUSED weights; the batcher folds the
            BNs into a copy on `device` (None means CUDA).
        imgsz: letterbox square every request is resized into.
        max_batch: device batch ceiling.
        max_wait_ms: how long the first request of a batch waits for
            co-riders; 0 still drains whatever is already queued.
        nms_backend: "matrix" (the CUDA kernel K3), "pallas" (K2) or "scan"
            (the plain loop).
        names: class names by index (the REST API's "name" field);
            "0", "1", ... by default.
    """

    def __init__(self, model, *, imgsz: int = 640, max_batch: int = 32,
                 max_wait_ms: float = 5.0, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, max_det: int = 300,
                 max_nms: int = 512, dtype=torch.bfloat16,
                 nms_backend: str = "matrix", device=None,
                 names: Optional[Sequence[str]] = None):
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model).to(self.device).fuse().eval()
        self.imgsz = int(imgsz)
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self._bucket_sizes = _buckets(self.max_batch)
        self._serve_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                              max_det=max_det, max_nms=max_nms,
                              backend=nms_backend)
        self.dtype = dtype
        self.names = list(names) if names else [str(i) for i in range(model.nc)]

        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self.stats_counters = {"requests": 0, "batches": 0,
                               "batch_hist": Counter(), "padded_rows": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dmayolo-microbatcher")
        self._thread.start()

    def _serve(self, x: torch.Tensor):
        """uint8 (B, S, S, 3) on the device -> (dets, valid) on the device."""
        with torch.inference_mode():
            xf = x.to(self.dtype) / 255.0
            raw = self.model.apply(xf, dtype=self.dtype, fused=True)
            return self.model.serve_detections(raw, **self._serve_kw)

    # ---------------------------------------------------------------- API

    def submit(self, img_rgb: np.ndarray) -> _Request:
        """Enqueue one HWC RGB uint8 image; returns a waitable handle."""
        img = np.asarray(img_rgb)
        if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
            raise ValueError(f"expected non-empty HWC RGB image, got shape {img.shape}")
        if img.dtype != np.uint8:
            raise ValueError(f"expected uint8 pixels, got {img.dtype}")
        req = _Request(img)
        # enqueue under the lock: close() sets _closed and puts _STOP under
        # the same lock, so no request lands behind the sentinel
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put(req)
        return req

    def __call__(self, img_rgb: np.ndarray,
                 timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(img_rgb).result(timeout)

    def warmup(self) -> None:
        """Run every batch bucket once, so first requests pay no set-up."""
        for b in self._bucket_sizes:
            z = torch.zeros((b, self.imgsz, self.imgsz, 3), dtype=torch.uint8,
                            device=self.device)
            dets, _ = self._serve(z)
            dets.cpu()

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_STOP)
        self._thread.join(timeout)

    # --------------------------------------------------------------- loop

    def _loop(self):
        stop = False
        while not stop:
            item = self._q.get()
            if item is _STOP:
                break
            batch = [item]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                wait = deadline - time.monotonic()
                try:
                    nxt = self._q.get(timeout=wait) if wait > 0 else self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            self._run(batch)

    def _run(self, batch: List[_Request]):
        sz = self.imgsz
        ok: List[_Request] = []
        tiles = []
        for req in batch:
            try:
                tiles.append(letterbox(req.img, (sz, sz), auto=False,
                                       device=self.device)[0])
                ok.append(req)
            except BaseException as e:  # this request fails alone, whatever it raised
                req.error = e
                req.event.set()
        batch = ok
        if not batch:
            return
        try:
            bucket = next(b for b in self._bucket_sizes if b >= len(batch))
            imgs = torch.zeros((bucket, sz, sz, 3), dtype=torch.uint8,
                               device=self.device)
            imgs[:len(batch)] = torch.stack(tiles)
            dets, valid = self._serve(imgs)
            dets = dets.float().cpu().numpy()
            valid = valid.cpu().numpy()
            for i, req in enumerate(batch):
                d = dets[i][valid[i]].copy()
                d[:, :4] = _scale_to_native(d[:, :4], (sz, sz), req.shape0)
                req.dets = d
                req.event.set()
            self.stats_counters["requests"] += len(batch)
            self.stats_counters["batches"] += 1
            self.stats_counters["batch_hist"][len(batch)] += 1
            self.stats_counters["padded_rows"] += bucket - len(batch)
        except BaseException as e:  # to every waiter of this batch; keep serving
            for req in batch:
                if not req.event.is_set():
                    req.error = e
                    req.event.set()
