"""Batching with background threads.

Port of `dmayolo_tpu/data/loader.py`: a thread pool reads and augments the
samples (the image loops release the GIL) and yields fixed-shape batches
in order:

    images:  uint8 NHWC (normalised on the device)
    targets: dense Targets(cls (B, M), xywhn (B, M, 4), mask (B, M))

A fixed M (max_targets) keeps every train step's shapes the same.  Each
sample draws its augmentation from `random.Random(hash((seed, epoch,
index)))`, so a batch is the same bytes at any number of workers.
"""
from __future__ import annotations

import logging
import queue
import random
import threading
from typing import Any, Iterator, NamedTuple, Optional

import numpy as np

from . import cvops
from ..train.loss import Targets

log = logging.getLogger(__name__)


class Batch(NamedTuple):
    """uint8 images (B, H, W, 3), their Targets, and the dataset index of
    each row (None for in-memory batches)."""

    images: Any
    targets: Targets
    indices: Optional[list] = None


class _Warn:
    """Warn once a loader that labels were dropped."""

    def __init__(self):
        self.done = False
        self.lock = threading.Lock()


def collate(samples, max_targets: int, indices=None, warn: Optional[_Warn] = None) -> Batch:
    """Stack (img, labels) pairs into dense arrays; labels past
    `max_targets` an image are dropped, with a warning (once a loader)."""
    imgs = np.stack([s[0] for s in samples])
    b = len(samples)
    cls = np.zeros((b, max_targets), np.float32)
    box = np.zeros((b, max_targets, 4), np.float32)
    mask = np.zeros((b, max_targets), bool)
    for i, (_, lb) in enumerate(samples):
        n = min(len(lb), max_targets)
        if len(lb) > max_targets and warn is not None:
            with warn.lock:
                first, warn.done = not warn.done, True
            if first:
                log.warning("collate: %d labels exceed max_targets=%d; the excess is dropped"
                            " (raise max_targets to keep them)", len(lb), max_targets)
        if n:
            cls[i, :n] = lb[:n, 0]
            box[i, :n] = lb[:n, 1:5]
            mask[i, :n] = True
    return Batch(imgs, Targets(cls, box, mask), indices)


class DataLoader:
    """Epoch iterator with prefetch threads.

    process_index / process_count: data-parallel loading, as the JAX
    loader's process stripe.  Every rank draws the same global order (the
    same seed) and reads only its contiguous row block of each global
    batch of `batch_size`: `local_bs = batch_size // process_count` rows
    (the reference's DistributedSampler with batch_size // WORLD_SIZE).
    A short last batch (`drop_last=False`) is wrap-padded to the global
    size, so every rank gets `local_bs` rows; with `wrap_short=False` it is
    not, and a rank's block may be short or empty (a `Batch` of no images,
    `images` None), for the validator to zero-pad."""

    sample_weights = None  # per-image sampling weights (image_weights mode)

    def __init__(self, dataset, batch_size: int, max_targets: int = 128, shuffle: bool = True,
                 workers: int = 4, seed: int = 0, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1, quad: bool = False,
                 wrap_short: bool = True):
        if batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} must be divisible by the "
                             f"process count {process_count}")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} of {process_count}")
        self.process_index = process_index
        self.process_count = process_count
        self.local_bs = batch_size // process_count
        self.wrap_short = wrap_short
        self.ds = dataset
        self.bs = batch_size
        self.max_targets = max_targets
        self.shuffle = shuffle
        self.workers = max(1, workers)
        self.rng = np.random.default_rng(seed)
        self._seed = seed
        self.drop_last = drop_last
        self.quad = quad  # each item of a batch of 4 tiled or upscaled 2x
        self._epoch = 0  # folded into the sample rng
        self._warn = _Warn()

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def _batches(self) -> Iterator[list]:
        n = len(self.ds)
        if self.sample_weights is not None:  # resample the indices by image weight
            w = np.asarray(self.sample_weights, np.float64)
            w = w / w.sum()
            order = self.rng.choice(n, size=n, replace=True, p=w)
        else:
            order = np.arange(n)
            if self.shuffle:
                self.rng.shuffle(order)
        lo = self.process_index * self.local_bs
        for i in range(len(self)):
            g = order[i * self.bs:(i + 1) * self.bs]
            if self.process_count > 1 and len(g) < self.bs and self.wrap_short:
                g = np.resize(g, self.bs)  # wrap-pad (DistributedSampler-style)
            yield g[lo:lo + self.local_bs].tolist()

    def __iter__(self) -> Iterator[Batch]:
        work: "queue.Queue" = queue.Queue()
        out: "queue.Queue" = queue.Queue(maxsize=2 * self.workers)
        batches = list(self._batches())
        for j, b in enumerate(batches):
            work.put((j, b))
        done = threading.Event()
        self._epoch += 1
        epoch = self._epoch

        def put(item):
            # a consumer that stops early must not leave a worker blocked
            while not done.is_set():
                try:
                    out.put(item, timeout=0.2)
                    return
                except queue.Full:
                    continue

        def worker():
            while not done.is_set():
                try:
                    j, idxs = work.get_nowait()
                except queue.Empty:
                    return
                if not idxs:  # this rank's block of a short last batch is empty
                    put((j, Batch(None, None, [])))
                    continue
                try:
                    samples = [self.ds.get(i, random.Random(hash((self._seed, epoch, int(i)))))
                               for i in idxs]
                    if self.quad:
                        rng = np.random.default_rng((self._seed, epoch, j))
                        put((j, collate_quad(samples, self.max_targets, rng=rng, indices=idxs,
                                             warn=self._warn)))
                    else:
                        put((j, collate(samples, self.max_targets, idxs, self._warn)))
                except BaseException as e:  # raised in the consumer, never a hang
                    put((j, e))
                    return

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.workers)]
        for t in threads:
            t.start()
        try:
            next_j, pending = 0, {}
            for _ in range(len(batches)):
                while next_j not in pending:
                    j, batch = out.get()
                    if isinstance(batch, BaseException):
                        raise batch
                    pending[j] = batch
                yield pending.pop(next_j)
                next_j += 1
        finally:
            done.set()
            for t in threads:
                t.join()


def collate_quad(samples, max_targets: int, rng=None, indices=None,
                 warn: Optional[_Warn] = None) -> Batch:
    """Quad collate: each group of four becomes one item at twice the
    resolution, either the first image upscaled 2x or a 2x2 tile of the
    four.  A tail short of four is upscaled image by image."""
    rng = rng or random
    out = []
    out_idx = [] if indices is not None else None
    n4 = len(samples) - len(samples) % 4
    for i in range(0, n4, 4):
        group = samples[i:i + 4]
        h, w = group[0][0].shape[:2]
        if rng.random() < 0.5:  # upscale one image
            im = cvops.resize(group[0][0], (2 * w, 2 * h), cvops.INTER_LINEAR)
            lb = group[0][1]
        else:  # 2x2 tile; labels shifted and halved into their quadrant
            top = np.concatenate([group[0][0], group[1][0]], axis=1)
            bot = np.concatenate([group[2][0], group[3][0]], axis=1)
            im = np.concatenate([top, bot], axis=0)
            parts = []
            offs = [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5)]
            for (ox, oy), (_, l) in zip(offs, group):
                if len(l):
                    l = l.copy()
                    l[:, 1] = l[:, 1] * 0.5 + ox
                    l[:, 2] = l[:, 2] * 0.5 + oy
                    l[:, 3:5] *= 0.5
                    parts.append(l)
            lb = np.concatenate(parts, 0) if parts else np.zeros((0, 5), np.float32)
        out.append((im, lb))
        if out_idx is not None:
            out_idx.append(indices[i])  # the group's first index
    for i in range(n4, len(samples)):
        im, lb = samples[i][0], samples[i][1]
        h, w = im.shape[:2]
        out.append((cvops.resize(im, (2 * w, 2 * h), cvops.INTER_LINEAR), lb))
        if out_idx is not None:
            out_idx.append(indices[i])
    return collate(out, max_targets, out_idx, warn)


def pad_to_batch(imgs: np.ndarray, targets: Targets, bs: int):
    """Pad a short final batch to bs rows (mask false on the padding);
    returns (images, targets, valid (bs,))."""
    n = imgs.shape[0]
    if n == bs:
        return imgs, targets, np.ones(bs, bool)
    pad = bs - n

    def _pad(a, dtype):
        a = np.asarray(a)
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], dtype)])

    imgs = _pad(imgs, imgs.dtype)
    t = Targets(_pad(targets.cls, np.float32), _pad(targets.box, np.float32),
                _pad(targets.mask, bool))
    return imgs, t, np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
