"""AutoAnchor: the best-possible-recall check and k-means + GA anchor
evolution, on the host in numpy and scipy.

Port of `dmayolo_tpu/train/autoanchor.py`, with its random draws as they
are: `check_anchors` jitters with the global `np.random.uniform`, scipy's
`kmeans` draws from the global NumPy state, and the GA from
`default_rng(seed)`, so one global seed gives both packages the same
anchors.  `dataset` is any object with `.shapes` (N, 2) image sizes as
(h, w) and `.labels`, a list of (n, 5) [cls, x, y, w, h] arrays (normalised
xywh).
"""
from __future__ import annotations

import numpy as np


def _metric(k, wh):
    """Each box's best ratio metric: the best over anchors of
    min(r, 1/r).min over (w, h)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        # zero (placeholder) anchors give inf ratios -> metric 0, handled by
        # the degenerate-anchor rule of maybe_autoanchor
        r = wh[:, None] / k[None]
        x = np.minimum(r, 1 / r).min(2)  # (n, k)
    best = x.max(1)
    return x, best


def anchor_fitness(k, wh, thr):
    _, best = _metric(k, wh)
    return (best * (best > thr)).mean()


def dataset_wh(shapes, labels, img_size: int):
    """Pixel box wh of each label at the training scale (normalised wh
    times the letterboxed image size), boxes under 2 px on both sides
    dropped."""
    wh = np.concatenate(
        [l[:, 3:5] * (img_size * shp[::-1] / shp.max()) for l, shp in zip(labels, shapes) if len(l)]
    )
    return wh[(wh >= 2.0).any(1)]


def check_anchors(anchors_px: np.ndarray, shapes: np.ndarray, labels, img_size: int,
                  thr: float = 4.0):
    """(bpr, aat): best possible recall and anchors above threshold per
    label, over the labels' wh jittered by uniform(0.9, 1.1)."""
    wh = dataset_wh(shapes, labels, img_size)
    wh = wh * np.random.uniform(0.9, 1.1, size=(wh.shape[0], 1))
    x, best = _metric(anchors_px.reshape(-1, 2), wh)
    aat = (x > 1 / thr).sum(1).mean()
    bpr = (best > 1 / thr).mean()
    return float(bpr), float(aat)


def kmean_anchors(shapes, labels, n: int = 9, img_size: int = 640, thr: float = 4.0,
                  gen: int = 1000, seed: int = 0, verbose: bool = False) -> np.ndarray:
    """`n` anchors (pixels, sorted by area): scipy k-means on the whitened
    label wh, then `gen` generations of the mutation GA."""
    from scipy.cluster.vq import kmeans

    npr = np.random.default_rng(seed)
    thr = 1 / thr
    wh0 = dataset_wh(shapes, labels, img_size)
    wh = wh0[(wh0 >= 2.0).any(1)]

    def fitness(k):
        r = wh[:, None] / k[None]
        x = np.minimum(r, 1 / r).min(2)
        best = x.max(1)
        return (best * (best > thr)).mean()

    s = wh.std(0)
    k = kmeans(wh / s, n, iter=30)[0] * s
    if len(k) != n:  # fewer distinct points than anchors: draw from the data's range
        k = np.sort(npr.uniform(wh.min(0), wh.max(0), (n, 2)), 0)
    k = k[np.argsort(k.prod(1))]

    f, sh, mp, sigma = fitness(k), k.shape, 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((npr.random(sh) < mp) * npr.random() * npr.normal(size=sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = fitness(kg)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        print(f"autoanchor: fitness={f:.4f} anchors={np.round(k).astype(int).tolist()}")
    return k


def maybe_autoanchor(model, dataset, img_size: int, thr: float = 4.0,
                     bpr_thresh: float = 0.98, verbose: bool = True):
    """Check the Detect head's anchors on `dataset` and re-cluster them when
    the best possible recall is under `bpr_thresh`, or always when they
    are degenerate (the `anchors: <int>` placeholders); the new set
    replaces the head's (stride units) when its recall is higher, or the
    old set was degenerate.  Returns the recall kept, or None for a head
    without anchors."""
    from ..nn.heads import Detect

    head = model.head
    if not isinstance(head, Detect):
        return None
    shapes = np.asarray(dataset.shapes, np.float64)
    anchors_px = head.anchors * model.stride.reshape(-1, 1, 1)
    bpr, aat = check_anchors(anchors_px, shapes, dataset.labels, img_size, thr)
    if verbose:
        print(f"autoanchor: BPR={bpr:.4f}, {aat:.2f} anchors/target")
    degenerate = float(np.min(anchors_px)) <= 0
    if bpr >= bpr_thresh and not degenerate:
        return bpr
    n = head.nl * head.na
    new = kmean_anchors(shapes, dataset.labels, n=n, img_size=img_size, thr=thr,
                        verbose=verbose)
    new_bpr, _ = check_anchors(new.reshape(head.nl, head.na, 2), shapes,
                               dataset.labels, img_size, thr)
    if new_bpr > bpr or degenerate:
        head.anchors = (
            new.reshape(head.nl, head.na, 2) / model.stride.reshape(-1, 1, 1)
        ).astype(np.float32)
        if verbose:
            print(f"autoanchor: updated anchors (BPR {new_bpr:.4f})")
        return new_bpr
    return max(bpr, new_bpr)
