"""Plots: PR and metric curves, the confusion matrix, label statistics,
training curves, evolution scatter, training mosaics and feature maps.

Port of `dmayolo_tpu/utils/plots.py`, host-side, with matplotlib's Agg
backend.  matplotlib is imported inside each plot, where it is needed:
the module imports without it, and a plot raises there, naming it (the
`Trainer` and `cli.train` call plots inside the JAX package's own guards,
so a machine without matplotlib trains without them).  The training
mosaic (`plot_image_grid`) draws with the port's `cvops` and writes with
`imageio`, in place of cv2.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError("the port's plots need matplotlib, which is not installed here") from e
    return plt


def plot_pr_curve(px, py, ap, save_path, names=()):
    """Precision against recall per class and over all classes."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if isinstance(py, list) else py
    if 0 < len(names) < 21:
        for i in range(py.shape[1]):
            ax.plot(px, py[:, i], linewidth=1, label=f"{names[i]} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    ax.plot(px, py.mean(1), linewidth=3, color="blue",
            label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)


def plot_mc_curve(px, py, save_path, names=(), xlabel="Confidence", ylabel="Metric"):
    """A metric against confidence per class, and its class mean."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if 0 < len(names) < 21:
        for i in range(py.shape[0]):
            ax.plot(px, py[i], linewidth=1, label=str(names[i]))
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)


def plot_confusion_matrix(matrix, nc, names=(), save_path="confusion_matrix.png",
                          normalize=True):
    """The (nc + 1) x (nc + 1) matrix, columns normalised, cells under
    0.005 left blank."""
    plt = _plt()
    array = matrix / ((matrix.sum(0).reshape(1, -1) + 1e-9) if normalize else 1)
    array = np.where(array < 0.005, np.nan, array)
    fig, ax = plt.subplots(figsize=(12, 9), tight_layout=True)
    im = ax.imshow(array, cmap="Blues", vmin=0.0)
    fig.colorbar(im)
    labels = list(names) + ["background"] if 0 < len(names) < 99 else None
    n = nc + 1
    for i in range(n):
        for j in range(n):
            v = array[i, j]
            if np.isfinite(v):
                ax.text(j, i, f"{v:.2f}", ha="center", va="center",
                        color="white" if v > 0.5 else "black", fontsize=7)
    if labels:
        ax.set_xticks(range(n))
        ax.set_yticks(range(n))
        ax.set_xticklabels(labels, rotation=90, fontsize=8)
        ax.set_yticklabels(labels, fontsize=8)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)


def plot_labels(labels, names=(), save_dir=Path("")):
    """Label statistics of (n, 5) rows (class, xywh normalised): the class
    histogram, box centres and sizes -> `labels.png`."""
    plt = _plt()
    c = labels[:, 0]
    b = labels[:, 1:5].T
    nc = int(c.max() + 1) if len(c) else 1
    fig, axs = plt.subplots(2, 2, figsize=(8, 8), tight_layout=True)
    axs[0, 0].hist(c, bins=np.linspace(0, nc, nc + 1) - 0.5, rwidth=0.8)
    axs[0, 0].set_ylabel("instances")
    if 0 < len(names) < 30:
        axs[0, 0].set_xticks(range(len(names)))
        axs[0, 0].set_xticklabels(names, rotation=90, fontsize=8)
    else:
        axs[0, 0].set_xlabel("classes")
    axs[0, 1].scatter(b[0], b[1], c=c, cmap="tab20", s=3, alpha=0.5)
    axs[0, 1].set_xlabel("x")
    axs[0, 1].set_ylabel("y")
    axs[1, 0].scatter(b[2], b[3], c=c, cmap="tab20", s=3, alpha=0.5)
    axs[1, 0].set_xlabel("width")
    axs[1, 0].set_ylabel("height")
    axs[1, 1].hist2d(b[2], b[3], bins=50, cmap="Blues")
    axs[1, 1].set_xlabel("width")
    axs[1, 1].set_ylabel("height")
    fig.savefig(Path(save_dir) / "labels.png", dpi=200)
    plt.close(fig)


def plot_results(csv_path, save_path=None):
    """Each column of `results.csv` but the epoch against the epoch ->
    `results.png` beside it (or `save_path`)."""
    import csv as csvmod

    plt = _plt()
    csv_path = Path(csv_path)
    with open(csv_path) as f:
        rows = list(csvmod.DictReader(f))
    if not rows:
        return
    keys = [k for k in rows[0] if k not in ("epoch",) and any(r.get(k) for r in rows)]
    epochs = [int(r["epoch"]) for r in rows]
    n = len(keys)
    cols = min(n, 5)
    rows_n = -(-n // cols)
    fig, axs = plt.subplots(rows_n, cols, figsize=(3 * cols, 3 * rows_n), tight_layout=True)
    axs = np.atleast_1d(axs).ravel()
    for i, k in enumerate(keys):
        ys = [float(r[k]) if r.get(k) else np.nan for r in rows]
        axs[i].plot(epochs, ys, marker=".", linewidth=1, markersize=4)
        axs[i].set_title(k, fontsize=9)
    for j in range(len(keys), len(axs)):
        axs[j].axis("off")
    fig.savefig(save_path or csv_path.with_name("results.png"), dpi=200)
    plt.close(fig)


def plot_image_grid(images, targets_list=None, names=(), save_path="train_batch.png",
                    max_images=16):
    """A mosaic of up to `max_images` RGB uint8 images with their
    (class, cx, cy, w, h) normalised boxes and labels, written as an image
    file (PNG or JPEG by the suffix)."""
    from ..data import cvops
    from ..data.imageio import imwrite

    n = min(len(images), max_images)
    cols = int(np.ceil(np.sqrt(n)))
    rows = -(-n // cols)
    h, w = images[0].shape[:2]
    canvas = np.full((rows * h, cols * w, 3), 255, np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        im = np.ascontiguousarray(images[i]).copy()
        if targets_list is not None and len(targets_list[i]):
            for cls, cx, cy, bw, bh in targets_list[i]:
                x1 = int((cx - bw / 2) * w)
                y1 = int((cy - bh / 2) * h)
                x2 = int((cx + bw / 2) * w)
                y2 = int((cy + bh / 2) * h)
                cvops.rectangle(im, (x1, y1), (x2, y2), (255, 60, 60), 2)
                label = names[int(cls)] if int(cls) < len(names) else str(int(cls))
                cvops.put_text(im, str(label), (x1, max(y1 - 3, 8)), 0.4, (255, 60, 60), 1)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    imwrite(str(save_path), canvas[:, :, ::-1])


def feature_visualization(x, module_type: str, stage: int, n: int = 32,
                          save_dir=Path("runs/features")):
    """Per-stage feature-map PNGs of the first image of an NHWC array,
    up to `n` channels in rows of 8 (the reference's utils/plots.py:423-447,
    hooked at yolo.py:237-238).  Returns the PNG's path, or None for an
    output that is not a map."""
    plt = _plt()
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    x = np.asarray(x)
    if x.ndim != 4:
        return None
    _, h, w, c = x.shape
    if h <= 1 or w <= 1:
        return None
    blocks = x[0].transpose(2, 0, 1)  # (C, H, W)
    n = min(n, c)
    cols = 8
    rows = -(-n // cols)
    fig, axs = plt.subplots(rows, cols, figsize=(cols * 1.5, rows * 1.5), tight_layout=True)
    axs = np.atleast_1d(axs).ravel()
    for i in range(n):
        axs[i].imshow(blocks[i], cmap="viridis")
        axs[i].axis("off")
    for j in range(n, len(axs)):
        axs[j].axis("off")
    f = save_dir / f"stage{stage}_{module_type.replace('.', '_')}_features.png"
    fig.savefig(f, dpi=150)
    plt.close(fig)
    return f


def plot_evolve(evolve_csv, save_path=None):
    """Each evolved hyperparameter against fitness, the best marked; from
    `evolve.csv` (["fitness", *hyp keys], `train/evolve.py`).  Returns the
    PNG's path."""
    import csv as _csv

    plt = _plt()
    evolve_csv = Path(evolve_csv)
    with open(evolve_csv) as f:
        rows = list(_csv.reader(f))
    keys = [k.strip() for k in rows[0]]
    data = np.asarray([[float(v) for v in r] for r in rows[1:]], np.float64)
    fit = data[:, 0]
    j = int(np.argmax(fit))
    hyp_keys = keys[1:]
    cols = 5
    nrows = -(-len(hyp_keys) // cols)
    fig, axs = plt.subplots(nrows, cols, figsize=(10, 2 * nrows), tight_layout=True)
    axs = np.atleast_1d(axs).ravel()
    for i, k in enumerate(hyp_keys):
        v = data[:, 1 + i]
        mu = v[j]
        axs[i].scatter(v, fit, c=fit, cmap="viridis", alpha=0.8, edgecolors="none", s=12)
        axs[i].plot(mu, fit.max(), "k+", markersize=12)
        axs[i].set_title(f"{k} = {mu:.3g}", fontsize=8)
        axs[i].tick_params(labelsize=6)
        if i % cols != 0:
            axs[i].set_yticks([])
    for jx in range(len(hyp_keys), len(axs)):
        axs[jx].axis("off")
    f = Path(save_path) if save_path else evolve_csv.with_suffix(".png")
    fig.savefig(f, dpi=200)
    plt.close(fig)
    return f
