"""Feature-map plots for `detect --visualize`.

Port of `dmayolo_tpu/utils/plots.py::feature_visualization` only; the
training plots of that module are ROADMAP.md Queue 1 item 15c.
matplotlib is imported inside the function, where it is needed: a
machine without it raises there, naming it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def feature_visualization(x, module_type: str, stage: int, n: int = 32,
                          save_dir=Path("runs/features")):
    """Per-stage feature-map PNGs of the first image of an NHWC array,
    up to `n` channels in rows of 8 (the reference's utils/plots.py:423-447,
    hooked at yolo.py:237-238).  Returns the PNG's path, or None for an
    output that is not a map."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError("--visualize needs matplotlib, which is not installed here; "
                           "the port's plots are ROADMAP.md Queue 1 item 15c") from e
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
