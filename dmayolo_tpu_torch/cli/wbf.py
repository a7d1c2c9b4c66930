"""Offline WBF ensembling of saved prediction txts.

Port of `dmayolo_tpu/cli/wbf.py`: reads N runs' `labels/*.txt` (xywhn +
conf, from `val` or `detect` with --save-txt --save-conf), fuses each
image's boxes with `weighted_boxes_fusion` (IoU 0.67, skip 0.01 by
default) and writes fused txt files, with 1-indexed classes unless
--no-one-indexed-cls.

    python -m dmayolo_tpu_torch.cli.wbf runs/val/a/labels runs/detect/b/labels --out runs/wbf/labels
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..core.wbf import weighted_boxes_fusion


def build_parser():
    p = argparse.ArgumentParser("dmayolo-wbf")
    p.add_argument("dirs", nargs="+", help="label dirs from val --save-txt --save-conf")
    p.add_argument("--out", type=str, default="runs/wbf/labels")
    p.add_argument("--iou-thr", type=float, default=0.67)
    p.add_argument("--skip-box-thr", type=float, default=0.01)
    p.add_argument("--weights", type=float, nargs="+", default=None)
    p.add_argument("--conf-type", choices=("avg", "max"), default="avg")
    p.add_argument("--allows-overflow", action="store_true")
    # the reference writes 1-indexed classes (ref wbf.py:70-77); opt out
    # with --no-one-indexed-cls to keep the txts val/detect-compatible
    p.add_argument("--one-indexed-cls", action=argparse.BooleanOptionalAction,
                   default=True)
    return p


def read_txt(path: Path):
    """(n,) cls, (n,4) xyxy-normalised, (n,) conf from xywhn+conf rows."""
    if not path.exists():
        return np.zeros(0), np.zeros((0, 4)), np.zeros(0)
    rows = np.array(
        [ln.split() for ln in path.read_text().strip().splitlines() if ln], np.float64
    ) if path.read_text().strip() else np.zeros((0, 6))
    if rows.size == 0:
        return np.zeros(0), np.zeros((0, 4)), np.zeros(0)
    cls = rows[:, 0]
    cx, cy, w, h = rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4]
    conf = rows[:, 5] if rows.shape[1] > 5 else np.ones(len(rows))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1).clip(0, 1)
    return cls, boxes, conf


def main(argv=None):
    opt = build_parser().parse_args(argv)
    dirs = [Path(d) for d in opt.dirs]
    out = Path(opt.out)
    out.mkdir(parents=True, exist_ok=True)

    stems = sorted({p.stem for d in dirs for p in d.glob("*.txt")})
    print(f"fusing {len(dirs)} models over {len(stems)} images")
    for stem in stems:
        boxes_l, scores_l, labels_l = [], [], []
        for d in dirs:
            cls, boxes, conf = read_txt(d / f"{stem}.txt")
            labels_l.append(cls)
            boxes_l.append(boxes)
            scores_l.append(conf)
        boxes, scores, labels = weighted_boxes_fusion(
            boxes_l, scores_l, labels_l, weights=opt.weights,
            iou_thr=opt.iou_thr, skip_box_thr=opt.skip_box_thr,
            conf_type=opt.conf_type, allows_overflow=opt.allows_overflow,
        )
        lines = []
        for (x1, y1, x2, y2), s, l in zip(boxes, scores, labels):
            c = int(l) + (1 if opt.one_indexed_cls else 0)  # ref wbf.py:70-77
            lines.append(
                f"{c} {(x1+x2)/2:.6f} {(y1+y2)/2:.6f} {x2-x1:.6f} {y2-y1:.6f} {s:.6f}"
            )
        (out / f"{stem}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
    print(f"wrote fused labels -> {out}")


if __name__ == "__main__":
    main()
