"""Training logs: `results.csv` always, TensorBoard scalars where
`torch.utils.tensorboard` imports.

Port of `dmayolo_tpu/utils/loggers.py`, the same 13 scalar keys
(`KEYS`).  A row whose columns are new (an epoch that validates after
epochs that did not, with `val_interval` > 1) widens the header: the file
is rewritten with the union of columns through a temporary file and
`os.replace`, so a crash mid-write leaves the old history whole; any other
row is appended.  `finalize` draws `results.png` (`plots.plot_results`,
which needs matplotlib: where it is missing, no plot) and closes.
"""
from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Dict

KEYS = [
    "train/box_loss", "train/obj_loss", "train/cls_loss",
    "metrics/precision", "metrics/recall", "metrics/mAP_0.5", "metrics/mAP_0.5:0.95",
    "val/box_loss", "val/obj_loss", "val/cls_loss",
    "x/lr0", "x/lr1", "x/lr2",
]


class Loggers:
    def __init__(self, save_dir, use_tb: bool = True):
        self.dir = Path(save_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.dir / "results.csv"
        self.tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.dir))
            except Exception:  # no tensorboard package: the CSV alone, as in JAX
                self.tb = None

    def log_metrics(self, metrics: Dict[str, float], step: int):
        row = {"epoch": step, **metrics}
        fields = list(row)
        old = None
        if self.csv_path.exists():
            with open(self.csv_path, newline="") as f:
                old = list(csv.DictReader(f).fieldnames or [])
            fields = old + [k for k in row if k not in old]
        if old is not None and fields == old:
            with open(self.csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=fields, restval="").writerow(row)
        else:
            rows = []
            if old is not None:
                with open(self.csv_path, newline="") as f:
                    rows = list(csv.DictReader(f))
            rows.append(row)
            tmp = self.csv_path.with_suffix(".csv.tmp")
            with open(tmp, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields, restval="")
                w.writeheader()
                w.writerows(rows)
            os.replace(tmp, self.csv_path)
        if self.tb:
            for k, v in metrics.items():
                try:
                    self.tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass

    def log_image(self, name: str, img, step: int = 0):
        """img: HWC uint8 RGB numpy."""
        if self.tb is not None:
            self.tb.add_image(name, img, step, dataformats="HWC")

    def close(self):
        if self.tb:
            self.tb.flush()
            self.tb.close()

    def finalize(self):
        """The end-of-training plot (`results.png`), then close."""
        try:
            from .plots import plot_results

            if self.csv_path.exists():
                plot_results(self.csv_path)
        except Exception:  # a plot must never fail the run (matplotlib may be missing)
            pass
        self.close()
