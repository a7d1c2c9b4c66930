#!/usr/bin/env python3
"""How far rounding alone moves the checks of `chip_smoke.py`, on one
NVIDIA GPU and its host CPU.

    python3 chip_conditioning.py

1. The raw head: the flagship, C3CASPD2 (its placeholder anchors do not
   enter the raw head) and CASPD_ODRTA built as `chip_smoke.py` builds
   them (seeded, head priors, BN statistics calibrated on two random
   640 px images), BN-folded, on the host CPU in f32 and in f64, on one
   random image of 64, 128 and 256 px: the largest |f32 - f64| of the raw
   head against its largest magnitude, over the levels.
2. One f32 train step: for the flagship (SIoU loss) and CASPD_ODRTA
   (TAL), one SGD step at batch 2, 640 px, full width, from seed-7
   `init_with_priors` weights, as `chip_smoke.py`'s train check takes it
   (TAL's assignment kept from the first CPU step and replayed in the
   others).  The step runs on the host CPU on all threads (the
   reference), on one thread, with every raw-head gradient multiplied by
   (1 + 2^-24 u), u uniform in [-1, 1] (one rounding step in the loss's
   gradient), on the card (TF32 off), and on the card with cuDNN off.
   Each is printed against the reference as `chip_smoke.py` reads it
   (loss relative, grads and updated parameters scaled by 1 + max |x| of
   each tensor), with the tensors of the largest grad error on the card.

Exits non-zero when there is no CUDA device.
"""
from __future__ import annotations

import copy
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def per_tensor(got, want, n=6):
    rows = [(float((got[k] - w).abs().max()) / (1 + float(w.abs().max())), k)
            for k, w in want.items()]
    return sorted(rows, reverse=True)[:n]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_conditioning: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from dmayolo_tpu_torch.graph import DetectionModel, model_config
    from dmayolo_tpu_torch.nn import heads

    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip(),
          flush=True)
    for name in (cs.FLAGSHIP, "C3CASPD2", "CASPD_ODRTA"):
        f32 = cs.build_model(cpu, cfg=model_config(name)).fuse()
        f64 = copy.deepcopy(f32).double()
        g = torch.Generator().manual_seed(2)
        for size in (64, 128, 256):
            x = torch.rand(1, size, size, 3, generator=g)
            with torch.inference_mode():
                lo = f32.apply(x, fused=True)
                hi = f64(x.double(), torch.float64)
            err = max(float((a.double() - b).abs().max()) / float(b.abs().max())
                      for a, b in zip(lo, hi))
            print(f"{name} raw head at {size} px on the CPU: max |f32 - f64| / max |f64| "
                  f"{err:.2e}", flush=True)
        del f32, f64
    for name, recipe in ((cs.FLAGSHIP, cs.RECIPE), ("CASPD_ODRTA", cs.SPD_RECIPES["CASPD_ODRTA"])):
        cfg = model_config(name)
        sd = DetectionModel(cfg, nc=10, device="cpu").init_with_priors(
            torch.Generator().manual_seed(7)).state_dict()
        batch = cs.train_batches(1, 2, 640, 10, recipe["max_targets"], 7)[0]
        replay = cs.ReplayedAssignment() if recipe["assignment"] == "tal" else None

        def step(device):
            return cs.one_train_step(device, cfg, sd, batch, torch.float32, recipe=recipe,
                                     replay=replay)

        runs = {"cpu": step(cpu)}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            runs["cpu, one thread"] = step(cpu)
        finally:
            torch.set_num_threads(threads)
        head = heads.TDetect if recipe["assignment"] == "tal" else heads.Detect
        forward, gen = head.forward, torch.Generator().manual_seed(1)

        def perturbed(self, xs, dtype):
            out = forward(self, xs, dtype)
            for o in out:
                o.register_hook(lambda g: g * (1 + 2 ** -24 * (
                    2 * torch.rand(g.shape, generator=gen, dtype=g.dtype) - 1)))
            return out

        head.forward = perturbed
        try:
            runs["cpu, head grads x (1 + 2^-24 u)"] = step(cpu)
        finally:
            head.forward = forward
        runs["card"] = step(card)
        torch.backends.cudnn.enabled = False
        try:
            runs["card, cuDNN off"] = step(card)
        finally:
            torch.backends.cudnn.enabled = True
        want = runs["cpu"]
        for label, got in runs.items():
            if label == "cpu":
                continue
            loss = max(abs(got[0][k] - want[0][k]) / abs(want[0][k]) for k in want[0])
            print(f"{name} {label} vs cpu: loss {loss:.2e}, grads "
                  f"{cs.scaled_err(got[1], want[1]):.3e}, params "
                  f"{cs.scaled_err(got[2], want[2]):.3e}", flush=True)
        off = runs["card, cuDNN off"]
        print(f"{name} card vs card with cuDNN off: grads "
              f"{cs.scaled_err(runs['card'][1], off[1]):.3e}, params "
              f"{cs.scaled_err(runs['card'][2], off[2]):.3e}")
        print(f"{name} largest grad errors, card vs cpu: " + ", ".join(
            f"{k} {e:.2e}" for e, k in per_tensor(runs["card"][1], want[1])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
