"""Exported-artifact inference backends for `cli.detect`.

Port of `dmayolo_tpu/cli/backends.py` (the reference's detect.py:96-141
DetectMultiBackend).  The native `.npz` and the reference `.pt` go
through `load_model_from_checkpoint`; the exported program is a
`torch.export` program (`*.pt2`, written by `cli.export --include
torch_export`) in place of the JAX package's `.stablehlo`: uint8 NHWC in
at a static (batch, imgsz), the decoded predictions (B, A, 5 + nc) out
(4 + nc for TDetect), so NMS stays in detect.  Its metadata (nc, imgsz,
batch size, stride, head, names, the device type it was exported on)
comes from the `.meta.yaml` sidecar beside it.

The JAX package's other program formats raise, naming what the port
lacks: `.stablehlo` is a JAX artifact, SavedModel and TFLite need
TensorFlow, ONNX needs the `onnx` package, which the port does not use.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# formats the JAX package runs and the port does not, with why
UNSUPPORTED = {
    "stablehlo": "a .stablehlo program is a JAX export; the port runs torch.export "
                 "programs (.pt2, `cli.export --include torch_export`)",
    "saved_model": "a TensorFlow SavedModel needs TensorFlow, which the port does not use",
    "tflite": "a TFLite model needs TensorFlow Lite, which the port does not use",
    "onnx": "an ONNX model needs the `onnx` package (and a runtime), which the port does "
            "not use",
}


def detect_backend(weights: str) -> str:
    w = str(weights)
    if w.endswith(".pt2"):
        return "torch_export"
    if w.endswith(".stablehlo"):
        return "stablehlo"
    if w.endswith(".tflite"):
        return "tflite"
    if w.endswith(".onnx"):
        return "onnx"
    p = Path(w)
    if p.is_dir() and (p / "saved_model.pb").exists():
        return "saved_model"
    return "native"


def _read_meta(weights: Path) -> dict:
    import yaml

    path = weights.parent / (weights.name + ".meta.yaml")
    if not path.exists():
        raise FileNotFoundError(
            f"{path} not found: re-run cli.export (it writes the metadata sidecar detect "
            "needs to run the program on its own)")
    with open(path) as f:
        return yaml.safe_load(f)


def load_backend(weights: str, backend: str, device=None):
    """Returns (fn, meta): fn maps uint8 (B, H, W, 3) with B ==
    meta['batch_size'] (numpy or a tensor) to the decoded predictions, a
    tensor on the program's device."""
    if backend in UNSUPPORTED:
        raise NotImplementedError(f"{weights}: {UNSUPPORTED[backend]}")
    if backend != "torch_export":
        raise ValueError(f"not an exported-artifact backend: {backend}")
    from ..utils.device import resolve_device

    w = Path(weights)
    meta = _read_meta(w)
    dev = resolve_device(device)
    plats = tuple(p.lower() for p in meta.get("platforms") or ())
    if dev.type not in plats:
        raise SystemExit(
            f"{w.name} was exported on {plats} but detect runs on {dev.type!r}: re-run "
            f"cli.export with --device {dev.type}, or pick one of {plats} with --device")
    program = torch.export.load(str(w)).module()

    def fn(x):
        with torch.inference_mode():
            return program(torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                           device=dev))

    return fn, meta
