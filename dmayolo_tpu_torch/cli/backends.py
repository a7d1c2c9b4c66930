"""Exported-artifact inference backends for `cli.detect`.

Port of `dmayolo_tpu/cli/backends.py` (the reference's detect.py:96-141
DetectMultiBackend).  The native `.npz` and the reference `.pt` go
through `load_model_from_checkpoint`; the exported programs are
  * a `torch.export` program (`*.pt2`, written by `cli.export --include
    torch_export`) in place of the JAX package's `.stablehlo`: uint8 NHWC
    in at a static (batch, imgsz), the decoded predictions (B, A, 5 + nc)
    out (4 + nc for TDetect), so NMS stays in detect;
  * a TFLite model (`*.tflite`, `cli.export --include tflite`, or the
    JAX package's), run by `cli/tflite_run.py::TFLiteProgram`: the f32
    artifact returns the decoded predictions; the full-integer
    `-int8.tflite` (`--int8`) ends at the raw per-scale heads, which
    `decode_raw` decodes in float from the sidecar's `strides` and
    `anchors_px`.
Their metadata (nc, imgsz, batch size, stride, head, names; for a `.pt2`
the device type it was exported on) comes from the `.meta.yaml` sidecar
beside each.

The JAX package's other program formats raise, naming why: `.stablehlo`
is JAX's serialized MLIR and a SavedModel a TF graph around an
XlaCallModule, both needing an XLA/MLIR runtime; ONNX needs the `onnx`
package (and a runtime), which neither package uses.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..nn.heads import decode_levels

# formats the JAX package runs and the port does not, with why
UNSUPPORTED = {
    "stablehlo": "a .stablehlo program is JAX's serialized MLIR, which needs an XLA runtime; "
                 "the port runs torch.export programs (.pt2, `cli.export --include "
                 "torch_export`) and TFLite models (.tflite)",
    "saved_model": "a SavedModel of the JAX package is a TensorFlow graph around an "
                   "XlaCallModule, which needs an XLA runtime; export a .tflite instead",
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


def decode_raw(raws, meta) -> torch.Tensor:
    """Anchor-based decode of raw head tensors (B, ny, nx, na, no) from
    the sidecar's `strides` and `anchors_px`: the JAX package's
    `decode_raw_np`, as `Detect.decode` computes it (`decode_levels`)."""
    return decode_levels(raws, meta["strides"],
                         [np.asarray(a, np.float32) for a in meta["anchors_px"]])


def raw_head_order(names, shapes, meta) -> list:
    """Positions of the raw-head outputs in scale order: by the ":k"
    suffix of their names (shapes alone can tie: two heads may share a
    stride), else by (ny, nx) from the sidecar; then checked against the
    sidecar's shapes (a check that survives python -O)."""
    try:
        order = sorted(range(len(names)), key=lambda i: int(names[i].split(":")[-1]))
    except ValueError:
        by_shape = {tuple(int(v) for v in shapes[i][1:3]): i for i in range(len(names))}
        if len(by_shape) != len(names):
            raise ValueError("int8 raw-head outputs have ambiguous shapes and unindexed names: "
                             "cannot order the heads safely")
        order = [by_shape[tuple(s)] for s in meta["shapes"]]
    expect = [tuple(s) for s in meta["shapes"]]
    got = [tuple(int(v) for v in shapes[i][1:3]) for i in order]
    if got != expect:
        raise ValueError(f"int8 raw-head output order mismatch: got {got}, metadata expects "
                         f"{expect}")
    return order


def load_backend(weights: str, backend: str, device=None):
    """Returns (fn, meta): fn maps uint8 (B, H, W, 3) with B ==
    meta['batch_size'] (numpy or a tensor) to the decoded predictions, a
    tensor on the program's device."""
    if backend in UNSUPPORTED:
        raise NotImplementedError(f"{weights}: {UNSUPPORTED[backend]}")
    if backend not in ("torch_export", "tflite"):
        raise ValueError(f"not an exported-artifact backend: {backend}")
    from ..utils.device import resolve_device

    w = Path(weights)
    meta = _read_meta(w)
    dev = resolve_device(device)
    if backend == "tflite":
        from .tflite_run import TFLiteProgram

        program = TFLiteProgram(w, device=dev)
        if not meta.get("raw_heads"):
            return (lambda x: program(x)[0]), meta
        shapes = [program.tensors[i].shape for i in program.outputs]
        order = raw_head_order(program.output_names, shapes, meta)

        def fn(x):
            outs = program(x)
            return decode_raw([outs[i] for i in order], meta)

        return fn, meta
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
