"""Export CLI: serialise a checkpoint for deployment.

Port of `dmayolo_tpu/cli/export.py`.  Formats:
  * torch_export: a `torch.export` program of the BN-folded inference
    step, in place of the JAX package's `stablehlo`: the same program,
    uint8 NHWC in at a static (batch, imgsz), `model.decode(apply(...))`
    out, saved with `torch.export.save` as `<weights>.pt2` beside a
    `.meta.yaml` whose `platforms` names the device type it was exported
    on (`cli.detect` runs it through `cli/backends.py`);
  * tflite: the same program at f32 as a TFLite model, `<weights>.tflite`,
    written by `cli/tflite_export.py` without TensorFlow (always f32, as
    in the JAX package: TFLite's builtins take no bf16);
  * torch: the unfolded weights as a `state_dict` `.pt` (f32, on the CPU)
    with the reference's keys and layouts, which are the port's own: the
    reference's tooling and both packages' `.pt` readers load it;
  * npz: the stripped inference checkpoint (BN folded, meta `fused`).
`--int8` also writes `<weights>-int8.tflite`: the raw-head program
quantized to TFLite's 8-bit spec, calibrated on `--ncalib` letterboxed
val images of `--data` (random noise, with a warning, without it), its
sidecar carrying the decode's constants; a TDetect model gets none, as in
the JAX package.  The JAX package's `tf` and `saved_model` (a TF graph
around an XlaCallModule) and `stablehlo` (JAX's serialized MLIR) need an
XLA runtime, and `onnx` the `onnx` package: they raise, naming why.

    python -m dmayolo_tpu_torch.cli.export --weights best.npz --imgsz 1536 --batch-size 8 --include torch_export npz torch
    python -m dmayolo_tpu_torch.cli.export --weights best.npz --imgsz 640 --include tflite --int8 --data visdrone.yaml
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

UNSUPPORTED = {
    "stablehlo": "stablehlo is JAX's serialized MLIR, which needs an XLA runtime; the port "
                 "writes torch_export (.pt2) and tflite",
    "tf": "tf is a TensorFlow graph around an XlaCallModule, which needs an XLA runtime; the "
          "port writes tflite",
    "saved_model": "saved_model is a TensorFlow graph around an XlaCallModule, which needs an "
                   "XLA runtime; the port writes tflite",
    "onnx": "onnx needs the `onnx` package, which the port does not use",
}


def build_parser():
    p = argparse.ArgumentParser("dmayolo-export")
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--imgsz", "--img", type=int, default=640, dest="imgsz")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--include", nargs="+", default=["torch_export"],
                   choices=["torch_export", "tflite", "torch", "npz", *UNSUPPORTED])
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without it) or cpu")
    p.add_argument("--int8", action="store_true",
                   help="also write a full-integer -int8.tflite (ref export.py:197-205); "
                        "needs --data for real calibration images")
    p.add_argument("--data", type=str, default=None,
                   help="dataset yaml of the int8 calibration images")
    p.add_argument("--ncalib", type=int, default=100,
                   help="calibration images for --int8")
    return p


class InferenceProgram(nn.Module):
    """The exported step: uint8 (B, S, S, 3) -> decoded predictions."""

    def __init__(self, model, dtype):
        super().__init__()
        self.model, self.dtype = model, dtype

    def forward(self, x):
        xf = x.to(self.dtype) / 255.0
        return self.model.decode(self.model.apply(xf, dtype=self.dtype, fused=True))


def write_sidecar(artifact: Path, model, imgsz: int, batch_size: int, **extra) -> None:
    """`<artifact>.meta.yaml`: what detect needs to run the artifact on
    its own (the reference's DetectMultiBackend reads the same from its
    exports)."""
    import yaml

    meta = {"nc": int(model.nc), "imgsz": int(imgsz), "batch_size": int(batch_size),
            "stride": int(model.stride.max()), "head": type(model.head).__name__,
            "names": list(getattr(model, "names", [])), **extra}
    artifact = Path(artifact)
    (artifact.parent / (artifact.name + ".meta.yaml")).write_text(
        yaml.safe_dump(meta, sort_keys=False))


def raw_head_meta(model, imgsz: int) -> dict:
    """The int8 artifact's sidecar keys: the raw heads' decode constants."""
    strides = [int(s) for s in np.asarray(model.stride)]
    anchors_px = (np.asarray(model.head.anchors, np.float32)
                  * np.asarray(strides, np.float32).reshape(-1, 1, 1))
    return {"raw_heads": True, "strides": strides, "anchors_px": anchors_px.tolist(),
            "shapes": [[imgsz // s, imgsz // s] for s in strides]}


def calibration_batches(opt) -> list:
    """Representative uint8 (batch, imgsz, imgsz, 3) batches for int8
    calibration: letterboxed val images from --data (the reference's
    export.py:197-201 calibrates from a val dataloader), the last batch
    padded by repetition; random noise, with a warning, only without
    --data (the JAX package's `_calibration_batches`)."""
    batches = []
    if opt.data:
        from ..data.datasets import _scan_images, check_dataset
        from ..data.imageio import imread
        from ..data.letterbox import letterbox_host

        files = _scan_images(check_dataset(opt.data)["val"])[: opt.ncalib]
        imgs = []
        for f in files:
            try:
                im = imread(f)
            except (OSError, ValueError):
                continue
            imgs.append(letterbox_host(im, opt.imgsz, auto=False)[0][..., ::-1].astype(np.uint8))
            if len(imgs) == opt.batch_size:
                batches.append(np.stack(imgs))
                imgs = []
        if imgs:
            while len(imgs) < opt.batch_size:
                imgs.append(imgs[-1])
            batches.append(np.stack(imgs))
        if not batches:
            raise SystemExit(f"--int8 calibration: no readable images found under the val split "
                             f"of {opt.data}: refusing to calibrate on noise")
    if not batches:
        print("WARNING: --int8 without --data calibrates on random noise — activation ranges "
              "will be wrong; pass --data for real images")
        rng = np.random.default_rng(0)
        batches = [rng.integers(0, 255, (opt.batch_size, opt.imgsz, opt.imgsz, 3), np.uint8)
                   for _ in range(8)]
    return batches


def main(argv=None):
    opt = build_parser().parse_args(argv)
    bad = [f for f in opt.include if f in UNSUPPORTED]
    if bad:
        raise NotImplementedError("; ".join(UNSUPPORTED[f] for f in bad))
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from ..utils.weights import jax_from_state_dict
    from .common import check_img_size, load_model_from_checkpoint, setup_device

    device = setup_device(opt.device)
    model = load_model_from_checkpoint(opt.weights, opt.cfg, device=device)
    opt.imgsz = check_img_size(opt.imgsz, int(model.stride.max()))
    src_meta = {}
    if not str(opt.weights).endswith(".pt"):
        _, src_meta = load_checkpoint(opt.weights)
    cfg_meta = opt.cfg or src_meta.get("cfg") or model.yaml
    if cfg_meta is model.yaml and hasattr(model.head, "anchors"):
        # keep the live (possibly autoanchor-evolved) anchors, in px units
        cfg_meta = dict(cfg_meta)
        anc_px = np.asarray(model.head.anchors) * model.stride.reshape(-1, 1, 1)
        cfg_meta["anchors"] = anc_px.reshape(len(model.stride), -1).tolist()
    base = Path(opt.weights).with_suffix("")
    dtype = torch.float32 if opt.fp32 else torch.bfloat16

    # the torch format holds the unfolded weights: taken before the fold
    torch_sd = None
    if "torch" in opt.include:
        if model.fused:
            raise ValueError(f"{opt.weights} is BN-folded; the torch format holds the "
                             "unfolded weights")
        torch_sd = {k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()}
    model.fuse()

    outputs = []

    def write_meta(artifact: Path, **extra):
        write_sidecar(artifact, model, opt.imgsz, opt.batch_size, **extra)

    if "npz" in opt.include:
        fp, fs = jax_from_state_dict(model)
        out = base.parent / (base.name + "_fused.npz")
        save_checkpoint(out, params=fp, stats=fs,
                        meta={"fused": True, "nc": model.nc, "cfg": cfg_meta})
        outputs.append(out)

    if torch_sd is not None:
        out = base.parent / (base.name + ".pt")
        if out.resolve() == Path(opt.weights).resolve():
            # --weights best.pt --include torch would overwrite the user's
            # source checkpoint with a bare state_dict (losing ema/yaml/nc)
            out = base.parent / (base.name + "_export.pt")
        torch.save(torch_sd, out)
        outputs.append(out)

    if "torch_export" in opt.include:
        x_spec = torch.zeros((opt.batch_size, opt.imgsz, opt.imgsz, 3), dtype=torch.uint8,
                             device=device)
        with torch.no_grad():
            program = torch.export.export(InferenceProgram(model, dtype).eval(), (x_spec,))
        out = base.parent / (base.name + ".pt2")
        torch.export.save(program, str(out))
        # a program runs on the device type it was exported on
        write_meta(out, platforms=[device.type])
        outputs.append(out)

    if "tflite" in opt.include:
        from .tflite_export import export_tflite

        out = export_tflite(model, opt.imgsz, opt.batch_size,
                            base.parent / (base.name + ".tflite"))
        write_meta(out)
        outputs.append(out)

    if opt.int8:
        head = type(model.head).__name__
        if head != "Detect":
            print(f"--int8 supports anchor-based Detect heads (got {head}) — skipping the int8 "
                  "artifact")
        else:
            from .tflite_export import export_tflite_int8

            out = export_tflite_int8(model, opt.imgsz, opt.batch_size, calibration_batches(opt),
                                     base.parent / (base.name + "-int8.tflite"))
            write_meta(out, **raw_head_meta(model, opt.imgsz))
            outputs.append(out)

    for o in outputs:
        print(f"exported: {o}")
    return outputs


if __name__ == "__main__":
    main()
