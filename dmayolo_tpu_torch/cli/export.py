"""Export CLI: serialise a checkpoint for deployment.

Port of `dmayolo_tpu/cli/export.py`.  Formats:
  * torch_export: a `torch.export` program of the BN-folded inference
    step, in place of the JAX package's `stablehlo`: the same program,
    uint8 NHWC in at a static (batch, imgsz), `model.decode(apply(...))`
    out, saved with `torch.export.save` as `<weights>.pt2` beside a
    `.meta.yaml` whose `platforms` names the device type it was exported
    on (`cli.detect` runs it through `cli/backends.py`);
  * torch: the unfolded weights as a `state_dict` `.pt` (f32, on the CPU)
    with the reference's keys and layouts, which are the port's own: the
    reference's tooling and both packages' `.pt` readers load it;
  * npz: the stripped inference checkpoint (BN folded, meta `fused`).
The JAX package's `tf`, `saved_model` and `tflite` need TensorFlow and
`stablehlo` is a JAX artifact: they raise, naming the format.  `onnx`
needs the `onnx` package, which the port does not use: it raises.
`--int8` (the JAX package's int8 TFLite artifact) raises for the same
reason; int8 serving runs in the port itself (`nn/quant.py`).

    python -m dmayolo_tpu_torch.cli.export --weights best.npz --imgsz 1536 --batch-size 8 --include torch_export npz torch
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

UNSUPPORTED = {
    "stablehlo": "stablehlo is a JAX export format; the port writes torch_export (.pt2)",
    "tf": "tf needs TensorFlow, which the port does not use",
    "saved_model": "saved_model needs TensorFlow, which the port does not use",
    "tflite": "tflite needs TensorFlow Lite, which the port does not use",
    "onnx": "onnx needs the `onnx` package, which the port does not use",
}


def build_parser():
    p = argparse.ArgumentParser("dmayolo-export")
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--imgsz", "--img", type=int, default=640, dest="imgsz")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--include", nargs="+", default=["torch_export"],
                   choices=["torch_export", "torch", "npz", *UNSUPPORTED])
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without it) or cpu")
    p.add_argument("--int8", action="store_true",
                   help="int8 TFLite export: raises (the port writes no TFLite)")
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


def main(argv=None):
    opt = build_parser().parse_args(argv)
    if opt.int8:
        raise NotImplementedError(
            "--int8 writes a full-integer TFLite artifact in the JAX package, and the port "
            "writes no TFLite (see 'tflite'); int8 serving and eval run in the port itself: "
            "cli.val --int8, make_infer_fn(quant=...)")
    bad = [f for f in opt.include if f in UNSUPPORTED]
    if bad:
        raise NotImplementedError("; ".join(UNSUPPORTED[f] for f in bad))
    import yaml

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
        # the sidecar detect needs to run the program on its own (the
        # reference's DetectMultiBackend reads the same from its exports);
        # a program runs on the device type it was exported on
        meta = {"nc": int(model.nc), "imgsz": int(opt.imgsz),
                "batch_size": int(opt.batch_size), "stride": int(model.stride.max()),
                "head": type(model.head).__name__,
                "names": list(getattr(model, "names", [])), "platforms": [device.type]}
        (out.parent / (out.name + ".meta.yaml")).write_text(yaml.safe_dump(meta, sort_keys=False))
        outputs.append(out)

    for o in outputs:
        print(f"exported: {o}")
    return outputs


if __name__ == "__main__":
    main()
