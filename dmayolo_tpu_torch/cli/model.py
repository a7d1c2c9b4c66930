"""Model inspection CLI: build a config, print its layer table, parameter
count and GFLOPs, and optionally a per-layer time profile.

Port of `dmayolo_tpu/cli/model.py`.

    python -m dmayolo_tpu_torch.cli.model --cfg yolov5s.yaml [--profile] [--imgsz 640]
"""
from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser("dmayolo-model")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--nc", type=int, default=None)
    p.add_argument("--imgsz", "--img", type=int, default=640, dest="imgsz")
    p.add_argument("--profile", action="store_true", help="per-layer timing")
    p.add_argument("--batch", type=int, default=1,
                   help="profile batch size (use serving batch, e.g. 128)")
    p.add_argument("--bf16", action="store_true",
                   help="profile in bfloat16 (serving dtype)")
    p.add_argument("--fused", action="store_true",
                   help="profile BN-folded inference weights (fuse)")
    p.add_argument("--verbose", action="store_true", help="print the layer table")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without it) or cpu")
    return p


def main(argv=None):
    opt = build_parser().parse_args(argv)
    import torch

    from ..graph import DetectionModel
    from ..utils.model_info import model_info, profile_layers
    from .common import resolve_config, setup_device

    device = setup_device(opt.device)
    model = DetectionModel(resolve_config(opt.cfg, "models"), nc=opt.nc, device=device)
    model.init_with_priors(torch.Generator().manual_seed(0))
    if opt.verbose:
        print(model.describe())
    model_info(model, img_size=opt.imgsz)
    if opt.profile:
        if opt.fused:
            model.fuse()
        profile_layers(model, img_size=opt.imgsz if opt.batch > 1 else min(opt.imgsz, 320),
                       batch=opt.batch, dtype=torch.bfloat16 if opt.bf16 else torch.float32,
                       fused=opt.fused)
    return model


if __name__ == "__main__":
    main()
