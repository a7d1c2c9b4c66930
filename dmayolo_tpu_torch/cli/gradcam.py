"""Grad-CAM CLI: per-detection heatmap overlays for a target layer.

Port of `dmayolo_tpu/cli/gradcam.py` (a working replacement for the
reference's broken main_gradcam.py:1-119), with its surface:
--model-path/--img-path/--output-dir/--img-size/--target-layer/--method
{gradcam,gradcampp}/--no-text-box.  For each input image: one JET overlay
with every kept detection's CAM blended in, and one CAM image a
detection.  The model runs unfolded in float32; images are read and
written with the port's `imageio` (a CAM image is written as three equal
channels: the port's writer takes colour images only).  Boxes are drawn
anti-aliased, as the JAX CLI draws them (`cvops.rectangle(...,
line_type=LINE_AA)`), and labels in the port's bitmap font.

    python -m dmayolo_tpu_torch.cli.gradcam --model-path best.npz --img-path images/ --target-layer model_17_cv3_act
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}

# cv2's COLORMAP_JET as cv2.applyColorMap gives it, BGR, indexed by level
_JET_BGR = np.frombuffer(bytes.fromhex(
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000b00000b40000b800"
    "00bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000e00000e40000e80000ec0000f00000f4"
    "0000f80000fc0000ff0000ff0400ff0800ff0c00ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00"
    "ff3000ff3400ff3800ff3c00ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff68"
    "00ff6c00ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00ffa000ff"
    "a400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00ffd000ffd400ffd800ffdc00"
    "ffe000ffe400ffe800ffec00fff000fff400fff800fffc00feff02faff06f6ff0af2ff0eeeff12eaff16e6ff"
    "1ae2ff1edeff22daff26d6ff2ad2ff2eceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aa"
    "ff56a6ff5aa2ff5e9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe3effc23affc636ff"
    "ca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee0efff20afff606fffa01fffe00fcff00"
    "f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff"
    "00bcff00b8ff00b4ff00b0ff00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084"
    "ff0080ff007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff004cff00"
    "48ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff001cff0018ff0014ff0010ff"
    "000cff0008ff0004ff0000ff0000fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000"
    "d40000d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a80000a40000a000009c00"
    "009800009400009000008c000088000084000080"
), np.uint8).reshape(256, 3)


def build_parser():
    p = argparse.ArgumentParser("dmayolo-gradcam")
    p.add_argument("--model-path", "--weights", dest="model_path", type=str, required=True)
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--img-path", type=str, default="data/images")
    p.add_argument("--output-dir", type=str, default="outputs/")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--target-layer", type=str, default="model_17_cv3_act",
                   help="layer address ('model_17_...') or plain index")
    p.add_argument("--method", type=str, default="gradcam", choices=["gradcam", "gradcampp"])
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-dets", type=int, default=10,
                   help="CAM for at most this many detections an image")
    p.add_argument("--names", type=str, default=None, help="dataset yaml for class names")
    p.add_argument("--no-text-box", "--no_text_box", dest="no_text_box", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without it) or cpu")
    return p


def _jet(cam: np.ndarray) -> np.ndarray:
    """cam in [0, 1] -> BGR JET colour map, as cv2.applyColorMap."""
    return _JET_BGR[(cam * 255).astype(np.uint8)]


def main(argv=None):
    opt = build_parser().parse_args(argv)
    import torch
    import yaml

    from ..core.nms import batched_nms
    from ..data import cvops
    from ..data.imageio import imread, imwrite
    from ..data.letterbox import letterbox_host
    from ..eval.gradcam import cam_for_detection, resolve_target_layer, upsample_cam
    from ..eval.validator import with_obj_column
    from .common import check_img_size, load_model_from_checkpoint, setup_device

    device = setup_device(opt.device)
    model = load_model_from_checkpoint(opt.model_path, opt.cfg, device=device)
    opt.img_size = check_img_size(opt.img_size, int(model.stride.max()))
    layer_i = resolve_target_layer(model, opt.target_layer)
    names = [str(i) for i in range(model.nc)]
    if opt.names:
        with open(opt.names) as f:
            names = yaml.safe_load(f).get("names", names)

    src = Path(opt.img_path)
    paths = (sorted(p for p in src.rglob("*") if p.suffix.lower() in IMG_EXTS)
             if src.is_dir() else [src])
    out_dir = Path(opt.output_dir) / f"layer_{layer_i}_{opt.method}"
    out_dir.mkdir(parents=True, exist_ok=True)

    cache: dict = {}
    results = []
    for path in paths:
        try:
            im0 = imread(path)
        except ValueError:
            print(f"skip (unreadable): {path}")
            continue
        img = letterbox_host(im0, (opt.img_size, opt.img_size), auto=False)[0]
        x = torch.as_tensor(img[None, :, :, ::-1].astype(np.float32) / 255.0, device=device)

        t0 = time.time()
        with torch.no_grad():
            dec = with_obj_column(model.decode(model.apply(x)), model.nc)
            dets, valid, srcs = batched_nms(
                dec, conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
                max_det=min(300, max(1, opt.max_dets)), return_src=True)
        dets, valid, srcs = (t.cpu().numpy() for t in (dets, valid, srcs))
        n = int(valid[0].sum())

        res = img.astype(np.float32) / 255.0
        cams = []
        for j in range(min(n, opt.max_dets)):
            cand, cls = int(srcs[0, j]), int(dets[0, j, 5])
            cam = cam_for_detection(model, x, layer_i, cand, cls, method=opt.method,
                                    _cache=cache)
            cams.append(cam)
            cam_up = upsample_cam(cam, img.shape[:2])
            heat = _jet(cam_up).astype(np.float32) / 255.0
            res = res + heat  # the reference's blend: add, then renormalise
            res = res / res.max()
            grey = (cam_up * 255).astype(np.uint8)
            imwrite(out_dir / f"{path.stem}_det{j}_{names[cls]}.jpg",
                    np.repeat(grey[..., None], 3, axis=2))

        res = np.ascontiguousarray((res * 255).astype(np.uint8))
        if not opt.no_text_box:
            for j in range(min(n, opt.max_dets)):
                x1, y1, x2, y2, conf, cls = dets[0, j]
                c1, c2 = (int(x1), int(y1)), (int(x2), int(y2))
                cvops.rectangle(res, c1, c2, (0, 0, 255), 2, line_type=cvops.LINE_AA)
                cvops.put_text(res, f"{names[int(cls)]} {conf:.2f}",
                               (c1[0], max(c1[1] - 3, 10)), 0.5, (255, 255, 255), 1)
        out_path = out_dir / f"{path.stem}_res.jpg"
        imwrite(out_path, res)
        print(f"{path.name}: {n} dets, {min(n, opt.max_dets)} CAMs "
              f"[{time.time() - t0:.2f}s] -> {out_path}")
        results.append({"path": str(path), "dets": dets[0, :n], "cands": srcs[0, :n],
                        "cams": cams, "out": out_path})
    return results


if __name__ == "__main__":
    main()
