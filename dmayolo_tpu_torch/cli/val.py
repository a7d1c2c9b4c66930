"""Validation CLI: mAP of a checkpoint on a dataset's split.

Port of `dmayolo_tpu/cli/val.py`, with its flags.  `--augment` (TTA) and
`--save-txt` (with `--save-conf`) write the reference's
`<project>/<name>/labels/*.txt` layout; `--task study` sweeps image sizes
into `study.csv`; `--save-json` writes COCO predictions and runs COCOeval
against the official annotations, or against ground truth built from the
YOLO labels where there are none.  `--int8` calibrates the input scales
on `--ncalib` dataset images and runs the eligible convs on the int8 path
(`nn/quant.py`).  `--devices N` (N > 1) evaluates data-parallel
(`parallel/mesh.py`): inside a torchrun group of N it joins it, else it
spawns N ranks (on the CPU over gloo with `--device cpu`; on CUDA over
NCCL, one GPU a rank, which must exist); `--batch-size` is the global
batch, the result that of one process, printed and written by rank 0.
`--spatial-shard` with an even `--devices` N also splits each image's
rows over 2 ranks (`make_mesh(N // 2, 2)`, `parallel/spatial.py`), the
large-image eval of the DMA regime, as JAX's; with an odd N it prints
JAX's words and runs data-parallel only; with N = 1 it changes nothing.

    python -m dmayolo_tpu_torch.cli.val --weights best.npz --data VisDrone.yaml --imgsz 1536
    python -m dmayolo_tpu_torch.cli.val --weights best.npz --data VisDrone.yaml --devices 4
    python -m dmayolo_tpu_torch.cli.val ... --imgsz 2048 --devices 2 --spatial-shard
"""
from __future__ import annotations

import argparse
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser("dmayolo-val")
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--cfg", type=str, default=None, help="model yaml (if not in ckpt meta)")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=640,
                   dest="imgsz")
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--task", type=str, default="val", choices=["val", "test", "speed", "study"])
    p.add_argument("--augment", action="store_true", help="TTA")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true")
    p.add_argument("--save-hybrid", action="store_true",
                   help="dataset labels join predictions before NMS as "
                        "conf-1.0 candidates; with --save-txt this writes "
                        "autolabelling hybrids")
    p.add_argument("--verbose", action="store_true",
                   help="report mAP by class (always on when nc < 50)")
    p.add_argument("--half", action="store_true",
                   help="accepted for parity; compute is bf16 by default "
                        "(reference --half = fp16); see --fp32")
    p.add_argument("--save-json", action="store_true",
                   help="write COCO-format predictions json and run COCOeval")
    p.add_argument("--project", type=str, default="runs/val")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ serving (nn/quant.py): convs run s8 x s8 -> s32 "
                        "on the card's tensor cores, decode stays float; "
                        "calibrated on --ncalib dataset images")
    p.add_argument("--ncalib", type=int, default=32,
                   help="calibration images for --int8")
    p.add_argument("--no-fuse", action="store_true")
    p.add_argument("--rect", action="store_true", help="rectangular val batches (pad 0.5)")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without it) or cpu")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel eval over N devices (N GPUs, or N CPU processes "
                        "with --device cpu); batch-size must divide")
    p.add_argument("--spatial-shard", action="store_true",
                   help="with an even --devices, also shard image H over 2 of them "
                        "(large-image eval)")
    p.add_argument("--max-nms", type=int, default=30000,
                   help="pre-NMS candidate budget")
    p.add_argument("--nms-backend", type=str, default="scan",
                   choices=["scan", "matrix", "pallas"])
    return p


def main(argv=None):
    opt = build_parser().parse_args(argv)
    from ..parallel import mesh as pm

    if opt.devices <= 1:
        return run(opt)
    opt.n_spatial = 2 if opt.spatial_shard and opt.devices % 2 == 0 else 1
    if opt.spatial_shard and opt.n_spatial == 1:
        print(f"--spatial-shard needs an even --devices count (got {opt.devices}) "
              f"— falling back to pure data parallelism")
    n_data = opt.devices // opt.n_spatial
    if opt.batch_size % n_data:
        raise ValueError(f"--batch-size {opt.batch_size} must be divisible by the "
                         f"{n_data} devices of the data axis")
    if pm.under_torchrun():
        mesh = pm.join_torchrun(device=opt.device)
        try:
            if mesh.world != opt.devices:
                raise ValueError(f"--devices {opt.devices} in a torchrun group of {mesh.world}")
            return run(opt, pm.make_mesh(n_data, opt.n_spatial, device=mesh.device))
        finally:
            pm.close_group()
    import torch

    device = "cpu" if opt.device == "cpu" else "cuda"
    pm.rank_devices(opt.devices, device)  # N visible GPUs, or it raises naming the count
    threads = max(1, torch.get_num_threads() // opt.devices) if device == "cpu" else None
    return pm.spawn(_rank, opt.devices, args=(opt,), device=device, threads=threads)[0]


def _rank(mesh, opt):
    """One rank of `--devices N`, on the (data, spatial) mesh of the flags."""
    from ..parallel import mesh as pm

    return run(opt, pm.make_mesh(opt.devices // opt.n_spatial, opt.n_spatial,
                                 device=mesh.device))


def run(opt, mesh=None):
    """The validation of `opt` (parsed flags), on `mesh`'s rank where given."""
    import torch

    from ..data.datasets import check_dataset
    from ..eval.validator import run_validation
    from .common import check_img_size, increment_path, load_model_from_checkpoint, setup_device

    main_rank = mesh is None or mesh.is_main
    say = print if main_rank else (lambda *a, **k: None)
    device = setup_device(opt.device) if mesh is None else mesh.device
    model = load_model_from_checkpoint(opt.weights, opt.cfg, device=device)
    opt.imgsz = check_img_size(opt.imgsz, int(model.stride.max()))
    fused = not opt.no_fuse
    if fused:
        model.fuse()
    dtype = torch.float32 if opt.fp32 else torch.bfloat16

    data = check_dataset(opt.data)
    out = increment_path(f"{opt.project}/{opt.name}", exist_ok=opt.exist_ok) \
        if main_rank else None
    if mesh is not None:  # rank 0's run directory
        out = mesh.broadcast_object(out)
    out.mkdir(parents=True, exist_ok=True)

    quant = None
    if opt.int8:
        if not fused:
            raise SystemExit("--int8 requires the fused inference path "
                             "(drop --no-fuse)")
        quant = calibrate(model, data, opt.imgsz, opt.ncalib, say) if main_rank else None
        if mesh is not None:  # rank 0's scales
            quant = mesh.broadcast_object(quant)

    split = data.get(opt.task if opt.task in ("val", "test") else "val") or data["val"]
    if opt.task == "speed":
        opt.conf_thres, opt.iou_thres = 0.25, 0.45
    kw = dict(batch_size=opt.batch_size, nc=data["nc"], conf_thres=opt.conf_thres,
                  iou_thres=opt.iou_thres, max_det=opt.max_det, max_nms=opt.max_nms,
                  nms_backend=opt.nms_backend, save_hybrid=opt.save_hybrid, dtype=dtype,
                  fused=fused, device=device, mesh=mesh, spatial=opt.spatial_shard)

    if opt.task == "study":
        # mAP and speed across image sizes
        rows = []
        for sz in range(256, opt.imgsz + 128, 128):
            r = run_validation(model, split, img_size=sz, **kw)
            rows.append((sz, r.mp, r.mr, r.map50, r.map, r.speed_ms.get("inference+nms", 0)))
            say(f"study {sz}px: {r.summary()} {r.speed_ms}")
        import csv as _csv

        if main_rank:
            with open(out / "study.csv", "w", newline="") as f:
                w = _csv.writer(f)
                w.writerow(["imgsz", "P", "R", "mAP50", "mAP", "ms_img"])
                w.writerows(rows)
        say(f"study -> {out/'study.csv'}")
        return rows

    jdict = [] if opt.save_json else None
    class_map = None
    if opt.save_json:
        from ..eval.coco_json import coco80_to_coco91_class, is_coco_data

        class_map = coco80_to_coco91_class() if is_coco_data(data) else None

    res = run_validation(
        model, split, img_size=opt.imgsz, **kw,
        save_txt_dir=(out / "labels") if opt.save_txt else None,
        save_conf=opt.save_conf, augment=opt.augment, rect=opt.rect,
        single_cls=opt.single_cls, save_json=jdict, class_map=class_map, quant=quant)
    if not main_rank:
        return res
    if jdict is not None:
        from ..eval.coco_json import evaluate_coco, write_coco_json

        w = Path(opt.weights).stem
        pred_json = write_coco_json(jdict, out / f"{w}_predictions.json")
        print(f"saved {len(jdict)} COCO prediction entries -> {pred_json}")
        anno_json = Path(data.get("path", "../coco")) / "annotations/instances_val2017.json"
        if not anno_json.exists():
            # no official annotations: COCO GT from the YOLO labels of the
            # same split, with the prediction writer's category-id map
            import json as _json

            from ..eval.coco_json import build_coco_gt_from_yolo

            gt = build_coco_gt_from_yolo(
                split, nc=int(data["nc"]), names=data.get("names"),
                class_map=class_map, single_cls=opt.single_cls)
            anno_json = out / "coco_gt.json"
            with open(anno_json, "w") as f:
                _json.dump(gt, f)
            print(f"built COCO GT from YOLO labels -> {anno_json} "
                  f"({len(gt['annotations'])} annotations)")
        # scoped to the validated images: against full official annotations
        # an unscoped eval counts every other image's labels as misses
        coco_res = evaluate_coco(pred_json, anno_json, img_ids=res.used_image_ids)
        if coco_res is not None:
            print(f"COCOeval: mAP@.5:.95={coco_res[0]:.4f} mAP@.5={coco_res[1]:.4f}")
    print(res.summary())
    print("speed:", {k: f"{v:.2f}ms" for k, v in res.speed_ms.items()})
    if (opt.verbose or int(data["nc"]) < 50) and res.per_class is not None:
        pc = res.per_class
        print(f"  {'Class':>16} {'Labels':>7} {'P':>7} {'R':>7} "
              f"{'mAP@.5':>7} {'mAP@.5:.95':>10}")
        for j, ci in enumerate(pc["cls"]):
            print(f"  {data['names'][int(ci)]:>16} {int(pc['nt'][j]):>7} "
                  f"{pc['p'][j]:>7.4f} {pc['r'][j]:>7.4f} "
                  f"{pc['ap50'][j]:>7.4f} {pc['ap'][j]:>10.4f}")
    elif res.maps is not None:
        for i, name in enumerate(data["names"]):
            if res.maps[i] > 0:
                print(f"  {name:>16}: mAP@.5:.95 {res.maps[i]:.4f}")
    return res


def calibrate(model, data, imgsz: int, ncalib: int, say=print):
    """--int8's input scales, from the first `ncalib` images of the train
    split (else val), letterboxed to `imgsz` without auto padding, RGB, in
    batches of 8, at f32; prints the calibration line."""
    import numpy as np
    import torch

    from ..data.datasets import _scan_images
    from ..data.imageio import imread
    from ..data.letterbox import letterbox_host
    from ..nn.quant import calibrate_act_scales, quant_coverage

    cal_src = data.get("train") or data["val"]
    imgs = []
    for f in _scan_images(cal_src)[:ncalib]:
        try:
            im = imread(f)
        except (OSError, ValueError):  # unreadable: skipped, as the JAX CLI does
            continue
        imgs.append(np.ascontiguousarray(letterbox_host(im, imgsz, auto=False)[0][..., ::-1]))
    if not imgs:
        raise SystemExit(f"--int8: no readable calibration images under {cal_src}")
    batches = [np.stack(imgs[i:i + 8]) for i in range(0, len(imgs), 8)]
    quant = calibrate_act_scales(model, batches, dtype=torch.float32)
    say(f"int8 calibration: {len(imgs)} images, {quant_coverage(model, quant)}")
    return quant


if __name__ == "__main__":
    main()
