"""Inference CLI: images, folders, videos, webcams and streams -> annotated
images and videos, txt labels, crops.

Port of `dmayolo_tpu/cli/detect.py` (the reference's detect.py:38-394),
with its flags.  Images are read with the port's `imread` (JPEG through
libjpeg or nvJPEG, see `data/imageio.py`), letterboxed on the host as the
JAX CLI does with cv2, and run in batches of `--batch-size` through the
serving tail (`decode_parts` and `nms_parts` at max_nms 30,000: more than
512 candidates take K3's blocked entry) or, with `--augment`, TTA and
`batched_nms`.  Boxes and labels are drawn with the port's host library
(`cvops.rectangle`, pixel-equal to cv2's; `cvops.put_text`, a bitmap font,
not cv2's Hershey strokes) and written under the source's file name.
Weights: `.npz`, the reference `.pt`, or a `torch.export` program from
`cli.export` (`.pt2`, through `cli/backends.py`).

A video file (`.mp4`, `.avi`, `.mov`, `.mkv`), a webcam index or a
stream URL (`://`) runs frame by frame at batch 1 (`_run_video`, as the
JAX CLI): each frame decoded by OpenCV (`data/video.py`, the JAX CLI's
`cv2.VideoCapture`), letterboxed on the host, served, drawn and written to
`{stem}_det.mp4` (`mp4v`, the source's FPS and size; not for a webcam,
nor under `--nosave`).  A comma-separated list or a `.streams` file (one
source a line) runs batched (`_run_streams`): a reader thread a source
keeps its latest frame, and each step serves every live source's in one
batch (chunked where an exported program's batch is smaller), printing
the detections a stream every 10 steps.  `--view-img` prints that there
is no display.

    python -m dmayolo_tpu_torch.cli.detect --weights best.npz --source images/ --imgsz 1536
    python -m dmayolo_tpu_torch.cli.detect --weights best.npz --source flight.mp4 --imgsz 1536
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
VID_EXTS = {".mp4", ".avi", ".mov", ".mkv"}

PALETTE = [
    (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
    (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
    (52, 147, 26), (187, 212, 0), (168, 153, 44), (255, 194, 0),
    (147, 69, 52), (255, 115, 100), (236, 24, 0), (255, 56, 132),
    (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
]


def build_parser():
    p = argparse.ArgumentParser("dmayolo-detect")
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--source", type=str, required=True,
                   help="image, folder, video file, webcam index, stream URL, comma-separated "
                        "sources or a .streams file")
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=640,
                   dest="imgsz")
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--names", type=str, default=None, help="dataset yaml for class names")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--save-crop", action="store_true")
    p.add_argument("--classify", type=str, default=None,
                   help="second-stage classifier checkpoint: keep only detections whose "
                        "class the classifier agrees with (the reference's "
                        "apply_classifier)")
    p.add_argument("--classify-cfg", type=str, default=None,
                   help="model yaml for --classify when the checkpoint does not carry one "
                        "(must end in a Classify head)")
    p.add_argument("--visualize", action="store_true",
                   help="dump feature-map PNGs for the first image (needs matplotlib)")
    p.add_argument("--agnostic-nms", action="store_true")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--classes", type=int, nargs="+", default=None)
    p.add_argument("--project", type=str, default="runs/detect")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--line-thickness", type=int, default=3)
    p.add_argument("--hide-labels", action="store_true",
                   help="draw boxes without class labels")
    p.add_argument("--hide-conf", action="store_true",
                   help="draw labels without confidences")
    p.add_argument("--view-img", action="store_true",
                   help="show results in a window: the port has no display, it says so")
    p.add_argument("--update", action="store_true",
                   help="strip optimizer state from the weights file after the run")
    p.add_argument("--half", action="store_true",
                   help="accepted for parity; compute is bf16 by default (reference "
                        "--half = fp16); see --fp32")
    p.add_argument("--fp32", action="store_true",
                   help="run the forward in float32 (default bf16)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without it) or cpu")
    return p


def _gather_sources(source: Path):
    if source.is_dir():
        return sorted(p for p in source.rglob("*") if p.suffix.lower() in IMG_EXTS)
    return [source]


def is_streams(source) -> bool:
    """A comma-separated list or a `.streams` file: `_run_streams`."""
    return "," in str(source) or str(source).endswith(".streams")


def is_video(source) -> bool:
    """A video file, a webcam index or a stream URL: `_run_video`."""
    s = str(source)
    return Path(s).suffix.lower() in VID_EXTS or s.isdigit() or "://" in s


def draw(im: np.ndarray, d: np.ndarray, names, opt) -> None:
    """Boxes and labels of `d` (n, 6: native xyxy, conf, cls) on `im` in
    place, as the JAX CLI draws them with cv2."""
    from ..data import cvops

    for x1, y1, x2, y2, conf, cls in d:
        c = int(cls)
        color = PALETTE[c % len(PALETTE)]
        cvops.rectangle(im, (int(x1), int(y1)), (int(x2), int(y2)), color, opt.line_thickness)
        if not opt.hide_labels:
            txt = names[c] if opt.hide_conf else f"{names[c]} {conf:.2f}"
            cvops.put_text(im, txt, (int(x1), int(y1) - 4), 0.6, color, 2)


def main(argv=None):
    opt = build_parser().parse_args(argv)
    import torch
    import yaml

    from ..core.nms import batched_nms, nms_parts
    from ..data.imageio import imread, imwrite
    from ..data.letterbox import letterbox_host
    from ..eval.second_stage import apply_classifier, save_one_box
    from ..eval.tta import forward_augment
    from ..eval.validator import _scale_to_native, with_obj_column
    from .backends import detect_backend, load_backend
    from .common import check_img_size, increment_path, load_model_from_checkpoint, setup_device

    device = setup_device(opt.device)
    backend = detect_backend(opt.weights)
    model = None
    if backend == "native":
        model = load_model_from_checkpoint(opt.weights, opt.cfg, device=device).fuse()
        opt.imgsz = check_img_size(opt.imgsz, int(model.stride.max()))
        nc = model.nc
        gs = int(model.stride.max())
        names = [str(i) for i in range(nc)]
    else:
        # an exported program: preprocessing and decode at a FIXED
        # (batch, imgsz) (the reference's detect.py:96-141)
        if opt.augment or opt.visualize:
            raise SystemExit(f"--augment/--visualize need the native model graph; the "
                             f"{backend} artifact is a frozen decode program")
        backend_fn, bmeta = load_backend(opt.weights, backend, device=device)
        nc = int(bmeta["nc"])
        gs = int(bmeta["stride"])
        if opt.imgsz != bmeta["imgsz"]:
            print(f"{backend}: overriding --imgsz {opt.imgsz} -> {bmeta['imgsz']} "
                  "(baked into the exported program)")
            opt.imgsz = int(bmeta["imgsz"])
        backend_bs = int(bmeta["batch_size"])
        opt.batch_size = backend_bs
        tdetect = bmeta.get("head") == "TDetect"
        names = [str(n) for n in bmeta.get("names") or []] or [str(i) for i in range(nc)]
    if opt.names:
        with open(opt.names) as f:
            d = yaml.safe_load(f)
        names = d.get("names", names)

    out = increment_path(f"{opt.project}/{opt.name}", exist_ok=opt.exist_ok)
    out.mkdir(parents=True, exist_ok=True)
    if opt.save_txt:
        (out / "labels").mkdir(exist_ok=True)

    class_mask = None
    if opt.classes is not None:
        class_mask = torch.as_tensor(np.isin(np.arange(nc), opt.classes), device=device)

    classifier_fn = None
    if opt.classify:
        from ..eval.second_stage import load_second_stage

        classifier_fn = load_second_stage(opt.classify, opt.classify_cfg, device=device)

    dtype = torch.float32 if opt.fp32 else torch.bfloat16

    if backend != "native":
        def infer(x):
            b = x.shape[0]
            if b > backend_bs:
                # more images than the program's static batch: chunk
                parts = [infer(x[i:i + backend_bs]) for i in range(0, b, backend_bs)]
                return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
            if b < backend_bs:  # the program has a static batch dim
                x = np.concatenate([x, np.zeros((backend_bs - b,) + x.shape[1:], x.dtype)])
            with torch.inference_mode():
                dec = backend_fn(x)
                if tdetect:  # TDetect's decode is (B, A, 4 + nc): obj = 1 column
                    dec = with_obj_column(dec, nc)
                dets, valid = batched_nms(dec, conf_thres=opt.conf_thres,
                                          iou_thres=opt.iou_thres, agnostic=opt.agnostic_nms,
                                          max_det=opt.max_det, class_mask=class_mask)
            return dets[:b], valid[:b]
    else:
        def infer(x):
            with torch.inference_mode():
                xf = torch.as_tensor(x, device=device).to(dtype) / 255.0
                if opt.augment:
                    dec = with_obj_column(forward_augment(model, xf, dtype=dtype, fused=True),
                                          model.nc)
                    return batched_nms(dec, conf_thres=opt.conf_thres, iou_thres=opt.iou_thres,
                                       agnostic=opt.agnostic_nms, max_det=opt.max_det,
                                       class_mask=class_mask)
                # serving fast path: fused per-scale decode, the same
                # results as decode + single-label batched_nms (the
                # reference's detect.py is single-label)
                raw = model.apply(xf, dtype=dtype, fused=True)
                boxes, scores, cls = model.decode_parts(raw, class_mask=class_mask)
                return nms_parts(boxes, scores, cls, conf_thres=opt.conf_thres,
                                 iou_thres=opt.iou_thres, agnostic=opt.agnostic_nms,
                                 max_det=opt.max_det, max_nms=30000)

    if opt.view_img:
        print("--view-img: no display available, skipping")
        opt.view_img = False
    if is_streams(opt.source) or is_video(opt.source):
        run = _run_streams if is_streams(opt.source) else _run_video
        res = run(opt, infer, names, out, classifier_fn)
        _maybe_update(opt, backend)
        return res
    files = _gather_sources(Path(opt.source))
    if not files:
        raise FileNotFoundError(f"no inputs in {opt.source}")

    if opt.visualize:
        from ..utils.plots import feature_visualization

        lb = letterbox_host(imread(files[0]), opt.imgsz, auto=False, stride=gs)[0]
        xv = torch.as_tensor(lb[None, :, :, ::-1].astype(np.float32) / 255.0, device=device)
        with torch.inference_mode():
            feats = model.apply_with_features(xv, fused=True)
        vis_dir = out / "features"
        for i, tname, t in feats:
            if torch.is_tensor(t) and t.dim() == 4:
                feature_visualization(t.float().cpu().numpy(), tname, i, save_dir=vis_dir)
        print(f"feature maps -> {vis_dir}")
    bs = min(opt.batch_size, len(files))

    n_done = 0
    t0 = time.perf_counter()
    for start in range(0, len(files), bs):
        chunk = files[start:start + bs]
        ims0 = [imread(f) for f in chunk]
        lbs = [letterbox_host(im, opt.imgsz, auto=False, stride=gs)[0] for im in ims0]
        x = np.stack([im[:, :, ::-1] for im in lbs])  # BGR -> RGB
        if x.shape[0] < bs:
            x = np.concatenate([x, np.zeros((bs - x.shape[0],) + x.shape[1:], x.dtype)])
        dets, valid = _to_host(*infer(x))

        for i, (f, im0) in enumerate(zip(chunk, ims0)):
            d = dets[i][valid[i]]
            if classifier_fn is not None:  # the reference's detect.py:253-255
                d = apply_classifier([d], classifier_fn, x.shape[1:3], [im0])[0]
            d[:, :4] = _scale_to_native(d[:, :4], x.shape[1:3], im0.shape[:2])
            n_done += 1
            imc = im0.copy() if opt.save_crop else None  # clean copy before the drawing
            label_summary = {}
            for cls in d[:, 5]:
                label_summary[names[int(cls)]] = label_summary.get(names[int(cls)], 0) + 1
            if not opt.nosave:
                draw(im0, d, names, opt)
                imwrite(out / f.name, im0)
            if opt.save_crop:
                for j, (x1, y1, x2, y2, conf, cls) in enumerate(d):
                    # gain/pad margin and BGR as the reference's save_one_box call
                    cdir = out / "crops" / names[int(cls)]
                    save_one_box((x1, y1, x2, y2), imc, file=cdir / f"{f.stem}_{j}.jpg",
                                 BGR=True)
            if opt.save_txt:
                h, w = im0.shape[:2]
                lines = []
                for x1, y1, x2, y2, conf, cls in d:
                    row = [int(cls), (x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                           (x2 - x1) / w, (y2 - y1) / h] + ([conf] if opt.save_conf else [])
                    lines.append(" ".join(f"{v:.6g}" if j else str(int(v))
                                          for j, v in enumerate(row)))
                (out / "labels" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")
            print(f"{f.name}: {label_summary or 'no detections'}")

    dt = time.perf_counter() - t0
    print(f"done: {n_done} images in {dt:.2f}s ({1000 * dt / max(n_done, 1):.1f} ms/img) "
          f"-> {out}")
    _maybe_update(opt, backend)
    return out


def _maybe_update(opt, backend) -> None:
    """--update (the reference's detect.py): strip the optimizer state from
    the weights file after the run."""
    if not opt.update:
        return
    if backend != "native":
        print("--update: n/a for exported-program artifacts")
    elif str(opt.weights).endswith(".pt"):
        print("--update: skipped: reference .pt checkpoints are loaded read-only "
              "(cli.export --include torch writes torch weights)")
    else:
        from ..utils.checkpoint import strip_checkpoint

        strip_checkpoint(opt.weights)
        print(f"--update: stripped optimizer state from {opt.weights}")


def _to_host(dets, valid):
    """`infer`'s (dets, valid) as float and bool numpy arrays."""
    return dets.float().cpu().numpy(), valid.cpu().numpy()


def _run_video(opt, infer, names, out, classifier_fn=None):
    """A video file, webcam index or stream URL, frame by frame at batch 1
    (the JAX CLI's `_run_video`; the reference's LoadImages video branch):
    letterboxed without stride padding, served, the second stage applied,
    drawn, and written to `{stem}_det.mp4` at the source's FPS and size
    (not for a webcam, nor under --nosave)."""
    from ..data.letterbox import letterbox_host
    from ..data.video import Capture, Writer
    from ..eval.second_stage import apply_classifier
    from ..eval.validator import _scale_to_native

    cap = Capture(opt.source)
    writer = None
    n = 0
    t0 = time.perf_counter()
    try:
        if not opt.nosave and not cap.is_camera:
            writer = Writer(out / (Path(str(opt.source)).stem + "_det.mp4"), cap.fps,
                            (cap.width, cap.height))
        while (frame := cap.read()) is not None:
            lb = letterbox_host(frame, opt.imgsz, auto=False)[0]
            dets, valid = _to_host(*infer(np.ascontiguousarray(lb[None, :, :, ::-1])))  # RGB
            d = dets[0][valid[0]]
            if classifier_fn is not None:  # the reference's detect.py:253-255
                d = apply_classifier([d], classifier_fn, lb.shape[:2], [frame])[0]
            d[:, :4] = _scale_to_native(d[:, :4], lb.shape[:2], frame.shape[:2])
            draw(frame, d, names, opt)
            if writer is not None:
                writer.write(frame)
            n += 1
    finally:
        if writer is not None:
            writer.release()
        cap.release()
    dt = time.perf_counter() - t0
    print(f"video: {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} FPS) -> {out}")
    return out


# how long the streams' loop waits at its end for a reader's last read
READER_JOIN_S = 10.0


def stream_sources(source) -> list:
    """The sources of a comma-separated list or of a `.streams` file (one
    path, URL or webcam index a line)."""
    if str(source).endswith(".streams"):
        return [s.strip() for s in Path(source).read_text().splitlines() if s.strip()]
    return [s.strip() for s in str(source).split(",") if s.strip()]


def _run_streams(opt, infer, names, out, classifier_fn=None):
    """Several sources batched through one program a step (the JAX CLI's
    `_run_streams`; the reference's LoadStreams): a reader thread a source
    keeps its latest frame under a lock; each step, once every live source
    has a frame, their frames (a finished source's last one too) are
    letterboxed and served as one batch.  Every 10 steps the detections a
    stream are printed, after the second stage.  Stops when every source
    has ended, or after `max_stream_steps` steps where `opt` has it.  A
    capture is released once its reader has ended; a reader still blocked
    in a read READER_JOIN_S after the loop (a stalled camera or stream)
    keeps its capture, left to the daemon thread."""
    import threading

    from ..data.letterbox import letterbox_host
    from ..data.video import Capture
    from ..eval.second_stage import apply_classifier

    srcs = stream_sources(opt.source)
    caps, threads = [], []
    frames = [None] * len(srcs)
    alive = [True] * len(srcs)
    lock = threading.Lock()

    def reader(i):
        while alive[i]:
            f = caps[i].read()
            if f is None:
                alive[i] = False
                break
            with lock:
                frames[i] = f

    n_steps = 0
    t0 = time.perf_counter()
    try:
        for s in srcs:
            caps.append(Capture(s))
        threads = [threading.Thread(target=reader, args=(i,), daemon=True)
                   for i in range(len(srcs))]
        for t in threads:
            t.start()
        while any(alive) and n_steps < getattr(opt, "max_stream_steps", 10 ** 9):
            with lock:
                batch0 = [f.copy() for f in frames if f is not None]
            if len(batch0) < sum(alive):
                time.sleep(0.01)
                continue
            if not batch0:
                break
            lbs = [letterbox_host(f, opt.imgsz, auto=False)[0] for f in batch0]
            dets, valid = _to_host(*infer(np.stack([f[:, :, ::-1] for f in lbs])))  # RGB
            n_steps += 1
            if n_steps % 10 == 0:
                ds = [dets[i][valid[i]] for i in range(len(batch0))]
                if classifier_fn is not None:  # the reference's detect.py:253-255
                    ds = apply_classifier(ds, classifier_fn, lbs[0].shape[:2], batch0)
                print(f"step {n_steps}: dets per stream {[len(d) for d in ds]}", flush=True)
    finally:
        for i in range(len(srcs)):
            alive[i] = False
        for i, c in enumerate(caps):  # a reader ends after the read it is in
            if i < len(threads):
                threads[i].join(timeout=READER_JOIN_S)
                if threads[i].is_alive():
                    continue
            c.release()
    dt = time.perf_counter() - t0
    print(f"streams: {n_steps} batched steps over {len(srcs)} sources in {dt:.1f}s "
          f"({n_steps * len(srcs) / max(dt, 1e-9):.1f} FPS aggregate)")
    return out


if __name__ == "__main__":
    main()
