"""REST serving demo: POST an image, get JSON detections.

Port of `dmayolo_tpu/serve/restapi.py` (the reference's
utils/flask_rest_api/restapi.py:16-36), on the standard library's
`ThreadingHTTPServer` as the JAX one, with the same contract:

    curl -X POST -F image=@bus.jpg http://localhost:5000/v1/object-detection
    -> [{"xmin":..,"ymin":..,"xmax":..,"ymax":..,"confidence":..,"class":..,"name":..}, ...]

The upload is decoded by the port's `imageio.imdecode` (JPEG, MPO, PNG,
BMP, TIFF, or webp through cv2's libwebp, whose pixels are PIL's) in
place of PIL, as PIL decodes it: a JPEG's, PNG's or webp's EXIF
orientation is not applied, a TIFF's is, and alpha is dropped.  One
difference stays: 16-bit TIFF and 16-bit BMP samples take cv2's scaling,
not PIL's.  Per request, an `AutoShape` from `hub.load` serves it
(batch 1, its records built without pandas, the keys and values of JAX's
`results.pandas().xyxy[0].to_dict(orient="records")`); with
`--batch-serve N` a `MicroBatcher` coalesces concurrent requests into
device batches of up to N.

    python -m dmayolo_tpu_torch.serve.restapi --weights best.npz --port 5000 --batch-serve 16
"""
from __future__ import annotations

import argparse
import json
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..data.imageio import imdecode


def _parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser for a single file field."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return body  # raw bytes upload
    boundary = ("--" + m.group(1)).encode()
    for part in body.split(boundary):
        if b"\r\n\r\n" in part and (b"filename=" in part or b"name=\"image\"" in part):
            return part.split(b"\r\n\r\n", 1)[1].rstrip(b"\r\n-")
    return None


def batch_records(dets, names):
    """MicroBatcher rows (n, 6) -> the JSON records."""
    return [{"xmin": float(x1), "ymin": float(y1), "xmax": float(x2), "ymax": float(y2),
             "confidence": float(conf), "class": int(cls), "name": names[int(cls)]}
            for x1, y1, x2, y2, conf, cls in dets]


class Handler(BaseHTTPRequestHandler):
    """POST /v1/object-detection.  `make_server` subclasses it with the
    model (`AutoShape`), or the batcher, and the image size."""

    model = None
    batcher = None
    imgsz = 640

    def do_POST(self):
        if not self.path.startswith("/v1/object-detection"):
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        data = _parse_multipart(body, self.headers.get("Content-Type", ""))
        if not data:
            self.send_error(400, "no image field")
            return
        try:
            # PIL's decode, which the REST API answers to: a JPEG's, PNG's
            # or webp's EXIF orientation is not applied
            rgb = imdecode(data, exif=False)[:, :, ::-1].copy()  # BGR -> RGB
        except ValueError:
            self.send_error(400, "undecodable image")
            return
        try:
            if self.batcher is not None:
                # micro-batched path: concurrent requests ride one device batch
                payload = batch_records(self.batcher(rgb, timeout=60), self.batcher.names)
            else:
                payload = self.model(rgb, size=self.imgsz).records(0)
        except Exception as e:  # a failed inference is a 500, not a dropped socket
            self.send_error(500, f"inference failed: {type(e).__name__}")
            return
        out = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, fmt, *args):
        print(f"[restapi] {self.address_string()} {fmt % args}")


def make_server(host: str, port: int, model=None, batcher=None,
                imgsz: int = 640) -> ThreadingHTTPServer:
    """A server (not yet serving) that answers with `batcher` where one is
    given, else with `model`; port 0 takes a free port
    (`server.server_address`)."""
    handler = type("BoundHandler", (Handler,), {"model": model, "batcher": batcher,
                                                "imgsz": int(imgsz)})
    return ThreadingHTTPServer((host, port), handler)


def build_parser():
    p = argparse.ArgumentParser("dmayolo-restapi")
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--cfg", type=str, default="yolov5s.yaml")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without it) or cpu")
    p.add_argument("--batch-serve", type=int, default=0, metavar="MAX_BATCH",
                   help="micro-batch concurrent requests up to this device batch (0 = "
                        "per-request batch 1, as the reference)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="how long a request waits for batch co-riders")
    p.add_argument("--imgsz", type=int, default=640)
    # the batched path's detection contract, defaulted to the per-request
    # AutoShape's (conf 0.25, IoU 0.45, max_det 1000); max-nms is the
    # candidates kept before NMS
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=1000)
    p.add_argument("--max-nms", type=int, default=4096)
    return p


def build(opt):
    """The model or batcher that `opt` asks for: (model, batcher)."""
    if opt.batch_serve > 0:
        from ..cli.common import load_model_from_checkpoint
        from .batcher import MicroBatcher

        model = load_model_from_checkpoint(opt.weights, opt.cfg, device=opt.device)
        batcher = MicroBatcher(model, imgsz=opt.imgsz, max_batch=opt.batch_serve,
                               max_wait_ms=opt.max_wait_ms, conf_thres=opt.conf_thres,
                               iou_thres=opt.iou_thres, max_det=opt.max_det,
                               max_nms=opt.max_nms, device=opt.device)
        print(f"micro-batching up to {opt.batch_serve} reqs/{opt.max_wait_ms} ms; "
              "warming the batch buckets ...")
        batcher.warmup()
        return None, batcher
    from ..hub import load

    model = load(weights=opt.weights, cfg=opt.cfg, device=opt.device)
    model.conf, model.iou, model.max_det = opt.conf_thres, opt.iou_thres, opt.max_det
    return model, None


def main(argv=None):
    opt = build_parser().parse_args(argv)
    model, batcher = build(opt)
    server = make_server(opt.host, opt.port, model=model, batcher=batcher, imgsz=opt.imgsz)
    print(f"serving on {opt.host}:{opt.port} (POST /v1/object-detection)")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()


if __name__ == "__main__":
    main()
