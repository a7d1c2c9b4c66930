"""The eval protocol: the device program and the host mAP.

Port of `dmayolo_tpu/eval/validator.py`.  The device program
(`make_infer_fn`) is the forward, decode and multi-label `batched_nms` of a
whole batch, optionally with TTA; the host side scales boxes back to the
native image, matches them to the labels at 10 IoU thresholds and
aggregates AP (`eval/metrics.py`).  The protocol's defaults are the
reference's: conf 0.001, NMS IoU 0.6, multi-label, max_det 300, and 30,000
candidates before NMS.

`run_validation` reads a dataset from disk through the port's
`DetectionDataset` and `DataLoader` (letterboxed batches, optionally
rectangular) and runs the protocol over it; `_match_batch` and
`_summarize` are its loop's body and summary, on arrays shaped like the
loader's `Batch`: images (B, H, W, 3) uint8, targets cls (B, M), box xywhn
(B, M, 4), mask (B, M).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.nms import batched_nms
from ..data.datasets import DetectionDataset
from ..data.loader import Batch, DataLoader
from ..parallel.mesh import gather_rows, image_rows, with_group
from ..parallel.spatial import global_height, spatial_scope
from ..train.loss import Targets
from ..utils.device import resolve_device
from .coco_json import append_coco_json, image_id_map
from .metrics import ap_per_class, process_batch
from .tta import forward_augment

IOUV = np.linspace(0.5, 0.95, 10)  # the 10 IoU thresholds of mAP@.5:.95


def with_obj_column(dec: torch.Tensor, nc: int) -> torch.Tensor:
    """A TDetect decode (B, N, 4 + nc) with an objectness column of ones
    inserted after the box, the (B, N, 5 + nc) layout NMS reads; a Detect
    decode as it is."""
    if dec.shape[-1] != nc + 4:
        return dec
    return torch.cat([dec[..., :4], torch.ones_like(dec[..., :1]), dec[..., 4:]], -1)


@dataclass
class ValResult:
    mp: float = 0.0
    mr: float = 0.0
    map50: float = 0.0
    map75: float = 0.0
    map: float = 0.0
    maps: Optional[np.ndarray] = None  # per-class AP
    per_class: Optional[Dict[str, np.ndarray]] = None  # cls/p/r/ap50/ap/nt
    speed_ms: Dict[str, float] = field(default_factory=dict)
    nt: int = 0
    # image ids the --save-json writer used, for COCOeval imgIds scoping
    used_image_ids: Optional[list] = None

    def summary(self) -> str:
        return (
            f"P={self.mp:.4f} R={self.mr:.4f} mAP@.5={self.map50:.4f} "
            f"mAP@.75={self.map75:.4f} mAP@.5:.95={self.map:.4f} ({self.nt} labels)"
        )


def make_infer_fn(model, conf_thres: float, iou_thres: float, max_det: int,
                  dtype=torch.bfloat16, fused: bool = False, augment: bool = False,
                  max_nms: int = 30000, nms_backend: str = "scan", mesh=None,
                  spatial: bool = False, hybrid: bool = False, quant=None):
    """The whole-batch forward, decode and NMS (optionally TTA) of `model`,
    on the model's device.

    Returns `infer(images, *targets) -> (dets (B, max_det, 6), valid
    (B, max_det))`: images (B, H, W, 3) uint8; with `hybrid`, the targets
    (cls (B, M), box xywhn (B, M, 4), mask (B, M)) join the predictions
    before NMS as conf-1.0 candidates (the reference's --save-hybrid).
    `quant` ({conv name: input scale}, `nn/quant.py`) runs those convs on
    the int8 path; TTA takes none.

    `mesh` (`parallel/mesh.py`) with a group: `images` (and the targets)
    are this rank's rows of the global batch, and `infer` returns the
    global batch's detections and `valid` on every rank (each data rank's
    rows gathered by one SUM all-reduce of a zero-filled buffer, exact),
    as the JAX package's multi-host path does.  With `spatial` and a mesh
    that splits rows (JAX's `P("data", "spatial")`), `images` are also
    only this rank's H rows (`shard_batch(spatial=True)`): the forward runs
    in the spatial scope (`parallel/spatial.py`), its raw head comes back
    whole on every spatial rank, and decode and NMS run on it there; TTA
    gathers the input image and re-splits each scaled one.  `spatial` on a
    mesh that splits nothing is the data-parallel path, as in JAX."""
    dp = with_group(mesh.data) if mesh is not None else None
    split = spatial and mesh is not None and mesh.spatial
    if quant is not None and augment:  # the JAX package's words
        raise ValueError("--int8 with TTA (--augment) is not supported")
    device = next(model.parameters()).device

    def infer(x, *tgt):
        with torch.inference_mode(), spatial_scope(mesh if split else None):
            x = torch.as_tensor(x, device=device)
            xf = x.to(dtype) / 255.0
            if augment:
                dec = forward_augment(model, xf, dtype=dtype, fused=fused)
            else:
                dec = model.decode(model.apply(xf, dtype=dtype, fused=fused, quant=quant))
            dec = with_obj_column(dec, model.nc)
            if hybrid:
                t_cls, t_box, t_mask = (torch.as_tensor(t, device=device) for t in tgt)
                h = global_height(x, 1) if split else x.shape[1]
                w = x.shape[2]
                scale = torch.tensor([w, h, w, h], dtype=dec.dtype, device=device)
                obj = t_mask.to(dec.dtype)[..., None]
                onehot = F.one_hot(t_cls.long(), model.nc).to(dec.dtype) * obj
                rows = torch.cat([t_box.to(dec.dtype) * scale, obj, onehot], -1)
                dec = torch.cat([dec, rows], 1)
            dets, valid = batched_nms(dec, conf_thres=conf_thres, iou_thres=iou_thres,
                                      multi_label=True, max_det=max_det, max_nms=max_nms,
                                      backend=nms_backend)
            if dp is None:
                return dets, valid
            rows = gather_rows(dp, torch.cat([dets.float(), valid[..., None].float()], -1))
            return rows[..., :6].to(dets.dtype), rows[..., 6] > 0.5

    return infer


def _shared_batch(mesh, ds, j, batch: Batch, batch_size: int, max_targets: int,
                  img_size: int, rect: bool) -> Batch:
    """This rank's rows of global batch `j`, zero-padded to its share of
    the batch (the rows past the dataset's end are zero images with no
    labels, as JAX pads a short last batch)."""
    local_bs = batch_size // mesh.world
    n = len(batch.indices)
    if n == local_bs:
        return batch
    shape = (tuple(int(v) for v in ds.batch_shapes[j]) if rect
             else batch.images.shape[1:3] if n else (img_size, img_size))
    imgs = np.zeros((local_bs,) + tuple(shape) + (3,), np.uint8)
    t = Targets(np.zeros((local_bs, max_targets), np.float32),
                np.zeros((local_bs, max_targets, 4), np.float32),
                np.zeros((local_bs, max_targets), bool))
    if n:
        imgs[:n] = batch.images
        for full, part in zip(t, batch.targets):
            full[:n] = part
    return Batch(imgs, t, list(batch.indices) + [-1] * (local_bs - n))


def _global_batch(mesh, local: Batch, n: int) -> Batch:
    """The first `n` rows of the global batch's targets and dataset indices
    on every rank, from each rank's rows (one all-reduce; the images stay
    local)."""
    cls, box, mask = (np.asarray(a) for a in local.targets)
    b, m = cls.shape
    rows = np.concatenate([cls, box.reshape(b, -1), mask.astype(np.float32),
                           np.asarray(local.indices, np.float32)[:, None]], 1)
    rows = gather_rows(mesh, torch.from_numpy(rows).to(mesh.device)).cpu().numpy()[:n]
    t = Targets(rows[:, :m], rows[:, m:5 * m].reshape(n, m, 4), rows[:, 5 * m:6 * m] > 0.5)
    return Batch(None, t, rows[:, -1].astype(np.int64).tolist())


def _scale_to_native(boxes: np.ndarray, lb_shape, native_shape):
    """Letterbox inverse (the reference's scale_coords), numpy."""
    gain = min(lb_shape[0] / native_shape[0], lb_shape[1] / native_shape[1])
    pad_x = (lb_shape[1] - native_shape[1] * gain) / 2
    pad_y = (lb_shape[0] - native_shape[0] * gain) / 2
    out = boxes.copy()
    out[:, [0, 2]] = (out[:, [0, 2]] - pad_x) / gain
    out[:, [1, 3]] = (out[:, [1, 3]] - pad_y) / gain
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, native_shape[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, native_shape[0])
    return out


def _save_txt(dets_native, native_shape, path: Path, save_conf: bool):
    """xywhn txt rows (the reference's save_one_txt)."""
    h, w = native_shape
    lines = []
    for x1, y1, x2, y2, conf, cls in dets_native:
        cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
        bw, bh = (x2 - x1) / w, (y2 - y1) / h
        row = [int(cls), cx, cy, bw, bh] + ([conf] if save_conf else [])
        lines.append(" ".join(f"{v:.6g}" if i else str(v) for i, v in enumerate(row)))
    path.write_text("\n".join(lines) + ("\n" if lines else ""))


def _match_batch(dets: np.ndarray, valid: np.ndarray, hw, t_cls: np.ndarray,
                 t_box: np.ndarray, t_mask: np.ndarray, single_cls: bool = False):
    """One batch of the validation loop on the host.

    dets (>= n, max_det, 6) and valid from `infer` (as numpy; rows past the
    n images of the targets are padding); hw the letterbox (H, W); targets
    (n, M) cls, (n, M, 4) xywhn box, (n, M) mask.  Returns the per-image
    stats (correct (k, 10), conf, pred cls, target cls) and detections
    (k, 6) in letterbox pixels."""
    h, w = hw
    stats, kept = [], []
    for i in range(len(t_cls)):
        d = dets[i][valid[i]]  # (k, 6) xyxy conf cls in letterbox space
        if single_cls:
            d[:, 5] = 0  # the predictions join the labels' class 0
        m = np.asarray(t_mask[i])
        cls = np.asarray(t_cls[i])[m]
        box = np.asarray(t_box[i])[m]  # xywhn
        if len(box):
            lx = box * np.array([w, h, w, h])
            xyxy = np.stack([lx[:, 0] - lx[:, 2] / 2, lx[:, 1] - lx[:, 3] / 2,
                             lx[:, 0] + lx[:, 2] / 2, lx[:, 1] + lx[:, 3] / 2], 1)
            labels = np.concatenate([cls[:, None], xyxy], 1)
        else:
            labels = np.zeros((0, 5), np.float32)
        stats.append((process_batch(d, labels, IOUV), d[:, 4], d[:, 5], cls))
        kept.append(d)
    return stats, kept


def _summarize(stats: List[tuple], nc: int,
               speed_ms: Optional[Dict[str, float]] = None) -> ValResult:
    """P, R, mAP@.5, mAP@.75 and mAP@.5:.95 at the max-F1 operating point
    from the per-image stats of `_match_batch`."""
    if not stats:
        return ValResult()
    tp = np.concatenate([s[0] for s in stats])
    conf = np.concatenate([s[1] for s in stats])
    pred_cls = np.concatenate([s[2] for s in stats])
    tcls = np.concatenate([s[3] for s in stats])
    res = ValResult(nt=len(tcls), speed_ms=dict(speed_ms or {}))
    if tp.size and tcls.size:
        p, r, ap, f1, classes = ap_per_class(tp, conf, pred_cls, tcls)
        ap50, ap75, ap_mean = ap[:, 0], ap[:, 5], ap.mean(1)
        res.mp, res.mr = float(p.mean()), float(r.mean())
        res.map50, res.map75 = float(ap50.mean()), float(ap75.mean())
        res.map = float(ap_mean.mean())
        maps = np.zeros(nc)
        maps[classes] = ap_mean
        res.maps = maps
        nt_cls = np.bincount(tcls.astype(int), minlength=nc)[classes]
        res.per_class = {"cls": classes, "p": p, "r": r, "ap50": ap50,
                         "ap": ap_mean, "nt": nt_cls}
    return res


def run_validation(
    model,
    data_path,
    img_size: int = 640,
    batch_size: int = 16,
    nc: Optional[int] = None,
    conf_thres: float = 0.001,
    iou_thres: float = 0.6,
    max_det: int = 300,
    dtype=torch.bfloat16,
    fused: bool = False,
    max_targets: int = 256,
    augment: bool = False,
    save_txt_dir: Optional[Path] = None,
    save_conf: bool = False,
    rect: bool = False,
    pad: float = 0.5,
    single_cls: bool = False,
    max_nms: int = 30000,
    nms_backend: str = "scan",
    save_json: Optional[list] = None,
    class_map=None,
    mesh=None,
    spatial: bool = False,
    save_hybrid: bool = False,
    quant=None,
    workers: int = 4,
    device=None,
) -> ValResult:
    """The eval protocol over the images and labels under `data_path` (a
    directory or a txt list of images): P, R, mAP@.5, mAP@.75 and
    mAP@.5:.95 of `model` (in eval mode for the run), on `device` (None:
    CUDA; the model must be there).

    rect: the aspect-sorted rectangular batches (pad 0.5 of a stride).
    save_txt_dir / save_json: the detections in native pixels as txt rows
    or COCO entries; save_hybrid: the labels join the candidates before
    NMS.  `workers` loader threads.  speed_ms: the device step (forward,
    decode, NMS, the copy back) a image after the first batch, and the
    loader's wait a image.

    mesh (`parallel/mesh.py`) with a group: data-parallel eval, the batch
    size the global one (it must divide by the world size).  Each rank
    loads only its rows of each batch (the loader's process stripe), a
    short last batch zero-padded as JAX pads it, and `infer` returns the
    global detections on every rank; the targets and dataset indices are
    gathered likewise, so every rank holds the same statistics and result
    as one process.  Only rank 0 writes the `save_txt_dir` files; every
    rank fills `save_json`.  `spatial` on a mesh that splits rows: each
    rank of a spatial group loads its data rank's rows and keeps its H rows
    of them (`make_infer_fn(spatial=True)`), so the batch size divides by
    the data axis only."""
    device = resolve_device(device if device is not None or mesh is None else mesh.device)
    dp = with_group(mesh.data) if mesh is not None else None
    split = spatial and mesh is not None and mesh.spatial
    world = mesh.n_data if mesh is not None else 1
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must be divisible by the mesh data "
                         f"axis ({world})")
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model is on {next(model.parameters()).device}, "
                         f"validation asked for {device}")
    nc = nc if nc is not None else model.nc
    ds = DetectionDataset(
        data_path, img_size=img_size, augment=False, rect=rect,
        stride=int(model.stride.max()),
        nc=nc if not single_cls else 10 ** 6,  # ids validated against the raw dataset
        batch_size=batch_size, pad=pad, single_cls=single_cls)
    loader = DataLoader(ds, batch_size, max_targets=max_targets, shuffle=False,
                        drop_last=False, workers=workers,
                        process_index=0 if dp is None else dp.rank, process_count=world,
                        wrap_short=False)
    infer = make_infer_fn(model, conf_thres, iou_thres, max_det, dtype=dtype, fused=fused,
                          augment=augment, max_nms=max_nms, nms_backend=nms_backend,
                          mesh=mesh, spatial=spatial, hybrid=save_hybrid, quant=quant)
    if save_txt_dir is not None:
        save_txt_dir = Path(save_txt_dir)
        save_txt_dir.mkdir(parents=True, exist_ok=True)
    json_ids = image_id_map(ds.im_files) if save_json is not None else None
    # identity class map sized to the model, past 1000 for LVIS-scale counts
    cmap = class_map if class_map is not None else list(range(max(1000, nc)))

    stats_acc = []
    t_infer = t_first = t_wait = 0.0
    n_first = n_timed = n_all = 0
    was_training = model.training
    model.eval()
    try:
        t_w = time.perf_counter()
        for j, batch in enumerate(loader):
            t0 = time.perf_counter()
            t_wait += t0 - t_w
            if dp is not None:
                batch = _shared_batch(dp, ds, j, batch, batch_size, max_targets, img_size, rect)
            n = batch.images.shape[0]
            tgt = batch.targets if save_hybrid else ()
            dets, valid = infer(batch.images[:, image_rows(batch.images.shape[1], mesh)]
                                if split else batch.images, *tgt)
            hw = batch.images.shape[1:3]
            if dp is not None:
                batch = _global_batch(dp, batch, min(batch_size, len(ds) - j * batch_size))
                n = len(batch.indices)
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            if n_all == 0:  # the first batch carries the builds and the autotuning
                t_first, n_first = time.perf_counter() - t0, n
            else:
                t_infer += time.perf_counter() - t0
                n_timed += n
            n_all += n
            stats, kept = _match_batch(dets, valid, hw, *batch.targets, single_cls=single_cls)
            stats_acc += stats
            if save_txt_dir is not None or save_json is not None:
                for i, d in enumerate(kept):
                    idx = batch.indices[i]
                    native = tuple(ds.shapes[idx])
                    dn = d.copy()
                    dn[:, :4] = _scale_to_native(d[:, :4], hw, native)
                    if save_txt_dir is not None and (mesh is None or mesh.is_main):
                        _save_txt(dn, native, save_txt_dir / f"{Path(ds.im_files[idx]).stem}.txt",
                                  save_conf)
                    if save_json is not None:
                        append_coco_json(jdict=save_json, dets_native=dn,
                                         image_id=json_ids[str(ds.im_files[idx])],
                                         class_map=cmap)
            t_w = time.perf_counter()
    finally:
        model.train(was_training)

    if n_timed:
        speed = {"inference+nms": 1000 * t_infer / n_timed}
    else:  # one batch: only the one with the builds exists
        speed = {"inference+nms(incl compile)": 1000 * t_first / max(n_first, 1)}
    speed["loader_wait"] = 1000 * t_wait / max(n_all, 1)
    res = _summarize(stats_acc, nc, speed)
    if save_json is not None:
        res.used_image_ids = sorted(set(json_ids.values()), key=str)
    return res
