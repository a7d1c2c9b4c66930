"""Synthetic datasets on disk, without OpenCV: the offline stand-ins for
coco128 (`generate`: shapes on texture) and for VisDrone-DET
(`generate_visdrone_analog`: tiny, crowded, imbalanced objects on aerial
scenes).

Port of `dmayolo_tpu/data/synthetic.py`.  Every random draw is the JAX
package's, in its order, from the same numpy generators, so the label
files come out byte-equal to the JAX package's; the drawing goes through
`cvops`'s raster, whose edges may differ from cv2's by a pixel, so the
images are close to the JAX package's but not equal.  Images are written
as JPEG (quality 85 for the VisDrone analog, as the JAX generator writes
them) through the machine's JPEG route (`imageio.jpeg_codec()`: libjpeg,
or nvJPEG on a card's machine without it), which raises where there is
none; or, with `ext="png"`, as PNG.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import yaml

from . import cvops
from .imageio import imwrite

CLASSES = ["rectangle", "circle", "triangle"]

# VisDrone-analog: the class list of VisDrone.yaml (10 classes); the
# sampling weights approximate VisDrone-DET's published class imbalance
VISDRONE_CLASSES = [
    "pedestrian", "people", "bicycle", "car", "van",
    "truck", "tricycle", "awning-tricycle", "bus", "motor",
]
VISDRONE_FREQ = np.array(
    [0.21, 0.07, 0.03, 0.38, 0.07, 0.03, 0.013, 0.009, 0.016, 0.08])
VISDRONE_FREQ = VISDRONE_FREQ / VISDRONE_FREQ.sum()


def _write_labels(path: Path, labels):
    with open(path, "w") as f:
        for row in labels:
            f.write(" ".join(f"{v:.6f}" if k else str(v) for k, v in enumerate(row)) + "\n")


def generate(root, n_train=64, n_val=16, img_size=320, seed=0, ext="jpg"):
    """Coloured rectangles, circles and triangles on a textured background;
    the class is the shape.  Returns the dataset yaml's path."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = (rng.integers(0, 60, (img_size, img_size, 3)) + 60).astype(np.uint8)
            for _ in range(30):  # background texture
                x, y = rng.integers(0, img_size, 2)
                cvops.fill_circle(img, (int(x), int(y)), int(rng.integers(1, 4)),
                                  tuple(int(c) for c in rng.integers(40, 120, 3)))
            labels = []
            for _ in range(int(rng.integers(1, 6))):
                kind = int(rng.integers(0, 3))
                size = int(rng.integers(img_size // 10, img_size // 4))
                cx = int(rng.integers(size, img_size - size))
                cy = int(rng.integers(size, img_size - size))
                color = tuple(int(c) for c in rng.integers(160, 255, 3))
                if kind == 0:
                    w, h = size, int(size * rng.uniform(0.5, 1.0))
                    cvops.fill_rect(img, (cx - w // 2, cy - h // 2), (cx + w // 2, cy + h // 2), color)
                    bw, bh = w, h
                elif kind == 1:
                    r = size // 2
                    cvops.fill_circle(img, (cx, cy), r, color)
                    bw = bh = 2 * r
                else:
                    r = size // 2
                    pts = np.array([[cx, cy - r], [cx - r, cy + r], [cx + r, cy + r]])
                    cvops.fill_poly(img, pts, color)
                    bw, bh = 2 * r, 2 * r
                labels.append((kind, cx / img_size, cy / img_size, bw / img_size, bh / img_size))
            imwrite(root / "images" / split / f"{i:05d}.{ext}", img)
            _write_labels(root / "labels" / split / f"{i:05d}.txt", labels)

    data = {"path": str(root), "train": "images/train", "val": "images/val",
            "nc": len(CLASSES), "names": CLASSES}
    with open(root / "shapes.yaml", "w") as f:
        yaml.safe_dump(data, f)
    return root / "shapes.yaml"


def _rot_rect(cx, cy, length, width, ang):
    """Corner points (4, 2) float of a rotated rectangle."""
    c, s = np.cos(ang), np.sin(ang)
    d = np.array([[length / 2, width / 2], [length / 2, -width / 2],
                  [-length / 2, -width / 2], [-length / 2, width / 2]])
    rot = np.array([[c, -s], [s, c]])
    return d @ rot.T + np.array([cx, cy])


def _poly(img, pts, color):
    cvops.fill_poly(img, np.round(pts).astype(np.int32), color)


def _aabb(ptss, img_size):
    pts = np.concatenate(ptss, 0)
    x0, y0 = np.clip(pts.min(0), 0, img_size)
    x1, y1 = np.clip(pts.max(0), 0, img_size)
    return x0, y0, x1, y1


class _SceneRNG:
    """Every draw of one scene through one numpy Generator."""

    def __init__(self, rng):
        self.rng = rng

    def u(self, lo, hi):
        return float(self.rng.uniform(lo, hi))

    def i(self, lo, hi):
        return int(self.rng.integers(lo, hi))

    def lognorm(self, med, sigma, lo, hi):
        return float(np.clip(med * np.exp(self.rng.normal(0, sigma)), lo, hi))


def _draw_vehicle(img, r, cls, cx, cy, ang, scale):
    """One vehicle sprite; returns its corner-point sets for the box.
    car/van overlap in size and palette (the cue is the windshield stripe
    and the aspect), truck is cab + box, bus long and saturated."""
    if cls == 3:  # car
        L = r.lognorm(11, 0.40, 6, 26) * scale
        W = L * r.u(0.42, 0.52)
        shade = r.i(0, 3)
        body = ([r.i(90, 200)] * 3 if shade == 0 else
                [r.i(10, 60)] * 3 if shade == 1 else
                [r.i(30, 220), r.i(30, 220), r.i(30, 220)])
        pts = _rot_rect(cx, cy, L, W, ang)
        _poly(img, pts, tuple(int(v) for v in body))
        wind = _rot_rect(cx + np.cos(ang) * L * 0.18,
                         cy + np.sin(ang) * L * 0.18, L * 0.22, W * 0.8, ang)
        _poly(img, wind, (40, 40, 50))
        return [pts]
    if cls == 4:  # van: bigger, light, solid roof
        L = r.lognorm(14, 0.35, 8, 30) * scale
        W = L * r.u(0.40, 0.50)
        v = r.i(150, 240)
        pts = _rot_rect(cx, cy, L, W, ang)
        _poly(img, pts, (v, v, v))
        return [pts]
    if cls == 5:  # truck: dark cab + light cargo box
        L = r.lognorm(20, 0.30, 12, 42) * scale
        W = L * r.u(0.30, 0.40)
        cab = _rot_rect(cx + np.cos(ang) * L * 0.38,
                        cy + np.sin(ang) * L * 0.38, L * 0.24, W, ang)
        box = _rot_rect(cx - np.cos(ang) * L * 0.12,
                        cy - np.sin(ang) * L * 0.12, L * 0.72, W, ang)
        v = r.i(160, 245)
        _poly(img, box, (v, v, v))
        _poly(img, cab, (r.i(20, 90),) * 3)
        return [cab, box]
    # bus: longest, saturated single colour
    L = r.lognorm(26, 0.25, 18, 46) * scale
    W = L * r.u(0.26, 0.34)
    hue = [(40, 60, 200), (200, 80, 40), (40, 160, 60), (30, 170, 200)]
    pts = _rot_rect(cx, cy, L, W, ang)
    _poly(img, pts, hue[r.i(0, 4)])
    return [pts]


def _draw_small(img, r, cls, cx, cy, ang, scale):
    """Pedestrian, people, bicycle, motor, tricycle and awning-tricycle
    sprites: the tiny end of VisDrone's size profile (3-10 px)."""
    if cls in (0, 1):  # pedestrian upright vs people (sitting: wider)
        s = r.lognorm(4.2, 0.30, 2.5, 8) * scale
        w, h = (s * 0.55, s) if cls == 0 else (s, s * 0.7)
        col = (r.i(0, 120), r.i(0, 120), r.i(0, 150))
        cvops.fill_ellipse(img, (int(cx), int(cy)), (max(1, int(w / 2)), max(1, int(h / 2))),
                           np.degrees(ang), col)
        head = (int(cx), int(cy - h * 0.2))
        cvops.fill_circle(img, head, 1, (r.i(120, 220),) * 3)
        return [np.array([[cx - w / 2, cy - h / 2], [cx + w / 2, cy + h / 2]])]
    if cls in (2, 9):  # bicycle (thin dark) vs motor (thicker, bright dot)
        L = r.lognorm(6.5, 0.25, 4, 11) * scale
        W = L * (0.22 if cls == 2 else 0.34)
        pts = _rot_rect(cx, cy, L, W, ang)
        _poly(img, pts, (r.i(10, 70),) * 3)
        if cls == 9:
            cvops.fill_circle(img, (int(cx), int(cy)), 1,
                              (r.i(120, 255), r.i(120, 255), r.i(120, 255)))
        return [pts]
    # tricycle / awning-tricycle: small wedge; awning adds a light canopy
    L = r.lognorm(8, 0.25, 5, 14) * scale
    W = L * 0.55
    pts = _rot_rect(cx, cy, L, W, ang)
    _poly(img, pts[:3], (r.i(20, 120), r.i(20, 120), r.i(20, 120)))
    out = [pts]
    if cls == 7:
        canopy = _rot_rect(cx - np.cos(ang) * L * 0.15,
                           cy - np.sin(ang) * L * 0.15, L * 0.5, W * 1.1, ang)
        _poly(img, canopy, (r.i(170, 250),) * 3)
        out.append(canopy)
    return out


def _background(img, r, img_size, roads):
    """Aerial base plate: asphalt roads with lane dashes, building blocks
    with roof fixtures (unlabelled small-rectangle distractors), vegetation."""
    img[:] = np.stack([_noise_plane(r, img_size, 98, 130)] * 3, -1)
    for _ in range(r.i(6, 14)):  # building blocks
        w, h = r.i(30, 110), r.i(30, 110)
        x, y = r.i(-20, img_size - 10), r.i(-20, img_size - 10)
        v = r.i(70, 170)
        cvops.fill_rect(img, (x, y), (x + w, y + h), (v + r.i(-15, 15), v + r.i(-15, 15), v))
        for _ in range(r.i(0, 6)):  # roof fixtures: car-sized distractors
            fx, fy = r.i(x + 3, x + max(4, w - 3)), r.i(y + 3, y + max(4, h - 3))
            fl, fw = r.i(4, 14), r.i(3, 8)
            fv = r.i(40, 220)
            cvops.fill_rect(img, (fx, fy), (fx + fl, fy + fw), (fv, fv, fv))
    for _ in range(r.i(8, 20)):  # vegetation blobs
        x, y = r.i(0, img_size), r.i(0, img_size)
        cvops.fill_circle(img, (x, y), r.i(4, 18), (r.i(20, 60), r.i(60, 120), r.i(20, 60)))
    for (px, py, ang, width) in roads:  # dark strips + centre dashes
        d = np.array([np.cos(ang), np.sin(ang)])
        p0 = np.array([px, py]) - d * img_size * 2
        p1 = np.array([px, py]) + d * img_size * 2
        cvops.line(img, tuple(np.round(p0).astype(int)), tuple(np.round(p1).astype(int)),
                   (r.i(55, 80),) * 3, int(width))
        for t in np.arange(-1.5, 1.5, 0.035):
            q = np.array([px, py]) + d * t * img_size * 2
            q2 = q + d * 5
            cvops.line(img, tuple(np.round(q).astype(int)), tuple(np.round(q2).astype(int)),
                       (200, 200, 200), 1)


def _noise_plane(r, img_size, lo, hi):
    return r.rng.integers(lo, hi, (img_size, img_size)).astype(np.uint8)


def _visdrone_scene(seed, img_size, min_objects, max_objects, obj_scale, occlusion,
                    cluster_scale):
    """One scene from its seed: (BGR image, label rows)."""
    r = _SceneRNG(np.random.default_rng(seed))
    img = np.empty((img_size, img_size, 3), np.uint8)
    roads = [(r.u(0, img_size), r.u(0, img_size), r.u(0, np.pi), r.u(18, 40) * cluster_scale)
             for _ in range(r.i(2, 4))]
    _background(img, r, img_size, roads)

    n_obj = r.i(min_objects, max_objects + 1)
    cls_draw = r.rng.choice(10, size=n_obj, p=VISDRONE_FREQ)
    labels = []
    # cluster process: vehicles queue on roads, smalls crowd
    crowd_centres = [(r.u(0, img_size), r.u(0, img_size)) for _ in range(r.i(2, 6))]
    order = r.rng.permutation(n_obj)
    for j in order:
        cls = int(cls_draw[j])
        vehicle = cls in (3, 4, 5, 8)
        if vehicle and r.u(0, 1) < 0.7:
            px, py, ang, width = roads[r.i(0, len(roads))]
            d = np.array([np.cos(ang), np.sin(ang)])
            t = r.u(-0.45, 0.45) * img_size * 2
            lat = r.u(-width * 0.35, width * 0.35)
            cx = px + d[0] * t - d[1] * lat
            cy = py + d[1] * t + d[0] * lat
            a = ang + r.u(-0.1, 0.1) + (np.pi if r.u(0, 1) < 0.5 else 0)
        elif not vehicle and r.u(0, 1) < 0.6:
            ccx, ccy = crowd_centres[r.i(0, len(crowd_centres))]
            cx = ccx + r.rng.normal(0, 11 * cluster_scale)
            cy = ccy + r.rng.normal(0, 11 * cluster_scale)
            a = r.u(0, 2 * np.pi)
        else:
            cx, cy = r.u(0, img_size), r.u(0, img_size)
            a = r.u(0, 2 * np.pi)
        if not (0 <= cx < img_size and 0 <= cy < img_size):
            continue
        if vehicle:
            ptss = _draw_vehicle(img, r, cls, cx, cy, a, obj_scale)
        else:
            ptss = _draw_small(img, r, cls, cx, cy, a, obj_scale)
        x0, y0, x1, y1 = _aabb(ptss, img_size)
        if x1 - x0 < 2 or y1 - y0 < 2:
            continue
        labels.append((cls, (x0 + x1) / 2 / img_size, (y0 + y1) / 2 / img_size,
                       (x1 - x0) / img_size, (y1 - y0) / img_size))

    # vegetation occluders over objects (their labels are kept)
    for _ in range(int(r.i(2, 7) * occlusion)):
        x, y = r.i(0, img_size), r.i(0, img_size)
        cvops.fill_circle(img, (x, y), r.i(5, 14), (r.i(20, 60), r.i(60, 120), r.i(20, 60)))

    # photometric: gamma, sensor noise, altitude blur
    gamma = r.u(0.75, 1.3)
    lut = np.clip((np.arange(256) / 255.0) ** gamma * 255, 0, 255).astype(np.uint8)
    img = lut[img]
    img = cvops.add_saturate(img, r.rng.normal(0, r.u(2, 7), img.shape).astype(np.int16))
    if r.u(0, 1) < 0.5:
        img = cvops.gaussian_blur(img, 3, r.u(0.3, 0.8))
    return img, labels


def generate_visdrone_analog(root, n_train=256, n_val=512, img_size=512,
                             seed=0, min_objects=40, max_objects=110,
                             obj_scale=1.0, occlusion=1.0,
                             cluster_scale=1.0, ext="jpg", workers=1):
    """VisDrone-DET analog for offline benchmarking: tiny objects (vehicle
    lengths lognormal ~6-46 px, pedestrians 2.5-8 px), 40-110 objects an
    image placed by a cluster process (queues along roads, crowds), the
    10-way class imbalance of VISDRONE_FREQ, confusable class pairs,
    unlabelled distractors, occluders, and per-image gamma, noise and blur.
    `cluster_scale` widens the cluster geometry with the objects.

    Each scene draws from its own generator, seeded in order from `seed`'s,
    so `workers` threads draw and write the scenes in parallel with the
    same result.  Returns the dataset yaml's path."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    jobs = []
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        jobs += [(split, i, int(rng.integers(1 << 62))) for i in range(n)]

    def one(job):
        split, i, s = job
        img, labels = _visdrone_scene(s, img_size, min_objects, max_objects, obj_scale,
                                      occlusion, cluster_scale)
        imwrite(root / "images" / split / f"{i:05d}.{ext}", img, quality=85)
        _write_labels(root / "labels" / split / f"{i:05d}.txt", labels)

    with ThreadPoolExecutor(max(1, workers)) as pool:
        for _ in pool.map(one, jobs):
            pass

    data = {"path": str(root), "train": "images/train", "val": "images/val",
            "nc": len(VISDRONE_CLASSES), "names": VISDRONE_CLASSES}
    with open(root / "visdrone_analog.yaml", "w") as f:
        yaml.safe_dump(data, f)
    return root / "visdrone_analog.yaml"
