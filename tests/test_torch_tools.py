"""The port's inference tools (dmayolo_tpu_torch/cli/{detect,export,backends,
wbf}.py, core/wbf.py, eval/second_stage.py, hub.py, serve/restapi.py,
serve/example_request.py, graph/model.py::apply_with_features,
utils/plots.py) against the JAX package's, on the CPU.

One tiny flagship-shaped model (width 0.125, nc 10, numpy-drawn weights
with wide biases, so scores rarely tie) is saved once as a JAX `.npz`;
both packages load it.  Four JPEG images (written by the port's libjpeg
route, read by both packages to the same pixels) at 128 px.

- WBF: fused boxes, scores and labels within 1e-6 of JAX's on random
  sets, and the `wbf` CLI's files equal to JAX's.
- second stage: `expand_boxes`, `save_one_box` and `apply_classifier`
  (a colour classifier, far from its ties) equal to JAX's.
- `Detections` (`pandas`, `records`, the box views, `crop`) and
  `AutoShape` at f32: JAX's frames and detection sets (boxes within
  1e-3 px, scores within 1e-4).
- `cli.detect` at --fp32: the same `labels/*.txt` line sets as JAX's
  (class equal, normalised xywh and conf within 1e-3), with and without
  `--augment --classes`; at 128 px the 1,008 candidates take the blocked
  "matrix" NMS at max_det 1000.
- `cli.export` -> `cli/backends.py` -> `cli.detect` on the `.pt2` equal to
  the native run; the `.pt` export read by JAX's `utils/torch_import.py`
  as JAX's own weights; the fused `.npz` loaded by both packages.
- `serve.restapi` over localhost in a thread: each batched answer equal
  to `MicroBatcher` on the same image, the per-request records' keys and
  values equal to JAX's `pandas().xyxy[0].to_dict(orient="records")`; a
  webp upload answered with JAX's detections of PIL's decode.
- `apply_with_features` equal to JAX's; `feature_visualization` writes
  its PNG, or raises naming matplotlib where it is missing.
- video, webcam, URL and stream sources reach the runner JAX's CLI
  dispatches them to (tests/test_torch_video.py holds the runners).
- what the port does not have raises, naming it:
  `stablehlo`/`tf`/`saved_model`/`tflite`/`onnx`, `--int8`, PIL images.
"""
import builtins
import contextlib
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import dmayolo_tpu.cli.detect as jdetect
import dmayolo_tpu.cli.wbf as jwbf_cli
import dmayolo_tpu.core.wbf as jwbf
import dmayolo_tpu.eval.second_stage as jss
import dmayolo_tpu.hub as jhub
from dmayolo_tpu.cli.common import load_model_from_checkpoint as jax_load
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.nn.fuse import fuse_params
from dmayolo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dmayolo_tpu.utils.torch_import import import_torch_state as jax_import_torch_state
from dmayolo_tpu_torch import hub as phub
from dmayolo_tpu_torch.cli import backends as pbackends
from dmayolo_tpu_torch.cli import detect as pdetect
from dmayolo_tpu_torch.cli import export as pexport
from dmayolo_tpu_torch.cli import wbf as pwbf_cli
from dmayolo_tpu_torch.cli.common import load_model_from_checkpoint
from dmayolo_tpu_torch.core import wbf as pwbf
from dmayolo_tpu_torch.data.imageio import imread, imwrite
from dmayolo_tpu_torch.eval import second_stage as pss
from dmayolo_tpu_torch.serve import example_request, restapi
from dmayolo_tpu_torch.serve.batcher import MicroBatcher
from dmayolo_tpu_torch.utils import plots

from test_torch_model import random_vars, small_cfg

IMG = 128
SIZES = [(200, 320), (256, 192), (150, 150), (96, 240)]
BOX_TOL = 1e-3  # normalised xywh and conf of the txt rows at f32
PX_TOL = 1e-3   # boxes in pixels (AutoShape, batcher)
SCORE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny model's JAX checkpoint and four JPEG images."""
    root = tmp_path_factory.mktemp("tools")
    cfg = small_cfg()
    jm = JaxModel(cfg)
    params, stats = random_vars(jm, seed=3)
    ckpt = root / "w.npz"
    jax_save_checkpoint(ckpt, params=params, stats=stats, meta={"cfg": cfg, "nc": cfg["nc"]})
    src = root / "imgs"
    src.mkdir()
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(SIZES):
        img = (rng.uniform(0, 1, (h // 8, w // 8, 3)) * 255).astype(np.uint8)
        img = np.kron(img, np.ones((8, 8, 1), np.uint8))  # blocks: JPEG keeps them
        imwrite(src / f"{i}.jpg", img)
    return {"root": root, "ckpt": ckpt, "src": src, "cfg": cfg, "jm": jm,
            "params": params, "stats": stats}


def read_labels(d: Path):
    out = {}
    for p in sorted(d.glob("*.txt")):
        rows = np.array([ln.split() for ln in p.read_text().split("\n") if ln], np.float64)
        out[p.stem] = rows.reshape(-1, 6) if rows.size else np.zeros((0, 6))
    return out


def matched(a: np.ndarray, b: np.ndarray, tol: np.ndarray, cls_col: int) -> bool:
    """Row sets equal: every row of `a` pairs with its own row of `b` of
    the same class whose other columns are within `tol` (per column)."""
    if a.shape != b.shape:
        return False
    free = np.ones(len(b), bool)
    for row in a:
        ok = free & (b[:, cls_col] == row[cls_col]) & (np.abs(b - row) <= tol).all(1)
        if not ok.any():
            return False
        free[np.argmax(ok)] = False
    return True


def assert_same_labels(got: dict, want: dict, tol=BOX_TOL):
    """txt rows: class, normalised xywh, conf."""
    assert got.keys() == want.keys()
    assert any(len(v) for v in want.values()), "no detections: the comparison is vacuous"
    for k in want:
        assert matched(got[k], want[k], np.full(6, tol), 0), k


def assert_same_dets(got, want):
    """(n, 6) xyxy pixels, conf, cls."""
    g, w = (np.asarray(d, np.float64).reshape(-1, 6) for d in (got, want))
    assert matched(g, w, np.array([PX_TOL] * 4 + [SCORE_TOL, 0]), 5)


# --------------------------------------------------------------------- WBF
def random_sets(rng, n_models):
    sets = []
    for _ in range(n_models):
        n = int(rng.integers(0, 30))
        xy = rng.uniform(-0.05, 0.9, (n, 2))
        wh = rng.uniform(0.0, 0.3, (n, 2))
        sets.append((np.concatenate([xy, xy + wh], 1), rng.uniform(0, 1, n),
                     rng.integers(0, 3, n).astype(float)))
    return sets


@pytest.mark.parametrize("kw", [dict(), dict(conf_type="max"), dict(allows_overflow=True),
                                dict(weights=[2.0, 1.0, 0.5], skip_box_thr=0.2, iou_thr=0.4),
                                dict(weights=[1.0])])
def test_wbf_matches_jax(kw):
    rng = np.random.default_rng(len(str(kw)))
    for _ in range(10):
        boxes, scores, labels = zip(*random_sets(rng, 3))
        with pytest.warns(UserWarning) if kw.get("weights") == [1.0] else contextlib.nullcontext():
            got = pwbf.weighted_boxes_fusion(boxes, scores, labels, **kw)
        with pytest.warns(UserWarning) if kw.get("weights") == [1.0] else contextlib.nullcontext():
            want = jwbf.weighted_boxes_fusion(boxes, scores, labels, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def test_wbf_cli_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    dirs = []
    for m in range(2):
        d = tmp_path / f"run{m}"
        d.mkdir()
        for stem in ("a", "b", "c"):
            n = int(rng.integers(0, 6)) if stem != "c" or m == 0 else 0
            rows = [f"{int(rng.integers(0, 3))} {rng.uniform(0.2, 0.8):.6f} "
                    f"{rng.uniform(0.2, 0.8):.6f} {rng.uniform(0.05, 0.3):.6f} "
                    f"{rng.uniform(0.05, 0.3):.6f} {rng.uniform(0, 1):.6f}" for _ in range(n)]
            (d / f"{stem}.txt").write_text("\n".join(rows) + ("\n" if rows else ""))
        dirs.append(str(d))
    for extra in ([], ["--no-one-indexed-cls", "--conf-type", "max", "--weights", "2", "1"]):
        jwbf_cli.main([*dirs, "--out", str(tmp_path / "jax"), *extra])
        pwbf_cli.main([*dirs, "--out", str(tmp_path / "port"), *extra])
        for p in sorted((tmp_path / "jax").glob("*.txt")):
            assert (tmp_path / "port" / p.name).read_text() == p.read_text(), p.name


# ------------------------------------------------------------ second stage
def test_expand_boxes_and_save_one_box(tmp_path):
    rng = np.random.default_rng(1)
    im = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    for _ in range(20):
        x1, y1 = rng.uniform(-20, 150, 2)
        box = (x1, y1, x1 + rng.uniform(1, 60), y1 + rng.uniform(1, 60))
        for kw in (dict(), dict(gain=1.3, pad=30.0, square=True)):
            np.testing.assert_array_equal(pss.expand_boxes(box, **kw),
                                          jss.expand_boxes(box, **kw))
        for bgr in (False, True):
            f = tmp_path / "crop.jpg"
            got = pss.save_one_box(box, im, file=f, BGR=bgr)
            want = jss.save_one_box(box, im, BGR=bgr, save=False)
            np.testing.assert_array_equal(got, want)
            if got.size:
                assert imread(f).shape == got.shape


def colour_classifier(x):
    """Logits = mean of each channel a crop (3 classes), far from ties."""
    return x.mean(axis=(1, 2))


def test_apply_classifier_matches_jax():
    rng = np.random.default_rng(2)
    ims, dets = [], []
    for i in range(3):
        im = np.zeros((200, 300, 3), np.uint8)
        d = []
        for c in range(3):  # a pure-colour patch a class: BGR channel 2 - c is RGB c
            x0, y0 = 20 + 90 * c, 40 + 20 * i
            im[y0:y0 + 60, x0:x0 + 60, 2 - c] = 250
            lb = rng.integers(0, 3)  # the detector's class: agrees about a third
            d.append([x0 + 20, y0 + 20, x0 + 40, y0 + 40, 0.9, lb])
        ims.append(im)
        dets.append(np.array(d, np.float32))
    dets.append(np.zeros((0, 6), np.float32))
    ims.append(ims[0])
    got = pss.apply_classifier(dets, colour_classifier, (200, 300), ims)
    want = jss.apply_classifier(dets, colour_classifier, (200, 300), ims)
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def classifier(setup):
    """A tiny checkpoint ending in a Classify head (nc 10), JAX-initialised."""
    cfg = {"nc": 10, "depth_multiple": 1.0, "width_multiple": 1.0,
           "anchors": [[10, 13, 16, 30, 33, 23]],
           "backbone": [[-1, 1, "Conv", [16, 3, 2]]],
           "head": [[-1, 1, "Classify", ["nc"]]]}
    jm = JaxModel(cfg)
    params, stats = random_vars(jm, seed=8)
    path = setup["root"] / "cls.npz"
    jax_save_checkpoint(path, params=params, stats=stats, meta={"cfg": cfg, "nc": 10})
    return path


def test_load_second_stage_matches_jax(classifier):
    x = np.random.default_rng(6).uniform(0, 1, (5, 224, 224, 3)).astype(np.float32)
    got = pss.load_second_stage(str(classifier), device="cpu")(x)
    want = jss.load_second_stage(str(classifier))(x)
    assert got.shape == want.shape == (5, 10) and got.dtype == np.float32
    # both run the classifier in bf16: its rounding, not the port, bounds this
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def test_detect_classify_keeps_a_subset(setup, classifier, detect_runs):
    # max_det 50: the first 50 keepers of the same greedy NMS, each crop
    # through the classifier
    out = pdetect.main(detect_argv(setup, "port_classify", "--classify", str(classifier),
                                   "--max-det", "50", "--device", "cpu"))
    got, plain = read_labels(out / "labels"), read_labels(detect_runs["plain"][0] / "labels")
    assert got.keys() == plain.keys()
    for k in plain:  # every kept row is one of the unfiltered run's
        assert all((np.abs(plain[k] - r) <= BOX_TOL).all(1).any() for r in got[k])
    assert sum(len(v) for v in got.values()) < sum(len(v) for v in plain.values())


# -------------------------------------------------------------- Detections
def test_detections_views_pandas_crop(tmp_path):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 255, (90, 140, 3), dtype=np.uint8) for _ in range(2)]
    dets = []
    for _ in range(2):
        xy = rng.uniform(0, 100, (4, 2))
        dets.append(np.concatenate([xy, xy + rng.uniform(5, 40, (4, 2)),
                                    rng.uniform(0.3, 1, (4, 1)),
                                    rng.integers(0, 3, (4, 1))], 1).astype(np.float32))
    names = ["car", "van", "bus"]
    got = phub.Detections(imgs, dets, ["a.jpg", "b.jpg"], names)
    want = jhub.Detections(imgs, dets, ["a.jpg", "b.jpg"], names)
    for k in ("xyxy", "xywh", "xyxyn", "xywhn"):
        for g, w in zip(getattr(got, k), getattr(want, k)):
            np.testing.assert_array_equal(g, w)
    gp, wp = got.pandas(), want.pandas()
    for k in ("xyxy", "xyxyn", "xywh", "xywhn"):
        for g, w in zip(getattr(gp, k), getattr(wp, k)):
            pd.testing.assert_frame_equal(g, w)
    for i in range(2):
        assert got.records(i) == wp.xyxy[i].to_dict(orient="records")
    gc = got.crop(save_dir=tmp_path / "port")
    wc = want.crop()
    assert len(gc) == len(wc) == 8
    for g, w in zip(gc, wc):
        np.testing.assert_array_equal(g["im"], w["im"])
        assert (g["cls"], g["label"]) == (w["cls"], w["label"])
    assert len(list((tmp_path / "port").rglob("*.jpg"))) == 8
    assert [len(t) for t in got.tolist()] == [1, 1]
    assert got.save(tmp_path / "saved") and len(list((tmp_path / "saved").glob("*.jpg"))) == 2
    rendered = got.render()
    assert all(r.shape == im.shape and not np.array_equal(r, im) for r, im in zip(rendered, imgs))


def test_autoshape_matches_jax(setup):
    jm, params, stats = jax_load(str(setup["ckpt"]))
    fp, fs = fuse_params(jm, params, stats)
    want_fn = jhub.AutoShape(jm, fp, fs, dtype=jnp.float32)
    model = load_model_from_checkpoint(setup["ckpt"], device="cpu").fuse()
    got_fn = phub.AutoShape(model, dtype=torch.float32)
    rng = np.random.default_rng(9)
    items = [str(setup["src"] / "0.jpg"), rng.integers(0, 255, (100, 180, 3), dtype=np.uint8),
             rng.integers(0, 255, (3, 90, 70), dtype=np.uint8)]  # a CHW array
    # JAX reads paths with cv2: the same pixels as the port's libjpeg route
    got, want = got_fn(items, size=IMG), want_fn(items, size=IMG)
    assert got.files == want.files
    assert sum(len(d) for d in want.xyxy) > 0
    for g, w in zip(got.xyxy, want.xyxy):
        assert_same_dets(g, w)


def test_hub_load_and_ensemble(setup):
    one = phub.load(str(setup["ckpt"]), device="cpu")
    assert isinstance(one, phub.AutoShape) and one.model.fused
    ens = phub.load([str(setup["ckpt"])] * 2, device="cpu")
    assert isinstance(ens, phub.AutoShapeEnsemble)
    ens.conf = 0.5
    img = np.random.default_rng(3).integers(0, 255, (128, 128, 3), dtype=np.uint8)
    jm, params, stats = jax_load(str(setup["ckpt"]))
    fp, fs = fuse_params(jm, params, stats)
    jens = jhub.AutoShapeEnsemble([(jm, fp, fs), (jm, fp, fs)], dtype=jnp.float32)
    jens.conf = 0.5
    ens.dtype = torch.float32
    assert_same_dets(ens(img, size=IMG).xyxy[0], jens(img, size=IMG).xyxy[0])


# ------------------------------------------------------------------ detect
def detect_argv(setup, name, *extra):
    return ["--weights", str(setup["ckpt"]), "--source", str(setup["src"]),
            "--imgsz", str(IMG), "--fp32", "--save-txt", "--save-conf", "--batch-size", "3",
            "--project", str(setup["root"] / "runs"), "--name", name, "--exist-ok", *extra]


@pytest.fixture(scope="module")
def detect_runs(setup):
    """JAX's and the port's detect runs: plain (with --save-crop), and
    --augment --classes."""
    runs = {}
    for tag, extra in (("plain", ["--save-crop"]), ("augment", ["--augment", "--classes", "1",
                                                                "3", "5", "7"])):
        jout = jdetect.main(detect_argv(setup, f"jax_{tag}", *extra) + ["--device", "cpu"])
        pout = pdetect.main(detect_argv(setup, f"port_{tag}", *extra) + ["--device", "cpu"])
        runs[tag] = (pout, jout)
    return runs


def test_detect_matches_jax(detect_runs):
    pout, jout = detect_runs["plain"]
    assert_same_labels(read_labels(pout / "labels"), read_labels(jout / "labels"))
    # annotated images under the sources' names, crops by class
    assert sorted(p.name for p in pout.glob("*.jpg")) == sorted(p.name for p in jout.glob("*.jpg"))
    # crops by class dir (their file names count detections in NMS order,
    # which ties may permute)
    pc, jc = ({d.name: len(list(d.glob("*.jpg"))) for d in (o / "crops").iterdir()}
              for o in (pout, jout))
    assert pc == jc and pc


def test_detect_augment_classes_matches_jax(detect_runs):
    pout, jout = detect_runs["augment"]
    got, want = read_labels(pout / "labels"), read_labels(jout / "labels")
    assert_same_labels(got, want)
    assert {int(c) for v in got.values() for c in v[:, 0]} <= {1, 3, 5, 7}


def test_export_backend_detect_equals_native(setup, detect_runs):
    root = setup["root"]
    w = root / "exp" / "w.npz"
    w.parent.mkdir(exist_ok=True)
    w.write_bytes(setup["ckpt"].read_bytes())
    outs = pexport.main(["--weights", str(w), "--imgsz", str(IMG), "--batch-size", "2",
                         "--include", "torch_export", "npz", "torch", "--fp32",
                         "--device", "cpu"])
    assert [o.name for o in outs] == ["w_fused.npz", "w.pt", "w.pt2"]
    assert pbackends.detect_backend(str(outs[2])) == "torch_export"
    meta = yaml.safe_load((outs[2].parent / "w.pt2.meta.yaml").read_text())
    assert meta["platforms"] == ["cpu"] and meta["batch_size"] == 2
    # 4 images through a batch-2 program: the chunk path; 3 would pad
    runs = {}
    for name, weights, bs in (("pt2", outs[2], "3"), ("fused", outs[0], "3")):
        argv = detect_argv(setup, f"port_{name}", "--device", "cpu")
        argv[1], argv[argv.index("--batch-size") + 1] = str(weights), bs
        runs[name] = read_labels(pdetect.main(argv) / "labels")
    native = read_labels(detect_runs["plain"][0] / "labels")
    assert_same_labels(runs["pt2"], native, tol=1e-5)
    assert_same_labels(runs["fused"], native, tol=1e-5)


def test_export_pt_read_by_jax(setup):
    """The `.pt` export holds JAX's own weights under the reference's keys:
    JAX's torch_import reads them back to its params and stats."""
    w = setup["root"] / "pt" / "w.npz"
    w.parent.mkdir(exist_ok=True)
    w.write_bytes(setup["ckpt"].read_bytes())
    (pt,) = pexport.main(["--weights", str(w), "--include", "torch", "--device", "cpu"])
    sd = torch.load(pt, map_location="cpu")
    jm = JaxModel(setup["cfg"])
    params, stats, report = jax_import_torch_state(jm, sd)
    assert not report.get("missing") and not report.get("unused")
    for tree, ref in ((params, setup["params"]), (stats, setup["stats"])):
        assert tree.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(np.asarray(tree[k]), np.asarray(ref[k]), err_msg=str(k))
    # and the port reads it back with the yaml beside it: the npz's model
    cfg = setup["root"] / "pt" / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(setup["cfg"]))
    got = load_model_from_checkpoint(pt, cfg=str(cfg), device="cpu").state_dict()
    want = load_model_from_checkpoint(setup["ckpt"], device="cpu").state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_fused_npz_loads_in_both(setup):
    w = setup["root"] / "fz" / "w.npz"
    w.parent.mkdir(exist_ok=True)
    w.write_bytes(setup["ckpt"].read_bytes())
    (fz,) = pexport.main(["--weights", str(w), "--include", "npz", "--device", "cpu"])
    x = np.random.default_rng(0).uniform(0, 1, (1, IMG, IMG, 3)).astype(np.float32)
    jm, params, stats = jax_load(str(fz))
    fp, fs = fuse_params(jm, params, stats)  # idempotent on a fused export
    want = jm.apply(fp, fs, jnp.asarray(x), fused=True)
    model = load_model_from_checkpoint(fz, device="cpu")
    assert model.fused
    with torch.no_grad():
        got = model.apply(torch.as_tensor(x), fused=True)
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- REST API
def test_restapi_matches_batcher_and_jax_records(setup):
    model = load_model_from_checkpoint(setup["ckpt"], device="cpu")
    batcher = MicroBatcher(model, imgsz=IMG, max_batch=4, max_wait_ms=20, max_det=1000,
                           max_nms=4096, dtype=torch.float32, device="cpu",
                           names=[f"c{i}" for i in range(10)])
    servers = [restapi.make_server("127.0.0.1", 0, batcher=batcher, imgsz=IMG),
               restapi.make_server("127.0.0.1", 0, model=phub.AutoShape(
                   load_model_from_checkpoint(setup["ckpt"], device="cpu").fuse(),
                   dtype=torch.float32), imgsz=IMG)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        urls = [f"http://127.0.0.1:{s.server_address[1]}/v1/object-detection" for s in servers]
        files = sorted(setup["src"].glob("*.jpg"))
        answers = [None] * len(files)

        def post(i):
            answers[i] = example_request.detect(str(files[i]), urls[0])

        posts = [threading.Thread(target=post, args=(i,)) for i in range(len(files))]
        for t in posts:
            t.start()
        for t in posts:
            t.join(60)
        assert not any(t.is_alive() for t in posts)
        keys = ("xmin", "ymin", "xmax", "ymax", "confidence", "class")
        for f, got in zip(files, answers):
            # alone, the image rides a batch of 1: f32 sums in another order
            want = restapi.batch_records(batcher(imread(f)[:, :, ::-1].copy(), timeout=60),
                                         batcher.names)
            assert [r.keys() for r in got] == [r.keys() for r in want]
            assert all(r["name"] == f"c{r['class']}" for r in got)
            assert_same_dets([[r[k] for k in keys] for r in got],
                             [[r[k] for k in keys] for r in want])
        assert any(answers)
        # the per-request path: JAX's AutoShape records for the same image
        got = example_request.detect(str(files[0]), urls[1])
        jm, params, stats = jax_load(str(setup["ckpt"]))
        fp, fs = fuse_params(jm, params, stats)
        want = jhub.AutoShape(jm, fp, fs, dtype=jnp.float32)(
            imread(files[0])[:, :, ::-1].copy(), size=IMG).pandas().xyxy[0].to_dict(
            orient="records")
        assert got and [r.keys() for r in got] == [r.keys() for r in want]
        assert_same_dets([[r[k] for k in keys] for r in got], [[r[k] for k in keys] for r in want])
        # an undecodable upload is a 400
        import urllib.error
        import urllib.request

        bad = urllib.request.Request(urls[0], data=b"not an image",
                                     headers={"Content-Type": "application/octet-stream"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        batcher.close()
    assert batcher.names[3] == "c3"


def test_restapi_webp_upload_as_jax(setup, tmp_path):
    """A lossy webp upload is answered with JAX's detections: its REST
    server's PIL decode through its AutoShape, per request."""
    from PIL import Image

    src = sorted(setup["src"].glob("*.jpg"))[1]
    webp = tmp_path / "a.webp"
    webp.write_bytes(cv2_webp(imread(src), 80))
    server = restapi.make_server("127.0.0.1", 0, model=phub.AutoShape(
        load_model_from_checkpoint(setup["ckpt"], device="cpu").fuse(), dtype=torch.float32),
        imgsz=IMG)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        got = example_request.detect(
            str(webp), f"http://127.0.0.1:{server.server_address[1]}/v1/object-detection")
    finally:
        server.shutdown()
        server.server_close()
    jm, params, stats = jax_load(str(setup["ckpt"]))
    fp, fs = fuse_params(jm, params, stats)
    rgb = np.asarray(Image.open(webp).convert("RGB"))
    want = jhub.AutoShape(jm, fp, fs, dtype=jnp.float32)(rgb, size=IMG).pandas().xyxy[0].to_dict(
        orient="records")
    keys = ("xmin", "ymin", "xmax", "ymax", "confidence", "class")
    assert got and [r.keys() for r in got] == [r.keys() for r in want]
    assert_same_dets([[r[k] for k in keys] for r in got], [[r[k] for k in keys] for r in want])


def cv2_webp(img, quality):
    import cv2

    ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return buf.tobytes()


# ---------------------------------------------------------- visualisation
def test_apply_with_features_matches_jax(setup, tmp_path):
    x = np.random.default_rng(1).uniform(0, 1, (1, IMG, IMG, 3)).astype(np.float32)
    jm, params, stats = setup["jm"], setup["params"], setup["stats"]
    want = jm.apply_with_features(params, stats, jnp.asarray(x))
    model = load_model_from_checkpoint(setup["ckpt"], device="cpu")
    with torch.no_grad():
        got = model.apply_with_features(torch.as_tensor(x))
    assert [(i, n) for i, n, _ in got] == [(i, n) for i, n, _ in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        if torch.is_tensor(g):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    pytest.importorskip("matplotlib")
    f = plots.feature_visualization(got[0][2].numpy(), got[0][1], 0, n=4, save_dir=tmp_path)
    assert f.exists() and f.name == "stage0_Conv_features.png"


def test_visualize_without_matplotlib_names_it(monkeypatch, tmp_path):
    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(RuntimeError, match="need matplotlib, which is not installed"):
        plots.feature_visualization(np.zeros((1, 4, 4, 2), np.float32), "Conv", 0,
                                    save_dir=tmp_path)


# ------------------------------------------------- video and stream sources
@pytest.mark.parametrize("source", ["clip.mp4", "0", "rtsp://cam/1", "a.jpg,b.jpg",
                                    "list.streams"])
def test_video_and_streams_raise(setup, monkeypatch, tmp_path, source):
    """Each video, webcam, URL or stream source reaches the runner that
    JAX's CLI dispatches it to (`_run_video` or `_run_streams`), with the
    same source; no capture is opened here."""
    reached = {}
    for tag, cli in (("jax", jdetect), ("port", pdetect)):
        for runner in ("_run_video", "_run_streams"):
            monkeypatch.setattr(cli, runner, lambda opt, *a, _r=runner, _t=tag, **k:
                                reached.setdefault(_t, (_r, opt.source)))
        cli.main(["--weights", str(setup["ckpt"]), "--source", source, "--device", "cpu",
                  "--project", str(tmp_path), "--name", tag])
    assert reached["port"] == reached["jax"]
    assert reached["jax"] == ("_run_streams" if source in ("a.jpg,b.jpg", "list.streams")
                              else "_run_video", source)


# ------------------------------------------------------ what is not ported


@pytest.mark.parametrize("fmt", ["stablehlo", "tf", "saved_model", "tflite", "onnx"])
def test_unported_export_formats_raise(setup, fmt):
    with pytest.raises(NotImplementedError, match=fmt):
        pexport.main(["--weights", str(setup["ckpt"]), "--include", fmt, "--device", "cpu"])


@pytest.mark.parametrize("name", ["w.stablehlo", "w.tflite", "w.onnx"])
def test_unported_backends_raise(tmp_path, name):
    backend = pbackends.detect_backend(str(tmp_path / name))
    with pytest.raises(NotImplementedError, match=backend.split("_")[0]):
        pbackends.load_backend(str(tmp_path / name), backend, device="cpu")


def test_int8_export_raises(setup):
    with pytest.raises(NotImplementedError, match="writes no TFLite"):
        pexport.main(["--weights", str(setup["ckpt"]), "--int8", "--device", "cpu"])


def test_pil_input_raises():
    class FakePIL:
        def convert(self, mode):
            return self

    with pytest.raises(TypeError, match="PIL"):
        phub.AutoShape._to_rgb_array(FakePIL())
