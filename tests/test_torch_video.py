"""Video files, webcams and streams in the port's `cli.detect`
(dmayolo_tpu_torch/cli/detect.py `_run_video`, `_run_streams`;
data/video.py) against the JAX CLI's, on the CPU.

The tiny model of tests/test_e2e_train.py (TINY_CFG) with
tests/test_torch_model.py's numpy-drawn weights (wide biases, so that
scores rarely tie; `init_with_priors` scores every box ~1.1e-3), saved
once as a JAX `.npz`; seeded `mp4v` clips written by cv2 here.  No
test opens a network URL or a camera: those cases record what reaches
`cv2.VideoCapture`, which here opens nothing.

- `_run_video` at --fp32 with --classify (a deterministic colour
  classifier in both packages, so that its decisions are the port's
  plumbing and not bf16 rounding): the letterboxed model inputs equal
  JAX's to the last bit, each frame's detections (before and after the
  second stage) within tests/test_torch_tools.py's PX_TOL and SCORE_TOL,
  `{stem}_det.mp4` reads back with the input's frame count, and the
  summary line has JAX's form.
- With --hide-labels the frames handed to the writer equal JAX's pixel
  for pixel (boxes drawn by `cvops.rectangle`, pixel-equal to cv2's).
- `_run_streams` over two clips whose reads are paced against the served
  steps (at most AHEAD frames ahead, as a live camera is), with
  `max_stream_steps`: the same summary and `step 10` lines as JAX's, each
  batch's rows the letterbox of a decoded frame of their own source,
  and batches of the same frames served to the same detections; then
  through a `.pt2` program of batch 1, which the CLI chunks.
- --update after a video run strips the checkpoint as JAX's does.
- "0" and "rtsp://..." reach the capture as JAX's do (an int, the URL)
  and raise JAX's "cannot open ...".
- A streams reader still blocked in a read when the loop ends keeps its
  capture; one that has ended has its capture released.
"""
import contextlib
import io
import re
import threading

import cv2
import jax
import numpy as np
import pytest
import torch

import dmayolo_tpu.cli.detect as jdetect
import dmayolo_tpu.eval.second_stage as jss
from dmayolo_tpu.data.augment import letterbox as jax_letterbox
from dmayolo_tpu.graph import DetectionModel as JaxModel
from dmayolo_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from dmayolo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dmayolo_tpu_torch.cli import backends as pbackends
from dmayolo_tpu_torch.cli import detect as pdetect
from dmayolo_tpu_torch.cli import export as pexport
from dmayolo_tpu_torch.data import video
from dmayolo_tpu_torch.eval import second_stage as pss

from test_e2e_train import TINY_CFG
from test_torch_model import random_vars
from test_torch_tools import PX_TOL, SCORE_TOL, matched

IMG = 128
FRAMES = 6
SIZE = (160, 120)  # clip width, height
STREAM_FRAMES = 40
STREAM_STEPS = 12  # past the CLI's "step 10" line
AHEAD = 2  # frames a paced reader may run ahead of the served steps
CONF = "0.25"  # the CLI's default


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_clip(path, n_frames=FRAMES, seed=0):
    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, SIZE)
    assert vw.isOpened()
    for _ in range(n_frames):
        # blocks of 8 px: mp4v keeps them, and the frames stay far apart
        f = rng.integers(0, 256, (SIZE[1] // 8, SIZE[0] // 8, 3), dtype=np.uint8)
        vw.write(np.kron(f, np.ones((8, 8, 1), np.uint8)))
    vw.release()
    return path


def decoded(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    jm = JaxModel(TINY_CFG)
    params, stats = random_vars(jm, seed=3)
    ckpt = root / "w.npz"
    jax_save_checkpoint(ckpt, params=params, stats=stats,
                        meta={"cfg": TINY_CFG, "nc": TINY_CFG["nc"]})
    return {"root": root, "ckpt": ckpt, "clip": write_clip(root / "clip.mp4")}


def argv(setup, name, source, *extra):
    return ["--weights", str(setup["ckpt"]), "--source", str(source), "--imgsz", str(IMG),
            "--conf-thres", CONF, "--fp32", "--project", str(setup["root"] / "runs"),
            "--name", name, "--exist-ok", "--device", "cpu", *extra]


def colour_classifier(x):
    """Logits = mean of each channel of a crop (3 classes), far from ties."""
    return np.asarray(x, np.float32).mean(axis=(1, 2))


def to_numpy(a):
    return a.float().cpu().numpy() if torch.is_tensor(a) and a.is_floating_point() else (
        a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a))


class Recorder:
    """Wraps a CLI module's runner so that its `infer` records each call's
    input and output (as numpy), and `apply_classifier` its outputs."""

    def __init__(self, monkeypatch, cli, runner, second_stage):
        self.inputs, self.outputs, self.classified = [], [], []
        real_run, real_cls = getattr(cli, runner), second_stage.apply_classifier

        def run(opt, infer, *a, **k):
            def rec(x):
                dets, valid = infer(x)
                self.inputs.append(np.array(x))
                self.outputs.append((to_numpy(dets).astype(np.float32), to_numpy(valid)))
                return dets, valid
            return real_run(opt, rec, *a, **k)

        def classify(*a, **k):
            out = real_cls(*a, **k)
            self.classified.append([np.array(d) for d in out])
            return out

        monkeypatch.setattr(cli, runner, run)
        monkeypatch.setattr(second_stage, "apply_classifier", classify)
        monkeypatch.setattr(second_stage, "load_second_stage", lambda *a, **k: colour_classifier)

    def rows(self, i, j):
        dets, valid = self.outputs[i]
        return dets[j][valid[j]]


def same_dets(a, b):
    return matched(np.asarray(a, np.float64).reshape(-1, 6), np.asarray(b, np.float64)
                   .reshape(-1, 6), np.array([PX_TOL] * 4 + [SCORE_TOL, 0]), 5)


@pytest.fixture(scope="module")
def video_runs(setup):
    """JAX's and the port's `_run_video` on the clip with --classify."""
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        for tag, cli, ss in (("jax", jdetect, jss), ("port", pdetect, pss)):
            rec = Recorder(mp, cli, "_run_video", ss)
            with _capture_stdout() as lines:
                out = cli.main(argv(setup, f"{tag}_video", setup["clip"], "--classify",
                                    str(setup["ckpt"])))
            runs[tag] = {"out": out, "rec": rec, "lines": lines}
            mp.undo()
    finally:
        mp.undo()
    return runs


@contextlib.contextmanager
def _capture_stdout():
    """The lines printed inside the block (pytest's capsys is per test)."""
    buf, lines = io.StringIO(), []
    with contextlib.redirect_stdout(buf):
        yield lines
    lines.extend(buf.getvalue().splitlines())


def test_video_inputs_equal_jax(setup, video_runs):
    j, p = video_runs["jax"]["rec"], video_runs["port"]["rec"]
    assert len(j.inputs) == len(p.inputs) == FRAMES
    for a, b in zip(p.inputs, j.inputs):
        assert a.shape == b.shape == (1, IMG, IMG, 3) and a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    # the letterbox of each decoded frame, BGR -> RGB
    for x, f in zip(p.inputs, decoded(setup["clip"])):
        np.testing.assert_array_equal(x[0], jax_letterbox(f, IMG, auto=False)[0][:, :, ::-1])


def test_video_detections_equal_jax(video_runs):
    j, p = video_runs["jax"]["rec"], video_runs["port"]["rec"]
    assert sum(len(j.rows(i, 0)) for i in range(FRAMES)) > 0, "vacuous: no detections"
    for i in range(FRAMES):
        assert same_dets(p.rows(i, 0), j.rows(i, 0)), i
    # the second stage: a subset kept, the same one
    assert len(p.classified) == len(j.classified) == FRAMES
    kept = sum(len(c[0]) for c in j.classified)
    assert 0 < kept < sum(len(j.rows(i, 0)) for i in range(FRAMES))
    for a, b in zip(p.classified, j.classified):
        assert same_dets(a[0], b[0])


def test_video_output_and_summary(setup, video_runs):
    for tag in ("jax", "port"):
        out = video_runs[tag]["out"]
        assert (out / "clip_det.mp4").exists()
        assert video.count_frames(out / "clip_det.mp4") == FRAMES
    pat = r"video: (\d+) frames in [\d.]+s \([\d.]+ FPS\) -> (.*)"
    for tag in ("jax", "port"):
        (m,) = [re.fullmatch(pat, ln) for ln in video_runs[tag]["lines"]
                if ln.startswith("video:")]
        assert m and int(m.group(1)) == FRAMES and m.group(2) == str(video_runs[tag]["out"])


def test_video_hide_labels_frames_equal_jax(setup, monkeypatch):
    """The frames handed to the writer, JAX's and the port's, are the
    same pixels (boxes only: the port's labels are a bitmap font)."""
    real = cv2.VideoWriter
    written = {}

    class RecWriter:
        def __init__(self, path, *a):
            self.frames = written.setdefault(path, [])
            self.w = real(path, *a)

        def isOpened(self):
            return self.w.isOpened()

        def write(self, f):
            self.frames.append(f.copy())
            self.w.write(f)

        def release(self):
            self.w.release()

    monkeypatch.setattr(cv2, "VideoWriter", RecWriter)
    outs = {}
    for tag, cli in (("jax", jdetect), ("port", pdetect)):
        outs[tag] = cli.main(argv(setup, f"{tag}_hide", setup["clip"], "--hide-labels",
                                  "--max-det", "20", "--line-thickness", "1"))
    jf, pf = (written[str(outs[t] / "clip_det.mp4")] for t in ("jax", "port"))
    src = decoded(setup["clip"])
    assert len(jf) == len(pf) == FRAMES
    assert any((f != s).any() for f, s in zip(pf, src)), "vacuous: nothing drawn"
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(a, b)
    assert video.count_frames(outs["port"] / "clip_det.mp4") == FRAMES


# ----------------------------------------------------------------- streams
class Paced:
    """Steps served so far, and a cv2.VideoCapture stand-in whose reads
    wait until they are at most AHEAD frames ahead of them (a reader that
    runs ahead of a slow step sees a timeout and moves on)."""

    def __init__(self, monkeypatch):
        self.steps, self.cond, self.opened = 0, threading.Condition(), []
        real, paced = cv2.VideoCapture, self

        class Capture:
            def __init__(self, src):
                paced.opened.append(src)
                self.cap, self.n = real(src), 0

            def isOpened(self):
                return self.cap.isOpened()

            def get(self, prop):
                return self.cap.get(prop)

            def read(self):
                with paced.cond:
                    paced.cond.wait_for(lambda: self.n <= paced.steps + AHEAD, timeout=2.0)
                self.n += 1
                return self.cap.read()

            def release(self):
                self.cap.release()

        monkeypatch.setattr(cv2, "VideoCapture", Capture)

    def stepped(self):
        with self.cond:
            self.steps += 1
            self.cond.notify_all()


def run_streams(monkeypatch, cli, ss, args):
    paced = Paced(monkeypatch)
    rec = Recorder(monkeypatch, cli, "_run_streams", ss)
    real_run = cli._run_streams

    def run(opt, infer, *a, **k):
        opt.max_stream_steps = STREAM_STEPS

        def stepping(x):
            try:
                return infer(x)
            finally:
                paced.stepped()
        return real_run(opt, stepping, *a, **k)

    monkeypatch.setattr(cli, "_run_streams", run)
    with _capture_stdout() as lines:
        cli.main(args)
    monkeypatch.undo()
    return rec, lines, paced


@pytest.fixture(scope="module")
def streams(setup):
    root = setup["root"]
    clips = [write_clip(root / f"s{i}.mp4", STREAM_FRAMES, seed=10 + i) for i in range(2)]
    src = root / "two.streams"
    src.write_text("".join(f"{c}\n" for c in clips))
    mp = pytest.MonkeyPatch()
    try:
        runs = {tag: run_streams(mp, cli, ss, argv(setup, f"{tag}_streams", src))
                for tag, cli, ss in (("jax", jdetect, jss), ("port", pdetect, pss))}
    finally:
        mp.undo()
    lbs = [[jax_letterbox(f, IMG, auto=False)[0][:, :, ::-1] for f in decoded(c)]
           for c in clips]
    return {"runs": runs, "clips": clips, "src": src, "letterboxed": lbs}


def frame_index(x, lbs):
    (i,) = [k for k, lb in enumerate(lbs) if np.array_equal(lb, x)]
    return i


def test_streams_lines_equal_jax(streams):
    lines = {}
    for tag, (rec, out, paced) in streams["runs"].items():
        assert paced.opened == [str(c) for c in streams["clips"]]
        lines[tag] = [re.sub(r" in [\d.]+s \([\d.]+ FPS aggregate\)", "", ln) for ln in out
                      if ln.startswith(("step ", "streams:"))]
        assert lines[tag][-1] == f"streams: {STREAM_STEPS} batched steps over 2 sources"
        assert len(rec.inputs) == STREAM_STEPS
    # "step 10": each package's counts of its own 10th batch's detections
    for tag, (rec, out, _) in streams["runs"].items():
        want = f"step 10: dets per stream {[len(rec.rows(9, i)) for i in range(2)]}"
        assert lines[tag][0] == want
    assert [ln.split(":")[0] for ln in lines["port"]] == [ln.split(":")[0]
                                                          for ln in lines["jax"]]


def test_streams_batches_are_decoded_frames(streams):
    seen = {}
    for tag, (rec, _, _) in streams["runs"].items():
        for x, (dets, valid) in zip(rec.inputs, rec.outputs):
            assert x.shape == (2, IMG, IMG, 3)
            key = tuple(frame_index(x[i], streams["letterboxed"][i]) for i in range(2))
            seen.setdefault(key, {})[tag] = [dets[i][valid[i]] for i in range(2)]
    both = [v for v in seen.values() if len(v) == 2]
    assert both, "no batch of the same frames in both runs"
    for v in both:  # the same frames: the same detections
        for a, b in zip(v["port"], v["jax"]):
            assert same_dets(a, b)


def test_streams_pt2_batch_1_chunks(setup, streams, monkeypatch):
    """Two live sources through a `.pt2` of batch 1 (JAX's
    tests/test_detect_backends.py on its exported program): each step's
    batch of 2 runs the program twice, and gives the native run's
    detections for the same frames within the program's decode route's
    tolerance (`batched_nms` in place of `nms_parts`)."""
    exp = setup["root"] / "exp"
    exp.mkdir(exist_ok=True)
    w = exp / "w.npz"
    w.write_bytes(setup["ckpt"].read_bytes())
    (pt2,) = pexport.main(["--weights", str(w), "--imgsz", str(IMG), "--batch-size", "1",
                           "--include", "torch_export", "--fp32", "--device", "cpu"])
    batches = []
    real_load = pbackends.load_backend

    def load(*a, **k):
        fn, meta = real_load(*a, **k)

        def counted(x):
            batches.append(x.shape[0])
            return fn(x)
        return counted, meta

    monkeypatch.setattr(pbackends, "load_backend", load)
    args = argv(setup, "port_streams_pt2", streams["src"])
    args[args.index("--weights") + 1] = str(pt2)
    rec, out, _ = run_streams(monkeypatch, pdetect, pss, args)
    assert [ln for ln in out if ln.startswith("streams:")][0].startswith(
        f"streams: {STREAM_STEPS} batched steps over 2 sources")
    assert batches == [1] * (2 * STREAM_STEPS)
    native = {}
    prec = streams["runs"]["port"][0]
    for x, (dets, valid) in zip(prec.inputs, prec.outputs):
        native[x.tobytes()] = [dets[i][valid[i]] for i in range(2)]
    same = [(x, o) for x, o in zip(rec.inputs, rec.outputs) if x.tobytes() in native]
    assert same, "no batch of the same frames as the native run"
    for x, (dets, valid) in same:
        assert all(same_dets(dets[i][valid[i]], native[x.tobytes()][i]) for i in range(2))


def test_update_after_video(setup, tmp_path):
    """--update strips the weights after a video run, as JAX's does: the
    same trees and meta in both files."""
    for tag, cli in (("jax", jdetect), ("port", pdetect)):
        w = tmp_path / f"{tag}.npz"
        w.write_bytes(setup["ckpt"].read_bytes())
        args = argv(setup, f"{tag}_update", setup["clip"], "--nosave", "--update")
        args[args.index("--weights") + 1] = str(w)
        with _capture_stdout() as lines:
            out = cli.main(args)
        assert f"--update: stripped optimizer state from {w}" in lines
        assert not (out / "clip_det.mp4").exists()
    (jt, jm), (pt, pm) = (jax_load_checkpoint(tmp_path / f"{t}.npz") for t in ("jax", "port"))
    assert jm.pop("date") and pm.pop("date")  # the time of each write
    assert jm == pm and "optimizer" not in str(jt.keys())
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, jt, pt))


@pytest.mark.parametrize("source,opened", [("0", 0), ("rtsp://cam/1", "rtsp://cam/1"),
                                           ("3,rtsp://cam/2", 3)])
def test_unopened_sources_raise_as_jax(setup, monkeypatch, source, opened):
    """What reaches cv2.VideoCapture, and the error, are JAX's; nothing is
    opened (the stand-in opens nothing)."""
    seen = []

    class Closed:
        def __init__(self, src):
            seen.append(src)

        def isOpened(self):
            return False

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoCapture", Closed)
    errors = {}
    for tag, cli in (("jax", jdetect), ("port", pdetect)):
        seen.clear()
        with pytest.raises((AssertionError, OSError)) as e:
            cli.main(argv(setup, f"{tag}_closed", source))
        errors[tag] = (str(e.value), list(seen))
    assert errors["port"][1][0] == errors["jax"][1][0] == opened
    assert type(opened) is type(errors["port"][1][0])
    if "," not in source:
        assert errors["port"][0] == errors["jax"][0] == f"cannot open {source}"
    else:  # JAX names the list, the port the first source it could not open
        assert errors["port"][0] == f"cannot open {source.split(',')[0]}"
        assert "failed to open" in errors["jax"][0]


def test_writer_that_does_not_open_raises(monkeypatch, tmp_path):
    """A writer whose encoder does not open raises, naming the codec; the
    video run does not go on without its output."""
    class Closed:
        def __init__(self, *a):
            pass

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoWriter", Closed)
    with pytest.raises(OSError, match="mp4v encoder did not open"):
        video.Writer(tmp_path / "a.mp4", 30, (64, 48))


def test_cv2_missing_names_the_need(monkeypatch):
    import builtins

    from dmayolo_tpu_torch.data import imageio

    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name.split(".")[0] == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="video and webp need OpenCV's decoder"):
        imageio._cv2()
    with pytest.raises(RuntimeError, match="OpenCV"):
        video.Capture("clip.mp4")


@pytest.mark.parametrize("stalled", [False, True])
def test_streams_release_only_ended_readers(monkeypatch, tmp_path, stalled):
    """`_run_streams` releases a capture only once its reader has ended: a
    reader blocked in a read (a stalled camera) past the join's timeout
    keeps its capture, which is not released underneath it."""
    gate, released = threading.Event(), []

    class Stalling:  # a frame, then the end once the step is served (or never)
        def __init__(self, source):
            self.source, self.n = source, 0

        def read(self):
            self.n += 1
            if self.n == 1:
                return np.full((48, 64, 3), 100, np.uint8)
            gate.wait(5.0)
            return None

        def release(self):
            released.append(self.source)

    def infer(x):
        if not stalled:
            gate.set()
        return torch.zeros(x.shape[0], 1, 6), torch.zeros(x.shape[0], 1, dtype=torch.bool)

    monkeypatch.setattr(video, "Capture", Stalling)
    monkeypatch.setattr(pdetect, "READER_JOIN_S", 0.05 if stalled else 5.0)
    opt = type("Opt", (), {"source": "a,b", "imgsz": 64, "max_stream_steps": 1})()
    try:
        with _capture_stdout() as lines:
            pdetect._run_streams(opt, infer, ["x"], tmp_path)
        assert lines[-1].startswith("streams: 1 batched steps over 2 sources")
        assert released == ([] if stalled else ["a", "b"])
    finally:
        gate.set()
