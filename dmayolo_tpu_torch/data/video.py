"""Video files, webcams and streams: frames in, annotated frames out.

The counterpart of the capture and writer calls of the JAX package's
`cli/detect.py` (`cv2.VideoCapture` and an `mp4v` `cv2.VideoWriter`).
Neither machine has another video decoder (no NVDEC headers, no libav*
but the one OpenCV's wheel bundles), so frames are decoded and encoded
by OpenCV, imported lazily through `imageio._cv2()`; every pixel
operation after the decode (letterbox, colour, drawing) is the port's
host library.

    cap = Capture("flight.mp4")             # or "0" (a webcam), or a URL
    writer = Writer("out.mp4", cap.fps, (cap.width, cap.height))
    while (frame := cap.read()) is not None:  # BGR uint8 (H, W, 3)
        writer.write(frame)
    writer.release(); cap.release()

A capture or writer that does not open raises; nothing turns a failed
open into a skip.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .imageio import _cv2

DEFAULT_FPS = 30  # where the container states none, as the JAX CLI
FOURCC = "mp4v"  # the JAX CLI's codec for `{stem}_det.mp4`


class Capture:
    """A video file, a webcam index (a string of digits, opened as an int)
    or a stream URL, opened; raises OSError("cannot open ...") where it
    cannot be.  `fps` (DEFAULT_FPS where the container has none), `width`,
    `height`, `is_camera`; `read()` gives the next BGR uint8 frame, or
    None at the end of the stream."""

    def __init__(self, source):
        cv2 = _cv2()
        self.source = str(source)
        self.is_camera = self.source.isdigit()
        self._cap = cv2.VideoCapture(int(self.source) if self.is_camera else self.source)
        if not self._cap.isOpened():
            raise OSError(f"cannot open {source}")
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or DEFAULT_FPS
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def read(self) -> Optional[np.ndarray]:
        ok, frame = self._cap.read()
        return frame if ok else None

    def release(self) -> None:
        self._cap.release()


class Writer:
    """An `mp4v` file opened at `fps` and `size` (width, height); raises
    where the encoder does not open.  `write(frame)` appends a BGR uint8
    frame of that size."""

    def __init__(self, path, fps: float, size: Tuple[int, int]):
        cv2 = _cv2()
        self.path = Path(path)
        self._w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*FOURCC), fps, size)
        if not self._w.isOpened():
            raise OSError(f"cannot write {path}: OpenCV's {FOURCC} encoder did not open "
                          f"(at {size[0]}x{size[1]}, {fps} FPS)")

    def write(self, frame: np.ndarray) -> None:
        self._w.write(frame)

    def release(self) -> None:
        self._w.release()


def count_frames(path) -> int:
    """The frames a video file decodes to, read to its end."""
    cap = Capture(path)
    try:
        n = 0
        while cap.read() is not None:
            n += 1
        return n
    finally:
        cap.release()
