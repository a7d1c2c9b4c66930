"""Asynchronous training checkpoints: the JAX `.npz`, written on a
background thread.

The JAX package's `--ckpt-async` saves the train state as an Orbax
checkpoint directory (`dmayolo_tpu/utils/orbax_ckpt.py`), which streams
device buffers to disk while training goes on.  The port's `--ckpt-async`
writes the same `.npz` as its synchronous save (`utils/checkpoint.py`),
on purpose: both packages' `--resume` read that file, and neither
package's CLI resumes from an Orbax directory.  What moves off the
training thread is the f16 conversion and the disk write.  The port
reads and writes the Orbax directories themselves in
`utils/orbax_ckpt.py`, whose checkpointer shares `BackgroundWriter`.

`save` takes the trees as they are: the caller hands over host arrays
that nothing writes to afterwards, as `train/step.py::state_trees` gives
them (arrays of their own, pulled when `save` is called).  At most one write is in flight: `save` waits
for the previous one.  A write goes to a temporary file that replaces
the checkpoint when it is whole.  `wait` and `close` raise what a write
raised.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

from .checkpoint import save_checkpoint


class BackgroundWriter:
    """One write at a time on a thread of its own; `wait` and `close`
    raise what a write raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _start(self, write: Callable[[], None]) -> None:
        """Wait for the write in flight, then start `write`."""
        self.wait()

        def run():
            try:
                write()
            except Exception as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="async-ckpt")
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight, if any, is on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


class AsyncTrainCheckpointer(BackgroundWriter):
    def save(self, path, trees: Dict[str, Dict], meta: Optional[Dict] = None) -> None:
        """Start writing `trees` (`save_checkpoint`'s keyword trees of numpy
        arrays, handed over) and `meta` to `path` (.npz), model and EMA
        trees in f16 as the synchronous save writes them; returns once the
        write has started."""
        path = Path(path).with_suffix(".npz")
        tmp = path.with_name(path.stem + ".tmp.npz")

        def write():  # to a temporary file first: a cut write leaves the last one whole
            save_checkpoint(tmp, meta=meta, half=True, **trees)
            os.replace(tmp, path)

        self._start(write)
