"""Model info: parameter count, forward FLOPs, the layer summary, and a
per-layer timing profile.

Port of `dmayolo_tpu/utils/model_info.py`.  The JAX package reads its FLOP
count from XLA's cost analysis of the compiled forward, which counts every
operation, elementwise ones included.  Here `torch.utils.flop_counter`
counts the matrix products and convolutions only (2 a multiply-add), so
the port's count is the smaller by the model's elementwise work (stated in
`tests/test_torch_cli.py`).  Times come from CUDA events on the card and
from the host clock on the CPU.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch


def param_count(model) -> int:
    """Every parameter's elements (BN statistics are buffers, not counted),
    as the JAX count over `params`."""
    return sum(p.numel() for p in model.parameters())


def flops(model, img_size: int = 640, batch: int = 1) -> float:
    """GFLOPs of one f32 forward at (batch, img_size, img_size, 3), matrix
    products and convolutions only."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = next(model.parameters()).device
    x = torch.zeros(batch, img_size, img_size, 3, device=dev)
    counter = FlopCounterMode(display=False)
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode(), counter:
            model.apply(x, fused=model.fused)
    finally:
        model.train(was_training)
    return counter.get_total_flops() / 1e9


def model_info(model, img_size: int = 640, verbose: bool = False) -> str:
    """Print and return the layer count, parameter count and GFLOPs at
    `img_size` (with `verbose`, one line a layer first)."""
    n_p = param_count(model)
    g = flops(model, img_size)
    lines = [repr(spec) for spec in model.specs] if verbose else []
    gstr = f", {g:.1f} GFLOPs @ {img_size}px" if g else ""
    lines.append(f"{len(model.model)} layers, {n_p:,} parameters{gstr}")
    out = "\n".join(lines)
    print(out)
    return out


def _run_to(model, x, k: int, dtype):
    """The graph's first k + 1 layers on `x`; returns the last output."""
    y: Dict[int, torch.Tensor] = {}
    out = x.permute(0, 3, 1, 2)
    for mod in model.model[: k + 1]:
        f = mod.f
        if f != -1:
            out = (y[f % mod.i] if isinstance(f, int)
                   else [out if j == -1 else y[j % mod.i] for j in f])
        out = mod(out, dtype)
        if mod.i in model.save:
            y[mod.i] = out
    return out


def _time_ms(fn, iters: int, on_card: bool) -> float:
    """Mean ms of `fn()` over `iters` runs after one warm-up run: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def profile_layers(model, img_size: int = 256, iters: int = 10, batch: int = 1,
                   dtype=torch.float32, fused: bool = False) -> List[tuple]:
    """Per-layer time: the graph run once per prefix (layers 0..k) and the
    times differenced, as the JAX profile does.  `fused` needs the
    BN-folded model (`fuse()`).  Returns and prints (i, name, delta ms,
    cumulative ms) a layer."""
    if fused and not model.fused:
        raise ValueError("fused=True needs the BN-folded model: call fuse() first")
    dev = next(model.parameters()).device
    on_card = dev.type == "cuda"
    x = torch.zeros(batch, img_size, img_size, 3, dtype=dtype, device=dev)
    results, prev = [], 0.0
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for k, spec in enumerate(model.specs):
                dt = _time_ms(lambda: _run_to(model, x, k, dtype), iters, on_card)
                results.append((spec.i, spec.name, max(dt - prev, 0.0), dt))
                prev = dt
    finally:
        model.train(was_training)
    print(f"{'idx':>4} {'module':<18} {'delta_ms':>9} {'cum_ms':>8}")
    for i, name, delta, cum in results:
        print(f"{i:>4} {name:<18} {delta:>9.2f} {cum:>8.2f}")
    return results


class Profile:
    """Stage timer: a context manager that waits for the card's queued
    work (when CUDA is initialised) before reading the clock."""

    def __init__(self):
        self.t = 0.0

    def __enter__(self):
        self._sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.dt = time.perf_counter() - self.start
        self.t += self.dt

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()


class Timeout:
    """Deadline guard for host-side sections (SIGALRM, unix only)."""

    def __init__(self, seconds: float, timeout_msg: str = "", suppress: bool = True):
        self.seconds = seconds
        self.msg = timeout_msg
        self.suppress = suppress

    def _handler(self, signum, frame):
        raise TimeoutError(self.msg)

    def __enter__(self):
        import signal

        signal.signal(signal.SIGALRM, self._handler)
        signal.setitimer(signal.ITIMER_REAL, self.seconds)
        return self

    def __exit__(self, exc_type, exc, tb):
        import signal

        signal.setitimer(signal.ITIMER_REAL, 0)
        return self.suppress and exc_type is TimeoutError
