"""Automatic batch-size selection from CUDA memory (`--batch-size -1`).

Port of `dmayolo_tpu/train/autobatch.py`.  The search (`autobatch`) is the
JAX package's: a doubling ladder of measured batch sizes, probing on past
a measurement just over the limit up to 1.25x of it, a failure above a
working size meaning "too big", one midpoint refinement, `multiple_of`,
and the default where there is no budget.  What it measures differs: JAX
reads XLA's static memory analysis of the lowered step; here a probe runs
one real train step at the batch (the deployed accumulate and
`device_aug`, uint8 images as the loader gives them) and reads
`torch.cuda.max_memory_allocated`.  A probe whose step raises a
`RuntimeError` is a failure, after its tensors are freed: out of memory
(`torch.OutOfMemoryError`), or a kernel's size limit (at 1536 px the
nearest upsample's backward refuses a gradient of INT_MAX elements or
more, which bs 64 reaches), the port's analogue of XLA refusing to
compile an oversized program.
The budget is the card's free memory (`torch.cuda.mem_get_info`) plus
what this process holds cached, read when the search starts.
"""
from __future__ import annotations

import gc
from typing import Callable, List, Optional, Sequence

import torch


def device_memory_budget(device=None) -> Optional[int]:
    """Bytes this process can use on a CUDA `device` (None: the current
    card), or None off the card (no budget: the caller takes its
    default)."""
    if device is None and not torch.cuda.is_available():
        return None
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    gc.collect()  # unreachable tensors still hold their blocks
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device))


def autobatch(measure_for_batch: Callable[[int], Optional[int]],
              fraction: float = 0.9,
              batch_sizes: Sequence[int] = (1, 2, 4),
              hbm_bytes: Optional[int] = None,
              default: int = 16,
              max_batch: int = 1024,
              multiple_of: int = 1,
              log: Optional[List] = None) -> int:
    """Pick the largest batch whose measured memory fits fraction * budget.

    measure_for_batch: bs -> peak bytes of one train step at bs (None: no
        measurement available); raises `RuntimeError` (such as
        `torch.OutOfMemoryError`) where the step does not run.
    hbm_bytes: the budget (None: `device_memory_budget()`).
    default: returned when there is no budget, no measurement, or the
        smallest probe fails.
    multiple_of: probe only multiples of this; every size returned was
        measured.
    log: if given, each probe's (bs, status, bytes) is appended to it.
    """
    mult = max(int(multiple_of), 1)
    budget = hbm_bytes if hbm_bytes is not None else device_memory_budget()
    if budget is None:
        d = max(default - default % mult, mult) if mult > 1 else default
        print(f"autobatch: no device memory budget (CPU?) — using default batch-size {d}")
        return d

    limit = budget * fraction
    gib = 1024**3
    measured = {}

    def probe(bs):
        """-> ('ok', bytes) | ('fail', None) | ('noinfo', None), memoised."""
        if bs in measured:
            return measured[bs]
        try:
            m = measure_for_batch(bs)
        except RuntimeError as e:  # the step does not run at this batch
            print(f"autobatch: bs={bs} failed ({type(e).__name__}: {str(e).splitlines()[0]})")
            measured[bs] = ("fail", None)
        else:
            if m is None:
                measured[bs] = ("noinfo", None)
            else:
                fits = "fits" if m <= limit else "over"
                print(f"autobatch: bs={bs} -> {m/gib:.2f}G ({fits} {limit/gib:.2f}G "
                      f"= {fraction*100:.0f}% of {budget/gib:.2f}G)")
                measured[bs] = ("ok", m)
        if log is not None:
            log.append((bs, *measured[bs]))
        return measured[bs]

    # doubling ladder of valid (multiple-of-m) sizes: every rung the search
    # can return has been measured
    ladder = [b * mult for b in batch_sizes if b * mult <= max_batch] or [mult]
    while ladder[-1] * 2 <= max_batch:
        ladder.append(ladder[-1] * 2)

    best = None          # largest bs measured under the limit
    any_ok = False
    stopped_early = False
    for bs in ladder:
        status, m = probe(bs)
        if status == "noinfo":
            print(f"autobatch: no memory measurement — using default batch-size {default}")
            return default
        if status == "fail":
            if not any_ok:
                # the smallest probe does not run: something else is
                # wrong; don't guess
                d = max(default - default % mult, mult) if mult > 1 else default
                print(f"autobatch: smallest probe failed — using default batch-size {d}")
                return d
            stopped_early = True
            break
        any_ok = True
        if m <= limit:
            best = bs
        elif m > limit * 1.25:
            # clearly over (not allocator noise) — stop the ladder
            stopped_early = True
            break

    if best is None:
        # nothing under the fraction * budget limit: the smallest valid
        # size runs (with a warning) if it fits the budget itself, else the
        # search refuses rather than return a size measured not to fit
        b = next(bs for bs in ladder if measured.get(bs, ("", 0))[0] == "ok")
        mem = measured[b][1]
        if mem > budget:
            raise RuntimeError(
                f"autobatch: smallest valid batch-size {b} needs {mem/gib:.2f}G but the "
                f"device budget is {budget/gib:.2f}G — reduce --imgsz, enable --remat, "
                f"or use fewer devices (multiple_of={mult})")
        print(f"autobatch: no probe under the {fraction*100:.0f}% limit — using smallest "
              f"batch-size {b} ({mem/gib:.2f}G of {budget/gib:.2f}G, tight)")
        return b

    # one midpoint refinement between the best fit and the next rung
    if stopped_early or measured.get(best * 2, ("", 0))[0] in ("fail", "ok"):
        cand = (best + best // 2) - (best // 2) % mult
        if cand > best and cand <= max_batch and cand not in measured:
            status, mm = probe(cand)
            if status == "ok" and mm <= limit:
                best = cand

    mem = measured[best][1]
    print(f"autobatch: batch-size {best} ({mem/gib:.2f}G measured, "
          f"{fraction*100:.0f}% target of {budget/gib:.2f}G)")
    return best


def probe_targets(n: int, max_targets: int, device, seed: int = 0):
    """`Targets` for n images: the first half of each image's rows live,
    small boxes spread over the image, so the loss runs its real path."""
    from .loss import Targets

    g = torch.Generator().manual_seed(seed)
    cls = torch.zeros(n, max_targets)
    xy = torch.rand(n, max_targets, 2, generator=g) * 0.8 + 0.1
    wh = torch.rand(n, max_targets, 2, generator=g) * 0.1 + 0.02
    mask = torch.zeros(n, max_targets, dtype=torch.bool)
    mask[:, : max(max_targets // 2, 1)] = True
    return Targets(cls.to(device), torch.cat([xy, wh], -1).to(device), mask.to(device))


def find_train_batch_size(model, loss_fn, hyp: dict, img_size: int = 640,
                          dtype=torch.bfloat16, fraction: float = 0.9,
                          hbm_bytes: Optional[int] = None,
                          default: int = 16,
                          max_targets: int = 64,
                          multiple_of: int = 1,
                          max_batch: int = 1024,
                          remat: bool = False,
                          device_aug: Optional[dict] = None,
                          accumulate: Optional[int] = None,
                          nbs: int = 64,
                          adam: bool = False,
                          log: Optional[List] = None,
                          world: int = 1) -> int:
    """Autobatch over the whole train step (forward, loss, backward,
    optimizer, EMA) of `model` (on its device) at `img_size`.

    Each probe runs the step the Trainer will run at that batch: the same
    accumulate (round(nbs / bs) unless given), so the step takes
    accumulate * bs uint8 images, the same `device_aug`, `remat` and
    optimizer.  On the CPU there is no budget and `default` is returned
    without a probe.  `world` > 1 (data-parallel training): the batch is
    the global one, a multiple of `world` (as `multiple_of`), and each
    probe runs one device's share of it, bs / world rows a microbatch,
    against that device's budget (the probe itself issues no
    collective)."""
    from .optim import Schedule, param_groups
    from .step import init_train_state, make_train_step

    device = next(model.parameters()).device
    multiple_of = max(int(multiple_of), int(world))
    if hbm_bytes is None:
        hbm_bytes = device_memory_budget(device)
    if hbm_bytes is None:  # off the card: the default, nothing probed
        return autobatch(lambda bs: None, hbm_bytes=None, default=default,
                         multiple_of=multiple_of)
    model.remat = remat
    state = init_train_state(model, param_groups(model), hyp.get("weight_decay", 5e-4),
                             adam=adam, momentum=hyp.get("momentum", 0.937))
    gen = torch.Generator(device=device).manual_seed(0)

    def run(bs: int) -> int:
        acc = accumulate if accumulate else max(round(nbs / bs), 1)
        sched = Schedule(hyp, epochs=100, steps_per_epoch=100, adam=adam, batch_size=bs,
                         step_scale=acc)
        step = make_train_step(loss_fn, sched, dtype=dtype, accumulate=acc,
                               device_aug=device_aug)
        n = acc * (bs // world)
        images = torch.randint(0, 256, (n, img_size, img_size, 3), dtype=torch.uint8,
                               device=device, generator=gen)
        targets = probe_targets(n, max_targets, device)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        step(state, images, targets, gen)
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))

    def measure(bs: int) -> int:
        error = None
        try:
            return run(bs)
        except RuntimeError as e:  # raised again below, once the step's tensors are gone
            error = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        finally:
            # the probe's batch, graph and grads go before the next probe
            state.optimizer.zero_grad(set_to_none=True)
            gc.collect()
            torch.cuda.empty_cache()
        raise RuntimeError(error)

    try:
        return autobatch(measure, fraction=fraction, hbm_bytes=hbm_bytes, default=default,
                         multiple_of=multiple_of, max_batch=max_batch, log=log)
    finally:
        model.remat = False
        del state
        gc.collect()
        torch.cuda.empty_cache()
