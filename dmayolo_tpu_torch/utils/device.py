"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA.  Raises when CUDA is asked for and missing: the
    port never drops to the CPU unless the caller passes `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
