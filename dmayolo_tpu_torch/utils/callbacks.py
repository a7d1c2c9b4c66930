"""Callback event bus: the reference's hooks, by the same names and in the
same order, so integrations written for it register here unchanged.

Port of `dmayolo_tpu/utils/callbacks.py`.  The `Trainer` runs
`on_train_start`, `on_train_epoch_start`, `on_model_save`,
`on_fit_epoch_end` (with the epoch's row and the epoch) and
`on_train_end`, where the JAX trainer runs them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

HOOKS = [
    "on_pretrain_routine_start",
    "on_pretrain_routine_end",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_start",
    "optimizer_step",
    "on_before_zero_grad",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_val_start",
    "on_val_batch_start",
    "on_val_image_end",
    "on_val_batch_end",
    "on_val_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "on_params_update",
    "teardown",
]


class Callbacks:
    def __init__(self):
        self._callbacks: Dict[str, List[dict]] = {h: [] for h in HOOKS}

    def register_action(self, hook: str, name: str = "", callback: Callable = None):
        assert hook in self._callbacks, f"hook '{hook}' not in {HOOKS}"
        assert callable(callback), "callback must be callable"
        self._callbacks[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook: Optional[str] = None):
        return self._callbacks[hook] if hook else self._callbacks

    def run(self, hook: str, *args, **kwargs):
        assert hook in self._callbacks, f"hook '{hook}' not in {HOOKS}"
        for action in self._callbacks[hook]:
            action["callback"](*args, **kwargs)
