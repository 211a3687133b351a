"""String-keyed training hook registry (counterpart of
``lpr_tpu/utils/callbacks.py``, reference yolov5/utils/callbacks.py:7-78)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

HOOKS = (
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_val_start", "on_val_batch_start",
    "on_val_image_end", "on_val_batch_end", "on_val_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end", "teardown",
)


class Callbacks:
    def __init__(self):
        self._hooks: Dict[str, List[Dict[str, Any]]] = {h: [] for h in HOOKS}

    def register_action(self, hook: str, name: str = "",
                        callback: Callable = None):
        if hook not in self._hooks:
            raise ValueError(f"unknown hook {hook!r}")
        if not callable(callback):
            raise ValueError("callback must be callable")
        self._hooks[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook: str = None):
        return self._hooks[hook] if hook else self._hooks

    def run(self, hook: str, *args, **kwargs):
        if hook not in self._hooks:
            raise ValueError(f"unknown hook {hook!r}")
        for entry in self._hooks[hook]:
            entry["callback"](*args, **kwargs)
