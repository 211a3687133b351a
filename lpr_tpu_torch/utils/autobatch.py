"""Memory planning for the batch size (counterpart of
``lpr_tpu/utils/autobatch.py``; the reference binary-searches the batch
from live CUDA memory, ``yolov5/utils/autobatch.py:16-57``).

:func:`traced_bytes` runs a function once on ``meta`` tensors (shapes and
dtypes, no data, no device work, no compile) under a
``TorchDispatchMode`` that follows every tensor an operation makes and
takes the peak of the bytes alive at once, counted per storage so that a
view does not count twice.  In eager PyTorch that live set is what the
caching allocator holds: a tensor is freed when its last reference goes.
:func:`autobatch` scales the per-sample peak by ``layout_factor`` and
takes the largest power-of-two batch that fits the card's memory.

``layout_factor`` covers what the live set does not see (the allocator's
rounding to 512-byte blocks, cuDNN's workspace); its default is
calibrated on an H100 by ``python -m lpr_tpu_torch.tools.validate_autobatch``
against ``torch.cuda.max_memory_allocated``'s marginal bytes per sample
(``PERF.md``).  The JAX module's TPU constants (v5e memory and its layout
factor) are not carried over.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# max_memory_allocated's marginal bytes per sample over the live-set
# estimate on an H100 80GB HBM3 at 700 W (tools/validate_autobatch.py;
# PERF.md section 6): 0.95-1.00 for the detector (forward in bf16 and
# float32, and its training step) and LPSR in bf16, 1.357 for LPSR in
# float32 (cuDNN's workspace grows with the batch); the largest, rounded up.
LAYOUT_FACTOR = 1.4


def _nbytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


class _LiveBytes(TorchDispatchMode):
    """Follows every tensor the operations return: each storage's bytes
    are live from its first tensor to the death of its last one."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._users: Dict[int, list] = {}    # storage -> [bytes, tensors]
        self._seen: Dict[int, Any] = {}      # id(tensor) -> finalizer

    def track(self, t: torch.Tensor) -> None:
        if id(t) in self._seen and self._seen[id(t)].alive:
            return
        key = t.untyped_storage()._cdata
        rec = self._users.get(key)
        if rec is None:
            rec = self._users[key] = [_nbytes(t), 0]
            self.live += rec[0]
            self.peak = max(self.peak, self.live)
        rec[1] += 1
        self._seen[id(t)] = weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        rec = self._users[key]
        rec[1] -= 1
        if rec[1] == 0:
            self.live -= rec[0]
            del self._users[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self.track(t)
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def traced_bytes(fn: Callable, *example_args) -> Tuple[int, int]:
    """(peak live bytes, output bytes) of ``fn(*example_args)``, run once
    on ``meta`` copies of the example tensors (their shapes and dtypes).
    The example tensors count as live from the start until their last
    reference goes, as the JAX estimate counts its inputs; tensors the
    function closes over (the weights) are not counted: they are the
    caller's ``param_bytes``.  Output bytes are those of the distinct
    storages of the result."""
    args = [_meta(a) if isinstance(a, torch.Tensor) else a
            for a in example_args]
    mode = _LiveBytes()
    with mode:
        for t in _tensors(args):
            mode.track(t)
        out = fn(*args)
        del args
        peak = mode.peak
    seen = {}
    for t in _tensors(out):
        seen[t.untyped_storage()._cdata] = _nbytes(t)
    return peak, sum(seen.values())


class _Apply(torch.nn.Module):
    """``apply_fn(module, x)`` as a module, so that ``functional_call``
    can put meta tensors in the module's weights' places."""

    def __init__(self, module: torch.nn.Module, fn: Callable):
        super().__init__()
        self.m = module
        self.fn = fn

    def forward(self, x):
        return self.fn(self.m, x)


def _leaves(params) -> list:
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().values())
    return list(_tensors(params))


def autobatch(apply_fn: Callable, params, sample_shape: Tuple[int, ...],
              dtype: torch.dtype = torch.float32,
              hbm_bytes: Optional[int] = None, reserve: float = 0.35,
              max_batch: int = 1024,
              layout_factor: float = LAYOUT_FACTOR) -> int:
    """The largest power-of-two batch whose estimated footprint fits
    ``(1 - reserve) * hbm_bytes - 2 * param_bytes``.  ``apply_fn(params,
    x)`` on a batch ``x`` of ``sample_shape`` in ``dtype``; ``params`` is a
    module or a tree of tensors (run as meta tensors here).
    ``hbm_bytes`` defaults to the ``total_memory`` of the card that holds
    the weights; weights on the CPU need it given."""
    from torch.func import functional_call

    leaves = _leaves(params)
    if hbm_bytes is None:
        dev = next((t.device for t in leaves if t.device.type == "cuda"),
                   None)
        if dev is None:
            raise ValueError("autobatch: the weights are not on a card; "
                             "pass hbm_bytes")
        hbm_bytes = torch.cuda.get_device_properties(dev).total_memory
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    x1 = torch.empty((1, *sample_shape), dtype=dtype, device="meta")
    with torch.no_grad():
        if isinstance(params, torch.nn.Module):
            wrapper = _Apply(params, apply_fn)
            meta = {f"m.{k}": _meta(v)
                    for k, v in params.state_dict().items()}
            peak1, out1 = traced_bytes(
                lambda x: functional_call(wrapper, meta, (x,)), x1)
        else:
            from lpr_tpu_torch.parallel.mesh import tree_map

            meta = tree_map(_meta, params)
            peak1, out1 = traced_bytes(lambda x: apply_fn(meta, x), x1)
    per_sample = (peak1 + out1) * layout_factor
    budget = hbm_bytes * (1.0 - reserve) - 2 * param_bytes
    if budget <= 0:
        return 1
    b = 1
    while b * 2 <= max_batch and per_sample * (b * 2) <= budget:
        b *= 2
    return b
