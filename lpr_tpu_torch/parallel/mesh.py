"""The data-parallel mesh (counterpart of ``lpr_tpu/parallel/mesh.py``).

The JAX package's mesh is a 1-D ``data`` axis over devices: batches are
sharded on the leading axis, weights replicated, and XLA inserts the
gradient all-reduce.  Here a :class:`Mesh` is the devices of this process,
one replica each, and the ``torch.distributed`` process group the replicas
of other processes join, or None.  A device may repeat: the JAX tests run
on 8 virtual CPU devices, and repeats are how the CPU tests and a machine
with one card run the split.  The collectives are explicit
(:mod:`lpr_tpu_torch.parallel.collectives`); one process drives one card,
PyTorch's idiom, so a trainer's mesh holds one local device.

``batch_sharding`` and ``replicated`` (JAX ``NamedSharding`` objects) have
no counterpart: :func:`shard_batch` and :func:`replicate` return the
per-device pieces themselves, and :func:`split_batch` cuts a batch without
moving it (the sharded recognizer's split).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: this process's devices, one replica each (repeats
    allowed); ``group``: the process group over which the replicas of all
    processes reduce, or None for this process alone."""

    devices: Tuple[torch.device, ...]
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` with the default process group once one is
    initialized (:func:`lpr_tpu_torch.parallel.multiproc
    .initialize_from_env`), else None.  By default the devices are this
    process's: in a process group on a card machine the process's card
    (``torch.cuda.current_device()``), else every card; on a machine
    without a card the CPU, ``n_devices`` times (the counterpart of JAX's
    virtual CPU devices).  ``n_devices`` takes the first ones; more than
    the cards raises."""
    import torch.distributed as dist

    group = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             else None)
    if devices is None:
        if torch.cuda.is_available():
            if group is not None:
                avail = [torch.device("cuda", torch.cuda.current_device())]
            else:
                avail = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
            n = len(avail) if n_devices is None else int(n_devices)
            if not 1 <= n <= len(avail):
                raise ValueError(f"a mesh of {n} devices over {len(avail)} "
                                 f"card(s) of this process; repeat a card "
                                 f"with make_mesh(devices=[...])")
            devices = avail[:n]
        else:
            devices = [torch.device("cpu")] * (1 if n_devices is None
                                               else int(n_devices))
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, group)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor or array leaf of dicts, lists and tuples;
    other leaves (None, numbers) kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.require(x, requirements="W"))


def split_batch(x, n: int) -> List[Any]:
    """``x`` (an array, a tensor or a sequence of items) cut on its
    leading axis into ``n`` equal pieces, as slices (no copy, no move).  A
    batch that does not divide raises, as JAX's sharded ``device_put``
    does; :func:`pad_to_multiple` pads one."""
    b = len(x)
    if b % n:
        raise ValueError(f"a batch of {b} does not split over {n} devices; "
                         f"pad it (pad_to_multiple)")
    per = b // n
    return [x[i * per:(i + 1) * per] for i in range(n)]


def shard_batch(tree: Any, mesh: Mesh) -> List[Any]:
    """The leading axis of every leaf split into ``mesh.size`` equal
    pieces (:func:`split_batch`), piece i on device i: one tree a replica.
    Under a process group the leaves are this process's local batch (the
    reference's DistributedSampler contract, as in the JAX package)."""
    return [tree_map(lambda x, i=i, dev=dev: _as_tensor(
        split_batch(x, mesh.size)[i]).to(dev), tree)
        for i, dev in enumerate(mesh.devices)]


def replicate(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of ``tree`` on each mesh device, each with storage of its
    own (a repeated device gets copies too).  Across processes each must
    pass the same value, as with DDP's identical init on every rank."""
    return [tree_map(lambda x, dev=dev: _as_tensor(x).to(dev, copy=True),
                     tree) for dev in mesh.devices]


def pad_to_multiple(batch, mult: int):
    """Pad the leading axis up to a multiple of ``mult`` with copies of
    the last row; returns (padded, real_count).  numpy arrays as the JAX
    helper pads them; tensors the same way."""
    b = batch.shape[0]
    rem = (-b) % mult
    if rem == 0:
        return batch, b
    if torch.is_tensor(batch):
        pad = batch[-1:].expand(rem, *batch.shape[1:])
        return torch.cat([batch, pad], 0), b
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), b
