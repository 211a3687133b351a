"""Multi-process data parallelism (counterpart of
``lpr_tpu/parallel/multiproc.py``).

The reference scales with torch DDP: ``WORLD_SIZE`` / ``RANK`` env
plumbing (``yolov5/train.py:60-62``) and ``dist.init_process_group``
(``train.py:535``).  The JAX package keeps that env contract for
``jax.distributed``, and so does this module:

- ``COORDINATOR_ADDRESS`` — ``host:port`` of rank 0's store (or a
  ``torch.distributed`` init URL: ``tcp://host:port``, ``file:///path``);
- ``WORLD_SIZE`` — the number of processes;
- ``RANK`` — this process's rank; ``LOCAL_RANK`` (optional) picks its card
  (default ``RANK`` modulo the cards).

One process drives one card.  The group runs NCCL when the process's
device is a card and gloo on the CPU; on a card a failure to start NCCL
raises (it never falls back to gloo).  The trainers reduce over the group
explicitly (:mod:`lpr_tpu_torch.parallel.collectives`).

``python -m lpr_tpu_torch.parallel.multiproc`` runs the self-check
:func:`multiproc_dp_check`: two LPSR trainer steps in 2 processes x N
images over gloo against 1 process x 2N, losses within 2e-6 relative and
the weights' sum within 1e-5 (the JAX check's bounds).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Optional, Tuple

import torch

from lpr_tpu_torch.device import DeviceLike, resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _init_url(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def init_group(init_method: str, world_size: int, rank: int,
               device: DeviceLike = "cuda"):
    """Start this process's ``torch.distributed`` group: NCCL on a card
    (the card made current first: ``device``'s index, else ``LOCAL_RANK``,
    else ``rank`` modulo the cards), gloo on the CPU.  On a card one
    all-reduce runs before this returns, so a failure to start NCCL raises
    here.  Returns the group."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    if dev.type == "cuda":
        idx = dev.index
        if idx is None:
            idx = int(os.environ.get("LOCAL_RANK", rank)) \
                % torch.cuda.device_count()
        torch.cuda.set_device(idx)
        card = torch.device("cuda", idx)
        dist.init_process_group("nccl", init_method=init_method,
                                world_size=world_size, rank=rank,
                                device_id=card)
        probe = torch.ones(1, device=card)
        dist.all_reduce(probe)
        torch.cuda.synchronize(card)
        if float(probe) != world_size:
            raise RuntimeError(f"NCCL's first all-reduce gave "
                               f"{float(probe)} over {world_size} ranks")
    else:
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world_size, rank=rank)
    return dist.group.WORLD


# The CLIs' refusal of --data-parallel in one process: the JAX flag shards
# one process's batch over every local device, which here is one process
# a card.
DATA_PARALLEL_NEEDS_ENV = (
    "--data-parallel runs one process a card: start WORLD_SIZE (above 1) "
    "processes with COORDINATOR_ADDRESS, WORLD_SIZE and RANK set "
    "(LOCAL_RANK picks the card); one process does not split its batch "
    "over several cards")


def initialize_from_env(device: DeviceLike = "cuda") -> bool:
    """:func:`init_group` from the env contract above.  False when
    ``WORLD_SIZE`` is absent or 1 (one process: callers need no branch),
    True once the group runs; a group already started (by an earlier
    call in this process) counts."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"the process group has "
                               f"{dist.get_world_size()} ranks, WORLD_SIZE "
                               f"says {world}")
        return True
    init_group(_init_url(os.environ["COORDINATOR_ADDRESS"]), world,
               int(os.environ["RANK"]), device)
    return True


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_slice(global_len: int) -> slice:
    """This process's contiguous slice of a global batch (the
    DistributedSampler equivalent); ``global_len`` must divide by the
    process count."""
    i, n = _rank_world()
    if global_len % n:
        raise ValueError(f"global batch {global_len} not divisible by "
                         f"{n} processes")
    per = global_len // n
    return slice(i * per, (i + 1) * per)


def rank_share(items: list, global_batch: int) -> Tuple[list, int]:
    """(this rank's share of ``items``, its batch) for a global batch:
    every ``world``-th item from the rank's index, after truncating to a
    multiple of ``world`` so every rank takes the same number of steps (a
    collective would wait forever otherwise; the reference's
    DistributedSampler split).  A batch that does not divide raises."""
    i, n = _rank_world()
    if global_batch % n:
        raise SystemExit(f"--batch-size {global_batch} not divisible by "
                         f"WORLD_SIZE {n}")
    return items[:len(items) - len(items) % n][i::n], global_batch // n


def is_main_process() -> bool:
    """The rank-0 gate for logging and checkpoints (the reference's
    ``RANK in {-1, 0}``)."""
    return _rank_world()[0] == 0


# ----------------------------------------------------------------------
# Self-check: 2 processes x N == 1 process x 2N.


def _payload(global_batch: int, device: str) -> dict:
    """Two LPSR trainer steps on data from a fixed seed: the global batch
    made on every rank, each rank taking its ``local_slice``; returns the
    losses and the weights' sum."""
    import numpy as np

    from lpr_tpu_torch.models.lpsr import LPSRConfig
    from lpr_tpu_torch.parallel.mesh import make_mesh
    from lpr_tpu_torch.train.lpsr import LPSRTrainConfig, LPSRTrainer

    mesh = make_mesh(devices=[device])
    lcfg = LPSRConfig(num_features=8, growth_rate=4, num_blocks=2,
                      num_layers=2)
    trainer = LPSRTrainer(LPSRTrainConfig(), lcfg, mesh=mesh)
    state = trainer.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(2):
        lr_img = rng.rand(global_batch, 8, 16, 3).astype(np.float32)
        hr_img = rng.rand(global_batch, 8, 16, 1).astype(np.float32)
        sl = local_slice(global_batch)
        state, loss = trainer.step(state, lr_img[sl], hr_img[sl])
        losses.append(float(loss))
    fp = float(sum(v.detach().double().sum().item()
                   for v in state["params"].values()))
    _, world = _rank_world()
    return {"losses": losses, "fingerprint": fp, "n_processes": world,
            "global_batch": global_batch}


def _run_role(env_extra: dict, global_batch: int, device: str
              ) -> subprocess.Popen:
    env = dict(os.environ)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "COORDINATOR_ADDRESS"):
        env.pop(k, None)
    env.update(env_extra)
    env.setdefault("OMP_NUM_THREADS", "1")
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import json; from lpr_tpu_torch.parallel import multiproc as m; "
            f"m.initialize_from_env({device!r}); "
            f"r = m._payload({global_batch}, {device!r}); "
            "print('PAYLOAD ' + json.dumps(r), flush=True) "
            "if m.is_main_process() else None")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            cwd=_REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _collect(proc: subprocess.Popen, tag: str,
             timeout: float) -> Optional[dict]:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"{tag} did not end within {timeout} s")
    if proc.returncode != 0:
        raise RuntimeError(f"{tag} failed (rc={proc.returncode}):\n"
                           f"{err[-4000:]}")
    for line in out.splitlines():
        if line.startswith("PAYLOAD "):
            return json.loads(line[len("PAYLOAD "):])
    return None


def multiproc_dp_check(n_processes: int = 2, per_process_batch: int = 4,
                       timeout: float = 600.0, device: str = "cpu"
                       ) -> Tuple[dict, dict]:
    """Run the payload in one process on the global batch and, at the
    same time, in ``n_processes`` processes (a ``file://`` store in a
    temporary directory) on ``per_process_batch`` images each, and hold
    the two to
    the JAX check's bounds: losses within 2e-6 relative, the weights' sum
    within 1e-5 (the all-reduce sums in another order than one process's
    mean).  Returns (single, multi)."""
    total = n_processes * per_process_batch
    store = tempfile.mkdtemp(prefix="lpr_dp_check_")
    try:
        url = "file://" + os.path.join(store, "store")
        procs = [("single-process baseline", _run_role({}, total, device))]
        procs += [(f"worker {r}", _run_role(
            {"COORDINATOR_ADDRESS": url, "WORLD_SIZE": str(n_processes),
             "RANK": str(r)}, total, device)) for r in range(n_processes)]
        got, errs = [], []
        for tag, p in procs:
            try:
                got.append(_collect(p, tag, timeout))
            except RuntimeError as e:   # collect every failure first
                errs.append(str(e))
        if errs:
            raise RuntimeError("\n".join(errs))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    single, multi = got[0], next((g for g in got[1:] if g), None)
    if not single or single["n_processes"] != 1:
        raise RuntimeError(f"single-process baseline gave {single}")
    if multi is None or multi["n_processes"] != n_processes:
        raise RuntimeError(f"rank 0 gave {multi}")
    for got, want in zip(multi["losses"], single["losses"]):
        if abs(got - want) > 2e-6 * abs(want):
            raise AssertionError(f"multi-process losses {multi['losses']} "
                                 f"!= single-process {single['losses']}")
    fp_m, fp_s = multi["fingerprint"], single["fingerprint"]
    if abs(fp_m - fp_s) > 1e-5 * max(1.0, abs(fp_s)):
        raise AssertionError(f"weights' sum diverged: {fp_m} vs {fp_s}")
    return single, multi


if __name__ == "__main__":
    single, multi = multiproc_dp_check()
    print(f"multiproc dp check ok: {multi['n_processes']} processes x "
          f"{multi['global_batch'] // multi['n_processes']} images == 1 "
          f"process x {single['global_batch']} (losses {multi['losses']})")
