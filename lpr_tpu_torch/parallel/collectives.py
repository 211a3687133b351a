"""The collectives the data-parallel trainers call, over a process group
(:class:`lpr_tpu_torch.parallel.mesh.Mesh` ``group``).

JAX's sharded step is the single-device program over the global batch,
and XLA inserts every reduction it needs.  Here each is explicit:

- :func:`all_reduce_sum` — a sum over ranks that autograd differentiates
  (its backward all-reduces the gradient): the detector's batch
  statistics over the global batch;
- :func:`average` — the mean over ranks of many tensors in one flat
  bucket: the gradients, the loss and its components, once a
  step;
- :func:`all_gather_cat` — every rank's tensor, concatenated in rank
  order: the validation PSNRs.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

Tensor = torch.Tensor


def world_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        import torch.distributed as dist

        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: Tensor):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """The sum of ``x`` over the ranks of ``group``, differentiable: every
    rank's value feeds every rank's result, so the gradient that reaches
    ``x`` is the sum of the ranks' gradients of the result.  Every rank
    must run the same forward and backward."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def average(tensors: Sequence[Tensor], group) -> List[Tensor]:
    """Each tensor's mean over the ranks of ``group``, from one
    all-reduce of a float32 bucket: new tensors, in the tensors' shapes
    and dtypes (the tensors themselves without a group)."""
    import torch.distributed as dist

    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].view(t.shape).to(t.dtype))
        i += n
    return out


@torch.no_grad()
def all_gather_cat(x: Tensor, group) -> Tensor:
    """Every rank's ``x`` (equal shapes), concatenated on the first axis
    in rank order; ``x`` itself without a group."""
    import torch.distributed as dist

    if group is None:
        return x
    parts: List[Tensor] = [torch.empty_like(x)
                           for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)
