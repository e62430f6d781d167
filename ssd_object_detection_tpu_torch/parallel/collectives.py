"""The collectives of the data-parallel train step and loss, and the two of the model axis.

Data axis:
  - `all_reduce_sum_`: the gradients, summed over the ranks in place through flat
    buckets of one dtype (one all-reduce per bucket). A sum, not DistributedDataParallel's
    mean: each rank's loss term is already divided by the global normalisers
    (losses.py), so the sum is the gradient of the global loss;
  - `all_gather_padded`: every rank's 1-D shard, padded to a length every rank knows, in
    rank order; the hard-negative threshold sorts the gathered background CE;
  - `all_reduce_sum`: the loss's partial sums and counts.
Each takes the `group` it runs on: the mesh's `data_group` (parallel/mesh.py), None for
the default group.

Model axis (parallel/shardings.py's column-parallel convs), Megatron's f and g:
  - `copy_to_model`: the identity forward; its backward sums the input gradient over the
    model group, since each model rank's gradient is that of its channels only;
  - `gather_channels`: an all-gather along dim 1 over the model group; its backward
    keeps this rank's channels of the gradient.

Every rank of a group calls each of them in the same order, a rank with no rows of a
micro-batch included. The tensors stay on their device: NCCL takes CUDA tensors, gloo
takes CPU tensors and, for all_reduce, all_gather and broadcast, CUDA tensors too.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 64 << 20


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive tensors of one dtype, grouped up to BUCKET_BYTES (a larger tensor
    is a bucket of its own)."""
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if not buckets or buckets[-1][0].dtype != t.dtype or size + nbytes > BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += nbytes
    return buckets


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group: Optional[Any] = None) -> None:
    """Replace each tensor by its sum over the ranks of `group`."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_sum(x: torch.Tensor, group: Optional[Any] = None) -> torch.Tensor:
    """x summed over the ranks of `group`, as a new tensor."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_padded(x: torch.Tensor, length: int, fill: float, group: Optional[Any] = None) -> torch.Tensor:
    """Every rank's 1-D `x` (at most `length` long) padded with `fill` to `length`,
    concatenated in the group's rank order: (group size * length,)."""
    if x.dim() != 1 or x.shape[0] > length:
        raise ValueError(f"all_gather_padded takes a 1-D shard of at most {length}, got {tuple(x.shape)}")
    padded = torch.full((length,), fill, dtype=x.dtype, device=x.device)
    padded[:x.shape[0]] = x.detach()
    parts = [torch.empty_like(padded) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, padded, group=group)
    return torch.cat(parts)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)  # gloo takes contiguous memory
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, ctx.channels = dist.get_rank(group), x.shape[1]
        channels_last = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts, dim=1)
        return out.contiguous(memory_format=torch.channels_last) if channels_last else out

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.channels
        return grad[:, lo:lo + ctx.channels], None


def copy_to_model(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """x itself; in the backward, its gradient summed over the model group `group`."""
    return _CopyToModel.apply(x, group)


def gather_channels(x: torch.Tensor, group: Optional[Any]) -> torch.Tensor:
    """Every model rank's channels (dim 1) of `x`, concatenated in rank order, in x's
    memory format (channels-last stays channels-last); in the backward, this rank's
    channels of the gradient."""
    return _GatherChannels.apply(x, group)
