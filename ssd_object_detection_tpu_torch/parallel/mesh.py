"""The data-parallel mesh: a process group whose ranks each hold a replica of the model and
a share of every batch. Port of ssd_object_detection_tpu/parallel/mesh.py.

The JAX package runs one program over a 1-D device mesh and lets GSPMD keep every
reduction global. Here each rank is a process with its own device, so what GSPMD did
implicitly is spelt out: `RowShard` says which rows of a global batch a rank holds,
`shard_batch` takes them, `replicate` broadcasts rank 0's parameters, and the train step
and the loss reduce across ranks through parallel/collectives.py.

Row layout. The JAX step splits the GLOBAL batch into `accum_steps` micro-batches of
consecutive rows (micro-batch m is global rows [m*B/a, (m+1)*B/a)). A rank's local batch
is, for each micro-batch in order, its share of that micro-batch: rows
[ceil(r*M/W), ceil((r+1)*M/W)) of it, M = B/a rows over W ranks. The shares differ by at
most one row, lower ranks hold the larger ones, a rank may hold none (a micro-batch
smaller than the ranks), and each rank's local batch splits into `accum_steps` equal
micro-batches again.

A 2-D mesh (parallel/shardings.py::make_2d_mesh) adds a model axis: the ranks that share
one data rank hold the same rows, and the wide convs split their output channels over
them. `rank` and `size` are then the data axis's, read from `data_group`; the 1-D mesh is
the case `tp_size == 1`, whose data group is the default group (`None` to
torch.distributed).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rows of every global batch that rank `rank` of `size` holds, for a step that
    splits the batch into `accum_steps` micro-batches."""

    rank: int = 0
    size: int = 1
    accum_steps: int = 1

    def micro_range(self, micro: int) -> tuple:
        """This rank's rows [lo, hi) of a micro-batch of `micro` rows."""
        return -(-self.rank * micro // self.size), -(-(self.rank + 1) * micro // self.size)

    def count(self, batch: int) -> int:
        """How many rows of a global batch of `batch` rows this rank holds."""
        if batch % self.accum_steps:
            raise ValueError(f"batch {batch} does not split into {self.accum_steps} micro-batches")
        lo, hi = self.micro_range(batch // self.accum_steps)
        return self.accum_steps * (hi - lo)

    def take(self, x):
        """This rank's rows of the global batch `x` (a numpy array or a tensor, the batch
        on its leading axis), micro-batch by micro-batch."""
        batch, rest = x.shape[0], tuple(x.shape[1:])
        n = self.count(batch)
        micro = batch // self.accum_steps
        lo, hi = self.micro_range(micro)
        return x.reshape((self.accum_steps, micro) + rest)[:, lo:hi].reshape((n,) + rest)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the mesh: its rank on the data axis and the axis's size,
    the device it computes on, and, on a 2-D mesh, the groups of its data and model axes
    and its rank on the model axis. A group of None is the default group."""

    rank: int
    size: int
    device: torch.device
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None
    tp_rank: int = 0
    tp_size: int = 1

    def shard(self, accum_steps: int = 1) -> RowShard:
        return RowShard(self.rank, self.size, accum_steps)


def make_mesh(num_devices: Optional[int] = None, device: Optional[torch.device] = None) -> Mesh:
    """The mesh of the initialised default process group (parallel/multihost.py).

    `num_devices`, where given, must be the group's size. The device defaults to the
    current CUDA device under NCCL and to the CPU otherwise; ranks of a gloo group may
    share one CUDA device, which the caller then names.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.multihost.initialize_distributed)")
    size = dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"a mesh of {num_devices} devices asked for in a group of {size} processes")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(rank=dist.get_rank(), size=size, device=torch.device(device))


def shard_batch(batch: Dict[str, Any], mesh: Mesh, accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows of every array of a global batch, as tensors on the mesh's device."""
    shard = mesh.shard(accum_steps)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        out[k] = shard.take(t).to(mesh.device)
    return out


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
