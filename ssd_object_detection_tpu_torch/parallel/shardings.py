"""The 2-D (data x model) mesh: data parallelism with the wide convs split over a model
axis. Port of ssd_object_detection_tpu/parallel/shardings.py.

The JAX package places parameters on a (data, model) device mesh and lets GSPMD insert
the collectives. Here each rank is a process, and what GSPMD inserted is spelt out:

  - `make_2d_mesh(dp, tp)`: global rank g = d * tp + m is data rank d and model rank m,
    the layout of `np.asarray(devices).reshape(dp, tp)`. The ranks of one m form a data
    group, the ranks of one d a model group. Every rank creates every group, in the same
    order, those it is not in included: `dist.new_group` is collective over the default
    group;
  - `shard_params_tp`: each eligible conv becomes a `ColumnParallelConv2d` holding output
    channels [m*OC/tp, (m+1)*OC/tp) of its weight and bias. Its forward is Megatron's
    column-parallel layer: `copy_to_model` of the input (the backward sums the input's
    gradient over the model group), the conv with the shard, and `gather_channels` of
    the output (the backward keeps this rank's channels), so every layer after it sees
    full channels;
  - `shard_state_tp`: the same for a TrainState, slicing the existing Adam moments of each
    sharded parameter and keeping the step count (a new optimizer would reset them);
  - `shard_batch_2d`: this data rank's rows; the model ranks of one data rank hold the same
    rows;
  - `unshard_state_dict`: the shards all-gathered into the one-process state dict.

The train step (train/step.py) and the loss (losses.py) reduce over the data group only:
on the default group the tp copies of each row would count tp times. The per-tensor clip
takes a sharded tensor's norm over the whole tensor, its shards' squares summed over the
model group (train/optim.py).

Placement against JAX's rule (`shard_params_tp` there, :33-49): JAX shards every leaf
whose last dim has at least `min_channels` entries and divides by tp, which also takes
GroupNorm's affine parameters and grouped (depthwise) kernels. The port shards dense conv
kernels (OIHW dim 0, `groups == 1`) with their biases, and keeps GroupNorm and depthwise
convs replicated. No number changes: a column-parallel conv gathers its output at once,
so what follows it runs on full channels either way, and the clip's norm is the whole
tensor's in both. At 81 classes SSD300's conf heads have 324 and 486 output channels (4
and 6 anchors), so they are column-parallel at tp 2; the loc heads (16 and 24) are not.

Tensor parallelism has no payoff at SSD's size (parallel/mesh.py of the JAX package):
this is the JAX package's 2-D mesh leg, ported for parity.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ssd_object_detection_tpu_torch.models.vgg import float_conv
from ssd_object_detection_tpu_torch.parallel.collectives import copy_to_model, gather_channels
from ssd_object_detection_tpu_torch.parallel.mesh import Mesh, shard_batch


def make_2d_mesh(dp: int, tp: int, device: Optional[torch.device] = None) -> Mesh:
    """This rank's place on a (dp, tp) grid over the initialised default group of dp * tp
    processes. The device defaults as in parallel/mesh.py::make_mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_2d_mesh needs an initialised process group "
                           "(parallel.multihost.initialize_distributed)")
    world = dist.get_world_size()
    if world != dp * tp:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} processes; the group has {world}")
    d, m = divmod(dist.get_rank(), tp)
    data_group = model_group = None
    for mm in range(tp):  # every rank makes every group, in this order
        group = dist.new_group([dd * tp + mm for dd in range(dp)])
        if mm == m:
            data_group = group
    for dd in range(dp):
        group = dist.new_group([dd * tp + mm for mm in range(tp)])
        if dd == d:
            model_group = group
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(rank=dist.get_rank(data_group), size=dist.get_world_size(data_group),
                device=torch.device(device), data_group=data_group, model_group=model_group,
                tp_rank=dist.get_rank(model_group), tp_size=dist.get_world_size(model_group))


def tp_eligible(conv: nn.Module, tp: int, min_channels: int) -> bool:
    """Whether a conv splits its output channels over `tp` model ranks: a dense
    `nn.Conv2d` (groups 1) with at least `min_channels` output channels, divisible by tp."""
    return (type(conv) is nn.Conv2d and conv.groups == 1 and conv.out_channels >= min_channels
            and conv.out_channels % tp == 0)


class ColumnParallelConv2d(nn.Module):
    """An `nn.Conv2d` whose output channels are split over the model axis: this rank holds
    channels [tp_rank * OC / tp, (tp_rank + 1) * OC / tp) of the weight and bias. Its
    output, gathered over the model group, is the whole conv's."""

    def __init__(self, conv: nn.Conv2d, mesh: Mesh):
        super().__init__()
        if not tp_eligible(conv, mesh.tp_size, 1):
            raise ValueError(f"{conv} does not split over {mesh.tp_size} model ranks")
        per = conv.out_channels // mesh.tp_size
        lo = mesh.tp_rank * per
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.kernel_size, self.stride, self.dilation, self.groups = (
            conv.kernel_size, conv.stride, conv.dilation, conv.groups)
        self.weight = nn.Parameter(conv.weight.detach()[lo:lo + per].clone())
        self.bias = (nn.Parameter(conv.bias.detach()[lo:lo + per].clone())
                     if conv.bias is not None else None)
        self.group = mesh.model_group
        self.shard = (lo, lo + per)

    def conv_nchw(self, x: torch.Tensor, pads: Tuple[int, int, int, int],
                  dtype: torch.dtype) -> torch.Tensor:
        """models/vgg.py's conv hook: f, the conv with this rank's channels, g."""
        return gather_channels(float_conv(copy_to_model(x, self.group), self, pads, dtype), self.group)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, "
                f"stride={self.stride}, channels [{self.shard[0]}, {self.shard[1]}) here")


def sharded_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The parameters of `model` that hold a shard (those of its ColumnParallelConv2d)."""
    return [p for m in model.modules() if isinstance(m, ColumnParallelConv2d) for p in m.parameters()]


def _set_module(model: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, leaf, module)


def shard_params_tp(model: nn.Module, mesh: Mesh, min_channels: int = 256) -> List[str]:
    """Replace, in place, every conv of `model` that `tp_eligible` takes with a
    ColumnParallelConv2d of this rank's channels; returns their names in module order.
    Replicate the model (parallel/mesh.py::replicate) before, not after: the shards
    differ between model ranks."""
    names = [name for name, m in model.named_modules()
             if tp_eligible(m, mesh.tp_size, min_channels)]
    for name in names:
        _set_module(model, name, ColumnParallelConv2d(model.get_submodule(name), mesh))
    return names


def shard_state_tp(state, mesh: Mesh, min_channels: int = 256) -> List[str]:
    """`shard_params_tp` on a TrainState's model; every optimizer entry of a sharded
    parameter moves to its shard, its moments sliced to the same channels (tensors shaped
    like the parameter; the step count is kept). Returns the sharded names."""
    before = dict(state.model.named_parameters())
    names = shard_params_tp(state.model, mesh, min_channels)
    after = dict(state.model.named_parameters())
    moved = {}
    for name in names:
        shard = state.model.get_submodule(name).shard
        for leaf in ("weight", "bias"):
            key = f"{name}.{leaf}"
            if key in before:
                moved[before[key]] = (after[key], shard)
    opt = state.optimizer
    for group in opt.param_groups:
        group["params"] = [moved[p][0] if p in moved else p for p in group["params"]]
    for old, (new, (lo, hi)) in moved.items():
        if old in opt.state:
            opt.state[new] = {k: v[lo:hi].clone() if isinstance(v, torch.Tensor)
                              and v.shape == old.shape else v
                              for k, v in opt.state.pop(old).items()}
    return names


def shard_batch_2d(batch: Dict[str, Any], mesh: Mesh, accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """This data rank's rows of a global batch (the same on every model rank), as tensors
    on the mesh's device."""
    return shard_batch(batch, mesh, accum_steps)


def unshard_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The model's state dict with every shard all-gathered over the model group: the
    keys and shapes of the model before `shard_params_tp`. Every model rank calls it."""
    state = model.state_dict()
    for name, module in model.named_modules():
        if isinstance(module, ColumnParallelConv2d):
            for leaf, p in module.named_parameters():
                parts = [torch.empty_like(p) for _ in range(mesh.tp_size)]
                dist.all_gather(parts, p.detach().contiguous(), group=mesh.model_group)
                state[f"{name}.{leaf}"] = torch.cat(parts)
    return state
