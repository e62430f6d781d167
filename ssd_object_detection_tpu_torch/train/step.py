"""The SSD train step, port of ssd_object_detection_tpu/train/step.py.

One call: optional on-device augmentation of the whole batch (ops/augment.py) -> scale
the images (uint8 is scaled on the device) -> build targets under no_grad through the
matcher dispatch (the CUDA kernel on the card) -> forward -> MultiBox loss -> backward
-> per-tensor clip at 0.01 of EACH micro-batch's gradients -> sum / accum_steps ->
learning rate = schedule(step) -> optimizer update.

Augmentation draws come from a generator on the model's device, seeded from
(aug_seed, step): the counterpart of the JAX step's fold_in(PRNGKey(aug_seed), step).
Seeding reads nothing from the device, and a resumed run redraws the same
augmentation at the same step.

With a data-parallel `mesh` (parallel/mesh.py) the step computes what the JAX step computes
under GSPMD on the global batch, of which each rank is handed its rows (`shard_batch`):
every rank draws the augmentation of the whole global batch and keeps its rows' draws;
for each micro-batch it takes the gradient of its term of the global loss (losses.py),
sums the gradients over the ranks (one all-reduce per micro-batch, parallel/collectives.py),
and only then clips per tensor, as JAX clips the gradient of the global micro-batch. A
rank with no row of a micro-batch joins its collectives with a zero gradient and
launches no matcher. Every rank then applies the same update to the same parameters,
so parameters and optimizer state stay bit-equal across the ranks. DistributedDataParallel
is not used: it averages, and it reduces before the clip could see the sum.

On a 2-D mesh (parallel/shardings.py) the gradient sum runs over the data group (the model
ranks of a data rank hold the same rows), and the clip takes each sharded tensor's norm
over its model group; everything else is as above: sum, then clip, then accumulate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ssd_object_detection_tpu_torch.losses import LossInfo, multibox_loss
from ssd_object_detection_tpu_torch.ops import augment
from ssd_object_detection_tpu_torch.ops.matching import build_targets
from ssd_object_detection_tpu_torch.parallel.collectives import all_reduce_sum_
from ssd_object_detection_tpu_torch.parallel.shardings import sharded_parameters
from ssd_object_detection_tpu_torch.train.optim import Schedule, clip_by_norm_per_tensor
from ssd_object_detection_tpu_torch.utils.device import true_divide

BATCH_KEYS = ("image", "gt_cls", "gt_boxes", "gt_valid")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static knobs of the step (the JAX StepConfig's, less the TPU-only ones)."""

    match_thresh: float = 0.5
    neg_pos_ratio: float = 3.0
    canonical_loss: bool = False
    variances: Optional[Tuple[float, float]] = None
    clip_norm: float = 0.01
    accum_steps: int = 1  # split_train: batch_size // split_batch_size
    augment: Optional[augment.AugConfig] = None  # on-device augmentation; None = off
    aug_seed: int = 0


@dataclasses.dataclass
class TrainState:
    """What the JAX TrainState carries, in PyTorch form: the model holds the params,
    the optimizer its state, and `step` counts updates."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer, schedule: Schedule) -> TrainState:
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)


def step_seed(aug_seed: int, step: int) -> int:
    """The augmentation generator's seed at `step`: a 64-bit hash of (aug_seed, step)."""
    return int(np.random.SeedSequence([aug_seed, step]).generate_state(1, np.uint64)[0])


def make_train_step(anchors: np.ndarray, cfg: StepConfig = StepConfig(), mesh=None) -> Callable:
    """Returns train_step(state, batch, global_batch=None) -> metrics dict of 0-d tensors
    (no host sync).

    batch: {"image": (B,S,S,3) float32 in [0,1] OR uint8 in [0,255], "gt_cls": (B,G)
    int32, "gt_boxes": (B,G,4) relative cxcywh float32, "gt_valid": (B,G) bool}, as
    numpy arrays or tensors; they are moved to the model's device. With `mesh` the batch
    is this rank's rows of a global batch of `global_batch` rows (default: B on every
    rank), and the metrics are the global batch's.
    """
    if cfg.augment is not None and not isinstance(cfg.augment, augment.AugConfig):
        raise TypeError(f"StepConfig.augment takes an ops.augment.AugConfig, got {cfg.augment!r}")
    anchors_np = np.asarray(anchors, np.float32)
    anchors_on: Dict[torch.device, torch.Tensor] = {}
    generators: Dict[torch.device, torch.Generator] = {}
    shard = mesh.shard(cfg.accum_steps) if mesh is not None else None

    def loss_for_micro(model, anchors_t, image, gt_cls, gt_boxes, gt_valid, global_micro) -> LossInfo:
        if image.shape[0] == 0:  # no row of this micro-batch here: the loss's collectives only
            d = anchors_t.shape[0]
            zeros = anchors_t.new_zeros
            return multibox_loss(
                gt_cls.new_zeros((0, d)), zeros((0, d, 4)), gt_valid.new_zeros((0, d)),
                zeros((0, d, 4)), zeros((0, d, model.num_classes)),
                neg_pos_ratio=cfg.neg_pos_ratio, canonical=cfg.canonical_loss, mesh=mesh,
                global_batch=global_micro,
            )
        if image.dtype == torch.uint8:
            image = true_divide(image.float(), 255.0)
        image = (image - 0.5) * 2.0
        with torch.no_grad():
            t_cls, t_loc, t_mask = build_targets(
                gt_cls, gt_boxes, gt_valid, anchors_t, thresh=cfg.match_thresh,
                variances=cfg.variances,
            )
        pred_loc, pred_logits = model(image)
        return multibox_loss(
            t_cls, t_loc, t_mask, pred_loc, pred_logits,
            neg_pos_ratio=cfg.neg_pos_ratio, canonical=cfg.canonical_loss, mesh=mesh,
            global_batch=global_micro,
        )

    def train_step(state: TrainState, batch: Dict[str, Any],
                   global_batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        params = [p for p in state.model.parameters() if p.requires_grad]
        device = params[0].device
        sharded, model_group = None, None
        if mesh is not None and mesh.tp_size > 1:
            shards = set(sharded_parameters(state.model))
            sharded, model_group = [p in shards for p in params], mesh.model_group
        if device not in anchors_on:
            anchors_on[device] = torch.as_tensor(anchors_np).to(device).contiguous()
        anchors_t = anchors_on[device]
        tensors = [torch.as_tensor(batch[k]).to(device, non_blocking=True) for k in BATCH_KEYS]
        local = tensors[0].shape[0]
        if global_batch is None:
            global_batch = local * (mesh.size if mesh is not None else 1)
        if global_batch % cfg.accum_steps:
            raise ValueError(f"batch {global_batch} does not split into {cfg.accum_steps} micro-batches")
        if local != (shard.count(global_batch) if shard is not None else global_batch):
            raise ValueError(f"a batch of {local} rows is not this rank's share of a global "
                             f"batch of {global_batch} rows")
        if cfg.augment is not None:  # the whole batch, before the micro-batch split
            if device not in generators:
                generators[device] = torch.Generator(device=device)
            gen = generators[device]
            gen.manual_seed(step_seed(cfg.aug_seed, state.step))
            draws = augment.draw_augment(gen, global_batch, cfg.augment, device)
            if shard is not None:  # the global batch's draws, this rank's rows of them
                draws = augment.AugDraws(*(shard.take(d) for d in draws))
            image, gt_boxes, gt_cls, gt_valid = augment.augment_batch(
                tensors[0], tensors[2], tensors[1], tensors[3], cfg.augment, draws)
            tensors = [image, gt_cls, gt_boxes, gt_valid]
        micro_rows = local // cfg.accum_steps
        micro_batches = zip(*(t.reshape((cfg.accum_steps, micro_rows) + tuple(t.shape[1:])).unbind(0)
                              for t in tensors))

        sum_grads, sum_info = None, None
        for micro in micro_batches:
            info = loss_for_micro(state.model, anchors_t, *micro, global_batch // cfg.accum_steps)
            if micro_rows:  # in the parameters' layout (conv weight gradients come
                # channels-last), so the clip's norms sum in the same order on every rank
                grads = [g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)
                         for g, p in zip(torch.autograd.grad(info.total, params), params)]
            else:
                grads = [torch.zeros_like(p) for p in params]
            if mesh is not None:  # the global micro-batch's gradient, then its clip
                all_reduce_sum_(grads, mesh.data_group)
            clip_by_norm_per_tensor(grads, cfg.clip_norm, sharded, model_group)
            info = LossInfo(*(x.detach() for x in info))
            if sum_grads is None:
                sum_grads, sum_info = grads, info
            else:
                for acc, g in zip(sum_grads, grads):
                    acc.add_(g)
                sum_info = LossInfo(*(a + b for a, b in zip(sum_info, info)))
        if cfg.accum_steps > 1:  # a divisor tensor: the card divides as JAX does (true_divide)
            divisor = torch.full((), cfg.accum_steps, dtype=sum_grads[0].dtype, device=device)
            for g in sum_grads:
                g.div_(divisor)
            sum_info = LossInfo(*(true_divide(x, cfg.accum_steps) for x in sum_info))

        for p, g in zip(params, sum_grads):
            p.grad = g
        lr = state.schedule(state.step)  # optax reads the schedule at the pre-update count
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return {
            "loss": sum_info.total,
            "loc_loss": sum_info.loc,
            "cls_loss_pos": sum_info.cls_pos,
            "cls_loss_neg": sum_info.cls_neg,
            "num_positive": sum_info.num_positive,
        }

    return train_step
