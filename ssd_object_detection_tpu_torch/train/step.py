"""The SSD train step, port of ssd_object_detection_tpu/train/step.py.

One call: scale the images (uint8 is scaled on the device) -> build targets under
no_grad through the matcher dispatch (the CUDA kernel on the card) -> forward ->
MultiBox loss -> backward -> per-tensor clip at 0.01 of EACH micro-batch's gradients
-> sum / accum_steps -> learning rate = schedule(step) -> optimizer update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ssd_object_detection_tpu_torch.losses import LossInfo, multibox_loss
from ssd_object_detection_tpu_torch.ops.matching import build_targets
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
    augment: Optional[Any] = None  # on-device augmentation is not ported (ROADMAP A10)


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


def make_train_step(anchors: np.ndarray, cfg: StepConfig = StepConfig()) -> Callable:
    """Returns train_step(state, batch) -> metrics dict of 0-d tensors (no host sync).

    batch: {"image": (B,S,S,3) float32 in [0,1] OR uint8 in [0,255], "gt_cls": (B,G)
    int32, "gt_boxes": (B,G,4) relative cxcywh float32, "gt_valid": (B,G) bool}, as
    numpy arrays or tensors; they are moved to the model's device.
    """
    if cfg.augment is not None:
        raise NotImplementedError("on-device augmentation is not ported yet (ROADMAP A10)")
    anchors_np = np.asarray(anchors, np.float32)
    anchors_on: Dict[torch.device, torch.Tensor] = {}

    def loss_for_micro(model, anchors_t, image, gt_cls, gt_boxes, gt_valid) -> LossInfo:
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
            neg_pos_ratio=cfg.neg_pos_ratio, canonical=cfg.canonical_loss,
        )

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        params = [p for p in state.model.parameters() if p.requires_grad]
        device = params[0].device
        if device not in anchors_on:
            anchors_on[device] = torch.as_tensor(anchors_np).to(device).contiguous()
        anchors_t = anchors_on[device]
        tensors = [torch.as_tensor(batch[k]).to(device, non_blocking=True) for k in BATCH_KEYS]
        if tensors[0].shape[0] % cfg.accum_steps:
            raise ValueError(f"batch {tensors[0].shape[0]} does not split into {cfg.accum_steps} micro-batches")
        micro_batches = zip(*(t.chunk(cfg.accum_steps) for t in tensors))

        sum_grads, sum_info = None, None
        for micro in micro_batches:
            info = loss_for_micro(state.model, anchors_t, *micro)
            grads = list(torch.autograd.grad(info.total, params))
            clip_by_norm_per_tensor(grads, cfg.clip_norm)
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
