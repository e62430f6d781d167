"""Schedules, per-tensor clip and optimizer factory, port of ssd_object_detection_tpu/train/optim.py.

The schedules are the TF formulas the JAX package uses, evaluated in float32 like
its jnp versions. As with optax, a schedule is read at the optimizer's count BEFORE
the update: the train step sets the learning rate to `schedule(step)` right before
each `optimizer.step()` (train/step.py).

Adam: optax and torch.optim.Adam apply the same update,
mu_hat / (sqrt(nu_hat) + eps) with bias-corrected moments and eps added outside the
square root; tests/test_torch_train_step.py holds the two together over several
steps. The clip is per tensor (tf.clip_by_norm on each gradient), not
torch.nn.utils.clip_grad_norm_, which clips the global norm.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

Schedule = Callable[[int], float]


def exponential_decay(initial: float, decay_steps: int, decay_rate: float, staircase: bool = False) -> Schedule:
    """tf.keras ExponentialDecay: initial * rate^(step/decay_steps)."""

    def schedule(step: int) -> float:
        p = np.float32(step) / np.float32(decay_steps)
        if staircase:
            p = np.floor(p)
        return float(np.float32(initial) * np.power(np.float32(decay_rate), p))

    return schedule


def polynomial_decay(start: float, decay_steps: int, end: float, power: float = 1.0) -> Schedule:
    """tf.keras PolynomialDecay: (start - end) * (1 - min(step, N)/N)^power + end."""

    def schedule(step: int) -> float:
        frac = np.clip(np.float32(step) / np.float32(decay_steps), np.float32(0), np.float32(1))
        scale = np.power(np.float32(1) - frac, np.float32(power))
        return float(np.float32(start - end) * scale + np.float32(end))

    return schedule


@torch.no_grad()
def clip_by_norm_per_tensor(grads: Iterable[torch.Tensor], max_norm: float = 0.01) -> None:
    """tf.clip_by_norm on each tensor, in place: g * max_norm / max(||g||_2, max_norm)."""
    for g in grads:
        norm = g.float().square().sum().sqrt()
        # a tensor numerator: `float / tensor` is a multiply by the reciprocal (two roundings)
        g.mul_(torch.full_like(norm, max_norm) / torch.clamp(norm, min=max_norm))


def make_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    beta_1: float = 0.9,
    beta_2: float = 0.999,
    epsilon: float = 1e-7,
    momentum: float = 0.0,
) -> torch.optim.Optimizer:
    """Adam/SGD factory. TF Adam's default epsilon is 1e-7. The learning rate is set
    by the train step from its schedule before every update."""
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(beta_1, beta_2), eps=epsilon)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum)
    raise ValueError(f"unknown optimizer {name!r}; expected 'adam' or 'sgd'")
