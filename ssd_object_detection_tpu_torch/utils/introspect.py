"""Model introspection and profiling, port of ssd_object_detection_tpu/utils/introspect.py.

  - `param_summary`: the per-parameter table and total (the Keras summary's analog), in
    the JAX table's columns; its total equals JAX's for the same (converted) weights;
  - `flops_analysis`: the FLOPs of one call of a function, counted by
    `torch.utils.flop_counter.FlopCounterMode` while it runs once;
  - `trace`: `torch.profiler` around a region, written as a Chrome trace (chrome://tracing
    or Perfetto read it; the card has no TensorBoard).

The two FLOP counts differ in scope. XLA's cost analysis (the JAX package) counts every
operation of the compiled program, elementwise work and reductions included;
FlopCounterMode counts convolutions and matrix products only, through aten's formulas
and the two registered here for the port's own operators: `ssd_torch::int8_conv`
(ops/cuda_int8.py, the int8 conv of a PTQ model) and `ssd_torch::conv3x3_bias_relu`
(ops/conv3x3.py). FlopCounterMode does not look inside a custom operator, so without
these formulas a PTQ forward would count none of its int8 convs. A product counts 2
operations (multiply and add), as aten's convolution formula does.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from ssd_object_detection_tpu_torch.ops import conv3x3 as _conv3x3  # noqa: F401  registers the operators
from ssd_object_detection_tpu_torch.ops import cuda_int8 as _cuda_int8  # noqa: F401


def param_summary(model: nn.Module) -> str:
    """Human-readable per-parameter table (Keras model.summary() analog)."""
    rows: List[Tuple[str, str, int]] = [(name, str(tuple(p.shape)), p.numel())
                                        for name, p in model.named_parameters()]
    total = sum(r[2] for r in rows)
    width = max(len(r[0]) for r in rows) + 2
    lines = [f"{'param':<{width}}{'shape':<20}{'count':>12}", "-" * (width + 32)]
    for name, shape, count in rows:
        lines.append(f"{name:<{width}}{shape:<20}{count:>12,}")
    lines.append("-" * (width + 32))
    lines.append(f"{'TOTAL':<{width}}{'':<20}{total:>12,}")
    return "\n".join(lines)


@register_flop_formula(torch.ops.ssd_torch.int8_conv)
def _int8_conv_flop(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """w_q (OC, KH, KW, IC), NHWC output: 2 * B * Ho * Wo * OC * KH * KW * IC."""
    return 2 * math.prod(out_shape) * math.prod(w_shape[1:])


@register_flop_formula(torch.ops.ssd_torch.conv3x3_bias_relu)
def _conv3x3_flop(x_shape, kernel_shape, *args, out_shape=None, **kwargs) -> int:
    """kernel (3, 3, IC, OC) on NHWC x, counted before the optional pool: 2 * B * H * W *
    9 * IC * OC."""
    return 2 * math.prod(x_shape[:3]) * math.prod(kernel_shape)


def flops_analysis(fn: Callable, *example_args) -> Dict[str, float]:
    """{"flops": the convolution and matrix-product FLOPs of one call fn(*example_args)},
    counted while it runs (on the arguments' device)."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops())}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region (CPU, and the card where there is one) into
    `<log_dir>/trace.json`, a Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
