"""Fused 3x3 SAME conv + bias (+ReLU) (+2x2/s2 max-pool), port of ssd_object_detection_tpu/ops/pallas_conv.py.

`conv3x3_bias_relu(x, kernel, bias, relu=True, pool=False)` is the public op, with the
JAX layouts: x (B, H, W, IC) NHWC, kernel (3, 3, IC, OC) HWIO, bias (OC,). Its forward
launches the hand-written CUDA kernel (ops/cuda_conv.py, csrc/conv3x3.cu) for CUDA
tensors and runs the plain version for CPU tensors, through the operator
`torch.ops.ssd_torch.conv3x3_bias_relu`. Its backward is autograd of the plain version,
recomputed from the saved (x, kernel, bias), as the JAX op's custom VJP is the VJP of its
XLA reference.

No model calls this op, as in the JAX package (docs/DESIGN.md): the port's VGG keeps
F.conv2d. The JAX row-tile picker (`_pick_row_tile`) sizes the TPU's VMEM and has no
counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssd_object_detection_tpu_torch.ops.cuda_conv import conv3x3_forward_cuda


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  relu: bool = True, pool: bool = False) -> torch.Tensor:
    """The plain version, in the order of the JAX `_conv3x3_xla`: the kernel cast to
    x.dtype, the products summed in float32 (bf16 values are exact in float32), the
    float32 bias, the optional ReLU, a cast to x.dtype, then the optional pool."""
    _, h, w, _ = x.shape
    if pool and (h % 2 or w % 2):
        raise ValueError(f"2x2/s2 pool needs even H and W, got {h}x{w}")
    weight = kernel.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x.float().permute(0, 3, 1, 2), weight, padding=1)
    y = y + bias.float()[:, None, None]
    if relu:
        y = torch.relu(y)
    y = y.to(x.dtype)
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return y.permute(0, 2, 3, 1).contiguous()


@torch.library.custom_op("ssd_torch::conv3x3_bias_relu", mutates_args=())
def conv3x3_op(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, relu: bool,
               pool: bool) -> torch.Tensor:
    """The forward as an operator (utils/introspect.py counts its FLOPs): the plain version
    for a CPU tensor, the CUDA wrapper (which refuses what is not on the card) otherwise."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, kernel, bias, relu, pool)
    return conv3x3_forward_cuda(x, kernel, bias, relu, pool)


class _Conv3x3BiasRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, relu, pool):
        ctx.save_for_backward(x, kernel, bias)
        ctx.relu, ctx.pool = relu, pool
        if x.device.type not in ("cpu", "cuda"):  # the wrapper refuses it
            return conv3x3_forward_cuda(x, kernel, bias, relu, pool)
        return torch.ops.ssd_torch.conv3x3_bias_relu(x, kernel, bias, relu, pool)

    @staticmethod
    def backward(ctx, grad):
        x, kernel, bias = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip((x, kernel, bias), ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            y = conv3x3_plain(*leaves, ctx.relu, ctx.pool)
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, grad)) if wanted else iter(())
        return (*(next(grads) if t.requires_grad else None for t in leaves), None, None)


def conv3x3_bias_relu(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                      relu: bool = True, pool: bool = False) -> torch.Tensor:
    """Fused 3x3 SAME conv + bias (+ReLU) (+2x2/s2 max-pool): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; gradients from the plain version."""
    return _Conv3x3BiasRelu.apply(x, kernel, bias, relu, pool)
