"""Device selection for the port's entry points, and a division that rounds alike on every device."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the GPU unless the caller asks for the CPU.

    Raises when a CUDA device is asked for and none is present; there is no silent
    fallback to the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor, correctly rounded on every device.

    PyTorch's CUDA kernels divide by a Python or CPU scalar as a multiply by its
    reciprocal, which is one ulp off the true quotient for about half of all inputs
    (for example uint8 / 255). The JAX package and PyTorch's CPU kernels divide; a
    divisor tensor on x's device makes the CUDA kernel divide too.
    """
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)
