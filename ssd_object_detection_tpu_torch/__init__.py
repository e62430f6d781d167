"""PyTorch + CUDA port of the SSD object-detection framework, for NVIDIA Hopper.

`ssd_object_detection_tpu/` (JAX) stays beside this package as the reference. The
port keeps its sub-layout and module names, so each counterpart is easy to find:

  ops/        anchors (numpy copy), boxes, matching (build_targets: kernel for CUDA
              tensors, plain matcher for CPU ones), plain_matcher (batched greedy
              matcher), cuda_matcher (wrapper of the hand-written CUDA matcher in csrc/),
              nms, preprocess (canvas resize), conv3x3 (fused conv op; its CUDA kernel's
              wrapper is cuda_conv), _cuda_build (nvcc + ctypes for every csrc/ kernel)
  models/     VGG-16 trunk, SSD pyramid/heads, flax -> torch parameter conversion
  losses.py   MultiBox loss, reference and canonical modes
  train/      schedules, per-tensor clip, optimizers, train step, Trainer
  eval/       predict (fused and plain detect), coco_map (numpy copy), runner
  data/       synthetic dataset (numpy copy)
  cli/        `python -m ssd_object_detection_tpu_torch.cli.train <config.yml>`,
              `python -m ssd_object_detection_tpu_torch.cli.eval_synthetic`

Public functions keep the JAX layouts: images NHWC (B, S, S, 3), boxes cxcywh
(..., 4), head outputs (B, D, 4) / (B, D, C). The package imports torch, numpy and
yaml only; it never imports jax or the JAX package.
"""

__version__ = "0.1.0"
