"""PyTorch + CUDA port of the SSD object-detection framework, for NVIDIA Hopper.

`ssd_object_detection_tpu/` (JAX) stays beside this package as the reference. The
port keeps its sub-layout and module names, so each counterpart is easy to find:

  ops/        anchors (numpy copy), boxes, matching (build_targets: kernel for CUDA
              tensors, plain matcher for CPU ones), plain_matcher (batched greedy
              matcher), cuda_matcher (wrapper of the hand-written CUDA matcher in csrc/),
              nms, preprocess (canvas resize), conv3x3 (fused conv op; its CUDA kernel's
              wrapper is cuda_conv), quant (int8 post-training quantization; its CUDA
              kernels, plain version and `ssd_torch::int8_conv` operator are cuda_int8),
              _cuda_build (nvcc + ctypes for every csrc/ kernel)
  models/     VGG-16, ResNet-34 and MobileNetV2 trunks, SSD pyramid/heads (six specs and
              the micro stem), flax <-> torch parameter conversion and the `.msgpack`
              weights file both packages read and write, the Keras .h5 import
  losses.py   MultiBox loss, reference and canonical modes
  train/      schedules, per-tensor clip, optimizers, train step, checkpoints, Trainer
  eval/       predict (fused and plain detect), coco_map (numpy copy), runner
  data/       COCO index, decode pipeline, host augmentation, packed cache and
              synthetic dataset (numpy/cv2 copies), device_prefetch (pinned memory,
              a side stream)
  utils/      device selection, msgpack reader/writer (no msgpack package), viz panels
  cli/        `python -m ssd_object_detection_tpu_torch.cli.train <config.yml>`,
              `python -m ssd_object_detection_tpu_torch.cli.eval <config.yml> --weights W`,
              `python -m ssd_object_detection_tpu_torch.cli.eval_synthetic`, and serve,
              export, infer; `--ptq` runs eval, serving and export int8

Public functions keep the JAX layouts: images NHWC (B, S, S, 3), boxes cxcywh
(..., 4), head outputs (B, D, 4) / (B, D, C). The package needs torch, numpy and
yaml; cv2 (decoding), tensorboard and tqdm are used where installed. It never imports
jax or the JAX package.
"""

__version__ = "0.1.0"
