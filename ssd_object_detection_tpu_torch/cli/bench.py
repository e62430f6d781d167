"""Benchmark harness: prints ONE JSON line with the headline metric. Port of bench.py.

Headline: SSD300-VGG16 fused end-to-end inference images/sec on one GPU. uint8 camera-size
canvases in, detections out: on-device resize, normalise, forward, softmax, decode and
class-aware NMS (eval/predict.py::make_fused_predict_fn), batch 32, in the serving
precision: int8 PTQ on the eligible convs, the loc/conf heads included
(ops/quant.py::quantize_synthetic, the int8 kernels of csrc/int8_conv.cu), bf16 elsewhere.
The bf16 path is timed the same way and reported in the same line
(`bf16_images_per_sec`). As in the JAX harness:
  - conf logits stay bf16 through the ranking (SSD conf_f32=False);
  - nms_mode="merged_top2": per-anchor top-2 class candidates ahead of the global pool;
  - the quantization scales are synthetic (random weights carry no calibratable signal;
    int8 throughput does not depend on the scales). The accuracy evidence uses
    calibrated scales: `cli.eval_synthetic --ptq`;
  - inputs: 16 distinct batches of 480x640 uint8 images, each in a 640x640 planar
    canvas, put on the device before timing.

Timing: 3 warm-up rounds, then 4 timed rounds; a round enqueues the 16 batches and reads
nothing back, and one `torch.cuda.synchronize()` ends the window. PTQ discovery and
quantization happen before the warm-up. On the card the timed window runs under
`torch.cuda.set_sync_debug_mode("error")`, so a host read inside it fails the run.

vs_baseline divides by 2,000 img/s, the JAX harness's anchor: an estimate of optimised
(TensorRT-class) A100 SSD300-VGG16 batch-32 inference throughput, not a measurement, and
not a TPU figure. The line also names the device and, on a GPU, its power limit
(nvidia-smi), which every figure needs beside it.

    python -m ssd_object_detection_tpu_torch.cli.bench [--batch 32] [--pipeline 16]
        [--warmup 3] [--iters 4] [--variant ssd300] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ssd_object_detection_tpu_torch.eval.predict import make_fused_predict_fn
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.ops.preprocess import pack_canvas
from ssd_object_detection_tpu_torch.ops.quant import quantize_synthetic
from ssd_object_detection_tpu_torch.utils.device import resolve_device

A100_SSD300_INFER_IMG_PER_SEC = 2000.0  # an A100 estimate (see the docstring), not measured

BATCH = 32
PIPELINE = 16  # distinct batches a round enqueues
WARMUP_ITERS = 3
BENCH_ITERS = 4  # timed rounds: BENCH_ITERS * PIPELINE batches


def power_limit(device: torch.device) -> Optional[str]:
    """The card's power limit as nvidia-smi reports it ("700.00 W"), None off the GPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[device.index or 0]


def images_per_sec(predict: Callable, canvases: torch.Tensor, sizes: torch.Tensor, warmup: int,
                   iters: int) -> float:
    """img/s of `predict` over rounds of every batch of `canvases` (P, B, 3, Hc, Wc)."""
    device = canvases.device

    def one_round():
        for i in range(canvases.shape[0]):
            predict(canvases[i], sizes[i])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        one_round()
    sync()
    if device.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            one_round()
        sync()
        seconds = time.perf_counter() - t0
    finally:
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    return canvases.shape[0] * canvases.shape[1] * iters / seconds


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description="fused SSD inference img/s, int8 PTQ and bf16 (PyTorch port)")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--pipeline", type=int, default=PIPELINE, help="distinct batches a round enqueues")
    p.add_argument("--warmup", type=int, default=WARMUP_ITERS)
    p.add_argument("--iters", type=int, default=BENCH_ITERS, help="timed rounds")
    p.add_argument("--variant", default="ssd300", help="a key of models/ssd.py::MODEL_SPECS")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    spec = MODEL_SPECS[args.variant]
    size = spec.image_size
    model = SSD(num_classes=81, spec=spec, dtype=torch.bfloat16, conf_f32=False)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(device).eval()
    anchors = generate_anchors(spec.anchor_spec)
    qmodel, _ = quantize_synthetic(model, (args.batch, size, size, 3), include_heads=True)

    rng = np.random.default_rng(0)
    packed = [pack_canvas([rng.integers(0, 256, (480, 640, 3), np.uint8) for _ in range(args.batch)])
              for _ in range(args.pipeline)]
    canvases = torch.from_numpy(np.stack([c for c, _ in packed])).to(device)  # (P, B, 3, Hc, Wc)
    sizes = torch.from_numpy(np.stack([s for _, s in packed])).to(device)  # (P, B, 2)

    def measure(m) -> float:
        predict = make_fused_predict_fn(m, anchors, image_size=size, nms_mode="merged_top2")
        return images_per_sec(predict, canvases, sizes, args.warmup, args.iters)

    int8_ips = measure(qmodel)
    bf16_ips = measure(model)
    result = {
        "metric": f"{args.variant}_fused_e2e_infer_images_per_sec_per_chip",
        "value": round(int8_ips, 1),
        "unit": "images/sec",
        "vs_baseline": round(int8_ips / A100_SSD300_INFER_IMG_PER_SEC, 3),
        "precision": "int8-ptq convs, heads included (accuracy gate: cli.eval_synthetic --ptq), bf16 elsewhere",
        "bf16_images_per_sec": round(bf16_ips, 1),
        "bf16_vs_baseline": round(bf16_ips / A100_SSD300_INFER_IMG_PER_SEC, 3),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "power_limit": power_limit(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
