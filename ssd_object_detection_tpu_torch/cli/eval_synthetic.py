"""mAP gate: train an SSD on the hermetic synthetic dataset, evaluate COCO-style mAP on a
held-out split, and print one JSON line with the gate `mAP@0.5 > --gate`.

Counterpart of tools/eval_synthetic.py (every variant of models/ssd.py::MODEL_SPECS),
with the same flags, defaults and recipe: 256 train and 64 val synthetic images (seeds 0 and 999), max_gt 8,
8 classes, a 100-step warmup on its own Adam optimizer (polynomial 1e-6 -> lr), then 1500
steps on a fresh one (exponential decay 200 / 0.97), batch 32, bf16 compute; the
predict path at score_thresh 0.05 and the COCO evaluator. The datasets live on the
device as uint8 and each step slices its batch there.

    python -m ssd_object_detection_tpu_torch.cli.eval_synthetic [--steps 1500] [--out FILE]

`--device` (default cuda; raises without a GPU) is the one flag the JAX tool lacks. No
file is written unless `--out` is given. `--save-weights FILE` exports the trained
weights as `.msgpack` (the JAX tool's format, models/convert.py); `--load-weights FILE`
loads such a file, from either package, and skips training. `--ptq` also evaluates the
int8 path (ops/quant.py) on the same weights and val split, calibrated on 4 train
batches: "ptq" (heads float) and "ptq_heads" (heads int8 too), each gated by its mAP@0.5
drop against float <= `--ptq-max-drop` (0.02), and `pass` needs every gate.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu_torch.eval.predict import make_predict_fn
from ssd_object_detection_tpu_torch.eval.runner import evaluate_batches
from ssd_object_detection_tpu_torch.models.convert import load_params_msgpack, save_params_msgpack
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.ops.quant import quantize_ssd
from ssd_object_detection_tpu_torch.train.optim import (
    exponential_decay,
    make_optimizer,
    polynomial_decay,
)
from ssd_object_detection_tpu_torch.train.step import StepConfig, create_train_state, make_train_step
from ssd_object_detection_tpu_torch.utils.device import resolve_device, true_divide

NUM_CLASSES = 8
MAX_GT = 8


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="synthetic mAP gate (PyTorch port)")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-train", type=int, default=256)
    p.add_argument("--num-val", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--decay-steps", type=int, default=200,
                   help="ExponentialDecay step interval for the main phase")
    p.add_argument("--decay-rate", type=float, default=0.97,
                   help="ExponentialDecay rate for the main phase")
    p.add_argument("--out", type=str, default=None, help="also write the result here")
    p.add_argument("--gate", type=float, default=0.9)
    p.add_argument("--variant", type=str, default="ssd300",
                   help=f"a model spec of models/ssd.py::MODEL_SPECS: {', '.join(MODEL_SPECS)}")
    p.add_argument("--canonical", action="store_true",
                   help="train and decode in canonical SSD-paper mode (smooth-L1, "
                   "per-image mining, 0.1/0.2 encoding variances)")
    p.add_argument("--ptq", action="store_true",
                   help="also evaluate int8 PTQ (heads float, and heads int8) on the same "
                   "weights, calibrated on 4 train batches")
    p.add_argument("--ptq-max-drop", type=float, default=0.02,
                   help="with --ptq: the largest mAP@0.5 drop against float that passes")
    p.add_argument("--save-weights", type=str, default=None,
                   help="export the trained weights to this .msgpack file")
    p.add_argument("--load-weights", type=str, default=None,
                   help="evaluate the weights in this .msgpack file; training is skipped")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    return p


def _on_device(ds: SyntheticDetectionDataset, device: torch.device) -> Dict[str, torch.Tensor]:
    """The whole dataset as device tensors, images uint8 (one host-to-device copy each)."""
    samples = [ds.sample(i) for i in range(ds.num_images)]
    host = {
        "image": np.stack([np.round(s[0] * 255).astype(np.uint8) for s in samples]),
        "gt_cls": np.stack([s[1] for s in samples]),
        "gt_boxes": np.stack([s[2] for s in samples]),
        "gt_valid": np.stack([s[3] for s in samples]),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def _train(args, model, train_step, batch_at, device: torch.device) -> float:
    """The JAX tool's recipe: a warmup phase on its own Adam optimizer, then the main
    phase on a fresh one. Returns the training seconds."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    # warmup phase with its own optimizer (the reference's two-optimizer warmup)
    state = create_train_state(model, make_optimizer("adam", model.parameters()),
                               polynomial_decay(1e-6, args.warmup, args.lr))
    metrics = {}
    for i in range(args.warmup):
        metrics = train_step(state, batch_at(i))
    if metrics:
        print(f"warmup done: loss {float(metrics['loss']):.3f}", flush=True)

    state = create_train_state(model, make_optimizer("adam", model.parameters()),
                               exponential_decay(args.lr, args.decay_steps, args.decay_rate))
    for i in range(args.steps):
        metrics = train_step(state, batch_at(i))
        if (i + 1) % 200 == 0:
            print(f"step {i + 1}/{args.steps}: loss {float(metrics['loss']):.3f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time() - t0


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parser().parse_args(argv)
    if args.variant not in MODEL_SPECS:
        raise ValueError(f"unknown --variant {args.variant!r}; expected one of {sorted(MODEL_SPECS)}")
    device = resolve_device(args.device)
    spec = MODEL_SPECS[args.variant]
    img = spec.image_size

    train = _on_device(SyntheticDetectionDataset(
        num_images=args.num_train, image_size=img, max_gt=MAX_GT, num_classes=NUM_CLASSES, seed=0,
    ), device)
    val = _on_device(SyntheticDetectionDataset(
        num_images=args.num_val, image_size=img, max_gt=MAX_GT, num_classes=NUM_CLASSES, seed=999,
    ), device)

    variances = (0.1, 0.2) if args.canonical else None
    step_cfg = StepConfig(canonical_loss=args.canonical, variances=variances)
    model = SSD(num_classes=NUM_CLASSES + 1, spec=spec, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(device)
    anchors = generate_anchors(spec.anchor_spec)
    train_step = make_train_step(anchors, step_cfg)

    bs = args.batch_size
    n_batches = args.num_train // bs

    def batch_at(step: int) -> Dict[str, torch.Tensor]:
        i = (step % n_batches) * bs
        return {k: v[i:i + bs] for k, v in train.items()}

    if args.load_weights:
        load_params_msgpack(model, args.load_weights)
        train_secs = 0.0
        print(f"loaded trained weights from {args.load_weights} (training skipped)", flush=True)
    else:
        train_secs = _train(args, model, train_step, batch_at, device)
        if args.save_weights:
            save_params_msgpack(model, args.save_weights)
            print(f"trained weights exported to {args.save_weights}", flush=True)

    # evaluate the held-out split with the predict path and the full evaluator
    def run_eval(eval_model) -> Dict[str, float]:
        predict = make_predict_fn(eval_model, anchors, variances=variances, score_thresh=0.05)
        val_batches = (
            {"image": val["image"][b0:b0 + bs],
             **{k: val[k][b0:b0 + bs].cpu().numpy() for k in ("gt_cls", "gt_boxes", "gt_valid")}}
            for b0 in range(0, args.num_val, bs)
        )
        return evaluate_batches(predict, val_batches, num_classes=NUM_CLASSES)

    metrics = run_eval(model)

    ptq_results = {}  # "ptq": heads float; "ptq_heads": heads int8 too
    if args.ptq:
        # calibrated on TRAIN batches, normalized as predict feeds the model
        calib = [(true_divide(train["image"][i * bs:(i + 1) * bs].float(), 255.0) - 0.5) * 2.0
                 for i in range(min(4, n_batches))]
        for key, include_heads in (("ptq", False), ("ptq_heads", True)):
            q_model, qspec = quantize_ssd(model, calib, include_heads=include_heads)
            print(f"{key}: quantized {len(qspec)} convs: {sorted(qspec)}", flush=True)
            ptq_results[key] = run_eval(q_model)
            print(f"{key}: float mAP@0.5 {metrics['mAP@0.5']:.4f} -> int8 "
                  f"{ptq_results[key]['mAP@0.5']:.4f}", flush=True)
            del q_model

    result = {
        "dataset": "synthetic (hermetic; data/synthetic.py)",
        "model": f"{args.variant} bf16" + (" (canonical loss/encoding)" if args.canonical else ""),
        "train": {"warmup": args.warmup, "steps": args.steps, "batch_size": bs, "lr": args.lr,
                  "decay": [args.decay_steps, args.decay_rate], "images": args.num_train,
                  "seconds": train_secs},
        "val_images": args.num_val,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "mAP": float(metrics["mAP"]),
        "mAP@0.5": float(metrics["mAP@0.5"]),
        "train_seconds": train_secs,
        "gate": f"mAP@0.5 > {args.gate}",
        "pass": bool(metrics["mAP@0.5"] > args.gate),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    for key, ptq_metrics in ptq_results.items():
        drop = float(metrics["mAP@0.5"]) - float(ptq_metrics["mAP@0.5"])
        result[key] = {
            "metrics": {k: float(v) for k, v in ptq_metrics.items()},
            "mAP50_drop_vs_float": drop,
            "gate": f"drop <= {args.ptq_max_drop}",
            "pass": bool(drop <= args.ptq_max_drop),
        }
        result["pass"] = bool(result["pass"] and result[key]["pass"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
