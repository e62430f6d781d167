#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check every kernel on it.

Run from the root of a checkout: `python3 chip_smoke.py` (one card, no arguments).

  1. prints the card's name and power limit (nvidia-smi), builds the CUDA matcher
     from ssd_object_detection_tpu_torch/csrc/ (nvcc, sm_90a);
  2. holds the kernel against its plain PyTorch version on the card at the main path's
     shapes (SSD300 anchors D=8,732, B=32, G=100; all-valid, ~10 %-valid, zero-valid,
     duplicated-GT images, the reference's golden bipartite case, a synthetic batch,
     and SSD512's 24,564 anchors): gt_index, cls and mask bit-equal, box exactly
     equal; times both with CUDA events;
  3. the main path: SSD300-VGG16 train steps at full width (81 classes, bf16 compute,
     batch 32, max_gt 100, uint8 synthetic images, reference loss) through
     make_train_step; every launch count is set to 0 just before and read just after,
     and each kernel must have run once per step; losses finite, params changed, and
     build_targets through the kernel equal to the plain matcher on that batch;
  4. the Trainer through the CLI on config/synthetic.yml (warmup + 2 epochs): the
     kernel must have run once per micro-batch of the steps the config asks for, and
     it must equal the plain matcher on one of the Trainer's own batches;
  5. prints the kernels line, then as its last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

TF32 is off for the whole run (cuDNN and matmul), so float32 work is full float32; the
train step computes in bf16 by configuration. Any failure raises and exits non-zero
with no result line; so does a machine without a CUDA device or a directory without
the port package.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "ssd_object_detection_tpu_torch"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, NVIDIA data sheet
MATCHER_SOURCE = f"{PACKAGE}/csrc/matcher.cu"
MATCHER_REPLACES = "ssd_object_detection_tpu/ops/pallas_matcher.py:204"


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median time of one call of `fn` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def matcher_cases(np, anchors300, anchors512):
    """(name, (gt_cls, gt_boxes, gt_valid, anchors)) numpy cases for kernel vs plain."""
    from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset

    cases = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        batch, max_gt = 32, 100
        boxes = np.concatenate(
            [rng.uniform(0, 1, (batch, max_gt, 2)), rng.uniform(0.02, 0.6, (batch, max_gt, 2))], -1
        ).astype(np.float32)
        cls = rng.integers(0, 80, (batch, max_gt)).astype(np.int32)
        valid = rng.uniform(size=(batch, max_gt)) < rng.uniform(0.05, 1.0, (batch, 1))
        valid[0] = True  # all valid
        valid[1] = False  # zero valid
        valid[2] = rng.uniform(size=max_gt) < 0.1  # ~10 % valid
        boxes[3, 50:] = boxes[3, :50]  # duplicated GTs: ties must go to the lower row
        valid[3] = True
        cases.append((f"random_seed{seed}", (cls, boxes, valid, anchors300)))
    ds = SyntheticDetectionDataset(num_images=32, image_size=300, max_gt=100, num_classes=8, seed=7)
    b = next(ds.batches(32))
    cases.append(("synthetic_b32", (b["gt_cls"], b["gt_boxes"], b["gt_valid"], anchors300)))
    golden_anchors = np.float32([[10, 10, 1, 1], [20, 20, 1.1, 1.1], [20, 20, 0.5, 0.5]])
    cases.append(("golden", (np.int32([[0, 1]]), np.float32([[[15, 15, 13, 13], [15, 15, 14, 14]]]),
                             np.ones((1, 2), bool), golden_anchors)))
    rng = np.random.default_rng(11)
    boxes = np.concatenate(
        [rng.uniform(0, 1, (8, 100, 2)), rng.uniform(0.02, 0.6, (8, 100, 2))], -1
    ).astype(np.float32)
    cases.append(("ssd512_anchors", (rng.integers(0, 80, (8, 100)).astype(np.int32), boxes,
                                     rng.uniform(size=(8, 100)) < 0.3, anchors512)))
    return cases


def matcher_bound(np, gt_valid, num_anchors):
    """Least time for the matcher's work on this batch (see PERF.md).

    Bytes: each input read once, each output written once. Operations: per (valid
    GT, anchor) pair, 13 fp32 ops for the legacy-clamp IoU, 1 comparison for phase 2's
    per-anchor maximum, and 1 for the greedy step that places that GT (one pass over
    the D column maxima); padded GT rows need no work.
    """
    batch, max_gt = gt_valid.shape
    in_bytes = batch * max_gt * (16 + 4 + 1) + num_anchors * 16
    out_bytes = batch * num_anchors * (4 + 4 + 16 + 1)
    ops = int(gt_valid.sum()) * num_anchors * 15
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# Kernel-name fragments for the profile's breakdown, first match wins.
KERNEL_GROUPS = (
    ("matcher", ("match_kernel",)),
    ("max-pool", ("max_pool",)),
    ("optimizer", ("multi_tensor", "adam")),
    ("sort (loss mining)", ("sort", "radix")),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "gemm", "dgrad", "wgrad", "nhwc", "sm90")),
)


def profile_step(torch, step) -> None:
    """Print where one train step's device time goes (torch.profiler), informational."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        print("profile: torch.profiler recorded no device time on this machine")
        return
    groups = {}
    for ms, _, name in kernels:
        lower = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in lower for k in keys)),
                     "other elementwise / reduction")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(groups.values())
    print(f"profile of one train step: kernels {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(device busy {100 * busy / wall_ms:.1f} %); by group: "
          + ", ".join(f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(), key=lambda x: -x[1])))
    for ms, calls, name in sorted(kernels, reverse=True)[:8]:
        print(f"  {ms:8.3f} ms  {calls:4d}x  {name[:110]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a GPU only")
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        fail(f"{PACKAGE}/ is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import numpy as np

    from ssd_object_detection_tpu_torch.models.ssd import SSD, SSD300_SPEC_MODEL
    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.ops.anchors import SSD512_SPEC, generate_anchors
    from ssd_object_detection_tpu_torch.ops.boxes import encode_boxes
    from ssd_object_detection_tpu_torch.ops.matching import build_targets, match_anchors
    from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
    from ssd_object_detection_tpu_torch.train.optim import exponential_decay, make_optimizer
    from ssd_object_detection_tpu_torch.train.step import (
        StepConfig, create_train_state, make_train_step,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- 1. card and build ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.time()
    lib = cuda_matcher.build()
    print(f"built {lib.name} in {time.time() - t0:.1f} s")

    # ---- 2. kernel vs plain version on the card ---------------------------------
    anchors300 = generate_anchors()
    anchors512 = generate_anchors(SSD512_SPEC)
    max_abs_err = 0.0
    main_case = None
    for name, case in matcher_cases(np, anchors300, anchors512):
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in case]
        got = cuda_matcher.match_anchors_cuda(*args)
        want = match_anchors(*args)
        torch.cuda.synchronize()
        for field, g, w in zip(got._fields, got, want):
            if not torch.equal(g, w):
                diff = (g != w).sum().item()
                fail(f"matcher case {name}: kernel and plain {field} differ in {diff} entries")
        max_abs_err = max(max_abs_err, (got.box - want.box).abs().max().item())
        print(f"matcher {name}: B={args[0].shape[0]} G={args[0].shape[1]} D={args[3].shape[0]} "
              f"valid={int(case[2].sum())} positives={int(got.mask.sum())}: bit-equal")
        if name == "synthetic_b32":
            main_case = (args, case[2])
        elif name == "random_seed0":
            dense = args
    args, valid_np = main_case
    kernel_ms = cuda_ms(torch, lambda: cuda_matcher.match_anchors_cuda(*args), warmup=5, iters=50)
    plain_ms = cuda_ms(torch, lambda: match_anchors(*args), warmup=2, iters=10)
    bound_ms, bound_by = matcher_bound(np, valid_np, anchors300.shape[0])
    print(f"matcher timing (synthetic B=32 G=100 D=8732, {int(valid_np.sum())} valid GTs, "
          f"max {int(valid_np.sum(1).max())} per image): kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    dense_ms = cuda_ms(torch, lambda: cuda_matcher.match_anchors_cuda(*dense), warmup=5, iters=20)
    print(f"matcher timing, dense case random_seed0 ({int(dense[2].sum())} valid of 3200): "
          f"kernel {dense_ms:.4f} ms")

    # ---- 3. the main path: full-width SSD300 train steps --------------------------
    batch_size, warmup_steps, timed_steps = 32, 2, 5
    ds = SyntheticDetectionDataset(num_images=2 * batch_size, image_size=300, max_gt=100,
                                   num_classes=8, seed=0)
    host_batches = []
    for b in ds.batches(batch_size):
        b["image"] = np.round(b["image"] * 255.0).astype(np.uint8)  # uint8 feed
        host_batches.append(b)
    model = SSD(num_classes=81, spec=SSD300_SPEC_MODEL, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, make_optimizer("adam", model.parameters()),
                               exponential_decay(1e-3, 100, 0.99))
    train_step = make_train_step(anchors300, StepConfig())
    watched = {n: p.detach().clone() for n, p in model.named_parameters()
               if n in ("vgg.block1_conv1.weight", "extra1_conv0.weight", "conf_head0.weight")}

    cuda_matcher.match_anchors_cuda.launches = 0
    step_ms, losses = [], []
    for i in range(warmup_steps + timed_steps):
        batch = host_batches[i % len(host_batches)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        if i >= warmup_steps:
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = cuda_matcher.match_anchors_cuda.launches
    steps = warmup_steps + timed_steps
    if launches != steps:
        fail(f"main path ran {steps} train steps but the matcher kernel launched {launches} times")
    if not all(math.isfinite(m["loss"]) for m in losses):
        fail(f"non-finite loss in the train steps: {losses}")
    for n, before in watched.items():
        if torch.equal(before, dict(model.named_parameters())[n].detach()):
            fail(f"param {n} did not change over {steps} train steps")
    med = statistics.median(step_ms)
    print(f"train step SSD300-VGG16 bf16 batch {batch_size} max_gt 100: losses "
          f"{[round(m['loss'], 4) for m in losses]}; median {med:.2f} ms over {timed_steps} "
          f"steps = {batch_size / med * 1e3:.1f} img/s; matcher launches {launches}")

    batch = host_batches[0]
    g = [torch.from_numpy(batch[k]).to(dev) for k in ("gt_cls", "gt_boxes", "gt_valid")]
    a = torch.from_numpy(anchors300).to(dev)
    t_cls, t_loc, t_mask = build_targets(*g, a)
    plain = match_anchors(*g, a)
    if not (torch.equal(t_cls, plain.cls) and torch.equal(t_mask, plain.mask)
            and torch.equal(t_loc, encode_boxes(plain.box, a[None]))):
        fail("build_targets through the kernel differs from the plain matcher on the batch")
    print(f"build_targets on the train batch: kernel == plain ({int(t_mask.sum())} positives)")
    profile_step(torch, lambda: train_step(state, host_batches[0]))

    # ---- 4. the Trainer through the CLI ---------------------------------------------
    from ssd_object_detection_tpu_torch.cli import train as cli_train

    cuda_matcher.match_anchors_cuda.launches = 0
    trainer = cli_train.main([
        os.path.join(ROOT, "config", "synthetic.yml"), "--device", "cuda",
        "--run-dir", os.path.join(ROOT, "build", "chip_smoke_run"),
    ])
    cli_launches = cuda_matcher.match_anchors_cuda.launches
    final_loss = float(trainer.last_metrics["loss"])
    # one launch per micro-batch: warmup steps, then every full batch of every epoch
    mc, data = trainer.cfg.model, trainer.cfg.data
    num_images = data.mini_batch.num_data if data.mini_batch.enable else 256
    cli_steps = (mc.warmup.step if mc.warmup.enable else 0) \
        + mc.train.epoch * (num_images // mc.train.batch_size)
    expected = cli_steps * trainer.step_cfg.accum_steps
    if not math.isfinite(final_loss) or cli_launches != expected:
        fail(f"CLI trainer: final loss {final_loss}, matcher launches {cli_launches}, "
             f"expected {expected} ({cli_steps} steps x {trainer.step_cfg.accum_steps} micro-batches)")
    # the kernel against the plain matcher on one of the Trainer's own batches
    cli_batch = next(trainer.train_batches())
    g = [torch.from_numpy(cli_batch[k]).to(dev) for k in ("gt_cls", "gt_boxes", "gt_valid")]
    a = torch.from_numpy(trainer.anchors).to(dev)
    got = cuda_matcher.match_anchors_cuda(*g, a, trainer.step_cfg.match_thresh)
    want = match_anchors(*g, a, trainer.step_cfg.match_thresh)
    for field, x, y in zip(got._fields, got, want):
        if not torch.equal(x, y):
            fail(f"CLI batch: kernel and plain {field} differ in {(x != y).sum().item()} entries")
    print(f"CLI trainer config/synthetic.yml: warmup + {mc.train.epoch} epochs = {cli_steps} "
          f"steps, matcher launches {cli_launches}, final loss {final_loss:.6f}; kernel == plain "
          f"on a Trainer batch (B={g[0].shape[0]} G={g[0].shape[1]} D={a.shape[0]})")

    # ---- 5. result lines ----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "greedy_anchor_matcher",
        "route": "cuda",
        "source": MATCHER_SOURCE,
        "replaces": MATCHER_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
