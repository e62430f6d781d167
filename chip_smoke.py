#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check every kernel on them.

Run from the root of a checkout: `python3 chip_smoke.py` (one card, no arguments).

  1. prints the card's name and power limit (nvidia-smi), builds both CUDA kernels from
     ssd_object_detection_tpu_torch/csrc/ (nvcc, sm_90a, one process per source, all
     started together) and prints the build times;
  2. holds the matcher kernel against its plain PyTorch version on the card at the main
     path's shapes (SSD300 anchors D=8,732, B=32, G=100; all-valid, ~10 %-valid,
     zero-valid, duplicated-GT images, the reference's golden bipartite case, a
     synthetic batch, and SSD512's 24,564 anchors): gt_index, cls and mask bit-equal,
     box exactly equal; times both with CUDA events;
  3. the train path: SSD300-VGG16 train steps at full width (81 classes, bf16 compute,
     batch 32, max_gt 100, uint8 synthetic images, reference loss) through
     make_train_step; every launch count is set to 0 just before and read just after,
     and the matcher must have run once per step; losses finite, params changed, and
     build_targets through the kernel equal to the plain matcher on that batch;
  4. the Trainer through the CLI on config/synthetic.yml (warmup + 2 epochs): the
     matcher must have run once per micro-batch of the steps the config asks for, and
     it must equal the plain matcher on one of the Trainer's own batches;
  5. the fused conv3x3 op's own path (no model calls it, as in the JAX package):
     conv3x3_bias_relu at the three VGG trunk shapes it fuses (batch 32, bf16, the
     wgmma kernel), at the seams of that kernel's tiles (ragged rows and columns, tile
     pixels rounded up, IC and OC off the chunk and the N-block, ping-pong tiles with
     more chunks than ring stages, batch 3, IC = 3), and a
     small float32 case in all four relu/pool combinations, launch count equal to the
     forward calls; each output against the plain version (float32 1e-5 of the output
     scale, bf16 one ulp beyond that), one backward against autograd of the plain
     version; per trunk shape the tile plan, kernel, plain and cuDNN (F.conv2d + relu +
     max_pool2d) times, TFLOP/s, share of the bound, host time of the wrapper and of one
     tensor-map encode;
  6. NMS on the card against the CPU on random and tie-heavy pools (B=32, N=400, 80
     classes): nms_on_pool, nms_on_pool_merged and its per_anchor_top2 variant give
     bit-equal valid, classes, scores and boxes;
  7. the detect path at full width (SSD300-VGG16, 81 classes, bf16, batch 32):
     make_fused_predict_fn on a 640x640 uint8 canvas of mixed image sizes and
     make_predict_fn on 300x300 uint8, with every count set to 0 before and read after;
     output shapes and validity invariants, the resize on the card bit-equal to the
     CPU, detect_from_logits on the card equal to the CPU on separated logits; median
     batch latency and img/s, the NMS fixpoint's iterations, a profile by kernel group;
  8. the evaluation gate: `python -m ssd_object_detection_tpu_torch.cli.eval_synthetic`
     at its defaults must reach mAP@0.5 > 0.9;
  9. prints the kernels line, then as its last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

TF32 is off for the whole run (cuDNN and matmul), so float32 work is full float32; the
train step and the detect path compute in bf16 by configuration. Any failure raises and
exits non-zero with no result line; so does a machine without a CUDA device or a
directory without the port package.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "ssd_object_detection_tpu_torch"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores, NVIDIA data sheet
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores, NVIDIA data sheet
MATCHER_SOURCE = f"{PACKAGE}/csrc/matcher.cu"
MATCHER_REPLACES = "ssd_object_detection_tpu/ops/pallas_matcher.py:204"
CONV_SOURCE = f"{PACKAGE}/csrc/conv3x3.cu"
CONV_REPLACES = "ssd_object_detection_tpu/ops/pallas_conv.py:134"
# (layer, H = W, IC = OC, pool): the VGG trunk convolutions the fused op stands for.
CONV_SHAPES = (("block1_conv2", 300, 64, True), ("block2_conv2", 150, 128, True),
               ("block3_conv2", 75, 256, False))
# (name, B, H, W, IC, OC, relu, pool): the seams of the bf16 kernel's tiles
# (ops/cuda_conv.py::plan_conv: pitch 32 x 8 rows with the pool, else full rows where
# that gives fewer tiles; 16-channel chunks; N-blocks of 64; ping-pong tiles).
CONV_EDGES = (
    ("rows_cols_ragged_pool", 2, 18, 64, 16, 64, True, True),
    ("rows_ragged_full_row", 2, 19, 65, 16, 64, True, False),
    ("cols_ragged_pitch32", 1, 10, 290, 16, 16, False, False),
    ("m_rounded_up", 1, 9, 40, 16, 64, True, False),
    ("ic40", 2, 20, 24, 40, 64, True, True),
    ("ic72", 2, 20, 24, 72, 128, True, False),
    ("ic40_oc72", 2, 34, 18, 40, 72, True, False),
    ("oc72", 2, 16, 30, 64, 72, True, True),
    ("oc200", 2, 16, 30, 64, 200, True, False),
    ("batch3", 3, 17, 33, 32, 64, False, False),
    ("odd_channels", 1, 7, 9, 3, 5, False, False),
    ("ic512_streamed64", 1, 10, 20, 512, 64, True, False),  # one tile of 32 chunks
    ("ic512_pingpong", 8, 64, 64, 512, 128, True, False),  # 352 tiles of 32 chunks, 5 stages
)


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr)
    sys.exit(1)


def stream_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean time of one call of `fn` over `iters` calls enqueued back to back, from CUDA
    events: the card's time per call, with the host's enqueue hidden behind it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


# Kernel-name fragments for the profiles' breakdowns, first match wins.
TRAIN_GROUPS = (
    ("matcher", ("match_kernel",)),
    ("max-pool", ("max_pool",)),
    ("optimizer", ("multi_tensor", "adam")),
    ("sort (loss mining)", ("sort", "radix")),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "gemm", "dgrad", "wgrad", "nhwc", "sm90")),
)
PREDICT_GROUPS = (
    ("max-pool", ("max_pool",)),
    ("sort (top-k)", ("sort", "radix")),
    ("convolution (cuDNN)", ("conv", "cudnn", "fprop", "implicit", "nhwc")),
    ("matmul (resize, NMS fixpoint)", ("gemm", "gemv", "cutlass", "matmul")),
    ("gather / index", ("gather", "index")),
)


def profile_step(torch, step, label: str, kernel_groups) -> None:
    """Print where one call's device time goes (torch.profiler), informational."""
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
        group = next((g for g, keys in kernel_groups if any(k in lower for k in keys)),
                     "other elementwise / reduction")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(groups.values())
    print(f"profile of {label}: kernels {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(device busy {100 * busy / wall_ms:.1f} %); by group: "
          + ", ".join(f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(), key=lambda x: -x[1])))
    for ms, calls, name in sorted(kernels, reverse=True)[:8]:
        print(f"  {ms:8.3f} ms  {calls:4d}x  {name[:110]}")


def conv_bound(x, out, oc: int):
    """Least time for one fused conv: each input read once (x, bf16 weights, f32 bias)
    and the output written once, over the memory rate; 2*B*H*W*9*IC*OC operations
    over the dense bf16 tensor-core rate (see PERF.md)."""
    batch, h, w, ic = x.shape
    flops = 2 * batch * h * w * 9 * ic * oc
    nbytes = (x.numel() * x.element_size() + 9 * ic * oc * x.element_size() + oc * 4
              + out.numel() * out.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_error(torch, got, want) -> float:
    """Largest |got - want| beyond the stated tolerance is 0, else fail: float32
    1e-5 of the output's scale (the kernel sums the 9*IC products in another order than
    cuDNN); bf16 that plus one bf16 ulp of the value (both sum in float32 and round
    once, so a sum that straddles a rounding boundary differs by one ulp)."""
    g, w = got.float(), want.float()
    tol = 1e-5 * max(w.abs().max().item(), 1.0)
    if got.dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    err = (g - w).abs()
    if not bool((err <= tol).all()):
        fail(f"conv kernel vs plain: max error {err.max().item():.3e} beyond tolerance")
    return err.max().item()


def nms_pools(np, seed: int, ties: bool, batch: int = 32, n: int = 400, c: int = 80):
    """Pooled candidates (cxcywh boxes (B, N, 4), thresholded scores (B, N, C)). The
    tie-heavy pool quantizes scores to 1/64, repeats boxes and gives every third anchor
    one shared score, so the keep sets depend on the tie order of every sort."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate(
        [rng.uniform(0.1, 0.9, (batch, n, 2)), rng.uniform(0.02, 0.4, (batch, n, 2))], -1
    ).astype(np.float32)
    scores = (rng.uniform(0, 1, (batch, n, c)) ** 4).astype(np.float32)
    if ties:
        scores = np.floor(scores * 64) / 64
        boxes[:, n // 2:] = boxes[:, : n - n // 2]
        scores[:, ::3] = np.float32(0.5)
    return boxes, np.where(scores >= 0.05, scores, 0.0).astype(np.float32)


def mixed_images(np, batch: int, seed: int = 0):
    """`batch` random uint8 HWC images cycling through COCO-like sizes."""
    rng = np.random.default_rng(seed)
    sizes = ((480, 640), (640, 480), (300, 300), (123, 457))
    return [rng.integers(0, 256, sizes[i % 4] + (3,), np.uint8) for i in range(batch)]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a GPU only")
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        fail(f"{PACKAGE}/ is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import numpy as np

    from ssd_object_detection_tpu_torch.models.ssd import SSD, SSD300_SPEC_MODEL
    from ssd_object_detection_tpu_torch.ops import cuda_conv, cuda_matcher, nms
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
    def timed_build(module):
        t = time.time()
        return module.build(), time.time() - t

    with ThreadPoolExecutor(2) as pool:  # one nvcc process per source, all at once
        builds = list(pool.map(timed_build, (cuda_matcher, cuda_conv)))
    for path, seconds in builds:
        print(f"built {path.name} in {seconds:.1f} s")

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
    profile_step(torch, lambda: train_step(state, host_batches[0]), "one train step",
                 TRAIN_GROUPS)

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

    conv = conv_phase(torch, np, dev)
    nms_phase(torch, np, nms, dev)
    detect_phase(torch, np, dev, anchors300)
    eval_gate_phase()

    # ---- 9. result lines ----------------------------------------------------------
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
    }, {
        "name": "conv3x3_bias_relu_pool",
        "route": "cuda",
        "source": CONV_SOURCE,
        "replaces": CONV_REPLACES,
        **conv,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


def conv_phase(torch, np, dev) -> dict:
    """5. The fused conv op's own path, its checks against the plain version, times."""
    import torch.nn.functional as F

    from ssd_object_detection_tpu_torch.ops import cuda_conv
    from ssd_object_detection_tpu_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_plain

    g = torch.Generator().manual_seed(0)

    def inputs(batch, h, w, ic, oc, dtype):
        x = torch.randn(batch, h, w, ic, generator=g).to(dtype)
        k = torch.randn(3, 3, ic, oc, generator=g) / math.sqrt(9 * ic)
        return x.to(dev), k.to(dev), (torch.randn(oc, generator=g) * 0.1).to(dev)

    cases = [(name, inputs(32, hw, hw, c, c, torch.bfloat16), True, pool)
             for name, hw, c, pool in CONV_SHAPES]
    cases += [(name, inputs(b, h, w, ic, oc, torch.bfloat16), relu, pool)
              for name, b, h, w, ic, oc, relu, pool in CONV_EDGES]
    cases += [(f"small_f32_relu{int(relu)}_pool{int(pool)}",
               inputs(2, 12, 20, 8, 16, torch.float32), relu, pool)
              for relu in (False, True) for pool in (False, True)]
    cuda_conv.conv3x3_forward_cuda.launches = 0
    outs = [conv3x3_bias_relu(*args, relu, pool) for _, args, relu, pool in cases]
    torch.cuda.synchronize()
    launches = cuda_conv.conv3x3_forward_cuda.launches
    if launches != len(cases):
        fail(f"conv op: {len(cases)} forward calls launched the kernel {launches} times")
    max_abs_err = 0.0
    for (name, args, relu, pool), got in zip(cases, outs):
        want = conv3x3_plain(*args, relu, pool)
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"conv {name}: kernel {tuple(got.shape)} {got.dtype} vs plain "
                 f"{tuple(want.shape)} {want.dtype}")
        err = conv_error(torch, got, want)
        differ = int((got != want).sum())
        if got.dtype == torch.bfloat16:
            max_abs_err = max(max_abs_err, err)
        print(f"conv {name} {tuple(args[0].shape)}->{tuple(got.shape)} {got.dtype} relu={relu} "
              f"pool={pool}: max |kernel - plain| {err:.3e}, {differ} of {got.numel()} differ")
    del outs

    # one backward through the op: the kernel's forward, the plain version's autograd
    x, k, b = inputs(4, 300, 300, 64, 64, torch.bfloat16)
    grad = torch.randn(4, 150, 150, 64, generator=g).to(torch.bfloat16).to(dev)
    leaves = [t.clone().requires_grad_() for t in (x, k, b)]
    ref = [t.clone().requires_grad_() for t in (x, k, b)]
    got = torch.autograd.grad(conv3x3_bias_relu(*leaves, True, True), leaves, grad)
    want = torch.autograd.grad(conv3x3_plain(*ref, True, True), ref, grad)
    for name, a, w in zip(("x", "kernel", "bias"), got, want):
        # the same autograd graph on the same inputs; only cuDNN's backward order varies
        scale = w.float().abs().max().item()
        diff = (a.float() - w.float()).abs().max().item()
        if diff > 1e-5 * max(scale, 1.0):
            fail(f"conv backward: d{name} differs by {diff:.3e} (scale {scale:.3e})")
        print(f"conv backward d{name} {tuple(a.shape)}: max |op - plain autograd| {diff:.3e}")
    del got, want, leaves, ref

    rows = []
    for name, hw, c, pool in CONV_SHAPES:
        x, k, b = inputs(32, hw, hw, c, c, torch.bfloat16)
        out = cuda_conv.conv3x3_forward_cuda(x, k, b, True, pool)
        def kernel():
            return cuda_conv.conv3x3_forward_cuda(x, k, b, True, pool)

        kernel_ms = cuda_ms(torch, kernel, warmup=3, iters=20)
        back_to_back_ms = stream_ms(torch, kernel)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):  # enqueue only: the wrapper's host time per call
            kernel()
        host_us = (time.perf_counter() - t) / 20 * 1e6
        torch.cuda.synchronize()
        plan = cuda_conv.plan_conv(hw, hw, pool)
        encode_us = cuda_conv.tensor_map_encode_us(x, plan)
        plain_ms = cuda_ms(torch, lambda: conv3x3_plain(x, k, b, True, pool), warmup=2, iters=5)
        x_nchw = x.permute(0, 3, 1, 2)  # a channels-last view, which cuDNN takes as is
        w_lib = k.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_lib = b.to(torch.bfloat16)

        def library():
            y = F.relu(F.conv2d(x_nchw, w_lib, b_lib, padding=1))
            return F.max_pool2d(y, 2, 2) if pool else y

        library_ms = cuda_ms(torch, library, warmup=3, iters=20)
        bound_ms, bound_by = conv_bound(x, out, c)
        flop = 2 * 32 * hw * hw * 9 * c * c
        tflops = flop / (kernel_ms * 1e-3) / 1e12
        tflops_back_to_back = flop / (back_to_back_ms * 1e-3) / 1e12
        tiles_h, tiles_w = plan.grid(hw, hw)
        rows.append({"shape": name, "ms": kernel_ms, "back_to_back_ms": back_to_back_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "tflops": tflops})
        print(f"conv timing {name} (32x{hw}x{hw}x{c}->{c}, bf16, relu, pool={pool}): kernel "
              f"{kernel_ms:.4f} ms per call ({back_to_back_ms:.4f} ms back to back), plain "
              f"{plain_ms:.4f} ms, cuDNN conv+relu"
              f"{'+pool' if pool else ''} {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        print(f"conv tile {name}: pitch {plan.pitch} x {plan.rows} rows "
              f"({plan.cols} columns), {tiles_h}x{tiles_w} tiles per image per N-block, "
              f"{plan.stages} ring stages, "
              f"{plan.smem_bytes} B shared memory; {tflops:.1f} TFLOP/s per call "
              f"({tflops_back_to_back:.1f} back to back), {100 * bound_ms / kernel_ms:.1f} % of "
              f"the bound; host per call {host_us:.1f} us, of it one tensor-map encode "
              f"{encode_us:.2f} us")
        del x, k, b, out, x_nchw, w_lib
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    first = {key: rows[0][key] for key in keys}
    return {"launches": launches, "max_abs_err": max_abs_err, **first, "shapes": rows}


def nms_phase(torch, np, nms, dev) -> None:
    """6. NMS stages on the card against the CPU: comparisons, sorts and exact gathers
    only, so any difference is a tie-order fault."""
    variants = (("nms_on_pool", lambda b, s: nms.nms_on_pool(b, s)),
                ("nms_on_pool_merged", lambda b, s: nms.nms_on_pool_merged(b, s)),
                ("nms_on_pool_merged(per_anchor_top2)",
                 lambda b, s: nms.nms_on_pool_merged(b, s, per_anchor_top2=True)))
    for seed, ties in ((0, False), (1, True)):
        boxes, scores = nms_pools(np, seed, ties)
        on_cpu = [torch.from_numpy(boxes), torch.from_numpy(scores)]
        on_card = [t.to(dev) for t in on_cpu]
        for name, fn in variants:
            got, want = fn(*on_card), fn(*on_cpu)
            for field, a, w in zip(got._fields, got, want):
                if not torch.equal(a.cpu(), w):
                    fail(f"{name} {'tie-heavy' if ties else 'random'}: {field} differs between "
                         f"card and CPU in {int((a.cpu() != w).sum())} entries")
            print(f"{name} {'tie-heavy' if ties else 'random'} B=32 N=400 C=80: card == CPU "
                  f"({int(want.valid.sum())} detections)")


def detect_phase(torch, np, dev, anchors300) -> None:
    """7. The detect path at full width, its invariants, latency and profile."""
    from ssd_object_detection_tpu_torch.eval.predict import (
        detect_from_logits, make_fused_predict_fn, make_predict_fn,
    )
    from ssd_object_detection_tpu_torch.models.ssd import SSD, SSD300_SPEC_MODEL
    from ssd_object_detection_tpu_torch.ops import cuda_conv, cuda_matcher, nms
    from ssd_object_detection_tpu_torch.ops.preprocess import pack_canvas, resize_bilinear_planar

    batch = 32
    model = SSD(num_classes=81, spec=SSD300_SPEC_MODEL, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    canvas_np, sizes_np = pack_canvas(mixed_images(np, batch), (640, 640))
    canvas, sizes = torch.from_numpy(canvas_np).to(dev), torch.from_numpy(sizes_np).to(dev)
    images_np = np.random.default_rng(1).integers(0, 256, (batch, 300, 300, 3), np.uint8)
    images = torch.from_numpy(images_np).to(dev)
    fused = make_fused_predict_fn(model, anchors300)
    plain = make_predict_fn(model, anchors300)

    for method in ("matmul", "gather"):  # exact arithmetic: the card equals the CPU
        on_card = resize_bilinear_planar(canvas[:4], sizes[:4], 300, method=method).cpu()
        on_cpu = resize_bilinear_planar(torch.from_numpy(canvas_np[:4]),
                                        torch.from_numpy(sizes_np[:4]), 300, method=method)
        if not torch.equal(on_card, on_cpu):
            fail(f"resize {method}: card and CPU differ by {(on_card - on_cpu).abs().max():.3e}")
    print("resize_bilinear_planar matmul and gather, 4 canvas images: card == CPU")

    cuda_conv.conv3x3_forward_cuda.launches = 0
    cuda_matcher.match_anchors_cuda.launches = 0
    nms.suppress_fixpoint.calls = nms.suppress_fixpoint.iterations = 0
    results = {"fused (640x640 uint8 canvas)": fused(canvas, sizes),
               "plain (300x300 uint8)": plain(images)}
    torch.cuda.synchronize()
    print(f"detect path launches: conv kernel {cuda_conv.conv3x3_forward_cuda.launches}, "
          f"matcher {cuda_matcher.match_anchors_cuda.launches} (no model calls either on this "
          f"path); NMS fixpoint {nms.suppress_fixpoint.iterations} iterations in "
          f"{nms.suppress_fixpoint.calls} calls")
    for name, det in results.items():
        shapes = [tuple(t.shape) for t in det]
        if shapes != [(batch, 100, 4), (batch, 100), (batch, 100), (batch, 100)]:
            fail(f"detect {name}: output shapes {shapes}")
        if not (torch.equal(det.valid, det.scores > 0) and torch.equal(det.classes < 0, ~det.valid)
                and bool((det.classes[det.valid] < 80).all())
                and bool(torch.isfinite(det.boxes).all())
                and bool((det.boxes[~det.valid] == 0).all())):
            fail(f"detect {name}: validity invariants broken")
        print(f"detect {name}: shapes {shapes}, {int(det.valid.sum())} valid detections")

    # detect_from_logits on the card against the CPU, on separated (trained-like) logits
    rng = np.random.default_rng(2)
    d = anchors300.shape[0]
    logits = rng.normal(size=(4, d, 81)).astype(np.float32)
    logits[..., -1] += 6.0
    for i in range(4):
        fg = rng.choice(d, 60, replace=False)
        logits[i, fg, rng.integers(0, 80, 60)] += 12.0
    loc = (rng.normal(size=(4, d, 4)) * 0.1).astype(np.float32)
    args = [torch.from_numpy(a) for a in (loc, logits, anchors300)]
    for mode in ("merged", "merged_top2", "per_class"):
        want = detect_from_logits(*args, nms_mode=mode)
        got = detect_from_logits(*(a.to(dev) for a in args), nms_mode=mode)
        got = [t.cpu() for t in got]
        if not (torch.equal(got[3], want.valid) and torch.equal(got[2], want.classes)
                and torch.allclose(got[1], want.scores, atol=1e-6, rtol=0)
                and torch.allclose(got[0], want.boxes, atol=1e-6, rtol=0)):
            fail(f"detect_from_logits {mode}: card and CPU disagree")
    print("detect_from_logits merged, merged_top2, per_class on separated logits (B=4, "
          "D=8732, C=81): card == CPU (keep sets and classes bit-equal, scores and boxes "
          "within 1e-6)")

    for name, call in (("fused (640x640 uint8 canvas)", lambda: fused(canvas, sizes)),
                       ("plain (300x300 uint8)", lambda: plain(images))):
        nms.suppress_fixpoint.calls = nms.suppress_fixpoint.iterations = 0
        ms = cuda_ms(torch, call, warmup=3, iters=20)
        per_call = nms.suppress_fixpoint.iterations / nms.suppress_fixpoint.calls
        print(f"detect latency {name}, SSD300-VGG16 bf16 batch {batch}, inputs on the card: "
              f"median {ms:.3f} ms = {batch / ms * 1e3:.1f} img/s; NMS fixpoint "
              f"{per_call:.2f} iterations per call (each, and the final convergence test, reads "
              f"one boolean on the host)")
    profile_step(torch, lambda: fused(canvas, sizes), "one fused predict call (batch 32)",
                 PREDICT_GROUPS)


def eval_gate_phase() -> None:
    """8. The synthetic mAP gate at the JAX tool's budget, in its own process."""
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.cli.eval_synthetic"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=900,
    )
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"  eval_synthetic: {line}")
    if proc.returncode != 0 or not lines:
        fail(f"eval_synthetic exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    result = json.loads(lines[-1])
    print(f"eval gate (cli.eval_synthetic defaults: {result['train']}): mAP {result['mAP']:.4f}, "
          f"mAP@0.5 {result['mAP@0.5']:.4f}, train {result['train_seconds']:.1f} s, "
          f"whole run {time.time() - t:.1f} s on {result['device']}")
    if not result["mAP@0.5"] > 0.9:
        fail(f"eval gate: mAP@0.5 {result['mAP@0.5']:.4f} is not above 0.9")


if __name__ == "__main__":
    main()
