#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check every kernel on them.

Run from the root of a checkout: `python3 chip_smoke.py` (one card, no arguments).

  1. prints the card's name and power limit (nvidia-smi), builds the three CUDA sources
     of ssd_object_detection_tpu_torch/csrc/ (matcher, conv3x3, int8_conv; nvcc, sm_90a,
     one process per source, all started together) and prints the build times;
  2. holds the matcher kernel against its plain PyTorch version on the card at the main
     path's shapes (SSD300 anchors D=8,732, B=32, G=100; all-valid, ~10 %-valid,
     zero-valid, duplicated-GT images, the reference's golden bipartite case, a
     synthetic batch, and SSD512's 24,564 anchors) and on the cases that strain its
     design (identical GTs, more GTs than anchors, empty and ragged column slices,
     B = 1 and B = 160, G = 1, a thresh below -1, SSD512's anchors at B = 32): gt_index,
     cls and mask bit-equal, box exactly equal; for the train path's batch, a dense
     batch and SSD512's anchors it prints the launch plan, the time per call, back to
     back and of the wrapper on the host, the rescans the plain model of the algorithm
     counts, and the time of an empty kernel of the same grid and cluster shape;
  3. the train path: SSD300-VGG16 train steps at full width (81 classes, bf16 compute,
     batch 32, max_gt 100, uint8 synthetic images, reference loss) through
     make_train_step; every launch count is set to 0 just before and read just after,
     and the matcher must have run once per step; losses finite, params changed, and
     build_targets through the kernel equal to the plain matcher on that batch;
  3b. the same for SSD300-R34 and SSD300-MNV2 (GroupNorm trunks): a float32 forward on
     the card (TF32 off) within 1e-4 of the output scale of the CPU forward of the same
     model; warmup + timed steps with the matcher once per step, finite losses, changed
     params, ms per step; one step with remat against one without from the same params
     (loss and gradients within the step's own run-to-run spread), the peak memory of
     each; one profiled step by kernel group (GroupNorm, depthwise convs, layout copies);
     what F.group_norm launches on a channels-last input;
  3c. data parallelism (parallel/*): (a) two ranks spawned by parallel/multihost.py's
     launch share cuda:0 over gloo (NCCL refuses two ranks on one device; gloo takes
     CUDA tensors, and a collective it lacked would fail the phase): SSD300-VGG16, 81
     classes, global batch 32 (16 a rank, each rank reading only its rows of the
     synthetic feed), max_gt 100, seed-0 weights; 3 float32 steps (TF32 off), each held
     to the one-process step at batch 32 on the same batches (num_positive exactly;
     loss and parameter L2 distance within twice the distance of the one-process step
     run as two halves of 16, the yardstick of batch-16 arithmetic, plus 1e-6 of the
     loss and of the step's own movement), then 3 bf16 steps; after each of the 6
     steps the ranks' parameters and Adam moments are bit-equal (rank 0's broadcast,
     compared on rank 1); the matcher launches once a step on each rank; it prints the
     2-rank and 1-process ms per step and the gradient all-reduce's ms, as two processes
     on one card, not a scaling figure; (c) the 2-rank evaluation of 53 binary images
     (batches 32 and 21, the remainder padded to 32) with dyadic weights: detections and
     metrics bit-equal to one process computing the same rows, and the comparison with
     one process at batch 32 printed; (b) a 1-rank NCCL group: its bf16 step bit-equal
     (deterministic algorithms) to the step without a mesh from the same state; (d)
     `debug_nans`: a NaN in vgg.block3_conv1's weight stops the step with
     FloatingPointError naming it, and the step without it runs; (e) max_pool_2x2 at
     block1's output (32x300x300x64 bf16): value and gradient card == CPU, bit for bit;
  3d. the 2-D (data x model) grid (parallel/shardings.py): four ranks spawned by launch
     share cuda:0 over gloo as a (2, 2) grid; SSD300-VGG16 at full width from the seed-0
     weights, global batch 32 (16 a data rank), max_gt 100, 81 classes, its convs of at
     least 256 output channels column-parallel (printed); 2 float32 steps (TF32 off,
     deterministic algorithms), each held to the one-process step as 3c holds its ranks
     (num_positive exactly; loss and unsharded parameters within the halves yardstick,
     the one-process references run under the same deterministic algorithms; and the
     grid no farther from one process running its arithmetic, halves of 16 with the
     column-parallel convs as two halves of their channels, than the halves are from
     one process),
     with the replicated parameters and Adam moments bit-equal across the model ranks and
     every parameter and moment bit-equal across the data ranks after each; the matcher
     once a step on each rank; then 2 bf16 steps timed, and one bf16 step's
     gather_channels and copy_to_model collectives replayed alone and timed: a cost
     figure of gloo through the host on one card, not a scaling figure;
  3e. the dry run, cli/dryrun.py::dryrun_multichip(4, device="cuda", backend="gloo"):
     every leg (data-parallel step, checkpoint resume, the (2, 2) leg within 1e-3 of the
     data-parallel loss, the data-parallel fused predict), with its seconds;
  4. the Trainer through the CLI on config/synthetic.yml (warmup + 2 epochs): the
     matcher must have run once per micro-batch of the steps the config asks for, and
     it must equal the plain matcher on one of the Trainer's own batches; the run must
     leave its two checkpoints and model_last.msgpack, and
     `python -m ssd_object_detection_tpu_torch.cli.eval config/synthetic.yml --weights`
     on that file must print a JSON line with mAP@0.5;
  4b. the Trainer's production path at full width: a COCO-format root of 640 synthetic
     300x300 images (80 canonical names under the sparse ids, iscrowd boxes, images
     without annotations) with its packed cache written by numpy (no cv2 here), SSD300,
     81 classes, batch 32, max_gt 100, bf16, flip on the host, batches fed by
     device_prefetch (depth 2); warmup 20 steps + 3 epochs of 20 with checkpoints
     (keep 2): the matcher once per micro-batch of every step, two checkpoints and
     model_last.msgpack left; a resume from the epoch-2 checkpoint restores params,
     Adam moments and step bit-equal and its epoch-3 losses equal an uninterrupted
     continuation from the same state on the same batches (exact under
     torch.use_deterministic_algorithms, see `resume_tolerance`); the exported
     msgpack loaded into a fresh SSD gives a bit-equal forward; it prints the Trainer's
     ms per step against phase 3's bare step, host ms per packed batch, the upload of
     one batch from pageable and pinned memory, a profile of 5 Trainer steps (the
     host-to-device copies' streams, their overlap with kernels, the device-busy
     share), and the checkpoint and msgpack costs;
  4c. the Trainer with the full augmentation recipe on the device (flip, expand, crop,
     photometric; ops/augment.py) on 4b's fixture: one packed batch augmented on the card
     and on the CPU from the same draws (valid, cls, boxes, crop rects, flips bit-equal,
     pixels within 2e-5), the augmentation's stages timed by CUDA events, CUDA-graph
     replay and torch.profiler (with what the profiler kept of the products), warmup 20 steps
     + 2 epochs of 20 with the matcher once per micro-batch and no host flip in the
     packed feed, a resume from the epoch-1 checkpoint whose epoch-2 losses are bit-equal
     to a continuation, the steady-state ms per step beside 4b's flip-only figure, and
     one profiled step's kernels;
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
  5b. the int8 conv kernels (csrc/int8_conv.cu: a quantize kernel, a wgmma s8 conv fed
     by TMA through an mbarrier ring): SSD300-VGG16 quantized on one synthetic batch, and
     each of its 17 int8 conv calls of a batch-32 forward replayed on its real input,
     then 7 shapes kept from the first kernel's seams and the 13 seams of the wgmma
     kernel's tiles (ops/int8_conv_model.py::SEAMS: halo boxes past every edge, rows and
     pitch off H and W, IC off 32, OC off 64 and 256, stride 2 on odd and even sizes,
     1x1 flattened and strided, VALID, a partly empty last round of the persistent
     grid, batch 1): quantize and int32 accumulators bit-equal to the plain version (a
     float64 conv of the int8 values), dequantized outputs bit-equal at bf16 and float32;
     per SSD300 conv the tile plan, the conv kernel and the quantize kernel alone against
     their own bounds, the pair per call and back to back against its bound, TOP/s, the
     plain version, im2col + torch._int_mm (cuBLASLt int8) + dequantize, the float
     path's bf16 cuDNN conv and the wrapper's host us;
  6. NMS on the card against the CPU on random and tie-heavy pools (B=32, N=400, 80
     classes): nms_on_pool, nms_on_pool_merged and its per_anchor_top2 variant give
     bit-equal valid, classes, scores and boxes;
  7. the detect path at full width (SSD300-VGG16, 81 classes, bf16, batch 32):
     make_fused_predict_fn on a 640x640 uint8 canvas of mixed image sizes and
     make_predict_fn on 300x300 uint8, with every count set to 0 before and read after;
     output shapes and validity invariants, the resize on the card bit-equal to the
     CPU, detect_from_logits on the card equal to the CPU on separated logits; median
     batch latency and img/s, the NMS fixpoint's iterations (its capped count, with no
     host read), a profile by kernel group;
  7c. the PTQ detect path at full width (5b's quantized SSD300-VGG16, batch 32, fused on
     the 640x640 canvas): one int8 launch per quantized conv, detections bit-equal to the
     same model with the plain int8 conv on the card, median latency in turns with the
     float model, a profile, and a PTQ bundle tier exported, reloaded through
     from_artifact and equal to the live quantized service (its MB beside the float
     parameters');
  7b. serving at full width (SSD300-VGG16, 81 classes, bf16, canvas 640x640, batch 32,
     tiers 1, 8, 32): the live DetectorService's median and p90 detect_images latency
     per tier, its host clock by stage and its program's device time (CUDA-graph replay
     and torch.profiler); the exported bundle (torch.export, one program per tier) loaded by
     DetectorService.from_artifact, equal to the live service at every tier and timed the
     same way; the BatchingFrontEnd under 64 threads x 4 single-image requests (img/s,
     p50 and p99 latency, mean dispatched batch);
  7d. the bench entry, cli/bench.py::main() at its defaults (int8 PTQ and bf16 fused
     SSD300 img/s at batch 32, 16 batches on the card a round, no host read in the timed
     rounds), its JSON line printed on a line of its own; and utils/introspect.py's
     flops_analysis of the SSD300 bf16 and PTQ forwards at batch 32, each equal to the sum
     over the convs reckoned from their shapes (`reckoned_conv_flops`);
  8. the evaluation gates, three `python -m ssd_object_detection_tpu_torch.cli.eval_synthetic`
     processes at their defaults at once on the card: `--ptq` (SSD300-VGG16 mAP@0.5 > 0.9,
     the int8 paths with heads float and heads int8 within 0.02 of it), `--variant
     ssd300_r34` and `--variant ssd300_mnv2` (each > 0.9);
  9. prints the kernels line (the matcher's launches count phases 3, 3b, 3c, 3d and 4c, the int8
     conv's one PTQ detect call of 7c), then as its last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Each phase prints its seconds. The Keras .h5 import is host code and the card may lack
h5py, so it is not run here (tests/test_torch_import_keras.py covers it on the CPU).
TF32 is off for the whole run (cuDNN and matmul), so float32 work is full float32; the
train step and the detect path compute in bf16 by configuration. Any failure raises and
exits non-zero with no result line; so does a machine without a CUDA device or a
directory without the port package.
"""

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
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
INT8_SOURCE = f"{PACKAGE}/csrc/int8_conv.cu"
INT8_REPLACES = "ssd_object_detection_tpu/ops/quant.py:192 (XLA int8 conv; no Pallas kernel)"
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores, NVIDIA data sheet
# the six 3x3 stride-1 int8 convs of SSD300-VGG16 at >= 38x38 (1,070 of its 1,242 GOP)
INT8_LARGE = ("vgg/block2_conv2", "vgg/block3_conv1", "vgg/block3_conv2", "vgg/block3_conv3",
              "extra0_conv0", "extra0_conv1")
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
# (name, B, H, W, IC, OC, kernel, stride, padding): shapes at the int8 conv kernel's
# seams, kept from its first design (128 x 128 tiles, 64-channel K chunks); the seams
# of the wgmma kernel's tiles (ops/int8_conv_model.py::SEAMS) run after them.
INT8_EDGES = (
    ("ic40_oc72_stride2_even", 2, 16, 16, 40, 72, 3, 2, "SAME"),  # K and OC tails, pads (0, 1)
    ("ic96_oc200", 2, 17, 19, 96, 200, 3, 1, "SAME"),  # a half K chunk, a second OC tile
    ("ic3_oc5", 1, 7, 9, 3, 5, 3, 1, "SAME"),
    ("stride2_odd", 2, 19, 19, 512, 256, 3, 2, "SAME"),  # pads (1, 1)
    ("valid_3_to_1", 4, 3, 3, 256, 256, 3, 1, "VALID"),
    ("batch1_pointwise", 1, 19, 19, 1024, 1024, 1, 1, "SAME"),
    ("m_tail", 3, 5, 7, 128, 136, 3, 1, "SAME"),  # 105 pixels: one partial pixel tile
)
# kernel names of csrc/int8_conv.cu in a profile
INT8_GROUPS = (("int8 quantize (csrc/int8_conv.cu)", ("quantize_pieces", "quantize_groups")),
               ("int8 conv (csrc/int8_conv.cu)", ("conv_wgmma",)))


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


def graph_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """The card's time per call with no host time of the wrapper in it: `calls` calls of
    `fn` captured into one CUDA graph, the median over `replays` replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def enqueue_us(torch, fn, iters: int = 50) -> float:
    """Host microseconds per call of `fn` when calls are only enqueued: the wrapper's
    own time (checks, allocations, the launch), the card's work hidden behind it."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


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
    ("host-to-device copy", ("memcpy htod",)),
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


def profiled_kernels(prof):
    """[(ms, calls, name)] by kernel of a torch.profiler run."""
    from torch.autograd import DeviceType

    return [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def group_kernels(kernels, kernel_groups):
    """Device ms by kernel group of [(ms, calls, name)]."""
    groups = {}
    for ms, _, name in kernels:
        lower = name.lower()
        group = next((g for g, keys in kernel_groups if any(k in lower for k in keys)),
                     "other elementwise / reduction")
        groups[group] = groups.get(group, 0.0) + ms
    return groups


def format_groups(groups) -> str:
    return ", ".join(f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(), key=lambda x: -x[1]))


def profile_step(torch, step, label: str, kernel_groups) -> None:
    """Print where one call's device time goes (torch.profiler), informational."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    kernels = profiled_kernels(prof)
    groups = group_kernels(kernels, kernel_groups)
    if not kernels:
        print("profile: torch.profiler recorded no device time on this machine")
        return
    busy = sum(groups.values())
    print(f"profile of {label}: kernels {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(device busy {100 * busy / wall_ms:.1f} %); by group: {format_groups(groups)}")
    for ms, calls, name in sorted(kernels, reverse=True)[:8]:
        print(f"  {ms:8.3f} ms  {calls:4d}x  {name[:110]}")


def device_kernels(torch, fn):
    """[(ms, calls, name)] of the kernels of one call of `fn` (warm), in torch.profiler,
    recorded after one warm-up step of the profiler. On the H100 machines the profiler
    loses some kernel records, cold or warm (phase 4c prints both ways for the
    augmentation's products), so these are the kernels it kept: their sum is a lower
    bound on device time. `graph_ms` gives the whole where `fn` can be captured."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kernels = []
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kernels.extend(profiled_kernels(p))) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return kernels


def device_ms(torch, fn) -> float:
    """The sum of the kernels torch.profiler kept of one call of `fn` (see
    `device_kernels`: a lower bound on its device time); 0.0 where it records none."""
    return sum(ms for ms, _, _ in device_kernels(torch, fn))


def sm_clock_under_load(torch, fn, seconds: float = 2.5):
    """nvidia-smi's readings of (SM clock MHz, its maximum MHz, power W) while `fn` runs
    back to back for `seconds`, one reading after another from a second thread."""
    import threading

    readings, done = [], threading.Event()

    def sample():
        time.sleep(0.5)  # let the load reach its clock
        while not done.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30).stdout
            readings.append(tuple(float(x) for x in out.splitlines()[0].split(",")))

    sampler = threading.Thread(target=sample)
    sampler.start()
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    done.set()
    sampler.join()
    return readings


def reckoned_conv_flops(spec, batch: int, num_classes: int) -> int:
    """2 * B * Ho * Wo * KH * KW * IC * OC summed over every conv of an SSD of `spec`
    (VGG16 or micro trunk), from the spec's shapes alone: what utils/introspect.py's
    flops_analysis must count for one forward."""
    total = 0

    def conv(h, ic, oc, k, stride=1, padding="SAME", dilation=1):
        nonlocal total
        ho = -(-h // stride) if padding == "SAME" else (h - (k - 1) * dilation - 1) // stride + 1
        total += 2 * batch * ho * ho * k * k * ic * oc
        return ho

    h, ch = spec.image_size, 3
    if spec.trunk == "vgg16":  # 2x2/s2 pools between blocks, then a SAME (ceil) pool
        for block, in_ch, features, n_convs in ((1, 3, 64, 2), (2, 64, 128, 2), (3, 128, 256, 3)):
            h = h if block == 1 else h // 2
            for i in range(n_convs):
                conv(h, in_ch if i == 0 else features, features, 3)
        h, ch = -(-h // 2), 256
    elif spec.trunk == "micro":
        for features in (32, 64):
            h, ch = conv(h, ch, features, 3, 2), features
    else:
        raise ValueError(f"no reckoning for the {spec.trunk!r} trunk")
    taps = []
    for block in spec.blocks:
        for c in block:
            h, ch = conv(h, ch, c[0], c[1], c[2], c[3], c[4] if len(c) > 4 else 1), c[0]
        taps.append((h, ch))
    for (h, ch), n in zip(taps, spec.anchor_spec.anchors_per_cell):
        conv(h, ch, n * 4, 3)
        conv(h, ch, n * num_classes, 3)
    return total


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
    started = time.time()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a GPU only")
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        fail(f"{PACKAGE}/ is not beside chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import numpy as np

    from ssd_object_detection_tpu_torch.models.ssd import SSD, SSD300_SPEC_MODEL
    from ssd_object_detection_tpu_torch.ops import cuda_conv, cuda_int8, cuda_matcher, nms
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

    with ThreadPoolExecutor(3) as pool:  # one nvcc process per source, all at once
        builds = list(pool.map(timed_build, (cuda_matcher, cuda_conv, cuda_int8)))
    for path, seconds in builds:
        print(f"built {path.name} in {seconds:.1f} s")

    anchors300 = generate_anchors()
    anchors512 = generate_anchors(SSD512_SPEC)
    print(f"phase 1 (card, builds): {time.time() - started:.1f} s")
    t_phase = time.time()
    matcher = matcher_phase(torch, np, dev, anchors300, anchors512)
    print(f"phase 2 (matcher): {time.time() - t_phase:.1f} s")
    t_phase = time.time()

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
    del model, state, watched
    torch.cuda.empty_cache()
    print(f"phase 3 (SSD300-VGG16 train steps): {time.time() - t_phase:.1f} s")
    family_launches = timed("3b (R34 and MNV2 train steps)", family_train_phase, torch, np, dev, smi)
    dp_launches = timed("3c (data parallel)", dp_phase, torch, np, dev, smi, med)
    dp_launches += timed("3d (DP x TP)", dp_tp_phase, torch, np, dev, smi, med)
    timed("3e (dry run)", dryrun_phase, dev)
    t_phase = time.time()

    # ---- 4. the Trainer through the CLI ---------------------------------------------
    from ssd_object_detection_tpu_torch.cli import train as cli_train

    cli_run = os.path.join(ROOT, "build", "chip_smoke_run")
    shutil.rmtree(cli_run, ignore_errors=True)
    cuda_matcher.match_anchors_cuda.launches = 0
    trainer = cli_train.main([
        os.path.join(ROOT, "config", "synthetic.yml"), "--device", "cuda", "--run-dir", cli_run,
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
    cli_eval_phase(trainer)
    print(f"phase 4 (Trainer through the CLI, cli.eval): {time.time() - t_phase:.1f} s")
    aug_launches = timed("4b + 4c (production Trainer)", production_phase, torch, np, dev, med,
                         card=smi)

    conv = timed("5 (conv3x3 op)", conv_phase, torch, np, dev)
    int8 = timed("5b (int8 conv kernels)", int8_phase, torch, np, dev, smi)
    timed("6 (NMS)", nms_phase, torch, np, nms, dev)
    timed("7 (detect)", detect_phase, torch, np, dev, anchors300)
    int8["launches"] = timed("7c (PTQ detect)", ptq_detect_phase, torch, np, dev, anchors300, smi)
    timed("7b (serving)", serve_phase, torch, np, dev, smi)
    timed("7d (bench entry)", bench_phase, torch, np, dev, smi)
    timed("8 (mAP gates)", eval_gate_phase)

    # ---- 9. result lines ----------------------------------------------------------
    print(f"all phases in {time.time() - started:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "greedy_anchor_matcher",
        "route": "cuda",
        "source": MATCHER_SOURCE,
        "replaces": MATCHER_REPLACES,
        "launches": launches + aug_launches + family_launches + dp_launches,
        **matcher,
        "library_ms": None,
    }, {
        "name": "conv3x3_bias_relu_pool",
        "route": "cuda",
        "source": CONV_SOURCE,
        "replaces": CONV_REPLACES,
        **conv,
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": INT8_SOURCE,
        "replaces": INT8_REPLACES,
        **int8,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


def timed(name: str, phase, *args, **kwargs):
    """Run one phase and print its seconds."""
    t = time.time()
    result = phase(*args, **kwargs)
    print(f"phase {name}: {time.time() - t:.1f} s")
    return result


def matcher_phase(torch, np, dev, anchors300, anchors512) -> dict:
    """2. The matcher kernel against its plain version on the card, and its times."""
    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.ops.matcher_model import match_anchors_model, stress_cases
    from ssd_object_detection_tpu_torch.ops.plain_matcher import match_anchors

    cases = [(name, case, 0.5) for name, case in matcher_cases(np, anchors300, anchors512)]
    cases += [(f"stress_{name}", case[:4], case[4])
              for name, case in stress_cases(anchors300, anchors512).items()]
    max_abs_err = 0.0
    timed = {}
    for name, case, thresh in cases:
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in case]
        got = cuda_matcher.match_anchors_cuda(*args, thresh)
        want = match_anchors(*args, thresh)
        torch.cuda.synchronize()
        for field, g, w in zip(got._fields, got, want):
            if not torch.equal(g, w):
                diff = (g != w).sum().item()
                fail(f"matcher case {name}: kernel and plain {field} differ in {diff} entries")
        max_abs_err = max(max_abs_err, (got.box - want.box).abs().max().item())
        print(f"matcher {name}: B={args[0].shape[0]} G={args[0].shape[1]} D={args[3].shape[0]} "
              f"thresh={thresh} valid={int(case[2].sum())} positives={int(got.mask.sum())}: "
              f"bit-equal")
        # timed: the train path's batch, a dense batch, SSD512's anchors, and the batch
        # whose every pick is a conflict (its time over its rescans is a rescan's cost)
        if name in ("synthetic_b32", "random_seed0", "ssd512_anchors", "stress_identical_gts"):
            timed[name] = (args, case[2])
        del got, want

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {}
    for name, (args, valid_np) in timed.items():
        batch, max_gt = valid_np.shape
        num_anchors = args[3].shape[0]
        launch = cuda_matcher.plan(batch, max_gt, num_anchors, sms)

        def kernel():
            return cuda_matcher.match_anchors_cuda(*args)

        kernel_ms = cuda_ms(torch, kernel, warmup=5, iters=50)
        back_to_back_ms = stream_ms(torch, kernel, warmup=5, iters=50)
        device_ms = graph_ms(torch, kernel)
        host_us = enqueue_us(torch, kernel)

        def empty():
            cuda_matcher.empty_launch(launch, dev)

        floor_ms, floor_call_ms = graph_ms(torch, empty), cuda_ms(torch, empty, warmup=5, iters=50)
        # the algorithm's plain model on the CPU: its result once more, and its rescans
        model, rescans = match_anchors_model(*(a.cpu() for a in args), cluster=launch.cluster)
        if not torch.equal(model.gt_index, kernel().gt_index.cpu()):
            fail(f"matcher case {name}: the kernel and the plain model of its algorithm differ")
        bound_ms, bound_by = matcher_bound(np, valid_np, num_anchors)
        at_once = cuda_matcher.max_active_clusters(launch, dev)
        if at_once < 1:
            fail(f"matcher case {name}: the card cannot schedule a cluster of {launch}")
        print(f"matcher timing {name} (B={batch} G={max_gt} D={num_anchors}, "
              f"{int(valid_np.sum())} valid GTs, max {int(valid_np.sum(1).max())} per image): "
              f"kernel {kernel_ms:.4f} ms per call, {back_to_back_ms:.4f} ms back to back, "
              f"{device_ms:.4f} ms replayed from a CUDA graph (no host time), host "
              f"{host_us:.1f} us per call; bound {bound_ms:.5f} ms ({bound_by})")
        print(f"matcher plan {name}: {launch.cluster} CTAs per image x {batch} = {launch.ctas} CTAs "
              f"of {launch.threads} threads ({launch.slice_cols} columns each), "
              f"{launch.smem_bytes} B shared memory, "
              f"{at_once} clusters fit the card at once; "
              f"{rescans} row rescans (plain model); empty kernel of that shape "
              f"{floor_ms:.4f} ms replayed from a CUDA graph, {floor_call_ms:.4f} ms per call")
        if name == "synthetic_b32":  # the train path's batch: the kernels line's numbers
            plain_ms = cuda_ms(torch, lambda: match_anchors(*args), warmup=2, iters=10)
            print(f"matcher plain version on {name}: {plain_ms:.4f} ms")
            result = {"max_abs_err": max_abs_err, "ms": kernel_ms,
                      "back_to_back_ms": back_to_back_ms, "graph_ms": device_ms,
                      "host_us": host_us, "launch_floor_ms": floor_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    return result


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
        host_us = enqueue_us(torch, kernel, iters=20)
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
              f"{per_call:.2f} iterations per call (the capped min(K, 16), run with no "
              f"convergence test: no host read)")
    profile_step(torch, lambda: fused(canvas, sizes), "one fused predict call (batch 32)",
                 PREDICT_GROUPS)

    # the capped fixpoint against the loop that stops once alive stops changing (the JAX
    # while_loop's semantics, one host read per iteration), in turns in this process
    capped = nms.suppress_fixpoint

    def converging(tri, max_iters: int = 16):
        tri_f = tri.float()
        alive = torch.ones(tri.shape[:-1], dtype=torch.bool, device=tri.device)
        prev = torch.zeros_like(alive)
        it = 0
        while it < min(tri.shape[-1], max_iters) and bool((alive != prev).any()):
            prev = alive
            alive = ~(torch.matmul(alive.float().unsqueeze(-2), tri_f).squeeze(-2) > 0.5)
            it += 1
        return alive

    def fused_with(fixpoint):
        nms.suppress_fixpoint = fixpoint
        try:
            return fused(canvas, sizes), cuda_ms(torch, lambda: fused(canvas, sizes), warmup=3, iters=20)
        finally:
            nms.suppress_fixpoint = capped

    turns = [fused_with(f) for f in (converging, capped, capped, converging)]
    if not all(torch.equal(a, b) for a, b in zip(turns[0][0], turns[1][0])):
        fail("fused predict: the capped and the converging fixpoint give other detections")
    ms = [t[1] for t in turns]
    print(f"fused predict batch {batch}, NMS fixpoint converging (a host read per iteration) / "
          f"capped (none), in turns converging, capped, capped, converging: "
          f"{', '.join(f'{x:.3f}' for x in ms)} ms; detections bit-equal")


def cli_eval_phase(trainer) -> None:
    """4, continued. The CLI run's files, and `cli.eval` on its exported weights in its
    own process."""
    ckpts = sorted(os.listdir(os.path.join(trainer.run_dir, "checkpoints")))
    weights = os.path.join(trainer.run_dir, "model_last.msgpack")
    epochs = trainer.cfg.model.train.epoch
    want = [f"ckpt_{e}.pt" for e in range(1, epochs + 1)][-trainer.cfg.model.checkpoint.keep:]
    if ckpts != want or not os.path.isfile(weights):
        fail(f"CLI trainer left checkpoints {ckpts} (expected {want}) and "
             f"model_last.msgpack {'present' if os.path.isfile(weights) else 'missing'}")
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.cli.eval", os.path.join(ROOT, "config", "synthetic.yml"),
         "--weights", weights, "--device", "cuda"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=600,
    )
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"cli.eval exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    metrics = json.loads(lines[-1])
    if not 0.0 <= metrics.get("mAP@0.5", -1.0) <= 1.0:
        fail(f"cli.eval printed no mAP@0.5 in [0, 1]: {lines[-1]}")
    print(f"CLI trainer files: {', '.join(ckpts)}, model_last.msgpack "
          f"({os.path.getsize(weights) / 1e6:.1f} MB); cli.eval on it: mAP@0.5 "
          f"{metrics['mAP@0.5']:.4f}, mAP {metrics['mAP']:.4f} in {time.time() - t:.1f} s")


# the 80 sparse category ids of COCO-2017 (ids 1-90 with gaps), in category order
COCO_SPARSE_IDS = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]


def write_coco_fixture(np, root: str, size: int = 300, num_images: int = 640,
                       num_empty: int = 8) -> str:
    """A COCO-format train split of `num_images` synthetic size x size images and its
    packed cache, written with numpy alone. Synthetic class c is COCO label 10c; about 8 % of
    the boxes are iscrowd; `num_empty` images have no annotation (the packer skips
    them). Returns the cache's directory."""
    from ssd_object_detection_tpu_torch.data.coco import COCO_NAMES, open_split
    from ssd_object_detection_tpu_torch.data.packed import index_digest
    from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset

    max_gt = 100
    os.makedirs(os.path.join(root, "annotations"))
    os.makedirs(os.path.join(root, "train2017"))
    cache = os.path.join(root, "packed")
    os.makedirs(cache)
    ds = SyntheticDetectionDataset(num_images=num_images, image_size=size, max_gt=8, num_classes=8)
    rng = np.random.default_rng(1)
    gt = {"gt_cls": np.zeros((num_images, max_gt), np.int32),
          "gt_boxes": np.zeros((num_images, max_gt, 4), np.float32),
          "gt_valid": np.zeros((num_images, max_gt), bool),
          "gt_crowd": np.zeros((num_images, max_gt), bool),
          "image_id": np.zeros((num_images,), np.int64),
          "orig_size": np.full((num_images, 2), size, np.int32)}
    images, annotations = [], []
    empty_every = num_images // num_empty
    with open(os.path.join(cache, "images.u8"), "wb") as f:
        for i in range(num_images):
            if i % empty_every == 0:
                image_id = 900000 + i
                images.append({"id": image_id, "file_name": f"{image_id:012d}.jpg",
                               "width": size, "height": size})
            image, cls, boxes, valid = ds.sample(i)
            f.write(np.clip(np.round(image * 255.0), 0, 255).astype(np.uint8).tobytes())
            n = int(valid.sum())
            # COCO xywh pixels as float32, then the decode pipeline's own conversion
            xywh = np.concatenate([boxes[:n, :2] - boxes[:n, 2:] / 2, boxes[:n, 2:]], 1) * size
            xywh = xywh.astype(np.float32)
            crowd = rng.uniform(size=n) < 0.08
            image_id = 1000 + i
            images.append({"id": image_id, "file_name": f"{image_id:012d}.jpg",
                           "width": size, "height": size})
            for j in range(n):
                annotations.append({
                    "id": len(annotations) + 1, "image_id": image_id,
                    "category_id": COCO_SPARSE_IDS[10 * int(cls[j])],
                    "bbox": [float(x) for x in xywh[j]], "iscrowd": int(crowd[j]),
                    "area": float(xywh[j, 2] * xywh[j, 3]),
                })
            cxcywh = xywh.copy()
            cxcywh[:, :2] += cxcywh[:, 2:] / 2
            cxcywh /= np.array([size, size, size, size], np.float32)
            gt["gt_cls"][i, :n] = 10 * cls[:n]
            gt["gt_boxes"][i, :n] = cxcywh
            gt["gt_valid"][i, :n] = True
            gt["gt_crowd"][i, :n] = crowd
            gt["image_id"][i] = image_id
    with open(os.path.join(root, "annotations", "instances_train2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": n} for c, n in zip(COCO_SPARSE_IDS, COCO_NAMES)]}, f)
    np.savez(os.path.join(cache, "gt.npz"), **gt)
    with open(os.path.join(cache, "meta.json"), "w") as f:
        json.dump({"count": num_images, "image_size": size, "max_gt": max_gt, "version": 3,
                   "include_crowd": True, "index_digest": index_digest(open_split(root, "train"))}, f)
    return cache


def clone_tree(torch, tree):
    """A deep copy of a state_dict-like tree, tensors cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(torch, v) for v in tree)
    return tree


def trees_equal(torch, a, b) -> bool:
    """Bit equality of two state_dict-like trees."""
    if isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(b, dict):
        return set(a) == set(b) and all(trees_equal(torch, a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(torch, x, y) for x, y in zip(a, b))
    return a == b


def resume_tolerance(nondeterministic: list) -> float:
    """The relative loss difference allowed between the resumed run and the uninterrupted
    continuation: 0 (bit-equal) when torch.use_deterministic_algorithms raised no
    warning on either run; otherwise 2e-2, about five bf16 ulps of a loss, for 20 Adam
    steps whose reductions may sum in another order."""
    return 0.0 if not nondeterministic else 2e-2


def trace_overlap(trace_path: str, wall_ms: float) -> str:
    """Read a torch.profiler chrome trace: the host-to-device copies (streams, kinds,
    time), the share of their time that overlaps a kernel on another stream, and the
    device-busy share of the profiled wall time."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    gpu = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not gpu:
        cats = sorted({str(e.get("cat")) for e in events})
        return f"torch.profiler recorded no device time on this machine (categories {cats})"

    def union(intervals):
        total, end = 0.0, -math.inf
        for a, b in sorted(intervals):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    def span(e):
        return (float(e["ts"]), float(e["ts"]) + float(e["dur"]))

    kernels = [e for e in gpu if e["cat"] == "kernel"]
    copies = [e for e in gpu if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    kernel_streams = {e.get("args", {}).get("stream") for e in kernels}
    copy_streams = sorted({e.get("args", {}).get("stream") for e in copies}, key=str)
    overlap = 0.0
    for c in copies:
        a, b = span(c)
        stream = c.get("args", {}).get("stream")
        cut = [(max(a, x), min(b, y)) for x, y in (span(k) for k in kernels
               if k.get("args", {}).get("stream") != stream) if x < b and y > a]
        overlap += union(cut)
    copy_us = sum(float(c["dur"]) for c in copies)
    busy_us = union([span(e) for e in gpu])
    kinds = sorted({c["name"] for c in copies})
    return (f"{len(copies)} host-to-device copies ({', '.join(kinds)}) on stream(s) "
            f"{copy_streams}, kernels on {sorted(kernel_streams, key=str)}; copies {copy_us / 1e3:.3f} ms, "
            f"{100 * overlap / copy_us if copy_us else 0.0:.1f} % of it under a kernel on another "
            f"stream; device busy {busy_us / 1e3:.3f} ms of {wall_ms:.3f} ms wall "
            f"({100 * busy_us / 1e3 / wall_ms:.1f} %)")


def production_config(root: str, cache: str, variant: str, num_images: int, batch_size: int,
                      resume: bool = False, epochs: int = 3):
    """Phase 4b's Trainer config: the packed COCO-format fixture, flip on the host, shuffle
    off, every step's losses logged (for the resume checks), a checkpoint per epoch."""
    from ssd_object_detection_tpu_torch.config import Config

    cfg = Config()
    d, mc = cfg.data, cfg.model
    d.dataset, d.dataset_root, d.packed_cache = "coco", root, cache
    d.num_classes, d.max_gt, d.shuffle, d.augment.flip = 80, 100, False, True
    mc.variant, mc.precision, mc.log_dir = variant, "bfloat16", os.path.join(root, "runs")
    mc.log_interval, mc.log_scalar_interval = 0, 1
    mc.train.batch_size, mc.train.epoch = batch_size, epochs
    mc.warmup.step = num_images // batch_size
    mc.checkpoint.keep, mc.checkpoint.resume = 2, resume
    return cfg


def production_phase(torch, np, dev, bare_step_ms: float, variant: str = "ssd300",
                     num_images: int = 640, batch_size: int = 32, card: str = "") -> int:
    """4b. The Trainer's production path on the card at full width (the defaults), then
    4c on the same fixture; returns 4c's matcher launches."""
    from torch.profiler import ProfilerActivity, profile

    from ssd_object_detection_tpu_torch.data.packed import PackedConfig, PackedPipeline
    from ssd_object_detection_tpu_torch.models.convert import load_params_msgpack
    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.train.loop import Trainer
    from ssd_object_detection_tpu_torch.train.step import create_train_state

    with tempfile.TemporaryDirectory(prefix="chip_smoke_coco_") as root:
        t = time.time()
        spec = MODEL_SPECS[variant]
        cache = write_coco_fixture(np, root, spec.image_size, num_images)
        mb = os.path.getsize(os.path.join(cache, "images.u8")) / 1e6
        print(f"production fixture: {num_images} + 8 unannotated COCO-format images at "
              f"{spec.image_size}x{spec.image_size}, packed cache {mb:.1f} MB of uint8 images, "
              f"written in {time.time() - t:.1f} s")

        def config(resume: bool = False):
            return production_config(root, cache, variant, num_images, batch_size, resume)

        # ---- train: warmup + 3 epochs, a checkpoint per epoch ------------------------
        run = os.path.join(root, "run")
        trainer = Trainer(config(), run_dir=run, device=dev)
        saved, save_ms = {}, []
        save_checkpoint = trainer.save_checkpoint

        def save_and_keep(state, tag, phase):  # what the epoch-2 checkpoint holds, in memory
            torch.cuda.synchronize()
            t = time.perf_counter()
            save_checkpoint(state, tag, phase)
            save_ms.append((time.perf_counter() - t) * 1e3)
            if tag == 2:
                saved.update(model=clone_tree(torch, state.model.state_dict()),
                             optimizer=clone_tree(torch, state.optimizer.state_dict()), step=state.step)

        trainer.save_checkpoint = save_and_keep
        cuda_matcher.match_anchors_cuda.launches = 0
        t = time.time()
        state = trainer.train()
        torch.cuda.synchronize()
        train_s = time.time() - t
        launches = cuda_matcher.match_anchors_cuda.launches
        mc = trainer.cfg.model
        per_epoch = num_images // batch_size
        steps = mc.warmup.step + mc.train.epoch * per_epoch
        if launches != steps * trainer.step_cfg.accum_steps or state.step != mc.train.epoch * per_epoch:
            fail(f"production Trainer: {launches} matcher launches and step {state.step}, expected "
                 f"{steps * trainer.step_cfg.accum_steps} launches and step {mc.train.epoch * per_epoch}")
        losses = [h["loss"] for h in trainer.history]
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            fail(f"production Trainer: {len(losses)} logged losses of {steps}, or a non-finite one")
        ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
        if ckpts != ["ckpt_2.pt", "ckpt_3.pt"] or not os.path.isfile(os.path.join(run, "model_last.msgpack")):
            fail(f"production Trainer left {ckpts} and {sorted(os.listdir(run))}")
        ckpt_mb = os.path.getsize(os.path.join(run, "checkpoints", "ckpt_3.pt")) / 1e6
        print(f"production Trainer ({variant} bf16, 81 classes, batch {batch_size}, max_gt 100, packed "
              f"COCO-format feed, flip, device_prefetch depth {trainer.cfg.data.device_prefetch}): "
              f"warmup {mc.warmup.step} + {mc.train.epoch} x {per_epoch} steps in {train_s:.1f} s, "
              f"matcher launches {launches}, loss {losses[0]:.4f} -> {losses[-1]:.4f}; left {ckpts} "
              f"and model_last.msgpack")

        # ---- weights across: the export into a fresh SSD, one forward -----------------
        batch = next(iter(trainer.train_batches()))
        images = torch.from_numpy(batch["image"]).to(dev)
        x = (images.float() / 255.0 - 0.5) * 2.0
        fresh = SSD(num_classes=81, spec=spec, dtype=torch.bfloat16)
        t = time.perf_counter()
        load_params_msgpack(fresh, os.path.join(run, "model_last.msgpack"))
        load_ms = (time.perf_counter() - t) * 1e3
        fresh = fresh.to(dev)
        with torch.no_grad():
            want, got = trainer.model(x), fresh(x)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail("the exported msgpack's forward differs from the trained model's")
        t = time.perf_counter()
        export_path = trainer.export_params("timed_export")
        export_ms = (time.perf_counter() - t) * 1e3
        export_mb = os.path.getsize(export_path) / 1e6
        print(f"weights across: model_last.msgpack loaded into a fresh SSD, forward on a "
              f"batch of {batch_size} bit-equal to the trained model's (loc {tuple(got[0].shape)}, conf "
              f"{tuple(got[1].shape)})")
        del fresh, want, got

        # ---- resume: tag 2 restored bit-equal, epoch 3 against a continuation ----------
        os.remove(os.path.join(run, "checkpoints", "ckpt_3.pt"))
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            resumed = Trainer(config(resume=True), run_dir=run, device=dev)
            probe = create_train_state(resumed.model, resumed._optimizer(resumed.cfg.model.train),
                                       resumed.main_schedule)
            torch.cuda.synchronize()
            t = time.perf_counter()
            tag = resumed.restore_latest(probe)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t) * 1e3
            if tag != 2 or probe.step != saved["step"] \
                    or not trees_equal(torch, resumed.model.state_dict(), saved["model"]) \
                    or not trees_equal(torch, probe.optimizer.state_dict(), saved["optimizer"]):
                fail(f"resume: tag {tag}, step {probe.step}; the restored params, Adam moments or "
                     f"step differ from what the epoch-2 checkpoint saved (step {saved['step']})")
            del probe
            rstate = resumed.train()
            # the uninterrupted continuation: the in-memory epoch-2 state, the same batches
            ref = Trainer(config(), run_dir=os.path.join(root, "continuation"), device=dev)
            ref.model.load_state_dict(saved["model"])
            cstate = create_train_state(ref.model, ref._optimizer(ref.cfg.model.train), ref.main_schedule)
            cstate.optimizer.load_state_dict(saved["optimizer"])
            cstate.step = saved["step"]
            ref._run_phase("train", cstate, ref.train_batches(epochs=1))
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        nondeterministic = sorted({str(w.message)[:120] for w in caught
                                   if "deterministic" in str(w.message)})
        got = [h["loss"] for h in resumed.history]
        want = [h["loss"] for h in ref.history]
        stages = {h["stage"] for h in resumed.history}
        if rstate.step != state.step or stages != {"train"} or len(got) != per_epoch or len(want) != per_epoch:
            fail(f"resume: step {rstate.step}, stages {stages}, {len(got)} and {len(want)} losses")
        tol = resume_tolerance(nondeterministic)
        rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))
        if rel > tol:
            fail(f"resume: epoch-3 losses differ from the continuation by {rel:.3e} relative "
                 f"(tolerance {tol}); nondeterministic ops: {nondeterministic}")
        flipped = [h["loss"] for h in trainer.history][-per_epoch:]
        print(f"resume from ckpt_2.pt: params, Adam moments and step {saved['step']} bit-equal to "
              f"what was saved; warmup skipped; epoch-3 losses vs the continuation: max relative "
              f"difference {rel:.3e} (tolerance {tol}; nondeterministic-op warnings: "
              f"{nondeterministic or 'none'}); the data order restarts from the seed as in the "
              f"JAX Trainer, so its flips are epoch 0's and its losses {got[0]:.4f} .. {got[-1]:.4f} "
              f"are not the uninterrupted run's epoch 3 ({flipped[0]:.4f} .. {flipped[-1]:.4f})")
        print(f"checkpoint: {ckpt_mb:.1f} MB (params, Adam moments, step), save "
              f"{', '.join(f'{ms:.1f}' for ms in save_ms)} ms, restore {restore_ms:.1f} ms; "
              f"msgpack export {export_mb:.1f} MB in {export_ms:.1f} ms, load {load_ms:.1f} ms")
        del resumed, rstate, ref, cstate, saved

        # ---- the feed alone: host ms per packed batch, pinning, one batch's upload -------
        def host_ms_per_batch(flip: bool):
            pipe = PackedPipeline(cache, PackedConfig(batch_size=batch_size, shuffle=False,
                                                      augment_flip=flip))
            t = time.perf_counter()
            batches = list(pipe)
            return (time.perf_counter() - t) * 1e3 / len(batches), batches

        gather_ms, _ = host_ms_per_batch(False)
        host_ms, host_batches = host_ms_per_batch(True)
        host_images = [torch.from_numpy(b["image"]) for b in host_batches]
        t = time.perf_counter()
        pinned = [x.pin_memory() for x in host_images]  # each a new page-locked allocation
        first_pin_ms = (time.perf_counter() - t) * 1e3 / len(pinned)
        del pinned
        torch.cuda.synchronize()
        t = time.perf_counter()
        for x in host_images:  # as the prefetch pins: each block freed before the next batch
            x.pin_memory()
        pin_ms = (time.perf_counter() - t) * 1e3 / len(host_images)
        pinned = host_images[0].pin_memory()
        nbytes = host_batches[0]["image"].nbytes
        pageable_ms = cuda_ms(torch, lambda: host_images[0].to(dev))
        pinned_ms = cuda_ms(torch, lambda: pinned.to(dev, non_blocking=True))
        print(f"packed feed: {host_ms:.3f} ms of host time per batch of {batch_size} "
              f"({gather_ms:.3f} ms of it the memmap gather alone, the rest the flip); "
              f"pin_memory {pin_ms:.3f} ms per batch when its block is reused "
              f"({first_pin_ms:.3f} ms for a new one); upload of one batch's "
              f"{nbytes / 1e6:.2f} MB of images: pageable {pageable_ms:.3f} ms, pinned "
              f"{pinned_ms:.3f} ms ({nbytes / pinned_ms / 1e6:.1f} GB/s)")
        del host_images, pinned

        # ---- steady state: the Trainer's ms per step against the bare step -------------
        trainer.cfg.model.log_scalar_interval = 20  # the config default: one fetch in 20
        timed = create_train_state(trainer.model, trainer._optimizer(mc.train), trainer.main_schedule)
        trainer._run_phase("train", timed, trainer.train_batches(epochs=1))  # warm

        def epoch_ms(batches) -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer._run_phase("train", timed, batches)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3

        packed_ms = [epoch_ms(trainer.train_batches(epochs=1)) for _ in range(2)]
        # the same Trainer loop on batches already assembled in memory: the feed's share
        memory_ms = [epoch_ms(host_batches) for _ in range(2)]
        step_ms = sum(packed_ms) / (2 * per_epoch)
        memory_step_ms = sum(memory_ms) / (2 * per_epoch)
        print(f"Trainer steady state on the packed feed: {step_ms:.2f} ms per step "
              f"({', '.join(f'{ms / per_epoch:.2f}' for ms in packed_ms)} per epoch of {per_epoch}, "
              f"each from a fresh prefetch) = {batch_size / step_ms * 1e3:.1f} img/s; the same loop on "
              f"batches already in host memory {memory_step_ms:.2f} ms "
              f"({', '.join(f'{ms / per_epoch:.2f}' for ms in memory_ms)}); phase 3's bare train "
              f"step (pageable upload inside) {bare_step_ms:.2f} ms = "
              f"{batch_size / bare_step_ms * 1e3:.1f} img/s")
        del host_batches

        # ---- one profile of 5 Trainer steps ---------------------------------------------
        batches = trainer.train_batches(epochs=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer._run_phase("train", timed, batches, max_steps=timed.step + 5)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        trace = os.path.join(root, "trainer_trace.json")
        prof.export_chrome_trace(trace)
        groups = group_kernels(profiled_kernels(prof), TRAIN_GROUPS)
        print(f"profile of 5 Trainer steps: {trace_overlap(trace, wall_ms)}; device time by "
              f"group: {format_groups(groups)}; {sum(groups.values()) / 5:.3f} ms of device time "
              f"per step against {step_ms:.2f} ms per unprofiled step")
        del trainer, timed, state, x, images
        torch.cuda.empty_cache()
        return device_augment_phase(torch, np, dev, root, cache, step_ms, card, variant,
                                    num_images, batch_size)


def device_augment_phase(torch, np, dev, root: str, cache: str, flip_step_ms: float, card: str,
                         variant: str, num_images: int, batch_size: int) -> int:
    """4c. The Trainer with the full recipe (flip, expand, crop, photometric) on the
    device, on phase 4b's packed fixture; returns its matcher launches."""
    from ssd_object_detection_tpu_torch.data.packed import PackedConfig, PackedPipeline
    from ssd_object_detection_tpu_torch.ops import augment, cuda_matcher
    from ssd_object_detection_tpu_torch.train.loop import Trainer
    from ssd_object_detection_tpu_torch.train.step import create_train_state, make_train_step
    from ssd_object_detection_tpu_torch.utils.device import true_divide

    recipe = augment.AugConfig()
    plain_batches = list(PackedPipeline(cache, PackedConfig(batch_size=batch_size, shuffle=False,
                                                            augment_flip=False)))
    # ---- the augmentation on the card against the CPU, from the same draws ------------
    host = [torch.from_numpy(plain_batches[0][k]) for k in ("image", "gt_boxes", "gt_cls", "gt_valid")]
    on_card = [x.to(dev) for x in host]
    draws = augment.draw_augment(torch.Generator(device=dev).manual_seed(0), batch_size, recipe, dev)
    draws_cpu = augment.AugDraws(*(x.cpu() for x in draws))
    got = [x.cpu() for x in augment.augment_batch(*on_card, recipe, draws)]
    want = augment.augment_batch(*host, recipe, draws_cpu)
    window, rect, flip = (x.cpu() for x in augment.geometry_from_draws(on_card[1], on_card[3],
                                                                      recipe, draws))
    want_geometry = augment.geometry_from_draws(host[1], host[3], recipe, draws_cpu)
    for name, a, b in (("valid", got[3], want[3]), ("cls", got[2], want[2]), ("boxes", got[1], want[1]),
                       ("crop rect", rect, want_geometry[1]), ("flip", flip, want_geometry[2]),
                       ("expand window", window, want_geometry[0])):
        if not torch.equal(a, b):
            fail(f"augmentation {name}: card and CPU differ in {int((a != b).sum())} entries")
    pixel_err = (got[0] - want[0]).abs().max().item()
    if not pixel_err <= 2e-5:
        fail(f"augmentation pixels: card and CPU differ by {pixel_err:.3e} (tolerance 2e-5)")
    expanded = int(((window[:, 2] - window[:, 0]) < 1).sum())
    cropped = int((rect != torch.tensor([0.0, 0.0, 1.0, 1.0])).any(-1).sum())
    size = host[0].shape[1]
    print(f"augmentation card == CPU on one packed batch ({batch_size} x {size}x{size}, max_gt 100) from "
          f"the same draws: valid, cls, boxes, crop rects, flips and expand windows bit-equal, "
          f"pixels within {pixel_err:.3e} (tolerance 2e-5); {expanded} expanded, {cropped} cropped, "
          f"{int(flip.sum())} flipped, {int(want[3].sum())} of {int(host[3].sum())} GTs kept")

    # ---- its stages on the card (CUDA events) ------------------------------------------
    img01 = true_divide(on_card[0].float(), 255.0)
    s_in = img01.shape[1]
    a, b = torch.ones(batch_size, device=dev), torch.zeros(batch_size, device=dev)
    ry = augment.axis_matrix(a, b, s_in, s_in)
    planar = img01.permute(0, 3, 1, 2).contiguous()
    stages = {
        "photometric": lambda: augment.photometric(img01, draws.photometric, 0.5),
        "geometry from draws (50 crop attempts)":
            lambda: augment.geometry_from_draws(on_card[1], on_card[3], recipe, draws),
        "matrix build (2 x (B, S, S))":
            lambda: (augment.axis_matrix(a, b, s_in, s_in), augment.axis_matrix(a, b, s_in, s_in)),
        "two float32 products":
            lambda: torch.matmul(torch.matmul(ry[:, None], planar), ry[:, None].transpose(-1, -2)),
        "augment_batch whole": lambda: augment.augment_batch(*on_card, recipe, draws),
    }
    stage_ms = {k: (cuda_ms(torch, fn), graph_ms(torch, fn, calls=10, replays=3), device_ms(torch, fn))
                for k, fn in stages.items()}
    whole_ms = stage_ms["augment_batch whole"][1]
    flop = 2 * 2 * batch_size * 3 * s_in ** 3
    products_bound = flop / FP32_OPS_PER_S * 1e3
    print(f"augmentation on the card, batch {batch_size} at {s_in}x{s_in} [{card}], by stage "
          "(CUDA events per call / card time replayed from a CUDA graph / kernel time in "
          "torch.profiler): "
          + ", ".join(f"{k} {ev:.3f} / {gr:.3f} / {dev_ms:.3f} ms" for k, (ev, gr, dev_ms) in stage_ms.items())
          + f"; the products are {flop / 1e9:.2f} GFLOP of float32, bound {products_bound:.3f} ms "
          f"at 67 TFLOP/s (TF32 off), {2 * ry.numel() * 4 / 1e6:.1f} MB of matrices")
    # what the products' kernel time stands on: its kernels, a bare bmm of the same shape
    # back to back, and the SM count and clock under that load
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        products = stages["two float32 products"]
        for activities in ([ProfilerActivity.CPU, ProfilerActivity.CUDA], [ProfilerActivity.CUDA]):
            products()
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                products()
                torch.cuda.synchronize()
            print(f"  torch.profiler ({' + '.join(a.name for a in activities)} tracing from the "
                  f"call's start) of the products: {len(prof.events())} events; by key: " + "; ".join(
                      f"{e.key[:90]} [{str(e.device_type).split('.')[-1]}] {e.count}x self device "
                      f"{e.self_device_time_total:.1f} us, device {e.device_time_total:.1f} us"
                      for e in prof.key_averages()))
        print("  the same after one warm-up step of the profiler (device tracing): " + "; ".join(
            f"{name[:90]} {calls}x {ms * 1e3:.1f} us" for ms, calls, name in device_kernels(torch, products)))
        per_channel = ry.repeat_interleave(3, 0)
        stacked = planar.reshape(-1, s_in, s_in)

        def bmm():
            return torch.bmm(per_channel, stacked)

        bmm_ms = stream_ms(torch, bmm, warmup=5, iters=200)
        bmm_kernels = device_kernels(torch, bmm)
        readings = sm_clock_under_load(torch, bmm)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        clock = statistics.median(r[0] for r in readings) if readings else float("nan")
        peak = sms * 128 * 2 * clock * 1e6  # 128 float32 lanes an SM, an FMA is 2 operations
        print(f"  one product as a bare bmm ({per_channel.shape[0]} x {s_in}^3, {flop / 2e9:.2f} GFLOP): "
              f"{bmm_ms:.4f} ms a call back to back (CUDA events, 200 calls) = "
              f"{flop / 2 / bmm_ms / 1e9:.1f} TFLOP/s; kernels in torch.profiler "
              + "; ".join(f"{ms:.4f} ms {calls}x {name[:80]}" for ms, calls, name in bmm_kernels)
              + f"; {sms} SMs, SM clock under this load {sorted(r[0] for r in readings)} MHz (max "
              f"{readings[0][1] if readings else 'not read'}), power {[r[2] for r in readings]} W "
              f"-> float32 peak at the median clock {peak / 1e12:.2f} TFLOP/s [{card}]")
        del per_channel, stacked
    del img01, ry, planar, on_card, got, want

    # ---- the Trainer: warmup + 2 epochs, a checkpoint per epoch ------------------------
    def config(resume: bool = False):
        cfg = production_config(root, cache, variant, num_images, batch_size, resume, epochs=2)
        aug = cfg.data.augment
        aug.device, aug.flip, aug.expand, aug.crop, aug.photometric = True, True, True, True, True
        return cfg

    run = os.path.join(root, "run_aug")
    trainer = Trainer(config(), run_dir=run, device=dev)
    if trainer.step_cfg.augment != recipe:
        fail(f"phase 4c: the Trainer's step augments with {trainer.step_cfg.augment}, not {recipe}")
    saved = {}
    save_checkpoint = trainer.save_checkpoint

    def save_and_keep(state, tag, phase):
        save_checkpoint(state, tag, phase)
        if tag == 1:
            saved.update(model=clone_tree(torch, state.model.state_dict()),
                         optimizer=clone_tree(torch, state.optimizer.state_dict()), step=state.step)

    trainer.save_checkpoint = save_and_keep
    cuda_matcher.match_anchors_cuda.launches = 0
    t = time.time()
    state = trainer.train()
    torch.cuda.synchronize()
    train_s = time.time() - t
    launches = cuda_matcher.match_anchors_cuda.launches
    mc = trainer.cfg.model
    per_epoch = num_images // batch_size
    steps = mc.warmup.step + mc.train.epoch * per_epoch
    losses = [h["loss"] for h in trainer.history]
    if launches != steps * trainer.step_cfg.accum_steps or len(losses) != steps \
            or not all(math.isfinite(x) for x in losses):
        fail(f"phase 4c Trainer: {launches} matcher launches, {len(losses)} losses, expected {steps}")
    source = trainer._train_source
    fed = next(iter(source))
    if source.cfg.augment_flip or not np.array_equal(fed["image"], plain_batches[0]["image"]):
        fail("phase 4c: the packed feed flipped on the host (PackedConfig.augment_flip "
             f"{source.cfg.augment_flip}) or fed other pixels than the unflipped cache")
    print(f"phase 4c Trainer ({variant} bf16, 81 classes, batch {batch_size}, max_gt 100, packed feed, "
          f"flip + expand + crop + photometric on the device): warmup {mc.warmup.step} + "
          f"{mc.train.epoch} x {per_epoch} steps in {train_s:.1f} s, matcher launches {launches}, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; PackedConfig.augment_flip False and the feed's "
          f"first batch equals the unflipped cache: the host flip did not run [{card}]")

    # ---- resume from the epoch-1 checkpoint: epoch 2 against a continuation ------------
    os.remove(os.path.join(run, "checkpoints", "ckpt_2.pt"))
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        resumed = Trainer(config(resume=True), run_dir=run, device=dev)
        rstate = resumed.train()
        ref = Trainer(config(), run_dir=os.path.join(root, "continuation_aug"), device=dev)
        ref.model.load_state_dict(saved["model"])
        cstate = create_train_state(ref.model, ref._optimizer(ref.cfg.model.train), ref.main_schedule)
        cstate.optimizer.load_state_dict(saved["optimizer"])
        cstate.step = saved["step"]
        ref._run_phase("train", cstate, ref.train_batches(epochs=1))
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    nondeterministic = sorted({str(w.message)[:120] for w in caught if "deterministic" in str(w.message)})
    got = [h["loss"] for h in resumed.history]
    want = [h["loss"] for h in ref.history]
    if rstate.step != state.step or len(got) != per_epoch or got != want:
        fail(f"phase 4c resume: step {rstate.step} (want {state.step}); epoch-2 losses {got} differ "
             f"from the continuation's {want}; nondeterministic-op warnings: {nondeterministic}")
    uninterrupted = losses[-per_epoch:]
    rel = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(got, uninterrupted))
    print(f"phase 4c resume from ckpt_1.pt: epoch-2 losses bit-equal to the continuation (the draws "
          f"are keyed on the step); nondeterministic-op warnings: {nondeterministic or 'none'}; "
          f"against the uninterrupted run's epoch 2 (trained without deterministic algorithms) "
          f"max relative difference {rel:.3e}")
    del resumed, rstate, ref, cstate, saved

    # ---- steady state against phase 4b's flip-only figure, and one profiled step -------
    trainer.cfg.model.log_scalar_interval = 20
    timed = create_train_state(trainer.model, trainer._optimizer(mc.train), trainer.main_schedule)
    trainer._run_phase("train", timed, trainer.train_batches(epochs=1))  # warm

    def epoch_ms() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer._run_phase("train", timed, trainer.train_batches(epochs=1))
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    epochs_ms = [epoch_ms() for _ in range(2)]
    step_ms = sum(epochs_ms) / (2 * per_epoch)
    dbatch = {k: torch.from_numpy(v).to(dev) for k, v in plain_batches[1].items()
              if k in ("image", "gt_cls", "gt_boxes", "gt_valid")}
    groups = group_kernels(device_kernels(torch, lambda: trainer.train_step(timed, dbatch)),
                           TRAIN_GROUPS)
    step_device_ms = sum(groups.values())
    # host time to enqueue one step (it returns before the card finishes), with and
    # without the augmentation: where it nears the step time, the step waits on the host
    unaugmented = make_train_step(trainer.anchors, dataclasses.replace(trainer.step_cfg, augment=None))

    def enqueue_ms(step_fn) -> float:
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step_fn(timed, dbatch)
            times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    enqueue = [enqueue_ms(f) for f in (trainer.train_step, unaugmented, unaugmented, trainer.train_step)]
    print(f"phase 4c Trainer steady state with device augmentation: {step_ms:.2f} ms per step "
          f"({', '.join(f'{ms / per_epoch:.2f}' for ms in epochs_ms)} per epoch of {per_epoch}) = "
          f"{batch_size / step_ms * 1e3:.1f} img/s, beside phase 4b's flip-only {flip_step_ms:.2f} ms "
          f"= {batch_size / flip_step_ms * 1e3:.1f} img/s in this process [{card}]; one profiled "
          f"augmented step: {step_device_ms:.3f} ms of kernels kept by torch.profiler, a lower bound "
          f"on its device time ({format_groups(groups)}), beside it "
          f"the augmentation {whole_ms:.3f} ms (replayed from a CUDA graph above) "
          f"({100 * whole_ms / step_device_ms if step_device_ms else 0.0:.1f} %); host time to "
          f"enqueue one step on a batch already on the card, in turns augmented, unaugmented, "
          f"unaugmented, augmented: {', '.join(f'{x:.2f}' for x in enqueue)} ms")
    del trainer, timed, state, dbatch
    torch.cuda.empty_cache()
    return launches


def serve_phase(torch, np, dev, card: str, variant: str = "ssd300",
                tiers=(1, 8, 32)) -> None:
    """7b. Serving at full width (the defaults): the live DetectorService per batch tier,
    the exported bundle served through from_artifact (equal to live), and the batching
    front end."""
    import threading

    from ssd_object_detection_tpu_torch.eval import serve
    from ssd_object_detection_tpu_torch.eval.runner import _fetch_detections
    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
    from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
    from ssd_object_detection_tpu_torch.ops.preprocess import pack_canvas

    spec, batch, canvas_hw = MODEL_SPECS[variant], max(tiers), (640, 640)
    model = SSD(num_classes=81, spec=spec, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    anchors = generate_anchors(spec.anchor_spec)
    kw = dict(image_size=spec.image_size, canvas_hw=canvas_hw, score_thresh=0.01)
    live = serve.DetectorService(model, anchors, batch_size=batch, batch_tiers=tiers, **kw)
    requests = {t: mixed_images(np, t, seed=t) for t in tiers}

    def latency(service, t: int):
        for _ in range(3):
            service.detect_images(requests[t])
        times = []
        for _ in range(20):
            start = time.perf_counter()
            service.detect_images(requests[t])
            times.append((time.perf_counter() - start) * 1e3)
        return statistics.median(times), np.percentile(times, 90)

    def split(t: int) -> str:
        """One live request's host clock by stage (each ending in a synchronize), and the
        program's device time: the sum of its kernels in torch.profiler."""
        marks = [time.perf_counter()]
        canvas, sizes = pack_canvas(requests[t], canvas_hw)
        marks.append(time.perf_counter())
        canvas_t, sizes_t = torch.from_numpy(canvas).to(dev), torch.from_numpy(sizes).to(dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        det = live._predict(canvas_t, sizes_t)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        _fetch_detections(det)
        marks.append(time.perf_counter())
        live.detect_images(requests[t])
        marks.append(time.perf_counter())
        names = ("canvas pack", "upload", "program", "fetch", "whole detect_images")
        program = (device_ms(torch, lambda: live._predict(canvas_t, sizes_t)),
                   graph_ms(torch, lambda: live._predict(canvas_t, sizes_t), calls=5, replays=3))
        return (", ".join(f"{n} {(b - a) * 1e3:.3f}" for n, a, b in zip(names, marks, marks[1:]))
                + f"; the program's device time {program[0]:.3f} (its kernels in torch.profiler), "
                f"{program[1]:.3f} (replayed from a CUDA graph)")

    live.warm()
    for t in tiers:
        split(t)
        print(f"serve live tier {t} host clock by stage, ms [{card}]: {split(t)}")

    export_s = {}
    for t in tiers:
        start = time.time()
        blob = serve.export_fused_detector(model, anchors, batch_size=t, **kw)
        export_s[t] = (time.time() - start, len(blob))
    del blob
    start = time.time()
    bundle = serve.export_fused_detector_bundle(model, anchors, tiers, **kw)
    bundle_s = time.time() - start
    start = time.time()
    art = serve.DetectorService.from_artifact(bundle, device=dev)
    load_s = time.time() - start
    if art._tiers != list(tiers) or art._canvas_hw != canvas_hw:
        fail(f"artifact bundle: tiers {art._tiers}, canvas {art._canvas_hw}")
    print(f"export bundle (tiers {list(tiers)}) [{card}]: "
          + ", ".join(f"tier {t} {s:.1f} s ({n / 1e6:.1f} MB)" for t, (s, n) in sorted(export_s.items()))
          + f"; the bundle of all tiers {bundle_s:.1f} s, {len(bundle) / 1e6:.1f} MB; "
          f"from_artifact {load_s:.1f} s")
    for t in tiers:
        got, want = art.detect_images(requests[t]), live.detect_images(requests[t])
        if json.dumps(got) != json.dumps(want):
            fail(f"artifact tier {t}: detections differ from the live service's")
        canvas_t, sizes_t = (torch.from_numpy(x).to(dev) for x in pack_canvas(requests[t], canvas_hw))
        program_ms = [device_ms(torch, lambda s=s: s._predict(canvas_t, sizes_t)) for s in (live, art)]
        print(f"artifact tier {t}: {sum(len(d) for d in got)} detections on {t} images, equal to "
              f"the live service's; the program's device time (its kernels in torch.profiler) "
              f"live {program_ms[0]:.3f} / artifact {program_ms[1]:.3f} ms [{card}]")
    art.warm()
    for t in tiers:  # in turns: live, artifact, artifact, live
        turns = [latency(service, t) for service in (live, art, art, live)]
        p50 = [x[0] for x in turns]
        p90 = [x[1] for x in turns]
        print(f"serve tier {t} ({variant} bf16, canvas 640x640, score 0.01) [{card}]: "
              f"detect_images median / p90 over 20 calls, in turns live, artifact, artifact, live: "
              + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in zip(p50, p90))
              + f" ms; live {2 * t / (p50[0] + p50[3]) * 1e3:.1f} img/s, artifact "
              f"{2 * t / (p50[1] + p50[2]) * 1e3:.1f} img/s (canvas pack, upload, program, one "
              f"fetch and the detection dicts, host clock)")
    del art, bundle

    # ---- the batching front end: 64 threads x 4 single-image requests ------------------
    images = mixed_images(np, 256, seed=3)
    dispatched = []
    detect_images = live.detect_images

    def counting(batch_images):
        start = time.perf_counter()
        result = detect_images(batch_images)
        dispatched.append((len(batch_images), (time.perf_counter() - start) * 1e3))
        return result

    live.detect_images = counting
    front = serve.BatchingFrontEnd(live)
    request_ms, errors = [], []

    def client(i: int):
        try:
            for j in range(4):
                start = time.perf_counter()
                front.submit(images[4 * i + j])
                request_ms.append((time.perf_counter() - start) * 1e3)
        except Exception as e:  # reported below; the phase fails on any
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(64)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall_s = time.perf_counter() - start
    front.close()
    live.detect_images = detect_images
    if errors or len(request_ms) != 256 or any(t.is_alive() for t in threads):
        fail(f"batching front end: {len(request_ms)} of 256 requests answered, errors {errors[:3]}")
    print(f"BatchingFrontEnd over the live service, 64 threads x 4 single uint8 images of mixed "
          f"sizes [{card}]: {256 / wall_s:.1f} img/s, request p50 {np.percentile(request_ms, 50):.2f} ms, "
          f"p99 {np.percentile(request_ms, 99):.2f} ms, {len(dispatched)} dispatches, mean batch "
          f"{statistics.mean(n for n, _ in dispatched):.2f} (sizes {[n for n, _ in dispatched]}); the "
          f"dispatcher ran detect_images {sum(ms for _, ms in dispatched):.1f} ms of the "
          f"{wall_s * 1e3:.1f} ms wall")
    del live, model
    torch.cuda.empty_cache()


# ---- 3c. data parallelism --------------------------------------------------------------
DP_STEPS = 3  # per precision


def dp_fresh_state(torch, dev, dtype, variant: str):
    """The variant at full width (81 classes, f32 params) from the seed-0 weights, Adam."""
    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
    from ssd_object_detection_tpu_torch.train.optim import exponential_decay, make_optimizer
    from ssd_object_detection_tpu_torch.train.step import create_train_state

    model = SSD(num_classes=81, spec=MODEL_SPECS[variant], dtype=dtype)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    return create_train_state(model, make_optimizer("adam", model.parameters()),
                              exponential_decay(1e-3, 100, 0.99))


def dp_batches(np, num_images: int, batch_size: int, image_size: int, shard=None, seed: int = 0):
    """uint8 synthetic batches at max_gt 100 (with a shard: this rank's rows of each)."""
    from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset

    ds = SyntheticDetectionDataset(num_images=num_images, image_size=image_size, max_gt=100,
                                   num_classes=8, seed=seed)
    out = []
    for b in ds.batches(batch_size, shard=shard):
        b["image"] = np.round(b["image"] * 255.0).astype(np.uint8)
        out.append(b)
    return out


def dp_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def dp_run_steps(torch, dev, state, step, batches, keep_params: bool = False, after=None) -> list:
    """One train step per batch (global batch 32): the metrics, host ms (the step ends in
    a synchronize), and with keep_params the parameters after it on the host."""
    out = []
    for batch in batches:
        dp_sync(torch, dev)
        t = time.perf_counter()
        metrics = step(state, batch, global_batch=32)
        dp_sync(torch, dev)
        record = {k: float(v) for k, v in metrics.items()}
        record["ms"] = (time.perf_counter() - t) * 1e3
        if keep_params:
            record["params"] = [p.detach().to("cpu", torch.float32, copy=True)
                                for p in state.model.parameters()]
        if after is not None:
            after(state)
        out.append(record)
    return out


def one_process_f32(torch, dev, variant: str, plain, global_batches, split_min_channels=None):
    """The float32 steps of the data-parallel phases in one process at batch 32 from the
    seed-0 weights, whole and as two halves of 16 (the yardstick of batch-16 arithmetic),
    and with `split_min_channels` also as halves whose convs of at least that many output
    channels run as two halves of their channels (a (2, 2) grid's arithmetic in one
    process): (initial parameters, dp_run_steps of the whole, of the halves, of the split
    halves or None), parameters on the host in model.parameters() order."""
    from types import SimpleNamespace

    from ssd_object_detection_tpu_torch.models.vgg import float_conv
    from ssd_object_detection_tpu_torch.parallel.shardings import tp_eligible

    class Halves(torch.nn.Module):
        """The model run on each half of the batch: what two data ranks compute."""

        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            outs = [self.inner(h) for h in x.chunk(2)]
            return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    class SplitConv(torch.nn.Module):
        """A conv computed as two halves of its output channels, concatenated."""

        def __init__(self, conv):
            super().__init__()
            self.conv = conv
            self.kernel_size, self.stride, self.dilation = conv.kernel_size, conv.stride, conv.dilation

        def conv_nchw(self, x, pads, dtype):
            c, half = self.conv, self.conv.out_channels // 2
            outs = [float_conv(x, SimpleNamespace(
                weight=c.weight[lo:lo + half], bias=None if c.bias is None else c.bias[lo:lo + half],
                stride=c.stride, dilation=c.dilation, groups=c.groups), pads, dtype) for lo in (0, half)]
            return torch.cat(outs, dim=1).contiguous(memory_format=torch.channels_last)

    def run(halves: bool, split: bool):
        state = dp_fresh_state(torch, dev, torch.float32, variant)
        if split:
            for name in [n for n, m in state.model.named_modules() if tp_eligible(m, 2, split_min_channels)]:
                parent, _, leaf = name.rpartition(".")
                module = state.model.get_submodule(parent) if parent else state.model
                setattr(module, leaf, SplitConv(getattr(module, leaf)))
        if halves:
            state.model = Halves(state.model)
        return dp_run_steps(torch, dev, state, plain, global_batches, keep_params=True)

    init = [p.detach().to("cpu", torch.float32, copy=True)
            for p in dp_fresh_state(torch, dev, torch.float32, variant).model.parameters()]
    split = run(True, True) if split_min_channels is not None else None
    return init, run(False, False), run(True, False), split


def l2_distance(torch, a, b) -> float:
    return math.sqrt(sum(float(torch.linalg.vector_norm(x - y)) ** 2 for x, y in zip(a, b)))


def dp_rank_worker(variant: str = "ssd300", device_type: str = "cuda") -> dict:
    """One of phase 3c's two ranks, both on cuda:0 over gloo (NCCL refuses two ranks on
    one device): (a) 3 float32 and 3 bf16 data-parallel SSD300 steps at global batch 32,
    the ranks' parameters and Adam moments compared bit for bit after every step; rank 0
    then runs the float32 steps in one process, whole and as two halves of 16; (c) the
    2-rank evaluation of a split with a remainder. Rank 0 returns the figures. (A CPU
    rehearsal passes a small registered variant and the CPU.)"""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ssd_object_detection_tpu_torch.eval.predict import make_predict_fn
    from ssd_object_detection_tpu_torch.eval.runner import _fetch_detections, _rank_images, evaluate_batches
    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
    from ssd_object_detection_tpu_torch.ops.nms import Detections
    from ssd_object_detection_tpu_torch.parallel.collectives import all_reduce_sum_
    from ssd_object_detection_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate
    from ssd_object_detection_tpu_torch.train.step import StepConfig, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    mesh = make_mesh(2, device=dev)
    rank = mesh.rank
    spec = MODEL_SPECS[variant]
    size = spec.image_size
    anchors = generate_anchors(spec.anchor_spec)
    local = dp_batches(np, DP_STEPS * 32, 32, size, shard=mesh.shard())  # 16 rows of each batch
    step = make_train_step(anchors, StepConfig(), mesh=mesh)
    unequal = []

    def ranks_equal(state):
        """Parameters and both Adam moments: rank 0's broadcast, compared on rank 1."""
        tensors = [t for p in state.model.parameters()
                   for t in (p, state.optimizer.state[p]["exp_avg"], state.optimizer.state[p]["exp_avg_sq"])]
        mine = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        theirs = mine.clone()
        dist.broadcast(theirs, src=0)
        same = torch.tensor([float(torch.equal(mine, theirs))], device=dev)
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
        if not bool(same.item()):
            unequal.append(state.step)

    # ---- (a) the data-parallel steps
    launches = []
    results = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        state = dp_fresh_state(torch, dev, dtype, variant)
        replicate(state.model, mesh)
        cuda_matcher.match_anchors_cuda.launches = 0
        results[name] = dp_run_steps(torch, dev, state, step, local,
                                     keep_params=(name == "float32" and rank == 0), after=ranks_equal)
        launches.append(cuda_matcher.match_anchors_cuda.launches)
        if name == "bfloat16":  # the gradient reduce alone: one all-reduce of every gradient
            grads = [torch.zeros_like(p) for p in state.model.parameters()]
            reduce_ms = []
            for _ in range(5):
                dp_sync(torch, dev)
                t = time.perf_counter()
                all_reduce_sum_(grads)
                dp_sync(torch, dev)
                reduce_ms.append((time.perf_counter() - t) * 1e3)
            grad_mb = sum(g.numel() * g.element_size() for g in grads) / 1e6
            del grads
        del state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    counts = torch.tensor(launches, device=dev)
    all_counts = [torch.empty_like(counts) for _ in range(2)]
    dist.all_gather(all_counts, counts)

    # ---- (c) evaluation over 2 ranks: dyadic weights, binary images, a remainder batch
    model = SSD(num_classes=81, spec=spec, dtype=torch.float32)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.clamp(torch.round(p * 256.0), -4, 4) / 256.0)
    predict = make_predict_fn(model, anchors)
    split = dp_batches(np, 53, 53, size, seed=1)[0]
    split["image"] = (split["image"] > 127).astype(np.float32)
    val = [{k: v[:32] for k, v in split.items()}, {k: v[32:] for k, v in split.items()}]  # 32, 21
    dp_metrics = evaluate_batches(predict, val, num_classes=8, mesh=mesh)
    dp_dets = [_fetch_detections(predict(_rank_images(b["image"], mesh, 32)), mesh) for b in val]

    dist.barrier()
    if rank != 0:
        dist.barrier()
        return {}
    # ---- rank 0 alone: the one-process references
    plain = make_train_step(anchors, StepConfig())
    global_batches = dp_batches(np, DP_STEPS * 32, 32, size)
    for got, want in zip(local, global_batches):
        if not all(np.array_equal(got[k], want[k][:16]) for k in want):
            raise RuntimeError("phase 3c: the sharded feed's rows are not rank 0's rows of the global batch")

    init, full, halves, _ = one_process_f32(torch, dev, variant, plain, global_batches)
    f32 = []
    for i, (d, f, h) in enumerate(zip(results["float32"], full, halves)):
        f32.append({
            "step": i + 1, "num_positive": (d["num_positive"], f["num_positive"]),
            "loss": (d["loss"], f["loss"], h["loss"]),
            "param_l2": (l2_distance(torch, d["params"], f["params"]),
                         l2_distance(torch, h["params"], f["params"]),
                         l2_distance(torch, f["params"], init)),
        })

    def rows_predict(images):  # the ranks' calls (padded to 32, 16 rows each), in one process
        padded = torch.cat([_rank_images(images, Mesh(rank=r, size=2, device=dev), 32) for r in range(2)])
        parts = [predict(padded[:16]), predict(padded[16:])]
        return Detections(*(torch.cat(x) for x in zip(*parts)))

    same_rows = [_fetch_detections(rows_predict(b["image"])) for b in val]
    one_batch = [_fetch_detections(predict(b["image"])) for b in val]
    dets_equal = all(np.array_equal(a[:len(b["image"])], c[:len(b["image"])])
                     for x, y, b in zip(dp_dets, same_rows, val) for a, c in zip(x, y))
    score_gap = max(float(np.abs(x[1][:len(b["image"])] - y[1]).max()) for x, y, b in zip(dp_dets, one_batch, val))
    out = {
        "f32": f32, "unequal": unequal, "launches": [c.tolist() for c in all_counts],
        "bf16_ms": [r["ms"] for r in results["bfloat16"]], "f32_ms": [r["ms"] for r in results["float32"]],
        "full_ms": [r["ms"] for r in full],
        "bf16_losses": [r["loss"] for r in results["bfloat16"]],
        "reduce_ms": reduce_ms, "grad_mb": grad_mb,
        "eval": {"dp": dp_metrics, "same_rows": evaluate_batches(rows_predict, val, num_classes=8),
                 "one_batch": evaluate_batches(predict, val, num_classes=8),
                 "dets_equal": dets_equal, "score_gap_one_batch": score_gap,
                 "valid": int(sum(x[3][:len(b["image"])].sum() for x, b in zip(dp_dets, val)))},
    }
    dist.barrier()
    return out


def dp_phase(torch, np, dev, card: str, bare_step_ms: float, variant: str = "ssd300",
             pool_shape=(32, 300, 300, 64)) -> int:
    """Phase 3c: (a) and (c) in two spawned ranks sharing the card over gloo, (b) a
    1-rank NCCL group, (d) debug_nans, (e) max_pool_2x2 at block1's output shape;
    returns the data-parallel matcher launches (both ranks' and the NCCL step's). A CPU
    rehearsal passes a small registered variant and pool shape, and runs (b) over gloo."""
    import torch.distributed as dist

    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS
    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
    from ssd_object_detection_tpu_torch.ops.pooling import max_pool_2x2
    from ssd_object_detection_tpu_torch.parallel import multihost
    from ssd_object_detection_tpu_torch.parallel.mesh import make_mesh
    from ssd_object_detection_tpu_torch.train.step import StepConfig, make_train_step
    from ssd_object_detection_tpu_torch.utils.debug import enable_nan_debugging

    # ---- (a) and (c): two ranks on cuda:0, gloo named (it takes CUDA tensors)
    t = time.time()
    r = multihost.launch(dp_rank_worker, 2, (variant, dev.type), device_type=dev.type, backend="gloo")
    spawn_s = time.time() - t
    launches = sum(sum(c) for c in r["launches"])
    if r["unequal"]:
        fail(f"phase 3c: the two ranks' parameters or Adam moments differ after steps {r['unequal']}")
    if any(c != [DP_STEPS, DP_STEPS] for c in r["launches"]):
        fail(f"phase 3c: matcher launches per rank (float32, bf16) {r['launches']}, want one a step")
    for s in r["f32"]:
        (dp, full), (l_dp, l_full, l_half), (p_dp, p_half, moved) = s["num_positive"], s["loss"], s["param_l2"]
        if dp != full:
            fail(f"phase 3c step {s['step']}: num_positive {dp} under 2 ranks, {full} in one process")
        if abs(l_dp - l_full) > 2 * abs(l_half - l_full) + 1e-6 * abs(l_full) \
                or p_dp > 2 * p_half + 1e-6 * moved:
            fail(f"phase 3c step {s['step']}: 2 ranks differ from one process beyond the yardstick "
                 f"of the same step run as two halves of 16: loss {l_dp} / {l_full} / {l_half}, "
                 f"param L2 {p_dp} against {p_half} (update {moved})")
        print(f"phase 3c float32 step {s['step']} (TF32 off): num_positive {dp:.0f} = one process; "
              f"loss 2 ranks {l_dp:.7f}, one process {l_full:.7f}, one process as two halves "
              f"{l_half:.7f}; param L2 distance to one process: 2 ranks {p_dp:.3e}, halves "
              f"{p_half:.3e} (the step moved them {moved:.3e})")
    print(f"phase 3c bf16 steps: losses {[round(x, 4) for x in r['bf16_losses']]}; parameters and Adam "
          f"moments bit-equal across the 2 ranks after each of the {DP_STEPS} float32 and "
          f"{DP_STEPS} bf16 steps; matcher launches per rank {r['launches']} (one a step)")
    print(f"phase 3c timing on {card} (two processes on one card, gloo; not a scaling figure): "
          f"2-rank bf16 step {statistics.median(r['bf16_ms'][1:]):.2f} ms (steps {[round(x, 2) for x in r['bf16_ms']]}), "
          f"float32 {[round(x, 2) for x in r['f32_ms']]}; one process bf16 {bare_step_ms:.2f} ms "
          f"(phase 3), float32 {[round(x, 2) for x in r['full_ms']]}; the gradient reduce "
          f"({r['grad_mb']:.1f} MB, one all-reduce) {statistics.median(r['reduce_ms']):.2f} ms per step "
          f"(median of {len(r['reduce_ms'])}); spawn to result {spawn_s:.1f} s")
    ev = r["eval"]
    if not ev["dets_equal"] or ev["dp"] != ev["same_rows"]:
        fail(f"phase 3c (c): 2-rank evaluation differs from one process computing the same rows: "
             f"{ev['dp']} / {ev['same_rows']}")
    print(f"phase 3c (c) evaluation, 2 ranks, batches 32 + 21 (padded to 32), dyadic weights, binary "
          f"images: detections ({ev['valid']} valid) and metrics bit-equal to one process computing "
          f"the ranks' rows; against one process at batch 32: metrics "
          f"{'equal' if ev['dp'] == ev['one_batch'] else 'differ: ' + str(ev['one_batch'])}, largest "
          f"score difference {ev['score_gap_one_batch']:.3e}; mAP@0.5 {ev['dp']['mAP@0.5']:.4f}")

    # ---- (b) a 1-rank NCCL group: its step equals the step without a mesh, bit for bit
    spec = MODEL_SPECS[variant]
    anchors = generate_anchors(spec.anchor_spec)
    batch = dp_batches(np, 32, 32, spec.image_size)[0]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{multihost.free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device=dev)
        states = [dp_fresh_state(torch, dev, torch.bfloat16, variant) for _ in range(2)]
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cuda_matcher.match_anchors_cuda.launches = 0
            got = make_train_step(anchors, StepConfig(), mesh=mesh)(states[0], batch, global_batch=32)
            launches += cuda_matcher.match_anchors_cuda.launches
            want = make_train_step(anchors, StepConfig())(states[1], batch)
            dp_sync(torch, dev)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        same = {k: float(got[k]) == float(want[k]) for k in want}
        a, b = ([t for p in s.model.parameters() for t in (p, s.optimizer.state[p]["exp_avg"],
                                                          s.optimizer.state[p]["exp_avg_sq"])]
                for s in states)
        if not all(same.values()) or not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"phase 3c (b): the 1-rank NCCL step differs from the step without a mesh "
                 f"(metrics equal: {same}); nondeterministic-op warnings: "
                 f"{sorted({str(w.message)[:100] for w in caught})}")
        print(f"phase 3c (b) 1-rank NCCL group: bf16 step bit-equal to the step without a mesh "
              f"(loss {float(got['loss']):.6f}, parameters and Adam moments)")
    finally:
        dist.destroy_process_group()
    del states

    # ---- (d) debug_nans: a NaN weight stops the step and is named
    for debug_nans in (True, False):
        state = dp_fresh_state(torch, dev, torch.bfloat16, variant)
        with torch.no_grad():
            state.model.vgg.block3_conv1.weight[0, 0, 0, 0] = float("nan")
        step = make_train_step(anchors, StepConfig())
        enable_nan_debugging(debug_nans, state.model)
        try:
            metrics = step(state, batch)
            dp_sync(torch, dev)
            if debug_nans:
                fail("phase 3c (d): debug_nans let a step with a NaN weight through")
            loss = float(metrics["loss"])
        except FloatingPointError as e:
            if not debug_nans or "vgg.block3_conv1.weight" not in str(e):
                fail(f"phase 3c (d): {e}")
            message = str(e)
        finally:
            enable_nan_debugging(False, state.model)
    print(f"phase 3c (d) debug_nans: the step raised FloatingPointError: {message}; without it the "
          f"step ran to a loss of {loss}")
    del state

    # ---- (e) max_pool_2x2 at block1's output shape: card == CPU, value and gradient
    gen = torch.Generator().manual_seed(0)
    b, h, w, c = pool_shape
    x = torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16)
    g = torch.randn(b, h // 2, w // 2, c, generator=gen).to(torch.bfloat16)
    outs = []
    for where in (dev, torch.device("cpu")):
        xt = x.to(where).requires_grad_(True)
        y = max_pool_2x2(xt)
        y.backward(g.to(where))
        outs.append((y.detach().cpu(), xt.grad.cpu()))
    if not (torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])):
        fail("phase 3c (e): max_pool_2x2 on the card differs from the CPU")
    print(f"phase 3c (e) max_pool_2x2 {b}x{h}x{w}x{c} bf16: value and gradient bit-equal card == CPU")
    return launches


DPTP_STEPS = 2  # per precision


def same_over(torch, dist, dev, tensors, group) -> bool:
    """Whether `tensors` are bit-equal on every rank of `group`: its first rank broadcasts
    them and every rank compares."""
    mine = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    theirs = mine.clone()
    dist.broadcast(theirs, src=dist.get_global_rank(group, 0), group=group)
    same = torch.tensor([float(torch.equal(mine, theirs))], device=dev)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=group)
    return bool(same.item())


def dp_tp_rank_worker(variant: str = "ssd300", device_type: str = "cuda", min_channels: int = 256) -> dict:
    """One of phase 3d's four ranks, all on cuda:0 over gloo, on a (2, 2) data x model grid
    (parallel/shardings.py): the variant at full width from the seed-0 weights with its
    convs of at least `min_channels` output channels column-parallel; 2 float32 steps
    (TF32 off, deterministic algorithms: each model rank computes the replicated layers
    itself, so its replicas stay bit-equal only where those round alike) with the replicas
    compared bit for bit after each, then 2 bf16 steps timed, and one bf16 step's
    model-axis traffic replayed alone. Rank 0 then runs the float32 steps in one process,
    whole and as halves, under the same deterministic algorithms, and returns the figures. (A CPU rehearsal passes a small
    registered variant and the CPU.)"""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
    from ssd_object_detection_tpu_torch.parallel import shardings
    from ssd_object_detection_tpu_torch.parallel.mesh import replicate
    from ssd_object_detection_tpu_torch.train.step import StepConfig, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    mesh = shardings.make_2d_mesh(2, 2, device=dev)
    spec = MODEL_SPECS[variant]
    anchors = generate_anchors(spec.anchor_spec)
    local = dp_batches(np, DPTP_STEPS * 32, 32, spec.image_size, shard=mesh.shard())  # 16 rows each
    step = make_train_step(anchors, StepConfig(), mesh=mesh)

    def sharded_state(dtype):
        state = dp_fresh_state(torch, dev, dtype, variant)
        replicate(state.model, mesh)
        return state, shardings.shard_state_tp(state, mesh, min_channels)

    def replicated_and_all(state):
        shards = set(shardings.sharded_parameters(state.model))
        tensors = [(p in shards, t) for p in state.model.parameters()
                   for t in (p, state.optimizer.state[p]["exp_avg"], state.optimizer.state[p]["exp_avg_sq"])]
        return [t for sharded, t in tensors if not sharded], [t for _, t in tensors]

    unequal, unsharded = [], []

    def check(state):  # after each float32 step
        replicated, every = replicated_and_all(state)
        if not same_over(torch, dist, dev, replicated, mesh.model_group):
            unequal.append(f"model axis, step {state.step}")
        if not same_over(torch, dist, dev, every, mesh.data_group):
            unequal.append(f"data axis, step {state.step}")
        full = shardings.unshard_state_dict(state.model, mesh)  # every rank gathers
        if dist.get_rank() == 0:
            unsharded.append({k: v.to("cpu", torch.float32, copy=True) for k, v in full.items()})

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    state, names = sharded_state(torch.float32)
    cuda_matcher.match_anchors_cuda.launches = 0
    f32 = dp_run_steps(torch, dev, state, step, local, after=check)
    launches = [cuda_matcher.match_anchors_cuda.launches]
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    state, _ = sharded_state(torch.bfloat16)
    cuda_matcher.match_anchors_cuda.launches = 0
    bf16 = dp_run_steps(torch, dev, state, step, local)
    launches.append(cuda_matcher.match_anchors_cuda.launches)
    bf16_replicas_equal = same_over(torch, dist, dev, replicated_and_all(state)[0], mesh.model_group)

    # one bf16 step's model-axis collectives, recorded, then replayed alone
    recorded = []
    real_gather, real_copy = shardings.gather_channels, shardings.copy_to_model

    def gather(x, group):
        recorded.append(("gather", x.shape, x.dtype))
        return real_gather(x, group)

    def copy(x, group):
        recorded.append(("reduce", x.shape, x.dtype))
        return real_copy(x, group)

    shardings.gather_channels, shardings.copy_to_model = gather, copy
    try:
        step(state, local[0], global_batch=32)
    finally:
        shardings.gather_channels, shardings.copy_to_model = real_gather, real_copy
    buffers = [(kind, torch.zeros(shape, dtype=dtype, device=dev)) for kind, shape, dtype in recorded]
    parts = {id(x): [torch.empty_like(x) for _ in range(mesh.tp_size)] for kind, x in buffers if kind == "gather"}
    traffic_ms = []
    for _ in range(4):
        dp_sync(torch, dev)
        dist.barrier()
        t = time.perf_counter()
        for kind, x in buffers:
            if kind == "gather":
                dist.all_gather(parts[id(x)], x, group=mesh.model_group)
            else:
                dist.all_reduce(x, group=mesh.model_group)
        dp_sync(torch, dev)
        traffic_ms.append((time.perf_counter() - t) * 1e3)
    traffic_mb = sum(x.numel() * x.element_size() * (mesh.tp_size if kind == "gather" else 1)
                     for kind, x in buffers) / 1e6
    del state, buffers, parts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    counts = torch.tensor(launches, device=dev)
    all_counts = [torch.empty_like(counts) for _ in range(dist.get_world_size())]
    dist.all_gather(all_counts, counts)

    dist.barrier()
    if dist.get_rank() != 0:
        dist.barrier()
        return {}
    # ---- rank 0 alone: the one-process references
    global_batches = dp_batches(np, DPTP_STEPS * 32, 32, spec.image_size)
    for got, want in zip(local, global_batches):
        if not all(np.array_equal(got[k], want[k][:16]) for k in want):
            raise RuntimeError("phase 3d: data rank 0's rows are not the first rows of the global batch")
    # under the grid's deterministic algorithms, so the yardstick compares like with like
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    init, full, halves, split = one_process_f32(
        torch, dev, variant, make_train_step(anchors, StepConfig()), global_batches, min_channels)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    with torch.device("meta"):
        order = [n for n, _ in SSD(num_classes=81, spec=spec).named_parameters()]
    records = []
    for i, (d, f, h, sp, u) in enumerate(zip(f32, full, halves, split, unsharded)):
        grid = [u[n] for n in order]
        records.append({
            "step": i + 1, "num_positive": (d["num_positive"], f["num_positive"]),
            "loss": (d["loss"], f["loss"], h["loss"], sp["loss"]),
            "param_l2": (l2_distance(torch, grid, f["params"]),
                         l2_distance(torch, h["params"], f["params"]),
                         l2_distance(torch, f["params"], init)),
            "split_l2": (l2_distance(torch, sp["params"], f["params"]), l2_distance(torch, grid, sp["params"])),
        })
    out = {"names": names, "f32": records, "unequal": unequal,
           "launches": [c.tolist() for c in all_counts], "bf16_ms": [r["ms"] for r in bf16],
           "f32_ms": [r["ms"] for r in f32], "full_ms": [r["ms"] for r in full],
           "bf16_losses": [r["loss"] for r in bf16], "bf16_replicas_equal": bf16_replicas_equal,
           "traffic_ms": traffic_ms, "traffic_mb": traffic_mb, "collectives": len(recorded)}
    dist.barrier()
    return out


def dp_tp_phase(torch, np, dev, card: str, bare_step_ms: float, variant: str = "ssd300",
                min_channels: int = 256) -> int:
    """Phase 3d: four ranks spawned by parallel/multihost.py's launch share the card over
    gloo as a (2, 2) data x model grid; returns their matcher launches."""
    from ssd_object_detection_tpu_torch.parallel import multihost

    t = time.time()
    r = multihost.launch(dp_tp_rank_worker, 4, (variant, dev.type, min_channels),
                         device_type=dev.type, backend="gloo")
    spawn_s = time.time() - t
    print(f"phase 3d column-parallel convs at min_channels {min_channels} ({len(r['names'])}): "
          f"{', '.join(r['names'])}")
    if r["unequal"]:
        fail(f"phase 3d: replicas differ after float32 steps: {r['unequal']}")
    if any(c != [DPTP_STEPS, DPTP_STEPS] for c in r["launches"]):
        fail(f"phase 3d: matcher launches per rank (float32, bf16) {r['launches']}, want one a step")
    for s in r["f32"]:
        (dp, full), (l_dp, l_full, l_half, l_split), (p_dp, p_half, moved) = s["num_positive"], s["loss"], s["param_l2"]
        if dp != full:
            fail(f"phase 3d step {s['step']}: num_positive {dp} on the (2, 2) grid, {full} in one process")
        if abs(l_dp - l_full) > 2 * abs(l_half - l_full) + 1e-6 * abs(l_full) \
                or p_dp > 2 * p_half + 1e-6 * moved:
            fail(f"phase 3d step {s['step']}: the (2, 2) grid differs from one process beyond the "
                 f"yardstick of the same step run as two halves of 16: loss {l_dp} / {l_full} / "
                 f"{l_half}, param L2 {p_dp} against {p_half} (update {moved})")
        if s["split_l2"][1] > p_half:
            fail(f"phase 3d step {s['step']}: the grid is {s['split_l2'][1]} from one process running "
                 f"its arithmetic (halves, channel-split convs), farther than the halves are from one "
                 f"process ({p_half})")
        print(f"phase 3d float32 step {s['step']} (TF32 off, deterministic): num_positive {dp:.0f} = "
              f"one process; loss (2, 2) grid {l_dp:.7f}, one process {l_full:.7f}, as two halves "
              f"{l_half:.7f}; unsharded param L2 distance to one process: grid {p_dp:.3e}, halves "
              f"{p_half:.3e} (the step moved them {moved:.3e}); one process as halves with the "
              f"column-parallel convs as two halves of their channels (the grid's arithmetic): loss "
              f"{l_split:.7f}, distance to one process {s['split_l2'][0]:.3e}, the grid's distance "
              f"to it {s['split_l2'][1]:.3e}")
    print(f"phase 3d float32: replicated parameters and Adam moments bit-equal across the model "
          f"ranks, and every parameter and moment across the data ranks, after each of the "
          f"{DPTP_STEPS} steps; matcher launches per rank {r['launches']} (one a step); bf16 "
          f"losses {[round(x, 4) for x in r['bf16_losses']]}, replicas after the bf16 steps "
          f"(cuDNN's default algorithms) {'bit-equal' if r['bf16_replicas_equal'] else 'NOT bit-equal'}")
    print(f"phase 3d timing on {card} (four processes on one card, gloo through the host; a cost "
          f"figure, not a scaling figure): (2, 2) bf16 step {statistics.median(r['bf16_ms'][1:]):.2f} ms "
          f"(steps {[round(x, 2) for x in r['bf16_ms']]}), float32 {[round(x, 2) for x in r['f32_ms']]}; "
          f"one process bf16 {bare_step_ms:.2f} ms (phase 3), float32 {[round(x, 2) for x in r['full_ms']]}; "
          f"one bf16 step's gather_channels + copy_to_model traffic ({r['collectives']} collectives, "
          f"{r['traffic_mb']:.1f} MB) {statistics.median(r['traffic_ms']):.2f} ms (median of "
          f"{len(r['traffic_ms'])} replays); spawn to result {spawn_s:.1f} s")
    return sum(sum(c) for c in r["launches"])


def dryrun_phase(dev) -> None:
    """Phase 3e: cli/dryrun.py's dry run over 4 ranks sharing the card over gloo."""
    from ssd_object_detection_tpu_torch.cli.dryrun import dryrun_multichip

    r = dryrun_multichip(4, device=dev.type, backend="gloo")
    if r["tp_loss"] is None or abs(r["tp_loss"] - r["dp_loss"]) >= 1e-3 or len(r["legs"]) != 5:
        fail(f"phase 3e: dry run result {r}")
    print(f"phase 3e dry run, 4 gloo ranks on one card: legs "
          f"{', '.join(f'{name} {s:.2f} s' for name, s in r['legs'])}; dp loss {r['dp_loss']:.6f}, "
          f"dp x tp loss {r['tp_loss']:.6f}, {r['detections']} detections, wall {r['wall_s']:.1f} s")


def bench_phase(torch, np, dev, card: str) -> None:
    """Phase 7d: cli/bench.py at its defaults (its JSON line printed by it), and
    flops_analysis of the SSD300 bf16 and PTQ forwards at batch 32 against the sum over
    the convs reckoned from their shapes."""
    from ssd_object_detection_tpu_torch.cli import bench
    from ssd_object_detection_tpu_torch.models.ssd import SSD, SSD300_SPEC_MODEL
    from ssd_object_detection_tpu_torch.ops.quant import quantize_synthetic
    from ssd_object_detection_tpu_torch.utils.introspect import flops_analysis

    result = bench.main([])
    print(f"phase 7d bench on {card}: int8 {result['value']} img/s, bf16 "
          f"{result['bf16_images_per_sec']} img/s (batch {bench.BATCH}, {bench.PIPELINE} batches a "
          f"round, {bench.BENCH_ITERS} timed rounds; the 2,000 img/s baseline is an A100 estimate)")
    model = SSD(num_classes=81, spec=SSD300_SPEC_MODEL, dtype=torch.bfloat16, conf_f32=False)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev).eval()
    qmodel, n = quantize_synthetic(model, (32, 300, 300, 3), include_heads=True)
    x = torch.rand((32, 300, 300, 3), generator=torch.Generator().manual_seed(0)).to(dev) * 2 - 1
    want = reckoned_conv_flops(SSD300_SPEC_MODEL, 32, 81)
    with torch.no_grad():
        got = {"bf16": flops_analysis(model, x)["flops"], "ptq": flops_analysis(qmodel, x)["flops"]}
    if any(v != want for v in got.values()):
        fail(f"phase 7d: flops_analysis {got} against {want} reckoned from the conv shapes")
    print(f"phase 7d flops_analysis SSD300 forward, batch 32: bf16 {got['bf16'] / 1e12:.4f} TFLOP, "
          f"PTQ ({n} int8 convs) {got['ptq'] / 1e12:.4f} TFLOP, both = the sum over the convs "
          f"reckoned from their shapes ({want})")


# torch.profiler kernel-name fragments for the R34 and MNV2 train steps, first match wins
FAMILY_GROUPS = (
    ("host-to-device copy", ("memcpy htod",)),
    ("matcher", ("match_kernel",)),
    ("group norm", ("group_norm", "groupnorm", "rowwisemoments", "computefusedparams",
                    "compute_internal_gradients", "gamma_beta", "welford")),
    ("depthwise conv", ("depthwise", "dwconv", "dgrad2d_grouped", "grouped")),
    ("max-pool", ("max_pool",)),
    ("optimizer", ("multi_tensor", "adam")),
    ("sort (loss mining)", ("sort", "radix")),
    ("layout / dtype copy", ("nchwtonhwc", "nhwctonchw", "copy_kernel", "direct_copy")),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "gemm", "dgrad", "wgrad", "nhwc", "sm90")),
)


def relative_l2(torch, got, want) -> float:
    """||got - want|| / ||want|| over lists of tensors, in float32."""
    num = sum(float(torch.linalg.vector_norm((a.float() - b.float()))) ** 2 for a, b in zip(got, want))
    den = sum(float(torch.linalg.vector_norm(b.float())) ** 2 for b in want)
    return math.sqrt(num / max(den, 1e-30))


def family_train_phase(torch, np, dev, card: str) -> int:
    """3b. SSD300-R34 and SSD300-MNV2 train steps at full width (81 classes, bf16, batch
    32, max_gt 100, uint8 synthetic images, reference loss): a float32 forward on the card
    against the CPU's; warmup + timed steps with the matcher once per step, finite losses,
    changed params; remat against no remat from the same params; peak memory of each;
    one profiled step; GroupNorm on a channels-last input. Returns matcher launches."""
    from torch import nn

    from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
    from ssd_object_detection_tpu_torch.models.resnet import group_norm
    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
    from ssd_object_detection_tpu_torch.train.optim import exponential_decay, make_optimizer
    from ssd_object_detection_tpu_torch.train.step import (
        StepConfig, TrainState, create_train_state, make_train_step,
    )

    batch_size, warmup_steps, timed_steps = 32, 2, 5
    ds = SyntheticDetectionDataset(num_images=2 * batch_size, image_size=300, max_gt=100,
                                   num_classes=8, seed=0)
    batches = []
    for b in ds.batches(batch_size):
        b["image"] = np.round(b["image"] * 255.0).astype(np.uint8)
        batches.append(b)
    train_step = make_train_step(generate_anchors(), StepConfig())
    total_launches = 0
    for variant in ("ssd300_r34", "ssd300_mnv2"):
        spec = MODEL_SPECS[variant]
        # float32 forward: the card (TF32 off) against the CPU, same port model
        model32 = SSD(num_classes=81, spec=spec).init_weights(torch.Generator().manual_seed(0))
        x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 300, 300, 3)).astype(np.float32))
        with torch.no_grad():
            want = model32(x)
            got = model32.to(dev)(x.to(dev))
        err = max(float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
        if not err <= 1e-4:
            fail(f"{variant} float32 forward: card and CPU differ by {err:.3e} of the output scale")
        del model32, got, want

        model = SSD(num_classes=81, spec=spec, dtype=torch.bfloat16)
        model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, make_optimizer("adam", model.parameters()),
                                   exponential_decay(1e-3, 100, 0.99))
        trunk_first = next(n for n, _ in model.named_parameters())
        watched = {n: p.detach().clone() for n, p in model.named_parameters()
                   if n in (trunk_first, "extra1_conv0.weight", "conf_head0.weight")}
        cuda_matcher.match_anchors_cuda.launches = 0
        step_ms, losses = [], []
        for i in range(warmup_steps + timed_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = train_step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            if i >= warmup_steps:
                step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(metrics["loss"]))
        launches = cuda_matcher.match_anchors_cuda.launches
        steps = warmup_steps + timed_steps
        if launches != steps:
            fail(f"{variant}: {steps} train steps launched the matcher kernel {launches} times")
        total_launches += launches
        if not all(math.isfinite(v) for v in losses):
            fail(f"{variant}: non-finite loss in the train steps: {losses}")
        for n, before in watched.items():
            if torch.equal(before, dict(model.named_parameters())[n].detach()):
                fail(f"{variant}: param {n} did not change over {steps} train steps")
        med = statistics.median(step_ms)

        # remat: one step from the same params (lr 0, so nothing moves), against the
        # step's own run-to-run spread (cuDNN's backward sums with atomics)
        probe = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.0),
                           schedule=lambda step: 0.0)

        def one_step(remat: bool):
            model.remat = remat
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m = train_step(probe, batches[0])
            torch.cuda.synchronize()
            return (float(m["loss"]), [p.grad.detach().clone() for p in model.parameters()],
                    torch.cuda.max_memory_allocated())

        loss_a, grads_a, peak_plain = one_step(False)
        loss_b, grads_b, _ = one_step(False)
        loss_r, grads_r, peak_remat = one_step(True)
        t = time.perf_counter()
        one_step(True)
        remat_ms = (time.perf_counter() - t) * 1e3
        model.remat = False
        spread, remat_diff = relative_l2(torch, grads_b, grads_a), relative_l2(torch, grads_r, grads_a)
        if abs(loss_r - loss_a) > abs(loss_b - loss_a) + 1e-6 * abs(loss_a) \
                or remat_diff > 2 * spread + 1e-3:
            fail(f"{variant} remat: loss {loss_r} vs {loss_a} (spread {abs(loss_b - loss_a)}), "
                 f"gradients {remat_diff:.3e} relative L2 (spread {spread:.3e})")
        del grads_a, grads_b, grads_r
        print(f"train step {variant} bf16 batch {batch_size} max_gt 100 [{card}]: losses "
              f"{[round(v, 4) for v in losses]}; median {med:.2f} ms over {timed_steps} steps = "
              f"{batch_size / med * 1e3:.1f} img/s; matcher launches {launches}; float32 forward "
              f"card vs CPU {err:.2e} of the output scale")
        print(f"remat {variant}: loss {loss_r:.6f} (no remat {loss_a:.6f}, again {loss_b:.6f}), "
              f"gradients {remat_diff:.3e} relative L2 from no remat (no remat twice: "
              f"{spread:.3e}); peak memory of one step {peak_plain / 2**30:.3f} GiB without, "
              f"{peak_remat / 2**30:.3f} GiB with remat; one remat step {remat_ms:.2f} ms")
        profile_step(torch, lambda: train_step(state, batches[0]), f"one {variant} train step",
                     FAMILY_GROUPS)
        del model, state, probe
        torch.cuda.empty_cache()

    # GroupNorm on a channels-last bf16 input (the trunks' layout): what it launches
    norm = nn.GroupNorm(32, 64, eps=1e-6).to(dev)
    x = torch.randn(32, 64, 150, 150, device=dev).to(torch.bfloat16, memory_format=torch.channels_last)
    y = group_norm(x, norm, torch.bfloat16)
    kernels = device_kernels(torch, lambda: group_norm(x, norm, torch.bfloat16))
    print(f"group_norm on a channels-last bf16 (32, 64, 150, 150) input [{card}]: output "
          f"channels-last {y.is_contiguous(memory_format=torch.channels_last)}; kernels "
          + "; ".join(f"{name[:70]} {ms:.3f} ms" for ms, _, name in sorted(kernels, reverse=True)))
    return total_launches


def int8_inputs(torch, np, dev):
    """SSD300-VGG16 (81 classes, bf16, seed 0) quantized on one synthetic batch, and the
    arguments of each int8 conv call of one forward at batch 32: [(name, args)]."""
    from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
    from ssd_object_detection_tpu_torch.models.ssd import SSD, SSD300_SPEC_MODEL
    from ssd_object_detection_tpu_torch.ops import quant

    model = SSD(num_classes=81, spec=SSD300_SPEC_MODEL, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    ds = SyntheticDetectionDataset(num_images=32, image_size=300, max_gt=8, num_classes=8, seed=3)
    images = next(ds.batches(32))["image"]
    x = torch.from_numpy((images - 0.5) * 2.0).float().to(dev)
    q_model, qspec = quant.quantize_ssd(model, [x])
    calls, real = [], quant.int8_conv

    def record(*args):
        calls.append(args)
        return real(*args)

    quant.int8_conv = record
    try:
        with torch.no_grad():
            q_model(x)
    finally:
        quant.int8_conv = real
    torch.cuda.synchronize()
    return list(zip(qspec, calls)), model, q_model, x


def int8_bound(x, w_q, out) -> tuple:
    """Least time for one int8 conv (quantize and conv together): x (compute dtype) read
    once, the int8 weights and the scales and bias read once, the output written once,
    over the memory rate; the 2*B*Ho*Wo*KH*KW*IC*OC int8 operations over the dense int8
    rate."""
    batch, ho, wo, oc = out.shape
    _, kh, kw, ic = w_q.shape
    ops = 2 * batch * ho * wo * kh * kw * ic * oc
    nbytes = (x.numel() * x.element_size() + w_q.numel() + 8 * oc
              + out.numel() * out.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), ops


def int8_conv_bound(xq, w_q, out) -> tuple:
    """Least time for the conv kernel alone: the int8 xq read once, the int8 weights and
    the scales and bias read once, the output written once, over the memory rate; its
    operations over the dense int8 rate."""
    batch, ho, wo, oc = out.shape
    _, kh, kw, ic = w_q.shape
    ops = 2 * batch * ho * wo * kh * kw * ic * oc
    nbytes = xq.numel() + w_q.numel() + 8 * oc + out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def quantize_bound(x, xq) -> float:
    """Least time for the quantize kernel: x read once, xq written once (bytes)."""
    return (x.numel() * x.element_size() + xq.numel()) / HBM_BYTES_PER_S * 1e3


def int8_phase(torch, np, dev, card: str) -> dict:
    """5b. The int8 kernels against their plain version on the card at SSD300-VGG16's 17
    eligible conv calls at batch 32 (their real inputs), at the shapes kept from the
    first kernel's seams and at the seams of the wgmma kernel's tiles: quantize and int32
    accumulators bit-equal, dequantized output bit-equal at bf16 and float32; per SSD300
    conv the tile plan, the quantize kernel and the conv kernel alone against their own
    bounds, the pair per call and back to back against `int8_bound`, TOP/s, the plain
    version, im2col + torch._int_mm (cuBLASLt int8) + dequantize, the float path's bf16
    cuDNN conv and the wrapper's host us."""
    import torch.nn.functional as F

    from ssd_object_detection_tpu_torch.models.vgg import float_conv, same_padding
    from ssd_object_detection_tpu_torch.ops import cuda_int8
    from ssd_object_detection_tpu_torch.ops.int8_conv_model import SEAMS, named_cases

    calls, model, q_model, _ = int8_inputs(torch, np, dev)
    if len(calls) != 17:
        fail(f"SSD300-VGG16 ran {len(calls)} int8 convs, expected 17")

    def check(name, x, w_q, w_scale, bias, x_scale, stride, pads) -> float:
        ic = x.shape[-1]
        xq = cuda_int8.quantize_cuda(x, x_scale)
        want_xq = cuda_int8.quantize_plain(x, x_scale)
        if not (torch.equal(xq[..., :ic], want_xq) and not bool(xq[..., ic:].any())):
            fail(f"int8 {name}: quantize kernel != plain in {int((xq[..., :ic] != want_xq).sum())} values")
        acc = cuda_int8.conv_cuda(xq, w_q, stride, pads)
        want_acc = cuda_int8.accumulate_plain(want_xq, w_q, stride, pads)
        if not torch.equal(acc, want_acc):
            fail(f"int8 {name}: int32 accumulators differ in {int((acc != want_acc).sum())} of {acc.numel()}")
        err = 0.0
        for dtype in (torch.bfloat16, torch.float32):
            got = (cuda_int8.int8_conv_cuda(x.to(dtype), w_q, w_scale, bias, x_scale, stride, pads)
                   if dtype == x.dtype else
                   cuda_int8.conv_cuda(xq, w_q, stride, pads, dtype, w_scale, x_scale, bias))
            want = cuda_int8.dequantize_plain(want_acc, x_scale, w_scale, bias, dtype)
            err = max(err, float((got.float() - want.float()).abs().max()))
            if not torch.equal(got, want):
                fail(f"int8 {name} {dtype}: dequantized output differs from plain by {err:.3e}")
        plan = cuda_int8.plan_int8(*x.shape, w_q.shape[0], tuple(w_q.shape[1:3]), tuple(stride),
                                   tuple(pads), 2)
        print(f"int8 {name} x {tuple(x.shape)} {x.dtype} w {tuple(w_q.shape)} stride {stride} pads "
              f"{pads} ({_plan_text(plan)}): quantize, int32 accumulators, bf16 and float32 "
              f"outputs bit-equal to plain")
        return err

    cuda_int8.int8_conv_cuda.launches = 0
    max_abs_err = 0.0
    for path, args in calls:
        max_abs_err = max(max_abs_err, check(path, *args))
    g = torch.Generator().manual_seed(5)
    for name, (b, h, w, ic, oc, k, s, padding) in named_cases(INT8_EDGES, SEAMS).items():
        x = (torch.randn(b, h, w, ic, generator=g) * 3).to(torch.bfloat16).to(dev)
        w_q = torch.randint(-127, 128, (oc, k, k, ic), generator=g, dtype=torch.int8).to(dev)
        w_scale = (torch.rand(oc, generator=g) * 0.01 + 1e-4).to(dev)
        bias = torch.randn(oc, generator=g).to(dev) if oc % 2 else None
        pads = (0, 0, 0, 0) if padding == "VALID" else (*same_padding(h, k, s), *same_padding(w, k, s))
        max_abs_err = max(max_abs_err, check(name, x, w_q, w_scale, bias,
                                             torch.tensor(3.0 / 127, device=dev), (s, s), pads))
    checked = cuda_int8.int8_conv_cuda.launches

    rows = []
    for path, (x, w_q, w_scale, bias, x_scale, stride, pads) in calls:
        def kernel():
            return cuda_int8.int8_conv_cuda(x, w_q, w_scale, bias, x_scale, stride, pads)

        out = kernel()
        xq = cuda_int8.quantize_cuda(x, x_scale)
        per_call = cuda_ms(torch, kernel, warmup=3, iters=10)
        back_to_back = stream_ms(torch, kernel, iters=10)
        quantize_ms = stream_ms(torch, lambda: cuda_int8.quantize_cuda(x, x_scale), iters=10)
        conv_ms = stream_ms(torch, lambda: cuda_int8.conv_cuda(xq, w_q, stride, pads, x.dtype,
                                                                w_scale, x_scale, bias), iters=10)
        host_us = enqueue_us(torch, kernel, iters=20)
        plain_ms = cuda_ms(torch, lambda: cuda_int8.int8_conv_plain(x, w_q, w_scale, bias, x_scale,
                                                                     stride, pads), warmup=1, iters=3)
        quantize_plain_ms = cuda_ms(torch, lambda: cuda_int8.quantize_plain(x, x_scale), warmup=1,
                                    iters=3)
        batch, ho, wo, oc = out.shape
        _, kh, kw, ic = w_q.shape
        w_cols = w_q.reshape(oc, -1).t()  # (K, OC), column-major: cuBLASLt's int8 layout
        top, bottom, left, right = pads

        def library():  # quantize, im2col, cuBLASLt int8 GEMM, dequantize
            xq = cuda_int8.quantize_plain(x, x_scale)
            cols = F.pad(xq, (0, 0, left, right, top, bottom)).unfold(1, kh, stride[0]).unfold(2, kw, stride[1])
            acc = torch._int_mm(cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * ic), w_cols)
            return cuda_int8.dequantize_plain(acc.view(batch, ho, wo, oc), x_scale, w_scale, bias,
                                              x.dtype)

        if not torch.equal(library(), out):
            fail(f"int8 {path}: im2col + torch._int_mm disagrees with the kernel")
        library_ms = cuda_ms(torch, library, warmup=2, iters=10)
        conv = model.get_submodule(path.replace("/", "."))
        x_nchw = x.permute(0, 3, 1, 2)
        cudnn_ms = cuda_ms(torch, lambda: float_conv(x_nchw, conv, pads, torch.bfloat16),
                           warmup=2, iters=10)
        bound_ms, bound_by, ops = int8_bound(x, w_q, out)
        conv_bound_ms, conv_bound_by = int8_conv_bound(xq, w_q, out)
        quantize_bound_ms = quantize_bound(x, xq)
        plan = cuda_int8.plan_int8(*x.shape, oc, (kh, kw), tuple(stride), tuple(pads),
                                   out.element_size())
        rows.append({"shape": path, "ms": per_call, "back_to_back_ms": back_to_back,
                     "quantize_ms": quantize_ms, "quantize_bound_ms": quantize_bound_ms,
                     "quantize_plain_ms": quantize_plain_ms,
                     "conv_ms": conv_ms, "conv_bound_ms": conv_bound_ms,
                     "conv_bound_by": conv_bound_by, "ops": ops,
                     "plain_ms": plain_ms, "library_ms": library_ms, "cudnn_bf16_ms": cudnn_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "host_us": host_us})
        print(f"int8 timing {path} {tuple(x.shape)}->{tuple(out.shape)} k{kh} s{stride[0]} "
              f"({_plan_text(plan)}) [{card}]: conv kernel {conv_ms:.4f} ms back to back = "
              f"{ops / conv_ms / 1e9:.1f} TOP/s, {100 * conv_bound_ms / conv_ms:.1f} % of its "
              f"{conv_bound_ms:.4f} ms bound ({conv_bound_by}); quantize kernel {quantize_ms:.4f} ms, "
              f"{100 * quantize_bound_ms / quantize_ms:.1f} % of its {quantize_bound_ms:.4f} ms "
              f"bound (bytes), its plain version {quantize_plain_ms:.4f} ms; pair {per_call:.4f} ms per call, {back_to_back:.4f} back to back = "
              f"{ops / back_to_back / 1e9:.1f} TOP/s, {100 * bound_ms / back_to_back:.1f} % of the "
              f"{bound_ms:.4f} ms pair bound ({bound_by}); plain {plain_ms:.3f} ms; im2col + "
              f"_int_mm {library_ms:.4f} ms; bf16 cuDNN conv {cudnn_ms:.4f} ms; host per call "
              f"{host_us:.1f} us")
        del out, xq
    keys = ("ms", "back_to_back_ms", "quantize_ms", "quantize_bound_ms", "quantize_plain_ms",
            "conv_ms", "conv_bound_ms", "plain_ms", "library_ms", "cudnn_bf16_ms", "bound_ms")
    totals = {key: sum(r[key] for r in rows) for key in keys}
    large = [r for r in rows if r["shape"] in INT8_LARGE]
    large_ms = sum(r["conv_ms"] for r in large)
    large_bound = sum(r["conv_bound_ms"] for r in large)
    print(f"int8 convs of one SSD300-VGG16 forward at batch 32, summed [{card}]: pair "
          f"{totals['ms']:.3f} ms per call ({totals['back_to_back_ms']:.3f} back to back) "
          f"against its {totals['bound_ms']:.3f} ms bound; conv kernel {totals['conv_ms']:.3f} ms "
          f"against {totals['conv_bound_ms']:.3f}; quantize kernel {totals['quantize_ms']:.3f} ms "
          f"against {totals['quantize_bound_ms']:.3f} (plain {totals['quantize_plain_ms']:.3f}); the six 3x3 stride-1 convs of >= 38x38: "
          f"conv kernel {large_ms:.3f} ms, {100 * large_bound / large_ms:.1f} % of their "
          f"{large_bound:.3f} ms bound; plain {totals['plain_ms']:.1f} ms, im2col + _int_mm "
          f"{totals['library_ms']:.3f} ms, bf16 cuDNN {totals['cudnn_bf16_ms']:.3f} ms; "
          f"{checked} checked launches")
    del calls, model, q_model
    torch.cuda.empty_cache()
    return {"launches": 0, "max_abs_err": max_abs_err, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
            # the side that holds the larger part of the summed bound
            "bound_by": max(("operations", "bytes"), key=lambda side: sum(
                r["bound_ms"] for r in rows if r["bound_by"] == side)),
            "library_ms": totals["library_ms"], "back_to_back_ms": totals["back_to_back_ms"],
            "conv_ms": totals["conv_ms"], "conv_bound_ms": totals["conv_bound_ms"],
            "quantize_ms": totals["quantize_ms"], "quantize_bound_ms": totals["quantize_bound_ms"],
            "quantize_plain_ms": totals["quantize_plain_ms"], "shapes": rows}


def _plan_text(plan) -> str:
    mode = "halo" if plan.taps_per_stage == plan.taps and plan.stride == (1, 1) else "tap"
    return (f"{mode} mode, {plan.row}-byte rows, pitch {plan.pitch} x {plan.rows} rows, "
            f"{plan.stages} stages, {plan.num_tiles} tiles")


def ptq_detect_phase(torch, np, dev, anchors300, card: str) -> int:
    """7c. The PTQ detect path at full width (SSD300-VGG16 quantized as in 5b, batch 32,
    fused on the 640x640 canvas): one int8 launch per quantized conv, detections bit-equal
    to the same model with the plain int8 conv on the card, median latency in turns with
    the float model, and one PTQ bundle tier exported, reloaded and equal to the live
    quantized service. Returns the int8 launches of one call."""
    from ssd_object_detection_tpu_torch.eval import serve
    from ssd_object_detection_tpu_torch.eval.predict import make_fused_predict_fn
    from ssd_object_detection_tpu_torch.ops import cuda_int8, quant
    from ssd_object_detection_tpu_torch.ops.preprocess import pack_canvas

    _, model, q_model, _ = int8_inputs(torch, np, dev)
    n_quantized = quant.quantized_convs(q_model)
    batch = 32
    canvas_np, sizes_np = pack_canvas(mixed_images(np, batch), (640, 640))
    canvas, sizes = torch.from_numpy(canvas_np).to(dev), torch.from_numpy(sizes_np).to(dev)
    fused_q = make_fused_predict_fn(q_model, anchors300)
    fused_f = make_fused_predict_fn(model, anchors300)
    fused_q(canvas, sizes)
    torch.cuda.synchronize()

    cuda_int8.int8_conv_cuda.launches = 0
    det = fused_q(canvas, sizes)
    torch.cuda.synchronize()
    launches = cuda_int8.int8_conv_cuda.launches
    if launches != n_quantized:
        fail(f"PTQ detect: {n_quantized} quantized convs launched the int8 kernels {launches} times")
    real = quant.int8_conv
    quant.int8_conv = cuda_int8.int8_conv_plain  # the plain version, on the card
    try:
        det_plain = fused_q(canvas, sizes)
    finally:
        quant.int8_conv = real
    for field, a, b in zip(det._fields, det, det_plain):
        if not torch.equal(a, b):
            fail(f"PTQ detect: {field} differs from the plain int8 path in {int((a != b).sum())} entries")
    turns = [cuda_ms(torch, lambda f=f: f(canvas, sizes), warmup=3, iters=20)
             for f in (fused_f, fused_q, fused_q, fused_f)]
    print(f"PTQ detect SSD300-VGG16 batch {batch}, fused 640x640 canvas [{card}]: {launches} int8 "
          f"launches for {n_quantized} quantized convs; detections bit-equal to the plain int8 "
          f"conv on the card ({int(det.valid.sum())} valid); median ms in turns float, int8, int8, "
          f"float: {', '.join(f'{ms:.3f}' for ms in turns)} = int8 "
          f"{2 * batch / (turns[1] + turns[2]) * 1e3:.1f} img/s, float "
          f"{2 * batch / (turns[0] + turns[3]) * 1e3:.1f} img/s")
    profile_step(torch, lambda: fused_q(canvas, sizes), "one PTQ fused predict call (batch 32)",
                 INT8_GROUPS + PREDICT_GROUPS)

    tier = 8
    kw = dict(image_size=300, canvas_hw=(640, 640), score_thresh=0.01)
    t = time.time()
    bundle = serve.export_fused_detector_bundle(q_model, anchors300, (tier,), **kw)
    export_s = time.time() - t
    art = serve.DetectorService.from_artifact(bundle, device=dev)
    live = serve.DetectorService(q_model, anchors300, batch_size=tier, **kw)
    requests = mixed_images(np, tier, seed=11)
    got, want = art.detect_images(requests), live.detect_images(requests)
    if json.dumps(got) != json.dumps(want) or serve.artifact_precision(bundle) != "int8-ptq":
        fail("PTQ bundle: the artifact's detections differ from the live quantized service's")
    float_mb = sum(p.numel() * 4 for p in model.parameters()) / 1e6
    print(f"PTQ bundle tier {tier} [{card}]: {len(bundle) / 1e6:.1f} MB (float parameters "
          f"{float_mb:.1f} MB), exported in {export_s:.1f} s, precision "
          f"{serve.artifact_precision(bundle)}; {sum(len(d) for d in got)} detections on {tier} "
          f"images equal to the live quantized service's")
    del art, live, bundle, model, q_model
    torch.cuda.empty_cache()
    return launches



def eval_gate_phase() -> None:
    """8. The synthetic mAP gates at the JAX tool's budget, each in its own process, the
    three at once on the card: SSD300-VGG16 with --ptq (float mAP@0.5 > 0.9, both int8
    drops <= 0.02), SSD300-R34 and SSD300-MNV2 (> 0.9)."""
    runs = {"ssd300 --ptq": ["--ptq"], "ssd300_r34": ["--variant", "ssd300_r34"],
            "ssd300_mnv2": ["--variant", "ssd300_mnv2"]}
    t = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gates_") as logs:
        procs = {}
        try:
            for name, flags in runs.items():
                out = open(os.path.join(logs, f"{len(procs)}.out"), "w+")
                err = open(os.path.join(logs, f"{len(procs)}.err"), "w+")
                procs[name] = (subprocess.Popen(
                    [sys.executable, "-m", f"{PACKAGE}.cli.eval_synthetic", *flags], cwd=ROOT,
                    env=dict(os.environ, PYTHONPATH=ROOT), stdout=out, stderr=err, text=True), out, err)
            for name, (proc, out, err) in procs.items():
                proc.wait(timeout=900)
        finally:
            for proc, out, err in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name, (proc, out, err) in procs.items():
            out.seek(0)
            err.seek(0)
            lines = out.read().strip().splitlines()
            stderr = err.read()
            out.close()
            err.close()
            for line in lines[:-1]:
                print(f"  eval_synthetic {name}: {line}")
            if proc.returncode != 0 or not lines:
                fail(f"eval_synthetic {name} exited {proc.returncode}:\n{stderr[-4000:]}")
            result = json.loads(lines[-1])
            print(f"eval gate {name} (cli.eval_synthetic defaults: {result['train']}): mAP "
                  f"{result['mAP']:.4f}, mAP@0.5 {result['mAP@0.5']:.4f}, train "
                  f"{result['train_seconds']:.1f} s on {result['device']}")
            if not result["mAP@0.5"] > 0.9:
                fail(f"eval gate {name}: mAP@0.5 {result['mAP@0.5']:.4f} is not above 0.9")
            for key in ("ptq", "ptq_heads"):
                if key in result:
                    gate = result[key]
                    print(f"eval gate {name} {key}: mAP@0.5 {gate['metrics']['mAP@0.5']:.4f}, drop "
                          f"{gate['mAP50_drop_vs_float']:.4f} against float ({gate['gate']})")
                    if not gate["pass"]:
                        fail(f"eval gate {name} {key}: drop {gate['mAP50_drop_vs_float']:.4f} > 0.02")
            if "--ptq" in runs[name] and not {"ptq", "ptq_heads"} <= set(result):
                fail(f"eval gate {name}: no PTQ results")
    print(f"eval gates, three processes at once on the card: {time.time() - t:.1f} s")


if __name__ == "__main__":
    main()
