#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check every kernel on them.

Run from the root of a checkout: `python3 chip_smoke.py` (one card, no arguments).

  1. prints the card's name and power limit (nvidia-smi), builds the nine CUDA sources
     of ssd_object_detection_tpu_torch/csrc/ (matcher, conv3x3, int8_conv, jpeg_decode,
     jpeg_progressive, jpeg_smooth, resize, png_unfilter, raw_image; nvcc, sm_90a, one
     process per source, all started together)
     and prints the build times;
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
     one process, nor farther than 5 % of that),
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
  4d. tools/feed_ceiling.py's cells on 4b's packed fixture (20 batches of 32) through 4b's
     Trainer config: the host floor (one epoch of batch assembly with the host flip), the
     device floor (the step on a resident batch) and the link floor (a batch pinned and
     copied), each positive and finite, and end-to-end steps at device_prefetch depths 1,
     2 and 4, each cell from a fresh epoch (3 fill + 10 timed steps), with the binding
     resource; the matcher once a step;
  4e. a COCO-format root of 64 of the committed fixtures under .jpg names (the ten
     COCO-sized JPEGs: 4:2:0, 4:2:2, 4:4:4, gray, restart markers, q75 optimised tables,
     Exif 6, progressive, 4:1:1, CMYK; and ROOT_EXTRAS: an RLE8 BMP, a PPM, a Sun raster,
     a JPEG cut and ended by EOI, a progressive JPEG libjpeg smooths, a GIF, an HDR, a
     16-bit PAM, cv2's 640x480 LZW TIFF, a planar TIFF, a big-endian BigTIFF, a CMYK
     Deflate TIFF and a 4:2:0 JPEG-in-TIFF of 16-row strips), in turn, then an LZMA TIFF,
     under distinct ids with boxes written here: `cli.train` packs it on the card
     (data/packed.py::pack_dataset through the decode feed, no cv2) and trains SSD300-VGG16
     from the cache at batch 32, bf16, 2 steps with the matcher once a step; every packed
     image equals cv2's recorded 300x300 digest; one decode an image (K1, a K6 launch a
     refinement round, K7 where libjpeg smooths, then the fused K2 + K3; K9 then K8 for a
     GIF; K9 where it has LZW chunks (old-style codes among them), K11 where it has CCITT
     or ThunderScan chunks, K1 and the fused K2 + K3 where it has JPEG chunks, K10 and K8
     for a TIFF; K8 for the other formats) and one resize; an LZMA TIFF in the root skipped
     (cv2.imread returns None for it); then that root with an uncompressed TIFF of
     4-sample tiles in place of an image: the feed refuses it naming the file;
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
     their own bounds (each the median of 5 rounds of 10 back-to-back calls, with the
     slowest round beside it; the summed times sum the medians), the pair per call and
     back to back against its bound, TOP/s, the
     plain version, im2col + torch._int_mm (cuBLASLt int8) + dequantize, the float
     path's bf16 cuDNN conv and the wrapper's host us;
  5c. the image kernels (csrc/jpeg_decode.cu K1 and the fused K2 + K3,
     csrc/jpeg_progressive.cu K6, csrc/jpeg_smooth.cu K7, csrc/resize.cu K4,
     csrc/png_unfilter.cu K5, csrc/raw_image.cu K8, csrc/gif_lzw.cu K9,
     csrc/tiff_assemble.cu K10, csrc/ccitt_decode.cu K11; no Pallas counterpart, cv2 on
     the host in the JAX package):
     every committed fixture (data/fixtures: COCO-sized JPEGs, progressive at each
     sampling, with restarts and optimised tables, CMYK, YCCK, sampling factors up to 4,
     seams at widths and heights 1-33, restart intervals of 1 MCU and past the image,
     Exif orientations 1-8, corrupt JPEGs libjpeg decodes with warnings, progressive ones
     it smooths, PNGs of each colour type, depth and Adam7, GIFs and HDRs at the edges
     of cv2's readers, TIFFs and BigTIFFs, JPEG-in-TIFFs, BMP, PxM, PAM, Sun raster and
     PFM variants, all in one decode_images call: the JPEG-in-TIFFs' chunks in the JPEGs'
     launches, one of the fused K2 + K3)
     decoded on the card equal to
     cv2's recorded digests, as are its
     300x300 linear resize and, past the serving canvas, its INTER_AREA fit; K1 and K6
     step by step, K7 and the fused K2 + K3 bit-equal to their plain versions on one batch
     of every JPEG fixture, K4 (uint8 and float32 linear, area; every fixture's 300x300
     resize also through resize_batch, a launch a 128 images), K5 (every PNG fixture
     alone and all in one call), K9 (every GIF fixture and every TIFF fixture's LZW chunks,
     old-style ones among them, in one launch, status and output), K11 (every TIFF
     fixture's CCITT and ThunderScan chunks in one launch), K10 (every TIFF chunk with a predictor or a swap,
     in place, in one launch) and K8 (every GIF, TIFF and raw fixture in one launch, YCbCr
     and CIELab TIFFs and JPEG-in-TIFFs of 2 and 4 samples and of separate planes among
     them) bit-equal to theirs; the fixtures the port still refuses (AVIF by either
     brand, uncompressed 4-sample tiles, YCbCr of 4 x 4 units that are no whole number of scanlines,
     PAMs with alpha, a 1-channel PFM) refused, those cv2
     returns None for and a JPEG cut with no marker after the cut ValueErrors; then each
     kernel at the main path's
     shapes (32 copies of the 640x480 4:2:0 JPEG for K1 and K2 + K3, K1 on one copy and
     K2 + K3 on one copy, the CMYK, 4:4:4 and Exif-6 JPEGs, beside its operations and
     bytes bounds, K6 on the
     refinement scans of 32 copies of the 640x480 progressive JPEG from K1's output, K7
     on 32 copies of that JPEG cut in its fifth scan (its DC copy and its tile pass
     apart, from a CUDA graph; one of it, 32 cut in the ninth scan, one launch; 32 cut
     after the DC scan), K11 on the 1728x2200 Group 4 fax page and 32 of them in one
     launch, the 300x300 resize (also from a
     CUDA graph, its host time, 32 in one launch; float32 and INTER_AREA beside
     F.interpolate's bilinear and area), a 640x480 PNG
     and 32 of them in one call, a 640x480 BMP for K8 (and 32 in one launch, one and 32
     of cv2's 640x480 LZW TIFF after K9 and K10, each also from a CUDA graph, with the
     wrapper's host time), a 640x480 GIF written here with
     the fixture tool's LZW encoder and 32 of them in one launch for K9, with K9's
     windows, segments, codes, ns a code and time by phase from its clock64 counters,
     held to the CPU model's counts, and the solid-colour 640x480 fixture; K9's TIFF
     flavour and K10 on cv2's 640x480 LZW TIFF; the host's parse of a 640x480 PackBits
     and Deflate TIFF) per call and
     back to back, beside its bound and its plain
     version, each timed output bit-equal to the plain one, K1's synchronisation rounds
     and serially repaired subsequences, the progressive entropy decode by scan and by
     scan kind, K1's and K6's time by pass (torch.profiler), and the decode + resize of
     the batch and of one image by stage (marker walk, unstuffing and restart split,
     layout, upload, K1-K3 with the warnings read, the resizes) in the same loop as its
     end-to-end time, and the PNG's host prep (chunk CRCs, zlib, the filter-byte check)
     beside K5;
  6. NMS against the CPU on random and tie-heavy pools (B=32, N=400, 80 classes):
     nms_on_pool, nms_on_pool_merged and its per_anchor_top2 variant give bit-equal
     valid, classes, scores and boxes;
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
  7e. tools/benchmark.py at SSD300 (infer_b1, infer_b32, infer_fused_e2e_b32,
     train_step_b32, train_accum_8x; medians of 3 rounds with min and max): its
     train_step_b32 within 0.5x-2x of phase 3's median step, and the matcher once a step
     for train_step_b32 and 8 times a step for train_accum_8x; then tools/sweep_infer.py
     --fused --ptq at batches 32, 64 and 128 (the int8 kernels in every call);
  7f. tools/profile.py --summarize, --mode train (2 steps) and --mode infer-fused --ptq on
     config/default.yml: each summary by kernel group (a lower bound, beside the traced
     window's CUDA-event time), naming the matcher and the int8 conv;
  7g. tools/serve_bench.py's closed loop in process over BatchingFrontEnd.submit, live
     SSD300 bf16 and int8 with batch tiers 1, 8 and 32, at concurrency 1, 8 and 32, 96
     requests a level, none failing: img/s, p50 and p99 per level;
  7h. HTTP on the card: cli/serve.py::make_server over the live SSD300-VGG16 service
     (seed-0 weights, bf16, canvas 640x640, tiers 1, 8 and 32); every fixture body
     POSTed and answered as DetectorService.detect_images answers the decoder's pixels,
     which equal cv2's digests (progressive, CMYK, YCCK, 4:1:1, corrupt and smoothed
     JPEG bodies, GIF, TIFF, HDR, BMP, PxM, PAM, Sun raster and PFM bodies among them);
     the refused fixtures (AVIF by either brand, uncompressed 4-sample tiles, YCbCr of 4 x 4
     units that are no whole number of scanlines, PAMs with alpha, a 1-channel PFM)
     415, those cv2 returns None for and bytes that are no image 400; 32 clients x 4
     posts of the 640x480 JPEG (img/s, p50, p99);
  8. the evaluation gates, three `python -m ssd_object_detection_tpu_torch.cli.eval_synthetic`
     processes at their defaults at once on the card: `--ptq` (SSD300-VGG16 mAP@0.5 > 0.9,
     the int8 paths with heads float and heads int8 within 0.02 of it), `--variant
     ssd300_r34` and `--variant ssd300_mnv2` (each > 0.9); the VGG gate saves its weights,
     and tools/diag_levels.py reads them (SSD300, 8 classes, max_gt 8): per level the
     anchor ceiling, the regressor at the matcher's assignment (one kernel launch), the
     classifier's choice and the solo AP;
  9. prints the kernels line (the matcher's launches count phases 3, 3b, 3c, 3d, 4c, 4d,
     7e, 7f, 8's diag and 4e, the int8 conv's those of 7c, 7e's sweep, 7f and 7g, the
     nine image kernels' those of 4e's pack and of 7h's server, each at least one), then as its
     last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Each phase prints its seconds. The Keras .h5 import is host code and the card may lack
h5py, so it is not run here (tests/test_torch_import_keras.py covers it on the CPU).
TF32 is off for the whole run (cuDNN and matmul), so float32 work is full float32; the
train step and the detect path compute in bf16 by configuration. Any failure raises and
exits non-zero with no result line; so does a machine without a CUDA device or a
directory without the port package.
"""

import collections
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import zlib
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


def stream_spread(torch, fn, rounds: int = 5, iters: int = 10) -> tuple:
    """(median, max) over `rounds` of stream_ms's back-to-back mean of `iters` calls: one
    stall inflates one round's mean, not the median."""
    means = [stream_ms(torch, fn, warmup=3 if r == 0 else 0, iters=iters) for r in range(rounds)]
    return statistics.median(means), max(means)


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


def profiled_kernels(prof):
    """[(ms, calls, name)] by kernel of a torch.profiler run."""
    from torch.autograd import DeviceType

    return [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def format_groups(groups) -> str:
    return ", ".join(f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(), key=lambda x: -x[1]))


def profile_step(torch, step, label: str, kernel_groups) -> None:
    """Print where one call's device time goes (torch.profiler), informational."""
    from torch.profiler import ProfilerActivity, profile

    from ssd_object_detection_tpu_torch.tools.profile import group_kernels

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
    from ssd_object_detection_tpu_torch.ops import cuda_conv, cuda_image, cuda_int8, cuda_matcher, nms
    from ssd_object_detection_tpu_torch.ops.anchors import SSD512_SPEC, generate_anchors
    from ssd_object_detection_tpu_torch.ops.boxes import encode_boxes
    from ssd_object_detection_tpu_torch.ops.matching import build_targets, match_anchors
    from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
    from ssd_object_detection_tpu_torch.train.optim import exponential_decay, make_optimizer
    from ssd_object_detection_tpu_torch.train.step import (
        StepConfig, create_train_state, make_train_step,
    )
    from ssd_object_detection_tpu_torch.tools.profile import TRAIN_GROUPS

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

    with ThreadPoolExecutor(4) as pool:  # one nvcc process per source, all at once
        builds = list(pool.map(timed_build, (cuda_matcher, cuda_conv, cuda_int8, cuda_image)))
    for path, seconds in builds[:3]:
        print(f"built {path.name} in {seconds:.1f} s")
    print(f"built {', '.join(p.name for p in cuda_image.SOURCES)} in {builds[3][1]:.1f} s")

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
    jpeg_launches, jpeg_matcher = timed("4e (JPEG pack and train)", jpeg_train_phase, torch, np, dev, smi)

    conv = timed("5 (conv3x3 op)", conv_phase, torch, np, dev)
    int8 = timed("5b (int8 conv kernels)", int8_phase, torch, np, dev, smi)
    image = timed("5c (image kernels)", image_phase, torch, np, dev, smi)
    timed("6 (NMS)", nms_phase, torch, np, nms, dev)
    timed("7 (detect)", detect_phase, torch, np, dev, anchors300)
    int8["launches"] = timed("7c (PTQ detect)", ptq_detect_phase, torch, np, dev, anchors300, smi)
    timed("7b (serving)", serve_phase, torch, np, dev, smi)
    http_launches = timed("7h (HTTP on the card)", http_phase, torch, np, dev, smi)
    timed("7d (bench entry)", bench_phase, torch, np, dev, smi)
    tool_launches, tool_int8 = timed("7e (tools.benchmark, tools.sweep_infer)", bench_tools_phase,
                                     torch, dev, smi, med)
    profile_launches, profile_int8 = timed("7f (tools.profile)", profile_tools_phase, torch, dev, smi)
    serve_int8 = timed("7g (tools.serve_bench)", serve_client_phase, torch, np, dev, smi)
    int8["launches"] += tool_int8 + profile_int8 + serve_int8
    diag_launches = timed("8 (mAP gates, tools.diag_levels)", eval_gate_phase)

    # ---- 9. result lines ----------------------------------------------------------
    for name in IMAGE_SOURCES:  # the slice's main paths: the JPEG root's pack (4e) and HTTP (7h)
        image[name]["launches"] = jpeg_launches[name] + http_launches[name]
        if not image[name]["launches"]:
            fail(f"{name} was launched no time on the pack and HTTP paths")
    print(f"all phases in {time.time() - started:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "greedy_anchor_matcher",
        "route": "cuda",
        "source": MATCHER_SOURCE,
        "replaces": MATCHER_REPLACES,
        "launches": (launches + aug_launches + family_launches + dp_launches + tool_launches
                     + profile_launches + diag_launches + jpeg_matcher),
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
    }] + [{
        "name": name, "route": "cuda", "source": source, "replaces": IMAGE_REPLACES, **image[name],
    } for name, source in IMAGE_SOURCES.items()]}))
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
    from ssd_object_detection_tpu_torch.tools.profile import PREDICT_GROUPS

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
    from ssd_object_detection_tpu_torch.tools.profile import TRAIN_GROUPS, group_kernels
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
        steady = create_train_state(trainer.model, trainer._optimizer(mc.train), trainer.main_schedule)
        trainer._run_phase("train", steady, trainer.train_batches(epochs=1))  # warm

        def epoch_ms(batches) -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer._run_phase("train", steady, batches)
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
            trainer._run_phase("train", steady, batches, max_steps=steady.step + 5)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        trace = os.path.join(root, "trainer_trace.json")
        prof.export_chrome_trace(trace)
        groups = group_kernels(profiled_kernels(prof), TRAIN_GROUPS)
        print(f"profile of 5 Trainer steps: {trace_overlap(trace, wall_ms)}; device time by "
              f"group: {format_groups(groups)}; {sum(groups.values()) / 5:.3f} ms of device time "
              f"per step against {step_ms:.2f} ms per unprofiled step")
        del trainer, steady, state, x, images
        torch.cuda.empty_cache()
        feed_launches = timed("4d (feed ceiling)", feed_ceiling_phase, torch, dev, root, cache,
                                    variant, num_images, batch_size, card)
        return feed_launches + device_augment_phase(torch, np, dev, root, cache, step_ms, card, variant,
                                                    num_images, batch_size)


def feed_ceiling_phase(torch, dev, root: str, cache: str, variant: str, num_images: int,
                       batch_size: int, card: str) -> int:
    """4d. tools/feed_ceiling.py's cells on phase 4b's packed fixture through 4b's Trainer
    config: the host, device and link floors, and end-to-end steps at device_prefetch
    depths 1, 2 and 4, each from a fresh epoch; returns its matcher launches."""
    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.tools import feed_ceiling
    from ssd_object_detection_tpu_torch.train.loop import Trainer

    steps, depths = 10, (1, 2, 4)
    trainer = Trainer(production_config(root, cache, variant, num_images, batch_size),
                      run_dir=os.path.join(root, "feed_ceiling"), device=dev)
    cuda_matcher.match_anchors_cuda.launches = 0
    r = feed_ceiling.measure(trainer, trainer._make_train_source(), steps, depths)
    launches = cuda_matcher.match_anchors_cuda.launches
    floors = r["floors_ms"]
    if not all(math.isfinite(v) and v > 0 for v in floors.values()):
        fail(f"feed ceiling: floors {floors}")
    expected = (1 + len(depths)) * (feed_ceiling.FILL_STEPS + r["timed_steps"]) * trainer.step_cfg.accum_steps
    if launches != expected:
        fail(f"feed ceiling: {launches} matcher launches, expected {expected} (one a step)")
    e2e = r["e2e_by_prefetch_depth"]
    print(f"feed ceiling ({variant} bf16, batch {batch_size}, packed cache of {r['epoch_batches']} "
          f"batches, host flip) [{card}]: floors host {floors['host']} ms a batch, device "
          f"{floors['device']} ms a step, link {floors['link']} ms a batch ({r['link_mb_per_s']} MB/s "
          f"pinned); end to end over {r['timed_steps']} steps from a fresh epoch: "
          + ", ".join(f"depth {k.split('_')[1]} {v['ms_per_step']} ms" for k, v in e2e.items())
          + f"; binding {r['binding_resource']}, overlap residual {r['overlap_residual_ms']} ms; "
          f"matcher launches {launches}")
    del trainer
    torch.cuda.empty_cache()
    return launches


def device_augment_phase(torch, np, dev, root: str, cache: str, flip_step_ms: float, card: str,
                         variant: str, num_images: int, batch_size: int) -> int:
    """4c. The Trainer with the full recipe (flip, expand, crop, photometric) on the
    device, on phase 4b's packed fixture; returns its matcher launches."""
    from ssd_object_detection_tpu_torch.data.packed import PackedConfig, PackedPipeline
    from ssd_object_detection_tpu_torch.ops import augment, cuda_matcher
    from ssd_object_detection_tpu_torch.tools.profile import TRAIN_GROUPS, group_kernels
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


# ---- 5c, 4e, 7h. decoding without cv2 ------------------------------------------------------
IMAGE_SOURCES = {"jpeg_entropy_decode": f"{PACKAGE}/csrc/jpeg_decode.cu",
                 "jpeg_idct_color": f"{PACKAGE}/csrc/jpeg_decode.cu",
                 "resize": f"{PACKAGE}/csrc/resize.cu",
                 "png_unfilter_expand": f"{PACKAGE}/csrc/png_unfilter.cu",
                 "progressive_entropy": f"{PACKAGE}/csrc/jpeg_progressive.cu",
                 "block_smooth": f"{PACKAGE}/csrc/jpeg_smooth.cu",
                 "raw_expand": f"{PACKAGE}/csrc/raw_image.cu",
                 "lzw_decode": f"{PACKAGE}/csrc/gif_lzw.cu",
                 "tiff_assemble": f"{PACKAGE}/csrc/tiff_assemble.cu",
                 "ccitt_decode": f"{PACKAGE}/csrc/ccitt_decode.cu",
                 "sgilog_decode": f"{PACKAGE}/csrc/sgilog_decode.cu"}
OLD_K1_MS = 9.6163  # the one-thread-a-segment K1 at 32 x 640x480 4:2:0 (chip_smoke.py, PERF.md run F)
# the one-block-an-image K6 (every scan, one thread a scan) at 32 x 640x480 progressive
# (chip_smoke.py, PERF.md run G of that design)
OLD_K6_MS = 69.2901
# the one-reading-thread K9 (records written in turns) on one 640x480 GIF (chip_smoke.py,
# PERF.md §6's K9 row)
OLD_K9_MS = 23.3709
# K2 (a thread a block) + K3 (a thread a pixel) at 32 x 640x480 4:2:0, the two launches'
# sum before they were fused (chip_smoke.py, PERF.md run G: 0.1170 + 0.2023)
OLD_K2_K3_MS = 0.3193
# the H100 SXM's peak integer issue rate, 132 SMs x 128 lanes x 1.98 GHz boost: each SM
# issues 64 integer lanes a clock to its INT32 pipe (adds, logic, shifts; the data
# sheet's 64 INT32 units) and 64 more to its FMA pipe, which executes IMAD. A bound takes
# the peak; at the INT32 pipe's 64 lanes alone the time doubles.
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# an estimate, not counted from the kernel's instructions: 16 1-D passes of ~60 and the
# dequantisation a block, ~30 a pixel for upsampling and colour
IDCT_OPS_PER_BLOCK, COLOR_OPS_PER_PIXEL = 1100, 30
IMAGE_REPLACES = ("no Pallas counterpart: cv2 on the host in the JAX package "
                  "(ssd_object_detection_tpu/data/pipeline.py:70)")


def image_wrappers():
    """The image kernels' wrappers in the kernels line's order."""
    from ssd_object_detection_tpu_torch.ops import cuda_image

    return dict(zip(IMAGE_SOURCES, cuda_image.KERNELS))


def fixture_record():
    from ssd_object_detection_tpu_torch.tools.make_image_fixtures import FIXTURES

    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return FIXTURES, json.load(f)


def decode_stages_ms(torch, dev, codec, cuda_image, blobs, repeats: int = 7) -> tuple:
    """The decode + 300x300 resize of `blobs` (JPEGs) by stage, in one loop with its
    end-to-end time, both warm: each repeat runs the staged pass (the marker walk, the
    unstuffing and restart split inside it, the layout, the upload with the stream
    synchronised, K1-K3 with the status read, the resizes (cuda_image.resize_batch: one
    K4 launch) with the stream synchronised) and the unstaged pass (codec.decode_images,
    then the resizes), in turns, the first
    order alternating. Returns ({stage: mean ms}, mean ms of the staged pass, mean ms of
    the unstaged pass): means, so that the stages add up, to at most the staged pass's
    time as in every pass."""
    split = codec._split_entropy
    spent = [0.0]

    def timed_split(d):
        t = time.perf_counter()
        out = split(d)
        spent[0] += time.perf_counter() - t
        return out

    def staged():
        spent[0] = 0.0
        marks = [time.perf_counter()]
        parsed = [codec.parse_jpeg(b) for b in blobs]
        marks.append(time.perf_counter())
        batch = codec.jpeg_batch(parsed)
        marks.append(time.perf_counter())
        batch = batch.to(dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        imgs, status = cuda_image.decode_jpeg_batch(batch)
        int(status.sum())  # the warnings read back, as a caller that reports them would
        marks.append(time.perf_counter())
        cuda_image.resize_batch(imgs, [(300, 300)] * len(imgs))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        walk = (marks[1] - marks[0]) - spent[0]
        return [walk, spent[0]] + [b - a for a, b in zip(marks[1:-1], marks[2:])], marks[-1] - marks[0]

    def unstaged():
        t = time.perf_counter()
        imgs = codec.decode_images(blobs, dev)
        cuda_image.resize_batch(imgs, [(300, 300)] * len(imgs))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    names = ("marker walk", "unstuff and split", "layout", "upload", "K1-K3 and warnings read", "resizes")
    stages, staged_s, unstaged_s = {k: [] for k in names}, [], []
    codec._split_entropy = timed_split
    try:
        staged()
        unstaged()
        for r in range(repeats):
            for run in ((staged, unstaged) if r % 2 == 0 else (unstaged, staged)):
                if run is unstaged:
                    unstaged_s.append(unstaged())
                    continue
                parts, total = staged()
                if sum(parts) > total + 1e-9:
                    fail(f"decode stages sum to {sum(parts) * 1e3:.3f} ms, past their pass's {total * 1e3:.3f} ms")
                for k, v in zip(names, parts):
                    stages[k].append(v * 1e3)
                staged_s.append(total)
    finally:
        codec._split_entropy = split
    return ({k: statistics.fmean(v) for k, v in stages.items()}, statistics.fmean(staged_s) * 1e3,
            statistics.fmean(unstaged_s) * 1e3)


def decode_tiff(codec, cuda_image, tif, device):
    """One parsed TIFF through the kernels on `device`: its JPEG chunks (if any) through K1
    (K6, K7) and the fused K2 + K3 in one batch, then K9, K10 (each where it needs them)
    and K8."""
    chunks = codec.tiff_jpeg_chunks([tif])
    pixels = None
    if chunks:
        batch = codec.jpeg_batch(chunks)
        batch = batch.to(device) if device.type == "cuda" else batch
        pixels = cuda_image.idct_color(cuda_image.decode_entropy(batch)[0], batch)
    return cuda_image.decode_raw_batch([], [tif], [], device, pixels)[0]


def smooth_report(torch, np, codec, cuda_image, fx, dev, prog_blob: bytes, smooth_in, smooth_dev, card: str) -> str:
    """K7 beside its bounds: the timed batch (32 x 640x480 progressive cut in its fifth scan,
    whose chroma components take the DC copy) from a CUDA graph, its passes apart
    (torch.profiler's records) and its launches; then from graphs one such image, 32 cut
    in the ninth scan (no component's DCs change: one launch) and 32 cut after the DC scan
    (every component's DCs change); each output bit-equal to the plain version's. The
    inputs are cloned at every call (K7 works in place): a graph of the clone alone is
    taken off."""
    def inputs(blob: bytes, n: int):
        host = codec.jpeg_batch([codec.parse_jpeg(blob)] * n)
        batch = host.to(dev)
        coef, _, stops = cuda_image.progressive_entropy(batch, cuda_image.entropy_decode(batch))
        hcoef, _, hstops = cuda_image.progressive_entropy(host, cuda_image.entropy_decode(host))
        return host, batch, coef, stops, hcoef, hstops

    def timed(host, batch, coef, stops, hcoef, hstops, label: str) -> str:
        before = cuda_image.block_smooth.launches
        got = cuda_image.block_smooth(batch, coef.clone(), stops)
        launches = cuda_image.block_smooth.launches - before
        if not torch.equal(got.cpu(), cuda_image.block_smooth(host, hcoef.clone(), hstops)):
            fail(f"block_smooth: the kernel on {label} differs from its plain version")
        if launches != 1 + int(host.smooth_dc > 0):
            fail(f"block_smooth: {launches} launches on {label}, expected {1 + int(host.smooth_dc > 0)}")
        g = graph_ms(torch, lambda: cuda_image.block_smooth(batch, coef.clone(), stops)) - \
            graph_ms(torch, lambda: coef.clone())
        sectors = cuda_image.bound_bytes("block_smooth_sectors", blocks=host.smooth_blocks) / HBM_BYTES_PER_S * 1e3
        return (f"{label}: {g:.4f} ms from a graph in {launches} launch(es) ({host.smooth_blocks} blocks, "
                f"{host.smooth_tiles} CTAs, {host.smooth_dc} DCs copied aside; the 32-byte-sector bound "
                f"{sectors:.6f} ms, {sectors / g * 100:.1f} % of it)")

    start, end = fx.entropy_span(prog_blob, 4)
    cut4 = prog_blob[:start + (end - start) // 2] + b"\xff\xd9"
    start, end = fx.entropy_span(prog_blob, 8)
    cut8 = prog_blob[:start + (end - start) // 2] + b"\xff\xd9"
    dc_only = prog_blob[:fx.entropy_span(prog_blob, 0)[1]] + b"\xff\xd9"
    per = {}
    for ms, _, kname in device_kernels(torch, lambda: cuda_image.block_smooth(smooth_dev, smooth_in[0].clone(),
                                                                            smooth_in[2])):
        for p in ("dc_copy", "smooth"):
            if f"{p}_kernel" in kname:
                per[p] = per.get(p, 0.0) + ms
    parts = [timed(*inputs(cut4, 32), "32 x 640x480 cut in the fifth scan (the timed batch)"),
             "its passes (torch.profiler's records, ms) " + (", ".join(f"{k} {v:.4f}" for k, v in per.items())
                                                            or "none recorded"),
             timed(*inputs(cut4, 1), "one such image"),
             timed(*inputs(cut8, 32), "32 cut in the ninth scan"),
             timed(*inputs(dc_only, 32), "32 cut after the DC scan")]
    return f"K7 [{card}]: " + "; ".join(parts) + "; timed outputs equal the plain version's"


def ccitt_report(torch, np, codec, cuda_image, dev, blobs, page, page1_h, page32, ms: float, bound: float,
                 card: str) -> str:
    """K11 beyond the timed 8-strip page: 32 copies of it in one launch, bit-equal to 32 of
    the one page's plain output; the same page in one strip (nothing to spread: the walk's
    cost a code word) and one 37x23 fixture, each bit-equal to the plain version; the cases
    whose guesses fail (a Group 3 strip without EOLs before strips with them, a Group 4
    strip whose first row reads past the white reference line) in one launch beside the
    page, bit-equal, each repaired from its second chunk as ops/fax_schedule_model replays
    it; and the reckoned chain bounds of the walk: one dependent table lookup (a code word)
    a changing element, each at about an L1 hit's 35 cycles of 1.98 GHz (reckoned, not
    measured), for the page's longest strip (the new schedule's) and for the whole page
    (one strip)."""
    from ssd_object_detection_tpu_torch.ops import fax_schedule_model

    cpu = torch.device("cpu")
    batch, buf, _ = page32
    before = cuda_image.ccitt_decode.launches
    cuda_image.ccitt_decode(buf, batch)
    if cuda_image.ccitt_decode.launches != before + 1:
        fail("ccitt_decode: 32 pages took more than one launch")
    want = cuda_image.ccitt_decode(page1_h[1].clone(), page1_h[0])[page1_h[0].fax_out:page1_h[0].total]
    got = buf[batch.fax_out:batch.total].cpu().reshape(32, -1)
    if not all(torch.equal(g, want) for g in got):
        fail("ccitt_decode: the kernel on 32 pages in one launch differs from its plain version")
    ms32 = cuda_ms(torch, lambda: cuda_image.ccitt_decode(buf, batch), warmup=1, iters=5)

    def single(name):  # (graph ms, plain ms) of K11 on one fixture alone, held bit-equal
        t = codec.parse_tiff(blobs[name])
        b = codec.raw_batch([], [t], [])
        d, h = cuda_image.upload(b, dev), cuda_image.upload(b, cpu)
        cuda_image.ccitt_decode(d, b)
        start = time.perf_counter()
        cuda_image.ccitt_decode(h, b)
        plain = (time.perf_counter() - start) * 1e3
        if not torch.equal(d.cpu(), h):
            fail(f"ccitt_decode: the kernel on {name} differs from its plain version")
        return graph_ms(torch, lambda: cuda_image.ccitt_decode(d, b), calls=5, replays=3), plain

    one_ms, one_plain = single("tiff_ccitt_g4_page_one_strip_1728x2200.tif")
    small_ms, _ = single("tiff_ccitt_g4_strips_37x23.tif")
    names = ["tiff_ccitt_noeol_then_eol_37x23.tif", "tiff_ccitt_g4_page_1728x2200.tif",
             "tiff_ccitt_g4_past_white_37x23.tif"]
    b = codec.raw_batch([], [codec.parse_tiff(blobs[n]) for n in names], [])
    d, h = cuda_image.upload(b, dev), cuda_image.upload(b, cpu)
    records = torch.zeros((b.faxes, codec.FAX_RECORD_INTS), dtype=torch.int32, device=dev)
    cuda_image.ccitt_decode(d, b, records)
    cuda_image.ccitt_decode(h, b)
    if not torch.equal(d.cpu(), h):
        fail("ccitt_decode: the kernel on the cases whose guesses fail differs from its plain version")
    model = h.numpy().copy()
    model[b.fax_out:] = 0
    report = fax_schedule_model.ccitt_schedule(model, b.fax_streams, model)
    repairs = [int(records[f, codec.FR_REPAIR_FROM]) for f in report]
    if repairs != [0 if r["repair_from"] is None else r["repair_from"] + 1 for r in report.values()] or \
            repairs != [2, 0, 2]:
        fail(f"ccitt_decode: repairs from chunks {repairs}, the replay's {report}")
    rows = np.unpackbits(want.numpy()).reshape(page.height, -1)[:, :page.width]
    per_row = (np.diff(rows.astype(np.int8), axis=1) != 0).sum(1) + rows[:, 0] + 1
    strip_rows = page.chunks[0].rows
    longest = max(int(per_row[y:y + strip_rows].sum()) for y in range(0, page.height, strip_rows))
    chain, whole = longest * 35 / 1.98e9 * 1e3, int(per_row.sum()) * 35 / 1.98e9 * 1e3
    return (f"K11 [{card}]: 32 pages in one launch {ms32:.4f} ms ({ms32 / ms:.3f} x one; byte bound "
            f"{32 * bound:.6f} ms); the page in one strip {one_ms:.4f} ms from a CUDA graph (plain {one_plain:.1f} "
            f"ms), tiff_ccitt_g4_strips_37x23.tif {small_ms:.4f} ms; the guesses of the noeol-then-EOL and "
            f"past-the-white-line cases repaired from chunk 2 as the replay repairs them, the page beside them "
            f"not; reckoned chain bounds: the page's longest strip {chain:.4f} ms ({longest} changing elements, "
            f"a lookup each at 35 cycles; {chain / ms * 100:.1f} % of the 8-strip time), the whole page "
            f"{whole:.4f} ms ({int(per_row.sum())}; {whole / one_ms * 100:.1f} % of the one-strip time); timed "
            f"outputs equal the plain version's")


def sgilog_640x480(np, fx, rgb) -> bytes:
    """A 640x480 LogLuv TIFF (SGILog, strips of 16 rows) of `rgb`'s pixels as linear XYZ,
    encoded with the fixture tool's tif_luv.c encoder."""
    lin = (rgb.astype(np.float64) / 255) ** 2.2
    xyz = lin @ np.array([[0.4124, 0.3576, 0.1805], [0.2126, 0.7152, 0.0722], [0.0193, 0.1192, 0.9505]]).T
    words = fx.logluv32(xyz)
    strips = [b"".join(fx.sgilog_planes(r, 4) for r in words[y:y + 16]) for y in range(0, words.shape[0], 16)]
    return fx.tiff(fx.tiff_tags(words.shape[1], words.shape[0], 16, 3, 32845, 34676, rows=16), strips)


def sgilog_report(torch, codec, cuda_image, dev, raw_batch, tiffs, names, card: str) -> str:
    """K12 on every SGILog fixture's chunks in one launch, from a CUDA graph, beside its
    plain version on them, bit-equal."""
    tif_names = [n for n in names if n.endswith(".tif")]
    sgi = [t for n, t in zip(tif_names, tiffs) if n.startswith(("tiff_sgilog_", "tiff_sgilog24_"))]
    b = codec.raw_batch([], sgi, [])
    d, h = cuda_image.upload(b, dev), cuda_image.upload(b, torch.device("cpu"))
    cuda_image.sgilog_decode(d, b)
    start = time.perf_counter()
    cuda_image.sgilog_decode(h, b)
    plain = (time.perf_counter() - start) * 1e3
    if not torch.equal(d.cpu(), h):
        fail("sgilog_decode: the kernel on the SGILog fixtures differs from its plain version")
    ms = graph_ms(torch, lambda: cuda_image.sgilog_decode(d, b), calls=10, replays=3)
    return (f"K12 [{card}]: the {len(sgi)} SGILog fixtures' {b.sgis} chunks in one launch {ms:.4f} ms from a CUDA "
            f"graph, plain {plain:.1f} ms; outputs equal the plain version's")


def expand_report(torch, cuda_image, card: str, ms: float, b2b: float, bound: float, bmp1, bmp32, tif1, tif1_h,
                  tif32, k10_bytes: int, bmp_bytes: int) -> str:
    """K8 (and K10) at the decode feed's shapes, each a decode call's launches from inputs
    on the card (a batch, its buffer after K9, K9's status): one 640x480 24-bit BMP, 32 of
    them in one call, cv2's 640x480 LZW TIFF after K9 (K10 in place, then K8) and 32 of
    those; per call, back to back, from a CUDA graph (the card alone) and the wrappers'
    host time, each against its byte bound; the 32-image outputs held to the one-image
    plain ones. The TIFF calls undo the predictor again at every call, in copies of the
    buffers: the same work."""
    tif1, tif32 = (tif1[0], tif1[1].clone(), tif1[2]), (tif32[0], tif32[1].clone(), tif32[2])
    def tiff_call(inputs):
        batch, buf, status = inputs

        def call():
            cuda_image.tiff_assemble(buf, batch, status)
            return cuda_image.raw_expand(buf, batch)
        return call

    def bmp_call(inputs):
        return lambda: cuda_image.raw_expand(inputs[1], inputs[0])

    want_bmp = cuda_image.raw_expand(bmp1[1], bmp1[0]).cpu()
    got = cuda_image.raw_expand(bmp32[1], bmp32[0]).cpu()
    step = bmp32[0].out[1][0]
    if not all(torch.equal(got[i * step:i * step + want_bmp.numel()], want_bmp) for i in (0, 31)):
        fail("raw_expand: 32 BMPs in one launch differ from the one-BMP output")
    want_tif = tiff_call((tif1_h[0], tif1_h[1].clone(), tif1_h[2]))()  # K10 then K8, the plain versions
    for label, inputs in (("one", tif1), ("32", tif32)):
        batch, buf, status = inputs
        fresh = cuda_image.upload(batch, buf.device)
        fresh[batch.lzw_at:] = buf[batch.lzw_at:]  # K9's output, not yet predicted
        got = tiff_call((batch, fresh, status))().cpu()
        if not all(torch.equal(got[at:at + want_tif.numel()], want_tif) for at, _, _ in batch.out[:1] + batch.out[-1:]):
            fail(f"K10 + K8 on {label} 640x480 LZW TIFF after K9 differ from the plain versions")
    floor = torch.zeros(1, dtype=torch.uint8, device=bmp1[1].device)
    lines = []
    tif_bound = (k10_bytes + 640 * 480 * 3 * 2) / HBM_BYTES_PER_S * 1e3  # K10's rows in and out, K8's samples in, RGB out
    for label, call, n, one_bound in (("one BMP", bmp_call(bmp1), 1, bound), ("32 BMPs", bmp_call(bmp32), 32, bound),
                                      ("one TIFF (K10 + K8)", tiff_call(tif1), 1, tif_bound),
                                      ("32 TIFFs (K10 + K8)", tiff_call(tif32), 32, tif_bound)):
        g = graph_ms(torch, call)
        host = enqueue_us(torch, call)
        per = ms if n == 1 and "BMP" in label else cuda_ms(torch, call, warmup=2, iters=10)
        back = b2b if n == 1 and "BMP" in label else stream_ms(torch, call, warmup=1, iters=10)
        lines.append(f"{label} {per:.4f} ms a call, {back:.4f} back to back, {g:.4f} from a CUDA graph (bound "
                     f"{n * one_bound:.6f} ms, {n * one_bound / g * 100:.2f} % of it), host {host:.1f} us")
    lines.append(f"the launch floor (a graph node adding 1 to one byte) {graph_ms(torch, lambda: floor.add_(1)):.4f} ms")
    return ("; K8 and K10 at the decode feed's shapes [" + card + "]: " + "; ".join(lines)
            + f" ({bmp_bytes} bytes of BMP rows an image; timed outputs equal the plain versions')")


def resize_report(torch, np, cuda_image, dev, one, ms: float, b2b: float, bound: float, plain_ms: float) -> tuple:
    """K4 beyond its per-call time on one 640x480 -> 300x300 uint8 image (`one`): from a
    CUDA graph (the card alone), the wrapper's host time a call, 32 images in one launch
    (resize_batch: per call, back to back, from a graph) against 32 bounds; float32 linear
    on one image and 32, and INTER_AREA at a whole-number factor (1280x960 -> 640x480),
    each beside the one PyTorch call that computes the same function
    (F.interpolate: bilinear, align_corners=False; area), the largest difference from
    it, and every output equal to the plain version's. Returns (the text, F.interpolate's
    ms for the float32 image: the kernels line's library_ms)."""
    F = torch.nn.functional
    graph = graph_ms(torch, lambda: cuda_image.resize(one, (300, 300)))
    host = enqueue_us(torch, lambda: cuda_image.resize(one, (300, 300)))
    many = [one.clone() for _ in range(32)]
    sizes = [(300, 300)] * 32
    batch32 = lambda: cuda_image.resize_batch(many, sizes)  # noqa: E731
    before = cuda_image.resize.launches
    got = batch32()
    if cuda_image.resize.launches != before + 1:
        fail("resize_batch of 32 images took more than one launch")
    want = cuda_image.resize(one.cpu(), (300, 300))
    if not all(torch.equal(g.cpu(), want) for g in got):
        fail("resize_batch of 32 images differs from the plain version")
    ms32, b2b32, graph32 = (cuda_ms(torch, batch32, warmup=2, iters=10), stream_ms(torch, batch32, warmup=1, iters=10),
                            graph_ms(torch, batch32))
    host32 = enqueue_us(torch, batch32)
    f1 = one.float() / 255
    f32s = [f1.clone() for _ in range(32)]
    nchw1 = f1.permute(2, 0, 1)[None].contiguous()
    nchw32 = nchw1.expand(32, -1, -1, -1).contiguous()
    k4_f1 = lambda: cuda_image.resize(f1, (300, 300))  # noqa: E731
    k4_f32 = lambda: cuda_image.resize_batch(f32s, sizes)  # noqa: E731
    lib_f1 = lambda: F.interpolate(nchw1, size=(300, 300), mode="bilinear", align_corners=False)  # noqa: E731
    lib_f32 = lambda: F.interpolate(nchw32, size=(300, 300), mode="bilinear", align_corners=False)  # noqa: E731
    if not torch.equal(k4_f1().cpu(), cuda_image.resize(f1.cpu(), (300, 300))):
        fail("float32 linear resize of the 640x480 image differs from the plain version")
    f_diff = float((k4_f1().permute(2, 0, 1) - lib_f1()[0]).abs().max())
    times = {k: (cuda_ms(torch, fn, warmup=2, iters=10), stream_ms(torch, fn, warmup=1, iters=10))
             for k, fn in (("k4_f1", k4_f1), ("lib_f1", lib_f1), ("k4_f32", k4_f32), ("lib_f32", lib_f32))}
    big = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (960, 1280, 3), dtype=np.uint8)).to(dev)
    big_f = big.float().permute(2, 0, 1)[None].contiguous()
    k4_area = lambda: cuda_image.resize(big, (480, 640), "area")  # noqa: E731
    lib_area = lambda: F.interpolate(big_f, size=(480, 640), mode="area")  # noqa: E731
    if not torch.equal(k4_area().cpu(), cuda_image.resize(big.cpu(), (480, 640), "area")):
        fail("the INTER_AREA fit 1280x960 -> 640x480 differs from the plain version")
    area_diff = float((k4_area().float().permute(2, 0, 1) - lib_area()[0].round()).abs().max())
    area_ms, lib_area_ms = cuda_ms(torch, k4_area, warmup=2, iters=10), cuda_ms(torch, lib_area, warmup=2, iters=10)
    area_bound = (960 * 1280 * 3 + 480 * 640 * 3) / HBM_BYTES_PER_S * 1e3
    f_bound = (640 * 480 * 3 + 300 * 300 * 3) * 4 / HBM_BYTES_PER_S * 1e3
    text = (f"; from a CUDA graph (the card alone) {graph:.4f} ms a call; the wrapper's host time {host:.1f} us a "
            f"call; 32 images in one launch (resize_batch) {ms32:.4f} ms a call, {b2b32:.4f} back to back, "
            f"{graph32:.4f} from a graph, host {host32:.1f} us a call (bound {32 * bound:.6f} ms, "
            f"{32 * bound / graph32 * 100:.3f} % of it from the graph; {32 * ms / ms32:.1f} x 32 single calls' "
            f"time); float32 linear, one image: K4 {times['k4_f1'][0]:.4f} ms a call, {times['k4_f1'][1]:.4f} back "
            f"to back, F.interpolate (bilinear) {times['lib_f1'][0]:.4f}, {times['lib_f1'][1]:.4f} (bound "
            f"{f_bound:.6f} ms; largest difference from K4 {f_diff:.3e}, the order of operations); 32 images: K4 "
            f"{times['k4_f32'][0]:.4f}, {times['k4_f32'][1]:.4f}; F.interpolate {times['lib_f32'][0]:.4f}, "
            f"{times['lib_f32'][1]:.4f} (bound {32 * f_bound:.6f}); INTER_AREA 1280x960 -> 640x480 uint8: K4 "
            f"{area_ms:.4f} ms a call, F.interpolate (area, float32) {lib_area_ms:.4f} (bound {area_bound:.6f} ms "
            f"for K4's bytes; largest difference from the rounded float mean {area_diff:.0f}); timed outputs "
            f"equal the plain version's")
    return text, times["lib_f1"][0]


def gif_640x480(np, fx, rgb) -> bytes:
    """A 640x480 GIF of `rgb` as cv2's writer makes one (its encoder is not on the card):
    a 256-entry global table (3-3-2 bits of red, green, blue), the pixels dithered to it
    with seeded random thresholds, written with the fixture tool's LZW encoder. On the
    640x480 JPEG fixture this gives as many LZW codes as cv2.imencode's dithered GIF of
    it (about 69,000; 97 kB)."""
    threshold = np.random.default_rng(0).random(rgb.shape[:2])

    def level(channel, levels):
        return np.clip(np.floor(rgb[..., channel] / 255 * (levels - 1) + threshold), 0, levels - 1).astype(np.int64)

    index = level(0, 8) * 32 + level(1, 8) * 4 + level(2, 4)
    k = np.arange(256)
    palette = np.stack([(k >> 5) * 255 // 7, ((k >> 2) & 7) * 255 // 7, (k & 3) * 255 // 3], -1)
    return fx.gif(index, palette)


def lzw_report(torch, cuda_image, gif_lzw_model, gif_valid, gif, batch, ms: float, bound, card: str) -> str:
    """K9 on one GIF: its windows, segments and codes (the kernel's counters, held to the
    CPU model's), ns a code, and its `ms` split over the four phases by the cycles thread
    0 counted in each (clock64)."""
    stats = torch.zeros((1, len(cuda_image.LZW_STATS)), dtype=torch.int64, device=batch.data.device)
    cuda_image.lzw_decode(batch, stats)
    got = dict(zip(cuda_image.LZW_STATS, stats[0].cpu().tolist()))
    _, _, model = gif_lzw_model.decode_frame(gif.lzw, gif.min_code_size, gif.frame_width, gif.frame_height,
                                             gif.interlaced, gif_valid(batch.gifs[0].cpu().tolist()))
    want = {k: getattr(model, k) for k in ("windows", "segments", "codes", "rounds", "levels")}
    if any(got[k] != v for k, v in want.items()):
        fail(f"lzw_decode: the kernel's counters {got} differ from the CPU model's {want}")
    cycles = [got[k] for k in cuda_image.LZW_STATS[:4]]
    phases = ", ".join(f"{k.split('_')[0]} {ms * c / max(sum(cycles), 1):.4f}"
                       for k, c in zip(cuda_image.LZW_STATS[:4], cycles))
    text = (f"{gif.frame_width}x{gif.frame_height}: {ms:.4f} ms, {got['codes']} codes in {got['segments']} "
            f"segments and {got['windows']} windows of {gif_lzw_model.WINDOW}, {ms / got['codes'] * 1e6:.1f} ns a "
            f"code; {got['rounds']} pointer-jumping rounds and {got['levels']} lifting levels built in all; by phase "
            f"(ms, the call's time split as thread 0's clock64 cycles: {sum(cycles)} in all) {phases}")
    return text if bound is None else text + f" [{card}]"


def image_phase(torch, np, dev, card: str) -> dict:
    """5c. The image kernels: each bit-equal to its plain version, and every decode
    equal to cv2's recorded digests, on the fixtures (their seams, corrupt and smoothed
    JPEGs, BMP, PxM, Sun raster and PFM included); then each timed at the main path's
    shapes, the progressive decode by scan kind. Returns, per kernel, the kernels line's
    numbers but its launches."""
    from ssd_object_detection_tpu_torch.data import codec
    from ssd_object_detection_tpu_torch.ops import cuda_image, gif_lzw_model
    from ssd_object_detection_tpu_torch.ops.plain_image import gif_valid
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx
    from ssd_object_detection_tpu_torch.tools.make_image_fixtures import REFUSED, png as encode_png, sha

    fixtures, record = fixture_record()
    images = record["images"]
    names = sorted(n for n, e in images.items() if "refused" not in e)
    blobs = {n: open(os.path.join(fixtures, n), "rb").read() for n in names}
    cpu = torch.device("cpu")

    # ---- bit-equality: every JPEG fixture in one batch, stage by stage ------------------
    jpegs = [n for n in names if n.endswith(".jpg")]
    host = codec.jpeg_batch([codec.parse_jpeg(blobs[n]) for n in jpegs])
    gpu = host.to(dev)
    fixture_sync = torch.zeros((host.segments.shape[0], 2), dtype=torch.int32, device=dev)
    out, out_p = cuda_image.entropy_outputs(gpu), cuda_image.entropy_outputs(host)
    err = {}
    for step in range(host.steps):
        for name, fn in (("jpeg_entropy_decode", cuda_image.entropy_decode),
                         ("progressive_entropy", cuda_image.progressive_entropy)):
            fn(gpu, out, step, fixture_sync) if fn is cuda_image.entropy_decode else fn(gpu, out, step)
            fn(host, out_p, step)
            for got, want in zip(out, out_p):
                if not torch.equal(got.cpu(), want):
                    fail(f"{name} (step {step}): the kernel differs from its plain version in "
                         f"{(got.cpu() != want).sum().item()} values")
            err[name] = max(err.get(name, 0.0), float((out[0].cpu().int() - out_p[0].int()).abs().max()))
    fixture_sync = fixture_sync.cpu()
    fixture_rounds, fixture_walked = fixture_sync[:, 0], fixture_sync[:, 1]
    warnings = int(out_p[1].sum())
    cuda_image.block_smooth(gpu, out[0], out[2])
    cuda_image.block_smooth(host, out_p[0], out_p[2])
    rgb = cuda_image.idct_color(out[0], gpu)
    rgb_p = cuda_image.idct_color(out_p[0], host)
    for name, got, want in (("block_smooth", out[0], out_p[0]), ("jpeg_idct_color", rgb, rgb_p)):
        if not torch.equal(got.cpu(), want):
            fail(f"{name}: the kernel differs from its plain version in {(got.cpu() != want).sum().item()} values")
        err[name] = float((got.cpu().int() - want.int()).abs().max())
    before = {k: w.launches for k, w in image_wrappers().items()}
    decoded = codec.decode_images([blobs[n] for n in names], dev)
    batch_launches = {k: w.launches - before[k] for k, w in image_wrappers().items()}
    jpeg_tiffs = [n for n in names if n.startswith("tiff_jpeg_")]
    if batch_launches["jpeg_idct_color"] != 1 or not jpeg_tiffs:
        fail(f"every fixture in one decode_images call: {batch_launches['jpeg_idct_color']} launches of the fused "
             f"K2 + K3, expected one for the JPEGs and the JPEG-in-TIFFs' chunks together")
    # the 300x300 resize of every decoded fixture through resize_batch (a launch a 128 images of mixed shapes)
    before_k4 = cuda_image.resize.launches
    batched = cuda_image.resize_batch(decoded, [(300, 300)] * len(decoded))
    k4_batch_launches = cuda_image.resize.launches - before_k4
    if k4_batch_launches != -(-len(decoded) // cuda_image.RESIZE_MAX_ITEMS):
        fail(f"resize_batch of {len(decoded)} fixtures took {k4_batch_launches} launches")
    resize_err, png_err, raw_err, seams = 0.0, 0, 0, 0
    for n, img in zip(names, decoded):
        e = images[n]
        host_img = img.cpu().numpy()
        if list(host_img.shape) != e["shape"] or sha(host_img) != e["rgb_sha256"]:
            fail(f"{n}: the decode on the card differs from cv2's recorded digest")
        small = cuda_image.resize(img, (300, 300))
        if sha(small.cpu().numpy()) != e["resize300_sha256"] or not torch.equal(small, batched[names.index(n)]):
            fail(f"{n}: the 300x300 linear resize on the card (alone, or in resize_batch) differs from cv2's "
                 f"recorded digest")
        resize_err = max(resize_err, float((small.cpu().int() - cuda_image.resize(img.cpu(), (300, 300)).int()).abs().max()))
        if "area_sha256" in e:
            fit = cuda_image.resize(img, e["area_shape"][:2], "area")
            if sha(fit.cpu().numpy()) != e["area_sha256"] or not torch.equal(
                    fit.cpu(), cuda_image.resize(img.cpu(), e["area_shape"][:2], "area")):
                fail(f"{n}: the INTER_AREA fit on the card differs from cv2's digest or the plain version")
        if n.endswith(".png"):
            png = codec.parse_png(blobs[n])
            got, want = cuda_image.decode_png(png, dev).cpu(), cuda_image.decode_png(png, cpu)
            if not torch.equal(got, want):
                fail(f"{n}: the PNG kernel differs from its plain version")
            png_err = max(png_err, int((got.int() - want.int()).abs().max()))
        if n.endswith(".gif"):
            gif = codec.parse_gif(blobs[n])
            got = cuda_image.decode_raw_batch([gif], [], [], dev)[0].cpu()
            want = cuda_image.decode_raw_batch([gif], [], [], cpu)[0]
            if not torch.equal(got, want):
                fail(f"{n}: the GIF kernels (K9, K8) differ from their plain versions")
            raw_err = max(raw_err, int((got.int() - want.int()).abs().max()))
        if n.endswith(".tif"):
            tif = codec.parse_tiff(blobs[n])
            got = decode_tiff(codec, cuda_image, tif, dev).cpu()
            want = decode_tiff(codec, cuda_image, tif, cpu)
            if not torch.equal(got, want):
                fail(f"{n}: the TIFF kernels (K1 + K2 + K3 for JPEG chunks, K9, K10, K8) differ from their plain "
                     f"versions")
            raw_err = max(raw_err, int((got.int() - want.int()).abs().max()))
        if not n.endswith((".png", ".jpg", ".gif", ".tif")):
            raw = codec.parse_raw(blobs[n], codec.image_kind(blobs[n]))
            got, want = cuda_image.decode_raw(raw, dev).cpu(), cuda_image.decode_raw(raw, cpu)
            if not torch.equal(got, want):
                fail(f"{n}: the raw image kernel differs from its plain version")
            raw_err = max(raw_err, int((got.int() - want.int()).abs().max()))
        seams += n.startswith(("seam_", "restart", "exif", "progressive_w", "progressive_h"))
    rng = np.random.default_rng(5)
    for shape in ((480, 640), (72, 96), (1, 9), (333, 500)):  # the host-augmented feed's float resize
        f = torch.from_numpy(rng.random(shape + (3,), dtype=np.float32))
        got, want = cuda_image.resize(f.to(dev), (300, 300)).cpu(), cuda_image.resize(f, (300, 300))
        if not torch.equal(got, want):
            fail(f"float32 linear resize {shape}: the kernel differs from its plain version")
    err["resize"] = resize_err
    # K5 on every PNG fixture in one call, K9 on every GIF fixture in one launch
    pngs = [codec.parse_png(blobs[n]) for n in names if n.endswith(".png")]
    for (n, got), want in zip(zip([n for n in names if n.endswith(".png")], cuda_image.decode_png_batch(pngs, dev)),
                              cuda_image.decode_png_batch(pngs, cpu)):
        if not torch.equal(got.cpu(), want):
            fail(f"{n}: the PNG kernel on every PNG fixture in one call differs from its plain version")
    gifs = []
    for n in sorted(list(names) + list(record["invalid"])):
        if n.endswith(".gif"):
            try:
                gifs.append(codec.parse_gif(open(os.path.join(fixtures, n), "rb").read()))
            except ValueError:  # refused before its LZW data is read
                pass
    # every GIF fixture and every TIFF fixture's LZW chunks in one K9 launch, every TIFF chunk with a
    # predictor or a swap in one K10 launch, then every GIF, TIFF and raw fixture in one K8 launch
    tiffs = [codec.parse_tiff(blobs[n]) for n in names if n.endswith(".tif")]
    raw_names = [n for n in names if not n.endswith((".jpg", ".png", ".gif", ".tif"))]
    raw_batch = codec.raw_batch(gifs, tiffs, [codec.parse_raw(blobs[n], codec.image_kind(blobs[n]))
                                             for n in raw_names])
    gif_host = raw_batch.lzw
    buf, want_buf = cuda_image.upload(raw_batch, dev), cuda_image.upload(raw_batch, cpu)
    indices, gif_status = cuda_image.lzw_decode(gif_host.to(dev), out=buf[raw_batch.lzw_at:])
    want_indices, want_status = cuda_image.lzw_decode(gif_host, out=want_buf[raw_batch.lzw_at:])
    if not torch.equal(gif_status.cpu(), want_status):
        fail(f"the LZW kernel's status on the GIF fixtures and TIFF LZW chunks {gif_status.cpu().tolist()} differs "
             f"from its plain version's {want_status.tolist()}")
    def max_diff(a, b) -> int:
        return int((a.cpu().int() - b.int()).abs().max()) if b.numel() else 0

    lzw_err = 0
    for row, st in zip(gif_host.gifs.tolist()[:len(gifs)], want_status.tolist()):
        span = slice(row[6], row[6] + row[3] * row[4])
        if st == codec.GIF_OK:
            if not torch.equal(indices[span].cpu(), want_indices[span]):
                fail("the LZW kernel's indices on a GIF fixture differ from its plain version's")
            lzw_err = max(lzw_err, max_diff(indices[span], want_indices[span]))
    tiff_region = slice(gif_host.frame_indices, gif_host.total_indices)
    if not torch.equal(indices[tiff_region].cpu(), want_indices[tiff_region]):
        fail("the LZW kernel's TIFF flavour on the TIFF fixtures' LZW chunks differs from its plain version")
    lzw_err = max(lzw_err, max_diff(indices[tiff_region], want_indices[tiff_region]))
    # every TIFF fixture's CCITT and ThunderScan chunks in one K11 launch
    launched11 = cuda_image.ccitt_decode.launches
    cuda_image.ccitt_decode(buf, raw_batch)
    cuda_image.ccitt_decode(want_buf, raw_batch)
    fax_region = slice(raw_batch.fax_out, raw_batch.fax_out + raw_batch.fax_bytes)
    if cuda_image.ccitt_decode.launches != launched11 + 1 or raw_batch.faxes == 0:
        fail(f"K11 over every TIFF fixture's {raw_batch.faxes} CCITT and ThunderScan chunks: not one launch")
    if not torch.equal(buf[fax_region].cpu(), want_buf[fax_region]):
        fail("the CCITT and ThunderScan kernel on every TIFF fixture's chunks in one launch differs from its plain "
             "version")
    err["ccitt_decode"] = float(max_diff(buf[fax_region], want_buf[fax_region]))
    # every TIFF fixture's SGILog chunks in one K12 launch
    launched12 = cuda_image.sgilog_decode.launches
    cuda_image.sgilog_decode(buf, raw_batch)
    cuda_image.sgilog_decode(want_buf, raw_batch)
    sgi_region = slice(raw_batch.sgi_out, raw_batch.total)
    if cuda_image.sgilog_decode.launches != launched12 + 1 or raw_batch.sgis == 0:
        fail(f"K12 over every TIFF fixture's {raw_batch.sgis} SGILog chunks: not one launch")
    if not torch.equal(buf[sgi_region].cpu(), want_buf[sgi_region]):
        fail("the SGILog kernel on every TIFF fixture's chunks in one launch differs from its plain version")
    err["sgilog_decode"] = float(max_diff(buf[sgi_region], want_buf[sgi_region]))
    tiff_status = want_status[len(gifs):]
    launched = (cuda_image.tiff_assemble.launches, cuda_image.raw_expand.launches)
    cuda_image.tiff_assemble(buf, raw_batch, gif_status)
    cuda_image.tiff_assemble(want_buf, raw_batch, want_status)
    chunk_bytes = [slice(0, raw_batch.host.size), slice(raw_batch.lzw_at + gif_host.frame_indices, raw_batch.total)]
    if not all(torch.equal(buf[r].cpu(), want_buf[r]) for r in chunk_bytes):  # the host's bytes and K9's TIFF chunks
        fail("the TIFF predictor kernel on every TIFF fixture's chunks in one launch differs from its plain version")
    err["tiff_assemble"] = float(max(max_diff(buf[r], want_buf[r]) for r in chunk_bytes))
    chunk_jpegs = codec.jpeg_batch(codec.tiff_jpeg_chunks(tiffs))
    chunk_dev = chunk_jpegs.to(dev)
    chunk_pixels = cuda_image.idct_color(cuda_image.decode_entropy(chunk_dev)[0], chunk_dev)
    expanded = cuda_image.raw_expand(buf, raw_batch, chunk_pixels)
    want_expanded = cuda_image.raw_expand(want_buf, raw_batch, chunk_pixels.cpu())
    if (cuda_image.tiff_assemble.launches, cuda_image.raw_expand.launches) != (launched[0] + 1, launched[1] + 1):
        fail("K10 and K8 over every GIF, TIFF and raw fixture: not one launch each")
    spans = [slice(at, at + h * w * 3) for i, (at, h, w) in enumerate(raw_batch.out)  # each image's RGB (padding
             if i >= len(gifs) or want_status[i] == codec.GIF_OK]  # between; a failed GIF frame's indices unspecified)
    if not all(torch.equal(expanded[r].cpu(), want_expanded[r]) for r in spans):
        fail("the raw image kernel on every GIF, TIFF and raw fixture in one launch differs from its plain version")
    raw_err = max([raw_err] + [max_diff(expanded[r], want_expanded[r]) for r in spans])
    if (batch_launches["raw_expand"] != 1 or batch_launches["tiff_assemble"] != 1 or batch_launches["lzw_decode"] != 1
            or batch_launches["ccitt_decode"] != 1 or batch_launches["sgilog_decode"] != 1):
        fail(f"every fixture in one decode_images call: launches {batch_launches}, expected one K9, one K11, one "
             f"K12, one K10 and one K8")
    err["png_unfilter_expand"] = float(png_err)
    err["raw_expand"] = float(raw_err)
    err["lzw_decode"] = float(lzw_err)
    for n in sorted(record["invalid"]):
        try:
            codec.decode_image(open(os.path.join(fixtures, n), "rb").read(), dev)
            fail(f"{n} decoded on the card; cv2 returns None for it")
        except ValueError:
            pass
    for name, text in REFUSED.items():
        try:
            codec.decode_image(open(os.path.join(fixtures, name), "rb").read(), dev)
            fail(f"{name} decoded; it must raise UnsupportedImage")
        except codec.UnsupportedImage as e:
            if text not in str(e):
                fail(f"{name}: the refusal does not name {text!r}: {e}")
    main_jpeg = blobs["coco_640x480_420.jpg"]
    try:
        codec.decode_image(main_jpeg[:len(main_jpeg) // 2], dev)
        fail("a JPEG cut with no marker after the cut decoded; cv2 returns None for it")
    except ValueError:
        pass
    kinds = sum(n.startswith(("progressive", "cmyk", "ycck", "sampling", "coco_640x480_p", "coco_640x427",
                              "coco_500x333_c")) for n in jpegs)
    corrupt = sum(n.startswith(("corrupt_", "progressive_cut", "progressive_dc_only", "progressive_incomplete",
                                "progressive_restart_dc", "progressive_restart_refine")) for n in jpegs)
    raws = [n for n in names if not n.endswith((".jpg", ".png", ".gif", ".tif"))]
    gif_statuses = sorted(collections.Counter(want_status[:len(gifs)].tolist()).items())
    print(f"image kernels: {len(gifs)} GIF fixtures and {len(tiff_status)} LZW chunks of {len(tiffs)} TIFF fixtures "
          f"through K9 in one launch (GIF statuses {gif_statuses}, TIFF chunk statuses "
          f"{sorted(collections.Counter(tiff_status.tolist()).items())}), {raw_batch.works} of the TIFFs' "
          f"{raw_batch.chunks.shape[0]} chunks ({raw_batch.k10_rows} rows) through K10 in one launch, "
          f"{raw_batch.faxes} CCITT and ThunderScan chunks through K11 in one launch, {raw_batch.sgis} SGILog "
          f"chunks through K12 in one launch, "
          f"{raw_batch.images} GIF, TIFF and raw fixtures through K8 in one launch ({raw_batch.tiles} CTAs), "
          f"{len(pngs)} PNG fixtures through K5 in one call, {len(record['invalid'])} fixtures cv2 returns None for "
          f"raising ValueError")
    print(f"image kernels: {len(names)} fixtures ({len(jpegs)} JPEGs in one batch, {kinds} of them progressive, "
          f"CMYK, YCCK or sampled 4:1:1 to 4x1 over 2x1, {corrupt} corrupt or smoothed ({warnings} libjpeg "
          f"warnings counted), {seams} seams: widths and heights 1-33, restart intervals of 1 MCU and past the "
          f"image, Exif orientations 1-8; {len(raws)} BMP, PxM, PAM, Sun raster, PFM and HDR) equal to cv2's "
          f"digests (cv2 {record['cv2']}, {record['libjpeg_turbo']}); K1, K6, K7, K2 + K3 equal to the plain versions "
          f"stage "
          f"by stage (K1's rounds on the fixture batch: max {int(fixture_rounds.max())}, mean "
          f"{float(fixture_rounds[fixture_rounds > 0].float().mean()):.2f} over "
          f"{int((fixture_rounds > 0).sum())} segments; subsequences its repair decoded one after another: "
          f"max {int(fixture_walked.max())} a segment, {int(fixture_walked.sum())} in all), K4 (uint8 linear, "
          f"float32 linear, area), K5, K9, K11, K12, K10 and K8 equal to theirs ({len(tiffs)} TIFFs and BigTIFFs among the "
          f"fixtures, {len(jpeg_tiffs)} JPEG-in-TIFFs whose chunks went through K1 and the fused K2 + K3 in the "
          f"JPEGs' launches: decode_images of every fixture launched {batch_launches}; their 300x300 resizes in "
          f"{k4_batch_launches} resize_batch launches equal one resize each); {len(REFUSED)} fixtures refused "
          f"({', '.join(sorted(REFUSED.values()))}); a JPEG cut with no marker after the cut raises ValueError")

    # ---- timing at the main path's shapes ---------------------------------------------
    batch_blobs = [main_jpeg] * 32
    prog_blob = blobs["coco_640x480_progressive.jpg"]
    start, end = fx.entropy_span(prog_blob, 4)
    smooth_blob = prog_blob[:start + (end - start) // 2] + b"\xff\xd9"  # cut in scan 4: libjpeg smooths
    prep_host = codec.jpeg_batch([codec.parse_jpeg(b) for b in batch_blobs])
    prep = prep_host.to(dev)
    one_host = codec.jpeg_batch([codec.parse_jpeg(main_jpeg)])
    one_dev = one_host.to(dev)
    prog_host = codec.jpeg_batch([codec.parse_jpeg(prog_blob)] * 32)
    prog_dev = prog_host.to(dev)
    smooth_host = codec.jpeg_batch([codec.parse_jpeg(smooth_blob)] * 32)
    smooth_dev = smooth_host.to(dev)
    if not smooth_host.smooth.shape[0] or smooth_host.steps != 1 or prog_host.steps != 1:
        fail("timing batches: the cut progressive JPEG is not smoothed, or a batch takes more than one step")
    sync32 = torch.zeros((prep_host.segments.shape[0], 2), dtype=torch.int32, device=dev)
    sync1 = torch.zeros((one_host.segments.shape[0], 2), dtype=torch.int32, device=dev)
    coef, _, _ = cuda_image.entropy_decode(prep, None, 0, sync32)
    cuda_image.entropy_decode(one_dev, None, 0, sync1)
    sync32, sync1 = sync32.cpu(), sync1.cpu()
    one = codec.decode_image(main_jpeg, dev)
    rgb16 = np.ascontiguousarray(one.cpu().numpy())
    png_blob = encode_png(rgb16, 2, 8)  # 640x480 RGB, the five filters in turn (no cv2 here)
    png = codec.parse_png(png_blob)
    png1_host, png32_host = codec.png_batch([png]), codec.png_batch([png] * 32)
    png1, png32 = png1_host.to(dev), png32_host.to(dev)
    gif = codec.parse_gif(gif_640x480(np, fx, rgb16))
    gif1_host, gif32_host = codec.gif_batch([gif]), codec.gif_batch([gif] * 32)
    gif1, gif32 = gif1_host.to(dev), gif32_host.to(dev)
    bmp_blob = fx.bmp(rgb16[..., ::-1], 24)  # the same pixels as a 640x480 24-bit BMP, rows bottom-up
    raw = codec.parse_raw(bmp_blob, "bmp")
    # the 640x480 LZW TIFF (cv2's writer: strips of about 8 KB, the predictor): K9's TIFF flavour, then K10, K8
    tif = codec.parse_tiff(blobs["tiff_cv2_640x480.tif"])

    def expand_inputs(raws, tiffs, device):  # a decode call's batch, its buffer after K9, and K9's status
        batch = codec.raw_batch([], tiffs, raws)
        buf = cuda_image.upload(batch, device)
        status = None
        if batch.lzw.gifs.shape[0]:
            status = cuda_image.lzw_decode(batch.lzw.to(device) if device.type == "cuda" else batch.lzw,
                                           out=buf[batch.lzw_at:])[1]
        return batch, buf, status

    bmp1, bmp1_h, bmp32 = expand_inputs([raw], [], dev), expand_inputs([raw], [], cpu), expand_inputs([raw] * 32, [], dev)
    tif1, tif1_h, tif32 = expand_inputs([], [tif], dev), expand_inputs([], [tif], cpu), expand_inputs([], [tif] * 32, dev)
    tif_timed = tif1[1].clone()
    tif_lzw_host = tif1[0].lzw
    tif_lzw = tif_lzw_host.to(dev)
    tif_zero = torch.zeros(tif_lzw_host.total_indices, dtype=torch.uint8, device=dev)
    # K11 on the 1728x2200 Group 4 fax page, and 32 of them in one launch
    page = codec.parse_tiff(blobs["tiff_ccitt_g4_page_1728x2200.tif"])
    page1, page1_h, page32 = expand_inputs([], [page], dev), expand_inputs([], [page], cpu), \
        expand_inputs([], [page] * 32, dev)
    # K12 on a 640x480 LogLuv TIFF of 16-row strips (the same pixels as XYZ, encoded here)
    sgi_tif = codec.parse_tiff(sgilog_640x480(np, fx, rgb16))
    sgi1, sgi1_h = expand_inputs([], [sgi_tif], dev), expand_inputs([], [sgi_tif], cpu)
    # K6 and K7 from the coefficients the kernels before them leave
    prog_first = cuda_image.entropy_decode(prog_dev)
    prog_first_host = cuda_image.entropy_decode(prog_host)
    smooth_in = cuda_image.progressive_entropy(smooth_dev, cuda_image.entropy_decode(smooth_dev))
    smooth_in_host = cuda_image.progressive_entropy(smooth_host, cuda_image.entropy_decode(smooth_host))
    for got, want in zip(prog_first + smooth_in, prog_first_host + smooth_in_host):
        if not torch.equal(got.cpu(), want):
            fail("the progressive timing batches' K1 and K6 outputs differ from the plain versions'")

    def fresh(tensors):
        return tuple(t.clone() for t in tensors)

    calls = {
        "jpeg_entropy_decode": lambda: cuda_image.entropy_decode(prep),
        "jpeg_idct_color": lambda: cuda_image.idct_color(coef, prep),
        "resize": lambda: cuda_image.resize(one, (300, 300)),
        "png_unfilter_expand": lambda: cuda_image.png_decode(png1),
        "progressive_entropy": lambda: cuda_image.progressive_entropy(prog_dev, fresh(prog_first)),
        "block_smooth": lambda: cuda_image.block_smooth(smooth_dev, fresh(smooth_in)[0], smooth_in[2]),
        "raw_expand": lambda: cuda_image.raw_expand(bmp1[1], bmp1[0]),
        "lzw_decode": lambda: cuda_image.lzw_decode(gif1),
        # in place, again at every call on a copy kept for the timing: the same work
        "tiff_assemble": lambda: cuda_image.tiff_assemble(tif_timed, tif1[0], tif1[2]),
        # into the zeroed output again at every call (it sets the same bits): the same work
        "ccitt_decode": lambda: cuda_image.ccitt_decode(page1[1], page1[0]),
        # into the zeroed output again at every call (it writes the same words): the same work
        "sgilog_decode": lambda: cuda_image.sgilog_decode(sgi1[1], sgi1[0]),
    }
    fresh_calls = {"tiff_assemble": lambda: cuda_image.tiff_assemble(tif1[1].clone(), tif1[0], tif1[2])}
    clone_ms = {"progressive_entropy": lambda: fresh(prog_first), "block_smooth": lambda: fresh(smooth_in)[0]}
    coef_h = coef.cpu()
    one_h = one.cpu()
    plain = {
        "jpeg_entropy_decode": lambda: cuda_image.entropy_decode(prep_host),
        "jpeg_idct_color": lambda: cuda_image.idct_color(coef_h, prep_host),
        "resize": lambda: cuda_image.resize(one_h, (300, 300)),
        "png_unfilter_expand": lambda: cuda_image.png_decode(png1_host),
        "progressive_entropy": lambda: cuda_image.progressive_entropy(prog_host, fresh(prog_first_host)),
        "block_smooth": lambda: cuda_image.block_smooth(smooth_host, fresh(smooth_in_host)[0], smooth_in_host[2]),
        "raw_expand": lambda: cuda_image.raw_expand(bmp1_h[1], bmp1_h[0]),
        "lzw_decode": lambda: cuda_image.lzw_decode(gif1_host),
        "tiff_assemble": lambda: cuda_image.tiff_assemble(tif1_h[1].clone(), tif1_h[0], tif1_h[2]),
        "ccitt_decode": lambda: cuda_image.ccitt_decode(page1_h[1].clone(), page1_h[0]),
        "sgilog_decode": lambda: cuda_image.sgilog_decode(sgi1_h[1].clone(), sgi1_h[0]),
    }

    def equal(got, want) -> bool:  # a kernel's output (tensor or tuple of them) against the plain one
        if isinstance(want, tuple):
            return all(equal(g, w) for g, w in zip(got, want))
        return torch.equal(got.cpu(), want)

    blocks = prep_host.total_blocks
    entropy_bytes = int(prep_host.segments[:, 1].sum()) // 8
    refine_bytes, refined_blocks = cuda_image.refinement_work(prog_host)
    bound_bytes = {
        "jpeg_entropy_decode": cuda_image.bound_bytes("entropy", entropy_bytes=entropy_bytes, blocks=blocks),
        "jpeg_idct_color": cuda_image.bound_bytes("idct_color", blocks=blocks, pixels=prep_host.total_pixels),
        "resize": cuda_image.bound_bytes("resize", in_bytes=one.numel(), out_bytes=300 * 300 * 3),
        "png_unfilter_expand": cuda_image.bound_bytes("png", inflated=len(png.inflated), pixels=480 * 640),
        "progressive_entropy": cuda_image.bound_bytes("progressive_entropy", entropy_bytes=refine_bytes,
                                                      blocks=refined_blocks),
        "block_smooth": cuda_image.bound_bytes("block_smooth", blocks=smooth_host.smooth_blocks),
        "raw_expand": cuda_image.bound_bytes("raw_expand", in_bytes=len(raw.data), pixels=480 * 640),
        "lzw_decode": cuda_image.bound_bytes("lzw", in_bytes=len(gif.lzw), pixels=480 * 640),
        "tiff_assemble": cuda_image.bound_bytes("tiff_assemble", chunk_bytes=sum(c.placed_rows * c.row_bytes
                                                                                 for c in tif.chunks)),
        "ccitt_decode": cuda_image.bound_bytes("ccitt", in_bytes=sum(len(c.raw) for c in page.chunks),
                                               out_bytes=sum(c.size for c in page.chunks)),
        "sgilog_decode": cuda_image.bound_bytes("sgilog", in_bytes=sum(len(c.raw) for c in sgi_tif.chunks),
                                                out_bytes=sum(c.size for c in sgi_tif.chunks)),
    }
    bound_ops = {"jpeg_idct_color": blocks * IDCT_OPS_PER_BLOCK + prep_host.total_pixels * COLOR_OPS_PER_PIXEL}
    shapes = {"jpeg_entropy_decode": f"32 x 640x480 4:2:0 ({entropy_bytes} entropy bytes, {blocks} blocks)",
              "jpeg_idct_color": f"32 x 640x480 4:2:0, {blocks} blocks -> RGB, {prep_host.tiles.shape[0]} tiles",
              "resize": "640x480x3 uint8 -> 300x300 linear", "png_unfilter_expand": "one 640x480 RGB PNG",
              "progressive_entropy": f"the 5 refinement scans of 32 x 640x480 progressive 4:2:0 ({refine_bytes} "
                                     f"entropy bytes, {refined_blocks} blocks refined, {len(prog_host.k6_rounds)} "
                                     f"rounds)",
              "block_smooth": f"32 x 640x480 progressive cut in scan 4 ({smooth_host.smooth_blocks} blocks)",
              "raw_expand": "one 640x480 24-bit BMP",
              "lzw_decode": f"one 640x480 GIF ({len(gif.lzw)} LZW bytes, min code size {gif.min_code_size})",
              "tiff_assemble": f"cv2's 640x480 LZW TIFF after K9, {len(tif.chunks)} strips of {tif.chunks[0].rows} "
                               f"rows (the predictor undone in place, a warp a row)",
              "ccitt_decode": f"the 1728x2200 Group 4 fax page ({sum(len(c.raw) for c in page.chunks)} coded bytes, "
                              f"{len(page.chunks)} strips), a CTA a strip",
              "sgilog_decode": f"a 640x480 LogLuv SGILog TIFF ({sum(len(c.raw) for c in sgi_tif.chunks)} coded bytes, "
                               f"{len(sgi_tif.chunks)} strips of 16 rows), a warp a strip"}
    out = {}
    for name, fn in calls.items():
        less = cuda_ms(torch, clone_ms[name], warmup=2, iters=10) if name in clone_ms else 0.0
        ms = cuda_ms(torch, fn, warmup=2, iters=10) - less
        b2b = stream_ms(torch, fn, warmup=1, iters=10) - less
        t = time.perf_counter()
        want = plain[name]()
        plain_ms = (time.perf_counter() - t) * 1e3
        if not equal(fresh_calls.get(name, fn)(), want):
            fail(f"{name}: the kernel at the timed shape differs from its plain version")
        del want
        bound = bound_bytes[name] / HBM_BYTES_PER_S * 1e3
        ops_bound = bound_ops.get(name, 0) / INT32_OPS_PER_S * 1e3
        by = "operations" if ops_bound > bound else "bytes"
        bound = max(bound, ops_bound)
        out[name] = {"max_abs_err": err[name], "ms": round(ms, 4), "plain_ms": round(plain_ms, 3),
                     "bound_ms": round(bound, 6), "bound_by": by, "library_ms": None}
        extra = "" if name not in clone_ms else f" (less {less:.4f} ms of cloning its input coefficients)"
        if name == "jpeg_entropy_decode":
            one_ms = cuda_ms(torch, lambda: cuda_image.entropy_decode(one_dev), warmup=2, iters=10)
            one_b2b = stream_ms(torch, lambda: cuda_image.entropy_decode(one_dev), warmup=1, iters=10)
            if not equal(cuda_image.entropy_decode(one_dev), cuda_image.entropy_decode(one_host)):
                fail("jpeg_entropy_decode: the kernel on one image differs from its plain version")
            cmyk_host = codec.jpeg_batch([codec.parse_jpeg(blobs["coco_500x333_cmyk.jpg"])])
            cmyk_dev = cmyk_host.to(dev)
            cmyk_sync = torch.zeros((cmyk_host.segments.shape[0], 2), dtype=torch.int32, device=dev)
            if not equal(cuda_image.entropy_decode(cmyk_dev, None, 0, cmyk_sync), cuda_image.entropy_decode(cmyk_host)):
                fail("jpeg_entropy_decode: the kernel on the CMYK JPEG differs from its plain version")
            cmyk_ms = cuda_ms(torch, lambda: cuda_image.entropy_decode(cmyk_dev), warmup=2, iters=10)
            prog_k1_ms = cuda_ms(torch, lambda: cuda_image.entropy_decode(prog_dev), warmup=2, iters=10)
            extra = (f"; one image {one_ms:.4f} ms a call, {one_b2b:.4f} back to back; synchronisation rounds "
                     f"a segment: 32 images max {int(sync32[:, 0].max())} mean {float(sync32[:, 0].float().mean()):.2f}, "
                     f"one image {int(sync1[:, 0].max())}; subsequences the repair decoded one after another: "
                     f"32 images max {int(sync32[:, 1].max())} a segment, {int(sync32[:, 1].sum())} in all, one image "
                     f"{int(sync1[:, 1].sum())} ({codec.SUBSEQ_BITS}-bit subsequences, "
                     f"{int(prep_host.total_subseqs)} at 32 images); the 500x333 CMYK JPEG {cmyk_ms:.4f} ms a call, "
                     f"{int(cmyk_sync[:, 1].sum())} of its {int(cmyk_host.total_subseqs)} subsequences repaired one "
                     f"after another in {int(cmyk_sync[:, 0].max())} rounds; the first scans (DC first, AC first) of "
                     f"32 x 640x480 progressive {prog_k1_ms:.4f} ms a call; timed outputs equal the plain version's; "
                     f"the earlier one-thread-a-segment design took {OLD_K1_MS} ms a call at 32 images")
            out[name]["progressive_first_ms"] = prog_k1_ms
        if name == "resize":
            extra, library = resize_report(torch, np, cuda_image, dev, one, ms, b2b, bound, plain_ms)
            out[name]["library_ms"] = round(library, 4)
        if name == "png_unfilter_expand":
            ms32 = cuda_ms(torch, lambda: cuda_image.png_decode(png32), warmup=2, iters=10)
            if not equal(cuda_image.png_decode(png32), cuda_image.png_decode(png32_host)):
                fail("png_unfilter_expand: the kernel on 32 PNGs in one call differs from its plain version")
            png_prep = []
            for _ in range(7):
                t = time.perf_counter()
                codec.parse_png(png_blob)
                png_prep.append((time.perf_counter() - t) * 1e3)
            steps = 640 + 480 - 1
            extra = (f"; its critical path W + H - 1 = {steps} dependent pixel steps, {ms / steps * 1e6:.1f} ns a "
                     f"step; 32 PNGs in one call {ms32:.4f} ms (bound {32 * bound:.6f} ms, "
                     f"{32 * bound / ms32 * 100:.3f} % of it); the PNG's host prep (chunk CRCs, zlib, the "
                     f"filter-byte check) {statistics.median(png_prep):.3f} ms (median of 7) beside K5's {ms:.4f}; "
                     f"timed outputs equal the plain version's")
            out[name]["png32_ms"] = ms32
        if name == "lzw_decode":
            ms32 = cuda_ms(torch, lambda: cuda_image.lzw_decode(gif32), warmup=2, iters=10)
            if not equal(cuda_image.lzw_decode(gif32), cuda_image.lzw_decode(gif32_host)):
                fail("lzw_decode: the kernel on 32 GIFs in one launch differs from its plain version")
            extra = "; " + lzw_report(torch, cuda_image, gif_lzw_model, gif_valid, gif, gif1, ms, bound, card)
            extra += (f"; 32 GIFs in one launch {ms32:.4f} ms ({ms32 / ms:.3f} x one; bound {32 * bound:.6f} ms, "
                      f"{32 * bound / ms32 * 100:.3f} % of it)")
            solid = codec.parse_gif(blobs["gif_solid_640x480.gif"])
            solid_host = codec.gif_batch([solid])
            solid_dev = solid_host.to(dev)
            if not equal(cuda_image.lzw_decode(solid_dev), cuda_image.lzw_decode(solid_host)):
                fail("lzw_decode: the kernel on the solid 640x480 GIF differs from its plain version")
            solid_ms = cuda_ms(torch, lambda: cuda_image.lzw_decode(solid_dev), warmup=2, iters=10)
            extra += ("; the solid-colour 640x480 fixture (the longest strings) "
                      + lzw_report(torch, cuda_image, gif_lzw_model, gif_valid, solid, solid_dev, solid_ms, None, card)
                      + f"; the one-reading-thread K9 took {OLD_K9_MS} ms on the 640x480 GIF ({OLD_K9_MS / ms:.1f} x "
                      f"this); timed outputs equal the plain version's")
            out[name]["gif32_ms"] = ms32
        if name == "jpeg_idct_color":
            byte_ms = bound_bytes[name] / HBM_BYTES_PER_S * 1e3
            extra = (f"; bounds: bytes {byte_ms:.6f} ms, operations {ops_bound:.6f} ms ({bound_ops[name]} int32 "
                     f"operations, an estimate; {2 * ops_bound:.6f} ms at the INT32 pipe's 64 lanes alone); K2 + K3 "
                     f"took {OLD_K2_K3_MS} ms ({OLD_K2_K3_MS / ms:.2f} x this)")
            for label, blob_names in (("one 640x480 4:2:0 JPEG", ["coco_640x480_420.jpg"]),
                                      ("the 500x333 CMYK JPEG", ["coco_500x333_cmyk.jpg"]),
                                      ("the 500x333 4:4:4 JPEG", ["coco_500x333_444.jpg"]),
                                      ("the 480x640 Exif-6 JPEG", ["coco_480x640_exif6.jpg"])):
                some_host = codec.jpeg_batch([codec.parse_jpeg(blobs[b]) for b in blob_names])
                some = some_host.to(dev)
                some_coef = cuda_image.decode_entropy(some)[0]
                if not equal(cuda_image.idct_color(some_coef, some), cuda_image.idct_color(some_coef.cpu(), some_host)):
                    fail(f"jpeg_idct_color: the kernel on {label} differs from its plain version")
                rounds = [cuda_ms(torch, lambda: cuda_image.idct_color(some_coef, some), warmup=2, iters=10)
                          for _ in range(5)]
                some_ms = statistics.median(rounds)
                some_b2b = stream_ms(torch, lambda: cuda_image.idct_color(some_coef, some), warmup=1, iters=20)
                extra += (f"; {label} {some_ms:.4f} ms a call (median of 5 rounds' medians, {min(rounds):.4f}-"
                          f"{max(rounds):.4f}), {some_b2b:.4f} back to back ({some_b2b / some_host.total_pixels * 1e6:.3f}"
                          f" ns a pixel against {b2b / prep_host.total_pixels * 1e6:.3f} at 32 x 4:2:0)")
            extra += "; timed outputs equal the plain version's"
        if name == "raw_expand":
            extra = expand_report(torch, cuda_image, card, ms, b2b, bound, bmp1, bmp32, tif1, tif1_h, tif32,
                                  bound_bytes["tiff_assemble"], len(raw.data))
        if name == "tiff_assemble":
            lzw_tif_ms = cuda_ms(torch, lambda: cuda_image.lzw_decode(tif_lzw, out=tif_zero.clone()), warmup=2,
                                 iters=10) - cuda_ms(torch, lambda: tif_zero.clone(), warmup=2, iters=10)
            if not equal(cuda_image.lzw_decode(tif_lzw, out=tif_zero.clone()),
                         cuda_image.lzw_decode(tif_lzw_host, out=tif_zero.cpu())):
                fail("lzw_decode: the TIFF flavour on the 640x480 LZW TIFF differs from its plain version")
            tif_in = sum(len(c.raw) for c in tif.chunks)
            tif_out = sum(c.rows * c.row_bytes for c in tif.chunks)
            lzw_tif_bound = cuda_image.bound_bytes("lzw", in_bytes=tif_in, pixels=tif_out)
            lzw_tif_bound_ms = lzw_tif_bound / HBM_BYTES_PER_S * 1e3
            t = time.perf_counter()
            cuda_image.lzw_decode(tif_lzw_host, out=tif_zero.cpu())
            lzw_tif_plain = (time.perf_counter() - t) * 1e3
            host_ms = {}
            rgb_tif = rgb16  # 640x480 RGB
            for label, comp, pack in (("PackBits", 32773, fx.packbits), ("Deflate", 8, zlib.compress)):
                body = fx.tiff(fx.tiff_tags(640, 480, 8, 3, 2, comp), [pack(rgb_tif.tobytes())])
                runs = []
                for _ in range(7):
                    t = time.perf_counter()
                    codec.parse_tiff(body)
                    runs.append((time.perf_counter() - t) * 1e3)
                host_ms[label] = statistics.median(runs)
            extra = (f"; K9's TIFF flavour on its {len(tif.chunks)} strips in one launch ({tif_in} LZW bytes, "
                     f"{tif_out} bytes out) {lzw_tif_ms:.4f} ms a call (bound "
                     f"{lzw_tif_bound_ms:.6f} ms, {lzw_tif_bound_ms / lzw_tif_ms * 100:.3f} % of it; plain "
                     f"{lzw_tif_plain:.1f} ms); the host's parse of a 640x480 RGB TIFF, median of 7: PackBits "
                     f"{host_ms['PackBits']:.3f} ms, Deflate {host_ms['Deflate']:.3f} ms; timed outputs equal the "
                     f"plain versions'")
        if name == "block_smooth":
            extra += "; " + smooth_report(torch, np, codec, cuda_image, fx, dev, prog_blob, smooth_in, smooth_dev,
                                          card)
        if name == "ccitt_decode":
            extra = "; " + ccitt_report(torch, np, codec, cuda_image, dev, blobs, page, page1_h, page32, ms, bound,
                                        card)
        if name == "sgilog_decode":
            extra = "; " + sgilog_report(torch, codec, cuda_image, dev, raw_batch, tiffs, names, card)
        if name == "progressive_entropy":
            total_ms = out["jpeg_entropy_decode"]["progressive_first_ms"] + ms
            extra += (f"; the whole progressive entropy decode of 32 x 640x480 (K1's first scans + K6's "
                      f"refinements) {total_ms:.4f} ms, against {OLD_K6_MS} ms of the one-block-an-image K6 "
                      f"(a fifth of it: {OLD_K6_MS / 5:.2f}); timed output equals the plain version's")
        print(f"{name} [{card}]: {shapes[name]}: {ms:.4f} ms a call, {b2b:.4f} ms back to back, "
              f"bound {bound:.6f} ms ({bound_bytes[name]} bytes; {bound / ms * 100:.3f} % of it), "
              f"plain version {plain_ms:.1f} ms on the host{extra}")
    out["jpeg_entropy_decode"].pop("progressive_first_ms")
    out["png_unfilter_expand"].pop("png32_ms")
    out["lzw_decode"].pop("gif32_ms")
    scan_kind_report(torch, cuda_image, prog_dev, card, "32 x 640x480 progressive")

    def k1_passes(batch) -> str:  # K1's five kernels, from the records torch.profiler kept
        per = {}
        for ms, _, kname in device_kernels(torch, lambda: cuda_image.entropy_decode(batch)):
            for p in ("guess", "round2", "repair", "write", "dc"):
                if f"{p}_kernel" in kname:
                    per[p] = per.get(p, 0.0) + ms
        return ", ".join(f"{p} {per[p]:.4f}" for p in ("guess", "round2", "repair", "write", "dc") if p in per)

    def k6_passes() -> str:  # K6's three kernels over its rounds
        per = {}
        for ms, _, kname in device_kernels(torch, calls["progressive_entropy"]):
            for p in ("mask", "walk", "apply"):
                if f"{p}_kernel" in kname:
                    per[p] = per.get(p, 0.0) + ms
        return ", ".join(f"{p} {per[p]:.4f}" for p in ("mask", "walk", "apply") if p in per)

    print(f"jpeg_entropy_decode by pass [{card}] (ms, the kernel records torch.profiler kept): 32 images "
          f"{k1_passes(prep) or 'none recorded'}; one image {k1_passes(one_dev) or 'none recorded'}")
    print(f"progressive_entropy by pass [{card}] (ms, summed over its rounds): {k6_passes() or 'none recorded'}")
    # end to end: encoded 640x480 JPEGs -> resized 300x300 images on the card, by stage
    for label, some in (("32 640x480 JPEGs", batch_blobs), ("one 640x480 JPEG", [main_jpeg])):
        stages, staged_ms, e2e_ms = decode_stages_ms(torch, dev, codec, cuda_image, some)
        print(f"decode + resize of {label} [{card}], mean of 7 passes each way, in turns: by stage "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f" ms (sum {sum(stages.values()):.3f}; the staged pass {staged_ms:.3f} ms); unstaged "
              f"(codec.decode_images, then the resizes) {e2e_ms:.3f} ms = {len(some) / e2e_ms * 1e3:.1f} images/s")
    return out


SCAN_KINDS = ("DC first", "DC refine", "AC first", "AC refine")


def scan_kind(job) -> str:
    """The kind of a progressive scan from its job row (Ss at 28, Ah at 30)."""
    return SCAN_KINDS[2 * int(job[28] > 0) + int(job[30] > 0)]


def progressive_scan_ms(torch, cuda_image, batch, iters: int = 10) -> tuple:
    """The progressive entropy decode (K1 for the scans that first send coefficients,
    K6's rounds for the refinements) one scan at a time over a batch on the card: the
    j-th scan of every image alone, every other scan's segments given no MCUs (which no
    kernel decodes), from the coefficients the scans before it left, less the same call
    with every scan so masked (the launches alone). Returns ([(j, kind, ms)], the
    launches' ms)."""
    segs = batch.segments.cpu()
    jobs = batch.jobs.cpu()
    prog = batch.progressive.cpu().tolist()

    def masked(keep):
        s = segs.clone()
        for first, n in prog:
            for i in range(n):
                j = jobs[first + i]
                if not keep(i):
                    s[int(j[26]):int(j[26] + j[27]), 4] = 0
        return dataclasses.replace(batch, segments=s.to(batch.data.device))

    def decode(b, out):
        for step in range(b.steps):
            cuda_image.entropy_decode(b, out, step)
            cuda_image.progressive_entropy(b, out, step)

    def timed(b, before):
        return cuda_ms(torch, lambda: decode(b, tuple(t.clone() for t in before)), warmup=1, iters=iters)

    empty = masked(lambda x: False)
    zeros = cuda_image.entropy_outputs(batch)
    idle = timed(empty, zeros) - cuda_ms(torch, lambda: tuple(t.clone() for t in zeros), warmup=1, iters=iters)
    out = []
    for i in range(max(n for _, n in prog)):
        before = cuda_image.entropy_outputs(batch)
        decode(masked(lambda x: x < i), before)
        ms = timed(masked(lambda x: x == i), before) - timed(empty, before)
        out.append((i, scan_kind(jobs[prog[0][0] + i].tolist()), ms))
    return out, idle


def scan_kind_report(torch, cuda_image, batch, card: str, label: str) -> dict:
    """Print the progressive decode by scan and by kind; returns {kind: ms}."""
    rows, idle = progressive_scan_ms(torch, cuda_image, batch)
    kinds = {}
    for _, kind, ms in rows:
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print(f"progressive entropy decode by scan [{card}], {label} (ms, each less the {idle:.4f} ms of the "
          f"launches with no scan to decode): " + "; ".join(f"scan {i} ({kind}) {ms:.4f}" for i, kind, ms in rows))
    print(f"progressive entropy decode by scan kind [{card}], {label} (ms; DC first and AC first through K1, "
          f"the refinements through K6): " + ", ".join(f"{k} {v:.4f}" for k, v in kinds.items())
          + f"; sum {sum(kinds.values()):.4f}")
    return kinds


# what the JPEG root of phase 4e holds besides the COCO-sized JPEGs, under .jpg names
ROOT_EXTRAS = ("bmp_rle8_37x23.bmp", "pxm_p6_37x23.ppm", "ras_cmap8_37x23.ras", "corrupt_cut_eoi_500x333.jpg",
               "progressive_cut_eoi_83x61.jpg", "gif_cv2_100x80.gif", "hdr_cv2_rle_37x23.hdr",
               "pam_16bit_37x23.pam", "tiff_cv2_640x480.tif", "tiff_planar_37x23.tif",
               "tiff_bigtiff_lzw_be_37x23.tif", "tiff_pil_cmyk_deflate_37x23.tif", "tiff_jpeg_strips_420_67x45.tif",
               "tiff_ycbcr22_lzw_37x23.tif", "tiff_pil_lab_lzw_37x23.tif", "tiff_jpeg_pil_cmyk_37x23.tif",
               "tiff_ccitt_g3_2d_37x23.tif", "tiff_thunderscan_37x23.tif", "tiff_lzw_old_gray_37x23.tif",
               "tiff_sgilog_logluv_37x23.tif", "tiff_tiles_rgba_37x23.tif")
# a kind cv2 reads and the port refuses, put in place of an image of the root
ROOT_REFUSED = ("tiff_refused_ycbcr44_odd_units_33x17.tif", "no whole number of scanlines")
# and one the feed skips, as the JAX feed skips what cv2.imread returns None for
ROOT_SKIPPED = ("tiff_invalid_lzma_37x23.tif",)


def jpeg_coco_root(np, root: str, num_images: int = 64) -> dict:
    """A COCO-format train split of `num_images` fixture images (the seven COCO-sized
    JPEGs and ROOT_EXTRAS, in turn), then ROOT_SKIPPED, under distinct ids and .jpg
    names, each with 1-4 boxes; returns {image id: fixture name} of the first
    `num_images`."""
    from ssd_object_detection_tpu_torch.data.coco import COCO_NAMES

    fixtures, record = fixture_record()
    names = sorted(n for n, e in record["images"].items() if n.startswith("coco_")) + list(ROOT_EXTRAS)
    os.makedirs(os.path.join(root, "annotations"))
    os.makedirs(os.path.join(root, "train2017"))
    rng = np.random.default_rng(4)
    images, annotations, ids = [], [], {}
    for i in range(num_images + len(ROOT_SKIPPED)):
        name = names[i % len(names)] if i < num_images else ROOT_SKIPPED[i - num_images]
        h, w = record["images"][name]["shape"][:2] if name in record["images"] else (23, 37)
        image_id = 5000 + i
        if i < num_images:
            ids[image_id] = name
        shutil.copy(os.path.join(fixtures, name), os.path.join(root, "train2017", f"{image_id:012d}.jpg"))
        images.append({"id": image_id, "file_name": f"{image_id:012d}.jpg", "width": w, "height": h})
        for _ in range(int(rng.integers(1, 5))):
            bw, bh = rng.uniform(0.1, 0.5) * w, rng.uniform(0.1, 0.5) * h
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            annotations.append({"id": len(annotations) + 1, "image_id": image_id,
                                "category_id": int(rng.choice(COCO_SPARSE_IDS)),
                                "bbox": [round(x, 2), round(y, 2), round(bw, 2), round(bh, 2)],
                                "area": round(bw * bh, 2), "iscrowd": 0})
    with open(os.path.join(root, "annotations", "instances_train2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": n} for c, n in zip(COCO_SPARSE_IDS, COCO_NAMES)]}, f)
    return ids


def jpeg_train_phase(torch, np, dev, card: str, variant: str = "ssd300") -> tuple:
    """4e. A COCO-format root of 64 fixture images under .jpg names (baseline,
    progressive, CMYK and 4:1:1 JPEGs, a BMP, a PPM, a Sun raster, a corrupt JPEG, a
    smoothed progressive one, a GIF, an HDR, a PAM, four TIFFs, a YCbCr and a CIELab TIFF,
    a JPEG-in-TIFF and a CMYK one, a CCITT Group 3 2-D, a ThunderScan, an old-style LZW,
    an SGILog LogLuv and an uncompressed tiled TIFF) and an
    LZMA TIFF (cv2.imread returns None: the feed skips it): cli.train packs it on the card
    (pack_dataset through the decode feed, 8 worker threads, each on its own stream) and
    trains SSD300-VGG16 from the cache at batch 32, bf16, 2 steps; every packed image
    equals cv2's recorded 300x300 digest. Then the root with ROOT_REFUSED (a YCbCr TIFF of
    4 x 4 units that are no whole number of scanlines) in place of an image is refused
    naming it. Returns the image kernels' launches and the matcher's."""
    import yaml

    from ssd_object_detection_tpu_torch.cli import train as cli_train
    from ssd_object_detection_tpu_torch.data import codec
    from ssd_object_detection_tpu_torch.ops import cuda_image, cuda_matcher
    from ssd_object_detection_tpu_torch.tools.make_image_fixtures import sha

    _, record = fixture_record()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jpeg_") as root:
        ids = jpeg_coco_root(np, root)
        cache = os.path.join(root, "packed")
        cfg = production_config(root, cache, variant, 64, 32, epochs=1)
        cfg.model.warmup.enable = False
        path = os.path.join(root, "jpeg.yml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg.to_dict(), f)
        cuda_image.reset_launches()
        cuda_matcher.match_anchors_cuda.launches = 0
        t = time.time()
        trainer = cli_train.main([path, "--device", dev.type, "--run-dir", os.path.join(root, "run")])
        seconds = time.time() - t
        launches = {name: k.launches for name, k in image_wrappers().items()}
        matcher = cuda_matcher.match_anchors_cuda.launches
        loss = float(trainer.last_metrics["loss"])
        gt = np.load(os.path.join(cache, "gt.npz"))
        size = trainer.spec.image_size
        packed = np.fromfile(os.path.join(cache, "images.u8"), np.uint8).reshape(-1, size, size, 3)
        if packed.shape[0] != 64 or sorted(gt["image_id"].tolist()) != sorted(ids):
            fail(f"JPEG pack: {packed.shape[0]} images packed of 64")
        for image, image_id in zip(packed, gt["image_id"].tolist()):
            if size == 300 and sha(image) != record["images"][ids[image_id]]["resize300_sha256"]:
                fail(f"JPEG pack: image {image_id} ({ids[image_id]}) differs from cv2's 300x300 digest")
        if matcher != 2 or not math.isfinite(loss):
            fail(f"JPEG train: matcher launches {matcher} (2 steps), loss {loss}")
        # one decode an image: K1 (and K6 a refinement round, K7 where libjpeg smooths, with
        # its DC copy where a component's DCs may change) for a JPEG, K9 then K8 for a GIF,
        # K9 for a TIFF with LZW chunks, K11 for one with CCITT or ThunderScan chunks, K12 for
        # one with SGILog chunks, K10 for one with a chunk to predict or swap, K8 for every
        # image but a JPEG; one resize an image
        fixtures, _ = fixture_record()
        want = {"jpeg_entropy_decode": 0, "progressive_entropy": 0, "block_smooth": 0, "raw_expand": 0,
                "lzw_decode": 0, "tiff_assemble": 0, "jpeg_idct_color": 0, "ccitt_decode": 0, "sgilog_decode": 0}
        for i in ids:
            data = open(os.path.join(fixtures, ids[i]), "rb").read()
            kind = codec.image_kind(data)
            chunks = codec.tiff_jpeg_chunks([codec.parse_tiff(data)]) if kind == "tiff" else []
            if kind != "jpeg":
                want["raw_expand"] += 1
                want["lzw_decode"] += kind == "gif" or (kind == "tiff" and any(
                    c.decoded is None and c.jpeg is None and c.fax < 0 and not c.sgi for c in codec.parse_tiff(data).chunks))
                want["ccitt_decode"] += kind == "tiff" and any(c.fax >= 0 for c in codec.parse_tiff(data).chunks)
                want["sgilog_decode"] += kind == "tiff" and any(c.sgi > 0 for c in codec.parse_tiff(data).chunks)
                want["tiff_assemble"] += kind == "tiff" and codec.raw_batch([], [codec.parse_tiff(data)], []).works > 0
                if not chunks:
                    continue
            want["jpeg_idct_color"] += 1
            b = codec.jpeg_batch(chunks or [codec.parse_jpeg(data)])
            want["jpeg_entropy_decode"] += b.steps
            want["progressive_entropy"] += len(b.k6_rounds)
            want["block_smooth"] += (1 + int(b.smooth_dc > 0)) if b.smooth.shape[0] else 0
        if any(launches[k] != v for k, v in want.items()) or launches["resize"] != 64 or not all(want.values()):
            fail(f"JPEG pack: image kernel launches {launches}, expected {want} and one resize per image")
        kinds = sorted({ids[i] for i in ids})
        # ROOT_REFUSED in the root (cv2 reads it, the port refuses it): the feed raises naming the file
        from ssd_object_detection_tpu_torch.data import coco, packed as packed_mod

        victim = os.path.join(root, "train2017", f"{min(ids):012d}.jpg")
        shutil.copy(os.path.join(fixtures, ROOT_REFUSED[0]), victim)
        try:
            packed_mod.pack_dataset(coco.open_split(root, "train"), os.path.join(root, "packed_refused"),
                                    image_size=size, max_gt=8, num_workers=2, device=dev)
            fail(f"JPEG pack: a root holding {ROOT_REFUSED[0]} packed; the feed must refuse it")
        except codec.UnsupportedImage as e:
            if victim not in str(e) or ROOT_REFUSED[1] not in str(e):
                fail(f"JPEG pack: the refusal of {ROOT_REFUSED[0]} does not name the file and the kind: {e}")
        print(f"JPEG root [{card}]: 64 fixture images ({len(kinds)} kinds: {', '.join(kinds)}) packed on the card "
              f"by cli.train and trained from, SSD300-VGG16 bf16 batch 32, 2 steps, loss {loss:.4f}, matcher "
              f"launches {matcher}; every packed image equals cv2's 300x300 digest; image kernel launches "
              f"{launches}; "
              f"{seconds:.1f} s for pack + train; {', '.join(ROOT_SKIPPED)} in the root skipped; the root with "
              f"{ROOT_REFUSED[0]} in place of an image refused naming it")
    return launches, matcher


def http_phase(torch, np, dev, card: str, variant: str = "ssd300", tiers=(1, 8, 32)) -> dict:
    """7h. cli/serve.py::make_server on the card (SSD300-VGG16, random weights from seed
    0, bf16, canvas 640x640, tiers 1, 8, 32): every fixture body POSTed and answered as
    DetectorService.detect_images answers the decoder's pixels, those pixels equal to
    cv2's digests (progressive, CMYK, YCCK, 4:1:1, corrupt and smoothed JPEG bodies, GIF,
    TIFF, JPEG-in-TIFF, HDR, BMP, PxM, PAM, Sun raster and PFM bodies among them); the
    refused bodies (AVIF, uncompressed 4-sample tiles, YCbCr of odd 4 x 4 units, PAMs with alpha,
    a 1-channel PFM) 415 (CCITT, ThunderScan and old-style LZW TIFF bodies are
    answered), those cv2 returns None for (an LZMA TIFF, JPEG-in-TIFFs libtiff cannot start
    among them) and bytes that are no image 400; 32
    concurrent clients posting the 640x480 JPEG. Returns the image kernels' launches."""
    import urllib.error
    import urllib.request

    from ssd_object_detection_tpu_torch.cli import serve as cli_serve
    from ssd_object_detection_tpu_torch.cli.serve import make_server
    from ssd_object_detection_tpu_torch.data import codec
    from ssd_object_detection_tpu_torch.eval import serve
    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
    from ssd_object_detection_tpu_torch.ops import cuda_image
    from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
    from ssd_object_detection_tpu_torch.tools.make_image_fixtures import sha

    fixtures, record = fixture_record()
    spec = MODEL_SPECS[variant]
    model = SSD(num_classes=81, spec=spec, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    service = serve.DetectorService(model, generate_anchors(spec.anchor_spec), image_size=spec.image_size,
                                    batch_size=max(tiers), batch_tiers=tiers, canvas_hw=(640, 640),
                                    score_thresh=0.01)
    service.warm()
    server = make_server(service, {"model": variant}, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/detect"

    def post(body: bytes):
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"), timeout=120) as r:
            return json.loads(r.read())

    try:
        bodies = {n: open(os.path.join(fixtures, n), "rb").read() for n in sorted(record["images"])}
        answers = {}
        cuda_image.reset_launches()  # the path: the server's decodes alone
        for name, body in bodies.items():
            if "refused" in record["images"][name]:
                try:
                    post(body)
                    fail(f"HTTP: {name} was answered; it must get 415")
                except urllib.error.HTTPError as e:
                    if e.code != 415:
                        fail(f"HTTP: {name} got {e.code}, not 415")
            else:
                answers[name] = post(body)["detections"]
        for body in [b"not an image"] + [open(os.path.join(fixtures, n), "rb").read() for n in sorted(record["invalid"])]:
            try:
                post(body)
                fail("HTTP: bytes cv2 returns None for were answered; they must get 400")
            except urllib.error.HTTPError as e:
                if e.code != 400:
                    fail(f"HTTP: bytes cv2 returns None for got {e.code}, not 400")
        launches = {name: k.launches for name, k in image_wrappers().items()}
        for name, got in answers.items():
            pixels = codec.decode_image(bodies[name], dev).cpu().numpy()
            if sha(pixels) != record["images"][name]["rgb_sha256"]:
                fail(f"HTTP: the decoder's pixels of {name} differ from cv2's digest")
            if got != json.loads(json.dumps(service.detect_images([pixels])[0])):
                fail(f"HTTP: the answer to {name} differs from detect_images on its pixels")
        answered = len(answers)
        refused = len(bodies) - answered
        body = open(os.path.join(fixtures, "coco_640x480_420.jpg"), "rb").read()
        for _ in range(3):
            post(body)
        request_ms, decode_ms, submit_ms = [], [], []

        def timed(fn, into):  # the handler's two calls, timed inside the server
            def call(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    into.append((time.perf_counter() - t) * 1e3)
            return call

        def client(_):
            for _ in range(4):
                start = time.perf_counter()
                post(body)
                request_ms.append((time.perf_counter() - start) * 1e3)

        decode_bytes, submit = cli_serve.decode_image_bytes, server.frontend.submit
        cli_serve.decode_image_bytes = timed(decode_bytes, decode_ms)
        server.frontend.submit = timed(submit, submit_ms)
        try:
            start = time.perf_counter()
            with ThreadPoolExecutor(32) as pool:
                list(pool.map(client, range(32)))
            wall = time.perf_counter() - start
        finally:
            cli_serve.decode_image_bytes = decode_bytes
            del server.frontend.submit
        mean = {k: float(np.mean(v)) for k, v in (("request", request_ms), ("decode", decode_ms),
                                                   ("submit", submit_ms))}
        print(f"HTTP on the card [{card}]: {answered} fixture bodies (JPEG, PNG, GIF, TIFF, BMP, PxM, PAM, Sun raster, "
              f"PFM, HDR) "
              f"answered as detect_images answers their decoded pixels, which equal cv2's digests; the {refused} "
              f"refused bodies 415, the {len(record['invalid'])} bodies cv2 returns None for and bytes that are no "
              f"image 400; image kernel launches {launches}; 32 clients x 4 "
              f"posts of the 640x480 JPEG: {128 / wall:.1f} img/s, p50 {np.percentile(request_ms, 50):.2f} ms, "
              f"p99 {np.percentile(request_ms, 99):.2f} ms; a request's mean {mean['request']:.2f} ms = the "
              f"handler's decode_image_bytes (parse, layout, upload, K1-K3, pixels back to the host) "
              f"{mean['decode']:.2f} (p50 {np.percentile(decode_ms, 50):.2f}) + the batching front end and "
              f"the detect path {mean['submit']:.2f} (p50 {np.percentile(submit_ms, 50):.2f}) + the rest "
              f"(HTTP, JSON, the client) {mean['request'] - mean['decode'] - mean['submit']:.2f}")
    finally:
        server.shutdown()
        server.server_close()
        server.frontend.close()
        thread.join(timeout=60)
    del service, model
    torch.cuda.empty_cache()
    return launches


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
        if s["split_l2"][1] > 0.05 * p_half:  # measured on the H100: 0.06 % and 0.19 % of it
            fail(f"phase 3d step {s['step']}: the grid is {s['split_l2'][1]} from one process running "
                 f"its arithmetic, more than 5 % of the halves' distance from one process ({p_half})")
        print(f"phase 3d float32 step {s['step']} (TF32 off, deterministic): num_positive {dp:.0f} = "
              f"one process; loss (2, 2) grid {l_dp:.7f}, one process {l_full:.7f}, as two halves "
              f"{l_half:.7f}; unsharded param L2 distance to one process: grid {p_dp:.3e}, halves "
              f"{p_half:.3e} (the step moved them {moved:.3e}); one process as halves with the "
              f"column-parallel convs as two halves of their channels (the grid's arithmetic): loss "
              f"{l_split:.7f}, distance to one process {s['split_l2'][0]:.3e}, the grid's distance "
              f"to it {s['split_l2'][1]:.3e} ({100 * s['split_l2'][1] / p_half:.2f} % of the halves' "
              f"distance; bound 5 %)")
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


def bench_tools_phase(torch, dev, card: str, bare_step_ms: float, variant: str = "ssd300",
                      iters: int = 30, sweep_iters: int = 20, batches: str = "32,64,128") -> tuple:
    """7e. tools/benchmark.py at SSD300 (its five entries, 3 rounds), its train_step_b32
    median within 0.5x-2x of phase 3's and train_accum_8x at 8 matcher launches a step;
    then tools/sweep_infer.py --fused --ptq at batches 32, 64, 128. Returns (matcher
    launches, int8 launches)."""
    from ssd_object_detection_tpu_torch.ops import cuda_int8, cuda_matcher
    from ssd_object_detection_tpu_torch.tools import benchmark, sweep_infer

    rounds, where = 3, ["--variant", variant, "--device", dev.type]
    cuda_matcher.match_anchors_cuda.launches = 0
    r = benchmark.main(["--rounds", str(rounds), "--iters", str(iters), *where])
    launches = cuda_matcher.match_anchors_cuda.launches
    steps = benchmark.train_steps_per_entry(iters, rounds)
    if launches != (1 + 8) * steps:
        fail(f"tools.benchmark: {launches} matcher launches for {steps} steps of train_step_b32 (1 a "
             f"step) and of train_accum_8x (8 a step): expected {9 * steps}")
    b32 = r["train_step_b32"]["ms_per_step"]
    if not 0.5 * bare_step_ms <= b32 <= 2 * bare_step_ms:
        fail(f"tools.benchmark train_step_b32 {b32} ms against phase 3's {bare_step_ms:.2f} ms: "
             "outside 0.5x-2x, so it times another window")
    entries = [(n, "ms_per_batch") for n in ("infer_b1", "infer_b32", "infer_fused_e2e_b32")] \
        + [(n, "ms_per_step") for n in ("train_step_b32", "train_accum_8x")]
    print(f"phase 7e tools.benchmark {variant} bf16 [{card}], median of {rounds} rounds (min-max): "
          + "; ".join(f"{name} {r[name][key]} ({r[name][key + '_min']}-{r[name][key + '_max']}) ms, "
                      f"{r[name]['images_per_sec']} img/s" for name, key in entries)
          + f"; train_step_b32 against phase 3's {bare_step_ms:.2f} ms: {b32 / bare_step_ms:.2f}x; "
          f"matcher launches {launches} = {steps} steps x (1 + 8)")
    cuda_int8.int8_conv_cuda.launches = 0
    points = sweep_infer.main(["--fused", "--ptq", "--rounds", str(rounds), "--iters", str(sweep_iters),
                               "--batches", batches, *where])
    int8 = cuda_int8.int8_conv_cuda.launches
    calls = len(points) * (3 + rounds * sweep_iters)
    if int8 == 0 or int8 % calls:
        fail(f"tools.sweep_infer --fused --ptq: {int8} int8 launches in {calls} calls")
    print(f"phase 7e tools.sweep_infer --fused --ptq [{card}]: "
          + "; ".join(f"batch {p['batch']} {p['ms']} ({p['ms_min']}-{p['ms_max']}) ms, {p['img_s']} img/s"
                      for p in points)
          + f"; int8 launches {int8} ({int8 // calls} a call)")
    return launches, int8


def profile_tools_phase(torch, dev, card: str, config: str = os.path.join(ROOT, "config", "default.yml"),
                        batch_size: int = 32) -> tuple:
    """7f. tools/profile.py --summarize in modes train (2 steps) and infer-fused --ptq on
    config/default.yml (SSD300, 81 classes, bf16, batch 32): a summary that names the
    matcher, and the int8 kernels. Returns (matcher launches, int8 launches)."""
    from ssd_object_detection_tpu_torch.ops import cuda_int8, cuda_matcher
    from ssd_object_detection_tpu_torch.tools import profile

    where = ["--device", dev.type, "--batch-size", str(batch_size)]
    cuda_matcher.match_anchors_cuda.launches = 0
    cuda_int8.int8_conv_cuda.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as out:
        runs = {"train": profile.main([config, "--mode", "train", "--steps", "2", "--summarize",
                                       "--out", os.path.join(out, "train"), *where]),
                "infer-fused --ptq": profile.main([config, "--mode", "infer-fused", "--ptq", "--summarize",
                                                   "--out", os.path.join(out, "fused"), *where])}
    launches, int8 = cuda_matcher.match_anchors_cuda.launches, cuda_int8.int8_conv_cuda.launches
    needed = {"train": ("matcher",), "infer-fused --ptq": ("int8 conv (csrc/int8_conv.cu)",)}
    if dev.type != "cuda":  # the CPU's summary sums operators, not the card's kernels
        needed = {mode: () for mode in needed}
    for mode, r in runs.items():
        missing = [g for g in needed[mode] if not r["groups"].get(g)]
        if not r["kernels"] or missing:
            fail(f"tools.profile --mode {mode}: {len(r['kernels'])} kernels in the summary, no {missing}")
        print(f"phase 7f tools.profile --mode {mode} [{card}]: {len(r['kernels'])} kernels, "
              f"{sum(r['groups'].values()):.3f} ms summed (a lower bound) in a {r['window_ms']:.3f} ms "
              f"window of {r['steps']} calls ({r['window_clock']}); top groups: {format_groups(r['groups'])}")
    if launches != 3 or int8 == 0:
        fail(f"tools.profile: {launches} matcher launches (3 train steps) and {int8} int8 launches")
    return launches, int8


def serve_client_phase(torch, np, dev, card: str, variant: str = "ssd300") -> int:
    """7g. tools/serve_bench.py's closed loop in process over BatchingFrontEnd.submit:
    live SSD300 bf16 and int8 (synthetic scales), batch 32 with tiers 1 and 8, at
    concurrency 1, 8 and 32, 96 requests a level. Returns the int8 launches."""
    from ssd_object_detection_tpu_torch.eval.serve import BatchingFrontEnd, DetectorService
    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
    from ssd_object_detection_tpu_torch.ops import cuda_int8
    from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
    from ssd_object_detection_tpu_torch.ops.quant import quantize_synthetic
    from ssd_object_detection_tpu_torch.tools import serve_bench

    spec = MODEL_SPECS[variant]
    size = spec.image_size
    model = SSD(num_classes=81, spec=spec, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev).eval()
    anchors = generate_anchors(spec.anchor_spec)
    payloads = [serve_bench.make_image(seed=s) for s in range(8)]
    int8 = 0
    for name in ("live bf16", "live int8"):
        served = model if name == "live bf16" else quantize_synthetic(model, (32, size, size, 3))[0]
        service = DetectorService(served, anchors, image_size=size, batch_size=32, batch_tiers=(1, 8))
        service.warm()
        cuda_int8.int8_conv_cuda.launches = 0
        front = BatchingFrontEnd(service)
        try:
            levels = serve_bench.run_levels(serve_bench.in_process_client(front), payloads, (1, 8, 32), 96)
        finally:
            front.close()
        leg = cuda_int8.int8_conv_cuda.launches  # none on the bf16 leg, some on the int8 one
        if name == "live int8":
            int8 = leg
        bad = [lvl for lvl in levels if lvl["errors"] or lvl["requests"] != 96]
        if bad or (name == "live int8") != (leg > 0):
            fail(f"tools.serve_bench {name}: levels {bad}, int8 launches {leg}")
        print(f"phase 7g tools.serve_bench in process, {name}, tiers 1, 8, 32 [{card}]: "
              + "; ".join(f"concurrency {lvl['concurrency']}: {lvl['req_per_s']} img/s, p50 "
                          f"{lvl['latency']['p50_ms']} ms, p99 {lvl['latency']['p99_ms']} ms" for lvl in levels))
    del model, served, service
    torch.cuda.empty_cache()
    return int8


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
        # medians of 5 rounds of 10 back-to-back calls, with the slowest round beside them
        back_to_back, back_to_back_max = stream_spread(torch, kernel)
        quantize_ms, quantize_max = stream_spread(torch, lambda: cuda_int8.quantize_cuda(x, x_scale))
        conv_ms, conv_max = stream_spread(torch, lambda: cuda_int8.conv_cuda(xq, w_q, stride, pads, x.dtype,
                                                                             w_scale, x_scale, bias))
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
              f"({_plan_text(plan)}) [{card}]: conv kernel {conv_ms:.4f} ms back to back (median of 5 rounds; "
              f"slowest round {conv_max:.4f}) = "
              f"{ops / conv_ms / 1e9:.1f} TOP/s, {100 * conv_bound_ms / conv_ms:.1f} % of its "
              f"{conv_bound_ms:.4f} ms bound ({conv_bound_by}); quantize kernel {quantize_ms:.4f} ms (slowest round "
              f"{quantize_max:.4f}), "
              f"{100 * quantize_bound_ms / quantize_ms:.1f} % of its {quantize_bound_ms:.4f} ms "
              f"bound (bytes), its plain version {quantize_plain_ms:.4f} ms; pair {per_call:.4f} ms per call, "
              f"{back_to_back:.4f} back to back (slowest round {back_to_back_max:.4f}) = "
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
    print(f"int8 convs of one SSD300-VGG16 forward at batch 32, the shapes' medians summed [{card}]: pair "
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
    from ssd_object_detection_tpu_torch.tools.profile import INT8_GROUPS, PREDICT_GROUPS

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



def eval_gate_phase() -> int:
    """8. The synthetic mAP gates at the JAX tool's budget, each in its own process, the
    three at once on the card: SSD300-VGG16 with --ptq (float mAP@0.5 > 0.9, both int8
    drops <= 0.02), SSD300-R34 and SSD300-MNV2 (> 0.9); then the per-level diagnosis of
    the VGG gate's weights. Returns the diagnosis's matcher launches."""
    weights = os.path.join(ROOT, "build", "chip_smoke_vgg_gate.msgpack")
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    runs = {"ssd300 --ptq": ["--ptq", "--save-weights", weights], "ssd300_r34": ["--variant", "ssd300_r34"],
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
    return diag_phase(weights)


def diag_phase(weights: str, variant: str = "ssd300", device: str = "cuda") -> int:
    """8, after the gates: tools/diag_levels.py on the VGG gate's trained weights (SSD300, 8
    classes, max_gt 8, the 64 held-out images); returns its matcher launches."""
    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.tools import diag_levels

    cuda_matcher.match_anchors_cuda.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_diag_") as out:
        r = diag_levels.main(["--variant", variant, "--num-classes", "8", "--max-gt", "8", "--device", device,
                              "--weights", weights, "--out", os.path.join(out, "diag.json")])
    launches = cuda_matcher.match_anchors_cuda.launches
    if launches != 1 or sum(r["assigned_anchor_level_hist"]) == 0:
        fail(f"tools.diag_levels: {launches} matcher launches, assigned anchors {r['assigned_anchor_level_hist']}")
    print(f"phase 8 tools.diag_levels on the VGG gate's weights [{r['device']}, {r['power_limit']}]: level, "
          f"anchors, anchor-ceiling IoU mean, regressor IoU mean at the assigned anchors, classifier best "
          f"IoU mean, assigned anchors, solo mAP@0.5:")
    for lv, n in enumerate(r["anchors_per_level"]):
        print(f"  {lv}  {n:5d}  {r['anchor_ceiling_iou'][lv]['mean']}  "
              f"{r['regressor_iou_at_assigned_anchor'][lv]['mean']}  "
              f"{r['classifier_best_iou_above_thresh'][lv]['mean']}  {r['assigned_anchor_level_hist'][lv]}  "
              f"{r['per_level_solo_ap'][lv]['mAP@0.5']}")
    return launches


if __name__ == "__main__":
    main()
