#!/usr/bin/env python3
"""Interleaved A/B of one hand-written kernel across trees, on one GPU.

    python3 conv_ab.py DIR_A DIR_B [DIR ...] [--kernel conv|matcher] [--rounds 2]
                       [--shapes NAME ...] [--out FILE]

Each DIR holds an `ssd_object_detection_tpu_torch/` package: a checkout of the repo,
or a copy of one with a change under test. Each round times every tree in a fresh
process, in the order A B ... B A, so that a drift of the card's clock during the run
falls on every tree alike. A process builds its tree's kernel, checks its output at
every shape against the plain version, then times the kernel's wrapper: back to back
(CUDA events around 20 calls enqueued together, the median of 5 such windows), per call
(CUDA events around one call on an idle card, the median of 20), the wrapper's host
time (the host clock around 50 calls enqueued without a synchronise, per call) and the
card's time with no host time in it (20 calls replayed from one CUDA graph, the median
of 5 replays: what back to back cannot show once the card is faster than the wrapper).

--kernel conv (the default) is the bf16 conv kernel (csrc/conv3x3.cu),
`conv3x3_forward_cuda` with relu, checked to one bf16 ulp beyond 1e-5 of the output's
scale as chip_smoke.py does. Its shapes: the three VGG trunk layers of chip_smoke.py at
batch 32, and streamed64, 32 x 75 x 75 x 512 -> 64 (one N-block of 64 channels, 32
input-channel chunks per tile through a shorter ring).

--kernel matcher is the greedy anchor matcher (csrc/matcher.cu), `match_anchors_cuda`,
checked bit-equal to the plain matcher. Its shapes are chip_smoke.py's cases: main
(`synthetic_b32`, the train path's batch: B=32, G=100, SSD300's 8,732 anchors), dense
(`random_seed0`: the same shape with 1,716 of 3,200 GTs valid) and ssd512
(`ssd512_anchors`: B=8, 24,564 anchors).

The script prints the card's name and power limit, one line per tree and shape with
every sample, and writes them all as JSON to FILE. A tree whose process fails (a check,
a fault) is reported with its error; the others are still timed.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

from chip_smoke import graph_ms, matcher_cases  # this script's neighbour

# (name, B, H, W, IC, OC, pool)
CONV_SHAPES = (
    ("block1_conv2", 32, 300, 300, 64, 64, True),
    ("block2_conv2", 32, 150, 150, 128, 128, True),
    ("block3_conv2", 32, 75, 75, 256, 256, False),
    ("streamed64", 32, 75, 75, 512, 64, False),
)


# shape name -> chip_smoke.py's matcher case
MATCHER_SHAPES = {"main": "synthetic_b32", "dense": "random_seed0", "ssd512": "ssd512_anchors"}
SHAPE_NAMES = {"conv": [s[0] for s in CONV_SHAPES], "matcher": list(MATCHER_SHAPES)}


def time_call(torch, call) -> dict:
    """Back-to-back, per-call and host time of `call` (see the module's note)."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    windows = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / 20)
    calls = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        calls.append(start.elapsed_time(end))
    t = time.perf_counter()
    for _ in range(50):
        call()
    host_us = (time.perf_counter() - t) / 50 * 1e6
    torch.cuda.synchronize()
    return {"back_to_back_ms": statistics.median(windows),
            "per_call_ms": statistics.median(calls), "host_us": host_us,
            "graph_ms": graph_ms(torch, call)}


def child_matcher(tree: str, names) -> None:
    """Time one tree's matcher at the named shapes; print one JSON line per shape."""
    sys.path.insert(0, os.path.abspath(tree))  # the package, its data and anchors: the tree's
    import numpy as np
    import torch

    from ssd_object_detection_tpu_torch.ops import cuda_matcher
    from ssd_object_detection_tpu_torch.ops.anchors import SSD512_SPEC, generate_anchors
    from ssd_object_detection_tpu_torch.ops.plain_matcher import match_anchors

    cuda_matcher.build()
    cases = dict(matcher_cases(np, generate_anchors(), generate_anchors(SSD512_SPEC)))
    for name in names:
        args = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in cases[MATCHER_SHAPES[name]]]
        got, want = cuda_matcher.match_anchors_cuda(*args), match_anchors(*args)
        for field, g, w in zip(got._fields, got, want):
            if not torch.equal(g, w):
                raise SystemExit(f"{tree} {name}: kernel and plain {field} differ")
        del got, want
        row = time_call(torch, lambda: cuda_matcher.match_anchors_cuda(*args))
        print(json.dumps({"shape": name, **row}), flush=True)


def child_conv(tree: str, names) -> None:
    """Time one tree's conv kernel at the named shapes; print one JSON line per shape."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from ssd_object_detection_tpu_torch.ops import cuda_conv
    from ssd_object_detection_tpu_torch.ops.conv3x3 import conv3x3_plain

    torch.backends.cudnn.allow_tf32 = False
    cuda_conv.build()
    g = torch.Generator().manual_seed(0)
    for name, batch, h, w, ic, oc, pool in CONV_SHAPES:
        if name not in names:
            continue
        x = torch.randn(batch, h, w, ic, generator=g).to(torch.bfloat16).cuda()
        k = (torch.randn(3, 3, ic, oc, generator=g) / math.sqrt(9 * ic)).cuda()
        b = (torch.randn(oc, generator=g) * 0.1).cuda()

        def call():
            return cuda_conv.conv3x3_forward_cuda(x, k, b, True, pool)

        got, want = call().float(), conv3x3_plain(x, k, b, True, pool).float()
        tol = 1e-5 * max(want.abs().max().item(), 1.0) + torch.exp2(
            torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
        if not bool(((got - want).abs() <= tol).all()):
            raise SystemExit(f"{tree} {name}: kernel and plain differ beyond one bf16 ulp")
        del got, want
        print(json.dumps({"shape": name, **time_call(torch, call)}), flush=True)
        del x, k, b


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--kernel", choices=list(SHAPE_NAMES), default="conv")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--shapes", nargs="+", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    args.shapes = args.shapes or SHAPE_NAMES[args.kernel]
    unknown = [name for name in args.shapes if name not in SHAPE_NAMES[args.kernel]]
    if unknown:
        parser.error(f"--kernel {args.kernel} has shapes {SHAPE_NAMES[args.kernel]}, not {unknown}")
    if args.child:
        (child_conv if args.kernel == "conv" else child_matcher)(args.trees[0], args.shapes)
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    samples = {tree: {name: [] for name in args.shapes} for tree in args.trees}
    failures = []
    for r in range(args.rounds):
        for tree in args.trees + args.trees[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree, "--kernel",
                 args.kernel, "--shapes", *args.shapes],
                capture_output=True, text=True, timeout=300)
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    row = json.loads(line)
                    samples[tree][row.pop("shape")].append(row)
            status = "done" if proc.returncode == 0 else f"FAILED (exit {proc.returncode})"
            print(f"round {r} {tree}: {status}", flush=True)
            if proc.returncode != 0:
                failures.append({"round": r, "tree": tree, "stderr": proc.stderr[-3000:]})
                print(proc.stderr[-3000:], flush=True)
    for name in args.shapes:
        for tree in args.trees:
            rows = samples[tree][name]
            if not rows:
                print(f"{name} {tree}: no sample")
                continue
            b2b = [s["back_to_back_ms"] for s in rows]
            per_call = [s["per_call_ms"] for s in rows]
            host = [s["host_us"] for s in rows]
            graph = [s["graph_ms"] for s in rows]
            print(f"{name} {tree}: back to back median {statistics.median(b2b):.4f} ms "
                  f"{[round(t, 4) for t in b2b]}; per call median "
                  f"{statistics.median(per_call):.4f} ms {[round(t, 4) for t in per_call]}; "
                  f"host median {statistics.median(host):.1f} us {[round(t, 1) for t in host]}; "
                  f"from a CUDA graph median {statistics.median(graph):.4f} ms "
                  f"{[round(t, 4) for t in graph]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernel": args.kernel, "samples": samples,
                       "failures": failures}, f, indent=1)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
