#!/usr/bin/env python3
"""Interleaved A/B of the bf16 conv kernel (csrc/conv3x3.cu) across trees, on one GPU.

    python3 conv_ab.py DIR_A DIR_B [DIR ...] [--rounds 2] [--shapes NAME ...] [--out FILE]

Each DIR holds an `ssd_object_detection_tpu_torch/` package: a checkout of the repo,
or a copy of one with a change under test. Each round times every tree in a fresh
process, in the order A B ... B A, so that a drift of the card's clock during the run
falls on every tree alike. A process builds its tree's kernel, checks its output at
every shape against the plain version (one bf16 ulp beyond 1e-5 of the output's
scale, as chip_smoke.py does), then times `conv3x3_forward_cuda` on bf16 inputs with
relu: back to back (CUDA events around 20 calls enqueued together, the median of 5
such windows) and per call (CUDA events around one call, the median of 20).

The shapes (all by default, or those named by --shapes): the three VGG trunk layers of
chip_smoke.py at batch 32, and streamed64, 32 x 75 x 75 x 512 -> 64 (one N-block of 64
channels, 32 input-channel chunks per tile through a shorter ring). The script prints
the card's name and power limit, one line per tree and shape with every sample, and
writes them all as JSON to FILE. A tree whose process fails (a check, a fault) is
reported with its error; the others are still timed.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

# (name, B, H, W, IC, OC, pool)
SHAPES = (
    ("block1_conv2", 32, 300, 300, 64, 64, True),
    ("block2_conv2", 32, 150, 150, 128, 128, True),
    ("block3_conv2", 32, 75, 75, 256, 256, False),
    ("streamed64", 32, 75, 75, 512, 64, False),
)


def child(tree: str, names) -> None:
    """Time one tree's kernel at the named shapes; print one JSON line per shape."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from ssd_object_detection_tpu_torch.ops import cuda_conv
    from ssd_object_detection_tpu_torch.ops.conv3x3 import conv3x3_plain

    torch.backends.cudnn.allow_tf32 = False
    cuda_conv.build()
    g = torch.Generator().manual_seed(0)
    for name, batch, h, w, ic, oc, pool in SHAPES:
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
        print(json.dumps({"shape": name, "back_to_back_ms": statistics.median(windows),
                          "per_call_ms": statistics.median(calls)}), flush=True)
        del x, k, b


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--shapes", nargs="+", default=[s[0] for s in SHAPES],
                        choices=[s[0] for s in SHAPES])
    parser.add_argument("--out", default=None)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.trees[0], args.shapes)
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
                [sys.executable, os.path.abspath(__file__), "--child", tree, "--shapes",
                 *args.shapes], capture_output=True, text=True, timeout=300)
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
            print(f"{name} {tree}: back to back median {statistics.median(b2b):.4f} ms "
                  f"{[round(t, 4) for t in b2b]}; per call median "
                  f"{statistics.median(per_call):.4f} ms {[round(t, 4) for t in per_call]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "samples": samples, "failures": failures}, f, indent=1)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
