#!/usr/bin/env python3
"""Interleaved A/B of one hand-written kernel across trees, on one GPU.

    python3 conv_ab.py DIR_A DIR_B [DIR ...] [--kernel conv|matcher|host_prep|refine|resize|raw|tiff|smooth|fax]
                       [--rounds 2]
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

--kernel host_prep is no kernel: the host's work before the JPEG kernels
(data/codec.py: `parse_jpeg`, the marker walk with the unstuffing and restart split,
then `jpeg_batch`, the layout), timed on the host clock, the median of 15 warm calls.
Its shapes: batch32 (32 copies of the 640x480 4:2:0 fixture JPEG, the decode feed's
batch) and one (one copy, an HTTP request). Every tree reads the fixture of the tree
that holds this script, so all parse the same bytes. It needs no card.

--kernel refine is K6, the progressive refinement decode (csrc/jpeg_progressive.cu),
`progressive_entropy` on the coefficients K1 leaves (a fresh copy a call, its cloning
inside every timed call alike), checked bit-equal to the plain version. Its shape:
batch32, 32 copies of the 640x480 progressive fixture JPEG (of the tree that holds this
script), the round structure of the timed tree's `jpeg_batch`.

--kernel resize is K4 (csrc/resize.cu), `cuda_image.resize`, checked bit-equal to the
plain version. Its shapes: one (a 640x480 uint8 RGB image to 300x300, linear: the decode
feed's call), batch32 (32 such images: one `resize_batch` call where the tree has it,
else 32 `resize` calls, the caller's loop), f32_one (the same image as float32, the
host-augmented feed's call), area_one (1280x960 uint8 to 640x480, INTER_AREA at a
whole-number factor: the serving canvas fit), tiny_one (an 8x8 uint8 image to 4x4: one
CTA, so its graph time is a launch and the kernel's chain of dependent loads with next
to no bytes) and launch_floor (no resize: one in-place add on a one-byte tensor, the
card's cost of a graph node that does nothing, the same in every tree). The images are
seeded random bytes.

--kernel raw is K8 (csrc/raw_image.cu) on BMPs, from inputs already on the card: one (a
640x480 24-bit BMP: the tree's K8 launch for it, `raw_expand` on its uploaded rows, or on
the call's uploaded buffer where the tree has `raw_batch`), batch32 (32 such BMPs: 32
launches where the tree launches K8 an image, one where it launches it a call),
decode_one and decode32 (`codec.decode_images` of the BMPs' bytes, the whole decode
call with the parse and the upload: per call and host time only, no graph, since an
upload from pageable memory cannot be captured) and launch_floor (as for resize).
--kernel tiff is K10 (csrc/tiff_assemble.cu) and K8 on cv2's 640x480 LZW TIFF (120 strips
of 4 rows with the predictor) after K9, from K9's output on the card: one (where the tree
places chunks: the zero-filled image buffer, K10, then K8; where it reads them in place:
K10 in place, then K8) and batch32 (32 copies in one call), checked against the plain
versions on a fresh copy before the timing (the timed calls undo the predictor again in
place: the same work), k10_one, k8_one, k10_32 and k8_32 (each of the two alone on one and
32 TIFFs: K10, with the zero fill where the tree places chunks; K8 on what K10 leaves),
decode_one and decode32 as for raw, and launch_floor. The BMPs
are seeded random bytes written by the tree's fixture tool; the TIFF is the fixture of
the tree that holds this script.

--kernel smooth is K7 (csrc/jpeg_smooth.cu), `block_smooth`, on the coefficients K1 and
K6 leave for the 640x480 progressive fixture JPEG (of the tree that holds this script) cut
short, a fresh copy of them a call (K7 works in place; the copy is inside every timed
call alike, and clone32 / clone_one time the copy alone), checked bit-equal to the plain
version. Its shapes: one (one JPEG cut in its fifth scan), batch32 (32 of them: chip_smoke's
5c batch, whose chroma components' DCs may change past the last good row), ninth32 (32 cut
in the ninth scan: no component's DCs change), dc_only32 (32 cut after the DC scan: every
component's DCs change), clone_one, clone32 and launch_floor (as for resize). Each row also
gives the tree's K7 launches a call and the ms of each of its kernels as torch.profiler
kept them ("passes").

--kernel fax is K11 (csrc/ccitt_decode.cu), `ccitt_decode`, on the uploaded call buffer of
CCITT TIFFs (the fixtures of the tree that holds this script, parsed by each tree's
codec), checked bit-equal to the plain version: page8 (the 1728x2200 Group 4 page in 8
strips), page1 (the same page in one strip: nothing to spread across chunks), page8_x32
(32 of the 8-strip pages in one call) and small (tiff_ccitt_g4_strips_37x23.tif, 37x23 in
4 strips), and launch_floor (as for resize).

The script prints the card's name and power limit, one line per tree and shape with
every sample, and writes them all as JSON to FILE. A tree whose process fails (a check,
a fault) is reported with its error; the others are still timed.
"""

import argparse
import json
import math
import os
import re
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
# shape name -> copies of the fixture JPEG
HOST_PREP_SHAPES = {"batch32": 32, "one": 1}
HOST_PREP_JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ssd_object_detection_tpu_torch",
                              "data", "fixtures", "coco_640x480_420.jpg")
REFINE_JPEG = os.path.join(os.path.dirname(HOST_PREP_JPEG), "coco_640x480_progressive.jpg")
# shape name -> (images, source (h, w), output (h, w), mode, float32)
RESIZE_SHAPES = {"one": (1, (480, 640), (300, 300), "linear", False),
                 "batch32": (32, (480, 640), (300, 300), "linear", False),
                 "f32_one": (1, (480, 640), (300, 300), "linear", True),
                 "area_one": (1, (960, 1280), (480, 640), "area", False),
                 "tiny_one": (1, (8, 8), (4, 4), "linear", False),
                 "launch_floor": None}
RAW_SHAPES = {"launch_floor": 0, "one": 1, "batch32": 32, "decode_one": 1, "decode32": 32}
# and, for TIFFs, each kernel alone: what a tree spends before K8 (K10, and its zero fill where
# it places chunks) and K8 itself
TIFF_SHAPES = {**RAW_SHAPES, "k10_one": 1, "k8_one": 1, "k10_32": 32, "k8_32": 32}
TIFF_FIXTURE = os.path.join(os.path.dirname(HOST_PREP_JPEG), "tiff_cv2_640x480.tif")
# shape name -> (the scan the JPEG is cut in, None: right after the DC scan; copies; time the copy alone)
SMOOTH_SHAPES = {"launch_floor": None, "one": (4, 1, False), "batch32": (4, 32, False), "ninth32": (8, 32, False),
                 "dc_only32": (None, 32, False), "clone_one": (4, 1, True), "clone32": (4, 32, True)}
# shape name -> (the fixture, copies in one call), None: the launch floor
FAX_SHAPES = {"launch_floor": None, "small": ("tiff_ccitt_g4_strips_37x23.tif", 1),
              "page8": ("tiff_ccitt_g4_page_1728x2200.tif", 1),
              "page1": ("tiff_ccitt_g4_page_one_strip_1728x2200.tif", 1),
              "page8_x32": ("tiff_ccitt_g4_page_1728x2200.tif", 32)}
SHAPE_NAMES = {"conv": [s[0] for s in CONV_SHAPES], "matcher": list(MATCHER_SHAPES),
               "host_prep": list(HOST_PREP_SHAPES), "refine": ["batch32"], "resize": list(RESIZE_SHAPES),
               "raw": list(RAW_SHAPES), "tiff": list(TIFF_SHAPES), "smooth": list(SMOOTH_SHAPES),
               "fax": list(FAX_SHAPES)}


def time_call(torch, call, graph: bool = True) -> dict:
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
            **({"graph_ms": graph_ms(torch, call)} if graph else {})}


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


def child_host_prep(tree: str, names) -> None:
    """Time one tree's host prep of JPEGs at the named shapes; one JSON line per shape."""
    sys.path.insert(0, os.path.abspath(tree))
    from ssd_object_detection_tpu_torch.data import codec

    with open(HOST_PREP_JPEG, "rb") as f:
        blob = f.read()
    for name in names:
        blobs = [blob] * HOST_PREP_SHAPES[name]
        parse, layout = [], []
        for i in range(18):  # 3 warm-up calls, then 15 timed
            t0 = time.perf_counter()
            parsed = [codec.parse_jpeg(b) for b in blobs]
            t1 = time.perf_counter()
            codec.jpeg_batch(parsed)
            t2 = time.perf_counter()
            if i >= 3:
                parse.append((t1 - t0) * 1e3)
                layout.append((t2 - t1) * 1e3)
        print(json.dumps({"shape": name, "parse_ms": statistics.median(parse),
                          "layout_ms": statistics.median(layout),
                          "total_ms": statistics.median(p + q for p, q in zip(parse, layout))}), flush=True)


def child_refine(tree: str, names) -> None:
    """Time one tree's K6 on 32 progressive JPEGs; one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from ssd_object_detection_tpu_torch.data import codec
    from ssd_object_detection_tpu_torch.ops import cuda_image

    with open(REFINE_JPEG, "rb") as f:
        blob = f.read()
    host = codec.jpeg_batch([codec.parse_jpeg(blob)] * 32)
    gpu = host.to(torch.device("cuda"))
    first = cuda_image.entropy_decode(gpu)

    def call():
        return cuda_image.progressive_entropy(gpu, tuple(t.clone() for t in first))

    want = cuda_image.progressive_entropy(host, tuple(t.cpu() for t in first))
    if not all(torch.equal(g.cpu(), w) for g, w in zip(call(), want)):
        raise SystemExit(f"{tree}: K6 and its plain version differ")
    print(json.dumps({"shape": names[0], **time_call(torch, call)}), flush=True)


def child_resize(tree: str, names) -> None:
    """Time one tree's K4 at the named shapes; one JSON line per shape."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from ssd_object_detection_tpu_torch.ops import cuda_image

    rng = np.random.default_rng(0)
    for name in names:
        if RESIZE_SHAPES[name] is None:
            one = torch.zeros(1, dtype=torch.uint8, device="cuda")
            print(json.dumps({"shape": name, **time_call(torch, lambda: one.add_(1))}), flush=True)
            continue
        count, src, dst, mode, f32 = RESIZE_SHAPES[name]
        host = [torch.from_numpy(rng.integers(0, 256, src + (3,), dtype=np.uint8)) for _ in range(count)]
        if f32:
            host = [h.float() / 255 for h in host]
        images = [h.cuda() for h in host]
        if hasattr(cuda_image, "resize_batch") and count > 1:
            def call():
                return cuda_image.resize_batch(images, [dst] * count, mode)
        else:
            def call():
                return [cuda_image.resize(img, dst, mode) for img in images]
        for got, want in zip(call(), [cuda_image.resize(h, dst, mode) for h in host]):
            if not torch.equal(got.cpu(), want):
                raise SystemExit(f"{tree} {name}: K4 and its plain version differ")
        print(json.dumps({"shape": name, **time_call(torch, call)}), flush=True)


def _expand_calls(torch, codec, cuda_image, raws, tiffs, dev):
    """({"both", "k10", "k8"}: the tree's K10 + K8 launches for parsed raw images and
    TIFFs whose inputs are on `dev`, and each alone; the plain result of both): the
    launches of one decode call, K9's output (the TIFFs' LZW chunks) made once
    beforehand."""
    cpu = torch.device("cpu")
    if hasattr(codec, "raw_batch"):  # K8 once a call over the call's buffer; K10 in place where a chunk needs it
        batch = codec.raw_batch([], tiffs, raws)

        def buffers(device):
            buf = cuda_image.upload(batch, device)
            status = None
            if batch.lzw.gifs.shape[0]:
                lzw = batch.lzw.to(device) if device.type == "cuda" else batch.lzw
                status = cuda_image.lzw_decode(lzw, out=buf[batch.lzw_at:])[1]
            return buf, status

        (buf, status), (buf_h, status_h) = buffers(dev), buffers(cpu)

        def launches(b, st):
            cuda_image.tiff_assemble(b, batch, st)
            return cuda_image.raw_expand(b, batch)

        want = launches(buf_h, status_h)
        return {"both": lambda: launches(buf, status), "k10": lambda: cuda_image.tiff_assemble(buf, batch, status),
                "k8": lambda: cuda_image.raw_expand(buf, batch)}, want
    # one K8 launch an image (its rows and params uploaded), the TIFFs placed by one K10 launch first
    parts = [(torch.frombuffer(bytearray(r.data), dtype=torch.uint8), torch.from_numpy(r.params()),
              torch.from_numpy(r.palette.copy()), r) for r in raws]
    tiff = codec.tiff_batch(tiffs) if tiffs else None

    def inputs(device):
        out = [(d.to(device), p.to(device), q.to(device), r) for d, p, q, r in parts]
        if tiff is None:
            return out, None
        host = codec.gif_batch([], tiff)
        zero = torch.zeros(host.total_indices, dtype=torch.uint8, device=device)
        zero.copy_(tiff.decoded.to(device))
        decoded, status = cuda_image.lzw_decode(host.to(device) if device.type == "cuda" else host, out=zero)
        chunks = tiff.chunks.to(device)
        params = [(torch.from_numpy(t.raw().params()).to(device), torch.from_numpy(t.palette.copy()).to(device), t)
                  for t in tiffs]
        return out, (decoded, status, chunks, params)

    def launches(ins, tif_ins):
        out = [cuda_image.raw_expand(d, p, q, r.scale, (r.height, r.width)) for d, p, q, r in ins]
        if tif_ins is not None:
            decoded, status, chunks, params = tif_ins
            images = cuda_image.tiff_assemble(decoded, chunks, status, tiff.image_bytes)
            out += [cuda_image.raw_expand(images[at:at + t.nbytes], p, q, 1.0, (t.height, t.width))
                    for at, (p, q, t) in zip(tiff.image_offsets, params)]
        return out

    ins, tif_ins = inputs(dev)
    want = launches(*inputs(cpu))
    calls = {"both": lambda: launches(ins, tif_ins)}
    if tif_ins is not None:
        decoded, status, chunks, params = tif_ins
        placed = cuda_image.tiff_assemble(decoded.clone(), chunks, status, tiff.image_bytes)  # decoded stays fresh
        calls["k10"] = lambda: cuda_image.tiff_assemble(decoded, chunks, status, tiff.image_bytes)
        calls["k8"] = lambda: [cuda_image.raw_expand(placed[at:at + t.nbytes], p, q, 1.0, (t.height, t.width))
                               for at, (p, q, t) in zip(tiff.image_offsets, params)]
    return calls, want


def child_raw(tree: str, names, kind: str = "raw") -> None:
    """Time one tree's K8 (and, for TIFFs, K10) at the named shapes; one JSON line per
    shape."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from ssd_object_detection_tpu_torch.data import codec
    from ssd_object_detection_tpu_torch.ops import cuda_image
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    dev = torch.device("cuda")
    cuda_image.build()
    if kind == "raw":
        rng = np.random.default_rng(0)
        blob = fx.bmp(rng.integers(0, 256, (480, 640, 3)), 24)
    else:
        with open(TIFF_FIXTURE, "rb") as f:
            blob = f.read()
    for name in names:
        count = TIFF_SHAPES[name]
        if count == 0:
            one = torch.zeros(1, dtype=torch.uint8, device=dev)
            print(json.dumps({"shape": name, **time_call(torch, lambda: one.add_(1))}), flush=True)
            continue
        blobs = [blob] * count
        if name.startswith("decode"):
            want = codec.decode_image(blob, "cpu")

            def call():
                return codec.decode_images(blobs, dev)

            if not all(torch.equal(g.cpu(), want) for g in call()):
                raise SystemExit(f"{tree} {name}: the decode differs from the plain one")
            print(json.dumps({"shape": name, **time_call(torch, call, graph=False)}), flush=True)
            continue
        parsed = [codec.parse_raw(b, "bmp") if kind == "raw" else codec.parse_tiff(b) for b in blobs]
        calls, want = _expand_calls(torch, codec, cuda_image, parsed if kind == "raw" else [],
                                    parsed if kind == "tiff" else [], dev)
        got = calls["both"]()
        call = calls[name.split("_")[0] if name.startswith("k") else "both"]
        got, want = (got, want) if isinstance(want, list) else ([got], [want])
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise SystemExit(f"{tree} {name}: the kernels differ from their plain versions")
        print(json.dumps({"shape": name, **time_call(torch, call)}), flush=True)


def child_smooth(tree: str, names) -> None:
    """Time one tree's K7 at the named shapes; one JSON line per shape."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from chip_smoke import device_kernels
    from ssd_object_detection_tpu_torch.data import codec
    from ssd_object_detection_tpu_torch.ops import cuda_image
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    with open(REFINE_JPEG, "rb") as f:
        blob = f.read()
    for name in names:
        if SMOOTH_SHAPES[name] is None:
            one = torch.zeros(1, dtype=torch.uint8, device="cuda")
            print(json.dumps({"shape": name, **time_call(torch, lambda: one.add_(1))}), flush=True)
            continue
        scan, count, clone_only = SMOOTH_SHAPES[name]
        if scan is None:
            cut = blob[:fx.entropy_span(blob, 0)[1]] + b"\xff\xd9"
        else:
            start, end = fx.entropy_span(blob, scan)
            cut = blob[:start + (end - start) // 2] + b"\xff\xd9"
        host = codec.jpeg_batch([codec.parse_jpeg(cut)] * count)
        gpu = host.to(torch.device("cuda"))
        coef, _, stops = cuda_image.progressive_entropy(gpu, cuda_image.entropy_decode(gpu))
        if clone_only:
            def call():
                return coef.clone()
        else:
            def call():
                return cuda_image.block_smooth(gpu, coef.clone(), stops)

            hcoef, _, hstops = cuda_image.progressive_entropy(host, cuda_image.entropy_decode(host))
            if not torch.equal(call().cpu(), cuda_image.block_smooth(host, hcoef, hstops)):
                raise SystemExit(f"{tree} {name}: K7 and its plain version differ")
        before = cuda_image.block_smooth.launches
        call()
        launches = cuda_image.block_smooth.launches - before
        passes = {}
        for ms, _, kname in device_kernels(torch, call):
            key = (re.findall(r"\w+_kernel", kname) or [kname.strip()])[0]
            passes[key] = passes.get(key, 0.0) + ms
        print(json.dumps({"shape": name, **time_call(torch, call), "launches": launches, "passes": passes}),
              flush=True)


def child_fax(tree: str, names) -> None:
    """Time one tree's K11 at the named shapes; one JSON line per shape."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from ssd_object_detection_tpu_torch.data import codec
    from ssd_object_detection_tpu_torch.ops import cuda_image

    for name in names:
        if FAX_SHAPES[name] is None:
            one = torch.zeros(1, dtype=torch.uint8, device="cuda")
            print(json.dumps({"shape": name, **time_call(torch, lambda: one.add_(1))}), flush=True)
            continue
        fixture, copies = FAX_SHAPES[name]
        with open(os.path.join(os.path.dirname(HOST_PREP_JPEG), fixture), "rb") as f:
            tiff = codec.parse_tiff(f.read())
        batch, single = codec.raw_batch([], [tiff] * copies, []), codec.raw_batch([], [tiff], [])
        buf, want = cuda_image.upload(batch, torch.device("cuda")), cuda_image.upload(single, torch.device("cpu"))
        cuda_image.ccitt_decode(want, single)
        cuda_image.ccitt_decode(buf, batch)
        region = buf[batch.fax_out:batch.fax_out + batch.fax_bytes].cpu().reshape(copies, -1)
        if not all(torch.equal(r, want[single.fax_out:single.fax_out + single.fax_bytes]) for r in region):
            raise SystemExit(f"{tree} {name}: K11 and its plain version differ")

        def call():  # into the decoded output again (it writes the same bytes): the same work
            return cuda_image.ccitt_decode(buf, batch)

        print(json.dumps({"shape": name, **time_call(torch, call)}), flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card; "none" without nvidia-smi (a
    host_prep run on a machine without a card)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "none"


CHILDREN = {"conv": child_conv, "matcher": child_matcher, "host_prep": child_host_prep, "refine": child_refine,
            "resize": child_resize, "raw": child_raw, "tiff": lambda tree, names: child_raw(tree, names, "tiff"),
            "smooth": child_smooth, "fax": child_fax}


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
        CHILDREN[args.kernel](args.trees[0], args.shapes)
        return
    card = card_line()
    if card == "none" and args.kernel != "host_prep":
        raise SystemExit("nvidia-smi found no card: the kernels are timed on a GPU")
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
            print(f"{name} {tree}: " + "; ".join(
                f"{key} median {statistics.median(s[key] for s in rows):.4f} {[round(s[key], 4) for s in rows]}"
                if not isinstance(rows[0][key], dict) else
                f"{key} " + ", ".join(f"{k} median {statistics.median(s[key].get(k, 0.0) for s in rows):.4f}"
                                      for k in rows[0][key])
                for key in rows[0]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernel": args.kernel, "samples": samples,
                       "failures": failures}, f, indent=1)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
