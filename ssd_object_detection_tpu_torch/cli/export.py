"""CLI: export a trained detector to a `torch.export` serving artifact.

`python -m ssd_object_detection_tpu_torch.cli.export config.yml --weights w.msgpack
--out detector.pt2 --batch-size 8 [--device cuda]`

Counterpart of tools/export.py. The artifact holds the weights and runs on the device
it was exported on (`--device`, default cuda; raises without a GPU). Load it with
    from ssd_object_detection_tpu_torch.eval.serve import load_detector
    detect = load_detector(open("detector.pt2", "rb").read())
    detections = detect(images01)   # (B, S, S, 3) float32 in [0, 1], on that device
`--fused` exports the uint8 contract instead (on-device resize + normalize + forward +
NMS; the host keeps image decode and pack_canvas):
    detections = detect(canvas_u8, sizes)  # (B, 3, Hc, Wc) uint8, (B, 2) int32
and `--fused --tiers 1,4,8` one bundle with a program per batch tier, for
DetectorService.from_artifact and `cli.serve --artifact`. `--ptq` and `--ptq-heads`
(ROADMAP A13) raise.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from ssd_object_detection_tpu_torch.cli.common import add_ptq_flags, build_model, refuse_ptq
from ssd_object_detection_tpu_torch.config import load_config
from ssd_object_detection_tpu_torch.eval.serve import (
    export_detector, export_fused_detector, export_fused_detector_bundle,
)
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(description="export ssd detector for serving (PyTorch port)")
    parser.add_argument("config", type=str)
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--score-thresh", type=float, default=0.01)
    parser.add_argument("--fused", action="store_true",
                        help="fused uint8 contract: detect(canvas_u8, sizes)")
    parser.add_argument("--tiers", type=str, default=None,
                        help="with --fused: comma-separated batch tiers (e.g. '1,4,8') "
                        "exported as one bundle; overrides --batch-size")
    parser.add_argument("--canvas", type=int, nargs=2, default=(640, 640),
                        metavar=("HC", "WC"), help="canvas extents for --fused")
    add_ptq_flags(parser)
    args = parser.parse_args(argv)
    if args.tiers and not args.fused:
        parser.error("--tiers requires --fused (bundles hold fused artifacts)")
    refuse_ptq(args)

    cfg = load_config(args.config)
    model, spec = build_model(cfg, args.weights, resolve_device(args.device))
    anchors = generate_anchors(spec.anchor_spec)
    common = dict(image_size=spec.image_size, variances=cfg.model.loss.variances,
                  score_thresh=args.score_thresh)
    if args.fused and args.tiers:
        blob = export_fused_detector_bundle(
            model, anchors, batch_tiers=[int(t) for t in args.tiers.split(",") if t],
            canvas_hw=tuple(args.canvas), **common)
    elif args.fused:
        blob = export_fused_detector(model, anchors, batch_size=args.batch_size,
                                     canvas_hw=tuple(args.canvas), **common)
    else:
        blob = export_detector(model, anchors, batch_size=args.batch_size, **common)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob)} bytes)")
    return args.out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
