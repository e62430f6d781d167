"""What the serve, export and infer CLIs share: the model from a config and weights,
the class-name table, and the refusal of the options that wait for int8 PTQ."""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch

from ssd_object_detection_tpu_torch.config import Config
from ssd_object_detection_tpu_torch.data.coco import COCO_NAMES
from ssd_object_detection_tpu_torch.models.convert import load_params_msgpack
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD, ModelSpec

logger = logging.getLogger(__name__)


def build_model(cfg: Config, weights: Optional[str], device: torch.device) -> Tuple[SSD, ModelSpec]:
    """The config's SSD with `weights` (either package's .msgpack) on `device`; random
    weights from seed 0 when no file is given."""
    spec = MODEL_SPECS[cfg.model.variant]
    dtype = torch.bfloat16 if cfg.model.precision == "bfloat16" else torch.float32
    model = SSD(num_classes=cfg.data.num_classes + 1, spec=spec, dtype=dtype)
    model = model.init_weights(torch.Generator().manual_seed(0))
    if weights:
        load_params_msgpack(model, weights)
    else:
        logger.warning("no --weights given; using RANDOM weights (smoke mode)")
    return model.to(device), spec


def class_names(cfg: Config) -> List[str]:
    if cfg.data.dataset == "coco" and cfg.data.num_classes == len(COCO_NAMES):
        return COCO_NAMES
    return [f"class_{i}" for i in range(cfg.data.num_classes)]


def refuse_ptq(args) -> None:
    """--ptq and --ptq-heads select the int8 path, which is not ported yet."""
    if args.ptq or args.ptq_heads:
        raise NotImplementedError(
            "--ptq/--ptq-heads: int8 post-training quantization is not ported yet (ROADMAP A13)")


def add_ptq_flags(parser) -> None:
    parser.add_argument("--ptq", action="store_true", help="not ported yet (ROADMAP A13)")
    parser.add_argument("--ptq-heads", action="store_true", help="not ported yet (ROADMAP A13)")


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
