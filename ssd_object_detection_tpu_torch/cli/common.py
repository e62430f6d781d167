"""What the eval, serve, export and infer CLIs share: the model from a config and
weights, the class-name table, and int8 post-training quantization (`--ptq`,
`--ptq-heads`): calibration batches from the config's dataset, then ops/quant.py."""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssd_object_detection_tpu_torch.config import Config
from ssd_object_detection_tpu_torch.data.coco import COCO_NAMES, open_split
from ssd_object_detection_tpu_torch.data.pipeline import CocoPipeline, PipelineConfig
from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu_torch.models.convert import load_params_msgpack
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD, ModelSpec
from ssd_object_detection_tpu_torch.ops.quant import quantize_ssd

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


def model_inputs(images: np.ndarray) -> np.ndarray:
    """Images (uint8, or float in [0, 1]) -> model inputs (x / 255 - 0.5) * 2, float32."""
    img = np.asarray(images).astype(np.float32)
    if np.asarray(images).dtype == np.uint8:
        img = img / 255.0
    return (img - 0.5) * 2.0


def calibration_batches(cfg: Config, spec: ModelSpec, n_batches: int,
                        batch_size: int) -> List[np.ndarray]:
    """Up to `n_batches` model-input batches ((x - 0.5) * 2) from the config's val split:
    synthetic data for a synthetic config (tools/export.py::_calibration_batches). Raises
    SystemExit when the dataset gives none."""
    if cfg.data.dataset == "synthetic":
        source = SyntheticDetectionDataset(
            num_images=n_batches * batch_size, image_size=spec.image_size,
            max_gt=min(cfg.data.max_gt, 8), num_classes=min(cfg.data.num_classes, 8),
        ).batches(batch_size=batch_size)
    else:
        index = open_split(cfg.data.dataset_root, "val", mini_batch=n_batches * batch_size)
        source = CocoPipeline(index, PipelineConfig(
            image_size=spec.image_size, max_gt=cfg.data.max_gt, batch_size=batch_size,
            shuffle=False, num_workers=cfg.data.num_workers,
        ))
    out = []
    for batch in source:
        out.append(model_inputs(batch["image"]))
        if len(out) >= n_batches:
            break
    if not out:
        raise SystemExit("--ptq: no calibration batches available from the dataset")
    return out


def quantize_for_serving(model: SSD, calib: Sequence, include_heads: bool) -> SSD:
    """int8 PTQ of `model` calibrated on `calib` (ops/quant.py::quantize_ssd)."""
    quantized, qspec = quantize_ssd(model, calib, include_heads=include_heads)
    logger.info("ptq: quantized %d convs: %s", len(qspec), sorted(qspec))
    return quantized


def add_ptq_flags(parser, calib_batches: bool = False) -> None:
    parser.add_argument("--ptq", action="store_true",
                        help="int8-quantize the eligible convs (ops/quant.py: >= 128 input "
                        "channels, no dilation, no groups, heads only with --ptq-heads), "
                        "calibrated on batches of the config's dataset")
    parser.add_argument("--ptq-heads", action="store_true",
                        help="with --ptq: also quantize the loc/conf head convs")
    if calib_batches:
        parser.add_argument("--calib-batches", type=int, default=4,
                            help="with --ptq: calibration batches from the val split")


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
