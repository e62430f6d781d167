"""Reference-API compatibility facade, port of ssd_object_detection_tpu/compat.py.

The reference's public surface is two classes:
  - `SSDDataLoader(dataset_root, dataset="coco", shuffle=True, mini_batch=0)` with
    `.get_dataset() -> (train, val)` and `.get_names_and_colors()`;
  - `SSDObjectDetectionModel(classes, log_dir)` with a nested `TrainConfig` and the
    methods train / save / load / get_model / get_prior_box / get_log_dir /
    get_log_writer / show_summary / predict / visualize_prior_box / visualize_dataset /
    visualize.

These wrappers give reference users the same constructor and call shapes on top of the
port's core (train/loop.py's Trainer, data/pipeline.py's CocoPipeline, eval/predict.py).
They are thin adapters; new code should use the core APIs directly. The one argument the
JAX facade lacks is `device` (default "cuda"; raises without a GPU; "cpu" runs there).
`save` / `load` write and read the flax-compatible `.msgpack` (models/convert.py through
utils/msgpack_io.py), so a file that either facade saved loads in the other.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ssd_object_detection_tpu_torch.config import Config
from ssd_object_detection_tpu_torch.data.coco import COCO_NAMES, coco_colors, open_split
from ssd_object_detection_tpu_torch.data.pipeline import CocoPipeline, PipelineConfig
from ssd_object_detection_tpu_torch.models.convert import load_params_msgpack, save_params_msgpack
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.utils.device import resolve_device, true_divide

logger = logging.getLogger(__name__)


class SSDDataLoader:
    """Reference data_loaders.SSDDataLoader parity (ssd/make_dataset.py:15-87)."""

    def __init__(self, dataset_root: str, dataset: str = "coco", shuffle: bool = True,
                 mini_batch: int = 0, image_size: int = 300, max_gt: int = 100,
                 batch_size: int = 32):
        if dataset.lower() != "coco":
            raise ValueError(f"unsupported dataset {dataset!r}")  # reference :32-33
        self._names = COCO_NAMES
        self._colors = coco_colors()
        cfg = PipelineConfig(image_size=image_size, max_gt=max_gt, batch_size=batch_size,
                             shuffle=shuffle)
        self._train = CocoPipeline(open_split(dataset_root, "train", mini_batch=mini_batch), cfg)
        self._val = CocoPipeline(open_split(dataset_root, "val", mini_batch=mini_batch), cfg)

    def get_dataset(self) -> Tuple[CocoPipeline, CocoPipeline]:
        return self._train, self._val

    def get_names_and_colors(self):
        return self._names, self._colors


class SSDObjectDetectionModel:
    """Reference models.SSDObjectDetectionModel parity (models/ssd_model.py:19-490).

    Same constructor (classes=80 foreground, background appended internally as the LAST
    channel; a timestamped run dir under log_dir) and method names; training runs the
    port's Trainer underneath. The weights start from the seed-0 initialisation.
    """

    class TrainConfig:
        """Reference TrainConfig (models/ssd_model.py:20-40), optimizer args as
        (name, lr) descriptors rather than live optimizer objects."""

        def __init__(self, epoch: int, batch_size: int,
                     optimizer: str = "adam", lr_initial: float = 1e-3,
                     lr_decay_step: int = 100, lr_decay_rate: float = 0.99,
                     warmup: bool = True, warmup_step: int = 1000,
                     warmup_lr_start: float = 1e-6, warmup_lr_end: float = 1e-3,
                     visualization_log_interval: int = 10,
                     split_batch: bool = False, split_batch_size: int = 4):
            self.epoch = epoch
            self.batch_size = batch_size
            self.optimizer = optimizer
            self.lr_initial = lr_initial
            self.lr_decay_step = lr_decay_step
            self.lr_decay_rate = lr_decay_rate
            self.warmup = warmup
            self.warmup_step = warmup_step
            self.warmup_lr_start = warmup_lr_start
            self.warmup_lr_end = warmup_lr_end
            self.visualization_log_interval = visualization_log_interval
            self.split_batch = split_batch
            self.split_batch_size = split_batch_size

    def __init__(self, classes: int, log_dir: str, variant: str = "ssd300",
                 precision: str = "bfloat16", device: str = "cuda"):
        stamp = time.strftime("%Y-%m-%d-%H%M%S", time.localtime())
        self._log_dir = os.path.join(log_dir, stamp)
        self._classes = classes
        self._variant = variant
        self._precision = precision
        self._device = resolve_device(device)
        spec = MODEL_SPECS[variant]
        dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        self._model = SSD(num_classes=classes + 1, spec=spec, dtype=dtype)
        self._model = self._model.init_weights(torch.Generator().manual_seed(0)).to(self._device)
        self._spec = spec
        self._prior_box = generate_anchors(spec.anchor_spec)
        self._log_writer = None
        self._predict_fns = {}

    # ------------------------------------------------------------- training
    def train(self, data_loader, cfg: "SSDObjectDetectionModel.TrainConfig",
              dataset_root: Optional[str] = None):
        """Train through the Trainer from this model's weights, which then hold the
        result; returns the Trainer's final TrainState. Without `dataset_root` the data
        is the synthetic dataset. `data_loader` is accepted for the reference's signature
        (the Trainer builds its own feed, as in the JAX facade)."""
        from ssd_object_detection_tpu_torch.train.loop import Trainer

        config = Config()
        config.data.dataset = "coco" if dataset_root else "synthetic"
        if dataset_root:
            config.data.dataset_root = dataset_root
        config.data.num_classes = self._classes
        config.model.variant = self._variant
        config.model.precision = self._precision
        config.model.log_dir = os.path.dirname(self._log_dir) or "."
        config.model.log_interval = cfg.visualization_log_interval
        config.model.train.epoch = cfg.epoch
        config.model.train.batch_size = cfg.batch_size
        config.model.train.optimizer.name = cfg.optimizer
        config.model.train.lr.initial = cfg.lr_initial
        config.model.train.lr.decay_step = cfg.lr_decay_step
        config.model.train.lr.decay_rate = cfg.lr_decay_rate
        config.model.warmup.enable = cfg.warmup
        config.model.warmup.step = cfg.warmup_step
        config.model.warmup.lr.start = cfg.warmup_lr_start
        config.model.warmup.lr.end = cfg.warmup_lr_end
        config.model.split_train.enable = cfg.split_batch
        config.model.split_train.batch_size = cfg.split_batch_size

        trainer = Trainer(config, run_dir=self._log_dir, device=str(self._device))
        trainer.model.load_state_dict(self._model.state_dict())
        state = trainer.train()
        self._model.load_state_dict(trainer.model.state_dict())
        return state

    # ------------------------------------------------------------ persistence
    def save(self, path: str = "model_weight.msgpack"):
        """Weights export as flax msgpack (the reference saves a whole-model .h5,
        models/ssd_model.py:405-407)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_params_msgpack(self._model, path)
        logger.info("Model is saved to %s", path)

    def load(self, path: str = "model_weight.msgpack"):
        load_params_msgpack(self._model, path)
        logger.info("Model is loaded from %s", path)

    # -------------------------------------------------------------- accessors
    def get_model(self) -> SSD:
        """The SSD module, which holds its parameters (analog of get_tf_model,
        models/ssd_model.py:413)."""
        return self._model

    def get_prior_box(self) -> np.ndarray:
        return self._prior_box

    def get_log_dir(self) -> str:
        return self._log_dir

    def get_log_writer(self):
        """TensorBoard writer for this run dir (reference models/ssd_model.py:421-423),
        created once; None, with one log line, where tensorboard is not installed."""
        if self._log_writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                logger.info("tensorboard is not installed; get_log_writer returns None")
                return None
            self._log_writer = SummaryWriter(os.path.join(self._log_dir, "tensorboard"))
        return self._log_writer

    def show_summary(self) -> str:
        """Print and return the per-parameter table (reference show_summary = Keras
        model.summary() + plot_model PNG, models/ssd_model.py:398-403;
        utils/introspect.py)."""
        from ssd_object_detection_tpu_torch.utils.introspect import param_summary

        table = param_summary(self._model)
        print(table)
        return table

    def predict(self, images01, **nms_kwargs):
        """Batched detection on [0, 1] RGB images (or uint8) -> Detections; the predict
        function is built once per set of NMS keyword arguments."""
        from ssd_object_detection_tpu_torch.eval.predict import make_predict_fn

        key = tuple(sorted(nms_kwargs.items()))
        if key not in self._predict_fns:
            self._predict_fns[key] = make_predict_fn(self._model, self._prior_box, **nms_kwargs)
        return self._predict_fns[key](images01)

    # ----------------------------------------------------------- visualization
    def visualize_prior_box(self, image_size: Optional[int] = None, max_cells: int = 6):
        from ssd_object_detection_tpu_torch.utils.viz import render_anchor_grid

        return render_anchor_grid(self._prior_box, image_size or self._spec.image_size, max_cells)

    def visualize_dataset(self, batches, max_images: int = 8, label_names=None,
                          label_colors=None):
        """Render encoded training targets back onto their images (reference
        models/ssd_model.py:446-475: decode offsets against the prior box and draw).
        `batches` is any iterable of pipeline batch dicts; returns a list of RGB arrays
        instead of the reference's interactive cv2.imshow loop."""
        from ssd_object_detection_tpu_torch.ops.matching import build_targets
        from ssd_object_detection_tpu_torch.utils.viz import render_targets

        names = label_names or [f"class_{i}" for i in range(self._classes)]
        colors = label_colors or coco_colors()[: self._classes]
        anchors = torch.as_tensor(self._prior_box).to(self._device)
        out = []
        for batch in batches:
            t_cls, t_loc, t_mask = (t.cpu().numpy() for t in build_targets(
                *(torch.as_tensor(np.asarray(batch[k])).to(self._device)
                  for k in ("gt_cls", "gt_boxes", "gt_valid")), anchors))
            for b in range(batch["image"].shape[0]):
                out.append(render_targets(np.asarray(batch["image"][b]), t_cls[b], t_loc[b],
                                          t_mask[b], self._prior_box, names, colors))
                if len(out) >= max_images:
                    return out
        return out

    @torch.inference_mode()
    def visualize(self, image01, thresh: float = 0.5, label_names=None, label_colors=None):
        """Score-threshold qualitative decode of one [0, 1] (or uint8) image (reference
        models/ssd_model.py:477-490)."""
        from ssd_object_detection_tpu_torch.utils.viz import render_predictions

        image = torch.as_tensor(np.asarray(image01))[None].to(self._device)
        if image.dtype == torch.uint8:
            image = true_divide(image.float(), 255.0)
        loc, logits = self._model((image - 0.5) * 2.0)
        return render_predictions(
            np.asarray(image01), loc[0].float().cpu().numpy(), logits[0].float().cpu().numpy(),
            self._prior_box,
            label_names or [f"class_{i}" for i in range(self._classes)],
            label_colors or coco_colors()[: self._classes],
            thresh=thresh,
        )
