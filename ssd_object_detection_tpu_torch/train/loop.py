"""Trainer: warmup + epoch loop, data feed, checkpoints and resume, msgpack export, eval.

Port of ssd_object_detection_tpu/train/loop.py (single device):
  - the timestamped run dir with its resolved config.json;
  - the data source: synthetic, or COCO through the decode-once packed cache
    (data/packed.py) or the decode pipeline (data/pipeline.py), chosen as the JAX
    Trainer chooses (`_make_train_source`); batches go through `device_prefetch`
    (data/prefetch.py), `data.device_prefetch` deep;
  - the warmup phase with its OWN optimizer and polynomial learning rate, looped over
    the dataset until `warmup.step` updates; then a fresh main optimizer with
    exponential decay for the epoch loop, restarting at step 0;
  - a checkpoint after every epoch (train/checkpoint.py: model and optimizer state,
    step, phase) and `resume`, which restores the newest, skips warmup and starts at
    epoch `tag`; the data order restarts from the seed, as in the JAX Trainer;
  - `eval_every` and `evaluate` (COCO-style mAP on the validation split);
  - the crash save `error_exit_save.msgpack`, then the error is raised again; the
    final export `<model.save>.msgpack` (models/convert.py: the JAX export's format);
  - TensorBoard scalars with the reference's tag names and the image panels, through
    `torch.utils.tensorboard`, and the tqdm bar: each skipped with one log line where
    its package is missing, as the JAX Trainer does without tensorflow or tqdm.

With `data.augment.device` (the default) and any of expand, crop or photometric asked
for, the whole recipe, flip included, runs inside the train step (ops/augment.py) and
both feeds hand it clean resized images: the packed feed drops its host flip, the
decode feed its host flip, expand, crop and photometric.

Not ported, each raising NotImplementedError: the Keras VGG import `pretrained_vgg`
(ROADMAP A11), data parallelism (A12: `data_parallel > 1`, or the default 0 where more
than one CUDA device divides the batch), `remat` and `debug_nans` (A15).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ssd_object_detection_tpu_torch.config import Config
from ssd_object_detection_tpu_torch.data.coco import COCO_NAMES, coco_colors, open_split
from ssd_object_detection_tpu_torch.data.pipeline import CocoPipeline, PipelineConfig
from ssd_object_detection_tpu_torch.data.prefetch import device_prefetch
from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu_torch.models.convert import load_params_msgpack, save_params_msgpack
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.ops.augment import AugConfig
from ssd_object_detection_tpu_torch.train.checkpoint import CheckpointManager
from ssd_object_detection_tpu_torch.train.optim import (
    exponential_decay,
    make_optimizer,
    polynomial_decay,
)
from ssd_object_detection_tpu_torch.train.step import (
    BATCH_KEYS,
    StepConfig,
    TrainState,
    create_train_state,
    make_train_step,
)
from ssd_object_detection_tpu_torch.utils.device import resolve_device, true_divide

logger = logging.getLogger(__name__)


def _auto_data_parallel(batch_size: int, device: torch.device) -> int:
    """The devices `parallel.data_parallel: 0` means: as in the JAX Trainer, the most
    local devices that divide the batch (1 off CUDA)."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    while batch_size % n:
        n -= 1
    return n


def _refuse_unported(cfg: Config, device: torch.device) -> None:
    """Raise for every config option whose behaviour the port does not have yet."""
    mc, dp = cfg.model, cfg.parallel.data_parallel
    unported = {
        "model.pretrained_vgg (ROADMAP A11)": bool(mc.pretrained_vgg),
        "parallel.data_parallel > 1 (ROADMAP A12)": dp > 1,
        "parallel.data_parallel: 0 over more than one CUDA device (ROADMAP A12)":
            dp == 0 and _auto_data_parallel(mc.train.batch_size, device) > 1,
        "model.remat (ROADMAP A15)": mc.remat,
        "model.debug_nans (ROADMAP A15)": mc.debug_nans,
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError("not ported yet: " + "; ".join(asked))


class _EpochIterable:
    """A make-one-epoch callable with the stateful pipelines' contract: each __iter__
    yields one epoch, and any rng the callable holds advances across epochs."""

    def __init__(self, make_epoch):
        self._make_epoch = make_epoch

    def __iter__(self):
        return iter(self._make_epoch())


class Trainer:
    def __init__(self, config: Config, run_dir: Optional[str] = None, device: str = "cuda"):
        self.cfg = config.validate()
        self.device = resolve_device(device)
        _refuse_unported(self.cfg, self.device)
        mc = self.cfg.model

        if run_dir is None:
            stamp = time.strftime("%Y-%m-%d-%H%M%S", time.localtime())
            run_dir = os.path.join(mc.log_dir, stamp)
        self.run_dir = run_dir
        os.makedirs(self.run_dir, exist_ok=True)

        self.spec = MODEL_SPECS[mc.variant]
        self.num_classes = self.cfg.data.num_classes + 1  # background LAST
        dtype = torch.bfloat16 if mc.precision == "bfloat16" else torch.float32
        self.model = SSD(
            num_classes=self.num_classes, spec=self.spec, dtype=dtype, s2d_stem=mc.s2d_stem,
        ).init_weights(torch.Generator().manual_seed(0)).to(self.device)
        self.anchors = generate_anchors(self.spec.anchor_spec)

        tr, wu = mc.train, mc.warmup
        self.main_schedule = exponential_decay(tr.lr.initial, tr.lr.decay_step, tr.lr.decay_rate)
        self.warmup_schedule = polynomial_decay(wu.lr.start, wu.step, wu.lr.end)
        accum = tr.batch_size // mc.split_train.batch_size if mc.split_train.enable else 1
        aug = self.cfg.data.augment
        self._device_augment = aug.device and (aug.expand or aug.crop or aug.photometric)
        self.step_cfg = StepConfig(
            match_thresh=mc.match_thresh,
            neg_pos_ratio=mc.loss.neg_pos_ratio,
            canonical_loss=mc.loss.canonical,
            variances=mc.loss.variances,
            accum_steps=accum,
            augment=(AugConfig(photometric=aug.photometric, expand=aug.expand,
                               crop=aug.crop, flip=aug.flip)
                     if self._device_augment else None),
            aug_seed=self.cfg.data.seed,
        )
        self.train_step = make_train_step(self.anchors, self.step_cfg)
        self.history: List[Dict[str, float]] = []
        self.last_metrics: Optional[Dict[str, torch.Tensor]] = None
        self._train_source = None
        self._eval_predict = None

        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.info("TensorBoard is not installed; training without scalars and panels")
        else:
            self._tb = SummaryWriter(os.path.join(self.run_dir, "tensorboard"))

        self._tqdm = None
        if mc.progress_bar:
            try:
                from tqdm import tqdm
            except ImportError:
                logger.info("tqdm is not installed; training without a progress bar")
            else:
                self._tqdm = tqdm

        self._ckpt_mgr = None
        if mc.checkpoint.enable:
            self._ckpt_mgr = CheckpointManager(
                os.path.join(os.path.abspath(self.run_dir), "checkpoints"), keep=mc.checkpoint.keep,
            )

        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(self.cfg.to_dict(), f, sort_keys=True, indent=4, separators=(",", ":"))
        if self._tb is not None:
            self._tb.add_text("config", str(self.cfg.to_dict()), 0)

        if self.cfg.data.dataset == "coco":
            self.class_names, self.class_colors = COCO_NAMES, coco_colors()
        else:
            self.class_names = [f"class_{i}" for i in range(self.cfg.data.num_classes)]
            self.class_colors = coco_colors()[: self.cfg.data.num_classes]

    def _optimizer(self, section) -> torch.optim.Optimizer:
        opt = section.optimizer
        return make_optimizer(
            opt.name, self.model.parameters(), beta_1=opt.beta_1, beta_2=opt.beta_2,
            epsilon=opt.epsilon, momentum=opt.momentum,
        )

    # ------------------------------------------------------------------ data
    def train_batches(self, epochs: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        """Yield `epochs` epochs of training batches. The epoch source is built once per
        Trainer and keeps its shuffle and flip state, so every epoch gets new draws."""
        if self._train_source is None:
            self._train_source = self._make_train_source()
        for _ in range(epochs):
            yield from self._train_source

    def _make_train_source(self) -> Iterable[Dict[str, np.ndarray]]:
        """The epoch iterable for the configured dataset (each __iter__ is one epoch)."""
        d = self.cfg.data
        batch_size = self.cfg.model.train.batch_size
        if d.dataset == "synthetic":
            ds = SyntheticDetectionDataset(
                num_images=d.mini_batch.num_data if d.mini_batch.enable else 256,
                image_size=self.spec.image_size,
                max_gt=min(d.max_gt, 8),
                num_classes=min(d.num_classes, 8),
            )
            order_rng = np.random.default_rng(d.seed)
            return _EpochIterable(lambda: ds.batches(
                batch_size, epochs=1, shuffle=d.shuffle, order_rng=order_rng,
            ))
        index = open_split(
            d.dataset_root, "train",
            mini_batch=d.mini_batch.num_data if d.mini_batch.enable else 0,
        )
        # with device augmentation the feeds hand the step clean resized images; host
        # expand/crop/photometric need original pixels, so they bypass the packed cache
        host = not self._device_augment
        host_aug = host and (d.augment.expand or d.augment.crop or d.augment.photometric)
        if d.packed_cache and host_aug:
            logger.warning(
                "data.packed_cache=%r is IGNORED because HOST expand/crop/"
                "photometric augmentation (data.augment.device: false) needs "
                "original-resolution pixels: training routes through the (much "
                "slower) JPEG-decode pipeline. Set data.augment.device: true to "
                "run the recipe on the device and keep the cache.", d.packed_cache,
            )
        if self._device_augment:
            logger.info(
                "augmentation runs on the device inside the train step (photometric=%s "
                "expand=%s crop=%s flip=%s; ops/augment.py)", d.augment.photometric,
                d.augment.expand, d.augment.crop, d.augment.flip,
            )
        if d.packed_cache and not host_aug:
            from ssd_object_detection_tpu_torch.data.packed import (
                PackedConfig, PackedPipeline, is_packed, pack_dataset, verify_cache,
            )

            if not is_packed(d.packed_cache):
                logger.info("building packed cache at %s ...", d.packed_cache)
                pack_dataset(
                    index, d.packed_cache, image_size=self.spec.image_size,
                    max_gt=d.max_gt, num_workers=d.num_workers,
                )
            else:
                verify_cache(index, d.packed_cache, image_size=self.spec.image_size, max_gt=d.max_gt)
            return PackedPipeline(
                d.packed_cache,
                PackedConfig(batch_size=batch_size, shuffle=d.shuffle,
                             augment_flip=d.augment.flip and host, seed=d.seed),
            )
        return CocoPipeline(
            index,
            PipelineConfig(
                image_size=self.spec.image_size, max_gt=d.max_gt, batch_size=batch_size,
                shuffle=d.shuffle, seed=d.seed, num_workers=d.num_workers, prefetch=d.prefetch,
                augment_flip=d.augment.flip and host, augment_expand=d.augment.expand and host,
                augment_crop=d.augment.crop and host,
                augment_photometric=d.augment.photometric and host,
            ),
        )

    def val_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """The validation split: 32 synthetic images (seed 999) in batches of at most 8,
        or COCO val through the decode pipeline."""
        d = self.cfg.data
        if d.dataset == "synthetic":
            ds = SyntheticDetectionDataset(
                num_images=32, image_size=self.spec.image_size,
                max_gt=min(d.max_gt, 8), num_classes=min(d.num_classes, 8), seed=999,
            )
            yield from ds.batches(min(self.cfg.model.train.batch_size, 8))
            return
        index = open_split(
            d.dataset_root, "val",
            mini_batch=d.mini_batch.num_data if d.mini_batch.enable else 0,
        )
        yield from CocoPipeline(
            index,
            PipelineConfig(
                image_size=self.spec.image_size, max_gt=d.max_gt,
                batch_size=self.cfg.model.train.batch_size, shuffle=False,
                num_workers=d.num_workers, prefetch=d.prefetch,
            ),
        )

    def evaluate(self, max_batches: Optional[int] = None, step: int = 0) -> Dict[str, float]:
        """COCO-style mAP of the current model over the validation split; `step` tags
        the TensorBoard `val/*` scalars."""
        from ssd_object_detection_tpu_torch.eval.predict import make_predict_fn
        from ssd_object_detection_tpu_torch.eval.runner import evaluate_batches

        if self._eval_predict is None:
            self._eval_predict = make_predict_fn(self.model, self.anchors, variances=self.step_cfg.variances)
        metrics = evaluate_batches(
            self._eval_predict, self.val_batches(), num_classes=self.cfg.data.num_classes,
            max_batches=max_batches,
        )
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"val/{k}", v, step)
        return metrics

    # ------------------------------------------------------------- checkpoint
    def save_checkpoint(self, state: TrainState, tag: int, phase: str) -> None:
        if self._ckpt_mgr is None:
            return
        self._ckpt_mgr.save(tag, {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "phase": 0 if phase == "warmup" else 1,
        })

    def restore_latest(self, state: TrainState) -> Optional[int]:
        """Load the newest checkpoint into `state` in place; its tag, or None."""
        if self._ckpt_mgr is None or self._ckpt_mgr.latest_step() is None:
            return None
        tag = self._ckpt_mgr.latest_step()
        payload = self._ckpt_mgr.restore(tag, map_location=self.device)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return tag

    def export_params(self, name: str) -> str:
        """Weights-only export `<run_dir>/<name>.msgpack`, the JAX Trainer's format."""
        path = os.path.join(self.run_dir, name if name.endswith(".msgpack") else name + ".msgpack")
        save_params_msgpack(self.model, path)
        logger.info("params exported to %s", path)
        return path

    def load_params(self, path: str) -> torch.nn.Module:
        """Replace the model's params with an exported msgpack file (either package's)."""
        load_params_msgpack(self.model, path)
        logger.info("params loaded from %s", path)
        return self.model

    # ------------------------------------------------------------------ logging
    def _log_scalars(self, stage: str, fetched: Dict[str, float], lr: float, step: int) -> None:
        if self._tb is None:
            return
        # reference tag names (models/ssd_model.py:281-285)
        for tag, key in (("loc loss", "loc_loss"), ("cls loss pos", "cls_loss_pos"),
                         ("cls loss neg", "cls_loss_neg"), ("loss", "loss")):
            self._tb.add_scalar(f"{stage}/{tag}", fetched[key], step)
        self._tb.add_scalar(f"{stage}/lr", lr, step)

    def _log_images(self, stage: str, batch: Dict[str, np.ndarray], step: int) -> None:
        from ssd_object_detection_tpu_torch.ops.matching import build_targets
        from ssd_object_detection_tpu_torch.utils import viz

        if self._tb is None or viz.cv2 is None:
            return
        image01 = np.asarray(batch["image"][0])
        if image01.dtype == np.uint8:
            image01 = image01.astype(np.float32) / 255.0
        with torch.no_grad():
            first = torch.as_tensor(np.asarray(batch["image"][:1])).to(self.device)
            if first.dtype == torch.uint8:
                first = true_divide(first.float(), 255.0)
            loc, logits = self.model((first - 0.5) * 2.0)
            t_cls, t_loc, t_mask = build_targets(
                *(torch.as_tensor(np.asarray(batch[k][:1])).to(self.device)
                  for k in ("gt_cls", "gt_boxes", "gt_valid")),
                torch.as_tensor(self.anchors).to(self.device),
                thresh=self.step_cfg.match_thresh, variances=self.step_cfg.variances,
            )
        loc, logits = loc[0].float().cpu().numpy(), logits[0].float().cpu().numpy()
        pred_img = viz.render_predictions(
            image01, loc, logits, self.anchors, self.class_names, self.class_colors, thresh=0.3,
        )
        gt_img = viz.render_targets(
            image01, t_cls[0].cpu().numpy(), t_loc[0].cpu().numpy(), t_mask[0].cpu().numpy(),
            self.anchors, self.class_names, self.class_colors,
        )
        # predictions rendered at GT-positive anchors (reference pred_with_mask panel)
        probs = np.exp(logits.astype(np.float64))
        probs /= probs.sum(-1, keepdims=True)
        pred_mask_img = viz.render_targets(
            image01, probs[:, :-1].argmax(-1), loc, t_mask[0].cpu().numpy(),
            self.anchors, self.class_names, self.class_colors, scores=probs[:, :-1].max(-1),
        )
        for tag, img in (("pred", pred_img), ("pred_with_mask", pred_mask_img), ("gt", gt_img)):
            self._tb.add_image(f"{stage}/{tag}", img, step, dataformats="HWC")

    # ------------------------------------------------------------------ train
    def _run_phase(
        self,
        stage: str,
        state: TrainState,
        batches: Iterable[Dict[str, np.ndarray]],
        max_steps: Optional[int] = None,
    ) -> TrainState:
        mc = self.cfg.model
        log_every = max(mc.log_scalar_interval, 1)
        host_side: List[Dict[str, np.ndarray]] = []

        def tee(src):
            for b in src:
                host_side.append(b)
                yield {k: b[k] for k in BATCH_KEYS}

        # the postfix refreshes only at log_every, so the bar forces no extra fetches
        bar = None
        if self._tqdm is not None:
            bar = self._tqdm(desc=stage, total=max_steps, initial=state.step, unit="step")

        try:
            for dbatch in device_prefetch(tee(batches), self.device, depth=self.cfg.data.device_prefetch):
                batch = host_side.pop(0)
                metrics = self.train_step(state, dbatch)
                self.last_metrics = metrics
                if state.step % log_every == 0:
                    # the one device -> host fetch of a logged step
                    fetched = {k: float(v) for k, v in metrics.items()}
                    lr = state.schedule(state.step)
                    fetched.update(stage=stage, step=state.step, lr=lr)
                    self.history.append(fetched)
                    self._log_scalars(stage, fetched, lr, state.step)
                    if bar is not None:
                        bar.set_postfix(loss=f"{fetched['loss']:.4f}", refresh=False)
                if bar is not None:
                    bar.update(1)
                if mc.log_interval and state.step % mc.log_interval == 0:
                    self._log_images(stage, batch, state.step)
                if max_steps is not None and state.step >= max_steps:
                    break
        finally:
            if bar is not None:
                bar.close()
        return state

    def train(self) -> TrainState:
        mc = self.cfg.model
        state = create_train_state(self.model, self._optimizer(mc.train), self.main_schedule)
        start_epoch = 0
        skip_warmup = False

        if mc.checkpoint.resume:
            tag = self.restore_latest(state)
            if tag is not None:
                start_epoch = tag
                skip_warmup = True
                logger.info("resumed from checkpoint %s (step %d)", tag, state.step)

        try:
            if mc.warmup.enable and not skip_warmup:
                logger.info("warmup for %d steps", mc.warmup.step)
                wstate = create_train_state(self.model, self._optimizer(mc.warmup), self.warmup_schedule)
                while wstate.step < mc.warmup.step:
                    before = wstate.step
                    self._run_phase("warmup", wstate, self.train_batches(epochs=1), max_steps=mc.warmup.step)
                    if wstate.step == before:
                        raise RuntimeError(
                            "warmup made no progress: the dataset produced no batches "
                            f"(batch_size {mc.train.batch_size} larger than the dataset?)"
                        )
                # the main optimizer starts fresh on the warmed-up params, at step 0
                state = create_train_state(self.model, self._optimizer(mc.train), self.main_schedule)

            for epoch in range(start_epoch, mc.train.epoch):
                logger.info("epoch %d/%d", epoch + 1, mc.train.epoch)
                self._run_phase("train", state, self.train_batches(epochs=1))
                self.save_checkpoint(state, epoch + 1, "train")
                if mc.eval_every and (epoch + 1) % mc.eval_every == 0:
                    metrics = self.evaluate(step=state.step)
                    logger.info("epoch %d val: %s", epoch + 1, metrics)
        except Exception:
            # the reference saves error_exit_save then re-raises; the model's params
            # are updated in place, so they are the freshest live state
            try:
                crash_path = self.export_params("error_exit_save")
                logger.critical("error during training; params saved to %s", crash_path)
            except Exception:  # never mask the original error
                logger.critical("error during training; the crash save also failed", exc_info=True)
            raise

        self.export_params(mc.save.replace(".h5", ""))
        if self._tb is not None:
            self._tb.flush()
        return state
