"""Trainer: warmup phase + epoch loop, port of ssd_object_detection_tpu/train/loop.py.

Kept from the JAX Trainer: the timestamped run dir with its resolved config.json; the
warmup phase with its OWN optimizer state and polynomial learning rate, looped over
the dataset until `warmup.step` updates; then a fresh main optimizer with exponential
decay for the epoch loop, restarting at step 0; the synthetic data source; metric
logging every `log_scalar_interval` steps.

Not ported yet, each queued in ROADMAP.md: the COCO and packed pipelines (A9),
on-device augmentation (A10), other trunks (A11), data parallelism (A12), and
TensorBoard scalars and image panels, checkpoints, resume, msgpack export and the
crash save, in-training evaluation, the Keras VGG import, remat, NaN debugging and the
tqdm bar (A8). A config that asks for one of them raises NotImplementedError, except
checkpoint and TensorBoard writing (scalars and the `log_interval` image panels) and the
progress bar, which are skipped with a log line.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ssd_object_detection_tpu_torch.config import Config
from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.train.optim import (
    exponential_decay,
    make_optimizer,
    polynomial_decay,
)
from ssd_object_detection_tpu_torch.train.step import (
    StepConfig,
    TrainState,
    create_train_state,
    make_train_step,
)
from ssd_object_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _refuse_unported(cfg: Config) -> None:
    """Raise for every config option whose behaviour the port does not have yet."""
    mc, d = cfg.model, cfg.data
    unported = {
        "data.dataset other than 'synthetic' (ROADMAP A9)": d.dataset != "synthetic",
        "data.augment (ROADMAP A10)": d.augment.flip or d.augment.expand or d.augment.crop
        or d.augment.photometric,
        "model.checkpoint.resume (ROADMAP A8)": mc.checkpoint.resume,
        "model.eval_every (ROADMAP A8)": bool(mc.eval_every),
        "model.pretrained_vgg (ROADMAP A11)": bool(mc.pretrained_vgg),
        "model.remat (ROADMAP A8)": mc.remat,
        "model.debug_nans (ROADMAP A8)": mc.debug_nans,
        "parallel.data_parallel > 1 (ROADMAP A12)": cfg.parallel.data_parallel > 1,
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError("not ported yet: " + "; ".join(asked))


class Trainer:
    def __init__(self, config: Config, run_dir: Optional[str] = None, device: str = "cuda"):
        self.cfg = config.validate()
        _refuse_unported(self.cfg)
        self.device = resolve_device(device)
        mc = self.cfg.model

        if run_dir is None:
            stamp = time.strftime("%Y-%m-%d-%H%M%S", time.localtime())
            run_dir = os.path.join(mc.log_dir, stamp)
        self.run_dir = run_dir
        os.makedirs(self.run_dir, exist_ok=True)
        if mc.checkpoint.enable or mc.progress_bar or mc.log_interval:
            logger.info("checkpoints, TensorBoard and the progress bar are not ported yet "
                        "(ROADMAP A8); training without them")

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
        self.step_cfg = StepConfig(
            match_thresh=mc.match_thresh,
            neg_pos_ratio=mc.loss.neg_pos_ratio,
            canonical_loss=mc.loss.canonical,
            variances=mc.loss.variances,
            accum_steps=accum,
        )
        self.train_step = make_train_step(self.anchors, self.step_cfg)
        self.history: List[Dict[str, float]] = []
        self.last_metrics: Optional[Dict[str, torch.Tensor]] = None
        self._train_source = None

        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(self.cfg.to_dict(), f, sort_keys=True, indent=4, separators=(",", ":"))

    def _optimizer(self, section) -> torch.optim.Optimizer:
        opt = section.optimizer
        return make_optimizer(
            opt.name, self.model.parameters(), beta_1=opt.beta_1, beta_2=opt.beta_2,
            epsilon=opt.epsilon, momentum=opt.momentum,
        )

    # ------------------------------------------------------------------ data
    def train_batches(self, epochs: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        """Yield `epochs` epochs of training batches; the shuffle state advances across
        calls, so every epoch gets a new permutation."""
        if self._train_source is None:
            d = self.cfg.data
            ds = SyntheticDetectionDataset(
                num_images=d.mini_batch.num_data if d.mini_batch.enable else 256,
                image_size=self.spec.image_size,
                max_gt=min(d.max_gt, 8),
                num_classes=min(d.num_classes, 8),
            )
            order_rng = np.random.default_rng(d.seed)
            self._train_source = lambda: ds.batches(
                self.cfg.model.train.batch_size, epochs=1, shuffle=d.shuffle, order_rng=order_rng,
            )
        for _ in range(epochs):
            yield from self._train_source()

    # ------------------------------------------------------------------ train
    def _run_phase(
        self,
        stage: str,
        state: TrainState,
        batches: Iterator[Dict[str, np.ndarray]],
        max_steps: Optional[int] = None,
    ) -> TrainState:
        log_every = max(self.cfg.model.log_scalar_interval, 1)
        for batch in batches:
            metrics = self.train_step(state, batch)
            self.last_metrics = metrics
            if state.step % log_every == 0:
                # the one device -> host fetch of a logged step
                fetched = {k: float(v) for k, v in metrics.items()}
                fetched.update(stage=stage, step=state.step, lr=state.schedule(state.step))
                self.history.append(fetched)
                logger.info("%s step %d: loss %.4f", stage, state.step, fetched["loss"])
            if max_steps is not None and state.step >= max_steps:
                break
        return state

    def train(self) -> TrainState:
        mc = self.cfg.model
        if mc.warmup.enable:
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
        for epoch in range(mc.train.epoch):
            logger.info("epoch %d/%d", epoch + 1, mc.train.epoch)
            self._run_phase("train", state, self.train_batches(epochs=1))
        return state
