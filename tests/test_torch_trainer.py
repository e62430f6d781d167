"""Port Trainer and CLI on the CPU with a tiny spec registered in the port's registry."""

import numpy as np
import pytest
import torch
import yaml

from ssd_object_detection_tpu_torch.cli import train as cli_train
from ssd_object_detection_tpu_torch.config import Config
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS
from ssd_object_detection_tpu_torch.train.loop import Trainer
from tests.test_torch_train_step import PORT_TINY

torch.set_num_threads(1)
MODEL_SPECS.setdefault("tiny-test-torch", PORT_TINY)


def _tiny_config(tmp_path, **overrides) -> Config:
    cfg = Config()
    cfg.data.dataset = "synthetic"
    cfg.data.num_classes = 8
    cfg.data.mini_batch.enable = True
    cfg.data.mini_batch.num_data = 8
    cfg.data.max_gt = 4
    cfg.model.variant = "tiny-test-torch"
    cfg.model.precision = "float32"
    cfg.model.log_dir = str(tmp_path)
    cfg.model.log_interval = 0
    cfg.model.log_scalar_interval = 1
    cfg.model.train.epoch = 1
    cfg.model.train.batch_size = 4
    cfg.model.warmup.step = 2
    for k, v in overrides.items():
        *parts, last = k.split(".")
        obj = cfg
        for p in parts:
            obj = getattr(obj, p)
        setattr(obj, last, v)
    return cfg


def test_trainer_warmup_then_epoch(tmp_path):
    trainer = Trainer(_tiny_config(tmp_path), run_dir=str(tmp_path / "run"), device="cpu")
    state = trainer.train()
    # warmup: 2 steps on its own optimizer; then the epoch restarts at step 0 and runs
    # 8 images / batch 4 = 2 steps on a fresh one
    assert state.step == 2
    stages = [(h["stage"], h["step"]) for h in trainer.history]
    assert stages == [("warmup", 1), ("warmup", 2), ("train", 1), ("train", 2)]
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert trainer.history[0]["lr"] == pytest.approx(trainer.warmup_schedule(1))
    assert (tmp_path / "run" / "config.json").exists()


def test_trainer_grad_accumulation(tmp_path):
    cfg = _tiny_config(tmp_path, **{"model.split_train.enable": True,
                                    "model.split_train.batch_size": 2,
                                    "model.warmup.enable": False})
    trainer = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    assert trainer.step_cfg.accum_steps == 2
    assert trainer.train().step == 2


def test_trainer_refuses_unported_options(tmp_path):
    for key, value in (("data.dataset", "coco"), ("model.checkpoint.resume", True),
                       ("data.augment.flip", True), ("model.eval_every", 1)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(_tiny_config(tmp_path, **{key: value}), run_dir=str(tmp_path / "r"), device="cpu")


def test_trainer_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU error")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_tiny_config(tmp_path), run_dir=str(tmp_path / "run"))


def test_cli_trains_from_yaml(tmp_path):
    cfg = _tiny_config(tmp_path, **{"model.train.epoch": 2})
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    trainer = cli_train.main([str(path), "--device", "cpu", "--run-dir", str(tmp_path / "cli")])
    assert trainer.history[-1]["stage"] == "train" and trainer.history[-1]["step"] == 4
    assert np.isfinite(float(trainer.last_metrics["loss"]))
