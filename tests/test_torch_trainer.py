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
    """Data parallelism (A12) and debug_nans (A15) still raise; pretrained_vgg and remat
    are ported (tests/test_torch_import_keras.py, tests/test_torch_trunks.py)."""
    for key, value in (("parallel.data_parallel", 2), ("model.debug_nans", True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(_tiny_config(tmp_path, **{key: value}), run_dir=str(tmp_path / "r"), device="cpu")
    trainer = Trainer(_tiny_config(tmp_path, **{"model.remat": True}), run_dir=str(tmp_path / "r"),
                      device="cpu")
    assert trainer.model.remat


@pytest.mark.parametrize("devices,batch_size,refused", [(2, 4, True), (8, 4, True), (3, 4, True),
                                                        (3, 5, False), (1, 4, False)])
def test_default_data_parallel_refuses_several_cuda_devices(tmp_path, monkeypatch, devices,
                                                             batch_size, refused):
    """`data_parallel: 0` means every CUDA device that divides the batch, as in the JAX
    Trainer: more than one is data parallelism (A12) and raises; one trains as before."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: devices)
    cfg = _tiny_config(tmp_path, **{"model.train.batch_size": batch_size})
    assert cfg.parallel.data_parallel == 0
    if refused:
        with pytest.raises(NotImplementedError, match="A12"):
            Trainer(cfg, run_dir=str(tmp_path / "r"), device="cuda")
    else:  # past the refusal the Trainer reaches CUDA itself, which this host lacks
        from ssd_object_detection_tpu_torch.train import loop

        loop._refuse_unported(cfg, torch.device("cuda"))
    # the CPU is one device, whatever the CUDA count
    Trainer(cfg, run_dir=str(tmp_path / "cpu"), device="cpu")


def test_device_augmentation_trains_and_resumes_bit_equal(tmp_path):
    """The full recipe on the device (synthetic data, shuffle off): 2 epochs straight
    equal 1 epoch and a resume for epoch 2 bit for bit, because the draws are keyed on
    the step; and the augmentation changes the run."""
    aug = {"data.augment.expand": True, "data.augment.crop": True,
           "data.augment.photometric": True, "data.augment.flip": True, "data.shuffle": False}
    straight = Trainer(_tiny_config(tmp_path, **aug, **{"model.train.epoch": 2}),
                       run_dir=str(tmp_path / "straight"), device="cpu")
    assert straight.step_cfg.augment is not None and straight.step_cfg.augment.crop
    straight.train()
    run = str(tmp_path / "split")
    Trainer(_tiny_config(tmp_path, **aug), run_dir=run, device="cpu").train()
    second = Trainer(_tiny_config(tmp_path, **aug, **{"model.train.epoch": 2,
                                                      "model.checkpoint.resume": True}),
                     run_dir=run, device="cpu")
    assert second.train().step == 4
    want = straight.model.state_dict()
    for key, value in second.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    assert [h["loss"] for h in second.history] == [h["loss"] for h in straight.history[-2:]]

    plain = Trainer(_tiny_config(tmp_path, **{"data.shuffle": False, "model.train.epoch": 2}),
                    run_dir=str(tmp_path / "plain"), device="cpu")
    assert plain.step_cfg.augment is None
    plain.train()
    assert [h["loss"] for h in plain.history] != [h["loss"] for h in straight.history]


def test_aug_ab_config_trains_on_the_packed_cache_without_host_flip(tmp_path):
    """config/aug_ab.yml (ssd300 recipe: flip, expand, crop, photometric; augment.device
    at its default) on a tools/make_fake_coco.py root: the Trainer packs the cache, feeds
    it with no host flip and augments inside the step."""
    pytest.importorskip("cv2")
    from ssd_object_detection_tpu_torch.config import load_config
    from ssd_object_detection_tpu_torch.data.packed import PackedPipeline
    from ssd_object_detection_tpu_torch.ops.augment import AugConfig
    from tests.test_torch_data import make_fake_coco

    root = str(tmp_path / "coco")
    make_fake_coco.make_split(root, "train", 12, seed=2)
    cfg = load_config("config/aug_ab.yml")
    assert cfg.data.augment.device and cfg.data.augment.crop and cfg.data.augment.flip
    cfg.data.dataset_root, cfg.data.packed_cache = root, str(tmp_path / "packed")
    cfg.data.num_workers = 1
    cfg.model.variant, cfg.model.precision = "tiny-test-torch", "float32"
    cfg.model.log_dir, cfg.model.progress_bar = str(tmp_path / "runs"), False
    cfg.model.train.batch_size, cfg.model.train.epoch, cfg.model.warmup.step = 4, 1, 1
    trainer = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    assert trainer.step_cfg.augment == AugConfig(photometric=True, expand=True, crop=True, flip=True)
    state = trainer.train()
    source = trainer._train_source
    assert isinstance(source, PackedPipeline) and source.cfg.augment_flip is False
    assert state.step == len(source) >= 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)


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
