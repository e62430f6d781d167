"""The port's reference-API facade (compat.py) against the JAX package's, case by case as
tests/test_compat.py runs it, with parity where both compute the same thing: the prior
box, the `.msgpack` weights each saves and the other loads, predict on the same weights,
the rendered panels and the parameter count."""

import logging

import jax
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.compat import SSDObjectDetectionModel as JaxModel
from ssd_object_detection_tpu.models.ssd import MODEL_SPECS as JAX_SPECS
from ssd_object_detection_tpu_torch.compat import SSDDataLoader, SSDObjectDetectionModel
from ssd_object_detection_tpu_torch.models.convert import from_flax_params
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS
from tests.test_torch_train_step import PORT_TINY
from tests.test_train_step import TINY_MODEL

torch.set_num_threads(1)
JAX_SPECS.setdefault("tiny-test", TINY_MODEL)
MODEL_SPECS.setdefault("tiny-test", PORT_TINY)


def _port(tmp_path):
    return SSDObjectDetectionModel(classes=8, log_dir=str(tmp_path), variant="tiny-test",
                                   precision="float32", device="cpu")


def _jax(tmp_path):
    return JaxModel(classes=8, log_dir=str(tmp_path), variant="tiny-test", precision="float32")


def _same_weights(tmp_path):
    """A JAX facade and a port facade holding its weights (through the JAX .msgpack)."""
    jm, pm = _jax(tmp_path), _port(tmp_path)
    path = str(tmp_path / "jax.msgpack")
    jm.save(path)
    pm.load(path)
    return jm, pm


def test_data_loader_rejects_unknown_dataset():
    with pytest.raises(ValueError):
        SSDDataLoader("/nonexistent", dataset="voc")


def test_model_constructor_and_accessors(tmp_path):
    m = _port(tmp_path)
    pb = m.get_prior_box()
    assert pb.shape == (TINY_MODEL.anchor_spec.num_anchors, 4)
    np.testing.assert_array_equal(pb, _jax(tmp_path).get_prior_box())
    assert str(tmp_path) in m.get_log_dir()
    model = m.get_model()
    assert sum(p.numel() for p in model.parameters()) > 0
    assert next(model.parameters()).device.type == "cpu"


def test_model_save_load_roundtrip_and_across_facades(tmp_path):
    """Port -> port bit-equal; a file the JAX facade saved loads in the port's, and one
    the port's saved loads in the JAX facade's, bit-equal."""
    m = _port(tmp_path)
    with torch.no_grad():
        for p in m.get_model().parameters():
            p.add_(0.25)  # not the seed-0 weights another facade starts from
    path = str(tmp_path / "w.msgpack")
    m.save(path)
    m2 = _port(tmp_path)
    m2.load(path)
    want = m.get_model().state_dict()
    for k, v in m2.get_model().state_dict().items():
        assert torch.equal(v, want[k]), k

    jm = _jax(tmp_path)
    jm.load(path)  # the port's file in the JAX facade
    got = from_flax_params(jax.tree.map(np.asarray, jm._params))
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k

    jax_path = str(tmp_path / "from_jax.msgpack")
    _jax(tmp_path).save(jax_path)
    m3 = _port(tmp_path)
    m3.load(jax_path)  # the JAX facade's file in the port's
    want = from_flax_params(jax.tree.map(np.asarray, _jax(tmp_path)._params))
    for k, v in m3.get_model().state_dict().items():
        assert torch.equal(v, want[k]), k


def test_model_predict_and_visualize(tmp_path):
    """predict against the JAX facade's on the same weights: classes and valid equal,
    boxes and scores within 1e-5; the prior-box panel equal to JAX's."""
    jm, pm = _same_weights(tmp_path)
    images = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    det = pm.predict(images)
    want = jm.predict(images)
    assert det.boxes.shape[0] == 2
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(det.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-5)
    assert pm.predict(images) is not det  # cached function, fresh result
    img = pm.visualize(np.zeros((64, 64, 3), np.float32), thresh=0.9)
    assert img.shape == (64, 64, 3)
    grid = pm.visualize_prior_box(max_cells=2)
    assert grid.shape[0] == 64
    np.testing.assert_array_equal(grid, jm.visualize_prior_box(max_cells=2))


def test_model_train_through_facade(tmp_path):
    """2 warmup steps (epoch 0) through the facade on synthetic data: the facade's model
    holds the trained weights, which the Trainer also exported."""
    m = _port(tmp_path)
    before = {k: v.clone() for k, v in m.get_model().state_dict().items()}
    cfg = SSDObjectDetectionModel.TrainConfig(
        epoch=0, batch_size=4, warmup=True, warmup_step=2, visualization_log_interval=0)
    state = m.train(data_loader=None, cfg=cfg)  # synthetic data (no dataset_root)
    assert state.step == 0  # the main phase starts fresh after warmup, as in JAX's Trainer
    after = m.get_model().state_dict()
    assert any(not torch.equal(after[k], v) for k, v in before.items())
    exported = _port(tmp_path)
    exported.load(str(tmp_path / m.get_log_dir().rsplit("/", 1)[1] / "model_last.msgpack"))
    for k, v in exported.get_model().state_dict().items():
        assert torch.equal(v, after[k]), k


def test_show_summary_and_log_writer(tmp_path, capsys):
    m = _port(tmp_path)
    table = m.show_summary()
    assert "TOTAL" in table and "weight" in table
    assert table in capsys.readouterr().out
    jax_table = _jax(tmp_path).show_summary()

    def total(t):
        return int(t.splitlines()[-1].split()[-1].replace(",", ""))

    assert total(table) == total(jax_table) == sum(p.numel() for p in m.get_model().parameters())
    assert len(table.splitlines()) == len(jax_table.splitlines())
    w = m.get_log_writer()
    assert w is not None and w is m.get_log_writer()  # cached
    w.close()


def test_log_writer_without_tensorboard_is_none(tmp_path, monkeypatch, caplog):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    m = _port(tmp_path)
    with caplog.at_level(logging.INFO, logger="ssd_object_detection_tpu_torch.compat"):
        assert m.get_log_writer() is None
    assert "tensorboard is not installed" in caplog.text


def test_visualize_dataset(tmp_path):
    jm, pm = _same_weights(tmp_path)
    batch = {
        "image": np.full((2, 64, 64, 3), 0.5, np.float32),
        "gt_cls": np.array([[1, 2], [3, 0]], np.int32),
        "gt_boxes": np.array(
            [[[0.5, 0.5, 0.3, 0.3], [0.2, 0.2, 0.1, 0.1]],
             [[0.7, 0.7, 0.2, 0.2], [0.0, 0.0, 0.0, 0.0]]], np.float32),
        "gt_valid": np.array([[True, True], [True, False]]),
    }
    imgs = pm.visualize_dataset([batch, batch], max_images=3)
    assert len(imgs) == 3
    assert imgs[0].shape == (64, 64, 3)
    for got, want in zip(imgs, jm.visualize_dataset([batch, batch], max_images=3)):
        np.testing.assert_array_equal(got, want)
