"""Keras .h5 import of the port (models/import_keras.py) against the JAX package's on the
same files: the three h5 layouts, the positional mapping, the shape checks, the
Trainer's `pretrained_vgg` and its refusal on a non-VGG trunk, and the error that names
h5py where it is missing. The fixtures are written here with h5py (the cases of
tests/test_import_keras.py); nothing is downloaded. Weights compare bit for bit: the
port holds the same float32 values, transposed HWIO -> OIHW."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.models import import_keras as jax_import
from ssd_object_detection_tpu.models.ssd import SSD as JaxSSD
from ssd_object_detection_tpu.models.ssd import SSD300_SPEC_MODEL as JAX_SSD300
from ssd_object_detection_tpu_torch.models import import_keras
from ssd_object_detection_tpu_torch.models.convert import from_flax_params, to_flax_params
from ssd_object_detection_tpu_torch.models.ssd import SSD
from ssd_object_detection_tpu_torch.train.loop import Trainer
from tests.test_import_keras import (
    _TRUNK_SHAPES,
    _all_conv_shapes,
    _rand,
    _write_keras3_vars_h5,
    _write_legacy_h5,
)
from tests.test_torch_trainer import _tiny_config

h5py = pytest.importorskip("h5py")
torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def flax_params():
    return JaxSSD(num_classes=81, spec=JAX_SSD300).init(jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3)))


@pytest.fixture(scope="module")
def port_state(flax_params):
    return from_flax_params(jax.tree.map(np.asarray, flax_params))


def _assert_same_as_jax(port_state, jax_params):
    """Every tensor of the port's state equals the JAX import's leaf (HWIO -> OIHW)."""
    want = from_flax_params(jax.tree.map(np.asarray, jax_params))
    assert set(port_state) == set(want)
    for key, value in want.items():
        assert torch.equal(port_state[key], value), key


@pytest.mark.parametrize("suffix", [":0", ""])
def test_full_import_legacy_layout(tmp_path, flax_params, port_state, suffix):
    path = str(tmp_path / "ref.h5")
    made = _write_legacy_h5(path, np.random.default_rng(0), suffix=suffix)
    got = import_keras.load_reference_ssd_h5(port_state, path)
    _assert_same_as_jax(got, jax_import.load_reference_ssd_h5(flax_params, path))
    np.testing.assert_array_equal(got["extra0_conv0.weight"].numpy(),
                                  made["conv2d"][0].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["conf_head5.weight"].numpy(),
                                  made["conv2d_24"][0].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["extra5_conv1.bias"].numpy(), made["conv2d_12"][1])


def test_full_import_keras3_vars_layout(tmp_path, flax_params, port_state):
    path = str(tmp_path / "k3.h5")
    made = _write_keras3_vars_h5(path, np.random.default_rng(1))
    got = import_keras.load_reference_ssd_h5(port_state, path)
    _assert_same_as_jax(got, jax_import.load_reference_ssd_h5(flax_params, path))
    np.testing.assert_array_equal(got["vgg.block3_conv3.weight"].numpy(),
                                  made["block3_conv3"][0].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["conf_head0.bias"].numpy(), made["conv2d_19"][1])


def test_full_import_into_a_model_loads_it_in_place(tmp_path):
    path = str(tmp_path / "ref.h5")
    made = _write_legacy_h5(path, np.random.default_rng(5))
    model = SSD(num_classes=81)
    assert import_keras.load_reference_ssd_h5(model, path) is model
    np.testing.assert_array_equal(model.loc_head0.weight.detach().numpy(),
                                  made["conv2d_13"][0].transpose(3, 2, 0, 1))


def _bad_pyramid_h5(path, rng):
    shapes = _all_conv_shapes()
    shapes[0] = (3, 3, 256, 99)  # wrong pyramid conv
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        g = mw.create_group("trunk")
        wn = []
        for lname, shape in _TRUNK_SHAPES.items():
            g.create_dataset(f"{lname}/kernel", data=_rand(shape, rng))
            g.create_dataset(f"{lname}/bias", data=_rand((shape[-1],), rng))
            wn += [f"{lname}/kernel", f"{lname}/bias"]
        g.attrs["weight_names"] = np.array([n.encode() for n in wn])
        names = ["trunk"]
        for i, shape in enumerate(shapes):
            lname = f"conv2d_{i}" if i else "conv2d"
            lg = mw.create_group(lname)
            lg.create_dataset(f"{lname}/kernel", data=_rand(shape, rng))
            lg.create_dataset(f"{lname}/bias", data=_rand((shape[-1],), rng))
            lg.attrs["weight_names"] = np.array([f"{lname}/kernel".encode(), f"{lname}/bias".encode()])
            names.append(lname)
        mw.attrs["layer_names"] = np.array([n.encode() for n in names])


def test_full_import_shape_mismatch_raises(tmp_path, flax_params):
    path = str(tmp_path / "bad.h5")
    _bad_pyramid_h5(path, np.random.default_rng(2))
    with pytest.raises(ValueError):
        jax_import.load_reference_ssd_h5(flax_params, path)
    model = SSD(num_classes=81)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="extra0_conv0"):
        import_keras.load_reference_ssd_h5(model, path)
    for key, value in model.state_dict().items():  # a failed import changes nothing
        assert torch.equal(value, before[key]), key


def test_full_import_wrong_conv_count_raises(tmp_path, port_state):
    path = str(tmp_path / "ref.h5")
    _write_legacy_h5(path, np.random.default_rng(6))
    with h5py.File(path, "a") as f:
        del f["model_weights"]["conv2d_24"]
    with pytest.raises(ValueError, match="24 non-trunk convs; model expects 25"):
        import_keras.load_reference_ssd_h5(port_state, path)


def _trunk_h5(path, rng, shapes=_TRUNK_SHAPES):
    with h5py.File(path, "w") as f:
        for lname, shape in shapes.items():
            g = f.create_group(lname).create_group(lname)
            g.create_dataset("kernel:0", data=_rand(shape, rng))
            g.create_dataset("bias:0", data=_rand((shape[-1],), rng))


def test_trunk_only_import_legacy(tmp_path, flax_params, port_state):
    path = str(tmp_path / "vgg.h5")
    _trunk_h5(path, np.random.default_rng(3))
    got = import_keras.load_vgg16_trunk_into(port_state, path)
    _assert_same_as_jax(got, jax_import.load_vgg16_trunk_into(flax_params, path))
    assert tuple(got["vgg.block1_conv1.weight"].shape) == (64, 3, 3, 3)


def test_trunk_only_import_other_layouts(tmp_path):
    """Keras 3 `vars/{0,1}` and the `weight_names` attribute give the same weights."""
    rng = np.random.default_rng(7)
    made = {n: (_rand(s, rng), _rand((s[-1],), rng)) for n, s in _TRUNK_SHAPES.items()}
    paths = [str(tmp_path / "k3.h5"), str(tmp_path / "wn.h5")]
    with h5py.File(paths[0], "w") as f:
        for name, (k, b) in made.items():
            sub = f.create_group(name).create_group("vars")
            sub.create_dataset("0", data=k)
            sub.create_dataset("1", data=b)
    with h5py.File(paths[1], "w") as f:
        for name, (k, b) in made.items():
            g = f.create_group(name)
            g.create_dataset("w/k", data=k)
            g.create_dataset("w/b", data=b)
            g.attrs["weight_names"] = np.array([b"w/k", b"w/b"])
    for path in paths:
        weights = import_keras.load_vgg16_trunk_weights(path)
        for name, (k, b) in made.items():
            np.testing.assert_array_equal(weights[name]["kernel"], k)
            np.testing.assert_array_equal(weights[name]["bias"], b)


def test_trunk_import_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "bad_vgg.h5")
    _trunk_h5(path, np.random.default_rng(4), dict(_TRUNK_SHAPES, block2_conv1=(3, 3, 64, 99)))
    model = SSD(num_classes=81)
    with pytest.raises(ValueError, match="block2_conv1"):
        import_keras.load_vgg16_trunk_into(model, path)


def test_trainer_pretrained_vgg_loads_the_trunk(tmp_path):
    """`model.pretrained_vgg` puts the .h5 trunk into the Trainer's model (the tiny
    spec has the full VGG trunk); a non-VGG variant raises ValueError, as in JAX."""
    from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS

    path = str(tmp_path / "vgg.h5")
    _trunk_h5(path, np.random.default_rng(8))
    trainer = Trainer(_tiny_config(tmp_path, **{"model.pretrained_vgg": path}),
                      run_dir=str(tmp_path / "run"), device="cpu")
    weights = import_keras.load_vgg16_trunk_weights(path)
    for name, w in weights.items():
        got = getattr(trainer.model.vgg, name)
        np.testing.assert_array_equal(got.weight.detach().numpy(), w["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got.bias.detach().numpy(), w["bias"])
    assert trainer.train().step == 2  # and it trains

    MODEL_SPECS.setdefault("tiny-r34-test-torch", MODEL_SPECS["ssd300_r34"])
    cfg = _tiny_config(tmp_path, **{"model.pretrained_vgg": path,
                                    "model.variant": "tiny-r34-test-torch"})
    with pytest.raises(ValueError, match="resnet34"):
        Trainer(cfg, run_dir=str(tmp_path / "r34"), device="cpu")


def test_round_trip_through_flax_layout(tmp_path, port_state):
    """The imported state converts to the flax tree the JAX import returns."""
    path = str(tmp_path / "vgg.h5")
    _trunk_h5(path, np.random.default_rng(9))
    tree = to_flax_params(import_keras.load_vgg16_trunk_into(port_state, path))
    weights = jax_import.load_vgg16_trunk_weights(path)
    for name, w in weights.items():
        np.testing.assert_array_equal(tree["params"]["vgg"][name]["kernel"], w["kernel"])


def test_missing_h5py_raises_an_error_that_names_it():
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "from ssd_object_detection_tpu_torch.models import import_keras\n"
        "try:\n"
        "    import_keras.load_vgg16_trunk_weights('x.h5')\n"
        "except ImportError as e:\n"
        "    assert e.name == 'h5py' and 'h5py' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('no error without h5py')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
