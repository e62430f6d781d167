"""Port preprocessing (ops/preprocess.py) against the JAX package on identical inputs.

Tolerances: "gather" atol 1e-6 against JAX "gather" (the same float32 lerps; only
fused multiply-adds could differ); "matmul" atol 1e-5 against JAX "matmul" (the same
bf16 roundings of weights and intermediate, products exact in float32, at most two
nonzero terms per sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.ops import preprocess as jax_pre
from ssd_object_detection_tpu_torch.ops import preprocess

torch.set_num_threads(1)

TOL = {"gather": 1e-6, "matmul": 1e-5}


def _resize_both(images, method, out_size=300, canvas=(640, 640)):
    canvas_u8, sizes = preprocess.pack_canvas(images, canvas)
    got = preprocess.resize_bilinear_planar(torch.from_numpy(canvas_u8), torch.from_numpy(sizes),
                                            out_size, method=method)
    want = jax_pre.resize_bilinear_planar(jnp.asarray(canvas_u8), jnp.asarray(sizes),
                                          out_size, method=method)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("method", ["gather", "matmul"])
@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (300, 300), (123, 457), (37, 50)])
def test_resize_matches_jax(hw, method):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    got, want = _resize_both([rng.integers(0, 256, (*hw, 3), np.uint8)], method)
    assert got.shape == want.shape == (1, 300, 300, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL[method], rtol=0)


@pytest.mark.parametrize("method", ["gather", "matmul"])
def test_resize_mixed_batch_matches_jax(method):
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, hw + (3,), np.uint8)
              for hw in ((96, 128), (128, 72), (64, 64), (25, 91))]
    got, want = _resize_both(images, method, out_size=64, canvas=(128, 128))
    np.testing.assert_allclose(got, want, atol=TOL[method], rtol=0)


def test_identity_size_is_exact():
    img = np.random.default_rng(1).integers(0, 256, (64, 64, 3), np.uint8)
    canvas_u8, sizes = preprocess.pack_canvas([img], (80, 96))
    for method in ("gather", "matmul"):
        got = preprocess.resize_bilinear_planar(torch.from_numpy(canvas_u8),
                                                torch.from_numpy(sizes), 64, method=method)
        np.testing.assert_array_equal(got[0].numpy(), img.astype(np.float32) / 255.0)


def test_axis_grid_matches_jax():
    valid = np.int32([1, 7, 300, 457, 640])
    for got, want in zip(preprocess._axis_grid(torch.from_numpy(valid), 300),
                         jax_pre._axis_grid(jnp.asarray(valid), 300)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_normalize01_and_unknown_method():
    x = np.random.default_rng(2).uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(preprocess.normalize01(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_pre.normalize01(jnp.asarray(x))))
    canvas_u8, sizes = preprocess.pack_canvas([np.zeros((4, 4, 3), np.uint8)], (8, 8))
    with pytest.raises(ValueError, match="unknown resize method"):
        preprocess.resize_bilinear_planar(torch.from_numpy(canvas_u8), torch.from_numpy(sizes),
                                          4, method="nearest")


def test_pack_canvas_matches_jax_and_rejects_oversize():
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, hw + (3,), np.uint8) for hw in ((10, 20), (30, 5))]
    for got, want in zip(preprocess.pack_canvas(images, (32, 32)),
                         jax_pre.pack_canvas(images, (32, 32))):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="exceeds canvas"):
        preprocess.pack_canvas([np.zeros((33, 8, 3), np.uint8)], (32, 32))
