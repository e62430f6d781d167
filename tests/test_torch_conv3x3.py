"""Port fused conv3x3 op (ops/conv3x3.py) against the JAX package on identical inputs.

The JAX op `conv3x3_bias_relu` runs its Pallas kernel in interpret mode on the CPU, as
tests/test_pallas_conv.py runs it; `_conv3x3_xla` is its XLA reference. On the CPU the
port's op runs its plain version (the CUDA kernel is held to it on the card,
tests/test_torch_cuda_conv.py and chip_smoke.py).

Tolerances: float32 atol 1e-5 (XLA's and oneDNN's convolutions sum in different
orders), as in tests/test_pallas_conv.py; bf16 at most one bf16 ulp of the value (the
float32 sums differ in order, then both round once to bf16); gradients atol 1e-4, as
in tests/test_pallas_conv.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.ops.pallas_conv import _conv3x3_pallas, _conv3x3_xla
from ssd_object_detection_tpu.ops.pallas_conv import conv3x3_bias_relu as jax_conv
from ssd_object_detection_tpu_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_plain

torch.set_num_threads(1)


def _inputs(rng, b=1, h=8, w=8, ic=8, oc=8):
    x = rng.standard_normal((b, h, w, ic)).astype(np.float32)
    k = (rng.standard_normal((3, 3, ic, oc)) * 0.1).astype(np.float32)
    bias = rng.standard_normal((oc,)).astype(np.float32)
    return x, k, bias


def _port(fn, x, k, b, relu, pool, dtype=torch.float32):
    return fn(torch.from_numpy(x).to(dtype), torch.from_numpy(k), torch.from_numpy(b), relu, pool)


@pytest.mark.parametrize("relu,pool", [(False, False), (True, False), (True, True)])
def test_matches_jax(relu, pool):
    x, k, b = _inputs(np.random.default_rng(0), b=2, h=8, w=8)
    want_xla = np.asarray(_conv3x3_xla(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), relu, pool))
    want_pallas = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), relu, pool))
    for fn in (conv3x3_plain, conv3x3_bias_relu):
        got = _port(fn, x, k, b, relu, pool).numpy()
        assert got.shape == want_xla.shape
        np.testing.assert_allclose(got, want_xla, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=0)


def test_matches_jax_multi_tile():
    """12 rows: the JAX kernel stitches three 4-row tiles through its halo rows."""
    x, k, b = _inputs(np.random.default_rng(1), h=12, w=8)
    want = np.asarray(_conv3x3_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                      relu=True, pool=False, row_tile=4))
    got = _port(conv3x3_bias_relu, x, k, b, True, False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("relu,pool", [(True, False), (False, True)])
def test_bf16_matches_jax(relu, pool):
    x, k, b = _inputs(np.random.default_rng(4), b=2, h=6, w=10, ic=16, oc=8)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(_conv3x3_xla(x16, jnp.asarray(k), jnp.asarray(b), relu, pool)
                      .astype(jnp.float32))
    got = _port(conv3x3_bias_relu, np.array(x16.astype(jnp.float32)), k, b, relu, pool,
                dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


def test_gradients_match_jax():
    x, k, b = _inputs(np.random.default_rng(2))

    def loss_jax(x, k, b):
        return jnp.sum(jax_conv(x, k, b, True, True) ** 2)

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    (conv3x3_bias_relu(*leaves, True, True) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_gradient_only_where_asked():
    x, k, b = (torch.from_numpy(a) for a in _inputs(np.random.default_rng(5)))
    k.requires_grad_()
    conv3x3_bias_relu(x, k, b, True, False).sum().backward()
    assert k.grad is not None and x.grad is None and b.grad is None


def test_pool_rejects_odd_extent():
    x, k, b = _inputs(np.random.default_rng(3), h=7, w=8)
    with pytest.raises(ValueError, match="even"):
        _port(conv3x3_bias_relu, x, k, b, True, True)


def test_other_devices_go_to_the_kernel_wrapper():
    """Only a CPU tensor takes the plain version; any other device reaches the CUDA
    wrapper, which refuses what is not on the card."""
    x, k, b = (torch.from_numpy(a).to("meta") for a in _inputs(np.random.default_rng(6)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv3x3_bias_relu(x, k, b, True, False)
