"""Port MultiBox loss against the JAX loss: values and gradients, both modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.losses import multibox_loss as jax_loss
from ssd_object_detection_tpu_torch.losses import multibox_loss

torch.set_num_threads(1)

# float32 sums over the batch are taken in different orders by XLA and PyTorch.
RTOL, ATOL = 1e-5, 1e-7


def _case(seed, B=2, D=64, C=11, pos_p=0.1):
    rng = np.random.default_rng(seed)
    gt_cls = rng.integers(0, C - 1, (B, D)).astype(np.int32)
    gt_loc = rng.normal(size=(B, D, 4)).astype(np.float32)
    mask = rng.uniform(size=(B, D)) < pos_p
    mask[0, 0] = True
    pred_loc = rng.normal(size=(B, D, 4)).astype(np.float32)
    logits = (rng.normal(size=(B, D, C)) * 3).astype(np.float32)
    return gt_cls, gt_loc, mask, pred_loc, logits


def _compare(case, canonical):
    gt_cls, gt_loc, mask, pred_loc, logits = case

    def jax_total(pl, lg):
        info = jax_loss(gt_cls, gt_loc, mask, pl, lg, canonical=canonical)
        return info.total, info

    (_, want), (g_loc, g_logits) = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pred_loc), jnp.asarray(logits)
    )
    pl = torch.from_numpy(pred_loc).requires_grad_()
    lg = torch.from_numpy(logits).requires_grad_()
    got = multibox_loss(torch.from_numpy(gt_cls), torch.from_numpy(gt_loc), torch.from_numpy(mask),
                        pl, lg, canonical=canonical)
    got.total.backward()
    for field in got._fields:
        np.testing.assert_allclose(float(getattr(got, field).detach()), float(getattr(want, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    np.testing.assert_allclose(pl.grad.numpy(), np.asarray(g_loc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(g_logits), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_loss_and_grads_match_jax(seed, canonical):
    _compare(_case(seed), canonical)


@pytest.mark.parametrize("canonical", [False, True])
def test_zero_positives_all_terms_zero(canonical):
    gt_cls, gt_loc, mask, pred_loc, logits = _case(5)
    mask[:] = False
    _compare((gt_cls, gt_loc, mask, pred_loc, logits), canonical)
    info = multibox_loss(torch.from_numpy(gt_cls), torch.from_numpy(gt_loc), torch.from_numpy(mask),
                         torch.from_numpy(pred_loc), torch.from_numpy(logits), canonical=canonical)
    assert float(info.total) == float(info.loc) == float(info.cls_pos) == 0.0


@pytest.mark.parametrize("canonical", [False, True])
def test_ties_at_mining_threshold(canonical):
    """Identical negative logits tie at the mining threshold: the reference mode admits
    every tied negative (more than 3 * num_pos), canonical mode ranks ties stably."""
    gt_cls, gt_loc, mask, pred_loc, _ = _case(6, B=2, D=32, C=4)
    mask[:] = False
    mask[0, :2] = True
    logits = np.zeros((2, 32, 4), np.float32)  # every negative has the same bg CE
    _compare((gt_cls, gt_loc, mask, pred_loc, logits), canonical)
    if not canonical:
        got = multibox_loss(torch.from_numpy(gt_cls), torch.from_numpy(gt_loc), torch.from_numpy(mask),
                            torch.from_numpy(pred_loc), torch.from_numpy(logits))
        assert float(got.cls_neg) == pytest.approx(np.log(4.0), rel=1e-6)  # mean over all ties
