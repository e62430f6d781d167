"""Port optimizer pieces and train step against the JAX package on identical inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssd_object_detection_tpu.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu.models.ssd import SSD as JaxSSD
from ssd_object_detection_tpu.ops.anchors import generate_anchors
from ssd_object_detection_tpu.train import optim as jax_optim
from ssd_object_detection_tpu.train.step import StepConfig as JaxStepConfig
from ssd_object_detection_tpu.train.step import create_train_state as jax_create_state
from ssd_object_detection_tpu.train.step import make_train_step as jax_make_train_step
from ssd_object_detection_tpu_torch.models.convert import from_flax_params
from ssd_object_detection_tpu_torch.models.ssd import SSD, ModelSpec
from ssd_object_detection_tpu_torch.ops.anchors import AnchorSpec
from ssd_object_detection_tpu_torch.train import optim
from ssd_object_detection_tpu_torch.train.step import StepConfig, TrainState, make_train_step
from tests.test_train_step import NUM_CLASSES, TINY_ANCHORS, TINY_MODEL

torch.set_num_threads(1)

PORT_TINY = ModelSpec(
    name=TINY_MODEL.name,
    anchor_spec=AnchorSpec(**{f: getattr(TINY_ANCHORS, f) for f in
                              ("image_size", "feature_sizes", "scale_refs", "aspect_ratios")}),
    blocks=TINY_MODEL.blocks,
)


def test_schedules_match_jax():
    pairs = [
        (optim.exponential_decay(1e-3, 100, 0.99), jax_optim.exponential_decay(1e-3, 100, 0.99)),
        (optim.exponential_decay(1e-3, 7, 0.5, staircase=True),
         jax_optim.exponential_decay(1e-3, 7, 0.5, staircase=True)),
        (optim.polynomial_decay(1e-6, 500, 1e-3), jax_optim.polynomial_decay(1e-6, 500, 1e-3)),
        (optim.polynomial_decay(1e-2, 50, 1e-4, power=2.0), jax_optim.polynomial_decay(1e-2, 50, 1e-4, 2.0)),
    ]
    for port, ref in pairs:
        for step in (0, 1, 13, 50, 250, 500, 1000):
            # float32 on both sides; pow may differ by an ulp between numpy and XLA
            assert port(step) == pytest.approx(float(ref(jnp.int32(step))), rel=1e-6)


def test_clip_by_norm_per_tensor_matches_jax():
    rng = np.random.default_rng(0)
    grads = {"a": rng.normal(size=(10, 3)).astype(np.float32) * 3,
             "b": rng.normal(size=(4,)).astype(np.float32) * 1e-4}
    want = jax_optim.clip_by_norm_per_tensor({k: jnp.asarray(v) for k, v in grads.items()}, 0.01)
    got = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    optim.clip_by_norm_per_tensor(got.values(), 0.01)
    for k in grads:  # rtol 1e-6: the norm's float32 sum order differs
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    assert float(got["a"].norm()) == pytest.approx(0.01, rel=1e-5)  # big tensor scaled
    np.testing.assert_array_equal(got["b"].numpy(), grads["b"])  # small one untouched


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_matches_optax_over_steps(name):
    """Identical gradient sequences and schedule: Adam's eps placement and bias
    correction (or SGD with momentum) agree with optax step after step."""
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(6, 5)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(6)]
    schedule_np = optim.polynomial_decay(1e-3, 4, 1e-2)
    if name == "adam":
        tx = optax.adam(jax_optim.polynomial_decay(1e-3, 4, 1e-2), b1=0.9, b2=0.999, eps=1e-7)
    else:
        tx = optax.sgd(jax_optim.polynomial_decay(1e-3, 4, 1e-2), momentum=0.9)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    port = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = optim.make_optimizer(name, port.values(), momentum=0.9)
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for group in opt.param_groups:  # as the train step does: schedule(pre-update count)
            group["lr"] = schedule_np(step)
        for k, p in port.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in p0:  # float32 update arithmetic in another order: a few ulps per step
            np.testing.assert_allclose(port[k].detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-5, atol=1e-7)


def _capture_grads():
    """An optax transform whose state becomes the incoming (clipped, averaged) grads
    and whose updates are zero, so the JAX step exposes its gradients exactly."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _tiny_setup():
    jax_model = JaxSSD(num_classes=NUM_CLASSES, spec=TINY_MODEL)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    port = SSD(num_classes=NUM_CLASSES, spec=PORT_TINY)
    port.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jax_model, params, port


def _port_step(port, batch, accum_steps):
    state = TrainState(model=port, optimizer=torch.optim.SGD(port.parameters(), lr=0.0),
                       schedule=lambda step: 0.0)
    step_fn = make_train_step(generate_anchors(TINY_ANCHORS), StepConfig(accum_steps=accum_steps))
    metrics = step_fn(state, batch)
    assert state.step == 1
    return metrics, {name: p.grad.clone() for name, p in port.named_parameters()}


@pytest.mark.parametrize("accum_steps", [1, 2, 3])
def test_train_step_loss_and_clipped_grads_match_jax(accum_steps):
    """One step from identical params and batch. Gradients are compared before the
    optimizer: Adam's first step is sign-like, so ulp noise would flip params.
    accum_steps 3 divides by a divisor whose reciprocal is inexact."""
    jax_model, params, port = _tiny_setup()
    n = 6 if accum_steps == 3 else 4
    ds = SyntheticDetectionDataset(num_images=n, image_size=64, max_gt=4, num_classes=8, seed=5)
    batch = next(ds.batches(batch_size=n))
    tx = _capture_grads()
    jax_step = jax_make_train_step(jax_model.apply, generate_anchors(TINY_ANCHORS), tx,
                                   JaxStepConfig(accum_steps=accum_steps))
    new_state, want = jax_step(jax_create_state(params, tx), batch)
    want_grads = from_flax_params(jax.tree.map(np.asarray, new_state.opt_state))

    metrics, grads = _port_step(port, batch, accum_steps)
    # float32 forward/backward through convs summed in another order (measured: loss
    # terms within 1.1e-7 relative, clipped grads within 1.8e-8 absolute of |g| <= 1e-2)
    for key in want:
        assert float(metrics[key]) == pytest.approx(float(want[key]), rel=1e-6), key
    assert float(metrics["num_positive"]) == float(want["num_positive"])  # exact matcher
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=1e-4, atol=5e-8,
                                   err_msg=name)


def test_uint8_images_equal_float_images():
    """uint8 batches are scaled on the device: same step as the equivalent [0,1] batch."""
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 64, 64, 3), np.uint8)
    base = {
        "gt_cls": rng.integers(0, 8, (2, 4)).astype(np.int32),
        "gt_boxes": np.concatenate([rng.uniform(0.3, 0.7, (2, 4, 2)), rng.uniform(0.1, 0.3, (2, 4, 2))],
                                   -1).astype(np.float32),
        "gt_valid": np.ones((2, 4), bool),
    }
    _, _, port = _tiny_setup()
    m_f32, g_f32 = _port_step(port, dict(base, image=u8.astype(np.float32) / 255.0), 1)
    m_u8, g_u8 = _port_step(port, dict(base, image=u8), 1)
    for key in m_f32:
        assert float(m_f32[key]) == float(m_u8[key]), key  # identical inputs after scaling
    for name in g_f32:
        torch.testing.assert_close(g_u8[name], g_f32[name], rtol=0, atol=0)


def test_augment_raises():
    """StepConfig.augment takes the port's AugConfig and nothing else."""
    with pytest.raises(TypeError, match="AugConfig"):
        make_train_step(generate_anchors(TINY_ANCHORS), StepConfig(augment=object()))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_augmented_train_step_matches_jax(monkeypatch, accum_steps):
    """One augmented step (full recipe) from identical params and batch, the port's draws
    patched to those the JAX step makes from fold_in(PRNGKey(aug_seed), step): the
    tolerances of test_train_step_loss_and_clipped_grads_match_jax."""
    from ssd_object_detection_tpu.ops.augment import AugConfig as JaxAugConfig
    from ssd_object_detection_tpu_torch.ops import augment
    from tests.test_torch_augment import jax_draws

    jax_model, params, port = _tiny_setup()
    ds = SyntheticDetectionDataset(num_images=4, image_size=64, max_gt=4, num_classes=8, seed=9)
    batch = next(ds.batches(batch_size=4))
    batch["image"] = np.round(batch["image"] * 255.0).astype(np.uint8)
    aug_seed, cfg = 3, augment.AugConfig(crop_attempts=50)
    tx = _capture_grads()
    jax_step = jax_make_train_step(
        jax_model.apply, generate_anchors(TINY_ANCHORS), tx,
        JaxStepConfig(accum_steps=accum_steps, augment=JaxAugConfig(crop_attempts=50), aug_seed=aug_seed))
    new_state, want = jax_step(jax_create_state(params, tx), batch)
    want_grads = from_flax_params(jax.tree.map(np.asarray, new_state.opt_state))

    draws = jax_draws(jax.random.fold_in(jax.random.PRNGKey(aug_seed), 0), 4, cfg)
    seen = []

    def jax_keyed_draws(generator, batch_size, aug_cfg, device):
        seen.append((batch_size, aug_cfg))
        return draws

    monkeypatch.setattr(augment, "draw_augment", jax_keyed_draws)
    state = TrainState(model=port, optimizer=torch.optim.SGD(port.parameters(), lr=0.0),
                       schedule=lambda step: 0.0)
    step_fn = make_train_step(generate_anchors(TINY_ANCHORS),
                              StepConfig(accum_steps=accum_steps, augment=cfg, aug_seed=aug_seed))
    metrics = step_fn(state, batch)
    assert seen == [(4, cfg)]  # one draw for the whole batch, before the split
    for key in want:
        assert float(metrics[key]) == pytest.approx(float(want[key]), rel=1e-6), key
    assert float(metrics["num_positive"]) == float(want["num_positive"])
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-4, atol=5e-8,
                                   err_msg=name)


def test_augmentation_draws_are_keyed_on_the_step():
    """The generator is reseeded from (aug_seed, step): the same step draws the same
    augmentation whatever ran before, another step or seed draws another."""
    from ssd_object_detection_tpu_torch.ops import augment
    from ssd_object_detection_tpu_torch.train.step import step_seed

    cfg = augment.AugConfig(crop_attempts=50)

    def draws(seed, step):
        gen = torch.Generator().manual_seed(step_seed(seed, step))
        return augment.draw_augment(gen, 4, cfg, torch.device("cpu"))

    same = draws(0, 5), draws(0, 5)
    assert all(torch.equal(a, b) for a, b in zip(*same))
    assert not torch.equal(draws(0, 5).crop_rects, draws(0, 6).crop_rects)
    assert not torch.equal(draws(0, 5).crop_rects, draws(1, 5).crop_rects)
