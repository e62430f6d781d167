"""The port's 2-D (data x model) mesh (parallel/shardings.py, the model-axis collectives,
the data-group paths of losses.py and train/step.py and the sharded clip of
train/optim.py) against the JAX package's `make_2d_mesh(2, 2)` + `shard_state_tp` step on
the conftest's virtual devices and against the port's own one-process step.

Four gloo ranks run in a subprocess (tests/_torch_dp_worker.py, which blocks JAX there) on
the tiny spec at `min_channels=128`, as tests/test_parallel.py's 2-D test shards it: one
Adam step at learning rate 1e-3, accum 1 and accum 2. Tolerances are that test's: loss
rel 1e-5, parameters rtol 1e-4 and atol 5e-6; the model ranks of one data rank must hold
bit-equal replicated parameters and moments, and the data ranks of one model rank
bit-equal shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ssd_object_detection_tpu.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu.models.ssd import SSD as JaxSSD
from ssd_object_detection_tpu.ops.anchors import generate_anchors
from ssd_object_detection_tpu.parallel.shardings import make_2d_mesh as jax_make_2d_mesh
from ssd_object_detection_tpu.parallel.shardings import shard_batch_2d as jax_shard_batch_2d
from ssd_object_detection_tpu.parallel.shardings import shard_params_tp as jax_shard_params_tp
from ssd_object_detection_tpu.parallel.shardings import shard_state_tp as jax_shard_state_tp
from ssd_object_detection_tpu.train.optim import make_optimizer as jax_make_optimizer
from ssd_object_detection_tpu.train.step import StepConfig as JaxStepConfig
from ssd_object_detection_tpu.train.step import create_train_state as jax_create_state
from ssd_object_detection_tpu.train.step import make_train_step as jax_make_train_step
from ssd_object_detection_tpu_torch.models.convert import from_flax_params
from ssd_object_detection_tpu_torch.models.ssd import SSD
from ssd_object_detection_tpu_torch.parallel.mesh import Mesh
from ssd_object_detection_tpu_torch.parallel.shardings import (
    ColumnParallelConv2d,
    shard_params_tp,
    shard_state_tp,
)
from ssd_object_detection_tpu_torch.train.optim import make_optimizer
from ssd_object_detection_tpu_torch.train.step import StepConfig, TrainState, make_train_step
from tests.test_torch_parallel import finish_worker, start_worker
from tests.test_torch_train_step import PORT_TINY
from tests.test_torch_trunks import _specs
from tests.test_train_step import NUM_CLASSES, TINY_ANCHORS, TINY_MODEL

torch.set_num_threads(1)
MIN_CHANNELS = 128
CASES = (("accum1", 1), ("accum2", 2))


def _batch():
    ds = SyntheticDetectionDataset(num_images=8, image_size=64, max_gt=4, num_classes=8, seed=5)
    return next(ds.batches(batch_size=8))


def _jax_2d_step(jax_model, params, batch, accum):
    tx = jax_make_optimizer("adam", 1e-3)
    step = jax_make_train_step(jax_model.apply, generate_anchors(TINY_ANCHORS), tx,
                               JaxStepConfig(accum_steps=accum))
    mesh = jax_make_2d_mesh(2, 2)
    state = jax_shard_state_tp(jax_create_state(params, tx), mesh, min_channels=MIN_CHANNELS)
    state, metrics = step(state, jax_shard_batch_2d({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    return ({k: float(v) for k, v in metrics.items()},
            from_flax_params(jax.tree.map(np.asarray, state.params)))


def _port_step(state_dict, batch, accum):
    model = SSD(num_classes=NUM_CLASSES, spec=PORT_TINY)
    model.load_state_dict(state_dict)
    state = TrainState(model=model, optimizer=make_optimizer("adam", model.parameters()),
                       schedule=lambda step: 1e-3)
    metrics = make_train_step(generate_anchors(TINY_ANCHORS), StepConfig(accum_steps=accum))(state, batch)
    return {k: float(v) for k, v in metrics.items()}, model.state_dict()


def _jax_dense_sharded(params, tp: int = 2):
    """JAX's own placement (shard_params_tp on a (2, tp) mesh) restricted to dense conv
    kernels, as port module names (in flax's sorted order): the leaves named `kernel` that
    landed on the model axis, less depthwise ones ((kh, kw, 1, C) with C > 1)."""
    placed = jax_shard_params_tp(params, jax_make_2d_mesh(2, tp), min_channels=MIN_CHANNELS)
    names = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        keys = [p.key for p in path]
        if keys[-1] != "kernel" or "model" not in tuple(leaf.sharding.spec):
            continue
        if leaf.shape[2] == 1 and leaf.shape[3] > 1:
            continue
        names.append(".".join(keys[1:-1]))
    return names


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("tp")
    jax_model = JaxSSD(num_classes=NUM_CLASSES, spec=TINY_MODEL)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    state_dict = from_flax_params(jax.tree.map(np.asarray, params))
    batch = _batch()
    inputs = {"spec": PORT_TINY, "num_classes": NUM_CLASSES, "state_dict": state_dict,
              "anchors": generate_anchors(TINY_ANCHORS), "batch": batch,
              "min_channels": MIN_CHANNELS,
              "cases": [{"name": name, "accum": accum} for name, accum in CASES]}
    torch.save(inputs, tmp_path / "inputs.pt")
    proc = start_worker(["tp", tmp_path / "inputs.pt", tmp_path / "out.pt"], tmp_path)
    # the references, computed while the ranks run
    jax_out = {name: _jax_2d_step(jax_model, params, batch, accum) for name, accum in CASES}
    one = {name: _port_step(state_dict, batch, accum) for name, accum in CASES}
    jax_names = _jax_dense_sharded(params)
    finish_worker(proc)
    ranks = [torch.load(f"{tmp_path / 'out.pt'}.r{r}", weights_only=False) for r in range(4)]
    return {"jax": jax_out, "one": one, "ranks": ranks, "jax_names": jax_names}


def test_rank_layout(tp):
    """Global rank d * 2 + m is data rank d, model rank m."""
    assert [r["coords"] for r in tp["ranks"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_2x2_step_matches_the_jax_2d_mesh_and_one_process(tp, name):
    (jax_metrics, jax_params), (one_metrics, one_params) = tp["jax"][name], tp["one"][name]
    for rank in tp["ranks"]:
        got = rank[name]
        assert got["metrics"] == tp["ranks"][0][name]["metrics"]  # global, on every rank
        for label, metrics in (("jax make_2d_mesh(2, 2)", jax_metrics), ("one process", one_metrics)):
            for key, want in metrics.items():
                assert got["metrics"][key] == pytest.approx(want, rel=1e-5), (label, key)
            assert got["metrics"]["num_positive"] == metrics["num_positive"], label
        assert set(got["unsharded"]) == set(jax_params) == set(one_params)
        for key, value in got["unsharded"].items():
            np.testing.assert_allclose(value.numpy(), np.asarray(jax_params[key]), rtol=1e-4, atol=5e-6,
                                       err_msg=f"jax make_2d_mesh(2, 2): {key}")
            np.testing.assert_allclose(value.numpy(), one_params[key].numpy(), rtol=1e-4, atol=5e-6,
                                       err_msg=f"one process: {key}")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_replicas_are_bit_equal(tp, name):
    """The model ranks of a data rank hold bit-equal replicated parameters and Adam
    moments; the data ranks of a model rank hold bit-equal shards and moments; every
    rank unshards to the same state dict."""
    ranks = [r[name] for r in tp["ranks"]]
    sharded = {f"{n}.{leaf}" for n in ranks[0]["names"] for leaf in ("weight", "bias")}
    for a, b in ((0, 1), (2, 3)):  # model ranks of data ranks 0 and 1
        for key, value in ranks[a]["params"].items():
            if key not in sharded:
                assert torch.equal(value, ranks[b]["params"][key]), (a, b, key)
                assert all(torch.equal(x, y) for x, y in zip(ranks[a]["moments"][key], ranks[b]["moments"][key]))
    for a, b in ((0, 2), (1, 3)):  # data ranks of model ranks 0 and 1
        for key, value in ranks[a]["params"].items():
            assert torch.equal(value, ranks[b]["params"][key]), (a, b, key)
            assert all(torch.equal(x, y) for x, y in zip(ranks[a]["moments"][key], ranks[b]["moments"][key]))
    for r in ranks[1:]:
        assert all(torch.equal(v, r["unsharded"][k]) for k, v in ranks[0]["unsharded"].items())
    for key in sharded:  # each model rank holds its half of the output channels
        full = ranks[0]["unsharded"][key]
        half = full.shape[0] // 2
        assert torch.equal(ranks[0]["params"][key], full[:half])
        assert torch.equal(ranks[1]["params"][key], full[half:])


def test_sharded_convs_follow_jax_rule_over_dense_kernels(tp):
    names = tp["ranks"][0]["accum1"]["names"]
    assert sorted(names) == sorted(tp["jax_names"])
    assert "extra0_conv0" in names and "vgg.block2_conv1" in names
    assert not any("head" in n for n in names)  # the tiny heads are 16 and 36 wide


def test_column_parallel_conv_matches_nn_conv2d(tp):
    """One ColumnParallelConv2d on 2 model ranks: the gathered output, the input gradient
    (summed over the model group) and this rank's weight and bias gradients against the
    whole nn.Conv2d, in float32; the output stays channels-last."""
    for rank in tp["ranks"]:
        c = rank["cp_conv"]
        assert c["channels_last"]
        for got, want in (("y", "y_want"), ("dx", "dx_want"), ("dw", "dw_want"), ("db", "db_want")):
            torch.testing.assert_close(c[got], c[want], rtol=1e-5, atol=1e-5, msg=got)


def test_ranks_import_no_jax(tp):
    assert [r["forbidden"] for r in tp["ranks"]] == [[]] * 4


def test_adam_moments_are_sliced_not_reset():
    """shard_state_tp after a step: each sharded parameter's moments are its channels of
    the old ones, the step count is kept, and the optimizer holds the new parameters."""
    model = SSD(num_classes=NUM_CLASSES, spec=PORT_TINY).init_weights(torch.Generator().manual_seed(0))
    state = TrainState(model=model, optimizer=make_optimizer("adam", model.parameters()),
                       schedule=lambda step: 1e-3)
    make_train_step(generate_anchors(TINY_ANCHORS), StepConfig())(state, _batch())
    before = {n: {k: v.clone() for k, v in state.optimizer.state[p].items()}
              for n, p in model.named_parameters()}
    mesh = Mesh(rank=0, size=1, device=torch.device("cpu"), tp_rank=1, tp_size=2)
    names = shard_state_tp(state, mesh, MIN_CHANNELS)
    assert names and state.step == 1
    params = list(model.parameters())
    assert [p for g in state.optimizer.param_groups for p in g["params"]] == params
    assert set(state.optimizer.state) == set(params)
    for n, p in model.named_parameters():
        after, old = state.optimizer.state[p], before[n]
        assert torch.equal(after["step"], old["step"])
        if n.rsplit(".", 1)[0] in names:
            half = old["exp_avg"].shape[0] // 2
            assert p.shape[0] == half
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(after[k], old[k][half:]), (n, k)
                assert after[k].abs().sum() > 0, (n, k)  # moments, not zeros
        else:
            assert all(torch.equal(after[k], old[k]) for k in old)


def test_grouped_convs_and_group_norm_stay_replicated():
    """MobileNetV2 (depthwise convs, GroupNorm): the port shards the dense convs that
    JAX's rule shards, and no depthwise conv."""
    port_spec, jax_spec = _specs("mobilenetv2")
    params = JaxSSD(num_classes=NUM_CLASSES, spec=jax_spec).init(jax.random.PRNGKey(0),
                                                                 jnp.zeros((1, 64, 64, 3)))
    model = SSD(num_classes=NUM_CLASSES, spec=port_spec)
    mesh = Mesh(rank=0, size=1, device=torch.device("cpu"), tp_rank=0, tp_size=2)
    names = shard_params_tp(model, mesh, MIN_CHANNELS)
    assert sorted(names) == sorted(_jax_dense_sharded(params))
    cp = [m for m in model.modules() if isinstance(m, ColumnParallelConv2d)]
    assert len(cp) == len(names) > 0
    assert all(m.groups == 1 for m in cp)
    assert any(isinstance(m, nn.Conv2d) and m.groups > 1 and m.out_channels >= MIN_CHANNELS
               for m in model.modules())
