"""The CUDA matcher's launch plan and the plain PyTorch model of its algorithm, on the CPU.

The kernel itself (csrc/matcher.cu) runs only on the card. What the CPU can hold:
the model of its algorithm (ops/matcher_model.py: a key per ground-truth row, column
slices merged by the key, greedy steps on the keys, rescans on conflicts) is bit-equal
to the plain matcher for every cluster size; the 64-bit key orders (value, column)
pairs as the kernel's `better()` does; and the plan (ops/cuda_matcher.py::plan) covers
every column once, launches no more CTAs than the card holds at once and fits shared
memory. Tolerance:
gt_index, cls and mask bit-equal, box exactly equal. No JAX is needed here;
tests/test_torch_matching.py holds the plain matcher to JAX on the same cases.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu_torch.ops import cuda_matcher
from ssd_object_detection_tpu_torch.ops.anchors import SSD512_SPEC, generate_anchors
from ssd_object_detection_tpu_torch.ops.matcher_model import (
    COLUMN_FIELD, key_column, make_keys, match_anchors_model, ordered_bits, stress_cases,
)
from ssd_object_detection_tpu_torch.ops.plain_matcher import match_anchors

torch.set_num_threads(1)
CLUSTERS = (1, 2, 4, 8)


def _boxes(rng, shape, size=(0.05, 0.5)):
    return np.concatenate(
        [rng.uniform(0, 1, shape + (2,)), rng.uniform(*size, shape + (2,))], -1
    ).astype(np.float32)


def _random_case(seed, batch=3, n_gt=6, n_anchor=40, valid_p=0.7):
    rng = np.random.default_rng(seed)
    anchors = _boxes(rng, (n_anchor,))
    gt_boxes = _boxes(rng, (batch, n_gt))
    gt_cls = rng.integers(0, 80, (batch, n_gt)).astype(np.int32)
    gt_valid = rng.uniform(size=(batch, n_gt)) < valid_p
    gt_valid[:, 0] = True
    return gt_cls, gt_boxes, gt_valid, anchors


def _large_case():
    """12,700 anchors at G=100, ~12% valid."""
    rng = np.random.default_rng(7)
    anchors = _boxes(rng, (12700,), (0.03, 0.4))
    gt_boxes = _boxes(rng, (2, 100), (0.05, 0.4))
    gt_cls = rng.integers(0, 80, (2, 100)).astype(np.int32)
    return gt_cls, gt_boxes, rng.uniform(size=(2, 100)) < 0.12, anchors


def _golden_case():
    anchors = np.float32([[10, 10, 1, 1], [20, 20, 1.1, 1.1], [20, 20, 0.5, 0.5]])
    gt_boxes = np.float32([[[15, 15, 13, 13], [15, 15, 14, 14]]])
    return np.int32([[0, 1]]), gt_boxes, np.ones((1, 2), bool), anchors


def _zero_valid_case():
    anchors = np.float32([[0.5, 0.5, 0.2, 0.2], [0.2, 0.2, 0.1, 0.1]])
    return np.zeros((2, 3), np.int32), np.zeros((2, 3, 4), np.float32), np.zeros((2, 3), bool), anchors


# the cases of tests/test_torch_matching.py (which holds the plain matcher to JAX on them)
CASES = {
    **{f"seed{s}": (lambda s=s: _random_case(s)) for s in range(5)},
    "golden": _golden_case,
    "zero_valid": _zero_valid_case,
    "anchors130": lambda: _random_case(9, batch=2, n_gt=4, n_anchor=130),
    "anchors12700_g100": _large_case,
}


def _small_stress_cases():
    rng = np.random.default_rng(5)
    return stress_cases(_boxes(rng, (43,)), _boxes(rng, (130,)), max_gt=6, many=20)


STRESS = _small_stress_cases()


def _assert_model_equals_plain(arrays, thresh, cluster):
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]
    got, rescans = match_anchors_model(*args, thresh, cluster)
    want = match_anchors(*args, thresh)
    for field, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), field
    return rescans


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", list(CASES))
def test_model_equals_plain_matcher(name, cluster):
    _assert_model_equals_plain(CASES[name](), 0.5, cluster)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", list(STRESS))
def test_model_equals_plain_matcher_on_stress_cases(name, cluster):
    *arrays, thresh = STRESS[name]
    rescans = _assert_model_equals_plain(arrays, thresh, cluster)
    if name == "identical_gts":
        # image 0: all G rows identical, so after each pick but the last every remaining
        # row rescans: (G-1) + ... + 1 = 15 at G = 6; image 1 adds its two groups
        assert rescans >= 15


@pytest.mark.parametrize("cluster", CLUSTERS)
@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31), n_gt=st.integers(1, 6), n_anchor=st.integers(1, 8),
       thresh=st.sampled_from([0.5, 0.0, -1.5]))
def test_model_equals_plain_matcher_on_tie_heavy_boxes(cluster, seed, n_gt, n_anchor, thresh):
    """Boxes snapped to a quarter grid (sizes may be 0): equal IoUs everywhere, so every
    tie rule decides; with up to 6 GTs on up to 8 anchors, also more GTs than anchors."""
    rng = np.random.default_rng(seed)

    def grid(n):
        return np.concatenate([rng.integers(0, 5, (n, 2)), rng.integers(0, 4, (n, 2))],
                              -1).astype(np.float32) / 4

    gt_boxes = np.stack([grid(n_gt), grid(n_gt)])
    gt_cls = rng.integers(0, 5, (2, n_gt)).astype(np.int32)
    gt_valid = rng.uniform(size=(2, n_gt)) < 0.8
    _assert_model_equals_plain((gt_cls, gt_boxes, gt_valid, grid(n_anchor)), thresh, cluster)


def test_key_orders_pairs_as_the_kernels_better():
    """make_keys(v, i) > make_keys(w, j) exactly when better(v, i, w, j): the larger
    value, then the lower index; for negative values, zero sizes and duplicates too."""
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.uniform(0, 1, 40), rng.uniform(-2, 0, 10),
                             np.float32([-1.0, -1.0, 1e-20, 1e-20, 1.0, 0.5, 0.5, 3e38, -3e38])])
    values = torch.from_numpy(rng.permutation(values).astype(np.float32))
    index = torch.arange(values.numel())
    keys = make_keys(values, index)
    assert keys.dtype == torch.int64 and bool((keys > 0).all())
    better = (values[:, None] > values[None, :]) | (
        (values[:, None] == values[None, :]) & (index[:, None] < index[None, :]))
    assert torch.equal(keys[:, None] > keys[None, :], better)
    assert [key_column(int(k)) for k in keys] == index.tolist()
    # the value part alone orders values, and the largest column still fits its field
    bits = ordered_bits(values)
    assert torch.equal(bits[:, None] > bits[None, :], values[:, None] > values[None, :])
    assert bool(((bits >= 1) & (bits < 2**32)).all())
    top = make_keys(torch.tensor([1.0]), torch.tensor([COLUMN_FIELD - 1]))
    assert key_column(int(top[0])) == COLUMN_FIELD - 1 and int(top[0]) < 2**63


@pytest.mark.parametrize("num_anchors", [1, 3, 7, 8, 130, 4001, 8732, 24564])
@pytest.mark.parametrize("batch", [1, 8, 16, 17, 32, 33, 66, 67, 132, 160])
def test_plan_covers_every_column_once_within_the_card(batch, num_anchors):
    launch = cuda_matcher.plan(batch, 100, num_anchors, 132)
    slices = cuda_matcher.column_slices(num_anchors, launch.cluster)
    assert len(slices) == launch.cluster and launch.cluster in cuda_matcher.CLUSTER_SIZES
    covered = [c for start, stop in slices for c in range(start, stop)]
    assert covered == list(range(num_anchors))
    assert all(stop - start <= launch.slice_cols for start, stop in slices)
    assert slices[1:] == [(min(num_anchors, r * launch.slice_cols),
                           min(num_anchors, (r + 1) * launch.slice_cols))
                          for r in range(1, launch.cluster)]  # as the kernel cuts them
    assert launch.ctas == batch * launch.cluster

    def held_at_once(cluster):  # CTAs of that cluster size's thread count on 132 SMs
        return 132 * (cuda_matcher.RESIDENT_THREADS // cuda_matcher._threads(num_anchors, cluster))

    # every CTA is on the card at once (no second wave) unless even one per image is
    # too many, and no larger cluster would have been
    assert launch.ctas <= held_at_once(launch.cluster) or launch.cluster == 1
    for larger in cuda_matcher.CLUSTER_SIZES:
        if larger > launch.cluster:
            assert batch * larger > held_at_once(larger)
    assert launch.threads == cuda_matcher._threads(num_anchors, launch.cluster)
    assert launch.threads % 32 == 0
    assert cuda_matcher.MIN_THREADS <= launch.threads <= cuda_matcher.MAX_THREADS
    chunk = launch.threads * cuda_matcher.COLS_PER_THREAD
    assert launch.threads == cuda_matcher.MAX_THREADS or chunk >= launch.slice_cols


@pytest.mark.parametrize("num_anchors,batch,cluster,threads", [
    # SSD300: 8 CTAs of 288 threads per image, three to an SM, hold up to batch 49
    (8732, 1, 8, 288), (8732, 16, 8, 288), (8732, 32, 8, 288), (8732, 49, 8, 288),
    # 4 CTAs of 576 threads have an SM each, so past batch 33 they would wait in line
    (8732, 50, 2, 1024), (8732, 66, 2, 1024), (8732, 67, 1, 1024), (8732, 132, 1, 1024),
    (8732, 133, 1, 1024), (8732, 1000, 1, 1024),
    # SSD512: 768 threads at 8 CTAs per image, one to an SM
    (24564, 8, 8, 768), (24564, 16, 8, 768), (24564, 17, 4, 1024), (24564, 33, 4, 1024),
    (24564, 34, 2, 1024), (24564, 67, 1, 1024),
    # 20,001 anchors: the card test's set, every cluster size on both sides of its limit
    (20001, 16, 8, 640), (20001, 17, 4, 1024), (20001, 34, 2, 1024), (20001, 67, 1, 1024),
])
def test_plan_cluster_sizes(num_anchors, batch, cluster, threads):
    launch = cuda_matcher.plan(batch, 100, num_anchors, 132)
    assert (launch.cluster, launch.threads) == (cluster, threads)


@pytest.mark.parametrize("max_gt", [1, 100])
@pytest.mark.parametrize("spec", ["ssd300", "ssd512"])
def test_plan_fits_shared_memory(spec, max_gt):
    num_anchors = {"ssd300": 8732, "ssd512": 24564}[spec]
    assert len(generate_anchors(SSD512_SPEC) if spec == "ssd512" else generate_anchors()) == num_anchors
    for batch in (1, 8, 32, 64, 256):
        launch = cuda_matcher.plan(batch, max_gt, num_anchors, 132)
        assert launch.smem_bytes == cuda_matcher.smem_bytes(max_gt, num_anchors, launch.cluster)
        # keys, inbox, picks, corners, row lists; a bit per column: a few KB
        assert launch.smem_bytes <= 16 * 1024 < cuda_matcher.SMEM_LIMIT


def test_plan_takes_a_smaller_cluster_when_the_inbox_does_not_fit():
    assert cuda_matcher.smem_bytes(3000, 3, 8) > cuda_matcher.SMEM_LIMIT
    launch = cuda_matcher.plan(1, 3000, 3, 132)
    assert launch.cluster == 4 and launch.smem_bytes <= cuda_matcher.SMEM_LIMIT
    assert cuda_matcher.plan(1, 6000, 3, 132).smem_bytes > cuda_matcher.SMEM_LIMIT  # the wrapper raises


def test_no_rescan_on_the_synthetic_training_batch():
    """The train path's batch (chip_smoke.py's synthetic_b32: 32 images of at most ~14
    GTs on SSD300's 8,732 anchors) needs no rescan; the model still equals the plain
    matcher there (held on 4 images to keep the plain matcher's (B, G, D) matrix small)."""
    ds = SyntheticDetectionDataset(num_images=32, image_size=300, max_gt=100, num_classes=8, seed=7)
    b = next(ds.batches(32))
    args = [torch.from_numpy(np.ascontiguousarray(b[k])) for k in ("gt_cls", "gt_boxes", "gt_valid")]
    anchors = torch.from_numpy(generate_anchors())
    launch = cuda_matcher.plan(32, 100, anchors.shape[0], 132)
    got, rescans = match_anchors_model(*args, anchors, cluster=launch.cluster)
    assert rescans == 0 and int(args[2].sum()) > 200
    want = match_anchors(*(a[:4] for a in args), anchors)
    for field, g, w in zip(got._fields, got, want):
        assert torch.equal(g[:4], w), field
