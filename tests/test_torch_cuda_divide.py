"""Division on the card rounds as numpy, the CPU and XLA do.

PyTorch's CUDA kernels divide by a Python or CPU scalar as a multiply by its
reciprocal, one ulp off the true quotient for about half of all inputs. The port
divides by a divisor tensor on the data's device (`utils/device.py::true_divide`), so
the card's results equal the CPU's bit for bit. These tests need an NVIDIA GPU and skip
elsewhere; the file imports no JAX, so the machine with the card runs it as
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_divide.py`.
"""

import numpy as np
import pytest
import torch

from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu_torch.models.ssd import SSD, ModelSpec
from ssd_object_detection_tpu_torch.ops.anchors import AnchorSpec, generate_anchors
from ssd_object_detection_tpu_torch.train.step import StepConfig, TrainState, make_train_step
from ssd_object_detection_tpu_torch.utils.device import true_divide

torch.set_num_threads(1)

# The tiny spec of tests/test_train_step.py (64x64 input, two feature maps), written
# out here because that file imports JAX.
TINY_ANCHORS = AnchorSpec(image_size=64, feature_sizes=((8, 8), (4, 4)), scale_refs=(13, 26, 45),
                          aspect_ratios=((2,), (2,)))
TINY_MODEL = ModelSpec(name="tiny", anchor_spec=TINY_ANCHORS, blocks=(
    ((128, 3, 1, "SAME"), (128, 1, 1, "SAME")),
    ((128, 3, 2, "SAME"), (128, 1, 1, "SAME")),
))


@pytest.fixture
def cuda_device():
    """The card; decided inside the fixture, never at import (xdist workers must
    collect identical tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("divisor", [255.0, 3.0])
def test_true_divide_bit_equal_to_numpy(cuda_device, divisor):
    x = np.arange(256, dtype=np.float32)
    want = x / np.float32(divisor)
    got = true_divide(torch.from_numpy(x).to(cuda_device), divisor).cpu().numpy()
    np.testing.assert_array_equal(got, want)


def _step(device, model, batch, accum_steps, dtype=torch.float32):
    """One train step of a copy of `model` computing in `dtype` on `device` (SGD at lr
    0, so only the gradients and metrics move) -> (metrics as floats, {name: grad on
    the CPU})."""
    port = SSD(num_classes=9, spec=TINY_MODEL, dtype=dtype).to(device)
    port.load_state_dict(model.state_dict())
    state = TrainState(model=port, optimizer=torch.optim.SGD(port.parameters(), lr=0.0),
                       schedule=lambda step: 0.0)
    step = make_train_step(generate_anchors(TINY_ANCHORS), StepConfig(accum_steps=accum_steps))
    metrics = step(state, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in port.named_parameters()})


def _tiny_batch_and_model():
    ds = SyntheticDetectionDataset(num_images=6, image_size=64, max_gt=4, num_classes=8, seed=5)
    model = SSD(num_classes=9, spec=TINY_MODEL).init_weights(torch.Generator().manual_seed(0))
    return next(ds.batches(batch_size=6)), model


@pytest.mark.cuda
def test_train_step_accum3_divides_exactly_on_card(cuda_device, monkeypatch):
    """accum_steps=3 on the card: the step's averaged gradients and metrics are the sums
    of its three micro-batch steps divided exactly (numpy's float32 quotient); a
    reciprocal multiply would be one ulp off in about half of the elements."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    batch, model = _tiny_batch_and_model()
    m3, g3 = _step(cuda_device, model, batch, 3)
    micro = [_step(cuda_device, model, {k: v[2 * i:2 * i + 2] for k, v in batch.items()}, 1)
             for i in range(3)]
    for name, got in g3.items():
        total = micro[0][1][name].clone()  # the step's order: ((g1 + g2) + g3)
        total.add_(micro[1][1][name]).add_(micro[2][1][name])
        want = total.numpy() / np.float32(3)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for key, got in m3.items():
        total = torch.tensor(micro[0][0][key]) + micro[1][0][key] + micro[2][0][key]
        assert got == float(total.numpy() / np.float32(3)), key


@pytest.mark.cuda
def test_train_step_accum3_card_matches_cpu(cuda_device):
    """One step with accum_steps=3 from identical float32 params and batch gives the
    same loss terms and gradients on the card as on the CPU.

    This checks that the two backends agree, not the division: a reciprocal multiply
    is one float32 ulp (~6e-8 relative) off the quotient, far inside the tolerance
    below, so a step that divides by the Python scalar passes it too. The division is
    held bit for bit by test_train_step_accum3_divides_exactly_on_card.

    The network computes in float64 on both devices: in float32 the two backends' sums
    differ by ulps, and where a 2x2 max-pool window holds a near-tie that picks another
    element to route the gradient to (measured on an H100: single elements up to 2e-5
    apart against |g| <= 2e-3). In float64 the float32 gradients are rounded once from
    sums that agree to ~1e-16, then clipped with float32 norms summed in another order
    (a few ulps) and summed over micro-batches, where cancellation leaves an ulp of the
    larger terms (measured: 9.7e-12): rtol 1e-5, atol 1e-9 (1e-7 of the clip norm)."""
    batch, model = _tiny_batch_and_model()
    m_cpu, g_cpu = _step(torch.device("cpu"), model, batch, 3, torch.float64)
    m_card, g_card = _step(cuda_device, model, batch, 3, torch.float64)
    assert m_card["num_positive"] == m_cpu["num_positive"]  # exact matcher on both
    for key in m_cpu:
        assert m_card[key] == pytest.approx(m_cpu[key], rel=1e-6), key
    for name in g_cpu:
        torch.testing.assert_close(g_card[name], g_cpu[name], rtol=1e-5, atol=1e-9,
                                   msg=lambda m, name=name: f"{name}: {m}")
