"""The port and chip_smoke.py import no JAX, flax, optax nor the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ssd_object_detection_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "ssd_object_detection_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'ssd_object_detection_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "import ssd_object_detection_tpu_torch.cli.train\n"
        "from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors\n"
        "from ssd_object_detection_tpu_torch.ops.matching import build_targets\n"
        "a = torch.from_numpy(generate_anchors())\n"
        "boxes = torch.tensor([[[0.5, 0.5, 0.3, 0.2]]])\n"
        "cls, loc, mask = build_targets(torch.tensor([[3]], dtype=torch.int32), boxes,\n"
        "                               torch.tensor([[True]]), a)\n"
        "assert mask.sum() >= 1 and int(cls[mask][0]) == 3\n"
        "import ssd_object_detection_tpu_torch.cli.eval_synthetic\n"
        "import ssd_object_detection_tpu_torch.cli.eval\n"
        "from ssd_object_detection_tpu_torch.data import coco, packed, pipeline, prefetch\n"
        "from ssd_object_detection_tpu_torch.train.checkpoint import CheckpointManager\n"
        "from ssd_object_detection_tpu_torch.utils import msgpack_io, viz\n"
        "from ssd_object_detection_tpu_torch.models.convert import load_params_msgpack, save_params_msgpack\n"
        "tree = msgpack_io.restore(msgpack_io.serialize({'w': np.arange(3, dtype=np.float32)}))\n"
        "assert tree['w'].tolist() == [0.0, 1.0, 2.0]\n"
        "batches = list(prefetch.device_prefetch(iter([{'x': np.ones(2)}]), 'cpu', depth=2))\n"
        "assert batches[0]['x'].tolist() == [1.0, 1.0]\n"
        "import ssd_object_detection_tpu_torch.eval.runner\n"
        "from ssd_object_detection_tpu_torch.eval.predict import detect_from_logits\n"
        "from ssd_object_detection_tpu_torch.ops.conv3x3 import conv3x3_bias_relu\n"
        "y = conv3x3_bias_relu(torch.ones(1, 4, 4, 2), torch.ones(3, 3, 2, 3), torch.zeros(3),\n"
        "                      True, True)\n"
        "assert tuple(y.shape) == (1, 2, 2, 3) and float(y.max()) == 18.0\n"
        "logits = torch.zeros(1, a.shape[0], 3)\n"
        "logits[..., -1] = 9.0\n"
        "logits[0, 7, 1] = 20.0\n"
        "det = detect_from_logits(torch.zeros(1, a.shape[0], 4), logits, a)\n"
        "assert int(det.valid.sum()) == 1 and int(det.classes[0, 0]) == 1\n"
        "import ssd_object_detection_tpu_torch.cli.serve, ssd_object_detection_tpu_torch.cli.export\n"
        "import ssd_object_detection_tpu_torch.cli.infer\n"
        "from ssd_object_detection_tpu_torch.ops import augment\n"
        "cfg = augment.AugConfig()\n"
        "draws = augment.draw_augment(torch.Generator().manual_seed(0), 2, cfg, torch.device('cpu'))\n"
        "out = augment.augment_batch(torch.zeros(2, 8, 8, 3, dtype=torch.uint8), boxes.repeat(2, 1, 1),\n"
        "                            torch.tensor([[3], [3]], dtype=torch.int32),\n"
        "                            torch.ones(2, 1, dtype=torch.bool), cfg, draws)\n"
        "assert tuple(out[0].shape) == (2, 8, 8, 3)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
