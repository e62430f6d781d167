"""CLI trainer: `python -m ssd_object_detection_tpu_torch.cli.train <config.yml> [--device cuda|cpu]`.

Counterpart of tools/train.py. `--device` (default cuda; raises without a GPU) is the
one option the JAX CLI lacks. `--resume` and `--eval-after` are not ported yet
(ROADMAP A8).
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from ssd_object_detection_tpu_torch.config import load_config
from ssd_object_detection_tpu_torch.train.loop import Trainer

logger = logging.getLogger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    parser = argparse.ArgumentParser(description="train ssd model (PyTorch port)")
    parser.add_argument("config", type=str, help="yaml config file")
    parser.add_argument("--run-dir", type=str, default=None, help="override the timestamped run dir")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    trainer = Trainer(load_config(args.config), run_dir=args.run_dir, device=args.device)
    state = trainer.train()
    final = float(trainer.last_metrics["loss"]) if trainer.last_metrics else float("nan")
    logger.info("done at step %d, final loss %.6f; artifacts in %s", state.step, final, trainer.run_dir)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
