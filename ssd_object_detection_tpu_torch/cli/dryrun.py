"""Entry points: a card forward and the multi-process dry run. Port of
__graft_entry__.py (`entry`, `dryrun_multichip`).

`entry()` returns the bf16 SSD300 forward of [0, 1] images and an example input, on the
card. `dryrun_multichip(n)` spawns n ranks (parallel/multihost.py::launch) and runs the
JAX dry run's legs at its sizes: a micro-trunk SSD (two strided convs) on 32x32 inputs,
9 classes, global batch 2n, accum 2, Adam with exponential decay;
  1. one data-parallel train step over the n ranks (matching, global mining, the clip of
     the summed gradient, accumulation, Adam);
  2. step 2, a checkpoint that rank 0 writes with torch.save, a barrier, a restore on
     every rank, and step 3 from it;
  3. when n >= 4 and n is even, an (n/2, 2) data x model mesh (parallel/shardings.py) at
     min_channels 64, whose loss must be within 1e-3 of step 1's;
  4. the data-parallel fused predict (resize, normalise, forward, decode, NMS) of each
     rank's rows of a uint8 canvas, at small pool sizes.
Rank 0 prints each leg's seconds and a summary line, and the call returns its figures.

On the card each rank takes a GPU of its own under NCCL. NCCL refuses two ranks on one
GPU, so with fewer GPUs than ranks the call raises unless the caller names
`backend="gloo"`, under which ranks share the GPUs (rank r on cuda:(r mod count)); nothing
falls back to the CPU.

    python -m ssd_object_detection_tpu_torch.cli.dryrun N [--device cpu] [--backend gloo]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ssd_object_detection_tpu_torch.models.ssd import SSD, SSD300_SPEC_MODEL, ModelSpec
from ssd_object_detection_tpu_torch.ops.anchors import AnchorSpec, generate_anchors
from ssd_object_detection_tpu_torch.utils.device import resolve_device

DRYRUN_SPEC = ModelSpec(
    name="dryrun",
    anchor_spec=AnchorSpec(image_size=32, feature_sizes=((8, 8), (4, 4)), scale_refs=(7, 13, 26),
                           aspect_ratios=((2,), (2,))),
    trunk="micro",
    blocks=(((64, 3, 1, "SAME"),), ((64, 3, 2, "SAME"),)),
)
NUM_CLASSES = 9  # 8 foreground classes + background LAST


def entry(device: str = "cuda") -> Tuple[Callable, Tuple[torch.Tensor]]:
    """(fn, example_args): SSD300-VGG16 in bf16 (81 classes, seed-0 weights), images in
    [0, 1] -> (loc, conf); the example is (8, 300, 300, 3) float32 zeros on the device."""
    dev = resolve_device(device)
    model = SSD(num_classes=81, spec=SSD300_SPEC_MODEL, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev).eval()

    @torch.inference_mode()
    def forward(images01: torch.Tensor):
        return model((images01 - 0.5) * 2.0)

    return forward, (torch.zeros((8, 300, 300, 3), dtype=torch.float32, device=dev),)


def dryrun_batch(batch_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The JAX dry run's batch, drawn in its order from `rng`."""
    return {
        "image": rng.uniform(0, 1, (batch_size, 32, 32, 3)).astype(np.float32),
        "gt_cls": rng.integers(0, 8, (batch_size, 4)).astype(np.int32),
        "gt_boxes": np.concatenate([rng.uniform(0.2, 0.8, (batch_size, 4, 2)),
                                    rng.uniform(0.1, 0.3, (batch_size, 4, 2))], axis=-1).astype(np.float32),
        "gt_valid": rng.uniform(size=(batch_size, 4)) < 0.8,
    }


def _finite(metrics, what: str) -> float:
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dry run, {what}: loss {loss}")
    return loss


def _rank(n: int, ckpt_dir: str, device_type: str) -> Dict:
    """One rank of the dry run; rank 0 prints and returns the figures."""
    from ssd_object_detection_tpu_torch.eval.predict import make_fused_predict_fn
    from ssd_object_detection_tpu_torch.ops.preprocess import pack_canvas
    from ssd_object_detection_tpu_torch.parallel.collectives import all_reduce_sum
    from ssd_object_detection_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from ssd_object_detection_tpu_torch.parallel.shardings import (
        make_2d_mesh, shard_batch_2d, shard_state_tp,
    )
    from ssd_object_detection_tpu_torch.train.optim import exponential_decay, make_optimizer
    from ssd_object_detection_tpu_torch.train.step import StepConfig, create_train_state, make_train_step

    t_start = time.perf_counter()
    marks = [t_start]
    legs = []
    rank = dist.get_rank()

    def leg(name: str) -> None:
        now = time.perf_counter()
        legs.append((name, now - marks[0]))
        if rank == 0:
            print(f"[dryrun] {name}: {now - marks[0]:.1f}s (total {now - t_start:.1f}s)", flush=True)
        marks[0] = now

    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    anchors = generate_anchors(DRYRUN_SPEC.anchor_spec)
    schedule = exponential_decay(1e-3, 100, 0.99)
    cfg = StepConfig(accum_steps=2)  # accum 2: the micro-batch loop (reference split_train)

    def fresh_model():
        model = SSD(num_classes=NUM_CLASSES, spec=DRYRUN_SPEC)
        return model.init_weights(torch.Generator().manual_seed(0)).to(dev)

    def fresh_state(model):
        return create_train_state(model, make_optimizer("adam", model.parameters()), schedule)

    mesh = make_mesh(n, device=dev)
    model = replicate(fresh_model(), mesh)  # every leg starts from these seed-0 weights
    step_fn = make_train_step(anchors, cfg, mesh=mesh)
    leg("build model + step")

    batch_size = 2 * n
    rng = np.random.default_rng(0)
    batch = dryrun_batch(batch_size, rng)

    # 1-D data parallelism (the production decomposition for this model family)
    state = fresh_state(model)
    local = shard_batch(batch, mesh, cfg.accum_steps)
    metrics = step_fn(state, local)
    loss_dp = _finite(metrics, "data-parallel step")
    positives = float(metrics["num_positive"])
    if state.step != 1:
        raise RuntimeError(f"dry run: step count {state.step} after one step")
    leg("dp train step")

    # step 2, a checkpoint written by rank 0, every rank restoring it, step 3
    _finite(step_fn(state, local), "step 2")
    path = os.path.join(ckpt_dir, "ckpt.pt")
    if rank == 0:
        torch.save({"model": model.state_dict(), "optimizer": state.optimizer.state_dict(),
                    "step": state.step}, path)
    dist.barrier()
    payload = torch.load(path, map_location=dev, weights_only=True)
    restored = fresh_state(fresh_model())
    restored.model.load_state_dict(payload["model"])
    restored.optimizer.load_state_dict(payload["optimizer"])
    restored.step = int(payload["step"])
    _finite(step_fn(restored, local), "step 3 after the restore")
    if restored.step != 3:
        raise RuntimeError(f"dry run: step count {restored.step} after the restore and one step")
    leg("step 2 + checkpoint resume + step 3")

    # the 2-D (data, model) mesh: the wide convs split their output channels
    loss_tp = None
    if n >= 4 and n % 2 == 0:
        mesh2d = make_2d_mesh(n // 2, 2, device=dev)
        state2d = fresh_state(fresh_model())
        shard_state_tp(state2d, mesh2d, min_channels=64)
        metrics2d = make_train_step(anchors, cfg, mesh=mesh2d)(
            state2d, shard_batch_2d(batch, mesh2d, cfg.accum_steps))
        loss_tp = _finite(metrics2d, "dp x tp step")
        if abs(loss_tp - loss_dp) >= 1e-3:
            raise RuntimeError(f"dry run: dp x tp loss {loss_tp} differs from the dp loss {loss_dp}")
        leg("dp x tp train step")

    # data-parallel inference: each rank's rows of a uint8 canvas through the fused predict
    fused = make_fused_predict_fn(fresh_model(), anchors, image_size=32, pre_nms_top_k=64,
                                  max_detections=16, merged_top_k=64)
    canvas, sizes = pack_canvas(
        [rng.integers(0, 256, (24, 32, 3), np.uint8) for _ in range(batch_size)], (48, 48))
    shard = mesh.shard()
    det = fused(shard.take(torch.from_numpy(canvas)), shard.take(torch.from_numpy(sizes)))
    rows = shard.count(batch_size)
    if tuple(det.boxes.shape) != (rows, 16, 4) or not bool(torch.isfinite(det.scores).all()):
        raise RuntimeError(f"dry run: fused predict gave boxes {tuple(det.boxes.shape)}, want "
                           f"({rows}, 16, 4), with finite scores")
    detections = int(all_reduce_sum(det.valid.sum(), mesh.data_group))
    leg("dp fused-infer")

    wall = time.perf_counter() - t_start
    if rank != 0:
        return {}
    print(f"dryrun_multichip({n}): ok, dp loss={loss_dp:.4f}"
          + (f", dp x tp loss={loss_tp:.4f}" if loss_tp is not None else "")
          + f", positives={positives:.0f}, 2-step+ckpt-resume=ok"
          + f", dp fused-infer detections={detections}, wall={wall:.1f}s", flush=True)
    return {"dp_loss": loss_dp, "tp_loss": loss_tp, "positives": positives,
            "detections": detections, "legs": legs, "wall_s": wall}


def dryrun_multichip(n_devices: int, device: str = "cuda", backend: Optional[str] = None) -> Dict:
    """The dry run over `n_devices` spawned ranks (see the module docstring); returns rank
    0's figures: losses, positives, detections, per-leg and wall seconds."""
    dev = resolve_device(device)
    if dev.type == "cuda" and backend is None and torch.cuda.device_count() < n_devices:
        raise ValueError(
            f"dryrun_multichip({n_devices}) on cuda runs one NCCL rank per GPU and this machine "
            f"has {torch.cuda.device_count()}; NCCL refuses two ranks on one GPU. Pass "
            f'backend="gloo" to run the {n_devices} ranks on the GPUs there are.')
    from ssd_object_detection_tpu_torch.parallel.multihost import launch

    with tempfile.TemporaryDirectory() as ckpt_dir:  # rank 0 writes the checkpoint here
        return launch(_rank, n_devices, (n_devices, ckpt_dir, dev.type), device_type=dev.type,
                      backend=backend)


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=8, help="ranks (default 8)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--backend", default=None,
                        help="torch.distributed backend: nccl on cuda, gloo on the cpu by default")
    args = parser.parse_args(argv)
    result = dryrun_multichip(args.n, device=args.device, backend=args.backend)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
