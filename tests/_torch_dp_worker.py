"""Worker script for the port's data-parallel CPU tests (not collected by pytest).

    python tests/_torch_dp_worker.py steps <inputs.pt> <out.pt>
        two gloo ranks (parallel/multihost.py::launch) run every case of inputs.pt
        (train steps and an evaluation) under a mesh; rank r writes <out.pt>.r<r>
    python tests/_torch_dp_worker.py tp <inputs.pt> <out.pt>
        four gloo ranks on a (2, 2) data x model mesh (parallel/shardings.py) run every
        train-step case of inputs.pt and one column-parallel conv; rank r writes <out.pt>.r<r>
    python tests/_torch_dp_worker.py dryrun <n>
        cli/dryrun.py::dryrun_multichip(n) on the CPU; prints "DRYRUN <json>" of its result
    python tests/_torch_dp_worker.py train <cli.train arguments...>
        cli.train, which spawns its own ranks (or, started by torchrun, joins its group);
        prints "HISTORY <json>" of rank 0
    python tests/_torch_dp_worker.py eval <cli.eval arguments...>
        cli.eval, which spawns its own ranks

Importing this file blocks JAX, flax, optax, orbax, TensorFlow and the JAX package in
sys.modules, so neither this process nor the ranks it spawns (which import it again as
their main module) can import them; and it registers the tiny test spec pickled at
$SSD_TORCH_TINY_SPEC as MODEL_SPECS["tiny-test-torch"].
"""

import json
import os
import pickle
import sys

for _name in ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflow", "ssd_object_detection_tpu"):
    sys.modules[_name] = None

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)

from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD  # noqa: E402

if os.environ.get("SSD_TORCH_TINY_SPEC"):
    with open(os.environ["SSD_TORCH_TINY_SPEC"], "rb") as _f:
        MODEL_SPECS.setdefault("tiny-test-torch", pickle.load(_f))


def forbidden_modules():
    """The blocked packages this process has imported (None entries are the blocks)."""
    return sorted(n for n, m in sys.modules.items() if m is not None
                  and n.split(".")[0] in ("jax", "flax", "optax", "orbax", "ssd_object_detection_tpu"))


def _model(inputs, state_dict):
    model = SSD(num_classes=inputs["num_classes"], spec=inputs["spec"])
    model.load_state_dict(state_dict)
    return model


def run_cases(inputs_path: str, out_path: str) -> None:
    """One rank: every train-step case and the evaluation of inputs.pt under the mesh."""
    import torch.distributed as dist

    from ssd_object_detection_tpu_torch.data.packed import PackedConfig, PackedPipeline
    from ssd_object_detection_tpu_torch.eval.predict import make_predict_fn
    from ssd_object_detection_tpu_torch.eval.runner import evaluate_batches
    from ssd_object_detection_tpu_torch.ops import augment
    from ssd_object_detection_tpu_torch.ops.matching import build_targets
    from ssd_object_detection_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from ssd_object_detection_tpu_torch.train.step import StepConfig, TrainState, make_train_step
    from ssd_object_detection_tpu_torch.utils.debug import checked_multibox_loss

    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh(2)
    out = {"forbidden": forbidden_modules()}
    real_draw, real_augment = augment.draw_augment, augment.augment_batch
    for case in inputs["cases"]:
        model = replicate(_model(inputs, inputs["state_dict"]), mesh)
        state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=1.0),
                           schedule=lambda step: 1.0)
        aug = augment.AugConfig(crop_attempts=50) if case["draws"] is not None else None
        drawn, augmented = [], {}
        if aug is not None:  # the JAX step's own draws for the global batch
            def draw(generator, batch, cfg, device, _draws=case["draws"]):
                drawn.append(batch)
                return augment.AugDraws(*(torch.from_numpy(d) for d in _draws))

            def record(*args, **kwargs):  # this rank's augmented rows
                out = real_augment(*args, **kwargs)
                augmented.update(zip(("image", "gt_boxes", "gt_cls", "gt_valid"),
                                     (t.detach().clone().numpy() for t in out)))
                return out
            augment.draw_augment, augment.augment_batch = draw, record
        step = make_train_step(inputs["anchors"], StepConfig(
            accum_steps=case["accum"], canonical_loss=case["canonical"], augment=aug,
            clip_norm=case["clip_norm"]), mesh=mesh)
        if case["packed"] is not None:
            pipe = PackedPipeline(case["packed"], PackedConfig(
                batch_size=case["global_batch"], shuffle=True, augment_flip=True, seed=3,
                shard=mesh.shard(case["accum"])))
            local = next(iter(pipe))
        else:
            local = {k: v.numpy() for k, v in shard_batch(case["batch"], mesh, case["accum"]).items()}
        metrics = step(state, {k: local[k] for k in ("image", "gt_cls", "gt_boxes", "gt_valid")},
                       global_batch=case["global_batch"])
        augment.draw_augment, augment.augment_batch = real_draw, real_augment
        out[case["name"]] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.clone() for k, v in model.state_dict().items()},
            "local": local, "drawn": drawn, "augmented": augmented,
        }
        if case["name"] == "positives_on_one_rank":  # rank 1 holds no positive of its own
            rows = {k: torch.from_numpy(local[k]) for k in ("image", "gt_cls", "gt_boxes", "gt_valid")}
            targets = build_targets(rows["gt_cls"], rows["gt_boxes"], rows["gt_valid"],
                                    torch.from_numpy(inputs["anchors"]))
            with torch.no_grad():
                pred = _model(inputs, inputs["state_dict"])((rows["image"] - 0.5) * 2.0)
                error, info = checked_multibox_loss(*targets, *pred, mesh=mesh,
                                                    global_batch=case["global_batch"])
            out[case["name"]]["checked"] = (error.get(), float(info.total))

    ev = inputs["eval"]
    model = _model(inputs, ev["state_dict"])
    predict = make_predict_fn(model, inputs["anchors"])
    out["eval"] = evaluate_batches(predict, ev["batches"], num_classes=ev["num_classes"], mesh=mesh)
    torch.save(out, f"{out_path}.r{dist.get_rank()}")


def run_tp_cases(inputs_path: str, out_path: str) -> None:
    """One rank of a (2, 2) mesh: every train-step case of inputs.pt with the wide convs
    column-parallel, then one ColumnParallelConv2d against the whole conv."""
    import torch.distributed as dist

    from ssd_object_detection_tpu_torch.models.vgg import conv_pads, float_conv
    from ssd_object_detection_tpu_torch.parallel.mesh import replicate
    from ssd_object_detection_tpu_torch.parallel.shardings import (
        ColumnParallelConv2d, make_2d_mesh, shard_batch_2d, shard_state_tp, unshard_state_dict,
    )
    from ssd_object_detection_tpu_torch.train.optim import make_optimizer
    from ssd_object_detection_tpu_torch.train.step import StepConfig, TrainState, make_train_step

    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_2d_mesh(2, 2)
    out = {"forbidden": forbidden_modules(), "coords": (mesh.rank, mesh.tp_rank)}
    for case in inputs["cases"]:
        model = replicate(_model(inputs, inputs["state_dict"]), mesh)
        state = TrainState(model=model, optimizer=make_optimizer("adam", model.parameters()),
                           schedule=lambda step: 1e-3)
        names = shard_state_tp(state, mesh, inputs["min_channels"])
        step = make_train_step(inputs["anchors"], StepConfig(accum_steps=case["accum"]), mesh=mesh)
        metrics = step(state, shard_batch_2d(inputs["batch"], mesh, case["accum"]))
        opt = state.optimizer
        out[case["name"]] = {
            "metrics": {k: float(v) for k, v in metrics.items()}, "names": names,
            "unsharded": unshard_state_dict(model, mesh),
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "moments": {n: (opt.state[p]["exp_avg"].clone(), opt.state[p]["exp_avg_sq"].clone())
                        for n, p in model.named_parameters()},
        }

    gen = torch.Generator().manual_seed(0)  # the same conv, input and gradient on every rank
    conv = torch.nn.Conv2d(16, 32, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.1)
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
    x = torch.randn(2, 16, 9, 11, generator=gen).contiguous(memory_format=torch.channels_last)
    grad = torch.randn(2, 32, 9, 11, generator=gen)
    pads = conv_pads(x, conv, "SAME")
    cp = ColumnParallelConv2d(conv, mesh)
    xs, xf = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y = cp.conv_nchw(xs, pads, torch.float32)
    y.backward(grad)
    want = float_conv(xf, conv, pads, torch.float32)
    want.backward(grad)
    lo, hi = cp.shard
    out["cp_conv"] = {
        "y": y.detach(), "y_want": want.detach(), "dx": xs.grad, "dx_want": xf.grad,
        "dw": cp.weight.grad, "dw_want": conv.weight.grad[lo:hi], "db": cp.bias.grad,
        "db_want": conv.bias.grad[lo:hi], "channels_last": y.is_contiguous(memory_format=torch.channels_last),
    }
    torch.save(out, f"{out_path}.r{dist.get_rank()}")


if __name__ == "__main__":
    from ssd_object_detection_tpu_torch.parallel import multihost

    mode, rest = sys.argv[1], sys.argv[2:]
    if mode == "steps":
        multihost.launch(run_cases, 2, (rest[0], rest[1]), device_type="cpu")
    elif mode == "tp":
        multihost.launch(run_tp_cases, 4, (rest[0], rest[1]), device_type="cpu")
    elif mode == "dryrun":
        from ssd_object_detection_tpu_torch.cli.dryrun import dryrun_multichip

        result = dryrun_multichip(int(rest[0]), device="cpu")
        print("DRYRUN " + json.dumps(result), flush=True)
    elif mode == "train":
        from ssd_object_detection_tpu_torch.cli import train

        result = train.main(rest)  # spawned: rank 0's history; under torchrun: this rank's Trainer
        if isinstance(result, list) or result.is_main:
            history = result if isinstance(result, list) else result.history
            print("HISTORY " + json.dumps(history), flush=True)
    elif mode == "eval":
        from ssd_object_detection_tpu_torch.cli import eval as cli_eval

        cli_eval.main(rest)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
