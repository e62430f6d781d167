"""flax parameter trees <-> state dicts of the port's SSD, and the `.msgpack` weights file.

A flax tree (numpy leaves, with or without its top "params" key) maps onto the port's
module names one for one, because both keep the Keras/flax layer names:
`vgg.block{b}_conv{i}`, `resnet.layer2_block0.proj_norm`, `mobilenet.stage1_block0.depthwise`,
`extra{bi}_conv{ci}`, `loc_head{i}`, `conf_head{i}`. Conv kernels are HWIO in flax and
OIHW in PyTorch (a depthwise (3, 3, 1, C) kernel becomes (C, 1, 3, 3) by the same
transpose); GroupNorm's `scale` is the torch `weight` of a 1-D parameter. The tests use
this to give both frameworks identical weights.

`save_params_msgpack` / `load_params_msgpack` write and read the weights file that the
JAX package's `Trainer.export_params` and `tools/eval_synthetic.py --save-weights`
write (`flax.serialization.to_bytes` of `{"params": ...}`), through
utils/msgpack_io.py, so a file that either package exported loads in the other.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ssd_object_detection_tpu_torch.utils import msgpack_io


def from_flax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params tree -> state_dict (`<module path>.weight` OIHW, `.bias`)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
            elif name == "kernel":
                state[f"{prefix}weight"] = torch.from_numpy(
                    np.array(np.asarray(value).transpose(3, 2, 0, 1), order="C")
                )
            elif name == "scale":  # GroupNorm
                state[f"{prefix}weight"] = torch.from_numpy(np.array(value))
            elif name == "bias":
                state[f"{prefix}bias"] = torch.from_numpy(np.array(value))
            else:
                raise ValueError(f"unexpected flax leaf {prefix}{name}")

    walk(tree, "")
    return state


def to_flax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of `from_flax_params`: {"params": nested dict of numpy arrays}."""
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        array = value.detach().cpu().numpy()
        if leaf == "weight" and array.ndim == 1:  # GroupNorm
            node["scale"] = array.copy()
        elif leaf == "weight":
            node["kernel"] = np.ascontiguousarray(array.transpose(2, 3, 1, 0))
        elif leaf == "bias":
            node["bias"] = array.copy()
        else:
            raise ValueError(f"unexpected state_dict entry {key}")
    return {"params": tree}


def params_from_bytes(model: nn.Module, data: bytes) -> nn.Module:
    """Load flax msgpack bytes into `model` in place. Every leaf must match a parameter
    of the same shape and every parameter must have a leaf: a missing or extra leaf, or
    a shape that differs, raises ValueError and leaves the model untouched."""
    state = from_flax_params(msgpack_io.restore(data))
    want = model.state_dict()
    missing, extra = sorted(set(want) - set(state)), sorted(set(state) - set(want))
    if missing or extra:
        raise ValueError(f"weights do not fit the model: missing {missing}, extra {extra}")
    shapes = [f"{k}: file {tuple(state[k].shape)}, model {tuple(v.shape)}"
              for k, v in want.items() if state[k].shape != v.shape]
    if shapes:
        raise ValueError("weights do not fit the model: " + "; ".join(shapes))
    model.load_state_dict(state)
    return model


def save_params_msgpack(model: nn.Module, path: str) -> str:
    """Write the model's parameters to `path` as flax msgpack; returns `path`."""
    with open(path, "wb") as f:
        f.write(msgpack_io.serialize(to_flax_params(model.state_dict())))
    return path


def load_params_msgpack(model: nn.Module, path: str) -> nn.Module:
    """Read a flax msgpack weights file (either package's export) into `model`."""
    with open(path, "rb") as f:
        return params_from_bytes(model, f.read())
