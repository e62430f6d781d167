"""flax parameter trees <-> state dicts of the port's SSD (no JAX counterpart).

A flax tree (numpy leaves, with or without its top "params" key) maps onto the port's
module names one for one, because both keep the Keras/flax layer names:
`vgg.block{b}_conv{i}`, `extra{bi}_conv{ci}`, `loc_head{i}`, `conf_head{i}`. Conv
kernels are HWIO in flax and OIHW in PyTorch. The tests use this to give both
frameworks identical weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


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
                    np.ascontiguousarray(np.asarray(value).transpose(3, 2, 0, 1))
                )
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
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(array.transpose(2, 3, 1, 0))
        elif leaf == "bias":
            node["bias"] = array.copy()
        else:
            raise ValueError(f"unexpected state_dict entry {key}")
    return {"params": tree}
