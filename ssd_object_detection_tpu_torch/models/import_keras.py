"""Keras .h5 weight import, port of ssd_object_detection_tpu/models/import_keras.py.

`load_vgg16_trunk_weights` reads the VGG-16 trunk layers of a Keras VGG16 .h5 (the
standard `vgg16_weights_tf_dim_ordering_tf_kernels_notop.h5`), `load_vgg16_trunk_into`
puts them into the port's SSD (or its state dict), and `load_reference_ssd_h5` imports a
whole reference-architecture Keras SSD .h5: the trunk by its stable `block{i}_conv{j}`
names, the 13 pyramid convs, 6 loc heads and 6 conf heads by position in build order,
every assignment shape-checked. Three h5 layouts are read: `name/name/kernel:0`, Keras
3's `vars/{0,1}` and the `weight_names` attribute.

Keras kernels are HWIO (as flax's); the port's are OIHW, so each kernel is transposed.
h5py is imported inside the functions, and a missing h5py raises an ImportError that
names it. The reference feeds [-1, 1] RGB into these weights; the port changes nothing
about the input path either.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)

_TRUNK_LAYERS = [
    "block1_conv1", "block1_conv2",
    "block2_conv1", "block2_conv2",
    "block3_conv1", "block3_conv2", "block3_conv3",
]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is needed to read Keras .h5 weights and is not installed",
                          name="h5py") from e
    return h5py


def _names(attr) -> List[str]:
    return [n.decode() if isinstance(n, bytes) else n for n in attr]


def _oihw(kernel: np.ndarray) -> torch.Tensor:
    """Keras HWIO kernel -> the port's OIHW float32 weight."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def _bias(bias: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(bias, np.float32))


def load_vgg16_trunk_weights(h5_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read {layer: {kernel (HWIO), bias}} for the trunk layers from a Keras VGG16 .h5."""
    h5py = _h5py()
    out = {}
    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for name in _TRUNK_LAYERS:
            grp = root[name]
            if name in grp:  # name/name/{kernel:0, bias:0}
                kernel, bias = np.asarray(grp[name]["kernel:0"]), np.asarray(grp[name]["bias:0"])
            elif "vars" in grp:  # keras 3: name/vars/{0, 1}
                kernel, bias = np.asarray(grp["vars"]["0"]), np.asarray(grp["vars"]["1"])
            else:  # the weight_names attribute
                names = _names(grp.attrs["weight_names"])
                kernel, bias = np.asarray(grp[names[0]]), np.asarray(grp[names[1]])
            out[name] = {"kernel": kernel.astype(np.float32), "bias": bias.astype(np.float32)}
    return out


StateOrModel = Union[nn.Module, Mapping[str, torch.Tensor]]


def _state(target: StateOrModel) -> Dict[str, torch.Tensor]:
    return dict(target.state_dict() if isinstance(target, nn.Module) else target)


def _put(target: StateOrModel, state: Dict[str, torch.Tensor]) -> StateOrModel:
    """The model with `state` loaded in place, or the new state dict."""
    if isinstance(target, nn.Module):
        target.load_state_dict(state)
        return target
    return state


def _assign(state: Dict[str, torch.Tensor], name: str, kernel, bias) -> None:
    expect = tuple(state[f"{name}.weight"].shape)
    weight = _oihw(kernel)
    if tuple(weight.shape) != expect:
        raise ValueError(f"{name}: kernel {tuple(np.shape(kernel))} (HWIO) does not fit the "
                         f"model's {expect} (OIHW)")
    state[f"{name}.weight"] = weight
    state[f"{name}.bias"] = _bias(bias)


def load_vgg16_trunk_into(target: StateOrModel, h5_path: str) -> StateOrModel:
    """The port's SSD (loaded in place) or a copy of its state dict with the VGG trunk
    replaced by the Keras weights of `h5_path`. A kernel of another shape raises
    ValueError and leaves a model untouched."""
    weights = load_vgg16_trunk_weights(h5_path)
    state = _state(target)
    for name, w in weights.items():
        _assign(state, f"vgg.{name}", w["kernel"], w["bias"])
    logger.info("loaded VGG16 trunk (%d layers) from %s", len(weights), h5_path)
    return _put(target, state)


def _layer_conv_weights(grp) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """All (name, kernel, bias) conv pairs inside one Keras layer group, in the layer's
    own weight order: the `weight_names` attribute, Keras 3 `vars/{0,1}` groups, or
    bare nested `<name>/<name>/{kernel,bias}` groups."""
    h5py = _h5py()
    out = []
    wn = grp.attrs.get("weight_names")
    if wn is not None and len(wn):
        names = _names(wn)
        arrays = {n: np.asarray(grp[n]) for n in names}
        for kname in (n for n in names if n.split("/")[-1].split(":")[0] == "kernel"):
            bname = kname.replace("kernel", "bias")
            if bname in arrays and arrays[kname].ndim == 4:
                out.append((kname.rsplit("/", 1)[0], arrays[kname], arrays[bname]))
        return out

    def visit(name, obj):
        if isinstance(obj, h5py.Group):
            if "vars" in obj and "0" in obj["vars"]:
                k = np.asarray(obj["vars"]["0"])
                if k.ndim == 4 and "1" in obj["vars"]:
                    out.append((name, k, np.asarray(obj["vars"]["1"])))
            elif "kernel" in obj and "bias" in obj:
                k = np.asarray(obj["kernel"])
                if k.ndim == 4:
                    out.append((name, k, np.asarray(obj["bias"])))

    visit("", grp)
    grp.visititems(visit)
    return out


def _ordered_layer_names(root) -> List[str]:
    """Model-order layer list: the `layer_names` attribute when present, else a natural
    sort of the group names (`conv2d`, `conv2d_1`, ..., `conv2d_10`)."""
    ln = root.attrs.get("layer_names")
    if ln is not None and len(ln):
        return _names(ln)

    def natural(name):
        return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", name)]

    return sorted(root.keys(), key=natural)


def load_reference_ssd_h5(target: StateOrModel, h5_path: str,
                          num_feature_maps: int = 6) -> StateOrModel:
    """Import a whole reference-architecture Keras SSD .h5 into the port's SSD300 (in
    place) or a copy of its state dict. The trunk goes by name; the other convs by
    position (pyramid convs, then loc heads, then conf heads). Raises ValueError on a
    missing trunk layer, a wrong count of convs or any shape mismatch."""
    h5py = _h5py()
    state = _state(target)
    trunk_found = {}
    sequence = []  # non-trunk conv (kernel, bias) in model order
    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for lname in _ordered_layer_names(root):
            if lname not in root:
                continue
            for wname, kernel, bias in _layer_conv_weights(root[lname]):
                base = wname.split("/")[-1] if "/" in wname else wname
                m = [part for part in wname.split("/") if part.startswith("block")]
                if m:
                    trunk_found[m[0]] = (kernel, bias)
                elif base.startswith("block"):
                    trunk_found[base] = (kernel, bias)
                else:
                    sequence.append((kernel, bias))

    for name in _TRUNK_LAYERS:
        if name not in trunk_found:
            raise ValueError(f"trunk layer {name} not found in {h5_path}")
        _assign(state, f"vgg.{name}", *trunk_found[name])

    extra = sorted({k.split(".")[0] for k in state if k.startswith("extra")},
                   key=lambda s: (int(s.split("_")[0][5:]), int(s.split("conv")[1])))
    order = (extra + [f"loc_head{i}" for i in range(num_feature_maps)]
             + [f"conf_head{i}" for i in range(num_feature_maps)])
    if len(sequence) != len(order):
        raise ValueError(f"{h5_path} holds {len(sequence)} non-trunk convs; model expects {len(order)}")
    for name, (kernel, bias) in zip(order, sequence):
        _assign(state, name, kernel, bias)
    logger.info("loaded full reference SSD (%d trunk + %d pyramid/head convs) from %s",
                len(_TRUNK_LAYERS), len(sequence), h5_path)
    return _put(target, state)
