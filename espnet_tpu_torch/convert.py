"""Carry JAX parameters into the port.

`jax_params_to_state_dict` turns the param tree of the JAX package's
`ASRModel.init(...)["params"]` (nested dicts of numpy arrays, as a flax
msgpack checkpoint restores them) into a `state_dict` of
`espnet_tpu_torch.models.asr.ASRModel`. Paths map one to one
("encoder/layer0/ff1/w1/kernel" -> "encoder.layer0.ff1.w1.weight"); the
leaves change layout:

* Dense `kernel` (in, out) -> `nn.Linear.weight` (out, in);
* Conv2d `kernel` (kh, kw, in, out), NHWC -> (out, in, kh, kw);
* depthwise Conv1d `kernel` (k, 1, d) -> (d, 1, k);
* LayerNorm `scale` -> `weight` (eps 1e-6 is set by the port's LayerNorm);
* Embed `embedding` -> `weight`;
* `pos_bias_u` / `pos_bias_v` (H, dk) and every `bias` as they are.

The fused and unfused JAX layers use the same param names, so one mapping
serves both. The stacked `layers/block` layout of `scan_layers` is refused,
and so is any leaf that the port's model has no place for.

A global-MVN model keeps its feature statistics in the non-trainable JAX
collection `mvn` ({"mvn": {"mvn": {"mean", "inv_std"}}}): pass the whole
variables dict {"params": ..., "mvn": ...} and they become the buffers
`mvn.mean` and `mvn.inv_std`. Loading such a model from its params alone
raises, since identity statistics would silently change its input.

Every layout change is a permutation, so the same mapping carries a JAX
*gradient* tree (`jax.grad` of the params) onto the port's parameter names
with `jax_params_to_state_dict`, to be compared with `param.grad` leaf by
leaf; `torch_to_jax_tree` maps the
port's tensors (parameters after an update, or their gradients) back into
the nested layout of a given JAX tree.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _leaf(name: str, value: np.ndarray):
    """(torch leaf name, array in torch layout) for one JAX leaf."""
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 3:
            return "weight", value.transpose(2, 1, 0)
        raise ValueError(f"kernel of unexpected rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    if name in ("bias", "pos_bias_u", "pos_bias_v"):
        return name, value
    raise ValueError(f"unknown parameter leaf {name!r}")


def _split_variables(tree: Mapping):
    """(params, mvn collection or None) of a JAX param tree or of a
    variables dict {"params", optionally "mvn"}."""
    if "params" in tree and set(tree) <= {"params", "mvn"}:
        return tree["params"], tree.get("mvn")
    return tree, None


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a JAX `ASRModel` param tree, or its variables dict with the `mvn`
    collection, to the port's state_dict (float32)."""
    params, mvn = _split_variables(params)
    sd = {}
    for path, value in _flatten(mvn or {}).items():
        sd[path.replace("/", ".")] = torch.from_numpy(
            np.array(value, np.float32))
    for path, value in _flatten(params).items():
        parts = path.split("/")
        if "layers" in parts and "block" in parts:
            raise NotImplementedError(
                f"{path}: the stacked scan_layers layout is not ported yet; "
                "convert a model built with scan_encoder_layers=False")
        leaf, arr = _leaf(parts[-1], value)
        key = ".".join(parts[:-1] + [leaf])
        if key in sd:
            raise ValueError(f"two JAX leaves map to {key}")
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def _unleaf(name: str, value: np.ndarray) -> np.ndarray:
    """The inverse of `_leaf`'s layout change for JAX leaf `name`."""
    if name == "kernel":
        if value.ndim == 2:
            return value.T
        if value.ndim == 4:
            return value.transpose(2, 3, 1, 0)
        if value.ndim == 3:
            return value.transpose(2, 1, 0)
    return value


def torch_to_jax_tree(tensors: Mapping[str, torch.Tensor],
                      like: Mapping) -> Dict:
    """Nested dict with `like`'s structure (a JAX param tree), each leaf
    taken from `tensors` (port names -> tensors, e.g. a state_dict or the
    parameters' gradients) in the JAX layout, as float32 numpy arrays."""
    if "params" in like and len(like) == 1:
        like = like["params"]

    def build(tree, prefix):
        out = {}
        for key, value in tree.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                out[key] = build(value, path)
                continue
            parts = path.split("/")
            leaf, _ = _leaf(parts[-1], np.asarray(value))
            t = tensors[".".join(parts[:-1] + [leaf])]
            arr = t.detach().cpu().float().numpy()
            out[key] = np.ascontiguousarray(_unleaf(parts[-1], arr))
        return out

    return build(like, "")


def load_jax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Load a JAX param tree, or the variables dict {"params", "mvn"} of a
    global-MVN model, into `model`; raises on any key left unused on either
    side, or on a shape that does not match."""
    sd = jax_params_to_state_dict(params)
    own = model.state_dict()
    unused = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if any(k.startswith("mvn.") for k in missing):
        raise KeyError(
            "the model normalises with global MVN, but no 'mvn' statistics "
            "came with the parameters: pass the JAX variables dict "
            "{'params': ..., 'mvn': ...}")
    if unused or missing:
        raise KeyError(f"JAX params unused by the port: {unused}; "
                       f"port params missing from the JAX tree: {missing}")
    for key, value in sd.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: JAX shape {tuple(value.shape)} vs port "
                             f"{tuple(own[key].shape)}")
    model.load_state_dict(sd)
    return model
