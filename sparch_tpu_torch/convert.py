"""Carry trained weights from the JAX package to the port.

:func:`variables_from_flax` maps a flax SNN variable tree, given as nested
dicts of numpy (or JAX) arrays, onto the port's ``state_dict`` names:

    params/<m>/W/kernel                  -> <m>.W.weight  (transposed: (out, in))
    params/<m>/W/bias                    -> <m>.W.bias
    params/<m>/{alpha,beta,a,b,V}        -> <m>.{alpha,beta,a,b,V}
    params/<m>/norm/BatchNorm_0/scale    -> <m>.norm.weight   (LayerNorm_0 alike)
    params/<m>/norm/BatchNorm_0/bias     -> <m>.norm.bias
    batch_stats/<m>/norm/BatchNorm_0/mean -> <m>.norm.running_mean
    batch_stats/<m>/norm/BatchNorm_0/var  -> <m>.norm.running_var

with ``<m>`` one of ``layer_<i>`` and ``readout``. Values are copied
exactly. A leaf that maps to nothing raises here; a port tensor that no
leaf sets raises in ``model.load_state_dict(..., strict=True)``.

:func:`variables_to_flax` is the inverse: a ``state_dict`` of the port
becomes the nested dicts of numpy arrays of the flax tree, so that the
port's trained parameters can be read in the JAX package's layout.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["variables_from_flax", "variables_to_flax"]

_CELL_PARAMS = ("alpha", "beta", "a", "b", "V")
_NORMS = ("BatchNorm_0", "LayerNorm_0")


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _target(path) -> Optional[Tuple[str, bool]]:
    """(state_dict key, transpose?) for one flax leaf path, or None."""
    if len(path) < 3:
        return None
    collection, module, rest = path[0], path[1], path[2:]
    if collection == "params":
        if rest == ("W", "kernel"):
            return f"{module}.W.weight", True
        if rest == ("W", "bias"):
            return f"{module}.W.bias", False
        if len(rest) == 1 and rest[0] in _CELL_PARAMS:
            return f"{module}.{rest[0]}", False
        if (len(rest) == 3 and rest[0] == "norm" and rest[1] in _NORMS
                and rest[2] in ("scale", "bias")):
            name = "weight" if rest[2] == "scale" else "bias"
            return f"{module}.norm.{name}", False
    if collection == "batch_stats" and len(rest) == 3 and \
            rest[:2] == ("norm", "BatchNorm_0") and rest[2] in ("mean", "var"):
        return f"{module}.norm.running_{rest[2]}", False
    return None


def variables_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax SNN variables -> the port's ``state_dict`` (CPU tensors)."""
    state_dict = {}
    for path, value in _leaves(variables):
        target = _target(path)
        if target is None:
            raise KeyError(f"no port tensor for flax leaf {'/'.join(path)}")
        key, transpose = target
        arr = np.array(value)  # a copy, never a view of the caller's array
        if transpose:
            arr = np.ascontiguousarray(arr.T)
        state_dict[key] = torch.from_numpy(arr)
    return state_dict


def variables_to_flax(state_dict) -> Dict[str, dict]:
    """The port's ``state_dict`` -> flax SNN variables (nested dicts of
    numpy arrays), the inverse of :func:`variables_from_flax`. A module
    with running statistics is a BatchNorm, any other norm a LayerNorm."""
    variables: Dict[str, dict] = {"params": {}}

    def put(collection, path, value):
        node = variables.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for key, tensor in state_dict.items():
        module, *rest = key.split(".")
        arr = tensor.detach().cpu().numpy().copy()
        norm = ("BatchNorm_0" if f"{module}.norm.running_mean" in state_dict
                else "LayerNorm_0")
        if rest == ["W", "weight"]:
            put("params", (module, "W", "kernel"),
                np.ascontiguousarray(arr.T))
        elif rest == ["W", "bias"]:
            put("params", (module, "W", "bias"), arr)
        elif len(rest) == 1 and rest[0] in _CELL_PARAMS:
            put("params", (module, rest[0]), arr)
        elif rest in (["norm", "weight"], ["norm", "bias"]):
            name = "scale" if rest[1] == "weight" else "bias"
            put("params", (module, "norm", norm, name), arr)
        elif rest in (["norm", "running_mean"], ["norm", "running_var"]):
            put("batch_stats",
                (module, "norm", norm, rest[1][len("running_"):]), arr)
        else:
            raise KeyError(f"no flax leaf for port tensor {key}")
    return variables
