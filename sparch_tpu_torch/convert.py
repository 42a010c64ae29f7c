"""Carry trained weights from the JAX package to the port.

:func:`variables_from_flax` maps a flax SNN or ANN variable tree, given as
nested dicts of numpy (or JAX) arrays, onto the port's ``state_dict`` names:

    params/<m>/<W>/kernel                -> <m>.<W>.weight  (transposed)
    params/<m>/<W>/bias                  -> <m>.<W>.bias
    params/<m>/{alpha,beta,a,b,V,Vz,Vr}  -> <m>.{alpha,beta,a,b,V,Vz,Vr}
    params/<m>/<n>/BatchNorm_0/scale     -> <m>.<n>.weight   (LayerNorm_0 alike)
    params/<m>/<n>/BatchNorm_0/bias      -> <m>.<n>.bias
    batch_stats/<m>/<n>/BatchNorm_0/mean -> <m>.<n>.running_mean
    batch_stats/<m>/<n>/BatchNorm_0/var  -> <m>.<n>.running_var

with ``<m>`` one of ``layer_<i>`` and ``readout``, ``<W>`` a projection
(``W``; an ANN layer's gates also ``Wz``, ``Wr``) and ``<n>`` its norm
(``norm``; an ANN layer's ``norm_W``, ``norm_Wz``, ``norm_Wr``). The tree
of a model wrapped in the audio frontend (``FbankFrontend``) has one level
more, ``params/inner/<m>/...`` and ``batch_stats/inner/<m>/...``, which
maps to the prefix ``inner.`` (``inner.<m>.<W>.weight``). Values are
copied exactly. A leaf that maps to nothing raises here; a port tensor that
no leaf sets raises in ``model.load_state_dict(..., strict=True)``.

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

_CELL_PARAMS = ("alpha", "beta", "a", "b", "V", "Vz", "Vr")
_DENSES = ("W", "Wz", "Wr")
_NORM_MODULES = ("norm",) + tuple(f"norm_{w}" for w in _DENSES)
_NORMS = ("BatchNorm_0", "LayerNorm_0")


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


_INNER = "inner"  # FbankFrontend's wrapped model


def _target(path) -> Optional[Tuple[str, bool]]:
    """(state_dict key, transpose?) for one flax leaf path, or None."""
    if len(path) > 1 and path[1] == _INNER:
        target = _target(path[:1] + path[2:])
        return None if target is None else \
            (f"{_INNER}.{target[0]}", target[1])
    if len(path) < 3:
        return None
    collection, module, rest = path[0], path[1], path[2:]
    if collection == "params":
        if len(rest) == 2 and rest[0] in _DENSES and rest[1] == "kernel":
            return f"{module}.{rest[0]}.weight", True
        if len(rest) == 2 and rest[0] in _DENSES and rest[1] == "bias":
            return f"{module}.{rest[0]}.bias", False
        if len(rest) == 1 and rest[0] in _CELL_PARAMS:
            return f"{module}.{rest[0]}", False
        if (len(rest) == 3 and rest[0] in _NORM_MODULES and rest[1] in _NORMS
                and rest[2] in ("scale", "bias")):
            name = "weight" if rest[2] == "scale" else "bias"
            return f"{module}.{rest[0]}.{name}", False
    if collection == "batch_stats" and len(rest) == 3 and \
            rest[0] in _NORM_MODULES and rest[1] == "BatchNorm_0" and \
            rest[2] in ("mean", "var"):
        return f"{module}.{rest[0]}.running_{rest[2]}", False
    return None


def variables_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax SNN or ANN variables -> the port's ``state_dict`` (CPU
    tensors)."""
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
    """The port's ``state_dict`` -> flax SNN or ANN variables (nested dicts
    of numpy arrays), the inverse of :func:`variables_from_flax`. A norm
    with running statistics is a BatchNorm, any other a LayerNorm."""
    variables: Dict[str, dict] = {"params": {}}

    def put(collection, path, value):
        node = variables.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for key, tensor in state_dict.items():
        module, *rest = key.split(".")
        head = ()  # the audio frontend's level, if any
        if module == _INNER and rest:
            head = (_INNER,)
            module, *rest = rest
        arr = tensor.detach().cpu().numpy().copy()
        if len(rest) == 1 and rest[0] in _CELL_PARAMS:
            put("params", (*head, module, rest[0]), arr)
            continue
        sub, leaf = rest if len(rest) == 2 else (None, None)
        stats = ".".join((*head, module, str(sub), "running_mean"))
        norm = "BatchNorm_0" if stats in state_dict else "LayerNorm_0"
        if sub in _DENSES and leaf == "weight":
            put("params", (*head, module, sub, "kernel"),
                np.ascontiguousarray(arr.T))
        elif sub in _DENSES and leaf == "bias":
            put("params", (*head, module, sub, "bias"), arr)
        elif sub in _NORM_MODULES and leaf in ("weight", "bias"):
            name = "scale" if leaf == "weight" else "bias"
            put("params", (*head, module, sub, norm, name), arr)
        elif sub in _NORM_MODULES and leaf in ("running_mean",
                                               "running_var"):
            put("batch_stats",
                (*head, module, sub, norm, leaf[len("running_"):]), arr)
        else:
            raise KeyError(f"no flax leaf for port tensor {key}")
    return variables
