"""Streaming (frame-by-frame) inference for the SNN family (counterpart of
the SNN half of sparch_tpu/serve/streaming.py).

Every model here is a stack of one-step recurrences, so streaming carries
each layer's state ``(u[, w], s)`` and the readout's membrane and
accumulator, and advances them one frame at a time. Both functions read the
weights from a ``state_dict`` (the port's names, as ``model.state_dict()``
or ``convert.variables_from_flax`` give them); the model supplies only the
architecture. BatchNorm uses its running statistics, so the per-frame norm
is an affine map.

For a unidirectional model with ``state_init='zeros'``, feeding T frames
one at a time gives the cumulative readout of one ``(B, T, F)`` forward.
Bidirectional models need the reversed sequence and cannot stream.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from sparch_tpu_torch.models.common import NORM_EPS
from sparch_tpu_torch.ops import cells
from sparch_tpu_torch.ops.surrogate import spike_boxcar

__all__ = ["streaming_init", "streaming_step"]

_ADAPTIVE = ("adLIF", "RadLIF")
_RECURRENT = ("RLIF", "RadLIF")


def _layer_names(model):
    return [f"layer_{i}" for i in range(model.num_hidden)]


def _check_snn(model):
    if not getattr(model, "is_snn", False):
        raise NotImplementedError(
            "the port streams spiking models only; the ANN slice is "
            "ROADMAP queue 1 item 4"
        )
    if model.bidirectional:
        raise ValueError("Bidirectional models cannot run in streaming mode.")


def streaming_init(model, state_dict, batch_size: int) -> Dict:
    """Zero-initialised streaming state for ``batch_size`` parallel
    streams, on the device of the weights."""
    _check_snn(model)
    state: Dict = {"layers": [], "t": 0}
    for name in _layer_names(model):
        alpha = state_dict[f"{name}.alpha"]
        zeros = torch.zeros((batch_size, alpha.shape[0]), dtype=torch.float32,
                            device=alpha.device)
        layer = {"u": zeros, "s": zeros}
        if model.neuron_type in _ADAPTIVE:
            layer["w"] = zeros
        state["layers"].append(layer)
    if model.use_readout_layer:
        alpha = state_dict["readout.alpha"]
        zeros = torch.zeros((batch_size, alpha.shape[0]), dtype=torch.float32,
                            device=alpha.device)
        state["readout"] = {"u": zeros, "out": zeros}
    return state


def _affine_norm(sd, prefix, normalization, y):
    """Eval-mode normalisation of a (B, H) frame."""
    if normalization == "batchnorm":
        inv = torch.rsqrt(sd[f"{prefix}.norm.running_var"] + NORM_EPS)
        return ((y - sd[f"{prefix}.norm.running_mean"]) * inv
                * sd[f"{prefix}.norm.weight"] + sd[f"{prefix}.norm.bias"])
    if normalization == "layernorm":
        mean = y.mean(dim=-1, keepdim=True)
        var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
        return ((y - mean) * torch.rsqrt(var + NORM_EPS)
                * sd[f"{prefix}.norm.weight"] + sd[f"{prefix}.norm.bias"])
    return y


def _project(sd, prefix, normalization, x_t):
    y = torch.matmul(x_t, sd[f"{prefix}.W.weight"].t())
    bias = sd.get(f"{prefix}.W.bias")
    if bias is not None:
        y = y + bias
    return _affine_norm(sd, prefix, normalization, y)


@torch.no_grad()
def streaming_step(model, state_dict, state: Dict,
                   x_t: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Advance all layers by one ``(B, F)`` frame. Returns
    ``(new_state, readout)``: the cumulative-softmax class accumulator
    ``(B, classes)``, or the top layer's spikes without a readout layer."""
    _check_snn(model)
    sd = state_dict
    neuron = model.neuron_type
    thr = model.threshold
    h = x_t
    new_layers = []
    for name, st in zip(_layer_names(model), state["layers"]):
        wx = _project(sd, name, model.normalization, h)
        alpha = torch.clamp(sd[f"{name}.alpha"], *cells.ALPHA_LIM)
        u, s = st["u"], st["s"]
        drive = wx
        if neuron in _RECURRENT:
            drive = drive + torch.matmul(s, cells.zero_diag(sd[f"{name}.V"]))
        if neuron in _ADAPTIVE:
            beta = torch.clamp(sd[f"{name}.beta"], *cells.BETA_LIM)
            a = torch.clamp(sd[f"{name}.a"], *cells.A_LIM)
            b = torch.clamp(sd[f"{name}.b"], *cells.B_LIM)
            w = beta * st["w"] + a * u + b * s
            drive = drive - w
        u = alpha * (u - s) + (1.0 - alpha) * drive
        s = spike_boxcar(u - thr)
        new_st = {"u": u, "s": s}
        if neuron in _ADAPTIVE:
            new_st["w"] = w
        new_layers.append(new_st)
        h = s  # no dropout at inference

    new_state = {"layers": new_layers, "t": state["t"] + 1}
    if model.use_readout_layer:
        wx = _project(sd, "readout", model.normalization, h)
        alpha = torch.clamp(sd["readout.alpha"], *cells.ALPHA_LIM)
        u = alpha * state["readout"]["u"] + (1.0 - alpha) * wx
        out = state["readout"]["out"] + torch.softmax(u, dim=-1)
        new_state["readout"] = {"u": u, "out": out}
        return new_state, out
    return new_state, h
