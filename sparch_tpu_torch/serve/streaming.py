"""Streaming (frame-by-frame) inference for the SNN and the ANN family
(counterpart of sparch_tpu/serve/streaming.py).

Every model here is a stack of one-step recurrences, so streaming carries
each layer's state (SNN: ``(u[, w], s)``; ANN: ``y``) and the readout's
accumulator (SNN: with its membrane), and advances them one frame at a
time. The ANN readout collapses time first, so its running sum of softmaxes
streams and its linear layer and norm are applied to it at every frame.
Both functions read the weights from a ``state_dict`` (the port's names, as
``model.state_dict()`` or ``convert.variables_from_flax`` give them); the
model supplies only the architecture. BatchNorm uses its running statistics, so the per-frame norm
is an affine map.

For a unidirectional model (an SNN with ``state_init='zeros'``; an ANN
always starts from zeros), feeding T frames one at a time gives the cumulative readout of one ``(B, T, F)`` forward.
Bidirectional models need the reversed sequence and cannot stream.

A model wrapped in the audio frontend (``FbankFrontend``, a ``--frontend
device`` experiment) streams too: each step takes one 400-sample waveform
window ``(B, 400)``, the windows advancing by the 160-sample hop, and its
fbank frame (``ops.fbank.fbank_torch``; the fbank is frame-local, so a
window's features are the batch fbank's frame) goes through the wrapped
model; its weights are the ``state_dict``'s ``inner.`` entries.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from sparch_tpu_torch.models.common import NORM_EPS
from sparch_tpu_torch.models.frontend import FbankFrontend
from sparch_tpu_torch.ops import cells
from sparch_tpu_torch.ops.fbank import FRAME_LENGTH, FRAME_SHIFT, fbank_torch
from sparch_tpu_torch.ops.surrogate import spike_boxcar

__all__ = ["streaming_init", "streaming_step"]

_ADAPTIVE = ("adLIF", "RadLIF")
_RECURRENT = ("RLIF", "RadLIF")


def _layer_names(model):
    return [f"layer_{i}" for i in range(model.num_hidden)]


def _check_streams(model):
    if model.bidirectional:
        raise ValueError("Bidirectional models cannot run in streaming mode.")


def _unwrap_frontend(model, state_dict):
    """(wrapped model, its ``state_dict``) for an ``FbankFrontend``; the
    pair as it is otherwise."""
    if not isinstance(model, FbankFrontend):
        return model, state_dict
    prefix = "inner."
    return model.inner, {k[len(prefix):]: v for k, v in state_dict.items()
                         if k.startswith(prefix)}


def _zeros(batch_size: int, vec: torch.Tensor):
    """A zero state as wide as ``vec`` is long, on its device."""
    return torch.zeros((batch_size, vec.shape[0]), dtype=torch.float32,
                       device=vec.device)


def streaming_init(model, state_dict, batch_size: int) -> Dict:
    """Zero-initialised streaming state for ``batch_size`` parallel
    streams, on the device of the weights."""
    model, state_dict = _unwrap_frontend(model, state_dict)
    _check_streams(model)
    state: Dict = {"layers": [], "t": 0}
    if not getattr(model, "is_snn", False):
        for name in _layer_names(model):
            w = state_dict[f"{name}.W.weight"]  # (out, in)
            # MLP layers are stateless; every layer carries a y all the same
            state["layers"].append({"y": _zeros(batch_size, w)})
        if model.use_readout_layer:
            # the running sum of the top layer's softmaxes
            state["readout"] = {"acc": _zeros(batch_size, w)}
        return state
    for name in _layer_names(model):
        zeros = _zeros(batch_size, state_dict[f"{name}.alpha"])
        layer = {"u": zeros, "s": zeros}
        if model.neuron_type in _ADAPTIVE:
            layer["w"] = zeros
        state["layers"].append(layer)
    if model.use_readout_layer:
        zeros = _zeros(batch_size, state_dict["readout.alpha"])
        state["readout"] = {"u": zeros, "out": zeros}
    return state


def _affine_norm(sd, norm, normalization, y):
    """Eval-mode normalisation of a (B, H) frame by the norm module
    ``norm`` (its state_dict prefix)."""
    if normalization == "batchnorm":
        inv = torch.rsqrt(sd[f"{norm}.running_var"] + NORM_EPS)
        return ((y - sd[f"{norm}.running_mean"]) * inv
                * sd[f"{norm}.weight"] + sd[f"{norm}.bias"])
    if normalization == "layernorm":
        mean = y.mean(dim=-1, keepdim=True)
        var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
        return ((y - mean) * torch.rsqrt(var + NORM_EPS)
                * sd[f"{norm}.weight"] + sd[f"{norm}.bias"])
    return y


def _project(sd, prefix, normalization, x_t, dense="W", norm="norm"):
    y = torch.matmul(x_t, sd[f"{prefix}.{dense}.weight"].t())
    bias = sd.get(f"{prefix}.{dense}.bias")
    if bias is not None:
        y = y + bias
    return _affine_norm(sd, f"{prefix}.{norm}", normalization, y)


@torch.no_grad()
def streaming_step(model, state_dict, state: Dict,
                   x_t: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Advance all layers by one ``(B, F)`` frame (for an
    ``FbankFrontend``: one ``(B, 400)`` waveform window). Returns
    ``(new_state, readout)``: the cumulative-softmax class accumulator
    ``(B, classes)`` (for an ANN: the readout's logits of the running
    sum), or the top layer's output without a readout layer."""
    if isinstance(model, FbankFrontend):
        if x_t.ndim != 2 or x_t.shape[-1] != FRAME_LENGTH:
            # a longer chunk would be cut to its first frame below
            raise ValueError(
                f"device-frontend streaming takes ONE {FRAME_LENGTH}-"
                f"sample (B, window) per step, advanced by the "
                f"{FRAME_SHIFT}-sample hop; got shape {tuple(x_t.shape)}"
            )
        x_t = fbank_torch(x_t, model.num_mel_bins)[:, 0, :]
    model, state_dict = _unwrap_frontend(model, state_dict)
    _check_streams(model)
    sd = state_dict
    if not getattr(model, "is_snn", False):
        return _ann_streaming_step(model, sd, state, x_t)
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


def _ann_streaming_step(model, sd, state, x_t):
    """One frame through the ANN stack."""
    kind = model.normalization
    ann_type = model.ann_type
    h = x_t
    new_layers = []
    for name, st in zip(_layer_names(model), state["layers"]):
        y = st["y"]

        def gate(w):
            return _project(sd, name, kind, h, w, f"norm_{w}")

        if ann_type == "MLP":
            y = torch.sigmoid(gate("W"))  # stateless
        elif ann_type == "RNN":
            y = torch.sigmoid(gate("W") + torch.matmul(y, sd[f"{name}.V"]))
        else:
            z = torch.sigmoid(gate("Wz")
                              + torch.matmul(y, sd[f"{name}.Vz"]))
            if ann_type == "LiGRU":
                c = torch.relu(gate("W") + torch.matmul(y, sd[f"{name}.V"]))
            else:
                r = torch.sigmoid(gate("Wr")
                                  + torch.matmul(y, sd[f"{name}.Vr"]))
                c = torch.tanh(gate("W")
                               + torch.matmul(r * y, sd[f"{name}.V"]))
            y = z * y + (1.0 - z) * c
        new_layers.append({"y": y})
        h = y  # no dropout at inference
    new_state = {"layers": new_layers, "t": state["t"] + 1}
    if model.use_readout_layer:
        # the readout collapses time first: the running sum streams, and
        # the small head is applied to it anew at every frame
        acc = state["readout"]["acc"] + torch.softmax(h, dim=-1)
        new_state["readout"] = {"acc": acc}
        return new_state, _project(sd, "readout", kind, acc)
    return new_state, h
