"""Neuron recurrences as plain PyTorch loops over time (counterpart of
sparch_tpu/ops/cells.py): the spiking cells and the non-spiking (ANN)
ones.

The calling layer hoists the input projection out of the recurrence, so
every cell here takes the pre-activations ``Wx`` of shape ``(B, T, H)`` and
runs only the sequential state update. Trainable neuron constants are
clamped to their plausible ranges once, before the loop; recurrent matrices
have their diagonal masked.

Dynamics (per step, previous-step ``u``, ``w`` and ``s`` on the right):

- LIF:    u = a*(u - s) + (1-a)*Wx_t ;  s = H(u - thr)
- adLIF:  w = beta*w + a_*u + b_*s ;  u = a*(u - s) + (1-a)*(Wx_t - w)
- RLIF:   u = a*(u - s) + (1-a)*(Wx_t + s @ V)
- RadLIF: w as adLIF ;  u = a*(u - s) + (1-a)*(Wx_t + s @ V - w)
- Readout: u = a*u + (1-a)*Wx_t ;  out = sum_t softmax(u_t)
- RNN:    y = sigmoid(Wx_t + y @ V)
- LiGRU:  z = sigmoid(Wzx_t + y @ Vz) ;  c = relu(Wx_t + y @ V)
          y = z*y + (1-z)*c
- GRU:    z as LiGRU ;  r = sigmoid(Wrx_t + y @ Vr)
          c = tanh(Wx_t + (r*y) @ V) ;  y = z*y + (1-z)*c
- ANN readout: out = sum_t softmax(x_t), no state

The arithmetic is written in the order the JAX cells use, op by op, so
that the two packages round alike. A cell runs in the type of ``Wx``: the
float32 neuron constants and recurrent matrices are cast to it where they
are used (a bf16 ``Wx``, which only an un-normalised projection under
``compute_dtype=bfloat16`` emits, gives a bf16 recurrence).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from sparch_tpu_torch.ops.surrogate import spike_boxcar

__all__ = [
    "ALPHA_LIM",
    "BETA_LIM",
    "A_LIM",
    "B_LIM",
    "init_state",
    "zero_diag",
    "lif_scan",
    "adlif_scan",
    "rlif_scan",
    "radlif_scan",
    "leaky_cumsum",
    "readout_sum",
    "readout_sum_scan",
    "rnn_scan",
    "ligru_scan",
    "gru_scan",
    "cumulative_softmax",
]

# Plausible ranges for the trainable neuron time constants.
ALPHA_LIM = (math.exp(-1 / 5), math.exp(-1 / 25))
BETA_LIM = (math.exp(-1 / 30), math.exp(-1 / 120))
A_LIM = (-1.0, 1.0)
B_LIM = (0.0, 2.0)


def init_state(
    generator: Optional[torch.Generator],
    shape: tuple,
    dtype: torch.dtype = torch.float32,
    mode: str = "uniform",
    device=None,
) -> torch.Tensor:
    """Initial neuron state: U[0, 1) drawn from ``generator`` for
    ``mode='uniform'`` (the original sparch draws a fresh one every
    forward), zeros for ``mode='zeros'``."""
    if mode == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if mode == "uniform":
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)
    raise ValueError(f"Invalid state init mode {mode}")


def zero_diag(V: torch.Tensor) -> torch.Tensor:
    """Mask the diagonal of a square matrix (no gradient to the diagonal)."""
    n = V.shape[-1]
    return V * (1.0 - torch.eye(n, dtype=V.dtype, device=V.device))


def _clip(p: torch.Tensor, lim) -> torch.Tensor:
    return torch.clamp(p, lim[0], lim[1])


def lif_scan(Wx, alpha, threshold: float, u0, s0):
    """Feedforward LIF recurrence. ``Wx``: (B,T,H) -> spikes (B,T,H)."""
    alpha = _clip(alpha, ALPHA_LIM).to(Wx.dtype)
    u, s = u0, s0
    out = []
    for t in range(Wx.shape[1]):
        u = alpha * (u - s) + (1.0 - alpha) * Wx[:, t]
        s = spike_boxcar(u - threshold)
        out.append(s)
    return torch.stack(out, dim=1)


def adlif_scan(Wx, alpha, beta, a, b, threshold: float, u0, w0, s0):
    """Adaptive LIF recurrence (adaptation current w)."""
    dt = Wx.dtype
    alpha = _clip(alpha, ALPHA_LIM).to(dt)
    beta = _clip(beta, BETA_LIM).to(dt)
    a = _clip(a, A_LIM).to(dt)
    b = _clip(b, B_LIM).to(dt)
    u, w, s = u0, w0, s0
    out = []
    for t in range(Wx.shape[1]):
        # w uses the previous step's u and s
        w = beta * w + a * u + b * s
        u = alpha * (u - s) + (1.0 - alpha) * (Wx[:, t] - w)
        s = spike_boxcar(u - threshold)
        out.append(s)
    return torch.stack(out, dim=1)


def rlif_scan(Wx, alpha, V, threshold: float, u0, s0):
    """Recurrent LIF: adds a per-step ``s @ V``, V zero-diagonal."""
    alpha = _clip(alpha, ALPHA_LIM).to(Wx.dtype)
    V = zero_diag(V).to(Wx.dtype)
    u, s = u0, s0
    out = []
    for t in range(Wx.shape[1]):
        rec = torch.matmul(s, V)
        u = alpha * (u - s) + (1.0 - alpha) * (Wx[:, t] + rec)
        s = spike_boxcar(u - threshold)
        out.append(s)
    return torch.stack(out, dim=1)


def radlif_scan(Wx, alpha, beta, a, b, V, threshold: float, u0, w0, s0):
    """Recurrent adaptive LIF (the flagship model)."""
    dt = Wx.dtype
    alpha = _clip(alpha, ALPHA_LIM).to(dt)
    beta = _clip(beta, BETA_LIM).to(dt)
    a = _clip(a, A_LIM).to(dt)
    b = _clip(b, B_LIM).to(dt)
    V = zero_diag(V).to(dt)
    u, w, s = u0, w0, s0
    out = []
    for t in range(Wx.shape[1]):
        w = beta * w + a * u + b * s
        rec = torch.matmul(s, V)
        u = alpha * (u - s) + (1.0 - alpha) * (Wx[:, t] + rec - w)
        s = spike_boxcar(u - threshold)
        out.append(s)
    return torch.stack(out, dim=1)


def leaky_cumsum(Wx, alpha, u0, chunk: Optional[int] = None):
    """Membrane trajectory of the linear leak ``u_t = a*u_{t-1} + (1-a)*wx_t``
    without a length-T loop.

    Inside a chunk of ``L`` steps the recurrence has the closed form
    ``u_j = a^{j+1} u_start + a^j * cumsum_j(a^{-i} v_i)`` with
    ``v = (1-a)*Wx``; only the ``T/L`` chunk carries stay sequential. ``L``
    is capped so the ``a^{-i}`` range stays near e^8 (a >= exp(-1/5) after
    the clamp), which keeps the f32 rounding at the eps level.

    ``Wx``: (B,T,H) -> (B,T,H) membrane series.
    """
    B, T, H = Wx.shape
    L = chunk or max(8, min(40, int(round(T**0.5))))
    n = -(-T // L)
    pad = n * L - T
    log_alpha = torch.log(alpha)  # alpha > 0 after clamping
    v = (1.0 - alpha) * Wx
    if pad:
        v = F.pad(v, (0, 0, 0, pad))
    v = v.reshape(B, n, L, H)

    j = torch.arange(L, dtype=Wx.dtype, device=Wx.device)[None, None, :, None]
    a_pow_j = torch.exp(j * log_alpha)  # alpha^j
    a_pow_mj = torch.exp(-j * log_alpha)  # alpha^-j
    intra = a_pow_j * torch.cumsum(v * a_pow_mj, dim=2)  # sum a^{j-i} v_i
    drive = intra[:, :, L - 1, :]  # (B, n, H) per-chunk drive
    a_pow_L = torch.exp(L * log_alpha)

    starts = []
    u = u0
    for k in range(n):
        starts.append(u)  # the state BEFORE chunk k
        u = a_pow_L * u + drive[:, k]
    starts = torch.stack(starts, dim=1)[:, :, None, :]  # (B, n, 1, H)

    us = (alpha * a_pow_j) * starts + intra  # alpha^{j+1} u_start + intra
    return us.reshape(B, n * L, H)[:, :T, :]


def readout_sum(Wx, alpha, u0):
    """Non-spiking leaky readout: cumulative softmax of the membrane,
    ``(B,T,H) -> (B,H)``, through the chunked closed form."""
    alpha = _clip(alpha, ALPHA_LIM).to(Wx.dtype)
    us = leaky_cumsum(Wx, alpha, u0)
    return torch.softmax(us, dim=-1).sum(dim=1)


def readout_sum_scan(Wx, alpha, u0):
    """Sequential formulation of :func:`readout_sum` (its semantics
    oracle)."""
    alpha = _clip(alpha, ALPHA_LIM).to(Wx.dtype)
    u = u0
    out = torch.zeros_like(u0)
    for t in range(Wx.shape[1]):
        u = alpha * u + (1.0 - alpha) * Wx[:, t]
        out = out + torch.softmax(u, dim=-1)
    return out


# ---------------------------------------------------------------------------
# Non-spiking (ANN) cells
# ---------------------------------------------------------------------------


def rnn_scan(Wx, V, y0):
    """Vanilla sigmoid RNN recurrence. ``Wx``: (B,T,H) -> y (B,T,H)."""
    V = V.to(Wx.dtype)
    y = y0
    out = []
    for t in range(Wx.shape[1]):
        y = torch.sigmoid(Wx[:, t] + torch.matmul(y, V))
        out.append(y)
    return torch.stack(out, dim=1)


def ligru_scan(Wx, Wzx, V, Vz, y0):
    """Light GRU (Ravanelli et al. 2018) recurrence with a ReLU candidate."""
    V, Vz = V.to(Wx.dtype), Vz.to(Wx.dtype)
    y = y0
    out = []
    for t in range(Wx.shape[1]):
        z = torch.sigmoid(Wzx[:, t] + torch.matmul(y, Vz))
        c = torch.relu(Wx[:, t] + torch.matmul(y, V))
        y = z * y + (1.0 - z) * c
        out.append(y)
    return torch.stack(out, dim=1)


def gru_scan(Wx, Wzx, Wrx, V, Vz, Vr, y0):
    """Full GRU (Cho et al. 2014) recurrence with a tanh candidate; the
    reset gate is applied before the recurrent product, ``(r*y) @ V``."""
    V, Vz, Vr = (m.to(Wx.dtype) for m in (V, Vz, Vr))
    y = y0
    out = []
    for t in range(Wx.shape[1]):
        z = torch.sigmoid(Wzx[:, t] + torch.matmul(y, Vz))
        r = torch.sigmoid(Wrx[:, t] + torch.matmul(y, Vr))
        c = torch.tanh(Wx[:, t] + torch.matmul(r * y, V))
        y = z * y + (1.0 - z) * c
        out.append(y)
    return torch.stack(out, dim=1)


def cumulative_softmax(x):
    """The ANN readout's collapse of time: ``sum_t softmax(x_t)``,
    ``(B,T,H) -> (B,H)``, summed in float32 (a float64 input stays
    float64)."""
    if x.dtype != torch.float64:
        x = x.float()
    return torch.softmax(x, dim=-1).sum(dim=1)
