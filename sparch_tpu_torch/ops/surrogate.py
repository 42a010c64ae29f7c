"""Surrogate-gradient spike function (counterpart of sparch_tpu/ops/surrogate.py).

Forward is the Heaviside step ``x > 0``; backward passes the incoming
gradient through on the half-open window ``-0.5 < x <= 0.5`` and zeroes it
outside (the boxcar surrogate of the original sparch).
"""
from __future__ import annotations

import torch

__all__ = ["spike_boxcar", "boxcar_window"]


def boxcar_window(x: torch.Tensor) -> torch.Tensor:
    """Boxcar surrogate derivative: 1 on ``-0.5 < x <= 0.5``, else 0."""
    return ((x > -0.5) & (x <= 0.5)).to(x.dtype)


class _SpikeBoxcar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x > 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * boxcar_window(x)


def spike_boxcar(x: torch.Tensor) -> torch.Tensor:
    """Heaviside spike with boxcar surrogate gradient."""
    return _SpikeBoxcar.apply(x)
