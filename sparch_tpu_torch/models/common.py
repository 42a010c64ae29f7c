"""Shared building blocks for the SNN and ANN layer stacks (counterpart of
sparch_tpu/models/common.py).

- Feedforward weights and biases: U[-1/sqrt(fan_in), 1/sqrt(fan_in)],
  ``torch.nn.Linear``'s default; recurrent matrices orthogonal; neuron
  constants uniform over their plausible range.
- Normalisation runs over the flattened ``(B*T, H)`` activations: BatchNorm
  with flax's conventions (momentum 0.95 on the running average, biased
  batch variance), or LayerNorm; any other kind is the identity.
- On the fused-kernel path BatchNorm is applied inside the kernel as the
  per-feature affine ``scale*x + shift`` (:meth:`SeqNorm.affine`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

__all__ = [
    "BN_MOMENTUM",
    "NORM_EPS",
    "torch_linear_init",
    "Dense",
    "SeqNorm",
    "FusedCellPolicy",
    "bidir_concat",
    "bidir_split",
]

# flax momentum 0.95 == torch BatchNorm1d(momentum=0.05)
BN_MOMENTUM = 0.95
NORM_EPS = 1e-5


def torch_linear_init(t: torch.Tensor, fan_in: int,
                      generator: Optional[torch.Generator] = None):
    """Fill ``t`` with U[-1/sqrt(fan_in), 1/sqrt(fan_in)] in place."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Dense(nn.Module):
    """Linear layer with torch-default init. ``weight`` is (out, in); the
    product is one ``torch.matmul`` over all leading dims."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.weight.shape[1]
        torch_linear_init(self.weight, fan_in, generator)
        if self.bias is not None:
            torch_linear_init(self.bias, fan_in, generator)

    def forward(self, x):
        y = torch.matmul(x, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return y


class SeqNorm(nn.Module):
    """Normalisation over flattened ``(B*T, H)``: ``kind`` is 'batchnorm'
    or 'layernorm'; anything else is the identity and holds no tensors.

    ``forward`` applies the norm (flax ``nn.BatchNorm`` / ``nn.LayerNorm``
    arithmetic); :meth:`affine` returns BatchNorm as the per-feature
    ``(scale, shift)`` a fused kernel applies on load (flax
    ``SeqNormAffine`` / ``_BNAffine``). Both read and, in training mode,
    update the same running statistics.
    """

    def __init__(self, kind: str, features: int):
        super().__init__()
        self.kind = kind
        if kind in ("batchnorm", "layernorm"):
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        if kind == "batchnorm":
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self):
        if self.kind in ("batchnorm", "layernorm"):
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()
        if self.kind == "batchnorm":
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def _update_running(self, mean, var):
        with torch.no_grad():
            m = BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x):
        if self.kind == "batchnorm":
            shape = x.shape
            flat = x.reshape(-1, shape[-1])
            if self.training:
                mean = flat.mean(dim=0)
                mean2 = (flat * flat).mean(dim=0)
                var = torch.clamp_min(mean2 - mean * mean, 0.0)
                self._update_running(mean, var)
            else:
                mean, var = self.running_mean, self.running_var
            mul = torch.rsqrt(var + NORM_EPS) * self.weight
            return ((flat - mean) * mul + self.bias).reshape(shape)
        if self.kind == "layernorm":
            mean = x.mean(dim=-1, keepdim=True)
            mean2 = (x * x).mean(dim=-1, keepdim=True)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            mul = torch.rsqrt(var + NORM_EPS) * self.weight
            return (x - mean) * mul + self.bias
        return x

    def affine(self, x) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
        """``(scale, shift)`` with ``scale = gamma * rsqrt(var + eps)`` and
        ``shift = beta - mean * scale``, from the batch statistics of ``x``
        in training mode and the running ones in eval; ``(None, None)`` for
        the identity. LayerNorm normalises per sample and has no such
        form."""
        if self.kind == "batchnorm":
            if self.training:
                flat = x.reshape(-1, x.shape[-1])
                if flat.dtype != torch.float64:
                    flat = flat.float()  # statistics in float32 at least
                mean = flat.mean(dim=0)
                mean2 = (flat * flat).mean(dim=0)
                var = mean2 - mean * mean
                self._update_running(mean, var)
            else:
                mean, var = self.running_mean, self.running_var
            scale = self.weight * torch.rsqrt(var + NORM_EPS)
            shift = self.bias - mean * scale
            return scale, shift
        if self.kind == "layernorm":
            raise ValueError("layernorm cannot fold to a feature affine")
        return None, None


def bidir_concat(x):
    """Stack the time-flipped sequence on the batch dim so one recurrence
    handles both directions."""
    return torch.cat([x, torch.flip(x, dims=[1])], dim=0)


def bidir_split(s):
    """Undo :func:`bidir_concat`: split the batch halves, re-flip the
    backward half, concatenate on features (width 2H)."""
    b = s.shape[0] // 2
    return torch.cat([s[:b], torch.flip(s[b:], dims=[1])], dim=-1)


class FusedCellPolicy:
    """When a layer takes the fused CUDA kernels (flax
    ``FusedCellPolicy._use_pallas``), and the dropout and bidirectional
    re-merge that follow the cell on either path, in one place for the
    spiking and the non-spiking layers. The inheriting module defines
    ``hidden_size``, ``cell_impl``, ``dropout``, ``bidirectional`` and
    ``training``.

    ``cell_impl``: 'pallas' always takes the fused path (its plain version
    on a CPU tensor); 'auto' takes it for every CUDA tensor, so a layer
    wider than the kernel takes raises there instead of running a plain
    loop on the card; 'scan' never. The JAX name 'pallas' is kept so that
    saved model records map one to one.
    """

    def _use_fused(self, x: torch.Tensor) -> bool:
        if self.cell_impl == "pallas":
            return True
        if self.cell_impl == "auto":
            return x.is_cuda
        if self.cell_impl == "scan":
            return False
        raise ValueError(f"Invalid cell_impl {self.cell_impl}")

    def _fused_dropout(self, fused: bool, like: torch.Tensor, generator):
        """``dict(drop_rate, drop_seed)`` for the in-kernel dropout: while
        training with dropout on the fused path, the rate and two int32
        drawn from ``generator`` on the layer's device (no host sync);
        otherwise rate 0 and no seed. The mask is drawn per element before
        the bidirectional split, as in the JAX package."""
        if not (fused and self.training and self.dropout > 0):
            return dict(drop_rate=0.0, drop_seed=None)
        seed = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                             dtype=torch.int32, device=like.device)
        return dict(drop_rate=float(self.dropout), drop_seed=seed)

    def _post(self, out, fused: bool, generator):
        """Bidirectional re-merge, then (unless the kernel dropped the
        output already) dropout."""
        if self.bidirectional:
            out = bidir_split(out)
        if fused or not (self.training and self.dropout > 0):
            return out  # dropped in the kernel, or not at all
        # inverted dropout with the mask drawn from the run's generator
        keep = torch.rand(out.shape, generator=generator, dtype=out.dtype,
                          device=out.device) >= self.dropout
        return out * keep * (1.0 / (1.0 - self.dropout))
