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
- ``compute_dtype=torch.bfloat16`` (mixed precision, by explicit casts):
  a :class:`Dense` casts its input and its weight to bf16 where it uses
  them and emits bf16, the normalisations take their sums in float32 over
  the bf16 stream, and the fused kernels run in their bf16-stream mode
  (:meth:`FusedCellPolicy._mxu_bf16`). Parameters, running statistics and
  the optimizer's moments stay float32.
- Under data parallelism, inside ``parallel.multihost.sharded()``, a
  rank's batch is a slice of the global batch, and every layer computes
  its slice of the global step: BatchNorm's statistics are the global batch's (one all-reduce of
  the stacked ``[mean, mean2]``, whose backward all-reduces the gradient),
  and the dropout masks and seeds are drawn for the global batch, each rank
  keeping its rows (``FusedCellPolicy``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from sparch_tpu_torch.parallel import multihost

__all__ = [
    "BN_MOMENTUM",
    "NORM_EPS",
    "torch_linear_init",
    "Dense",
    "rec_dot",
    "SeqNorm",
    "FusedCellPolicy",
    "check_precision_fields",
    "remat_layer",
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


class _CastLinear(torch.autograd.Function):
    """``x @ W^T (+ bias)`` in the type of ``x`` with float32 parameters
    (JAX ``rec_dot`` and ``bias_add``): the weight and the bias are cast at
    use, and their gradients are summed in float32, not in the stream's
    type. A product of two bf16 values is exact in float32, so the weight
    gradient is the bf16 product with a float32 sum."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        y = torch.matmul(x, weight.to(x.dtype).t())
        return y if bias is None else y + bias.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = torch.matmul(g, weight.to(g.dtype)) \
            if ctx.needs_input_grad[0] else None
        g2 = g.reshape(-1, g.shape[-1]).to(weight.dtype)
        dw = torch.matmul(g2.t(), x.reshape(-1, x.shape[-1]).to(weight.dtype))
        return dx, dw, g2.sum(dim=0) if ctx.has_bias else None


class Dense(nn.Module):
    """Linear layer with torch-default init. ``weight`` is (out, in); the
    product is one ``torch.matmul`` over all leading dims.

    ``dtype`` as flax's: the input and the float32 parameters are cast to
    it where they are used and the output comes in it. With ``dtype=None``
    nothing is cast but an input of a narrower type than the weight (a bf16
    spike raster), which is promoted to the weight's."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.weight.shape[1]
        torch_linear_init(self.weight, fan_in, generator)
        if self.bias is not None:
            torch_linear_init(self.bias, fan_in, generator)

    def forward(self, x):
        if self.dtype is not None:
            return _CastLinear.apply(x.to(self.dtype), self.weight, self.bias)
        if x.dtype != self.weight.dtype:
            x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        y = torch.matmul(x, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return y


def rec_dot(a, V):
    """``a @ V`` in the type of ``a`` (JAX ``cells.rec_dot``): where ``a``
    is narrower than the float32 ``V`` (a bf16 stream), ``V`` is cast
    where it is used and its gradient summed in float32, as
    :class:`Dense` does with its weight."""
    if a.dtype == V.dtype:
        return torch.matmul(a, V)
    return _CastLinear.apply(a, V.t(), None)


def _batch_moments(flat):
    """``(mean, mean2)`` over the rows of ``flat``, of the global batch
    inside ``multihost.sharded()`` (each rank holds as many rows): one
    all-reduce of the pair stacked."""
    mean, mean2 = flat.mean(dim=0), (flat * flat).mean(dim=0)
    if not multihost.is_sharded():
        return mean, mean2
    stacked = torch.stack([mean, mean2])
    return multihost.mean_over_ranks(stacked, "stats").unbind(0)


class SeqNorm(nn.Module):
    """Normalisation over flattened ``(B*T, H)``: ``kind`` is 'batchnorm'
    or 'layernorm'; anything else is the identity and holds no tensors.

    ``forward`` applies the norm (flax ``nn.BatchNorm`` / ``nn.LayerNorm``
    arithmetic); :meth:`affine` returns BatchNorm as the per-feature
    ``(scale, shift)`` a fused kernel applies on load (flax
    ``SeqNormAffine`` / ``_BNAffine``). Both read and, in training mode,
    update the same running statistics. A bf16 stream is read up to
    float32 first: the sums are float32 and so is what ``forward`` returns
    (the identity returns its input as it is).
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
        if self.kind in ("batchnorm", "layernorm") and \
                x.dtype == torch.bfloat16:
            x = x.float()
        if self.kind == "batchnorm":
            shape = x.shape
            flat = x.reshape(-1, shape[-1])
            if self.training:
                mean, mean2 = _batch_moments(flat)
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
                mean, mean2 = _batch_moments(flat)
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

    ``compute_dtype`` and ``mxu_precision`` (kept for the JAX model
    records; 'default' or 'highest'): the fused kernels run in their
    bf16-stream mode exactly when ``compute_dtype`` is bfloat16. The JAX
    policy's other clause, ``mxu_precision='default'`` on a TPU, follows
    that chip's default product precision; a float32 product on a CUDA card
    is float32 by default, so here ``mxu_precision`` selects nothing.

    ``cell_impl``: 'pallas' always takes the fused path (its plain version
    on a CPU tensor); 'auto' takes it for every CUDA tensor, so a layer
    wider than the kernel takes raises there instead of running a plain
    loop on the card; 'scan' never. The JAX name 'pallas' is kept so that
    saved model records map one to one. 'pallas_tp' is a path of its own
    (``_tp``), not the fused one.
    """

    def _use_fused(self, x: torch.Tensor) -> bool:
        if self.cell_impl == "pallas":
            return True
        if self.cell_impl == "auto":
            return x.is_cuda
        if self.cell_impl in ("scan", "pallas_tp"):
            return False
        raise ValueError(f"Invalid cell_impl {self.cell_impl}")

    def _tp(self):
        """(mesh, axis, batch_axis) of the ``cell_impl='pallas_tp'`` path
        (JAX ``FusedCellPolicy._tp``). Normalisation and dropout stay
        outside the TP kernels: the norm is applied to the drive, and
        ``_post`` drops the output with a mask from the run's generator,
        as on the scan path. The mesh may hold its ranks on one card or one
        a card; either way the layer's tensors are on its ``home``. The
        inheriting module defines ``tp_mesh``, ``tp_axis`` and
        ``tp_batch_axis``."""
        if self.tp_mesh is None:
            raise ValueError(
                "cell_impl='pallas_tp' needs tp_mesh=<sparch_tpu_torch."
                "parallel.Mesh with a '%s' axis>" % self.tp_axis
            )
        return self.tp_mesh, self.tp_axis, self.tp_batch_axis

    def _mxu_bf16(self) -> bool:
        return self.compute_dtype == torch.bfloat16

    def _fused_dropout(self, fused: bool, like: torch.Tensor, generator):
        """``dict(drop_rate, drop_seed)`` for the in-kernel dropout: while
        training with dropout on the fused path, the rate and two int32
        drawn from ``generator`` on the layer's device (no host sync);
        otherwise rate 0 and no seed. The mask is drawn per element before
        the bidirectional split, as in the JAX package; the layer passes
        the kernels ``drop_rows`` too, so that they hash the global batch's
        rows."""
        if not (fused and self.training and self.dropout > 0):
            return dict(drop_rate=0.0, drop_seed=None)
        seed = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                             dtype=torch.int32, device=like.device)
        return dict(drop_rate=float(self.dropout), drop_seed=seed)

    def _post(self, out, fused: bool, generator, rows=None):
        """Bidirectional re-merge, then (unless the kernel dropped the
        output already) dropout, its mask drawn for the global batch
        (``rows``) and cut to the rank's rows."""
        if self.bidirectional:
            out = bidir_split(out)
        if fused or not (self.training and self.dropout > 0):
            return out  # dropped in the kernel, or not at all
        # inverted dropout with the mask drawn from the run's generator
        draw = torch.float32 if out.dtype == torch.bfloat16 else out.dtype
        keep = multihost.draw_rows(
            lambda shape: torch.rand(shape, generator=generator, dtype=draw,
                                     device=out.device),
            out.shape, rows) >= self.dropout
        return out * keep * (1.0 / (1.0 - self.dropout))


def check_precision_fields(compute_dtype, mxu_precision: str):
    """Validate a model's ``compute_dtype`` (None, float32 or bfloat16) and
    ``mxu_precision``; returns the ``dtype`` of its ``Dense`` layers (None
    for float32, as in the JAX package)."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"Invalid compute_dtype {compute_dtype}")
    if mxu_precision not in ("default", "highest"):
        raise ValueError(f"Invalid mxu_precision {mxu_precision}")
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else None


def remat_layer(layer: nn.Module, x, generator):
    """``layer(x, generator)`` rematerialised (flax ``nn.remat``): its
    residuals are dropped after the forward and the backward recomputes the
    layer from its input.

    The recomputation must see the forward's random draws (dropout seed or
    mask, uniform states), and they come from an explicit generator that
    ``torch.utils.checkpoint`` does not restore. So the generator's state
    at entry is kept, the recomputation replays from it, and the state the
    generator had reached by then is put back afterwards. The running
    statistics are put back too: only the forward itself may move them."""
    from torch.utils.checkpoint import checkpoint

    if generator is None:
        entry = None
    else:
        entry = generator.get_state()
    forward_done = []

    def run(x):
        if not forward_done:
            forward_done.append(True)
            return layer(x, generator)
        buffers = [b.detach().clone() for b in layer.buffers()]
        now = generator.get_state() if generator is not None else None
        try:
            if generator is not None:
                generator.set_state(entry)
            return layer(x, generator)
        finally:
            if generator is not None:
                generator.set_state(now)
            with torch.no_grad():
                for b, saved in zip(layer.buffers(), buffers):
                    b.copy_(saved)

    return checkpoint(run, x, use_reentrant=False)
