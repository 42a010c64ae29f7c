"""Spiking neural networks (counterpart of sparch_tpu/models/snn.py).

Multi-layer stacks of {LIF, adLIF, RLIF, RadLIF} neurons with a
non-spiking cumulative-softmax readout. Each layer hoists its input
projection into one time-batched matmul and runs the state recurrence
either as a plain PyTorch loop (``ops.cells``) or through the fused CUDA
kernel (``ops.fused_cells``), which also applies BatchNorm as an affine on
load.

    model = SNN((B, T, F), [512, 512, 35], neuron_type="RadLIF")
    out, firing_rates = model(x)              # x: (B, T, F)

Eval/train mode is the module's (``model.eval()``); a uniform state init,
the dropout seed of the fused path and the dropout mask of the plain path
draw from the ``generator`` given to ``forward``. Both paths are
differentiable: the fused one through the backward kernels.

``compute_dtype=torch.bfloat16``: every projection runs and emits in bf16
(parameters stay float32), the fused cells run in their bf16-stream mode on
that bf16 drive and hand bf16 spikes to the next layer, and the readout's
membrane recurrence runs in float32. ``remat=True`` recomputes each hidden
layer in the backward instead of keeping its residuals.

``cell_impl='pallas_tp'`` with ``tp_mesh=parallel.make_mesh([dev] * P,
model=P)`` runs each hidden layer's recurrence split over the P ranks of the
mesh's ``tp_axis`` (``ops.fused_tp``): RLIF and RadLIF through the
tensor-parallel kernels, LIF and adLIF through the fused cell on each
rank's block, in the bf16-stream mode under ``compute_dtype=bfloat16``. The
norm is applied to the drive and the dropout drawn from the run's
generator, both outside the kernels, as on the scan path; the readout is
the plain one. A mesh across cards (``make_mesh([cuda:0, .., cuda:P-1],
model=P)``) takes the same path: the layer lives on the mesh's ``home``
card, its projections, norms and readout run there, and only the cell runs
one rank a card (the entry points scatter and gather), with the one-card
form's bits. ``tp_batch_axis`` is kept for the JAX model records: the
port's ``data`` axis is the processes of a data-parallel run.

Under data parallelism (``parallel.multihost``) a rank's forward is its
slice of the global batch's: the uniform initial states and the dropout
are drawn for the global batch (``multihost.batch_rows``), BatchNorm takes
the global statistics and the firing rates are the global batch's means.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from sparch_tpu_torch.models.common import (
    Dense,
    FusedCellPolicy,
    SeqNorm,
    bidir_concat,
    check_precision_fields,
    remat_layer,
)
from sparch_tpu_torch.ops import cells, fused_cells, fused_tp
from sparch_tpu_torch.parallel import multihost

__all__ = [
    "SNN",
    "LIFLayer",
    "adLIFLayer",
    "RLIFLayer",
    "RadLIFLayer",
    "ReadoutLayer",
    "SNN_NEURON_TYPES",
]

SNN_NEURON_TYPES = ("LIF", "adLIF", "RLIF", "RadLIF")


def _uniform_(t: torch.Tensor, lim, generator):
    with torch.no_grad():
        t.uniform_(lim[0], lim[1], generator=generator)


def _init_states(like: torch.Tensor, n: int, mode: str, generator,
                 rows=None):
    """``n`` initial states of ``like``'s rows, drawn for the global
    batch (``rows``, a ``multihost.RowMap``) and cut to the rank's."""
    shape = (like.shape[0], like.shape[2])
    return [
        multihost.draw_rows(
            lambda s: cells.init_state(generator, s, like.dtype, mode,
                                       like.device), shape, rows)
        for _ in range(n)
    ]


class _SpikingLayerBase(FusedCellPolicy, nn.Module):
    """Shared scaffolding: bidirectional batch trick, hoisted projection,
    norm, cell, dropout. Subclasses set ``recurrent``/``adaptive`` and
    define ``_cell``."""

    recurrent = False
    adaptive = False

    def __init__(self, input_size: int, hidden_size: int,
                 threshold: float = 1.0, dropout: float = 0.0,
                 normalization: str = "batchnorm", use_bias: bool = False,
                 bidirectional: bool = False, state_init: str = "uniform",
                 cell_impl: str = "auto", compute_dtype=None,
                 mxu_precision: str = "default", tp_mesh=None,
                 tp_axis: str = "model",
                 tp_batch_axis: Optional[str] = "data"):
        super().__init__()
        dense_dtype = check_precision_fields(compute_dtype, mxu_precision)
        self.tp_mesh = tp_mesh
        self.tp_axis = tp_axis
        self.tp_batch_axis = tp_batch_axis
        self.compute_dtype = compute_dtype
        self.mxu_precision = mxu_precision
        self.hidden_size = hidden_size
        self.threshold = threshold
        self.dropout = dropout
        self.normalization = normalization
        self.bidirectional = bidirectional
        self.state_init = state_init
        self.cell_impl = cell_impl
        self.W = Dense(input_size, hidden_size, use_bias, dtype=dense_dtype)
        self.norm = SeqNorm(normalization, hidden_size)
        self.alpha = nn.Parameter(torch.empty(hidden_size))
        if self.adaptive:
            self.beta = nn.Parameter(torch.empty(hidden_size))
            self.a = nn.Parameter(torch.empty(hidden_size))
            self.b = nn.Parameter(torch.empty(hidden_size))
        if self.recurrent:
            self.V = nn.Parameter(torch.empty(hidden_size, hidden_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.W.reset_parameters(generator)
        self.norm.reset_parameters()
        _uniform_(self.alpha, cells.ALPHA_LIM, generator)
        if self.adaptive:
            _uniform_(self.beta, cells.BETA_LIM, generator)
            _uniform_(self.a, cells.A_LIM, generator)
            _uniform_(self.b, cells.B_LIM, generator)
        if self.recurrent:
            with torch.no_grad():
                nn.init.orthogonal_(self.V, generator=generator)

    def _fold_norm(self, x) -> bool:
        """On the fused path batchnorm/none fold into the kernel as an
        affine on the drive; layernorm (per-sample stats) cannot."""
        return self._use_fused(x) and self.normalization != "layernorm"

    def _pre(self, x):
        """Hoisted projection + norm -> (Wx, scale, shift); scale/shift are
        None where the norm was applied to Wx here. On the fold path Wx
        keeps the type the projection emitted (bf16 under
        ``compute_dtype=bfloat16``): it is not cast here, so the float32
        mode keeps its exact spike trains."""
        if self.bidirectional:
            x = bidir_concat(x)
        Wx = self.W(x)
        if self._fold_norm(x):
            scale, shift = self.norm.affine(Wx)
            return Wx, scale, shift
        return self.norm(Wx), None, None

    def forward(self, x, generator: Optional[torch.Generator] = None):
        rows = multihost.batch_rows(x.shape[0])
        Wx, scale, shift = self._pre(x)
        fused = self._use_fused(x)
        n = 3 if self.adaptive else 2
        states = _init_states(Wx, n, self.state_init, generator, rows)
        drop = dict(self._fused_dropout(fused, Wx, generator),
                    drop_rows=rows)
        s = self._cell(Wx, scale, shift, states, fused, drop)
        return self._post(s, fused, generator, rows)

    def _cell(self, Wx, scale, shift, states, fused, drop):
        raise NotImplementedError


class LIFLayer(_SpikingLayerBase):
    """Feedforward leaky integrate-and-fire layer."""

    def _cell(self, Wx, scale, shift, states, fused, drop):
        u0, s0 = states
        if self.cell_impl == "pallas_tp":
            mesh, axis, _ = self._tp()
            return fused_tp.lif_tp(Wx, self.alpha, self.threshold, u0, s0,
                                   mesh=mesh, tp_axis=axis,
                                   mxu_bf16=self._mxu_bf16())
        if fused:
            return fused_cells.lif_fused(
                Wx, self.alpha, self.threshold, u0, s0, scale=scale,
                shift=shift, mxu_bf16=self._mxu_bf16(), **drop,
            )
        return cells.lif_scan(Wx, self.alpha, self.threshold, u0, s0)


class adLIFLayer(_SpikingLayerBase):
    """Adaptive LIF layer with adaptation current."""

    adaptive = True

    def _cell(self, Wx, scale, shift, states, fused, drop):
        u0, w0, s0 = states
        if self.cell_impl == "pallas_tp":
            mesh, axis, _ = self._tp()
            return fused_tp.adlif_tp(Wx, self.alpha, self.beta, self.a,
                                     self.b, self.threshold, u0, w0, s0,
                                     mesh=mesh, tp_axis=axis,
                                     mxu_bf16=self._mxu_bf16())
        if fused:
            return fused_cells.adlif_fused(
                Wx, self.alpha, self.beta, self.a, self.b, self.threshold,
                u0, w0, s0, scale=scale, shift=shift,
                mxu_bf16=self._mxu_bf16(), **drop,
            )
        return cells.adlif_scan(Wx, self.alpha, self.beta, self.a, self.b,
                                self.threshold, u0, w0, s0)


class RLIFLayer(_SpikingLayerBase):
    """Recurrent LIF layer with a zero-diagonal orthogonal V."""

    recurrent = True

    def _cell(self, Wx, scale, shift, states, fused, drop):
        u0, s0 = states
        if self.cell_impl == "pallas_tp":
            mesh, axis, _ = self._tp()
            return fused_tp.rlif_tp(Wx, self.alpha, self.V, self.threshold,
                                    u0, s0, mesh=mesh, tp_axis=axis,
                                    mxu_bf16=self._mxu_bf16())
        if fused:
            return fused_cells.rlif_fused(
                Wx, self.alpha, self.V, self.threshold, u0, s0, scale=scale,
                shift=shift, mxu_bf16=self._mxu_bf16(), **drop,
            )
        return cells.rlif_scan(Wx, self.alpha, self.V, self.threshold,
                               u0, s0)


class RadLIFLayer(_SpikingLayerBase):
    """Recurrent adaptive LIF layer, the strongest spiking model."""

    recurrent = True
    adaptive = True

    def _cell(self, Wx, scale, shift, states, fused, drop):
        u0, w0, s0 = states
        if self.cell_impl == "pallas_tp":
            mesh, axis, _ = self._tp()
            return fused_tp.radlif_tp(Wx, self.alpha, self.beta, self.a,
                                      self.b, self.V, self.threshold, u0, w0,
                                      s0, mesh=mesh, tp_axis=axis,
                                      mxu_bf16=self._mxu_bf16())
        if fused:
            return fused_cells.radlif_fused(
                Wx, self.alpha, self.beta, self.a, self.b, self.V,
                self.threshold, u0, w0, s0, scale=scale, shift=shift,
                mxu_bf16=self._mxu_bf16(), **drop,
            )
        return cells.radlif_scan(Wx, self.alpha, self.beta, self.a, self.b,
                                 self.V, self.threshold, u0, w0, s0)


def readout_fused_route(cell_impl: str, on_cuda: bool) -> bool:
    """Whether the readout takes ``fused_cells.readout_fused`` (the fused
    kernels on a CUDA tensor, their plain versions on a CPU one) rather
    than ``cells.readout_sum``: always under 'pallas', and under 'auto'
    for a CUDA tensor. The JAX package keeps ``readout_sum`` for 'auto'
    because the class dim pads to 128 lanes in its TPU kernel; on the card
    ``readout_sum`` is ~150 small kernels a step, so 'auto' takes the
    kernels there, as it takes the fused cells, at any class count. A CPU
    tensor under 'auto', 'scan' and 'pallas_tp' keep ``readout_sum``, as
    in the JAX package."""
    return cell_impl == "pallas" or (cell_impl == "auto" and on_cuda)


class ReadoutLayer(nn.Module):
    """Non-spiking leaky readout producing ``(B, labels)`` as a cumulative
    softmax of the membrane, through the fused readout or the chunked
    closed form ``cells.readout_sum`` (``readout_fused_route``)."""

    def __init__(self, input_size: int, hidden_size: int,
                 normalization: str = "batchnorm", use_bias: bool = False,
                 state_init: str = "uniform", cell_impl: str = "auto",
                 compute_dtype=None):
        super().__init__()
        self.state_init = state_init
        self.cell_impl = cell_impl
        self.W = Dense(input_size, hidden_size, use_bias,
                       dtype=check_precision_fields(compute_dtype, "default"))
        self.norm = SeqNorm(normalization, hidden_size)
        self.alpha = nn.Parameter(torch.empty(hidden_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.W.reset_parameters(generator)
        self.norm.reset_parameters()
        _uniform_(self.alpha, cells.ALPHA_LIM, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        Wx = self.norm(self.W(x))
        if Wx.dtype == torch.bfloat16:
            # the membrane recurrence always runs in float32: it is tiny
            # and feeds the loss
            Wx = Wx.float()
        (u0,) = _init_states(Wx, 1, self.state_init, generator,
                             multihost.batch_rows(Wx.shape[0]))
        if readout_fused_route(self.cell_impl, Wx.is_cuda):
            return fused_cells.readout_fused(Wx, self.alpha, u0)
        return cells.readout_sum(Wx, self.alpha, u0)


_LAYER_CLASSES = {
    "LIF": LIFLayer,
    "adLIF": adLIFLayer,
    "RLIF": RLIFLayer,
    "RadLIF": RadLIFLayer,
}


class SNN(nn.Module):
    """A multi-layered spiking neural network.

    Takes ``(batch, time, feat)`` inputs (4-D ``(batch, time, feat, chan)``
    inputs are flattened to 3-D) and returns ``(output, firing_rates)``:
    the readout's ``(B, classes)`` (or the top layer's spikes without a
    readout) and the mean firing rate of every hidden neuron, shape
    ``(sum of hidden widths,)`` (2H per bidirectional layer). Hidden
    layers are the submodules ``layer_0``, ``layer_1``, ...; the readout
    is ``readout``.

    ``compute_dtype`` (None or float32, or bfloat16 for mixed precision),
    ``mxu_precision``, ``remat`` and, for ``cell_impl='pallas_tp'``,
    ``tp_mesh``, ``tp_axis`` and ``tp_batch_axis`` as in the JAX package (see
    the module docstring and ``common.FusedCellPolicy``).
    """

    is_snn = True

    def __init__(self, input_shape: Tuple, layer_sizes: Sequence[int],
                 neuron_type: str = "LIF", threshold: float = 1.0,
                 dropout: float = 0.0, normalization: str = "batchnorm",
                 use_bias: bool = False, bidirectional: bool = False,
                 use_readout_layer: bool = True, state_init: str = "uniform",
                 cell_impl: str = "auto", compute_dtype=None,
                 mxu_precision: str = "default", remat: bool = False,
                 tp_mesh=None, tp_axis: str = "model",
                 tp_batch_axis: Optional[str] = "data",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_precision_fields(compute_dtype, mxu_precision)
        if neuron_type not in _LAYER_CLASSES:
            raise ValueError(f"Invalid neuron type {neuron_type}")
        if use_readout_layer and len(layer_sizes) < 2:
            raise ValueError(
                "use_readout_layer=True needs at least one hidden layer "
                "(nb_layers >= 2)"
            )
        self.input_shape = tuple(input_shape)
        self.layer_sizes = tuple(layer_sizes)
        self.neuron_type = neuron_type
        self.threshold = threshold
        self.normalization = normalization
        self.bidirectional = bidirectional
        self.use_readout_layer = use_readout_layer
        self.state_init = state_init
        self.cell_impl = cell_impl
        self.compute_dtype = compute_dtype
        self.mxu_precision = mxu_precision
        self.remat = remat
        self.tp_mesh = tp_mesh
        self.tp_axis = tp_axis
        self.tp_batch_axis = tp_batch_axis

        layer_cls = _LAYER_CLASSES[neuron_type]
        width = math.prod(self.input_shape[2:])
        for i in range(self.num_hidden):
            layer = layer_cls(
                width, self.layer_sizes[i], threshold=threshold,
                dropout=dropout, normalization=normalization,
                use_bias=use_bias, bidirectional=bidirectional,
                state_init=state_init, cell_impl=cell_impl,
                compute_dtype=compute_dtype, mxu_precision=mxu_precision,
                tp_mesh=tp_mesh, tp_axis=tp_axis, tp_batch_axis=tp_batch_axis,
            )
            self.add_module(f"layer_{i}", layer)
            width = self.layer_sizes[i] * (2 if bidirectional else 1)
        if use_readout_layer:
            self.readout = ReadoutLayer(
                width, self.layer_sizes[-1], normalization=normalization,
                use_bias=use_bias, state_init=state_init,
                cell_impl=cell_impl, compute_dtype=compute_dtype,
            )
        if generator is not None:
            self.reset_parameters(generator)

    @property
    def num_layers(self) -> int:
        return len(self.layer_sizes)

    @property
    def num_outputs(self) -> int:
        return self.layer_sizes[-1]

    @property
    def num_hidden(self) -> int:
        return self.num_layers - 1 if self.use_readout_layer else \
            self.num_layers

    def hidden_layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_hidden)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in self.hidden_layers():
            layer.reset_parameters(generator)
        if self.use_readout_layer:
            self.readout.reset_parameters(generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if x.ndim == 4:
            x = x.reshape(x.shape[0], x.shape[1], -1)
        elif x.ndim != 3:
            raise NotImplementedError(f"Unsupported input rank {x.ndim}")
        all_spikes = []
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.hidden_layers():
            x = remat_layer(layer, x, generator) if remat \
                else layer(x, generator)
            all_spikes.append(x)
        if self.use_readout_layer:
            x = self.readout(x, generator)
        # per-layer means before concatenating: no (B, T, sum H) stack;
        # the global batch's under data parallelism
        firing_rates = multihost.mean_over_ranks(torch.cat(
            [s.float().mean(dim=(0, 1)) for s in all_spikes]
        ), "rates")
        return x, firing_rates
