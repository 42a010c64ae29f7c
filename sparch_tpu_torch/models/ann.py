"""Non-spiking ANN baselines: MLP, RNN, LiGRU, GRU (counterpart of
sparch_tpu/models/ann.py).

The same layer scaffolding as the spiking stack: each gate's input
projection is hoisted into one time-batched matmul with its own
normalisation, and the state recurrence runs either as a plain PyTorch loop
(``ops.cells``) or through the fused CUDA kernels (``ops.fused_ann``), which
apply BatchNorm per gate as an affine on load. ``cell_impl='pallas_tp'``
runs the recurrence through the tensor-parallel kernels of
``ops.fused_tp_ann`` over the ranks of ``tp_mesh``; the norm is then applied
to each gate's drive and the dropout follows the cell, as on the scan path.
The ANN readout collapses time first (a sum of per-step softmaxes) and then
applies its linear layer and a 2-D norm, the opposite order of the SNN
readout.

    model = ANN((B, T, F), [512, 512, 35], ann_type="GRU")
    out, _ = model(x)                     # (out, None), like the SNN

Sub-modules are named as in the flax tree: ``layer_<i>.{W,Wz,Wr}`` (the
projections), ``layer_<i>.{norm_W,norm_Wz,norm_Wr}``, the parameters
``layer_<i>.{V,Vz,Vr}``, ``readout.W`` and ``readout.norm``. The initial
state is always zeros. Eval/train mode is the module's; the dropout seed of
the fused path and the dropout mask of the plain path draw from the
``generator`` given to ``forward``.

``compute_dtype=torch.bfloat16``: every projection runs and emits in bf16
(parameters stay float32); on the fused path each gate's raw bf16 stream
feeds the batch statistics (summed in float32), the kernel's affine and the
backward alike (the JAX layer casts the gate stream to bf16 once for this;
here the projection has emitted bf16 already), and the kernels run in their
bf16-stream mode, as the tensor-parallel ones do on the normalised drive.
The readout collapses time in float32. ``remat=True`` recomputes each hidden layer in
the backward instead of keeping its residuals.
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
from sparch_tpu_torch.ops import cells, fused_ann, fused_tp_ann
from sparch_tpu_torch.parallel import multihost

__all__ = [
    "ANN",
    "MLPLayer",
    "RNNLayer",
    "LiGRULayer",
    "GRULayer",
    "ReadoutLayerANN",
    "ANN_TYPES",
]

ANN_TYPES = ("MLP", "RNN", "LiGRU", "GRU")


class _ANNLayerBase(FusedCellPolicy, nn.Module):
    """Shared scaffolding: bidirectional batch trick, one hoisted
    projection and norm per gate, cell, dropout. Subclasses name their
    gates (``W`` the candidate, ``Wz`` the update, ``Wr`` the reset; each
    recurrent gate ``W*`` has a matrix ``V*``) and their two cells."""

    gates: Tuple[str, ...] = ("W",)
    recurrent = True
    _scan = None     # the plain cell of ops.cells
    _fused = None    # the fused cell of ops.fused_ann
    _tp_cell = None  # the tensor-parallel cell of ops.fused_tp_ann

    def __init__(self, input_size: int, hidden_size: int,
                 dropout: float = 0.0, normalization: str = "batchnorm",
                 use_bias: bool = False, bidirectional: bool = False,
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
        self.dropout = dropout
        self.normalization = normalization
        self.bidirectional = bidirectional
        self.cell_impl = cell_impl
        for name in self.gates:
            self.add_module(name, Dense(input_size, hidden_size, use_bias,
                                        dtype=dense_dtype))
            self.add_module(f"norm_{name}",
                            SeqNorm(normalization, hidden_size))
            if self.recurrent:
                self.register_parameter(
                    "V" + name[1:],
                    nn.Parameter(torch.empty(hidden_size, hidden_size)))
        self.reset_parameters()

    def _matrices(self):
        return [getattr(self, "V" + name[1:]) for name in self.gates]

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for name in self.gates:
            getattr(self, name).reset_parameters(generator)
            getattr(self, f"norm_{name}").reset_parameters()
        if self.recurrent:
            with torch.no_grad():
                for V in self._matrices():
                    # the full matrix: the ANN cells keep the diagonal
                    nn.init.orthogonal_(V, generator=generator)

    def _gate_projections(self, x, fold: bool):
        """Per-gate projections -> (wxs, scales, shifts). With ``fold``
        batchnorm becomes the per-gate affine that the kernel applies on
        load, from the statistics of the raw projection; otherwise the
        norm is applied here and there is no affine ('none' has none
        either way)."""
        wxs, scales, shifts = [], [], []
        for name in self.gates:
            Wx = getattr(self, name)(x)
            norm = getattr(self, f"norm_{name}")
            if fold:
                scale, shift = norm.affine(Wx)
                scales.append(scale)
                shifts.append(shift)
            else:
                Wx = norm(Wx)
            wxs.append(Wx)
        if not fold or scales[0] is None:
            return wxs, None, None
        return wxs, scales, shifts

    def forward(self, x, generator: Optional[torch.Generator] = None):
        rows = multihost.batch_rows(x.shape[0])
        if self.bidirectional:
            x = bidir_concat(x)
        fused = self._use_fused(x)
        fold = fused and self.normalization != "layernorm"
        wxs, scales, shifts = self._gate_projections(x, fold)
        # the fused cell carries its state in float32 at least
        state_dtype = torch.promote_types(wxs[0].dtype, torch.float32) \
            if fused else wxs[0].dtype
        y0 = torch.zeros((wxs[0].shape[0], wxs[0].shape[2]),
                         dtype=state_dtype, device=wxs[0].device)
        if fused:
            y = type(self)._fused(
                *wxs, *self._matrices(), y0, scales=scales, shifts=shifts,
                mxu_bf16=self._mxu_bf16(),
                **self._fused_dropout(fused, wxs[0], generator),
                drop_rows=rows)
        elif self.cell_impl == "pallas_tp":
            mesh, axis, _ = self._tp()
            y = type(self)._tp_cell(*wxs, *self._matrices(), y0, mesh=mesh,
                                    tp_axis=axis, mxu_bf16=self._mxu_bf16())
        else:
            y = type(self)._scan(*wxs, *self._matrices(), y0)
        return self._post(y, fused, generator, rows)


class MLPLayer(_ANNLayerBase):
    """Non-recurrent sigmoid layer: no state, no kernel."""

    recurrent = False

    def forward(self, x, generator: Optional[torch.Generator] = None):
        (Wx,), _, _ = self._gate_projections(x, fold=False)
        return self._post(torch.sigmoid(Wx), False, generator,
                          multihost.batch_rows(x.shape[0]))


class RNNLayer(_ANNLayerBase):
    """Vanilla sigmoid RNN layer with an orthogonal V."""

    _scan = staticmethod(cells.rnn_scan)
    _fused = staticmethod(fused_ann.rnn_fused)
    _tp_cell = staticmethod(fused_tp_ann.rnn_tp)


class LiGRULayer(_ANNLayerBase):
    """Light GRU layer (Ravanelli et al. 2018), a normalisation per gate."""

    gates = ("W", "Wz")
    _scan = staticmethod(cells.ligru_scan)
    _fused = staticmethod(fused_ann.ligru_fused)
    _tp_cell = staticmethod(fused_tp_ann.ligru_tp)


class GRULayer(_ANNLayerBase):
    """Full GRU layer (Cho et al. 2014)."""

    gates = ("W", "Wz", "Wr")
    _scan = staticmethod(cells.gru_scan)
    _fused = staticmethod(fused_ann.gru_fused)
    _tp_cell = staticmethod(fused_tp_ann.gru_tp)


class ReadoutLayerANN(nn.Module):
    """ANN readout: the sum of per-step softmaxes, then the linear layer
    and a norm on the 2-D ``(B, out)`` result."""

    def __init__(self, input_size: int, output_size: int,
                 normalization: str = "batchnorm", use_bias: bool = False,
                 compute_dtype=None):
        super().__init__()
        self.W = Dense(input_size, output_size, use_bias,
                       dtype=check_precision_fields(compute_dtype, "default"))
        self.norm = SeqNorm(normalization, output_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.W.reset_parameters(generator)
        self.norm.reset_parameters()

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.norm(self.W(cells.cumulative_softmax(x)))


_LAYER_CLASSES = {
    "MLP": MLPLayer,
    "RNN": RNNLayer,
    "LiGRU": LiGRULayer,
    "GRU": GRULayer,
}


class ANN(nn.Module):
    """A multi-layered non-spiking network.

    Takes ``(batch, time, feat)`` inputs (4-D inputs are flattened to 3-D)
    and returns ``(output, None)`` so that callers treat SNNs and ANNs
    alike: the readout's ``(B, classes)`` logits, or the top layer's
    ``(B, T, H)`` without a readout. Hidden layers are the submodules
    ``layer_0``, ``layer_1``, ...; the readout is ``readout``.

    ``compute_dtype`` (None or float32, or bfloat16 for mixed precision),
    ``mxu_precision`` and ``remat`` as in the JAX package (see the module
    docstring and ``common.FusedCellPolicy``). ``cell_impl='pallas_tp'``
    takes ``tp_mesh`` (``parallel.make_mesh``; its ``tp_axis`` splits the
    neurons of every recurrent layer) and raises without one when it runs;
    ``tp_batch_axis`` is kept for the JAX model records (a ``data`` axis
    longer than 1 is not ported).
    """

    is_snn = False

    def __init__(self, input_shape: Tuple, layer_sizes: Sequence[int],
                 ann_type: str = "MLP", dropout: float = 0.0,
                 normalization: str = "batchnorm", use_bias: bool = False,
                 bidirectional: bool = False, use_readout_layer: bool = True,
                 cell_impl: str = "auto", compute_dtype=None,
                 mxu_precision: str = "default", remat: bool = False,
                 tp_mesh=None, tp_axis: str = "model",
                 tp_batch_axis: Optional[str] = "data",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_precision_fields(compute_dtype, mxu_precision)
        if ann_type not in _LAYER_CLASSES:
            raise ValueError(f"Invalid ann type {ann_type}")
        if bidirectional and ann_type == "MLP":
            raise ValueError("MLP cannot be bidirectional.")
        if use_readout_layer and len(layer_sizes) < 2:
            raise ValueError(
                "use_readout_layer=True needs at least one hidden layer "
                "(nb_layers >= 2)"
            )
        self.input_shape = tuple(input_shape)
        self.layer_sizes = tuple(layer_sizes)
        self.ann_type = ann_type
        self.normalization = normalization
        self.bidirectional = bidirectional
        self.use_readout_layer = use_readout_layer
        self.cell_impl = cell_impl
        self.compute_dtype = compute_dtype
        self.mxu_precision = mxu_precision
        self.remat = remat

        layer_cls = _LAYER_CLASSES[ann_type]
        width = math.prod(self.input_shape[2:])
        for i in range(self.num_hidden):
            layer = layer_cls(
                width, self.layer_sizes[i], dropout=dropout,
                normalization=normalization, use_bias=use_bias,
                bidirectional=bidirectional, cell_impl=cell_impl,
                compute_dtype=compute_dtype, mxu_precision=mxu_precision,
                tp_mesh=tp_mesh, tp_axis=tp_axis, tp_batch_axis=tp_batch_axis,
            )
            self.add_module(f"layer_{i}", layer)
            width = self.layer_sizes[i] * (2 if bidirectional else 1)
        if use_readout_layer:
            self.readout = ReadoutLayerANN(
                width, self.layer_sizes[-1], normalization=normalization,
                use_bias=use_bias, compute_dtype=compute_dtype,
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
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.hidden_layers():
            x = remat_layer(layer, x, generator) if remat \
                else layer(x, generator)
        if self.use_readout_layer:
            x = self.readout(x, generator)
        return x, None
