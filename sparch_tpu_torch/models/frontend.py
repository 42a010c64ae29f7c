"""The device audio frontend (counterpart of sparch_tpu/models/frontend.py).

``FbankFrontend`` wraps any model of the package so that it takes raw
16 kHz waveform batches ``(B, samples)``: the 40-bin log-mel fbank is
computed on the waveforms' device (``ops.fbank.fbank_torch``), and the
host pipeline only decodes and augments (``--frontend device``). The
device fbank and the host one (``fbank_np``, ``--frontend host``) agree to
float32 rounding, so the two frontends are interchangeable.

The wrapped model's tensors live under ``inner.`` in the ``state_dict``
(``convert.variables_from_flax`` maps the JAX wrapper's ``params/inner``
and ``batch_stats/inner`` there).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sparch_tpu_torch.ops.fbank import fbank_torch

__all__ = ["FbankFrontend"]


class FbankFrontend(nn.Module):
    """``inner`` fed with the fbank of a waveform batch: ``forward(x,
    generator)`` takes ``x = (waveforms, xlens)`` (``xlens`` the true frame
    count of each item, as ``data.audio.pad_waveform_batch`` gives it) or
    the waveforms alone, and returns what ``inner`` returns.

    The attributes the training stack reads off a model (``is_snn``,
    ``state_init``, the layer counts) are ``inner``'s.
    """

    def __init__(self, inner: nn.Module, num_mel_bins: int = 40):
        super().__init__()
        self.inner = inner
        self.num_mel_bins = num_mel_bins

    @property
    def is_snn(self) -> bool:
        return self.inner.is_snn

    @property
    def state_init(self) -> Optional[str]:
        return getattr(self.inner, "state_init", None)

    @property
    def num_layers(self) -> int:
        return self.inner.num_layers

    @property
    def num_outputs(self) -> int:
        return self.inner.num_outputs

    @property
    def use_readout_layer(self) -> bool:
        return self.inner.use_readout_layer

    def forward(self, x, generator: Optional[torch.Generator] = None):
        xlens = None
        if isinstance(x, (tuple, list)):
            x, xlens = x
        if x.ndim != 2:
            raise ValueError(
                f"FbankFrontend expects (batch, samples) waveforms, got "
                f"rank {x.ndim}"
            )
        feats = fbank_torch(x, self.num_mel_bins)
        if xlens is not None:
            # the host pipeline pads the features with zeros, whereas the
            # fbank of a zero-padded waveform tail is the log-energy floor:
            # the padded frames go back to zero
            t = torch.arange(feats.shape[1], device=feats.device)
            keep = t[None, :] < xlens.to(feats.device)[:, None]
            feats = torch.where(keep[..., None], feats, 0.0)
        return self.inner(feats, generator)
