"""Kaldi-compatible 40-bin log-mel filterbank (counterpart of
sparch_tpu/ops/fbank.py).

The features of ``torchaudio.compliance.kaldi.fbank(x, num_mel_bins=40)``
with its default parameters: 16 kHz, frames of 400 samples (25 ms) every
160 (10 ms), snip_edges, a 512-point FFT, no dither, the DC offset removed
per frame, pre-emphasis 0.97 with the first sample reflected, the Povey
window ((0.5 - 0.5 cos)^0.85), the power spectrum without the Nyquist bin,
Kaldi's mel scale 1127 ln(1 + f/700) from 20 Hz to Nyquist, then
log(max(e, EPS)).

Two forms of one computation:

- ``fbank_np``: NumPy, on the host, one utterance at a time (the data
  loaders' ``--frontend host``); its code and constants are the JAX
  package's, so its features are the JAX package's bits;
- ``fbank_torch``: PyTorch on the waveform's own device, batched over
  leading dimensions (``models.frontend.FbankFrontend``, ``--frontend
  device``): the same steps in the same order, framed by ``unfold``, the
  spectrum by ``torch.fft.rfft`` and the mel product by ``torch.matmul``
  (in float32 as every product of the port, TF32 off as PyTorch's
  default). It agrees with ``fbank_np`` to float32 rounding.

Waveforms are float in [-1, 1] (``torchaudio.load``'s convention).
"""
from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000
FRAME_LENGTH = 400  # 25 ms
FRAME_SHIFT = 160  # 10 ms
FFT_SIZE = 512  # next power of two of 400 (round_to_power_of_two)
LOW_FREQ = 20.0
PREEMPH = 0.97
LOG_EPS = 1.1920928955078125e-07  # float32 machine epsilon (Kaldi EPSILON)

__all__ = [
    "mel_scale",
    "mel_filterbank",
    "povey_window",
    "fbank_np",
    "fbank_torch",
    "num_frames",
]


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


def povey_window(length: int = FRAME_LENGTH) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2.0 * math.pi * n / (length - 1))) ** 0.85).astype(
        np.float32
    )


def mel_filterbank(
    num_bins: int = 40,
    fft_size: int = FFT_SIZE,
    sample_rate: int = SAMPLE_RATE,
    low_freq: float = LOW_FREQ,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi-style triangular mel filterbank, shape (fft_size//2, num_bins).

    ``high_freq <= 0`` means Nyquist + high_freq. The Nyquist FFT bin is
    left out (Kaldi uses bins 0..fft_size//2 - 1).
    """
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    num_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_freqs = mel_scale(np.arange(num_fft_bins) * fft_bin_width)  # (F,)
    left = mel_low + np.arange(num_bins) * mel_delta  # (M,)
    center = left + mel_delta
    right = center + mel_delta

    up = (bin_freqs[:, None] - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - bin_freqs[:, None]) / (right - center)[None, :]
    weights = np.maximum(0.0, np.minimum(up, down))
    return weights.astype(np.float32)


def num_frames(num_samples: int) -> int:
    """snip_edges frame count."""
    if num_samples < FRAME_LENGTH:
        return 0
    return 1 + (num_samples - FRAME_LENGTH) // FRAME_SHIFT


_MEL_CACHE: dict = {}


def _weights(num_mel_bins: int) -> np.ndarray:
    if num_mel_bins not in _MEL_CACHE:
        _MEL_CACHE[num_mel_bins] = mel_filterbank(num_mel_bins)
    return _MEL_CACHE[num_mel_bins]


def fbank_np(waveform: np.ndarray, num_mel_bins: int = 40) -> np.ndarray:
    """Host fbank: float waveform (..., n_samples) -> (..., frames, bins)."""
    x = np.asarray(waveform, np.float32)
    nf = num_frames(x.shape[-1])
    idx = np.arange(nf)[:, None] * FRAME_SHIFT + np.arange(FRAME_LENGTH)[None, :]
    frames = x[..., idx]  # (..., nf, 400)

    # remove the DC offset of each frame
    frames = frames - np.mean(frames, axis=-1, keepdims=True)
    # pre-emphasis with the first sample reflected: x[i] - 0.97 x[max(i-1, 0)]
    prev = np.concatenate([frames[..., :1], frames[..., :-1]], axis=-1)
    frames = frames - PREEMPH * prev
    frames = frames * povey_window()

    spec = np.fft.rfft(frames, n=FFT_SIZE, axis=-1)
    power = np.abs(spec[..., : FFT_SIZE // 2]) ** 2  # drop the Nyquist bin
    mel = power @ _weights(num_mel_bins)
    return np.log(np.maximum(mel, LOG_EPS)).astype(np.float32)


def fbank_torch(waveform: torch.Tensor, num_mel_bins: int = 40) -> torch.Tensor:
    """Device fbank: float waveform (..., n_samples) -> (..., frames, bins)
    float32, on the waveform's device."""
    x = waveform.float()
    nf = num_frames(x.shape[-1])
    if nf == 0:
        return x.new_zeros(x.shape[:-1] + (0, num_mel_bins))
    frames = x.unfold(-1, FRAME_LENGTH, FRAME_SHIFT)  # (..., nf, 400)

    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - PREEMPH * prev
    frames = frames * torch.from_numpy(povey_window()).to(x.device)

    spec = torch.fft.rfft(frames, n=FFT_SIZE, dim=-1)
    power = spec[..., : FFT_SIZE // 2].abs() ** 2
    weights = torch.from_numpy(_weights(num_mel_bins)).to(x.device)
    mel = torch.matmul(power, weights)
    return torch.log(torch.clamp_min(mel, LOG_EPS))
