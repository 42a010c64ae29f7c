"""Waveform augmentation chain for the non-spiking datasets (counterpart
of sparch_tpu/data/augment.py, which it repeats line for line: the same
draws from the same ``np.random.default_rng(seed)`` stream in the same
order give the same waveforms). The reverb needs the native Freeverb or
SciPy: the JAX module's approximation for a machine with neither (a
decaying-noise room response) is not carried over.

The original sparch's train-split chain:

    RandomApply([PolarityInversion()], p=0.8)
    RandomApply([Noise(min_snr, max_snr)], p=p_noise)
    RandomApply([Gain()], p=0.3)
    RandomApply([Reverb(16 kHz)], p=0.6)

Implemented in NumPy (the original uses the ``torchaudio_augmentations``
package, a thin wrapper over these same operations):

- PolarityInversion: exact (multiply by -1).
- Noise: additive white Gaussian noise with std drawn uniformly from
  ``[min_snr*std(x), max_snr*std(x)]`` (same parameterisation as
  torchaudio_augmentations.Noise).
- Gain: uniform gain in dB from [-20, -1] (the package's defaults).
- Reverb: the package drives sox's ``reverb`` effect with uniformly random
  integer (reverberance, HF-damping, room-scale) in [0, 100) and then
  downmixes to mono. sox's reverb is the public-domain Freeverb algorithm
  (8 parallel damped feedback combs + 4 series allpasses per channel);
  ``_sox_reverb`` below is a clean-room NumPy/SciPy implementation of that
  algorithm with sox's exact parameter mappings (filter lengths, feedback
  and damping curves, wet gain, stereo offsets). Each comb/allpass is an
  exact IIR evaluated by ``scipy.signal.lfilter``; the hot path is the
  shared C++ kernel ``native/freeverb.cpp`` (``data.native``). Augmentation
  is off by default (``--use_augm``).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["AugmentChain"]


def _polarity(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return -x


def _noise(x, rng, min_snr, max_snr):
    std = float(np.std(x))
    noise_std = rng.uniform(min_snr * std, max_snr * std)
    return x + rng.normal(0.0, noise_std, size=x.shape).astype(np.float32)


def _gain(x, rng, min_db=-20.0, max_db=-1.0):
    db = rng.uniform(min_db, max_db)
    return x * np.float32(10.0 ** (db / 20.0))


# Freeverb filter delay lengths in samples at 44100 Hz (sox reverb.c);
# channel-offset spread of 12 samples, alternating sign per filter.
_COMB_LENGTHS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
_ALLPASS_LENGTHS = (225, 341, 441, 556)
_STEREO_ADJUST = 12


def _filter_delays(sr, scale, offset):
    """sox filter_array_create's delay lengths: combs scale with the room,
    allpasses with the rate only; the channel offset (+-12 samples)
    alternates sign per filter in CREATION order."""
    r = sr / 44100.0
    off = offset
    combs = []
    for L in _COMB_LENGTHS:
        combs.append(int(L * r * scale + _STEREO_ADJUST * off + 0.5))
        off = -off
    aps = []
    for L in _ALLPASS_LENGTHS:
        aps.append(int(L * r + _STEREO_ADJUST * off + 0.5))
        off = -off
    # sox's filter_array_process walks the allpass array from the LAST
    # element down — series allpasses don't commute, so preserve it
    return combs, aps[::-1]


def _freeverb_channel(x64, sr, scale, offset, feedback, damp):
    """One Freeverb channel: 8 parallel damped combs + 4 series allpasses.

    Hot path: the native C++ kernel (native/freeverb.cpp, O(N) per
    filter, through ``data.native``). Fallback: exact IIR forms via scipy.signal.lfilter — the
    comb obeys
        w[n] = x[n] + f*store[n],  store[n] = (1-d)*w[n-D] + d*store[n-1],
        out[n] = w[n-D]
    => transfer  out/x = z^-D (1 - d z^-1) / (1 - d z^-1 - f(1-d) z^-D),
    the allpass  (1.5 z^-D - 1) / (1 - .5 z^-D). NOTE the fallback's dense
    coefficient vectors make lfilter O(N*D) — ~250 ms per 1 s utterance
    vs ~0.5 ms native; it exists for toolchain-free environments and as
    an independent formulation of the same filters.
    """
    combs, aps = _filter_delays(sr, scale, offset)

    from sparch_tpu_torch.data.native import freeverb_channel

    native = freeverb_channel(
        x64, np.asarray(combs), np.asarray(aps), feedback, damp
    )
    if native is not None:
        return native

    from scipy.signal import lfilter

    wet = np.zeros_like(x64)
    for D in combs:
        b = np.zeros(D + 2)
        b[D], b[D + 1] = 1.0, -damp
        a = np.zeros(D + 1)
        a[0], a[1] = 1.0, -damp
        a[D] += -feedback * (1.0 - damp)
        wet += lfilter(b, a, x64)
    for D in aps:
        b = np.zeros(D + 1)
        b[0], b[D] = -1.0, 1.5
        a = np.zeros(D + 1)
        a[0], a[D] = 1.0, -0.5
        wet = lfilter(b, a, wet)
    return wet


def _sox_reverb(x, rng, sample_rate=16000):
    """sox ``reverb <reverberance> <HF-damping> <room-scale>`` on a mono
    waveform, with the three percentages drawn uniformly from [0, 100)
    like torchaudio_augmentations.Reverb, followed by the package's
    mono downmix. Parameter mappings are sox reverb.c's:

        scale    = room_scale/100 * 0.9 + 0.1
        feedback = 1 - exp((reverberance - b) / (a*b)),
                   a = -1/ln(1-0.3), b = 100/(ln(1-0.98)*a + 1)
                   (so feedback runs 0.3 at 0% to 0.98 at 100%)
        damping  = hf_damping/100 * 0.3 + 0.2
        wet gain = 0.015 (0 dB); mono in + default stereo-depth 100%
        makes two wet channels whose filter lengths differ by +-12
        samples; the downmix averages them:  out = dry + (wetL+wetR)/2.
    """
    reverberance = float(rng.integers(0, 100))
    hf_damping = float(rng.integers(0, 100))
    room_scale = float(rng.integers(0, 100))
    return _reverb_fixed(x, reverberance, hf_damping, room_scale,
                         sample_rate)


def _reverb_fixed(x, reverberance, hf_damping, room_scale, sample_rate=16000):
    """The deterministic core of :func:`_sox_reverb`: sox ``reverb r d s``
    with explicit percentages."""
    scale = room_scale / 100.0 * 0.9 + 0.1
    a = -1.0 / math.log(1.0 - 0.3)
    b = 100.0 / (math.log(1.0 - 0.98) * a + 1.0)
    feedback = 1.0 - math.exp((reverberance - b) / (a * b))
    damp = hf_damping / 100.0 * 0.3 + 0.2
    gain = 0.015

    x64 = x.astype(np.float64)
    wet_l = _freeverb_channel(x64, sample_rate, scale, 0.0, feedback, damp)
    wet_r = _freeverb_channel(x64, sample_rate, scale, 1.0, feedback, damp)
    out = x64 + gain * 0.5 * (wet_l + wet_r)
    return out.astype(np.float32)


class AugmentChain:
    """Randomly-applied augmentation chain with the original sparch's
    probabilities."""

    def __init__(
        self,
        min_snr: float = 1e-4,
        max_snr: float = 0.9,
        p_noise: float = 0.1,
        seed: int = 0,
    ):
        self.min_snr = min_snr
        self.max_snr = max_snr
        self.p_noise = p_noise
        self.rng = np.random.default_rng(seed)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        rng = self.rng
        if rng.random() < 0.8:
            x = _polarity(x, rng)
        if rng.random() < self.p_noise:
            x = _noise(x, rng, self.min_snr, self.max_snr)
        if rng.random() < 0.3:
            x = _gain(x, rng)
        if rng.random() < 0.6:
            x = _sox_reverb(x, rng)
        return x.astype(np.float32)
