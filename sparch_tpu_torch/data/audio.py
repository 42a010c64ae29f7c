"""HD / SC non-spiking dataset pipeline: WAV -> (augment) -> log-mel fbank
(counterpart of sparch_tpu/data/audio.py, which it repeats line for line).

- WAV decoding with the stdlib ``wave`` module (8-, 16- and 32-bit PCM,
  stereo averaged to mono), scaled to float [-1, 1] like ``torchaudio.load``;
- the 40-bin Kaldi-compatible log-mel fbank of each item on the host
  (``ops.fbank.fbank_np``, ``--frontend host``), or the raw waveform, whose
  fbank the model computes on the card (``models.frontend.FbankFrontend``,
  ``--frontend device``);
- the 4-transform augmentation chain on the train split only
  (``data.augment``);
- the original sparch's labels: HD's digit from the filename
  (``int(filename[-6])``, +10 when ``filename[5] == 'g'``, German); SC's
  from the parent folder, the labels being the sorted folders without
  ``_background_noise_``.

A batch is padded to its longest item, rounded up to ``pad_multiple``
frames, so that the shapes a run sees stay few; the true lengths come back
as ``xlens`` (in frames, for both frontends).
"""
from __future__ import annotations

import logging
import os
import wave
from pathlib import Path
from typing import List, Optional

import numpy as np

from sparch_tpu_torch.data.augment import AugmentChain
from sparch_tpu_torch.data.loader import DataLoader
from sparch_tpu_torch.ops.fbank import (
    FRAME_LENGTH,
    FRAME_SHIFT,
    fbank_np,
    num_frames,
)

logger = logging.getLogger(__name__)

__all__ = [
    "read_wav",
    "pad_waveform_batch",
    "HeidelbergDigits",
    "SpeechCommands",
    "load_hd_or_sc",
]


def _identity(x):
    """Picklable no-op transform (lambdas break multi-process loading)."""
    return x


def read_wav(path: str) -> np.ndarray:
    """Read a (mono) PCM WAV file as float32 in [-1, 1]."""
    with wave.open(path, "rb") as f:
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"Unsupported WAV sample width {width} in {path}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x


def _collate_padded(batch, pad_multiple: int = 1):
    """Pad per-item (T_i, F) features to the batch max (rounded up to
    ``pad_multiple``); xlens are the true pre-padding lengths."""
    xs, ys = zip(*batch)
    xlens = np.asarray([x.shape[0] for x in xs], dtype=np.int64)
    max_t = int(xlens.max())
    if pad_multiple > 1:
        max_t = ((max_t + pad_multiple - 1) // pad_multiple) * pad_multiple
    feat = xs[0].shape[1]
    out = np.zeros((len(xs), max_t, feat), dtype=np.float32)
    for i, x in enumerate(xs):
        out[i, : x.shape[0]] = x
    return out, xlens, np.asarray(ys, dtype=np.int64)


# Kaldi framing at 16 kHz (25 ms window, 10 ms shift, snip_edges): frame
# count T(L) = 1 + (L - 400)//160 for L >= 400.


def pad_waveform_batch(xs, pad_multiple: int = 1):
    """Pad raw 16 kHz waveforms so the fbank produces frame counts
    rounded to ``pad_multiple`` buckets (bounded compile shapes).

    The one waveform-padding policy: the device-frontend training collate
    and serving (``serve.Predictor``) both call this, so the two paths
    cannot drift apart. Returns ``(out, xlens)``: ``out`` a zero-padded
    ``(n, samples)`` float32 array sized to the bucketed frame count,
    ``xlens`` the true per-item FRAME counts (what ``FbankFrontend``
    masks padded frames with) — identical to the host pipeline's
    feature-frame lengths.
    """
    xlens = np.asarray([num_frames(len(x)) for x in xs], dtype=np.int64)
    max_t = max(int(xlens.max()), 1)
    if pad_multiple > 1:
        max_t = ((max_t + pad_multiple - 1) // pad_multiple) * pad_multiple
    n = FRAME_LENGTH + (max_t - 1) * FRAME_SHIFT
    out = np.zeros((len(xs), n), dtype=np.float32)
    for i, x in enumerate(xs):
        m = min(len(x), n)
        out[i, :m] = x[:m]
    return out, xlens


def _collate_waveforms(batch, pad_multiple: int = 1):
    """Device-frontend collate: see :func:`pad_waveform_batch`."""
    xs, ys = zip(*batch)
    out, xlens = pad_waveform_batch(xs, pad_multiple)
    return out, xlens, np.asarray(ys, dtype=np.int64)


class HeidelbergDigits:
    """Non-spiking Heidelberg Digits (HD) dataset: ``<data_folder>/audio/``
    and the ``{train,test}_filenames.txt`` lists."""

    def __init__(
        self,
        data_folder: str,
        split: str,
        use_augm: bool,
        min_snr: float,
        max_snr: float,
        p_noise: float,
        num_mel_bins: int = 40,
        pad_multiple: int = 1,
        seed: int = 0,
        frontend: str = "host",
    ):
        if split not in ["train", "test"]:
            raise ValueError(f"Invalid split {split}")
        self.data_folder = data_folder
        self.num_mel_bins = num_mel_bins
        self.pad_multiple = pad_multiple
        self.frontend = frontend
        filename = f"{data_folder}/{split}_filenames.txt"
        with open(filename) as f:
            self.file_list = f.read().splitlines()

        if use_augm and split == "train":
            self.transf = AugmentChain(min_snr, max_snr, p_noise, seed=seed)
        else:
            self.transf = _identity

    def __len__(self) -> int:
        return len(self.file_list)

    def __getitem__(self, index: int):
        filename = self.file_list[index]
        x = read_wav(f"{self.data_folder}/audio/{filename}")
        x = self.transf(x)
        if self.frontend == "host":
            x = fbank_np(x, self.num_mel_bins)
        # 'device': the raw waveform; the model computes the fbank

        # Label: digit 0-9, +10 for German
        y = int(filename[-6])
        if filename[5] == "g":
            y += 10
        return x, y

    def reseed_augment(self, seed: int):
        """Give this process's augmentation chain an independent stream
        (called by the loader's worker initializer)."""
        if isinstance(self.transf, AugmentChain):
            self.transf.rng = np.random.default_rng(seed)

    def generate_batch(self, batch):
        if self.frontend == "device":
            return _collate_waveforms(batch, self.pad_multiple)
        return _collate_padded(batch, self.pad_multiple)


class SpeechCommands:
    """Google Speech Commands v2 dataset: ``<data_folder>/<label>/*.wav``
    and the ``{validation,testing}_list.txt`` lists; training is every
    other file."""

    def __init__(
        self,
        data_folder: str,
        split: str,
        use_augm: bool,
        min_snr: float,
        max_snr: float,
        p_noise: float,
        num_mel_bins: int = 40,
        pad_multiple: int = 1,
        seed: int = 0,
        frontend: str = "host",
    ):
        if split not in ["training", "validation", "testing"]:
            raise ValueError(f"Invalid split {split}")
        self.data_folder = data_folder
        self.num_mel_bins = num_mel_bins
        self.pad_multiple = pad_multiple
        self.frontend = frontend
        EXCEPT_FOLDER = "_background_noise_"

        def load_list(name):
            with open(os.path.join(data_folder, name)) as f:
                return [os.path.join(data_folder, line.strip()) for line in f]

        if split == "training":
            files = sorted(str(p) for p in Path(data_folder).glob("*/*.wav"))
            exclude = set(load_list("validation_list.txt") + load_list("testing_list.txt"))
            self.file_list = [
                w for w in files if w not in exclude and EXCEPT_FOLDER not in w
            ]
        else:
            self.file_list = load_list(f"{split}_list.txt")

        # Sorted subdir names; drop _background_noise_ (sorts first)
        subdirs = sorted(
            d for d in os.listdir(data_folder)
            if os.path.isdir(os.path.join(data_folder, d))
        )
        self.labels = [d for d in subdirs if d != EXCEPT_FOLDER]

        if use_augm and split == "training":
            self.transf = AugmentChain(min_snr, max_snr, p_noise, seed=seed)
        else:
            self.transf = _identity

    def __len__(self) -> int:
        return len(self.file_list)

    def __getitem__(self, index: int):
        filename = self.file_list[index]
        x = read_wav(filename)
        x = self.transf(x)
        if self.frontend == "host":
            x = fbank_np(x, self.num_mel_bins)

        relpath = os.path.relpath(filename, self.data_folder)
        label, _ = os.path.split(relpath)
        y = self.labels.index(label)
        return x, y

    def reseed_augment(self, seed: int):
        """Give this process's augmentation chain an independent stream
        (called by the loader's worker initializer)."""
        if isinstance(self.transf, AugmentChain):
            self.transf.rng = np.random.default_rng(seed)

    def generate_batch(self, batch):
        if self.frontend == "device":
            return _collate_waveforms(batch, self.pad_multiple)
        return _collate_padded(batch, self.pad_multiple)


def load_hd_or_sc(
    dataset_name: str,
    data_folder: str,
    split: str,
    batch_size: int,
    shuffle: bool = True,
    use_augm: bool = False,
    min_snr: float = 0.0001,
    max_snr: float = 0.9,
    p_noise: float = 0.1,
    workers: int = 0,
    pad_multiple: int = 1,
    seed: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
    frontend: str = "host",
    batch_transform=None,
) -> DataLoader:
    """A loader for a split of HD or SC. HD has no validation split:
    ``valid`` reads ``test``. ``batch_transform`` runs on each collated
    batch in the loader's producer thread (see ``DataLoader``)."""
    if dataset_name not in ["hd", "sc"]:
        raise ValueError(f"Invalid dataset name {dataset_name}")
    if split not in ["train", "valid", "test"]:
        raise ValueError(f"Invalid split name {split}")

    if dataset_name == "hd":
        if split in ["valid", "test"]:
            split = "test"
            logging.info("\nHD uses the same split for validation and testing.\n")
        dataset = HeidelbergDigits(
            data_folder, split, use_augm, min_snr, max_snr, p_noise,
            pad_multiple=pad_multiple, seed=seed, frontend=frontend,
        )
    else:
        split = {"train": "training", "valid": "validation", "test": "testing"}[split]
        dataset = SpeechCommands(
            data_folder, split, use_augm, min_snr, max_snr, p_noise,
            pad_multiple=pad_multiple, seed=seed, frontend=frontend,
        )

    logging.info(f"Number of examples in {dataset_name} {split} set: {len(dataset)}")

    return DataLoader(
        dataset,
        batch_size=batch_size,
        collate_fn=dataset.generate_batch,
        shuffle=shuffle,
        seed=seed,
        prefetch=2 if workers >= 0 else 0,
        workers=max(workers, 0),
        num_shards=num_shards,
        shard_index=shard_index,
        batch_transform=batch_transform,
    )
