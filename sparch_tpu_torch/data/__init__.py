"""Data (counterpart of sparch_tpu/data): the batch loader, the SHD/SSC
spike-raster pipeline and the HD/SC audio pipeline (WAV files, the
augmentation chain, host or device filterbank)."""
from sparch_tpu_torch.data.audio import (
    HeidelbergDigits,
    SpeechCommands,
    load_hd_or_sc,
    pad_waveform_batch,
    read_wav,
)
from sparch_tpu_torch.data.augment import AugmentChain
from sparch_tpu_torch.data.loader import DataLoader
from sparch_tpu_torch.data.spiking import SpikingDataset, load_shd_or_ssc

__all__ = [
    "AugmentChain",
    "DataLoader",
    "HeidelbergDigits",
    "SpeechCommands",
    "SpikingDataset",
    "load_hd_or_sc",
    "load_shd_or_ssc",
    "pad_waveform_batch",
    "read_wav",
]
