"""Data (counterpart of sparch_tpu/data): the batch loader and the SHD/SSC
spike-raster pipeline. The HD/SC audio pipeline waits for the device
filterbank (ROADMAP queue 1 item 5)."""
from sparch_tpu_torch.data.loader import DataLoader
from sparch_tpu_torch.data.spiking import SpikingDataset, load_shd_or_ssc

__all__ = ["DataLoader", "SpikingDataset", "load_shd_or_ssc"]
