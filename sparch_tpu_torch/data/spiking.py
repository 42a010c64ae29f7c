"""SHD / SSC spiking dataset pipeline (counterpart of
sparch_tpu/data/spiking.py).

Reads the Heidelberg HDF5 layout (groups ``spikes/times``, ``spikes/units``
and ``labels``) and bins each utterance's spike events into a dense
``(nb_steps, 700)`` float32 raster: event times are digitised into
``nb_steps`` bins spanning ``max_time`` seconds and counted, so a unit
spiking twice in one bin gets 2.0. Events at or after ``max_time`` and
units outside [0, 700) are dropped. The binning runs on the host
(``data.native``).

``h5py`` is imported where a file is opened, so the package imports on a
machine without it.
"""
from __future__ import annotations

import logging

import numpy as np

from sparch_tpu_torch.data.loader import DataLoader
from sparch_tpu_torch.data.native import bin_events

__all__ = ["SpikingDataset", "load_shd_or_ssc", "NB_UNITS", "MAX_TIME"]

NB_UNITS = 700
MAX_TIME = 1.4


class SpikingDataset:
    """Dataset for the Spiking Heidelberg Digits (SHD) or Spiking Speech
    Commands (SSC) dataset: item ``i`` is ``(raster, label)``."""

    def __init__(
        self,
        dataset_name: str,
        data_folder: str,
        split: str,
        nb_steps: int = 100,
    ):
        import h5py

        self.nb_steps = nb_steps
        self.nb_units = NB_UNITS
        self.max_time = MAX_TIME
        self.time_bins = np.linspace(0, self.max_time, num=self.nb_steps)

        self._filename = f"{data_folder}/{dataset_name}_{split}.h5"
        # HDF5 handles are neither fork-safe nor picklable: the labels are
        # read now (small); the spikes handle opens lazily, once per
        # process, so the dataset works under multi-process loading
        with h5py.File(self._filename, "r") as f:
            self.labels = np.array(f["labels"], dtype=np.int64)
        self._h5 = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_h5"] = None
        return state

    def _spikes(self):
        """The ``spikes`` group: ``["times"][i]`` and ``["units"][i]`` are
        utterance ``i``'s event times (s) and units."""
        if self._h5 is None:
            import h5py

            self._h5 = h5py.File(self._filename, "r")
        return self._h5["spikes"]

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, index: int):
        spikes = self._spikes()
        x = bin_events(
            np.asarray(spikes["times"][index], np.float64),
            np.asarray(spikes["units"][index], np.int64),
            self.time_bins,
            self.nb_steps,
            self.nb_units,
        )
        return x, self.labels[index]

    def generate_batch(self, batch):
        """Collate: stack the rasters; returns (xs, xlens, ys) with
        ``xlens`` the step count of each item (``nb_steps`` for all)."""
        xs, ys = zip(*batch)
        xs = np.stack(xs, axis=0)
        xlens = np.full((len(ys),), self.nb_steps, dtype=np.int64)
        ys = np.asarray(ys, dtype=np.int64)
        return xs, xlens, ys


def load_shd_or_ssc(
    dataset_name: str,
    data_folder: str,
    split: str,
    batch_size: int,
    nb_steps: int = 100,
    shuffle: bool = True,
    workers: int = 0,
    seed: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
    batch_transform=None,
) -> DataLoader:
    """A loader for a split of SHD or SSC. SHD has no validation split:
    ``valid`` reads ``test``. ``batch_transform`` runs on each collated
    batch in the loader's producer thread (see ``DataLoader``)."""
    if dataset_name not in ["shd", "ssc"]:
        raise ValueError(f"Invalid dataset name {dataset_name}")
    if split not in ["train", "valid", "test"]:
        raise ValueError(f"Invalid split name {split}")
    if dataset_name == "shd" and split == "valid":
        logging.info("SHD does not have a validation split. Using test split.")
        split = "test"

    dataset = SpikingDataset(dataset_name, data_folder, split, nb_steps)
    logging.info(f"Number of examples in {split} set: {len(dataset)}")

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
