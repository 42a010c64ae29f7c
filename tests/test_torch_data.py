"""The port's data pipeline (``sparch_tpu_torch.data``) against the JAX
package's: loader batches index for index (shuffle on and off, two
epochs, two shards, ``drop_last``, a worker pool), event binning (native
and NumPy, events at and after 1.4 s, units out of range) and the SHD/SSC
loaders' rasters, lengths and labels, SHD's valid split reading test."""
import os

import numpy as np
import pytest
import torch

from sparch_tpu.data import loader as jax_loader
from sparch_tpu.data import native as jax_native
from sparch_tpu.data import spiking as jax_spiking
from sparch_tpu_torch.data import loader, native, spiking

from .fixtures import make_shd_h5


class Items:
    """Item i is (a raster filled with i, label i % 3)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 3), i, np.float32), i % 3


def collate(items):
    xs, ys = zip(*items)
    return np.stack(xs), np.asarray(ys, np.int64)


def epochs(loader_cls, n_epochs=2, **kw):
    dl = loader_cls(Items(kw.pop("n", 23)), collate_fn=collate, **kw)
    out = [[(x.copy(), y.copy()) for x, y in dl] for _ in range(n_epochs)]
    return out, len(dl)


@pytest.mark.parametrize("kw", [
    dict(batch_size=5, shuffle=True, seed=4),
    dict(batch_size=5, shuffle=False),
    dict(batch_size=6, shuffle=True, seed=1, num_shards=2, shard_index=0),
    dict(batch_size=6, shuffle=True, seed=1, num_shards=2, shard_index=1),
    dict(batch_size=5, shuffle=True, seed=2, drop_last=True),
    dict(batch_size=4, shuffle=True, seed=0, prefetch=0),
], ids=["shuffle", "in_order", "shard0", "shard1", "drop_last",
        "no_prefetch"])
def test_loader_batches_equal_jax(kw):
    got, n_got = epochs(loader.DataLoader, **kw)
    want, n_want = epochs(jax_loader.DataLoader, **kw)
    assert n_got == n_want == len(got[0])
    for e in range(2):
        assert len(got[e]) == len(want[e])
        for (gx, gy), (wx, wy) in zip(got[e], want[e]):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    if kw.get("shuffle"):  # each epoch its own order
        assert not all(np.array_equal(a[0], b[0])
                       for a, b in zip(got[0], got[1]))


def test_two_shards_cover_the_global_batch():
    kw = dict(batch_size=6, shuffle=True, seed=1)
    whole, _ = epochs(loader.DataLoader, drop_last=True, **kw)
    parts = [epochs(loader.DataLoader, num_shards=2, shard_index=i, **kw)[0]
             for i in (0, 1)]
    for e in range(2):
        for b, (x, _) in enumerate(whole[e]):
            halves = np.concatenate([parts[0][e][b][0], parts[1][e][b][0]])
            np.testing.assert_array_equal(halves, x)


def test_batch_transform_runs_on_the_producer_side():
    seen = []

    def transform(batch):
        seen.append(True)
        x, y = batch
        return torch.from_numpy(x).to(torch.bfloat16), y

    dl = loader.DataLoader(Items(7), batch_size=3, collate_fn=collate,
                           shuffle=False, batch_transform=transform)
    batches = list(dl)
    assert len(seen) == len(batches) == 3
    assert all(x.dtype == torch.bfloat16 for x, _ in batches)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spikes"))
    make_shd_h5(f"{d}/shd_train.h5", n=11, nb_classes=3, seed=0)
    make_shd_h5(f"{d}/shd_test.h5", n=6, nb_classes=3, seed=1)
    for split, seed in (("train", 2), ("valid", 3), ("test", 4)):
        make_shd_h5(f"{d}/ssc_{split}.h5", n=9, nb_classes=5, seed=seed,
                    n_events_range=(300, 900))
    return d


def batches_of(load, **kw):
    return [tuple(np.array(v) for v in b) for b in load(**kw)]


@pytest.mark.parametrize("name,split", [
    ("shd", "train"), ("shd", "valid"), ("ssc", "train"), ("ssc", "valid"),
    ("ssc", "test"),
])
def test_spiking_loader_equals_jax(folder, name, split):
    kw = dict(dataset_name=name, data_folder=folder, split=split,
              batch_size=4, nb_steps=100, shuffle=split == "train", seed=5)
    got = batches_of(spiking.load_shd_or_ssc, **kw)
    want = batches_of(jax_spiking.load_shd_or_ssc, **kw)
    assert len(got) == len(want) > 1
    for (gx, gl, gy), (wx, wl, wy) in zip(got, want):
        assert gx.dtype == np.float32 and gx.shape[1:] == (100, 700)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gy, wy)
    if name == "shd" and split == "valid":  # SHD's valid split reads test
        test = batches_of(spiking.load_shd_or_ssc, **dict(kw, split="test"))
        for g, t in zip(got, test):
            np.testing.assert_array_equal(g[0], t[0])


def test_spiking_loader_with_workers_equals_jax(folder):
    kw = dict(dataset_name="ssc", data_folder=folder, split="train",
              batch_size=4, shuffle=True, seed=7)
    got = spiking.load_shd_or_ssc(workers=2, **kw)
    try:
        got_batches = [tuple(np.array(v) for v in b) for b in got]
    finally:
        got.close()
    want = batches_of(jax_spiking.load_shd_or_ssc, workers=0, **kw)
    assert len(got_batches) == len(want)
    for g, w in zip(got_batches, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_dataset_reopens_its_file_after_pickling(folder):
    import pickle

    ds = spiking.SpikingDataset("ssc", folder, "train", 100)
    x0, y0 = ds[3]
    clone = pickle.loads(pickle.dumps(ds))
    assert clone._h5 is None
    x1, y1 = clone[3]
    np.testing.assert_array_equal(x0, x1)
    assert y0 == y1


def events(seed, n=4000):
    """Event times over [-0.1, 1.6) s, some exactly on 1.4 s and on bin
    edges, and units over [-3, 705)."""
    rng = np.random.default_rng(seed)
    times = rng.uniform(-0.1, 1.6, n)
    edges = np.linspace(0, spiking.MAX_TIME, 100)
    times[:40] = spiking.MAX_TIME
    times[40:80] = edges[rng.integers(0, 100, 40)]
    units = rng.integers(-3, 705, n)
    return times, units, edges


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_events_equals_jax_numpy(seed):
    times, units, edges = events(seed)
    want = jax_native._bin_events_np(times, units, edges, 100, 700)
    assert want.sum() < len(times)  # some events were dropped
    got_np = native._bin_events_np(times, units, edges, 100, 700)
    np.testing.assert_array_equal(got_np, want)
    assert native.native_available()  # the native branch runs here
    got = native.bin_events(times, units, edges, 100, 700)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_native_library_is_built_under_build():
    native.native_available()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native._LIB == os.path.join(root, "build", "native",
                                       "libsparch_binning.so")
    assert os.path.exists(native._LIB)
    assert not [f for f in os.listdir(os.path.dirname(native._LIB))
                if f.endswith(".tmp")]
