"""The port's HD/SC audio path on the CPU, against the JAX package's: the
filterbank (``ops.fbank``: the NumPy constants and host fbank bit for
bit, ``fbank_torch`` within atol 2e-3 of ``fbank_np`` and ``fbank_jnp``),
``read_wav`` (8-, 16- and 32-bit PCM, stereo), the collates, both datasets'
items and labels and ``load_hd_or_sc``'s batches for both frontends (bit
for bit, augmentation on), ``AugmentChain`` at three seeds on the native
Freeverb and on the SciPy formulation (bit for bit), ``FbankFrontend``
with the JAX wrapper's weights (LIF logits within atol 2e-2, rtol 1e-3,
the bound ``tests/test_cli_audio.py`` holds the two JAX frontends to;
padded frames zeroed), the converter's ``inner`` level and the waveform
streaming step."""
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.data import audio as jax_audio
from sparch_tpu.data import augment as jax_augment
from sparch_tpu.data import native as jax_native
from sparch_tpu.models import build_model as jax_build_model
from sparch_tpu.models.frontend import FbankFrontend as JaxFbankFrontend
from sparch_tpu.ops import fbank as jax_fbank
from sparch_tpu.serve import streaming_init as jax_streaming_init
from sparch_tpu.serve import streaming_step as jax_streaming_step
from sparch_tpu_torch.convert import variables_from_flax, variables_to_flax
from sparch_tpu_torch.data import audio, augment, native
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.models.frontend import FbankFrontend
from sparch_tpu_torch.ops import fbank
from sparch_tpu_torch.serve import streaming_init, streaming_step

from .fixtures import make_hd_tree, make_sc_tree, tone, write_wav

FBANK_ATOL = 2e-3  # tests/test_fbank.py: the JAX host and device fbanks


def waves(seed, n=3, lo=0.05, hi=0.6):
    """Ragged float waveforms of lo-hi s: noise over a tone."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.uniform(lo, hi) * 16000)
        x = tone(rng.uniform(200, 3000), m / 16000, amp=0.3)
        out.append((x + rng.normal(0, 0.05, m)).astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# The filterbank
# ---------------------------------------------------------------------------

def test_fbank_constants_equal_jax():
    for bins in (40, 23):
        np.testing.assert_array_equal(fbank.mel_filterbank(bins),
                                      jax_fbank.mel_filterbank(bins))
    np.testing.assert_array_equal(fbank.povey_window(),
                                  jax_fbank.povey_window())
    f = np.linspace(0, 8000, 17)
    np.testing.assert_array_equal(fbank.mel_scale(f), jax_fbank.mel_scale(f))
    for n in (0, 399, 400, 559, 560, 16000):
        assert fbank.num_frames(n) == jax_fbank.num_frames(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fbank_np_equals_jax_and_torch_is_within_bound(seed):
    xs = waves(seed) + [np.zeros(300, np.float32)]
    for x in xs:
        want = jax_fbank.fbank_np(x)
        got = fbank.fbank_np(x)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        dev = fbank.fbank_torch(torch.from_numpy(x))
        assert dev.dtype == torch.float32 and dev.shape == want.shape
        np.testing.assert_allclose(dev.numpy(), want, rtol=0,
                                   atol=FBANK_ATOL)
        jnp_feats = np.asarray(jax.jit(jax_fbank.fbank_jnp)(x))
        np.testing.assert_allclose(dev.numpy(), jnp_feats, rtol=0,
                                   atol=FBANK_ATOL)
    # batched over leading dims: each row's frames are its own fbank
    batch, _ = audio.pad_waveform_batch(xs[:3], 20)
    feats = fbank.fbank_torch(torch.from_numpy(batch)).numpy()
    for row, x in zip(feats, xs):
        nf = fbank.num_frames(len(x))
        np.testing.assert_allclose(row[:nf], fbank.fbank_np(x), rtol=0,
                                   atol=FBANK_ATOL)


# ---------------------------------------------------------------------------
# WAV files, collates, datasets, loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_read_wav_equals_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    n = 1000 * channels
    if width == 1:
        raw = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    else:
        raw = rng.integers(-(2 ** (8 * width - 1)), 2 ** (8 * width - 1), n,
                           dtype=np.int64).astype(f"<i{width}").tobytes()
    path = str(tmp_path / "x.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(16000)
        f.writeframes(raw)
    got, want = audio.read_wav(path), jax_audio.read_wav(path)
    assert got.dtype == np.float32 and got.shape == (1000,)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 1.0


@pytest.mark.parametrize("pad_multiple", [1, 20])
def test_collates_equal_jax(pad_multiple):
    xs = waves(3, n=4)
    items = [(fbank.fbank_np(x), i) for i, x in enumerate(xs)]
    for got, want in zip(audio._collate_padded(items, pad_multiple),
                         jax_audio._collate_padded(items, pad_multiple)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    items = [(x, i) for i, x in enumerate(xs + [np.zeros(50, np.float32)])]
    for got, want in zip(audio._collate_waveforms(items, pad_multiple),
                         jax_audio._collate_waveforms(items, pad_multiple)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    out, xlens = audio.pad_waveform_batch(xs, pad_multiple)
    t = fbank.num_frames(out.shape[1])
    assert t % pad_multiple == 0 and t >= xlens.max()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    hd = str(root / "hd")
    make_hd_tree(hd, n_per_digit=2, digits=(0, 3))
    # a German utterance: 'g' at index 5 adds 10 to the digit
    write_wav(os.path.join(hd, "audio", "spk0_ger_70.wav"),
              tone(900, dur=0.3))
    for split in ("train", "test"):
        with open(os.path.join(hd, f"{split}_filenames.txt"), "a") as f:
            f.write("spk0_ger_70.wav\n")
    sc = str(root / "sc")
    make_sc_tree(sc, labels=("go", "stop", "yes"), n_per_label=4)
    write_wav(os.path.join(sc, "_background_noise_", "noise.wav"),
              tone(50, dur=0.2))
    return {"hd": hd, "sc": sc}


@pytest.mark.parametrize("frontend", ["host", "device"])
@pytest.mark.parametrize("name", ["hd", "sc"])
def test_dataset_items_and_labels_equal_jax(trees, name, frontend):
    split = "test" if name == "hd" else "testing"
    cls, jcls = ((audio.HeidelbergDigits, jax_audio.HeidelbergDigits)
                 if name == "hd" else
                 (audio.SpeechCommands, jax_audio.SpeechCommands))
    kw = dict(use_augm=False, min_snr=1e-4, max_snr=0.9, p_noise=0.1,
              frontend=frontend)
    got, want = cls(trees[name], split, **kw), jcls(trees[name], split, **kw)
    assert len(got) == len(want) > 0
    assert got.file_list == want.file_list
    labels = []
    for i in range(len(got)):
        (gx, gy), (wx, wy) = got[i], want[i]
        assert gy == wy
        labels.append(gy)
        np.testing.assert_array_equal(gx, wx)
        assert gx.ndim == (2 if frontend == "host" else 1)
    if name == "hd":
        assert sorted(set(labels)) == [0, 3, 17]
    else:
        assert got.labels == ["go", "stop", "yes"]
        train = cls(trees[name], "training", **kw)
        assert len(train) == 6  # 2 each; the lists and the noise left out
        assert not any("_background_noise_" in f for f in train.file_list)


@pytest.mark.parametrize("frontend", ["host", "device"])
@pytest.mark.parametrize("name", ["hd", "sc"])
def test_loaders_equal_jax(trees, name, frontend):
    """Two shuffled, augmented train epochs and the eval splits, batch for
    batch, bit for bit."""
    kw = dict(dataset_name=name, data_folder=trees[name], batch_size=3,
              pad_multiple=20, seed=4, frontend=frontend)
    for split, extra in (("train", dict(shuffle=True, use_augm=True,
                                        p_noise=0.5)),
                         ("valid", dict(shuffle=False)),
                         ("test", dict(shuffle=False))):
        got = audio.load_hd_or_sc(split=split, **kw, **extra)
        want = jax_audio.load_hd_or_sc(split=split, **kw, **extra)
        assert len(got) == len(want) > 0
        for _ in range(2 if split == "train" else 1):
            for g, w in zip(got, want, strict=True):
                for a, b in zip(g, w):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("freeverb", ["native", "scipy"])
def test_augment_chain_equals_jax(monkeypatch, seed, freeverb):
    """Six waves through one chain each, so that every branch is drawn;
    the SciPy formulation is O(N*D): its waves stay at 0.2 s."""
    if freeverb == "scipy":
        for mod in (native, jax_native):
            monkeypatch.setattr(mod, "freeverb_channel", lambda *a: None)
        dur = 0.2
    else:
        assert native.freeverb_available()
        dur = 1.0
    rng = np.random.default_rng(seed)
    xs = [rng.normal(0, 0.2, int(dur * 16000)).astype(np.float32)
          for _ in range(6)]
    chain = augment.AugmentChain(p_noise=0.5, seed=seed)
    jchain = jax_augment.AugmentChain(p_noise=0.5, seed=seed)
    for x in xs:
        got, want = chain(x.copy()), jchain(x.copy())
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert chain.rng.random() == jchain.rng.random()  # the same draws


def test_native_freeverb_built_under_build_and_matches_scipy():
    assert native.freeverb_available()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native._FV_LIB == os.path.join(root, "build", "native",
                                          "libsparch_freeverb.so")
    assert os.path.exists(native._FV_LIB)
    x = np.random.default_rng(5).normal(size=2000)
    combs, aps = augment._filter_delays(16000, 0.7, 1.0)
    got = native.freeverb_channel(x, np.asarray(combs), np.asarray(aps),
                                  0.93, 0.41)
    want = jax_native.freeverb_channel(x, np.asarray(combs),
                                       np.asarray(aps), 0.93, 0.41)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The frontend, the converter's inner level, waveform streaming
# ---------------------------------------------------------------------------

def jax_frontend(model_type, sizes, wav, lens, seed=0):
    inner = jax_build_model(model_type, (len(wav), None, 40), list(sizes),
                            dropout=0.0, normalization="batchnorm",
                            state_init="zeros")
    model = JaxFbankFrontend(inner=inner)
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           (wav, lens), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # running statistics from one train-mode pass
    _, mut = model.apply(variables, (wav, lens), train=True,
                         mutable=["batch_stats"])
    variables["batch_stats"] = jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"])
    return model, variables


def port_frontend(jmodel, variables, cell_impl="scan"):
    inner = jmodel.inner
    model = FbankFrontend(build_model(
        inner.neuron_type, inner.input_shape, inner.layer_sizes,
        dropout=0.0, normalization="batchnorm", state_init="zeros",
        cell_impl=cell_impl))
    model.load_state_dict(variables_from_flax(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def lif(trees):
    """A JAX LIF [16, 35] in its frontend, its running statistics from
    the first SC batch, and that batch."""
    wav, xlens, _ = next(iter(audio.load_hd_or_sc(
        dataset_name="sc", data_folder=trees["sc"], split="train",
        batch_size=6, shuffle=False, pad_multiple=20, frontend="device")))
    jmodel, variables = jax_frontend("LIF", (16, 35), wav,
                                     xlens.astype(np.int32))
    return jmodel, variables, wav, xlens


def test_frontend_matches_jax_wrapper(lif):
    jmodel, variables, wav, xlens = lif
    want, _ = jmodel.apply(variables, (wav, xlens.astype(np.int32)),
                           train=False)
    model = port_frontend(jmodel, variables)
    seen = []
    model.inner.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    with torch.no_grad():
        got, _ = model((torch.from_numpy(wav), torch.from_numpy(xlens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=1e-3)
    # the padded frames are zero, the others the host pipeline's features
    feats = seen[0].numpy()
    assert feats.shape[1] % 20 == 0 and feats.shape[1] > xlens.max()
    for row, n, x in zip(feats, xlens, wav):
        assert not row[n:].any()
        np.testing.assert_allclose(
            row[:n], fbank.fbank_np(x[:400 + (n - 1) * 160]), rtol=0,
            atol=FBANK_ATOL)
    assert model.is_snn and model.num_outputs == 35
    assert model.state_init == "zeros" and model.use_readout_layer
    with pytest.raises(ValueError, match="rank 3"):
        model(torch.zeros(2, 8, 40))


def test_converter_maps_the_inner_level(lif):
    _, variables, _, _ = lif
    sd = variables_from_flax(variables)
    assert sd and all(k.startswith("inner.") for k in sd)
    assert "inner.layer_0.alpha" in sd
    assert "inner.readout.norm.running_var" in sd
    back = variables_to_flax(sd)
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path])


def test_waveform_streaming_matches_jax_and_batch(lif):
    jmodel, variables, _, _ = lif
    n_frames, b = 9, 3
    wav = np.random.default_rng(3).normal(
        0, 0.3, (b, 400 + (n_frames - 1) * 160)).astype(np.float32)
    model = port_frontend(jmodel, variables)
    sd = variables_from_flax(variables)
    state = streaming_init(model, sd, b)
    jstate = jax_streaming_init(jmodel, variables, b)
    jstep = jax.jit(lambda s, w: jax_streaming_step(jmodel, variables, s, w))
    for t in range(n_frames):
        window = wav[:, t * 160:t * 160 + 400]
        state, out = streaming_step(model, sd, state,
                                    torch.from_numpy(window))
        jstate, jout = jstep(jstate, jnp.asarray(window))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=2e-4, err_msg=f"frame {t}")
    assert state["t"] == n_frames
    with torch.no_grad():
        batch, _ = model(torch.from_numpy(wav))
    np.testing.assert_allclose(out.numpy(), batch.numpy(), rtol=0, atol=2e-4)
    with pytest.raises(ValueError, match="window"):
        streaming_step(model, sd, state, torch.from_numpy(wav))
