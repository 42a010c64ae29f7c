"""The port's CLI on the HD/SC audio path, on the CPU.

Against the JAX package, one run a flow from the same argv and the same
initial weights (``convert.variables_from_flax``, loaded in place), LIF
[16, 20|35], 2 epochs, ``state_init zeros``, ``pdrop 0``, ``cell_impl
scan``, held as ``tests/test_torch_cli.py`` holds LIF: the train loss of
every epoch within rtol 1e-4, the valid and test accuracy equal, the final
weights within rtol 1e-4 / atol 1e-5, the log lines equal with their
numbers masked and ``meta.json``'s ``model`` record equal key for key.

- HD with ``--frontend host``: both packages read the same WAVs into the
  same features (``fbank_np``, bit for bit);
- SC with ``--frontend device --use_augm true``: the same augmented
  waveforms (the same draws of one seed, the same native Freeverb), whose
  fbank each package computes in its own model (``fbank_jnp``,
  ``fbank_torch``; they part by float32 rounding).

The fixtures' pure tones get a noise floor at -50 dB (``noise_floor``), as
recordings have. Without one, most mel bins of a pure 16-bit tone sit near
the log floor (log 2^-23 = -15.9) with little spread, so the features carry
a common offset of ~-10 that cancels in the sum over B*T of the first
layer's weight gradient: both packages' gradients carry ~1e-6 of float32
rounding there, which Adam's first steps turn into weights 4.7e-5 apart and
running variances 4.5e-3 apart after 2 HD epochs (measured on this
flow, rtol 1e-4 missed by 3.7x), with the losses still within 1e-4. With
the floor the weights stay within 1e-6. The pure-tone HD flow is held to
the JAX CLI in float64 in ``tests/test_torch_cli_audio_f64.py``: there the
gap shrinks to 2e-7, so in float32 it is rounding.

The port alone: a RadLIF bidirectional SC device-frontend run end to end
(``--use_augm``, dropout), then ``Predictor.from_experiment`` on ragged
waveforms against the run's own eval path, bit for bit, and the
waveform predictor's contracts."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import run_exp_torch
from sparch_tpu_torch.convert import variables_from_flax
from sparch_tpu_torch.data.audio import read_wav
from sparch_tpu_torch.models.frontend import FbankFrontend
from sparch_tpu_torch.serve import Predictor
from sparch_tpu_torch.train.loop import Experiment

from .fixtures import make_hd_tree, make_sc_tree, make_shd_h5, write_wav
from .test_torch_cli import RootMessages, masked, numbers, run_jax


def noise_floor(root, amp=0.003, seed=0):
    """Add white noise of std ``amp`` to every WAV under ``root``."""
    rng = np.random.default_rng(seed)
    for path in sorted(Path(root).rglob("*.wav")):
        x = read_wav(str(path))
        write_wav(str(path), x + rng.normal(0, amp, len(x)))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio_cli")
    hd, sc = str(root / "hd"), str(root / "sc")
    make_hd_tree(hd, n_per_digit=3, digits=(0, 1))
    make_sc_tree(sc, labels=("go", "stop"), n_per_label=8)
    noise_floor(root)
    return {"hd": hd, "sc": sc}


def argv_of(data, name, folder, *extra, model="LIF", epochs=2):
    return ["--dataset_name", name, "--data_folder", data,
            "--model_type", model, "--nb_layers", "2", "--nb_hiddens", "16",
            "--batch_size", "4", "--nb_epochs", str(epochs),
            "--pad_multiple", "20", "--new_exp_folder", folder, *extra]


FLOWS = {
    "hd_host": ("hd", ("--frontend", "host")),
    "sc_device_augm": ("sc", ("--frontend", "device", "--use_augm", "true")),
}


@pytest.fixture(scope="module", params=list(FLOWS))
def pair(request, trees, tmp_path_factory):
    name, extra = FLOWS[request.param]
    extra = extra + ("--state_init", "zeros", "--pdrop", "0",
                     "--cell_impl", "scan")
    root = tmp_path_factory.mktemp(request.param)
    jfolder, tfolder = str(root / "jax"), str(root / "port")
    jexp, jmsg, init, final = run_jax(
        argv_of(trees[name], name, jfolder, *extra))
    with RootMessages() as tmsg:
        texp = Experiment(run_exp_torch.parse_args(
            argv_of(trees[name], name, tfolder, *extra)), device="cpu")
        texp.state.model.load_state_dict(variables_from_flax(init))
        texp.forward()
    return dict(flow=request.param, jexp=jexp, jmsg=jmsg, jfinal=final,
                jfolder=jfolder, texp=texp, tmsg=tmsg, tfolder=tfolder)


def test_cli_run_matches_jax(pair):
    texp, jexp = pair["texp"], pair["jexp"]
    assert texp.nb_inputs == jexp.nb_inputs == 40
    assert texp.nb_outputs == jexp.nb_outputs
    assert isinstance(texp.net, FbankFrontend) == \
        (pair["flow"] == "sc_device_augm")
    for pattern, rtol in ((r"Epoch \d+: train loss=.*", 1e-4),
                          (r"Epoch \d+: valid acc=.*", 0.0),
                          (r"Test acc=.*", 0.0)):
        got = numbers(pair["tmsg"], pattern)
        want = numbers(pair["jmsg"], pattern)
        assert len(got) == len(want) > 0, pattern
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   err_msg=pattern)
    want = variables_from_flax(pair["jfinal"])
    got = texp.state.model.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert masked(pair["tmsg"], pair["tfolder"]) == \
        masked(pair["jmsg"], pair["jfolder"])
    metas = []
    for folder in (pair["jfolder"], pair["tfolder"]):
        with open(os.path.join(folder, "checkpoints", "meta.json")) as f:
            metas.append(json.load(f)["model"])
    assert list(metas[1]) == list(metas[0])
    assert metas[1] == metas[0]
    assert metas[1]["pad_multiple"] == 20
    assert metas[1]["frontend"] == ("device" if isinstance(
        texp.net, FbankFrontend) else "host")


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def radlif(trees, tmp_path_factory):
    """RadLIF [16, 35] bidirectional on SC through the device frontend,
    augmentation and dropout on, uniform state init; 3 epochs."""
    folder = str(tmp_path_factory.mktemp("radlif") / "exp")
    with RootMessages() as messages:
        exp = run_exp_torch.main(argv_of(
            trees["sc"], "sc", folder, "--frontend", "device",
            "--bidirectional", "true", "--use_augm", "true",
            "--pdrop", "0.1", model="RadLIF", epochs=3), device="cpu")
    return exp, messages, folder


def test_radlif_device_frontend_run(radlif):
    exp, messages, folder = radlif
    assert isinstance(exp.net, FbankFrontend)
    assert exp.host_fetches == {"train": 3, "valid": 3, "test": 1}
    assert any(m.strip() == "Data augmentation is used" for m in messages)
    losses = numbers(messages, r"Epoch \d+: train loss=.*")
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert os.path.isdir(os.path.join(folder, "checkpoints", "best_model"))
    with open(os.path.join(folder, "checkpoints", "meta.json")) as f:
        record = json.load(f)["model"]
    assert record["frontend"] == "device" and record["bidirectional"]


def test_from_experiment_serves_waveforms_as_the_eval_path(radlif):
    """Ragged true-length waveforms through ``from_experiment`` (its
    pad_multiple read from the run's meta) give the probabilities of the
    run's test batches through its model, state draws seeded as the
    Predictor seeds them, bit for bit; a padded batch with its lengths
    gives them too."""
    exp, _, folder = radlif
    pred = Predictor.from_experiment(folder, batch_size=2, device="cpu")
    assert pred.pad_multiple == 20 and isinstance(pred.model, FbankFrontend)
    ds = exp.test_loader.dataset
    waves = [ds[i][0] for i in range(len(ds))]
    want = []
    exp.net.eval()
    generator = torch.Generator()
    with torch.no_grad():
        for (wav, lens), _, _ in exp.test_loader:
            generator.manual_seed(0)
            out, _ = exp.net((wav, lens), generator)
            want.append((out / out.sum(-1, keepdim=True)).numpy())
    want = np.concatenate(want)
    labels, probs = pred(waves)
    np.testing.assert_array_equal(probs, want)
    np.testing.assert_array_equal(labels, want.argmax(-1))
    padded = np.zeros((len(waves), max(map(len, waves)) + 99), np.float32)
    for i, w in enumerate(waves):
        padded[i, :len(w)] = w
    _, probs2 = pred(padded, lengths=[len(w) for w in waves])
    np.testing.assert_array_equal(probs2, probs)


def test_waveform_predictor_contracts(radlif):
    _, _, folder = radlif
    pred = Predictor.from_experiment(folder, batch_size=4, device="cpu")
    assert Predictor.from_experiment(folder, pad_multiple=7,
                                     device="cpu").pad_multiple == 7
    wav = np.zeros((2, 560), np.float32)
    with pytest.raises(ValueError, match="lengths"):
        pred(wav)  # a padded array needs its lengths
    with pytest.raises(ValueError, match="lengths"):
        pred(wav, lengths=[560])  # one length for two waveforms
    labels, probs = pred(np.zeros((0, 560), np.float32))
    assert labels.shape == (0,) and probs.shape == (0, 35)
    # a clip shorter than one frame serves; the last chunk is padded
    labels, probs = pred([np.zeros(150, np.float32)] + [wav[0]] * 4)
    assert labels.shape == (5,) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("case", ["shd_device", "sc_device_bf16"])
def test_frontend_flag_fallbacks(case, trees, tmp_path):
    """As in the JAX loop: ``--frontend device`` on SHD/SSC falls back to
    the host pipeline, and ``--input_dtype bfloat16`` is ignored with the
    device frontend (the waveforms stay float32); each with a warning."""
    if case == "shd_device":
        make_shd_h5(str(tmp_path / "shd_train.h5"), n=4, nb_classes=2)
        make_shd_h5(str(tmp_path / "shd_test.h5"), n=4, nb_classes=2)
        argv = argv_of(str(tmp_path), "shd", str(tmp_path / "exp"),
                       "--frontend", "device")
        warning = "--frontend device only applies to hd/sc"
    else:
        argv = argv_of(trees["sc"], "sc", str(tmp_path / "exp"),
                       "--frontend", "device", "--input_dtype", "bfloat16")
        warning = "--input_dtype bfloat16 is ignored"
    with RootMessages() as messages:
        exp = Experiment(run_exp_torch.parse_args(argv), device="cpu")
    assert any(warning in m for m in messages)
    if case == "shd_device":
        assert exp.frontend == "host" and not isinstance(exp.net,
                                                         FbankFrontend)
    else:
        assert exp.input_dtype == "float32"
        (x, lens), _, _ = next(iter(exp.train_loader))
        assert x.dtype == torch.float32 and x.ndim == 2
    assert exp._model_config["frontend"] == exp.frontend
