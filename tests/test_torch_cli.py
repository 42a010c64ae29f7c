"""The port's CLI (``run_exp_torch.py``, ``train.loop.Experiment``,
``serve.Predictor.from_experiment``) on the CPU.

Against the JAX package: both ``Experiment`` classes are built from the
same argv on the same SHD-schema files (LIF and RadLIF, 2 epochs,
``state_init zeros``, ``pdrop 0``, ``cell_impl scan``), the port's model
is given the JAX model's initial weights (``convert.variables_from_flax``,
loaded in place so that the optimizer keeps its parameters), and both
run ``forward()``: the train loss of every epoch within rtol 1e-4, the
valid and test accuracy equal or one utterance apart, the final weights
within rtol 1e-4 / atol 1e-5, the log lines equal with their numbers
masked (but the JAX mesh line, the port's device line and the model's
description), and ``meta.json``'s ``model`` record equal key for key.

LIF holds these tolerances over the 2 epochs (6 steps). RadLIF does not,
and neither does the JAX package against itself: a membrane value within
rounding of the threshold spikes in one run and not in the other, the
recurrence carries the difference on, and Adam's first steps turn
gradients near zero into steps of +-lr whatever their size. On these
files it starts at the first train-mode forward: on a batch of 8 such
utterances, at the same initial weights, the JAX scan model and the
port's spike a different number of times in 2 to 9 of the 32 hidden
neurons, with the matrices on a 2^-12 grid (every product exact) and
without normalization too, and a first epoch of that one batch gives
losses 3 % apart. The JAX CLI's 8-device and 1-device runs of RadLIF on
these files part by 3 % in the first epoch's loss and by up to 0.08 in a
weight after 6 steps. So where a value misses its tolerance, the JAX CLI runs again on
one device of its mesh, which changes only the order of the batch sums,
and the port may be no further from the JAX run than that run is: each
tensor's largest distance within 3 times that run's largest, and its
distance as a whole (the L2 norm over its elements) within 2 times that
run's. The second bound is what holds the weights: a port whose whole
tensor moves apart from the JAX run fails it where a few flipped elements
do not.

The port alone: a fresh run, ``--auto_resume``, ``--use_pretrained_model``
with and without ``--only_do_testing``, ``--input_dtype bfloat16`` (the
float32 run's numbers exactly: spike counts are exact in bf16), an ANN,
the folder rules and serving from the folder."""
import functools
import json
import logging
import os
import re
import shutil
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import run_exp
import run_exp_torch
from sparch_tpu.parallel import mesh as jax_mesh
from sparch_tpu.train import loop as jax_loop
from sparch_tpu.train.loop import Experiment as JaxExperiment
from sparch_tpu_torch.convert import variables_from_flax
from sparch_tpu_torch.models import build_model_from_config
from sparch_tpu_torch.serve import Predictor, load_experiment
from sparch_tpu_torch.train.checkpoint import load_state_tree
from sparch_tpu_torch.train.loop import Experiment

from .fixtures import make_shd_h5

N_TRAIN, N_TEST = 20, 12
# the valid and test means are over batches of 8 and 4: one utterance of
# the 4 moves the mean by 1/8
ONE_UTTERANCE = 1.0 / 8 + 1e-7
# how much further from the JAX run than the JAX run on one device the
# port may land where rounding tips spikes: at a tensor's largest distance,
# and in its distance as a whole (L2 over the elements)
WITNESS_FACTOR = 3.0
WITNESS_NORM_FACTOR = 2.0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shd"))
    make_shd_h5(f"{d}/shd_train.h5", n=N_TRAIN, nb_classes=4, seed=0,
                noise_frac=0.3)
    make_shd_h5(f"{d}/shd_test.h5", n=N_TEST, nb_classes=4, seed=1,
                noise_frac=0.3)
    return d


def argv_of(data, folder, *extra, hiddens=16, epochs=2):
    return ["--dataset_name", "shd", "--data_folder", data,
            "--batch_size", "8", "--nb_hiddens", str(hiddens),
            "--nb_epochs", str(epochs), "--new_exp_folder", folder,
            *extra]


class RootMessages:
    """Collects the messages logged on the root logger at INFO and up
    (the loops log there; libraries log on their own loggers)."""

    def __enter__(self):
        self.messages = []
        self._level = logging.root.level
        logging.root.handle = lambda rec: self.messages.append(
            rec.getMessage())
        logging.root.setLevel(logging.INFO)
        return self.messages

    def __exit__(self, *exc):
        del logging.root.handle
        logging.root.setLevel(self._level)


def numbers(messages, pattern):
    return [float(m.split("=")[-1]) for m in messages
            if re.fullmatch(pattern, m)]


def masked(messages, folder):
    out = []
    for m in messages:
        m = m.replace(folder, "<exp>")
        m = re.sub(r"\d+(\.\d+)?(e[-+]?\d+)?", "#", m)
        if m.strip().startswith(("Device mesh:", "Device:")):
            continue  # the JAX mesh line and the port's device line
        if "Created new" in m:
            m = m.split(":")[0]  # the models describe themselves apart
        out.append(m)
    return out


def _float64(tree):
    return jax.tree.map(
        lambda a: a.astype(np.float64)
        if np.issubdtype(a.dtype, np.floating) else a, tree)


def run_jax(argv, devices=None, float64=False):
    """The JAX CLI's run of ``argv``, on the whole CPU mesh or on
    ``devices``; returns (experiment, messages, initial and final
    variables). ``float64``: with ``jax_enable_x64`` on, the state (every
    parameter, statistic and optimizer moment) and each input batch cast
    to float64 (the initial variables are returned as built, in
    float32)."""
    prng = jax.config.jax_default_prng_impl
    mesh = functools.partial(jax_mesh.make_mesh, devices)
    put = JaxExperiment._put_batch
    if float64:
        def put(self, x, y, put=put):
            return put(self, _float64(x), y)
    try:
        jax.config.update("jax_enable_x64", float64)
        with RootMessages() as messages, \
                mock.patch.object(jax_loop, "make_mesh", mesh), \
                mock.patch.object(JaxExperiment, "_put_batch", put):
            exp = JaxExperiment(run_exp.parse_args(argv))
            init = jax.device_get({"params": exp.state.params,
                                   "batch_stats": exp.state.batch_stats})
            if float64:
                exp.state = _float64(exp.state)
            exp.forward()
    finally:
        # the JAX loop sets the process's PRNG implementation
        jax.config.update("jax_default_prng_impl", prng)
        jax.config.update("jax_enable_x64", False)
    final = jax.device_get({"params": exp.state.params,
                            "batch_stats": exp.state.batch_stats})
    return exp, messages, init, final


@pytest.fixture(scope="module", params=["LIF", "RadLIF"])
def pair(request, data, tmp_path_factory):
    """One JAX run and one port run per model type, the port starting
    from the JAX model's initial weights."""
    root = tmp_path_factory.mktemp(request.param)
    extra = ("--model_type", request.param, "--state_init", "zeros",
             "--pdrop", "0", "--cell_impl", "scan")
    jfolder, tfolder = str(root / "jax"), str(root / "port")
    jexp, jmsg, init, final = run_jax(argv_of(data, jfolder, *extra))
    with RootMessages() as tmsg:
        texp = Experiment(run_exp_torch.parse_args(
            argv_of(data, tfolder, *extra)), device="cpu")
        texp.state.model.load_state_dict(variables_from_flax(init))
        texp.forward()
    witness = {}

    def one_device():
        """The JAX CLI's run again on one device of the mesh (another
        order of the batch sums): how far the reference moves by rounding
        alone."""
        if not witness:
            folder = str(root / "jax1")
            _, msg, _, fin = run_jax(argv_of(data, folder, *extra),
                                     jax.devices()[:1])
            witness.update(msg=msg, final=fin, folder=folder)
        return witness

    return types.SimpleNamespace(jexp=jexp, jmsg=jmsg, jfinal=final,
                                 jfolder=jfolder, texp=texp, tmsg=tmsg,
                                 tfolder=tfolder, one_device=one_device)


def within_or_witnessed(got, want, witness, rtol, atol, what):
    """``got`` (the port) within ``atol + rtol * |want|`` of ``want`` (the
    JAX CLI on the whole mesh); else no further from it than the JAX CLI's
    own run on one device (``witness()``) is: the largest distance within
    WITNESS_FACTOR times that run's largest, and the L2 distance within
    WITNESS_NORM_FACTOR times that run's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    if np.all(err <= atol + rtol * np.abs(want)):
        return
    spread = np.abs(np.asarray(witness(), np.float64) - want)
    assert err.max() <= WITNESS_FACTOR * spread.max(), \
        (what, got, want, spread)
    assert np.linalg.norm(err) <= \
        WITNESS_NORM_FACTOR * np.linalg.norm(spread), \
        (what, np.linalg.norm(err), np.linalg.norm(spread))


def test_epoch_losses_and_accuracies_match_jax(pair):
    for pattern, rtol, atol in (
            (r"Epoch \d+: train loss=.*", 1e-4, 0.0),
            (r"Epoch \d+: valid acc=.*", 0.0, ONE_UTTERANCE),
            (r"Test acc=.*", 0.0, ONE_UTTERANCE)):
        got, want = numbers(pair.tmsg, pattern), numbers(pair.jmsg, pattern)
        assert len(got) == len(want) > 0
        within_or_witnessed(
            got, want, lambda: numbers(pair.one_device()["msg"], pattern),
            rtol, atol, pattern)


def test_final_weights_match_jax(pair):
    want = variables_from_flax(pair.jfinal)
    got = pair.texp.state.model.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        within_or_witnessed(
            got[k].numpy(), want[k].numpy(),
            lambda: variables_from_flax(pair.one_device()["final"])[k],
            1e-4, 1e-5, k)


def test_log_lines_match_jax(pair):
    """The lines of the port's run are the JAX run's, numbers masked; where
    the JAX runs on the whole mesh and on one device log other lines (a
    best model saved at another epoch), the port's are one of the two."""
    got = masked(pair.tmsg, pair.tfolder)
    if got != masked(pair.jmsg, pair.jfolder):
        one = pair.one_device()
        witness = masked(one["msg"], one["folder"])
        assert masked(pair.jmsg, pair.jfolder) != witness
        assert got == witness


def test_meta_model_record_matches_jax(pair):
    metas = []
    for folder in (pair.jfolder, pair.tfolder):
        with open(os.path.join(folder, "checkpoints", "meta.json")) as f:
            metas.append(json.load(f))
    jmeta, tmeta = metas
    assert list(tmeta["model"]) == list(jmeta["model"])
    assert tmeta["model"] == jmeta["model"]
    assert tmeta.keys() == jmeta.keys()
    assert tmeta["scheduler"].keys() == jmeta["scheduler"].keys()
    # the record rebuilds the model the run trained
    model = build_model_from_config(tmeta["model"])
    assert model.state_dict().keys() == \
        pair.texp.state.model.state_dict().keys()


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

def run(data, folder, *extra, **kw):
    with RootMessages() as messages:
        exp = run_exp_torch.main(argv_of(data, folder, *extra, **kw),
                                 device="cpu")
    return exp, messages


@pytest.fixture(scope="module")
def fresh(data, tmp_path_factory):
    """LIF [8, 8, 20], 2 epochs, zero state init, default dropout and
    'auto' (the kernels' plain versions on the CPU)."""
    folder = str(tmp_path_factory.mktemp("fresh") / "exp")
    exp, messages = run(data, folder, "--state_init", "zeros", hiddens=8)
    return exp, messages, folder


def test_fresh_run(fresh):
    exp, messages, folder = fresh
    assert os.path.isdir(os.path.join(folder, "log"))
    assert os.path.isdir(os.path.join(folder, "checkpoints", "best_model"))
    assert exp.host_fetches == {"train": 2, "valid": 2, "test": 1}
    train = [h for h in exp.history if h["split"] == "train"]
    assert [h["epoch"] for h in train] == [1, 2]
    assert all(h["utterances"] == N_TRAIN and not h["pinned"]
               for h in train)
    assert [h["loss"] for h in train] == \
        numbers(messages, r"Epoch \d+: train loss=.*")
    assert [h["acc"] for h in exp.history if h["split"] == "valid"] == \
        numbers(messages, r"Epoch \d+: valid acc=.*")
    assert exp.history[-1]["split"] == "test"
    assert exp.history[-1]["acc"] == exp.test_acc
    assert any(m.startswith("Loading best model") for m in messages)
    assert exp.state.model.readout.W.weight.device.type == "cpu"


def test_existing_folder_raises(fresh, data):
    _, _, folder = fresh
    with pytest.raises(FileExistsError):
        run(data, folder, hiddens=8)


def test_auto_resume_continues_from_the_best_epoch(fresh, data, tmp_path):
    folder = str(tmp_path / "exp")
    shutil.copytree(fresh[2], folder)
    with open(os.path.join(folder, "checkpoints", "meta.json")) as f:
        best = json.load(f)["epoch"]
    saved = load_state_tree(os.path.join(folder, "checkpoints"), "cpu")
    args = run_exp_torch.parse_args(argv_of(
        data, folder, "--state_init", "zeros", "--auto_resume", "true",
        hiddens=8, epochs=1))
    with RootMessages() as messages:
        exp = Experiment(args, device="cpu")
        # the constructed state is the checkpoint's
        for k, v in saved["model"].items():
            assert torch.equal(exp.state.model.state_dict()[k], v), k
        assert exp.state.step == saved["step"]
        exp.forward()
    assert any(m.strip().startswith(f"------ Auto-resumed from epoch {best}")
               for m in messages)
    epochs = [int(m.split(":")[0].split()[1]) for m in messages
              if re.fullmatch(r"Epoch \d+: train loss=.*", m)]
    assert epochs == [best + 1]


def test_pretrained_only_testing_gives_the_runs_test_acc(fresh, data):
    exp0, messages0, folder = fresh
    exp, messages = run(data, "unused", "--state_init", "zeros",
                        "--use_pretrained_model", "true",
                        "--only_do_testing", "true",
                        "--load_exp_folder", folder, hiddens=8)
    assert exp.exp_folder == folder
    assert not numbers(messages, r"Epoch \d+: train loss=.*")
    # zero state inits: the same weights give the same test
    assert exp.test_acc == exp0.test_acc
    assert numbers(messages, r"Test loss=.*") == \
        numbers(messages0, r"Test loss=.*")


def test_pretrained_training_validates_first(data, tmp_path):
    folder = str(tmp_path / "exp")
    run(data, folder, "--state_init", "zeros", hiddens=8, epochs=1)
    exp, messages = run(data, "unused", "--state_init", "zeros",
                        "--use_pretrained_model", "true",
                        "--load_exp_folder", folder, "--start_epoch", "3",
                        hiddens=8, epochs=1)
    assert any("Using pretrained model" in m for m in messages)
    assert numbers(messages, r"Epoch 3: valid acc=.*")
    assert numbers(messages, r"Epoch \d+: train loss=.*")


def test_pretrained_without_checkpoint_raises(data, tmp_path):
    with pytest.raises(FileNotFoundError):
        run(data, "unused", "--use_pretrained_model", "true",
            "--load_exp_folder", str(tmp_path), hiddens=8)


def test_bf16_inputs_give_the_float32_run(data, tmp_path):
    """Spike counts are exact in bf16 and a float32 model promotes the
    batch: every logged number but the times is the float32 run's."""
    runs = []
    for dtype in ("float32", "bfloat16"):
        exp, messages = run(data, str(tmp_path / dtype), "--model_type",
                            "RadLIF", "--input_dtype", dtype, hiddens=8,
                            epochs=1)
        runs.append([m for m in messages if "=" in m and "time" not in m
                     and "input_dtype" not in m
                     and "new_exp_folder" not in m])
    assert runs[0] == runs[1]
    seen = []
    exp.train_loader.batch_transform = lambda b: seen.append(
        exp._to_tensors(b)) or seen[-1]
    next(iter(exp.train_loader))
    assert seen[0][0].dtype == torch.bfloat16


def test_ann_model(data, tmp_path):
    exp, messages = run(data, str(tmp_path / "gru"), "--model_type", "GRU",
                        hiddens=8, epochs=1)
    assert not exp.net.is_snn
    assert not any("act rate" in m for m in messages)
    assert any(m.strip().startswith("Created new non-spiking model")
               for m in messages)
    assert 0.0 <= exp.test_acc <= 1.0


def test_auto_generated_folder_name_is_the_jax_loops(data, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset_name", "shd", "--data_folder", data, "--nb_hiddens",
            "8", "--nb_epochs", "1", "--batch_size", "8", "--pdrop", "0.25",
            "--use_bias", "true", "--lr", "0.005"]
    with RootMessages():
        exp = run_exp_torch.main(argv, device="cpu")
    # the JAX loop's naming rule, run on the same attributes
    fake = types.SimpleNamespace(**{k: getattr(exp, k) for k in (
        "use_pretrained_model", "new_exp_folder", "dataset_name",
        "model_type", "nb_layers", "nb_hiddens", "pdrop", "normalization",
        "use_bias", "bidirectional", "use_regularizers", "lr",
        "auto_resume")})
    fake.new_exp_folder = None
    monkeypatch.chdir(tmp_path / "exp")  # a place without that folder
    JaxExperiment.init_exp_folders(fake)
    assert exp.exp_folder == fake.exp_folder
    assert exp.exp_folder.startswith("exp/test_exps/shd_LIF_3lay8_drop0_25")


def test_predictor_from_experiment(fresh, data):
    exp, _, folder = fresh
    x = np.stack([exp.valid_loader.dataset[i][0] for i in range(N_TEST)])
    served = Predictor.from_experiment(folder, batch_size=8, device="cpu")
    model, state_dict = load_experiment(folder, device="cpu")
    direct = Predictor(model, state_dict, batch_size=8, device="cpu")
    labels, probs = served(x)
    want_labels, want_probs = direct(x)
    np.testing.assert_array_equal(probs, want_probs)
    np.testing.assert_array_equal(labels, want_labels)
    # the best checkpoint is the model the run tested with
    same = Predictor(exp.net, exp.net.state_dict(), batch_size=8,
                     device="cpu")
    np.testing.assert_array_equal(same(x)[1], probs)


def test_entry_points_need_a_card_unless_asked(data, tmp_path):
    folder = str(tmp_path / "exp")
    args = run_exp_torch.parse_args(argv_of(data, folder))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(args)
    assert not os.path.exists(folder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_experiment(folder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_experiment(folder)
