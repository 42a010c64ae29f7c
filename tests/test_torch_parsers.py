"""The port's CLI flags (``sparch_tpu_torch.parsers``, ``run_exp_torch.py``)
against the JAX package's: every action's option strings, dest, type,
default and choices, found by introspecting both parsers; ``strtobool``;
the printed options; the flags of the parallel paths (items 7 and 8) and of
ROADMAP item 9, accepted and acted on."""
import argparse
import logging
import os

import pytest

import run_exp
import run_exp_torch
from sparch_tpu.parsers import model_config as jax_model_config
from sparch_tpu.parsers import training_config as jax_training_config
from sparch_tpu_torch.parsers import model_config, training_config
from sparch_tpu_torch.train.loop import Experiment


def surface(add):
    parser = add(argparse.ArgumentParser())
    rows = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        rows[a.dest] = (tuple(a.option_strings),
                        getattr(a.type, "__name__", a.type), a.default,
                        tuple(a.choices) if a.choices else None, a.nargs,
                        a.required)
    return rows


@pytest.mark.parametrize("which", ["model", "training"])
def test_flag_surface_equals_jax(which):
    port = {"model": model_config.add_model_options,
            "training": training_config.add_training_options}[which]
    jax = {"model": jax_model_config.add_model_options,
           "training": jax_training_config.add_training_options}[which]
    got, want = surface(port), surface(jax)
    assert list(got) == list(want)
    assert got == want


def test_cli_parses_as_jax():
    argv = ["--model_type", "GRU", "--nb_layers", "4", "--use_bias", "yes",
            "--dataset_name", "ssc", "--lr", "0.001", "--seed", "3",
            "--input_dtype", "bfloat16", "--auto_resume", "true"]
    assert vars(run_exp_torch.parse_args(argv)) == \
        vars(run_exp.parse_args(argv))
    assert vars(run_exp_torch.parse_args([])) == vars(run_exp.parse_args([]))


def test_help_lists_every_flag(capsys):
    def flags(module):
        with pytest.raises(SystemExit):
            module.parse_args(["-h"])
        out = capsys.readouterr().out
        return sorted(w for w in out.split() if w.startswith("--"))

    assert flags(run_exp_torch) == flags(run_exp)


@pytest.mark.parametrize("value", ["y", "Yes", "TRUE", "on", "1", "n", "No",
                                   "false", "OFF", "0", "maybe"])
def test_strtobool_equals_jax(value):
    try:
        want = jax_model_config.strtobool(value)
    except ValueError:
        with pytest.raises(ValueError):
            model_config.strtobool(value)
        return
    assert model_config.strtobool(value) is want


@pytest.fixture
def root_messages(monkeypatch):
    """The messages logged on the root logger at INFO and above."""
    messages = []
    monkeypatch.setattr(logging.root, "handle",
                        lambda rec: messages.append(rec.getMessage()))
    level = logging.root.level
    logging.root.setLevel(logging.INFO)
    yield messages
    logging.root.setLevel(level)


def test_printed_options_equal_jax(root_messages):
    args = run_exp.parse_args(["--model_type", "RadLIF", "--workers", "2"])
    messages = root_messages
    for mc, tc in ((model_config, training_config),
                   (jax_model_config, jax_training_config)):
        mc.print_model_options(args)
        tc.print_training_options(args)
    assert len(messages) == 4
    assert messages[:2] == messages[2:]


# the flags that were refused until their items were ported: item 7 (data
# parallelism, the TP mesh through the CLI) and item 8 (--seq_parallel,
# the sequence pipeline) build an Experiment on their meshes
REFUSED = [
    (["--cell_impl", "pallas_tp", "--mesh_model", "2", "--nb_hiddens",
      "256"], None),
    (["--mesh_model", "2"], None),
    (["--seq_parallel", "2"], "item 8"),
]


@pytest.mark.parametrize("argv,item", REFUSED,
                         ids=[" ".join(a[:2]) for a, _ in REFUSED])
def test_refused_flags_raise_naming_their_item(tmp_path, argv, item,
                                               monkeypatch):
    exp = str(tmp_path / "exp")
    args = run_exp_torch.parse_args(argv + ["--new_exp_folder", exp])
    # no data on disk: the run builds everything but its loaders
    monkeypatch.setattr(Experiment, "init_dataset", _no_data)
    exp = Experiment(args, device="cpu")
    if item is not None:
        # the pipeline's mesh and steps; no item-8 refusal is left
        assert exp.seq_mesh.shape == {"data": 1, "seq": 2, "model": 1}
        assert exp.seq_mesh.one_card and exp.mesh.shape["model"] == 1
        assert callable(exp._pipe_train_step)
        assert callable(exp._pipe_eval_step)
        return
    assert exp.seq_mesh is None
    P = int(argv[argv.index("--mesh_model") + 1])
    assert exp.mesh.shape == {"data": 1, "model": P} and exp.mesh.one_card
    layer = exp.net.layer_0
    assert layer.cell_impl == exp.cell_impl
    assert (layer.tp_mesh is exp.mesh) == (exp.cell_impl == "pallas_tp")


def _no_data(self):
    self.nb_inputs, self.nb_outputs = 700, 20


# ported with utils/cache.py and utils/profiling.py: accepted, and a run
# acts on them
ITEM_9 = [["--compile_cache", "cache_dir"], ["--compile_cache", "true"],
          ["--profile_dir", "trace_dir"]]


@pytest.fixture(scope="module")
def shd(tmp_path_factory):
    from tests.fixtures import make_shd_h5

    d = tmp_path_factory.mktemp("shd")
    make_shd_h5(str(d / "shd_train.h5"), n=8, nb_classes=4, seed=0)
    make_shd_h5(str(d / "shd_test.h5"), n=4, nb_classes=4, seed=1)
    return str(d)


@pytest.mark.parametrize("argv", ITEM_9, ids=[" ".join(a) for a in ITEM_9])
def test_item9_flags_are_accepted_and_run(shd, tmp_path, monkeypatch, argv):
    """The flags that were refused until their modules were ported: a
    one-epoch run builds its kernels in the cache's directory (a relative
    path from the working directory, 'true' the per-user default) or
    writes a profiler trace of its first epoch."""
    from sparch_tpu_torch.utils import cache

    monkeypatch.chdir(tmp_path)
    args = run_exp_torch.parse_args(argv + [
        "--dataset_name", "shd", "--data_folder", shd, "--batch_size", "4",
        "--nb_hiddens", "8", "--nb_layers", "2", "--nb_epochs", "1",
        "--new_exp_folder", str(tmp_path / "exp")])
    try:
        exp = Experiment(args, device="cpu")
        exp.forward()
        kernel_dir = exp.kernel_dir
    finally:
        cache.use_compile_cache(None)
    want = {"cache_dir": tmp_path / "cache_dir",
            "true": cache.default_cache_dir()}.get(args.compile_cache)
    if want is None:
        assert kernel_dir == cache.use_compile_cache(None)
        assert len(list((tmp_path / "trace_dir").glob("trace_*.json"))) == 1
    else:
        assert str(kernel_dir) == os.path.realpath(want)
        assert not (tmp_path / "trace_dir").exists()
    assert [h["split"] for h in exp.history] == ["train", "valid", "test"]


@pytest.mark.parametrize("argv", [
    [], ["--compile_cache", "false"], ["--prng_impl", "threefry2x32"],
    ["--seq_microbatches", "8"], ["--cell_impl", "pallas"],
    # the audio path is ported
    ["--dataset_name", "hd"], ["--dataset_name", "sc"],
    ["--frontend", "device"],
])
def test_accepted_flags(argv, tmp_path, monkeypatch):
    """Each builds an Experiment (no data on disk: all but the loaders)."""
    monkeypatch.setattr(Experiment, "init_dataset", _no_data)
    args = run_exp_torch.parse_args(argv + ["--new_exp_folder",
                                            str(tmp_path / "exp")])
    exp = Experiment(args, device="cpu")
    assert exp.net.layer_0.cell_impl == args.cell_impl
