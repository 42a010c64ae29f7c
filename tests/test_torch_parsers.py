"""The port's CLI flags (``sparch_tpu_torch.parsers``, ``run_exp_torch.py``)
against the JAX package's: every action's option strings, dest, type,
default and choices, found by introspecting both parsers; ``strtobool``;
the printed options; and the flags the port refuses, each raising
``NotImplementedError`` naming its ROADMAP item before any folder is
made."""
import argparse
import logging
import os

import pytest

import run_exp
import run_exp_torch
from sparch_tpu.parsers import model_config as jax_model_config
from sparch_tpu.parsers import training_config as jax_training_config
from sparch_tpu_torch.parsers import model_config, training_config
from sparch_tpu_torch.train.loop import Experiment, refuse_unported


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


REFUSED = [
    (["--cell_impl", "pallas_tp"], "item 7"),
    (["--mesh_model", "2"], "item 7"),
    (["--seq_parallel", "2"], "item 8"),
    (["--compile_cache", "cache_dir"], "item 9"),
    (["--compile_cache", "true"], "item 9"),
    (["--profile_dir", "trace_dir"], "item 9"),
]


@pytest.mark.parametrize("argv,item", REFUSED,
                         ids=[" ".join(a) for a, _ in REFUSED])
def test_refused_flags_raise_naming_their_item(tmp_path, argv, item):
    exp = str(tmp_path / "exp")
    args = run_exp_torch.parse_args(argv + ["--new_exp_folder", exp])
    with pytest.raises(NotImplementedError, match=f"queue 1 {item}"):
        Experiment(args, device="cpu")
    assert not os.path.exists(exp)


@pytest.mark.parametrize("argv", [
    [], ["--compile_cache", "false"], ["--prng_impl", "threefry2x32"],
    ["--seq_microbatches", "8"], ["--cell_impl", "pallas"],
    # the audio path is ported
    ["--dataset_name", "hd"], ["--dataset_name", "sc"],
    ["--frontend", "device"],
])
def test_accepted_flags(argv):
    refuse_unported(run_exp_torch.parse_args(argv))
