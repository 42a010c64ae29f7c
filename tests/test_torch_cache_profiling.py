"""``--compile_cache`` and ``--profile_dir`` in the port
(sparch_tpu_torch.utils.cache, utils.profiling, ``_build``'s directory),
and the draws and plans of ``tools/fuzz_kernels_torch.py``, on the CPU.

The cache's flag values are held against sparch_tpu.utils.cache; the
kernels' build directory follows the flag and a library loaded once stays
the one in use (the loader is faked: no ``nvcc`` here); one tiny CLI
fine-tune from an imported reference checkpoint runs with both flags. The
fuzz's case draw is a function of (seed, k), and every drawn case's plans,
from the port's plan functions with injected SM counts and occupancies as
the CPU plan tests inject them, own every row and neuron within what the
card holds.
"""
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import run_exp_torch
import tools.fuzz_kernels_torch as fuzz
from sparch_tpu.utils.cache import resolve_cache_arg as jax_resolve_cache_arg
from sparch_tpu_torch import _build, migrate
from sparch_tpu_torch.ops import fused_cells
from sparch_tpu_torch.train.loop import Experiment
from sparch_tpu_torch.utils import cache
from sparch_tpu_torch.utils.profiling import trace

from tests.fixtures import make_shd_h5
from tests.test_torch_migrate import reference_state_dict


@pytest.fixture
def build_dir():
    """Leave the kernels' build directory as the test found it."""
    yield
    cache.use_compile_cache(None)


@pytest.mark.parametrize("value", [None, False, True, "true", "TRUE", "1",
                                   "yes", "on", "false", "0", "no", "Off",
                                   "none", "", "cache_dir", "/a/b"])
def test_resolve_cache_arg_equals_jax(value):
    assert cache.resolve_cache_arg(value) == jax_resolve_cache_arg(value)


def test_build_directory_follows_the_cache(build_dir, tmp_path):
    assert cache.use_compile_cache(str(tmp_path)) == tmp_path.resolve()
    assert _build.library_path("readout_fwd").parent == tmp_path.resolve()
    for value in ("true", True, "ON"):
        assert cache.use_compile_cache(value) == \
            Path(cache.default_cache_dir())
    assert cache.default_cache_dir().startswith(tempfile.gettempdir())
    for value in (None, False, "false", "none", ""):
        cache.use_compile_cache(str(tmp_path))
        assert cache.use_compile_cache(value) == _build.DEFAULT_BUILD_DIR
    assert _build.library_path("readout_fwd").parent == \
        _build.DEFAULT_BUILD_DIR


def test_a_loaded_library_stays_loaded(build_dir, tmp_path, monkeypatch):
    """``_build.load`` opens a library once for its digest: after the
    directory moves, the library already open is used again and nothing
    is built or opened a second time."""
    opened, built = [], []
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: opened.append(path) or object())
    monkeypatch.setattr(_build, "build", lambda names: built.append(names))
    cache.use_compile_cache(str(tmp_path / "a"))
    path = _build.library_path("readout_fwd")
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    lib = _build.load("readout_fwd")
    assert _build.load("readout_fwd") is lib
    cache.use_compile_cache(str(tmp_path / "b"))
    assert not _build.library_path("readout_fwd").exists()
    assert _build.load("readout_fwd") is lib
    assert opened == [str(path)] and built == []
    # another source is built in the new directory
    _build.load("readout_bwd")
    assert built == [["readout_bwd"]]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path / "t"), "cpu"):
        torch.ones(3).add_(1)
    (path,) = (tmp_path / "t").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)


@pytest.fixture(scope="module")
def shd(tmp_path_factory):
    d = tmp_path_factory.mktemp("shd")
    make_shd_h5(str(d / "shd_train.h5"), n=16, nb_classes=4, seed=0)
    make_shd_h5(str(d / "shd_test.h5"), n=8, nb_classes=4, seed=1)
    return str(d)


def test_fine_tune_with_cache_and_profile(build_dir, shd, tmp_path):
    """An imported reference RadLIF [16, 16, 20] fine-tuned for one epoch
    by ``run_exp_torch`` with ``--compile_cache`` and ``--profile_dir``:
    the run starts from the imported weights, builds its kernels in the
    cache's directory and writes a readable trace of its first epoch."""
    folder = str(tmp_path / "imported")
    sd = reference_state_dict("RadLIF", sizes=(16, 16, 20), n_in=700,
                              seed=7)
    torch.save(sd, str(tmp_path / "sd.pth"))
    _, imported = migrate.import_torch_checkpoint(
        str(tmp_path / "sd.pth"), folder, config_overrides={"batch_size": 8},
        device="cpu")
    argv = ["--model_type", "RadLIF", "--nb_layers", "3", "--nb_hiddens",
            "16", "--dataset_name", "shd", "--data_folder", shd,
            "--batch_size", "8", "--nb_epochs", "1", "--pdrop", "0.1",
            "--use_pretrained_model", "1", "--load_exp_folder", folder,
            "--compile_cache", str(tmp_path / "kernels"),
            "--profile_dir", str(tmp_path / "trace")]
    exp = Experiment(run_exp_torch.parse_args(argv), device="cpu")
    assert exp.kernel_dir == (tmp_path / "kernels").resolve() == \
        _build.BUILD_DIR
    state = exp.net.state_dict()
    assert state.keys() == imported.keys()
    for k, v in imported.items():
        assert torch.equal(state[k], v), k
    fused_cells.reset_launch_counts()
    exp.forward()
    assert not any(fused_cells.launch_counts().values())
    assert [h["split"] for h in exp.history] == ["valid", "train", "valid",
                                                 "test"]
    assert np.isfinite([h["loss"] for h in exp.history]).all()
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "aten::addmm" in names or "aten::matmul" in names


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_draw_is_a_function_of_seed_and_case(seed):
    cases = [fuzz.draw_case(seed, k) for k in range(2 * len(fuzz.FAMILIES))]
    assert cases == [fuzz.draw_case(seed, k)
                     for k in range(2 * len(fuzz.FAMILIES))]
    assert cases != [fuzz.draw_case(seed + 10, k)
                     for k in range(2 * len(fuzz.FAMILIES))]
    first = cases[:len(fuzz.FAMILIES)]
    assert [c["family"] for c in first] == list(fuzz.FAMILIES)
    # the first round reaches the rows layout and the readout's wide forms
    assert first[0]["H"] >= fuzz.WIDE_H[0]
    assert first[3]["C"] > fused_cells._LANE_C
    names = {fuzz.case_name(c) for c in cases}
    assert len(names) == len(cases)


# clusters of 1-6 one-SM blocks an H100 80GB HBM3 holds at once
# (cudaOccupancyMaxActiveClusters, PERF.md), and half of it
HELD = {"h100": {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17},
        "half": {1: 66, 2: 33, 3: 19, 4: 15, 5: 11, 6: 8}}


def smem_per_sm(source, form, H, cols, rows, threads):
    """Blocks an SM holds by shared memory and threads (the model of
    tests/test_torch_cell_fwd_plan.py)."""
    smem = fused_cells._slice_smem(H, cols, rows, threads, bool(form[-1]))
    return max(0, min(233472 // (smem + 1024), 2048 // threads,
                      65536 // (threads * 64)))


@pytest.mark.parametrize("sms,held", [(132, "h100"), (114, "h100"),
                                      (66, "half")])
def test_fuzz_cases_have_valid_plans(sms, held):
    for seed in (0, 1):
        for k in range(150):
            case = fuzz.draw_case(seed, k)
            plans = fuzz.plans_of(case, sms, smem_per_sm,
                                  lambda kernel, c: HELD[held][c])
            assert fuzz.plan_faults(case, plans, sms) == [], \
                fuzz.case_name(case)
            if case["family"] in ("tp_bwd", "tp_ann_fwd", "tp_ann_bwd"):
                assert plans["tp"].per_rank * case["P"] <= \
                    HELD[held][plans["tp"].rank.cluster]


def test_plan_faults_find_a_bad_plan():
    case = fuzz.draw_case(0, 5)  # an ANN forward
    plan = fuzz.plans_of(case, 132, smem_per_sm, lambda k, c: 132)["fwd"]
    bad = plan._replace(clusters=plan.clusters + 1)
    assert fuzz.plan_faults(case, {"fwd": bad}, 132)
    assert fuzz.plan_faults(case, {"fwd": plan._replace(cols=1)}, 132)
