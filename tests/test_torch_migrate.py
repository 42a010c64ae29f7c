"""Migration in the port (sparch_tpu_torch.migrate and its two tools)
against sparch_tpu.migrate on the CPU.

The reference package is not in the repository, so its checkpoints are
built here by hand in its layout (``reference_state_dict``: ``snn.{i}`` /
``ann.{i}`` with ``W``, ``alpha``, ``beta``, ``a``, ``b``, ``V``, the ANN
gates and norms, ``num_batches_tracked``) from a numpy seed, and a pickled
module is stood in for by an ``nn.Module`` carrying the reference's
attribute names. Weights and inputs sit on dyadic grids, so that the
forwards of both packages can be held spike for spike.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu import migrate as jax_migrate
from sparch_tpu.models import build_model_from_config as jax_model_from_config
from sparch_tpu_torch import migrate
from sparch_tpu_torch.convert import variables_from_flax
from sparch_tpu_torch.models import build_model_from_config
from sparch_tpu_torch.serve import Predictor

B, T, F, H, C = 3, 15, 10, 12, 4
SNN_TYPES = ("LIF", "adLIF", "RLIF", "RadLIF")
ANN_TYPES = ("MLP", "RNN", "LiGRU", "GRU")
GATES = {"MLP": (), "RNN": ("",), "LiGRU": ("", "z"), "GRU": ("", "z", "r")}


def _dyadic(rng, shape, scale, mean=0.0, step=2.0 ** -8):
    return torch.from_numpy(
        (np.round(rng.normal(mean, scale, shape) / step) * step)
        .astype(np.float32))


def _norm(sd, prefix, n, normalization, rng):
    """A reference norm: gains of 4 and positive biases (so that every
    layer spikes), running statistics off their defaults."""
    if normalization == "none":
        return
    sd[f"{prefix}.weight"] = torch.full((n,), 4.0)
    sd[f"{prefix}.bias"] = torch.from_numpy(
        (np.round(rng.uniform(0.5, 1.0, n) * 16) / 16).astype(np.float32))
    if normalization == "batchnorm":
        sd[f"{prefix}.running_mean"] = _dyadic(rng, n, 0.1)
        sd[f"{prefix}.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 2.0, n).astype(np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)


def reference_state_dict(model_type, normalization="batchnorm",
                         use_bias=False, bidirectional=False, seed=0,
                         sizes=(H, H, C), n_in=F):
    """A ``state_dict`` in the reference's layout (snns.py / anns.py),
    weights on a 2^-8 grid (positive on average without a norm, so that
    every layer spikes)."""
    rng = np.random.default_rng(seed)
    snn = model_type in SNN_TYPES
    container = "snn" if snn else "ann"
    sd = {}
    width = n_in
    for i, h in enumerate(sizes):
        p = f"{container}.{i}"
        readout = i == len(sizes) - 1
        projections = [""] if readout or snn else list(GATES[model_type]) \
            or [""]
        for g in projections:
            sd[f"{p}.W{g}.weight"] = _dyadic(
                rng, (h, width), 1.0 / np.sqrt(width),
                1.0 / np.sqrt(width) if normalization == "none" else 0.0)
            if use_bias:
                sd[f"{p}.W{g}.bias"] = _dyadic(rng, h, 0.1)
            _norm(sd, f"{p}.norm{g}", h, normalization, rng)
        if snn:
            sd[f"{p}.alpha"] = torch.from_numpy(
                rng.uniform(np.exp(-1 / 5), np.exp(-1 / 25), h)
                .astype(np.float32))
        if snn and not readout and model_type in ("adLIF", "RadLIF"):
            sd[f"{p}.beta"] = torch.from_numpy(
                rng.uniform(np.exp(-1 / 30), np.exp(-1 / 120), h)
                .astype(np.float32))
            sd[f"{p}.a"] = torch.from_numpy(
                rng.uniform(-1, 1, h).astype(np.float32))
            sd[f"{p}.b"] = torch.from_numpy(
                rng.uniform(0, 2, h).astype(np.float32))
        if not readout and (model_type in ("RLIF", "RadLIF") or
                            (not snn and model_type != "MLP")):
            for g in GATES.get(model_type, ("",)):
                sd[f"{p}.V{g}.weight"] = _dyadic(rng, (h, h),
                                                 0.5 / np.sqrt(h))
        width = h * (2 if bidirectional else 1)
    return sd


CASES = [(m, norm, bias, bidir)
         for m in SNN_TYPES + ANN_TYPES
         for norm in ("batchnorm", "layernorm", "none")
         for bias in (False, True)
         for bidir in ([False] if m == "MLP" else [bias])]


def _case_id(case):
    m, norm, bias, bidir = case
    return f"{m}-{norm}-{'bias' if bias else 'nobias'}-" \
           f"{'bdir' if bidir else 'udir'}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_port_state_dict_equals_the_jax_route(case):
    """The port's reference-to-port state dict equals
    ``variables_from_flax`` of the JAX function's tree, key for key and
    bit for bit, and the port's model of the record takes it strictly."""
    model_type, norm, bias, bidir = case
    sd = reference_state_dict(model_type, norm, bias, bidir)
    cfg = jax_migrate.infer_config_from_state_dict(sd, batch_size=B)
    got = migrate.state_dict_from_reference(sd, cfg)
    want = variables_from_flax(jax_migrate.variables_from_state_dict(sd, cfg))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    build_model_from_config(cfg).load_state_dict(got, strict=True)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_inferred_config_equals_jax(case):
    model_type, norm, bias, bidir = case
    sd = reference_state_dict(model_type, norm, bias, bidir)
    for kw in ({}, {"batch_size": B, "threshold": 1.5, "dropout": "0.25"}):
        want = jax_migrate.infer_config_from_state_dict(sd, **kw)
        assert migrate.infer_config_from_state_dict(sd, **kw) == want
    assert want["model_type"] == model_type
    assert want["bidirectional"] == bidir and want["use_bias"] == bias
    assert want["normalization"] == norm


class StandIn(torch.nn.Module):
    """A stand-in for a pickled reference module: its attribute names
    (snns.py:94-107 / anns.py:71-83) and its ``state_dict``."""

    def __init__(self, model_type, sd, **attrs):
        super().__init__()
        self._sd = sd
        if model_type in SNN_TYPES:
            self.snn, self.neuron_type, self.threshold = True, model_type, 1.2
        else:
            self.ann, self.ann_type = True, model_type
        self.__dict__.update(attrs)

    def state_dict(self, *args, **kw):
        return dict(self._sd)


@pytest.mark.parametrize("model_type", SNN_TYPES + ANN_TYPES)
def test_config_from_module_equals_jax(model_type):
    net = StandIn(model_type, {}, batch_size=B, input_size=F,
                  layer_sizes=[H, H, C], dropout=0.1,
                  normalization="layernorm", use_bias=True,
                  bidirectional=model_type != "MLP", use_readout_layer=True)
    want = jax_migrate.config_from_module(net)
    assert migrate.config_from_module(net) == want
    assert want["model_type"] == model_type


def test_string_boolean_overrides():
    sd = reference_state_dict("RadLIF")
    for raw, want in (("false", False), ("0", False), ("no", False),
                      ("True", True), ("on", True)):
        kw = dict(use_readout_layer=raw, bidirectional=raw, remat=raw)
        got = migrate.infer_config_from_state_dict(dict(sd), **kw)
        assert got == jax_migrate.infer_config_from_state_dict(dict(sd), **kw)
        assert got["use_readout_layer"] is want and got["remat"] is want
    cfg = migrate.config_from_module(StandIn(
        "GRU", {}, batch_size=B, input_size=F, layer_sizes=[H, C],
        dropout=0.0, normalization="none", use_bias=False,
        bidirectional=False, use_readout_layer=True))
    assert migrate._apply_overrides(
        dict(cfg, input_shape=list(cfg["input_shape"])),
        {"use_bias": "yes", "batch_size": "7"}) == \
        jax_migrate._apply_overrides(
            dict(cfg, input_shape=list(cfg["input_shape"])),
            {"use_bias": "yes", "batch_size": "7"})
    with pytest.raises(ValueError, match="not a boolean"):
        migrate.infer_config_from_state_dict(sd, use_readout_layer="maybe")


def test_unpickling_names_the_missing_package(tmp_path):
    """A module whose package is not importable gives the actionable
    error; nothing is written."""
    pth = tmp_path / "best_model.pth"
    # a pickle whose class lives in a package that does not exist
    pth.write_bytes(b"\x80\x02csparch_missing.models\nSNN\nq\x00)\x81q\x01.")
    with pytest.raises(ModuleNotFoundError, match="sparch_path"):
        migrate.load_torch_checkpoint(str(pth))
    with pytest.raises(ModuleNotFoundError, match="sparch_path"):
        migrate.import_torch_checkpoint(str(pth), str(tmp_path / "out"),
                                        device="cpu")
    assert not (tmp_path / "out").exists()


FORWARD_CASES = [("LIF", "batchnorm", False, True),
                 ("adLIF", "layernorm", True, False),
                 ("RLIF", "none", False, False),
                 ("RadLIF", "batchnorm", True, True),
                 ("MLP", "batchnorm", False, False),
                 ("RNN", "layernorm", False, True),
                 ("LiGRU", "none", True, False),
                 ("GRU", "batchnorm", False, True)]


@pytest.mark.parametrize("case", FORWARD_CASES, ids=_case_id)
def test_eval_forward_equals_the_jax_scan_model(case):
    """The port's model on the converted weights against the JAX
    ``cell_impl='scan'`` model of the same state dict, zero state init:
    every hidden layer's output (the spikes) bit for bit in the SNNs,
    within rtol 1e-5 in the ANNs; the logits within rtol 1e-5."""
    model_type, norm, bias, bidir = case
    sd = reference_state_dict(model_type, norm, bias, bidir, seed=3)
    cfg = migrate.infer_config_from_state_dict(sd, batch_size=B)
    x = (np.random.default_rng(4).integers(0, 9, (B, T, F)) / 4.0) \
        .astype(np.float32)
    jmodel = jax_model_from_config(cfg, state_init="zeros", cell_impl="scan")
    want, inter = jmodel.apply(
        jax_migrate.variables_from_state_dict(sd, cfg), jnp.asarray(x),
        train=False, capture_intermediates=True, mutable=["intermediates"])
    want = np.asarray(want[0] if isinstance(want, tuple) else want)
    model = build_model_from_config(cfg, state_init="zeros",
                                    cell_impl="scan")
    model.load_state_dict(migrate.state_dict_from_reference(sd, cfg))
    model.eval()
    hidden = []
    hooks = [layer.register_forward_hook(
        lambda mod, args, res: hidden.append(res))
        for layer in model.hidden_layers()]
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    inter = inter["intermediates"]
    for i, got in enumerate(hidden):
        ref = np.asarray(inter[f"layer_{i}"]["__call__"][0])
        ref = ref[0] if ref.ndim == 4 else ref
        if model_type in SNN_TYPES:
            assert 0.0 < float(got.mean()) < 1.0, (i, float(got.mean()))
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(i))
        else:
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-6, err_msg=str(i))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """One reference RadLIF state dict saved as a .pth, imported by both
    packages (zero state init and the scan cells by --set, so that both
    serve deterministic functions and the JAX side runs no interpret-mode
    kernel)."""
    root = tmp_path_factory.mktemp("migrate")
    sd = reference_state_dict("RadLIF", "batchnorm", False, True, seed=5)
    pth = str(root / "sd.pth")
    torch.save(sd, pth)
    overrides = {"batch_size": B, "state_init": "zeros", "cell_impl": "scan"}
    jax_folder, port_folder = str(root / "jax"), str(root / "port")
    jax_migrate.import_torch_checkpoint(pth, jax_folder,
                                        config_overrides=overrides)
    model, state_dict = migrate.import_torch_checkpoint(
        pth, port_folder, config_overrides=overrides, device="cpu")
    x = (np.random.default_rng(6).integers(0, 9, (5, T, F)) / 4.0) \
        .astype(np.float32)
    return dict(root=root, sd=sd, pth=pth, jax=jax_folder,
                port=port_folder, model=model, state_dict=state_dict, x=x)


def _jax_probs(folder, x):
    from sparch_tpu.serve import Predictor as JaxPredictor

    return JaxPredictor.from_experiment(folder, batch_size=B)(x)


def test_imported_folder_serves_as_the_jax_import(imported):
    """The port's folder through ``Predictor.from_experiment`` within 1e-6
    of the JAX import's folder through the JAX ``from_experiment`` (5
    utterances in batches of 3: the last is padded); its meta has the
    keys of the port's training loop."""
    labels, probs = Predictor.from_experiment(
        imported["port"], batch_size=B, device="cpu")(imported["x"])
    want_labels, want_probs = _jax_probs(imported["jax"], imported["x"])
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-6)
    with open(os.path.join(imported["port"], "checkpoints",
                           "meta.json")) as f:
        meta = json.load(f)
    assert tuple(meta["model"]) == migrate.MODEL_RECORD_KEYS
    assert meta["model"]["state_init"] == "zeros"
    assert meta["epoch"] == 0 and meta["imported_from"] == imported["pth"]
    tree = torch.load(os.path.join(imported["port"], "checkpoints",
                                   "best_model", "state.pt"))
    assert tree["step"] == 0 and tree["optimizer"]["state"] == {}
    assert tree["optimizer"]["param_groups"][0]["lr"] == 0.01
    for k, v in imported["state_dict"].items():
        assert torch.equal(tree["model"][k], v), k


def test_jax_experiment_converts_to_a_port_folder(imported, tmp_path):
    """``tools/jax_exp_to_torch.py`` on the JAX import's folder: the same
    probabilities within 1e-6, the weights bit for bit; a folder the port
    cannot build is refused before anything is written."""
    import tools.jax_exp_to_torch as tool

    out = str(tmp_path / "converted")
    tool.main([imported["jax"], out, "--device", "cpu"])
    labels, probs = Predictor.from_experiment(out, batch_size=B,
                                              device="cpu")(imported["x"])
    want_labels, want_probs = _jax_probs(imported["jax"], imported["x"])
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-6)
    tree = torch.load(os.path.join(out, "checkpoints", "best_model",
                                   "state.pt"))
    for k, v in imported["state_dict"].items():
        assert torch.equal(tree["model"][k], v), k
    # a record with a field the port has no model for
    bad = tmp_path / "bad"
    os.makedirs(bad / "checkpoints")
    with open(os.path.join(imported["jax"], "checkpoints", "meta.json")) as f:
        meta = json.load(f)
    meta["model"]["seq_parallel_axis"] = "seq"
    os.symlink(os.path.join(imported["jax"], "checkpoints", "best_model"),
               bad / "checkpoints" / "best_model")
    (bad / "checkpoints" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="cannot build"):
        tool.convert(str(bad), str(tmp_path / "refused"), device="cpu")
    assert not (tmp_path / "refused").exists()


def test_import_tool_writes_the_folder(imported, tmp_path):
    """``tools/import_torch_checkpoint_torch.py`` on the .pth: the module
    API's folder; ``--verify`` refuses a state dict before writing."""
    import tools.import_torch_checkpoint_torch as tool

    out = str(tmp_path / "tool")
    tool.main([imported["pth"], out, "--set", f"batch_size={B}",
               "state_init=zeros", "cell_impl=scan", "--device", "cpu"])
    a = torch.load(os.path.join(out, "checkpoints", "best_model",
                                "state.pt"))
    b = torch.load(os.path.join(imported["port"], "checkpoints",
                                "best_model", "state.pt"))
    assert a["model"].keys() == b["model"].keys()
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    with pytest.raises(SystemExit, match="pickled-module"):
        tool.main([imported["pth"], str(tmp_path / "no"), "--verify",
                   "--device", "cpu"])
    assert not (tmp_path / "no").exists()


def test_verify_holds_the_forward_of_a_module(imported):
    """``--verify``'s check on a module whose forward is the port's own
    model on the same weights (the reference's forward is not in the
    repository): zero apart; a module with other weights fails it."""
    import tools.import_torch_checkpoint_torch as tool

    sd, model = imported["sd"], imported["model"]
    cfg = migrate.infer_config_from_state_dict(sd, batch_size=B)
    port_sd = migrate.state_dict_from_reference(sd, cfg)

    class Module(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x):
            return self.net(x)

    same = build_model_from_config(cfg, state_init="zeros", cell_impl="scan")
    same.load_state_dict(port_sd)
    assert tool.verify(Module(same), cfg, port_sd) == 0.0
    other = {k: v * 0.5 if k.endswith("W.weight") else v
             for k, v in port_sd.items()}
    with pytest.raises(SystemExit, match="VERIFY FAILED"):
        tool.verify(Module(same), cfg, other)
    assert model.training is False


def test_a_device_frontend_record_keeps_its_inner_level(tmp_path):
    """A record with ``frontend: device`` (a JAX ``--frontend device``
    run's) is written around ``FbankFrontend``: the state dict's ``inner.``
    names load, and the folder serves raw waveforms; without that level
    the port refuses the folder before writing it."""
    sd = reference_state_dict("LIF", sizes=(H, C), n_in=40, seed=8)
    cfg = migrate.infer_config_from_state_dict(
        sd, batch_size=B, state_init="zeros", frontend="device")
    port_sd = migrate.state_dict_from_reference(sd, cfg)
    inner = {f"inner.{k}": v for k, v in port_sd.items()}
    migrate.write_experiment(str(tmp_path / "f"), cfg, inner, device="cpu")
    pred = Predictor.from_experiment(str(tmp_path / "f"), batch_size=2,
                                     device="cpu")
    assert pred._waveform
    wave = np.random.default_rng(0).normal(0, 0.1, 8000).astype(np.float32)
    _, probs = pred([wave, wave[:5000], wave])
    assert probs.shape == (3, C) and np.isfinite(probs).all()
    with pytest.raises(ValueError, match="cannot build"):
        migrate.write_experiment(str(tmp_path / "g"), cfg, port_sd,
                                 device="cpu")
    assert not (tmp_path / "g").exists()
