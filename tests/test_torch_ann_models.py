"""The port's ANN family (sparch_tpu_torch.models.ann: MLP, RNN, LiGRU, GRU)
against the JAX ANN on the CPU, with the weights carried across by
``convert.variables_from_flax``.

Weights and inputs come from seeds; the norm gains and biases are moved off
1 and 0 and the running statistics come from one train-mode pass, so that
nothing is trivially equal. ``cell_impl="pallas"`` runs the JAX kernels in
interpret mode and the port's plain fused versions; ``"scan"`` the plain
loops on both sides. Eval logits agree to rtol 1e-5 (atol 2e-6 for logits
near 0) and the running statistics that a train-mode pass leaves behind to
rtol 1e-4 / atol 1e-5. Train-mode logits agree to atol 2e-4: the readout's
batchnorm divides by the standard deviation of 8 rows, which carries a
rounding difference of 1e-6 in a layer's output up to 1.5e-4 between the
JAX package's own kernel and scan paths on these inputs."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.models import build_model as jax_build_model
from sparch_tpu_torch.convert import variables_from_flax, variables_to_flax
from sparch_tpu_torch.models import (
    ANN,
    ANN_TYPES,
    MODEL_TYPES,
    SNN,
    build_model,
    build_model_from_config,
)
from sparch_tpu_torch.parallel import make_mesh

from tests.test_torch_models import _leaves

B, T, F, H, C = 8, 13, 12, 24, 5
CASES = [("MLP", False), ("RNN", False), ("LiGRU", False), ("GRU", False),
         ("LiGRU", True)]


def jax_ann(ann_type="GRU", cell_impl="scan", normalization="batchnorm",
            use_bias=False, bidirectional=False, dropout=0.0, seed=0,
            shape=(B, T, F), sizes=(H, H, C)):
    """(JAX model, numpy variable tree, input x) for a small ANN: norm gains
    and biases off their defaults, running statistics from one train-mode
    pass on other data."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    model = jax_build_model(
        ann_type, shape, list(sizes), normalization=normalization,
        use_bias=use_bias, bidirectional=bidirectional, dropout=dropout,
        cell_impl=cell_impl,
    )
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.array, variables)
    for layer in variables["params"].values():
        for name, sub in layer.items():
            if not name.startswith("norm"):
                continue
            for norm in sub.values():
                norm["scale"] = rng.uniform(0.8, 1.5, norm["scale"].shape) \
                    .astype(np.float32)
                norm["bias"] = rng.normal(0, 0.2, norm["bias"].shape) \
                    .astype(np.float32)
    if normalization == "batchnorm":
        x_stats = rng.normal(0.3, 1.2, shape).astype(np.float32)
        _, mut = model.apply(variables, jnp.asarray(x_stats), train=True,
                             rngs={"dropout": jax.random.PRNGKey(seed + 1)},
                             mutable=["batch_stats"])
        variables["batch_stats"] = jax.tree_util.tree_map(
            np.array, mut["batch_stats"])
    return model, variables, x


def port_ann(jmodel, variables, cell_impl, **kw):
    model = build_model(
        jmodel.ann_type, jmodel.input_shape, jmodel.layer_sizes,
        normalization=jmodel.normalization, use_bias=jmodel.use_bias,
        bidirectional=jmodel.bidirectional, dropout=jmodel.dropout,
        cell_impl=cell_impl, **kw,
    )
    model.load_state_dict(variables_from_flax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
@pytest.mark.parametrize("ann_type,bidirectional", CASES)
def test_ann_matches_jax(ann_type, bidirectional, cell_impl):
    """Eval logits; then one train-mode pass: its logits and the running
    statistics it leaves behind."""
    jmodel, variables, x = jax_ann(ann_type, cell_impl,
                                   bidirectional=bidirectional)
    want, none = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = port_ann(jmodel, variables, cell_impl)
    with torch.no_grad():
        out, rates = model(torch.from_numpy(x))
    assert rates is None and none is None and out.shape == (B, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)
    assert np.asarray(want).std() > 0.1  # logits that tell classes apart

    (want, _), mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-4)
    got = variables_to_flax(model.state_dict())["batch_stats"]
    paths = dict(_leaves(got))
    n = 0
    for path, stat in _leaves(jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"])):
        np.testing.assert_allclose(paths[path], stat, rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(path))
        n += 1
    gates = {"MLP": 1, "RNN": 1, "LiGRU": 2, "GRU": 3}[ann_type]
    assert n == len(paths) == 2 * (2 * gates + 1)


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
def test_layernorm_and_bias_match_jax(cell_impl):
    """layernorm is applied to the streams on either path (no affine goes
    into the cell), and the projections carry a bias."""
    jmodel, variables, x = jax_ann("GRU", cell_impl, "layernorm",
                                   use_bias=True)
    assert "batch_stats" not in variables
    want, _ = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = port_ann(jmodel, variables, cell_impl)
    assert model.layer_0.Wz.bias is not None
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


def test_no_normalization_and_no_readout_match_jax():
    jmodel, variables, x = jax_ann("LiGRU", "pallas", "none",
                                   sizes=(H, H))
    jmodel = jmodel.clone(use_readout_layer=False)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    want, _ = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = build_model("LiGRU", (B, T, F), [H, H], normalization="none",
                        use_readout_layer=False, cell_impl="pallas")
    model.load_state_dict(variables_from_flax(variables), strict=True)
    with torch.no_grad():
        out, _ = model.eval()(torch.from_numpy(x))
    assert out.shape == (B, T, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("normalization", ["batchnorm", "layernorm"])
@pytest.mark.parametrize("ann_type", ANN_TYPES)
def test_ann_converter_round_trips(ann_type, normalization):
    """flax -> port names every tensor of the model and nothing else;
    port -> flax gives the tree back, leaf for leaf."""
    jmodel, variables, _ = jax_ann(ann_type, normalization=normalization,
                                   use_bias=True)
    sd = variables_from_flax(variables)
    model = port_ann(jmodel, variables, "scan")
    assert set(sd) == set(model.state_dict())
    back = variables_to_flax(sd)
    want, got = dict(_leaves(variables)), dict(_leaves(back))
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg="/".join(path))
    # a projection is stored transposed, a recurrent matrix as it is
    np.testing.assert_array_equal(
        sd["layer_0.W.weight"].numpy(),
        variables["params"]["layer_0"]["W"]["kernel"].T)
    if ann_type != "MLP":
        np.testing.assert_array_equal(sd["layer_1.V"].numpy(),
                                      variables["params"]["layer_1"]["V"])


def test_ann_converter_is_strict():
    jmodel, variables, _ = jax_ann("GRU")
    layer = dict(variables["params"]["layer_0"])
    layer["Wq"] = {"kernel": np.ones((2, 2), np.float32)}
    extra = {**variables, "params": {**variables["params"],
                                     "layer_0": layer}}
    with pytest.raises(KeyError, match="Wq"):
        variables_from_flax(extra)
    with pytest.raises(KeyError, match="norm_Wq"):
        variables_to_flax({"layer_0.norm_Wq.weight": torch.ones(2)})
    params = {k: dict(v) for k, v in variables["params"].items()}
    del params["layer_1"]["Vr"]
    model = port_ann(jmodel, variables, "scan")
    with pytest.raises(RuntimeError, match="layer_1.Vr"):
        model.load_state_dict(
            variables_from_flax({**variables, "params": params}),
            strict=True)


def test_build_model_builds_all_eight_types():
    assert len(MODEL_TYPES) == 8 and set(ANN_TYPES) < set(MODEL_TYPES)
    for model_type in MODEL_TYPES:
        # an ANN drops the spiking options, as the JAX registry does
        model = build_model(model_type, (2, 3, 4), [8, 8, 3],
                            state_init="zeros", threshold=1.0)
        assert isinstance(model, ANN if model_type in ANN_TYPES else SNN)
        assert model.is_snn == (model_type not in ANN_TYPES)
        out, _ = model.eval()(torch.zeros(2, 3, 4))
        assert out.shape == (2, 3)
    cfg = {"model_type": "GRU", "input_shape": [2, 3, 4],
           "layer_sizes": [8, 3], "normalization": "layernorm",
           "use_bias": True, "bidirectional": True, "dropout": 0.2,
           "cell_impl": "pallas_tp", "state_init": "uniform",
           "threshold": 1.0}
    model = build_model_from_config(cfg)
    assert model.ann_type == "GRU" and model.cell_impl == "auto"
    assert model.layer_0.dropout == 0.2 and model.layer_0.bidirectional
    assert model.readout.W.weight.shape == (3, 16)
    with pytest.raises(ValueError, match="Invalid model type"):
        build_model("LSTM", (2, 3, 4), [8, 3])


def test_ann_options():
    with pytest.raises(ValueError, match="bidirectional"):
        build_model("MLP", (2, 3, 4), [8, 3], bidirectional=True)
    with pytest.raises(ValueError, match="nb_layers"):
        build_model("RNN", (2, 3, 4), [3])
    # remat and compute_dtype=bfloat16 are ported: the model builds, keeps
    # its parameters float32 and runs
    model = build_model("GRU", (2, 3, 4), [8, 3], remat=True,
                        compute_dtype=torch.bfloat16)
    assert model.remat and model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model(torch.zeros(2, 3, 4))[0].dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model("GRU", (2, 3, 4), [8, 3], compute_dtype=torch.float16)
    # the tensor-parallel path is ported: it needs a mesh when it runs, and
    # its bf16 form runs
    with pytest.raises(ValueError, match="tp_mesh"):
        build_model("GRU", (8, 3, 4), [256, 3], cell_impl="pallas_tp")(
            torch.zeros(8, 3, 4))
    model = build_model("GRU", (8, 3, 4), [256, 3], cell_impl="pallas_tp",
                        compute_dtype=torch.bfloat16,
                        tp_mesh=make_mesh([torch.device("cpu")] * 2, model=2))
    assert model(torch.zeros(8, 3, 4))[0].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="rank"):
        build_model("GRU", (2, 3, 4), [8, 3])(torch.zeros(2, 3))
    model = build_model("LiGRU", (2, 3, 2, 2), [8, 3], cell_impl="nope")
    with pytest.raises(ValueError, match="cell_impl"):
        model(torch.zeros(2, 3, 2, 2))
    # 4-D input is flattened; one seed gives one set of weights; V is
    # orthogonal with its diagonal kept
    a = ANN((2, 3, 2, 2), [8, 3], "GRU",
            generator=torch.Generator().manual_seed(7))
    b = ANN((2, 3, 2, 2), [8, 3], "GRU",
            generator=torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a(torch.ones(2, 3, 2, 2))[0].shape == (2, 3)
    for V in (a.layer_0.V, a.layer_0.Vz, a.layer_0.Vr):
        torch.testing.assert_close(V @ V.t(), torch.eye(8), atol=1e-5,
                                   rtol=0)
        assert float(torch.diagonal(V.detach()).abs().max()) > 0
    assert not torch.equal(a.layer_0.V, a.layer_0.Vz)


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
def test_ann_dropout_in_train_mode_only(cell_impl):
    model = build_model("GRU", (B, T, F), [H, H], dropout=0.5,
                        use_readout_layer=False, cell_impl=cell_impl)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, T, F)).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        dropped, _ = model.train()(x, gen)
        again, _ = model(x, torch.Generator().manual_seed(3))
        served, _ = model.eval()(x, gen)
    assert torch.equal(dropped, again)
    assert 0.4 < float((dropped == 0).float().mean()) < 0.6
    assert not (served == 0).any()


def test_port_imports_without_jax():
    """Every module of the port imports with jax, flax and the JAX package
    blocked."""
    import importlib
    import pkgutil

    import sparch_tpu_torch

    blocked = ("jax", "flax", "sparch_tpu", "optax")
    saved = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] in blocked + ("sparch_tpu_torch",)}
    try:
        for k in saved:
            del sys.modules[k]
        for k in blocked:
            sys.modules[k] = None  # import of a blocked name raises
        names = ["sparch_tpu_torch"] + [
            m.name for m in pkgutil.walk_packages(
                sparch_tpu_torch.__path__, "sparch_tpu_torch.")]
        assert {"sparch_tpu_torch.ops.fused_ann",
                "sparch_tpu_torch.models.ann",
                "sparch_tpu_torch.serve.streaming"} <= set(names)
        for name in names:
            importlib.import_module(name)
        with pytest.raises(ImportError):
            importlib.import_module("jax")
    finally:
        for k in [k for k in sys.modules
                  if k.split(".")[0] in blocked + ("sparch_tpu_torch",)]:
            del sys.modules[k]
        sys.modules.update(saved)
