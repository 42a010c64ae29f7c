"""The port's SNN (sparch_tpu_torch.models) against the JAX SNN on the CPU,
with the weights carried across by convert.variables_from_flax.

Inputs and weights sit on dyadic grids (inputs in quarters, projection and
recurrent weights in multiples of 2^-8), so every matmul is exact in any
summation order; what is left to differ is elementwise rounding. Logits
agree to rtol 1e-5 and the spike counts of every neuron are equal."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.models import build_model as jax_build_model
from sparch_tpu_torch.convert import variables_from_flax
from sparch_tpu_torch.models import (
    MODEL_TYPES,
    SNN,
    build_model,
    build_model_from_config,
)

B, T, F, H, C = 9, 13, 16, 40, 5


def _dyadic(a, step=2.0**-8):
    return (np.round(np.asarray(a) / step) * step).astype(np.float32)


def jax_snn(neuron_type="RadLIF", cell_impl="scan", normalization="batchnorm",
            use_bias=False, bidirectional=False, seed=0, shape=(B, T, F),
            sizes=(H, H, C)):
    """(JAX model, numpy variable tree with non-trivial running stats,
    input x) for a small SNN; weights on a dyadic grid, norm gains of 4 and
    positive norm biases so that every layer spikes."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 5, shape) / 4.0).astype(np.float32)
    model = jax_build_model(
        neuron_type, shape, list(sizes), normalization=normalization,
        use_bias=use_bias, bidirectional=bidirectional, state_init="zeros",
        cell_impl=cell_impl,
    )
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = variables["params"]
    for layer in params.values():
        layer["W"]["kernel"] = _dyadic(layer["W"]["kernel"])
        if "V" in layer:
            layer["V"] = _dyadic(layer["V"])
        for norm in layer.get("norm", {}).values():
            norm["scale"] = np.full_like(norm["scale"], 4.0)
            norm["bias"] = _dyadic(
                rng.uniform(0.5, 1.0, norm["bias"].shape), 2.0**-4
            )
    if normalization == "batchnorm":
        x_stats = (rng.integers(0, 5, shape) / 4.0).astype(np.float32)
        _, mut = model.apply(variables, jnp.asarray(x_stats), train=True,
                             mutable=["batch_stats"])
        variables["batch_stats"] = jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"]
        )
    return model, variables, x


def port_snn(jmodel, variables, cell_impl):
    model = build_model(
        jmodel.neuron_type, jmodel.input_shape, jmodel.layer_sizes,
        normalization=jmodel.normalization, use_bias=jmodel.use_bias,
        bidirectional=jmodel.bidirectional, state_init="zeros",
        cell_impl=cell_impl,
    )
    model.load_state_dict(variables_from_flax(variables), strict=True)
    return model.eval()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("normalization", ["batchnorm", "layernorm"])
def test_converter_round_trips_every_leaf(use_bias, normalization):
    jmodel, variables, _ = jax_snn(normalization=normalization,
                                   use_bias=use_bias)
    model = port_snn(jmodel, variables, "scan")
    sd = model.state_dict()
    converted = variables_from_flax(variables)
    assert set(converted) == set(sd)
    n = 0
    for path, leaf in _leaves(variables):
        coll, mod, *rest = path
        if coll == "batch_stats":
            key = f"{mod}.norm.running_{rest[-1]}"
            want = leaf
        elif rest == ["W", "kernel"]:
            key, want = f"{mod}.W.weight", leaf.T
        elif rest == ["W", "bias"]:
            key, want = f"{mod}.W.bias", leaf
        elif rest[0] == "norm":
            key = f"{mod}.norm.{'weight' if rest[-1] == 'scale' else 'bias'}"
            want = leaf
        else:
            key, want = f"{mod}.{rest[0]}", leaf
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
        n += 1
    assert n == len(sd)


def test_converter_is_strict():
    jmodel, variables, _ = jax_snn()
    model = port_snn(jmodel, variables, "scan")
    # a flax leaf with no port tensor raises in the converter
    extra = {**variables,
             "params": {**variables["params"], "mystery": {"w": np.ones(2)}}}
    with pytest.raises(KeyError, match="mystery"):
        variables_from_flax(extra)
    # a port tensor that no leaf sets raises when loading
    params = {k: dict(v) for k, v in variables["params"].items()}
    del params["layer_1"]["alpha"]
    missing = variables_from_flax({**variables, "params": params})
    with pytest.raises(RuntimeError, match="layer_1.alpha"):
        model.load_state_dict(missing, strict=True)


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
@pytest.mark.parametrize(
    "neuron_type,bidirectional",
    [("RadLIF", False), ("LIF", False), ("RadLIF", True)],
)
def test_snn_matches_jax(neuron_type, bidirectional, cell_impl):
    """Eval forward, same cell_impl on both sides ('pallas' runs the JAX
    kernel in interpret mode and the port's plain fused version)."""
    jmodel, variables, x = jax_snn(neuron_type, cell_impl,
                                   bidirectional=bidirectional)
    want_out, want_rates = jmodel.apply(variables, jnp.asarray(x),
                                        train=False)
    model = port_snn(jmodel, variables, cell_impl)
    with torch.no_grad():
        out, rates = model(torch.from_numpy(x))
    want_rates = np.asarray(want_rates)
    assert want_rates.mean() > 0.01  # the layers really spike
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=1e-6)
    # equal spike counts per neuron (the means differ only in summation
    # order)
    np.testing.assert_array_equal(np.rint(rates.numpy() * B * T),
                                  np.rint(want_rates * B * T))


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
def test_train_mode_running_stats_match_flax(cell_impl):
    """One train-mode pass updates the running statistics as flax does,
    through the applied norm ('scan') and the kernel's affine fold
    ('pallas')."""
    jmodel, variables, x = jax_snn(cell_impl=cell_impl)
    model = port_snn(jmodel, variables, cell_impl)
    _, mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x))
    for name, st in mut["batch_stats"].items():
        bn = st["norm"]["BatchNorm_0"]
        norm = getattr(model, name).norm
        np.testing.assert_allclose(norm.running_mean.numpy(),
                                   np.asarray(bn["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(norm.running_var.numpy(),
                                   np.asarray(bn["var"]), rtol=1e-5,
                                   atol=1e-6)


def test_fused_policy():
    model = SNN((2, 3, 4), [8, 3], "RadLIF", cell_impl="auto")
    x = torch.zeros(2, 3, 4)
    assert not model.layer_0._use_fused(x)  # CPU tensor: plain scan
    model.layer_0.cell_impl = "pallas"
    assert model.layer_0._use_fused(x)
    model.layer_0.cell_impl = "scan"
    assert not model.layer_0._use_fused(x)
    # on the card 'auto' takes the kernel at every width: past the
    # kernel's own limit the wrapper raises, no plain loop runs there
    model.layer_0.cell_impl = "auto"
    model.layer_0.hidden_size = 8192
    assert model.layer_0._use_fused(SimpleNamespace(is_cuda=True))


def test_unported_options_raise():
    # the non-spiking family is ported: the registry builds it
    assert not build_model("GRU", (2, 3, 4), [8, 3]).is_snn
    # remat and compute_dtype=bfloat16 are ported: every model type builds
    # with both and runs a train-mode forward and a backward
    for model_type in MODEL_TYPES:
        model = build_model(model_type, (2, 3, 4), [8, 8, 3], remat=True,
                            compute_dtype=torch.bfloat16, cell_impl="pallas",
                            dropout=0.5).train()
        out, _ = model(torch.ones(2, 3, 4), torch.Generator().manual_seed(0))
        out.float().sum().backward()
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in model.parameters()), model_type
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model("RadLIF", (2, 3, 4), [8, 3], compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="mxu_precision"):
        build_model("GRU", (2, 3, 4), [8, 3], mxu_precision="low")
    # cell_impl='pallas_tp' is ported for the spiking family: it needs a
    # mesh and says so when it runs without one
    with pytest.raises(ValueError, match="tp_mesh"):
        build_model("RadLIF", (8, 3, 4), [128, 3],
                    cell_impl="pallas_tp")(torch.ones(8, 3, 4))
    # the fused dropout is ported: a train-mode forward runs and drops
    model = build_model("RadLIF", (2, 3, 4), [8, 3], cell_impl="pallas",
                        dropout=0.5).train()
    out, _ = model(torch.ones(2, 3, 4), torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()


def test_build_model_from_config_and_generator_init():
    cfg = {"model_type": "RadLIF", "input_shape": [2, 3, 4],
           "layer_sizes": [8, 3], "normalization": "batchnorm",
           "use_bias": True, "bidirectional": False,
           "cell_impl": "pallas_tp", "state_init": "zeros"}
    model = build_model_from_config(cfg)
    assert model.cell_impl == "auto" and model.layer_0.W.bias is not None
    a = SNN((2, 3, 4), [8, 3], "RadLIF", generator=torch.Generator()
            .manual_seed(7))
    b = SNN((2, 3, 4), [8, 3], "RadLIF", generator=torch.Generator()
            .manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    V = a.layer_0.V.detach()
    torch.testing.assert_close(V @ V.t(), torch.eye(8), atol=1e-5, rtol=0)
