"""The port's tensor-parallel SNN (``cell_impl='pallas_tp'``) on the CPU:
against the JAX SNN, against the port's own scan model, through the
training and eval steps, and its error paths.

The TP model runs in the one-card form (``make_mesh([cpu] * P, model=P)``),
where each CPU tensor takes the plain versions of ``ops.fused_tp``. It is
held to the JAX ``SNN(cell_impl='scan')`` with the same converted variables,
dropout 0 and zero state init (weights and inputs on dyadic grids, as in
tests/test_torch_models.py, so the spike trains must be equal), and to the
port's ``scan`` model with dropout 0.1, a uniform state init and one
generator. Gradients within 5e-5 of each one's largest magnitude, the bound
tests/test_pallas_tp.py holds the JAX TP model to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F_

from sparch_tpu.models.snn import SNN as JaxSNN
from sparch_tpu_torch.convert import variables_from_flax
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.parallel import make_mesh
from sparch_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

from tests.test_torch_models import jax_snn

B, T, F, C = 8, 10, 16, 5
GRAD_ATOL = 5e-5  # of the gradient's largest magnitude
RATE_WEIGHT = 0.1  # the loss also reaches the spikes through the rates


def _mesh(P):
    return make_mesh([torch.device("cpu")] * P, model=P)


def _tp_model(jmodel, variables, P, **kw):
    model = build_model(
        jmodel.neuron_type, jmodel.input_shape, jmodel.layer_sizes,
        normalization=jmodel.normalization, use_bias=jmodel.use_bias,
        bidirectional=jmodel.bidirectional, state_init="zeros",
        cell_impl="pallas_tp", tp_mesh=_mesh(P), **kw)
    model.load_state_dict(variables_from_flax(variables), strict=True)
    return model


def _assert_grads(got, want, what):
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-4)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_ATOL * scale,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("neuron,P,bidirectional", [
    ("RadLIF", 2, False), ("RLIF", 2, False), ("LIF", 2, False),
    ("adLIF", 2, False), ("RadLIF", 4, True)])
def test_tp_model_matches_jax_scan(neuron, P, bidirectional):
    """Eval forward bit for bit in the spikes, then the train-mode loss and
    every parameter gradient against ``jax.grad`` of the JAX scan model."""
    H = 128 * P
    jmodel, variables, x = jax_snn(neuron, "scan", bidirectional=bidirectional,
                                   shape=(B, T, F), sizes=(H, H, C))
    model = _tp_model(jmodel, variables, P).eval()
    want_out, want_rates = jmodel.apply(variables, jnp.asarray(x),
                                        train=False)
    with torch.no_grad():
        out, rates = model(torch.from_numpy(x))
    want_rates = np.asarray(want_rates)
    assert 0.01 < want_rates.mean() < 0.5  # the layers really spike
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(np.rint(rates.numpy() * B * T),
                                  np.rint(want_rates * B * T))

    y = np.random.default_rng(1).integers(0, C, B)

    def loss_fn(params):
        (o, r), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            o, jnp.asarray(y)).mean()
        return ce + RATE_WEIGHT * jnp.sum(r)

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    want = variables_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    model.train()
    o, r = model(torch.from_numpy(x))
    loss = F_.cross_entropy(o, torch.from_numpy(y)) + RATE_WEIGHT * r.sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    _assert_grads(got, {k: v.numpy() for k, v in want.items()},
                  f"{neuron} P={P}")


def _port_pair(neuron, P, dropout):
    """(scan model, pallas_tp model) of one state dict."""
    kw = dict(dropout=dropout, bidirectional=True, state_init="uniform",
              generator=torch.Generator().manual_seed(0))
    H = 128 * P
    scan = build_model(neuron, (B, T, F), [H, H, C], cell_impl="scan", **kw)
    with torch.no_grad():  # V on the 2^-8 grid: s @ V exact in any order
        for layer in scan.hidden_layers():
            if hasattr(layer, "V"):
                layer.V.copy_(torch.round(layer.V * 256.0) / 256.0)
    tp = build_model(neuron, (B, T, F), [H, H, C], cell_impl="pallas_tp",
                     tp_mesh=_mesh(P), **kw)
    tp.load_state_dict(scan.state_dict(), strict=True)
    return scan, tp


@pytest.mark.parametrize("neuron", ["RadLIF", "RLIF"])
def test_tp_trains_and_evaluates_as_the_port_scan(neuron):
    """Two ``make_train_step`` steps and one ``make_eval_step`` of the TP
    model against the port's scan model from one state dict and one seed,
    dropout 0.1 and uniform states drawn from the run's generator: the
    first products of a uniform s0 sum in other orders on the two paths,
    so losses within 1e-5 relative and gradients within the bound."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.integers(0, 5, (B, T, F)) / 4.0).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, C, B))
    runs = {}
    for model in _port_pair(neuron, 2, 0.1):
        state = create_train_state(model, 1e-2, device="cpu", seed=0)
        step, eval_step = make_train_step(model), make_eval_step(model)
        mets, grads = [], None
        for i in range(2):
            state, met = step(state, x, y)
            mets.append(met)
            if i == 0:
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
        ev = eval_step(state, x, y, torch.Generator().manual_seed(3))
        runs[model.cell_impl] = mets, grads, ev
    (s_mets, s_grads, s_ev), (t_mets, t_grads, t_ev) = runs["scan"], \
        runs["pallas_tp"]
    for sm, tm in zip(s_mets, t_mets):
        np.testing.assert_allclose(float(tm["loss"]), float(sm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["spike_rate"]),
                                   float(sm["spike_rate"]), rtol=1e-5)
    _assert_grads({k: v.numpy() for k, v in t_grads.items()},
                  {k: v.numpy() for k, v in s_grads.items()},
                  f"{neuron} pallas_tp vs scan")
    for k in ("loss", "acc", "spike_rate"):
        np.testing.assert_allclose(float(t_ev[k]), float(s_ev[k]), rtol=1e-5)


def test_tp_model_has_the_scan_variable_tree():
    """The JAX TP model is initialised through its scan twin (the training
    loop does so), and its variable tree is the scan model's: the converter
    needs no TP rule, and loads it strictly into the port's TP model."""
    from jax.sharding import Mesh as JaxMesh

    kw = dict(input_shape=(B, T, F), layer_sizes=[256, C],
              neuron_type="RadLIF", normalization="batchnorm",
              bidirectional=True)
    x = jnp.zeros((B, T, F))
    rngs = {"params": jax.random.PRNGKey(0), "state": jax.random.PRNGKey(1)}
    scan_vars = JaxSNN(cell_impl="scan", **kw).init(rngs, x, train=False)
    jmesh = JaxMesh(np.array(jax.devices()[:2]), ("model",))
    tp_shapes = jax.eval_shape(
        lambda: JaxSNN(cell_impl="pallas_tp", tp_mesh=jmesh,
                       tp_batch_axis=None, **kw).init(rngs, x, train=False))
    assert jax.tree_util.tree_structure(tp_shapes) == \
        jax.tree_util.tree_structure(scan_vars)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape, tp_shapes, scan_vars))
    model = build_model("RadLIF", (B, T, F), [256, C], bidirectional=True,
                        cell_impl="pallas_tp", tp_mesh=_mesh(2))
    model.load_state_dict(variables_from_flax(
        jax.tree_util.tree_map(np.asarray, scan_vars)), strict=True)


def test_tp_model_error_paths():
    x = torch.ones(B, T, F)
    # no mesh: raises when it runs, as the JAX layer does
    with pytest.raises(ValueError, match="tp_mesh"):
        build_model("RLIF", (B, T, F), [256, C], cell_impl="pallas_tp")(x)
    # H % (P*128)
    with pytest.raises(ValueError, match="divisible by num_model_devices"):
        build_model("RadLIF", (B, T, F), [384, C], cell_impl="pallas_tp",
                    tp_mesh=_mesh(2))(x)
    # any number of rows (the TPU kernels wanted a multiple of 8): B = 6
    # gives the scan model's output
    x6 = torch.rand(6, T, F, generator=torch.Generator().manual_seed(1))
    tp6 = build_model("RadLIF", (6, T, F), [256, C], cell_impl="pallas_tp",
                      tp_mesh=_mesh(2)).eval()
    scan6 = build_model("RadLIF", (6, T, F), [256, C],
                        cell_impl="scan").eval()
    scan6.load_state_dict(tp6.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(
            tp6(x6, torch.Generator().manual_seed(2))[0],
            scan6(x6, torch.Generator().manual_seed(2))[0],
            rtol=1e-5, atol=1e-6)
    # the TP kernels' bf16 form runs
    out, _ = build_model("RadLIF", (B, T, F), [256, C],
                         cell_impl="pallas_tp", tp_mesh=_mesh(2),
                         compute_dtype=torch.bfloat16)(x)
    assert out.shape == (B, C) and bool(torch.isfinite(out).all())
    # a mesh without the named axis
    with pytest.raises(ValueError, match="no axis 'tp'"):
        build_model("RLIF", (B, T, F), [256, C], cell_impl="pallas_tp",
                    tp_mesh=_mesh(2), tp_axis="tp")(x)
    # the non-spiking family takes the TP path too (ops/fused_tp_ann.py),
    # in either stream mode
    model = build_model("GRU", (B, T, F), [256, C], cell_impl="pallas_tp",
                        tp_mesh=_mesh(2))
    assert model(x)[0].shape == (B, C)
    out, _ = build_model("GRU", (B, T, F), [256, C], cell_impl="pallas_tp",
                         tp_mesh=_mesh(2), compute_dtype=torch.bfloat16)(x)
    assert out.shape == (B, C) and bool(torch.isfinite(out).all())
