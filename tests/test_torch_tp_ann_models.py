"""The port's tensor-parallel ANN (``cell_impl='pallas_tp'`` for RNN, LiGRU,
GRU) on the CPU: against the JAX ANN, against the port's own scan model,
through the training and eval steps, and its error paths.

The TP model runs in the one-card form (``make_mesh([cpu] * P, model=P)``),
where each CPU tensor takes the plain versions of ``ops.fused_tp_ann``. It
is held to the JAX ``ANN(cell_impl='scan')`` with the same converted
variables and dropout 0 (the two frameworks draw other masks), at the
bounds tests/test_pallas_tp_ann.py holds the JAX TP model to: train-mode
logits within 3e-4, the running statistics within 2e-5, every parameter
gradient within 5e-5 of its largest magnitude; eval logits as
tests/test_torch_ann_models.py holds the port's scan model (rtol 1e-5).
Against the port's scan model the dropout is 0.1, drawn from one generator
on both paths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F_

from sparch_tpu.models.ann import ANN as JaxANN
from sparch_tpu_torch.convert import variables_from_flax, variables_to_flax
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.parallel import make_mesh
from sparch_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

from tests.test_torch_ann_models import jax_ann
from tests.test_torch_models import _leaves

B, T, F, C = 8, 10, 16, 5
GRAD_ATOL = 5e-5  # of the gradient's largest magnitude


def _mesh(P):
    return make_mesh([torch.device("cpu")] * P, model=P)


@pytest.mark.parametrize("ann_type,P,bidirectional", [
    ("GRU", 2, False), ("LiGRU", 2, True)])
def test_tp_ann_matches_jax_scan(ann_type, P, bidirectional):
    H = 128 * P
    jmodel, variables, x = jax_ann(ann_type, "scan",
                                   bidirectional=bidirectional,
                                   shape=(B, T, F), sizes=(H, H, C))
    model = build_model(ann_type, (B, T, F), [H, H, C],
                        bidirectional=bidirectional, cell_impl="pallas_tp",
                        tp_mesh=_mesh(P))
    model.load_state_dict(variables_from_flax(variables), strict=True)
    want, _ = jmodel.apply(variables, jnp.asarray(x), train=False)
    model.eval()
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)

    y = np.random.default_rng(1).integers(0, C, B)

    def loss_fn(params):
        (o, _), mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            o, jnp.asarray(y)).mean()
        return ce, (o, mut["batch_stats"])

    (want_loss, (want_out, want_stats)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    model.train()
    o, _ = model(torch.from_numpy(x))
    loss = F_.cross_entropy(o, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=3e-4)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    stats = dict(_leaves(variables_to_flax(model.state_dict())["batch_stats"]))
    for path, stat in _leaves(jax.tree_util.tree_map(np.asarray, want_stats)):
        np.testing.assert_allclose(stats[path], stat, rtol=0, atol=2e-5,
                                   err_msg="/".join(path))
    want = variables_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-4)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_ATOL * scale,
                                   err_msg=f"{ann_type} P={P}: {k}")


@pytest.mark.parametrize("ann_type,P", [("GRU", 2), ("RNN", 4)])
def test_tp_ann_trains_and_evaluates_as_the_port_scan(ann_type, P):
    """Two ``make_train_step`` steps and one ``make_eval_step`` of the TP
    model against the port's scan model from one state dict and one seed,
    dropout 0.1 from the run's generator on both: losses within 1e-5
    relative, step-1 gradients within the bound."""
    H = 128 * P
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (B, T, F)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, B))
    kw = dict(dropout=0.1, generator=torch.Generator().manual_seed(0))
    scan = build_model(ann_type, (B, T, F), [H, H, C], cell_impl="scan",
                       **kw)
    tp = build_model(ann_type, (B, T, F), [H, H, C], cell_impl="pallas_tp",
                     tp_mesh=_mesh(P), **kw)
    tp.load_state_dict(scan.state_dict(), strict=True)
    runs = {}
    for model in (scan, tp):
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
    for k, w in s_grads.items():
        scale = max(float(w.abs().max()), 1e-4)
        np.testing.assert_allclose(t_grads[k].numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=k)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(t_ev[k]), float(s_ev[k]), rtol=1e-5)


def test_tp_ann_has_the_scan_variable_tree():
    """The JAX TP ANN keeps the scan ANN's variable tree (the same
    ``self._V`` names): the converter carries it across as it is and loads
    it strictly into the port's TP model."""
    kw = dict(input_shape=(B, T, F), layer_sizes=[256, C], ann_type="GRU",
              normalization="batchnorm", bidirectional=True)
    x = jnp.zeros((B, T, F))
    rngs = {"params": jax.random.PRNGKey(0)}
    scan_vars = JaxANN(cell_impl="scan", **kw).init(rngs, x, train=False)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("model",))
    tp_shapes = jax.eval_shape(
        lambda: JaxANN(cell_impl="pallas_tp", tp_mesh=jmesh,
                       tp_batch_axis=None, **kw).init(rngs, x, train=False))
    assert jax.tree_util.tree_structure(tp_shapes) == \
        jax.tree_util.tree_structure(scan_vars)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape, tp_shapes, scan_vars))
    model = build_model("GRU", (B, T, F), [256, C], bidirectional=True,
                        cell_impl="pallas_tp", tp_mesh=_mesh(2))
    model.load_state_dict(variables_from_flax(
        jax.tree_util.tree_map(np.asarray, scan_vars)), strict=True)


def test_tp_ann_error_paths():
    x = torch.ones(B, T, F)
    # no mesh: raises when it runs, as the JAX layer does
    with pytest.raises(ValueError, match="tp_mesh"):
        build_model("LiGRU", (B, T, F), [256, C], cell_impl="pallas_tp")(x)
    # the TP kernels' bf16 form runs
    out, _ = build_model("RNN", (B, T, F), [256, C], cell_impl="pallas_tp",
                         tp_mesh=_mesh(2), compute_dtype=torch.bfloat16)(x)
    assert out.shape == (B, C) and bool(torch.isfinite(out).all())
    # H % (P*128)
    with pytest.raises(ValueError, match="divisible by num_model_devices"):
        build_model("GRU", (B, T, F), [384, C], cell_impl="pallas_tp",
                    tp_mesh=_mesh(2))(x)
    # any number of rows (the TPU kernels wanted a multiple of 8): B = 6
    # gives the scan model's output
    x6 = torch.rand(6, T, F, generator=torch.Generator().manual_seed(1))
    tp6 = build_model("GRU", (6, T, F), [256, C], cell_impl="pallas_tp",
                      tp_mesh=_mesh(2)).eval()
    scan6 = build_model("GRU", (6, T, F), [256, C], cell_impl="scan").eval()
    scan6.load_state_dict(tp6.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(tp6(x6)[0], scan6(x6)[0], rtol=1e-5,
                                   atol=1e-6)
