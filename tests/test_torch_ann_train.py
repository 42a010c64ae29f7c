"""Training the ANN family in the port (sparch_tpu_torch.train) against
sparch_tpu.train on the CPU: three steps of ``make_train_step`` in both
packages from the same weights on the same batches, for a GRU and a LiGRU
[16, 16, 5] with batchnorm and dropout 0.1, ``cell_impl="pallas"`` (the JAX
kernels in interpret mode, the port's plain versions through its
``autograd.Function``).

The dropout masks are equal because both kernels hash (seed, batch tile,
row, column, step) alike: the seeds that the JAX step will draw for each
layer are read off a forward with the step's own dropout key and handed to
the port in place of its generator's draws. Tolerances: first-step
gradients atol 3e-5 / rtol 1e-4 (the gradient tests' own); logged loss rtol
1e-5; parameters after each update atol 2e-5 at lr 1e-2, leaving out
entries whose JAX gradient is nonzero but below 1e-6 at some step, where
Adam's division by |g| + 1e-8 makes the update a function of rounding; no
tensor is left out."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparch_tpu.models import common as jax_common
from sparch_tpu.train import make_eval_step as jax_make_eval_step
from sparch_tpu.train import make_train_step as jax_make_train_step
from sparch_tpu.train.state import TrainState as JaxTrainState
from sparch_tpu.train.state import adam_with_injectable_lr
from sparch_tpu_torch.convert import variables_from_flax
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.models.common import FusedCellPolicy
from sparch_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

from tests.test_torch_ann_models import jax_ann
from tests.test_torch_models import _leaves
from tests.test_torch_train import _port_tree

B, T, F, H, C = 8, 12, 12, 16, 5
LR = 1e-2
STEPS = 3
DROPOUT = 0.1
SMALL_GRAD = 1e-6
PARAM_ATOL = 2e-5


def _pair(ann_type, cell_impl="pallas", dropout=DROPOUT):
    """(JAX model, JAX state, port model, port state, batches)."""
    jmodel, variables, _ = jax_ann(ann_type, cell_impl, dropout=dropout,
                                   shape=(B, T, F), sizes=(H, H, C))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = adam_with_injectable_lr(LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(0), tx=tx)
    model = build_model(ann_type, (B, T, F), [H, H, C], dropout=dropout,
                        cell_impl=cell_impl)
    model.load_state_dict(variables_from_flax(variables), strict=True)
    state = create_train_state(model, LR, device="cpu", seed=0)
    rng = np.random.default_rng(1)
    batches = [(rng.normal(0, 1, (B, T, F)).astype(np.float32),
                rng.integers(0, C, B)) for _ in range(STEPS)]
    return jmodel, jstate, model, state, batches


def _loss_fn(jmodel, params, batch_stats, x, y, dropout_rng):
    (out, _), _ = jmodel.apply(
        {"params": params, "batch_stats": batch_stats}, x, train=True,
        rngs={"dropout": dropout_rng}, mutable=["batch_stats"])
    return optax.softmax_cross_entropy_with_integer_labels(out, y).mean()


def _jax_seeds(monkeypatch, jmodel, jstate, x, y):
    """The dropout seeds that the next JAX train step draws, by layer: its
    dropout key is the third split of the state's key, and a layer's seed
    depends on that key and the layer's name alone."""
    seeds = []
    original = jax_common.FusedCellPolicy._fused_dropout

    def recording(self, train):
        rate, seed = original(self, train)
        seeds.append(np.array(seed))
        return rate, seed

    _, _, dropout_rng = jax.random.split(jstate.rng, 3)
    with monkeypatch.context() as m:
        m.setattr(jax_common.FusedCellPolicy, "_fused_dropout", recording)
        _loss_fn(jmodel, jstate.params, jstate.batch_stats, x, y,
                 dropout_rng)
    return seeds, dropout_rng


@pytest.mark.parametrize("ann_type", ["GRU", "LiGRU"])
def test_three_ann_train_steps_match_jax(ann_type, monkeypatch):
    jmodel, jstate, model, state, batches = _pair(ann_type)
    jstep = jax_make_train_step(jmodel, donate=False)
    jgrad = jax.jit(jax.grad(
        lambda *a: _loss_fn(jmodel, *a)))
    step = make_train_step(model)
    queue = []

    def seeded(self, fused, like, generator):
        assert fused and self.training
        return dict(drop_rate=float(self.dropout),
                    drop_seed=torch.from_numpy(queue.pop(0)))

    monkeypatch.setattr(FusedCellPolicy, "_fused_dropout", seeded)
    small = None
    for i, (x, y) in enumerate(batches):
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        seeds, dropout_rng = _jax_seeds(monkeypatch, jmodel, jstate, jx, jy)
        assert len(seeds) == 2 and not np.array_equal(*seeds)
        queue.extend(seeds)
        jgrads = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrad(
            jstate.params, jstate.batch_stats, jx, jy, dropout_rng))))
        if small is None:
            small = {p: np.zeros(g.shape, bool) for p, g in jgrads.items()}
        jstate, jmet = jstep(jstate, jx, jy)
        state, met = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert not queue and state.step == i + 1 == int(jstate.step)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        assert float(met["acc"]) == float(jmet["acc"])
        assert float(met["spike_rate"]) == 0.0 == float(jmet["spike_rate"])
        if i == 0:
            got = dict(_leaves(_port_tree(model, grads=True)["params"]))
            assert set(got) == set(jgrads)
            for path, want in jgrads.items():
                np.testing.assert_allclose(
                    got[path], want, atol=3e-5, rtol=1e-4,
                    err_msg="/".join(path))
                assert np.abs(want).max() > 1e-4, path
        for path, g in jgrads.items():
            small[path] |= (g != 0) & (np.abs(g) < SMALL_GRAD)
        port = _port_tree(model)
        got = dict(_leaves(port["params"]))
        for path, want in _leaves(jax.tree_util.tree_map(
                np.asarray, jstate.params)):
            keep = ~small[path]
            np.testing.assert_allclose(
                got[path][keep], want[keep], rtol=0, atol=PARAM_ATOL,
                err_msg=f"step {i + 1} " + "/".join(path))
        got = dict(_leaves(port["batch_stats"]))
        for path, want in _leaves(jax.tree_util.tree_map(
                np.asarray, jstate.batch_stats)):
            np.testing.assert_allclose(got[path], want, rtol=1e-4, atol=1e-5,
                                       err_msg="/".join(path))
    n_small = sum(int(m.sum()) for m in small.values())
    n_all = sum(m.size for m in small.values())
    print(f"{ann_type}: left out {n_small} of {n_all} entries with a "
          f"gradient below {SMALL_GRAD}")
    assert n_small < 0.02 * n_all


def test_ann_eval_step_matches_jax():
    jmodel, jstate, model, state, batches = _pair("GRU")
    x, y = batches[0]
    jmet = jax_make_eval_step(jmodel)(jstate, jnp.asarray(x), jnp.asarray(y),
                                      jax.random.PRNGKey(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    met = make_eval_step(model)(state, torch.from_numpy(x),
                                torch.from_numpy(y))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert float(met["acc"]) == float(jmet["acc"])
    assert float(met["spike_rate"]) == 0.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def _dropout_run(ann_type, seed, cell_impl, regularizers=False):
    model = build_model(ann_type, (B, T, F), [H, H, C], dropout=DROPOUT,
                        cell_impl=cell_impl,
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, LR, device="cpu", seed=seed)
    step = make_train_step(model, use_regularizers=regularizers)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (B, T, F)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, B))
    losses = []
    for _ in range(8):
        state, met = step(state, x, y)
        losses.append(float(met["loss"]))
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
@pytest.mark.parametrize("ann_type", ["MLP", "RNN", "LiGRU", "GRU"])
def test_ann_training_is_deterministic_and_learns(ann_type, cell_impl):
    """In the port alone: one seed gives bit-equal parameters, another
    seed others; eight steps on one batch lower the loss; the firing-rate
    regularizer is skipped for a model without firing rates."""
    losses, params = _dropout_run(ann_type, 3, cell_impl)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    losses2, params2 = _dropout_run(ann_type, 3, cell_impl,
                                    regularizers=True)
    assert losses == losses2
    for k, v in params.items():
        assert torch.equal(v, params2[k]), k
    _, other = _dropout_run(ann_type, 4, cell_impl)
    assert any(not torch.equal(v, other[k]) for k, v in params.items())
