"""The training slice of the port (sparch_tpu_torch.train) against
sparch_tpu.train on the CPU: three steps of ``make_train_step`` in both
packages from the same weights (carried across by
``convert.variables_from_flax``) on the same batches.

The model is a RadLIF SNN [16, 16, 5] with batchnorm, zero state init and
no dropout, so nothing random separates the two. With ``cell_impl="pallas"``
the JAX package runs its Pallas kernels in interpret mode and the port its
plain versions through the ``autograd.Function``s. Tolerances: first-step
gradients atol 2e-3, rtol 1e-4 (the backward tests' own); logged loss rtol
1e-5; parameters after each update atol 2e-5 at lr 1e-2 (Adam turns a
relative gradient error of 1e-4 into at most lr * 1e-4 per step, and the
moments carry it on), leaving out entries whose JAX gradient is nonzero
but below 1e-6 in magnitude at some step, where Adam's division by
|g| + 1e-8 makes the update a function of rounding. Entries whose gradient
is exactly zero at every step stay in and must not move at all.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparch_tpu.train import ReduceLROnPlateau as JaxReduceLROnPlateau
from sparch_tpu.train import make_eval_step as jax_make_eval_step
from sparch_tpu.train import make_train_step as jax_make_train_step
from sparch_tpu.train.state import TrainState as JaxTrainState
from sparch_tpu.train.state import adam_with_injectable_lr
from sparch_tpu_torch.convert import variables_from_flax, variables_to_flax
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.train import (
    ReduceLROnPlateau,
    create_train_state,
    make_eval_step,
    make_train_step,
)

from tests.test_torch_models import _leaves, jax_snn

B, T, F, H, C = 8, 12, 12, 16, 5
LR = 1e-2
STEPS = 3
SMALL_GRAD = 1e-6
PARAM_ATOL = 2e-5
REG = dict(use_regularizers=True, reg_factor=0.5, reg_fmin=0.05,
           reg_fmax=0.2)


def _pair(cell_impl, **port_kw):
    """(JAX model, JAX state, port model, port state, batches)."""
    jmodel, variables, _ = jax_snn("RadLIF", cell_impl, shape=(B, T, F),
                                   sizes=(H, H, C))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = adam_with_injectable_lr(LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(0), tx=tx)
    model = build_model("RadLIF", (B, T, F), [H, H, C], state_init="zeros",
                        cell_impl=cell_impl, **port_kw)
    model.load_state_dict(variables_from_flax(variables), strict=True)
    state = create_train_state(model, LR, device="cpu", seed=0)
    rng = np.random.default_rng(1)
    batches = [((rng.integers(0, 5, (B, T, F)) / 4.0).astype(np.float32),
                rng.integers(0, C, B)) for _ in range(STEPS)]
    return jmodel, jstate, model, state, batches


def _jax_grad_fn(jmodel, reg):
    """jax.grad of the step's loss, as a jitted function of (params,
    batch_stats, x, y)."""
    def loss_fn(params, batch_stats, x, y):
        (out, rates), _ = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, x, train=True,
            mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(out, y).mean()
        if reg:
            loss = loss + reg["reg_factor"] * (
                jax.nn.relu(reg["reg_fmin"] - rates).sum()
                + jax.nn.relu(rates - reg["reg_fmax"]).sum())
        return loss

    return jax.jit(jax.grad(loss_fn))


def _port_tree(model, grads=False):
    """The port's parameters (or their .grad) in the flax tree's layout."""
    sd = {k: (p.grad if grads else p) for k, p in model.named_parameters()}
    sd.update({k: b for k, b in model.named_buffers()})
    return variables_to_flax(sd)


def test_three_train_steps_match_jax():
    """The main path: cell_impl="pallas". The scan path and the
    regularizers run in tests/test_torch_train_variants.py."""
    check_three_train_steps("pallas", None)


def check_three_train_steps(cell_impl, reg):
    jmodel, jstate, model, state, batches = _pair(cell_impl)
    kw = reg or {}
    jstep = jax_make_train_step(jmodel, donate=False, **kw)
    jgrad = _jax_grad_fn(jmodel, reg)
    step = make_train_step(model, **kw)
    initial = dict(_leaves(_port_tree(model)["params"]))
    moved = {path: np.zeros(v.shape, bool) for path, v in initial.items()}
    small = {path: np.zeros(v.shape, bool) for path, v in initial.items()}
    for i, (x, y) in enumerate(batches):
        jgrads = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrad(
            jstate.params, jstate.batch_stats, jnp.asarray(x),
            jnp.asarray(y)))))
        jstate, jmet = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        state, met = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert state.step == i + 1 == int(jstate.step)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        assert float(met["acc"]) == float(jmet["acc"])
        np.testing.assert_allclose(float(met["spike_rate"]),
                                   float(jmet["spike_rate"]), rtol=1e-6)
        assert float(jmet["spike_rate"]) > 0.01  # the layers really spike
        if i == 0:
            # the check that cannot be fooled: the gradients themselves
            got = dict(_leaves(_port_tree(model, grads=True)["params"]))
            assert set(got) == set(jgrads)
            for path, want in jgrads.items():
                np.testing.assert_allclose(
                    got[path], want, atol=2e-3, rtol=1e-4,
                    err_msg="/".join(path))
            assert max(np.abs(g).max() for g in jgrads.values()) > 1e-3
        for path, g in jgrads.items():
            moved[path] |= g != 0
            small[path] |= (g != 0) & (np.abs(g) < SMALL_GRAD)
        port = _port_tree(model)
        for path, want in _leaves(jax.tree_util.tree_map(
                np.asarray, jstate.params)):
            got = dict(_leaves(port["params"]))[path]
            keep = ~small[path]
            np.testing.assert_allclose(
                got[keep], want[keep], rtol=0, atol=PARAM_ATOL,
                err_msg=f"step {i + 1} " + "/".join(path))
            still = ~moved[path]
            assert np.array_equal(got[still], initial[path][still]), path
        for path, want in _leaves(jax.tree_util.tree_map(
                np.asarray, jstate.batch_stats)):
            got = dict(_leaves(port["batch_stats"]))[path]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg="/".join(path))
    n_small = sum(int(m.sum()) for m in small.values())
    n_all = sum(m.size for m in small.values())
    n_still = sum(int((~m).sum()) for m in moved.values())
    print(f"{cell_impl}: left out {n_small} of {n_all} entries with a "
          f"gradient below {SMALL_GRAD}; {n_still} never moved")
    assert n_small < 0.05 * n_all
    # the diagonal of V never moves
    assert n_still >= 2 * H


def test_eval_step_matches_jax():
    jmodel, jstate, model, state, batches = _pair("pallas")
    x, y = batches[0]
    jmet = jax_make_eval_step(jmodel)(jstate, jnp.asarray(x), jnp.asarray(y),
                                      jax.random.PRNGKey(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    met = make_eval_step(model)(state, torch.from_numpy(x),
                                torch.from_numpy(y))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert float(met["acc"]) == float(jmet["acc"])
    np.testing.assert_allclose(float(met["spike_rate"]),
                               float(jmet["spike_rate"]), rtol=1e-6)
    # eval changes nothing, running statistics included
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="another model"):
        make_eval_step(build_model("LIF", (B, T, F), [H, C]))(
            state, torch.from_numpy(x), torch.from_numpy(y))


def _dropout_run(seed, cell_impl="pallas", steps=STEPS):
    model = build_model(
        "RadLIF", (B, T, F), [H, H, C], dropout=0.1, state_init="uniform",
        cell_impl=cell_impl, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.hidden_layers():
            layer.norm.weight.fill_(4.0)
            layer.norm.bias.fill_(0.75)
    state = create_train_state(model, LR, device="cpu", seed=seed)
    step = make_train_step(model)
    rng = np.random.default_rng(2)
    losses = []
    for _ in range(steps):
        x = torch.from_numpy((rng.integers(0, 5, (B, T, F)) / 4.0).astype(
            np.float32))
        y = torch.from_numpy(rng.integers(0, C, B))
        state, met = step(state, x, y)
        losses.append(float(met["loss"]))
        assert float(met["spike_rate"]) > 0.01
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
def test_dropout_uniform_training_is_deterministic(cell_impl):
    """dropout 0.1 and a uniform state init, in the port alone: one seed
    gives bit-equal parameters, another seed gives others."""
    losses, params = _dropout_run(3, cell_impl)
    assert np.isfinite(losses).all()
    losses2, params2 = _dropout_run(3, cell_impl)
    assert losses == losses2
    for k, v in params.items():
        assert torch.equal(v, params2[k]), k
    _, other = _dropout_run(4, cell_impl)
    assert any(not torch.equal(v, other[k]) for k, v in params.items())


def test_plateau_schedule_matches_jax_and_set_lr_takes_effect():
    series = [0.1, 0.3, 0.3, 0.29, 0.31, 0.2, 0.2, 0.2, 0.2, -0.1, 0.5]
    for mode in ("max", "min"):
        a = ReduceLROnPlateau(lr=LR, mode=mode)
        b = JaxReduceLROnPlateau(lr=LR, mode=mode)
        assert [a.step(m) for m in series] == [b.step(m) for m in series]
        assert a.state_dict() == b.state_dict()
        assert ReduceLROnPlateau.from_state_dict(a.state_dict()) == a
    assert a.lr < LR

    _, _, model, state, batches = _pair("scan")
    step = make_train_step(model)
    assert state.lr == LR
    x, y = (torch.from_numpy(v) for v in batches[0])
    state, _ = step(state, x, y)
    after_one = {k: v.clone() for k, v in model.named_parameters()}
    assert state.set_lr(0.0) is state and state.lr == 0.0
    state, _ = step(state, x, y)
    for k, v in model.named_parameters():
        assert torch.equal(v, after_one[k]), k  # lr 0: nothing moves
    state.set_lr(LR)
    state, _ = step(state, x, y)
    assert any(not torch.equal(v, after_one[k])
               for k, v in model.named_parameters())


def test_create_train_state_needs_a_card_unless_asked_for_the_cpu():
    model = build_model("LIF", (B, T, F), [H, C])
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model, LR)
    state = create_train_state(model, LR, device="cpu", seed=1)
    assert state.device == torch.device("cpu") and state.step == 0
    group = state.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


@pytest.mark.parametrize("normalization", ["batchnorm", "layernorm"])
def test_variables_to_flax_round_trips(normalization):
    _, variables, _ = jax_snn("RadLIF", normalization=normalization,
                              use_bias=True)
    back = variables_to_flax(variables_from_flax(variables))
    want = dict(_leaves(variables))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg="/".join(path))
    with pytest.raises(KeyError, match="mystery"):
        variables_to_flax({"layer_0.mystery": torch.ones(2)})
