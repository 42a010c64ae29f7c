"""``remat=True`` in the port: every hidden layer under
``torch.utils.checkpoint`` (counterpart of ``nn.remat`` in
sparch_tpu/models/snn.py and ann.py).

The backward recomputes each hidden layer from its input. The port draws
its dropout seeds, its plain-path dropout masks and its uniform states from
an explicit ``torch.Generator``, which the checkpoint does not restore; the
recomputation replays the forward's draws all the same and leaves the
generator where the forward left it, and the running statistics move once.
So a run with ``remat`` equals the run without it bit for bit: losses, every
gradient, the parameters and the running statistics after three steps (the
JAX package pins the same property at 1e-7, XLA's reassociation). Both
stream modes, both ``cell_impl``s, all eight model types.

Against the JAX package's ``remat=True``: one training step of RadLIF, the
loss and every gradient at the tolerances of tests/test_torch_train.py
(rtol 1e-5; atol 2e-3, rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu_torch.models import MODEL_TYPES, build_model
from sparch_tpu_torch.train import create_train_state, make_train_step

from tests.test_torch_models import _leaves
from tests.test_torch_train import _jax_grad_fn, _pair, _port_tree

B, T, F, C = 8, 11, 10, 3


def _batch():
    rng = np.random.default_rng(0)
    x = (rng.random((B, T, F)) > 0.5).astype(np.float32)
    return torch.from_numpy(x), torch.arange(B) % C


def _run(model_type, cell_impl, remat, steps=3, **kw):
    """``steps`` training steps with dropout and (for an SNN) uniform
    states, from one seed; (losses, step-1 gradients, final state dict,
    the generator's final state)."""
    x, y = _batch()
    model = build_model(model_type, (B, T, F), [16, 16, C], dropout=0.25,
                        state_init="uniform", cell_impl=cell_impl,
                        remat=remat,
                        generator=torch.Generator().manual_seed(0), **kw)
    state = create_train_state(model, 1e-2, device="cpu", seed=3)
    step = make_train_step(model)
    losses, grads = [], None
    for i in range(steps):
        state, met = step(state, x, y)
        losses.append(float(met["loss"]))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return losses, grads, model.state_dict(), state.generator.get_state()


def _assert_same_run(a, b):
    assert a[0] == b[0]  # the losses, bit for bit
    for part in (1, 2):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), k
    assert torch.equal(a[3], b[3])  # the generator went as far


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_remat_equals_the_run_without_it_bit_for_bit(model_type, cell_impl):
    _assert_same_run(_run(model_type, cell_impl, True),
                     _run(model_type, cell_impl, False))


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
@pytest.mark.parametrize("model_type", ["RadLIF", "GRU"])
def test_remat_under_bf16_equals_the_run_without_it(model_type, cell_impl):
    kw = dict(compute_dtype=torch.bfloat16)
    _assert_same_run(_run(model_type, cell_impl, True, **kw),
                     _run(model_type, cell_impl, False, **kw))


def test_remat_draws_matter_and_eval_does_not_checkpoint():
    """The draws are part of the result (another seed gives other
    gradients, so an unreplayed recomputation could not go unnoticed), the
    layers really are recomputed in the backward, and without a gradient
    nothing is checkpointed."""
    x, y = _batch()
    calls = []
    model = build_model("RadLIF", (B, T, F), [16, 16, C], dropout=0.25,
                        state_init="uniform", cell_impl="pallas", remat=True,
                        generator=torch.Generator().manual_seed(0))
    for layer in model.hidden_layers():
        layer.register_forward_pre_hook(lambda *_: calls.append(1))

    def grads(seed):
        model.zero_grad()
        out, _ = model.train()(x, torch.Generator().manual_seed(seed))
        torch.nn.functional.cross_entropy(out, y).backward()
        return torch.cat([p.grad.flatten() for p in model.parameters()])

    a, n = grads(3), len(calls)
    assert n == 4  # two layers, each run in the forward and in the backward
    assert not torch.equal(a, grads(4))
    assert torch.equal(a, grads(3))
    calls.clear()
    with torch.no_grad():
        model(x, torch.Generator().manual_seed(3))
    assert len(calls) == 2


def test_remat_step_matches_the_jax_package_with_remat():
    jmodel, jstate, model, state, batches = _pair("pallas", remat=True)
    assert model.remat
    jmodel = jmodel.clone(remat=True)
    x, y = batches[0]
    jgrads = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, _jax_grad_fn(jmodel, None)(
            jstate.params, jstate.batch_stats, jnp.asarray(x),
            jnp.asarray(y)))))
    state, met = make_train_step(model)(state, torch.from_numpy(x),
                                        torch.from_numpy(y))
    (out, _), _ = jmodel.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(x), train=True, mutable=["batch_stats"])
    import optax

    want = float(optax.softmax_cross_entropy_with_integer_labels(
        out, jnp.asarray(y)).mean())
    np.testing.assert_allclose(float(met["loss"]), want, rtol=1e-5)
    got = dict(_leaves(_port_tree(model, grads=True)["params"]))
    assert set(got) == set(jgrads)
    for path, g in jgrads.items():
        np.testing.assert_allclose(got[path], g, atol=2e-3, rtol=1e-4,
                                   err_msg="/".join(path))
    assert max(np.abs(g).max() for g in jgrads.values()) > 1e-3
