"""The port's sequence pipeline against the JAX pipeline
(``sparch_tpu/parallel/seqpipe.py`` on the conftest's 8-device CPU mesh),
in three cases built once (one JAX step is several seconds here; the broad
matrix is held against the port's own single-device step in
``test_torch_seqpipe.py``):

- RadLIF bidirectional with batchnorm and the default recipe (dropout 0.1,
  uniform states) at S = 4, M = 2: the JAX ``train_step`` draws its noise
  as ``rng, k = jax.random.split(state.rng); draw_noise(model, k,
  x.shape)``; the test makes that draw and injects it, as numpy, into the
  port's ``noise=``. Tolerances of
  ``test_seqpipe_bidirectional_default_recipe_oracle``: loss rtol 1e-5,
  the weights after one Adam step atol 2e-5, running statistics 1e-5.
- GRU at seq = 2, model = 2 (batchnorm, no dropout): loss rtol 2e-4, the
  weights atol 5e-5 (``test_seqpipe_ann_tensor_parallel``).
- ``make_seqpipe_predict`` of a RadLIF with uniform states at S = 2, M =
  2, its eval noise drawn from one key and injected: rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.models import build_model as jax_build_model
from sparch_tpu.parallel import seqpipe as jax_seqpipe
from sparch_tpu.train.state import TrainState as JaxTrainState
from sparch_tpu.train.state import adam_with_injectable_lr
from sparch_tpu_torch.convert import variables_from_flax, variables_to_flax
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.parallel import (
    make_seq_mesh,
    make_seqpipe_predict,
    make_seqpipe_train_step,
)
from sparch_tpu_torch.train import create_train_state

B, T, F, H, C = 8, 24, 12, 16, 5
CPU = torch.device("cpu")
LR = 1e-2
# name: (model type, build kwargs, (data, seq, model) of the mesh, M, seed)
CASES = {
    "radlif_bidir_recipe": ("RadLIF", dict(
        dropout=0.1, normalization="batchnorm", state_init="uniform",
        bidirectional=True), (4, 1), 2, 13),
    "gru_seq2_model2": ("GRU", dict(dropout=0.0, normalization="batchnorm"),
                        (2, 2), 2, 0),
}


def to_torch(tree):
    """A JAX noise tree as torch tensors (through numpy)."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def port_model(model_type, kw, seed):
    """The port's model from a seed, and its weights as the flax tree (the
    JAX side takes them instead of tracing its own init)."""
    model = build_model(model_type, (B, T, F), [H, H, C], cell_impl="scan",
                        generator=torch.Generator().manual_seed(seed), **kw)
    return model, jax.tree_util.tree_map(
        jnp.asarray, variables_to_flax(model.state_dict()))


def jax_state(variables, seed):
    tx = adam_with_injectable_lr(LR)
    return JaxTrainState(step=jnp.zeros((), jnp.int32),
                         params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]),
                         rng=jax.random.PRNGKey(seed), tx=tx)


def _x(seed, binary=True):
    rng = np.random.default_rng(seed)
    x = rng.random((B, T, F))
    return (x < 0.3).astype(np.float32) if binary else x.astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX pipelined train steps of ``CASES`` and the JAX predict: the
    only JAX builds of this file."""
    out = {}
    for name, (mt, kw, (S, P), M, seed) in CASES.items():
        jmodel = jax_build_model(mt, (B, T, F), [H, H, C], cell_impl="scan",
                                 **kw)
        x = _x(seed, jmodel.is_snn)
        y = (np.arange(B) % C).astype(np.int64)
        model, variables = port_model(mt, kw, seed)
        state = jax_state(variables, seed)
        _, k = jax.random.split(state.rng)
        noise = jax_seqpipe.draw_noise(jmodel, k, x.shape, train=True)
        mesh = jax_seqpipe.make_seq_mesh(jax.devices()[:S * P], model=P)
        step = jax_seqpipe.make_seqpipe_train_step(jmodel, mesh, n_micro=M)
        new, met = step(state, jax.device_put(
            x, jax_seqpipe.seq_batch_sharding(mesh)), y)
        after = jax.tree_util.tree_map(
            np.asarray, {"params": new.params,
                         "batch_stats": new.batch_stats})
        out[name] = dict(model=model, x=x, y=y,
                         noise=to_torch(noise), loss=float(met["loss"]),
                         after=variables_from_flax(after))
    # the inference forward of a RadLIF with uniform states
    jmodel = jax_build_model("RadLIF", (B, T, F), [H, H, C],
                             cell_impl="scan", state_init="uniform",
                             normalization="batchnorm")
    x = _x(21)
    model, variables = port_model("RadLIF", dict(
        state_init="uniform", normalization="batchnorm"), 3)
    mesh = jax_seqpipe.make_seq_mesh(jax.devices()[:2])
    key = jax.random.PRNGKey(22)
    predict = jax_seqpipe.make_seqpipe_predict(jmodel, mesh, n_micro=2)
    got = predict(variables["params"], variables["batch_stats"],
                  jax.device_put(x, jax_seqpipe.seq_batch_sharding(mesh)),
                  key)
    out["predict"] = dict(
        model=model, x=x,
        noise=to_torch(jax_seqpipe.draw_noise(jmodel, key, x.shape,
                                              train=False)),
        out=np.asarray(got))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_the_jax_pipeline(jax_runs, name):
    mt, kw, (S, P), M, _ = CASES[name]
    run = jax_runs[name]
    model = run["model"]
    state = create_train_state(model, LR, device="cpu")
    mesh = make_seq_mesh([CPU] * (S * P), model=P)
    state, met = make_seqpipe_train_step(model, mesh, n_micro=M)(
        state, torch.from_numpy(run["x"]), torch.from_numpy(run["y"]),
        noise=run["noise"])
    snn = model.is_snn
    if snn:
        assert float(met["spike_rate"]) > 0.0
    np.testing.assert_allclose(float(met["loss"]), run["loss"],
                               rtol=1e-5 if snn else 2e-4)
    sd = model.state_dict()
    for k, v in run["after"].items():
        atol = 1e-5 if "running" in k else (2e-5 if snn else 5e-5)
        np.testing.assert_allclose(sd[k], v, atol=atol, err_msg=k)


def test_predict_matches_the_jax_pipeline(jax_runs):
    run = jax_runs["predict"]
    predict = make_seqpipe_predict(run["model"], make_seq_mesh([CPU] * 2),
                                   n_micro=2)
    out = predict(torch.from_numpy(run["x"]), noise=run["noise"])
    np.testing.assert_allclose(out, run["out"], rtol=1e-5, atol=1e-6)
