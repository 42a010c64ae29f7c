"""The port's tensor-parallel models under ``compute_dtype=bfloat16``
(``cell_impl='pallas_tp'``, the TP kernels' bf16-stream form) on the CPU, in
the one-card form (``make_mesh([cpu] * 2, model=2)``), for all seven
recurrent model types.

- Against the port's single-card bf16 model (``cell_impl='pallas'``, the
  plain versions of ``ops.fused_cells`` / ``ops.fused_ann``) with no
  normalisation and no dropout, so that both hand the cells the same bf16
  drive, and the spiking readout in its closed form on both: the TP cells
  round where the single-card cells round, so two training steps and an
  eval step are equal bit for bit, losses, every gradient and the
  parameters after.
- Against the JAX model in the same mode (``compute_dtype=bfloat16``,
  ``cell_impl='scan'``, the weights carried across by
  ``convert.variables_from_flax``, which needs no change for this path):
  the JAX scan cells keep their products in float32 where the TP kernels
  round to bf16, so the outputs are held as tests/test_torch_bf16_models.py
  holds the bf16 models (atol 0.3, rtol 0.1, the mean cross-entropy within
  0.05, the JAX package's own bounds between its bf16 and float32 modes),
  and each parameter's gradient must point the same way: cosine similarity
  at least 0.99 with the JAX gradient (measured here: 0.9977 or more; the
  largest elementwise gaps, up to 0.19 of a gradient's largest magnitude,
  are the LiGRU's relu kink and the readout norm's ill-conditioning).
- Against the port's scan model in bf16 (dropout 0.1 and the uniform state
  init drawn from one generator on both paths): the step-1 loss within
  0.05 and the gradients by the same cosine rule; parameters, gradients and
  Adam's moments float32; an eval step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F_

from sparch_tpu_torch.convert import variables_from_flax, variables_to_flax
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.parallel import make_mesh
from sparch_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

from tests.test_torch_ann_models import jax_ann
from tests.test_torch_models import _leaves, jax_snn

BF16 = torch.bfloat16
B, T, F, C, P = 8, 10, 16, 5, 2
H = 128 * P
TYPES = ["LIF", "adLIF", "RLIF", "RadLIF", "RNN", "LiGRU", "GRU"]
SPIKING = TYPES[:4]
OUT_ATOL, OUT_RTOL = 0.3, 0.1
LOSS_TOL = 0.05
COS_MIN = 0.99


def _mesh():
    return make_mesh([torch.device("cpu")] * P, model=P)


def _tp_kw():
    return dict(cell_impl="pallas_tp", tp_mesh=_mesh(), compute_dtype=BF16)


def _cosines(got, want):
    """Cosine similarity of each gradient with the reference's, over the
    parameters whose reference gradient is not zero."""
    out = {}
    for k, w in want.items():
        w = torch.as_tensor(w).double().flatten()
        if float(w.abs().max()) > 0:
            g = torch.as_tensor(got[k]).double().flatten()
            out[k] = float(F_.cosine_similarity(g, w, dim=0))
    return out


def _assert_float32(model, state=None):
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
        assert p.grad is None or p.grad.dtype == torch.float32, k
    if state is not None:
        moments = [v for st in state.optimizer.state.values()
                   for v in st.values() if torch.is_tensor(v)]
        assert moments and all(v.dtype == torch.float32 for v in moments)


def _steps(model, x, y, n=2):
    """``n`` training steps and one eval step: (metrics of each step,
    step-1 gradients, parameters after, eval metrics, state)."""
    state = create_train_state(model, 1e-2, device="cpu", seed=0)
    step = make_train_step(model)
    mets, grads = [], None
    for i in range(n):
        state, met = step(state, x, y)
        mets.append({k: float(v) for k, v in met.items()})
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    ev = make_eval_step(model)(state, x, y, torch.Generator().manual_seed(3))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    return mets, grads, params, {k: float(v) for k, v in ev.items()}, state


def _batch(model_type, seed=2, gain=1.0):
    """An input batch; a spiking model's on a grid that bf16 holds, times
    ``gain`` (without a norm, a gain of 8 makes every layer spike)."""
    rng = np.random.default_rng(seed)
    if model_type in SPIKING:
        x = (rng.integers(0, 5, (B, T, F)) * gain / 4.0).astype(np.float32)
    else:
        x = rng.normal(0, 1, (B, T, F)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(rng.integers(0, C, B))


@pytest.mark.parametrize("model_type", TYPES)
def test_tp_bf16_model_equals_the_single_card_bf16_model(model_type):
    bidirectional = model_type in ("RadLIF", "LiGRU")
    kw = dict(normalization="none", dropout=0.0, bidirectional=bidirectional,
              generator=torch.Generator().manual_seed(0))
    single = build_model(model_type, (B, T, F), [H, H, C], cell_impl="pallas",
                         compute_dtype=BF16, **kw)
    if model_type in SPIKING:
        # 'pallas' also takes the fused readout, 'pallas_tp' the closed form
        # (as the JAX models do): both take the closed form here
        single.readout.cell_impl = "scan"
    tp = build_model(model_type, (B, T, F), [H, H, C], **_tp_kw(), **kw)
    tp.load_state_dict(single.state_dict(), strict=True)
    x, y = _batch(model_type, gain=8.0)
    want = _steps(single, x, y)
    got = _steps(tp, x, y)
    _assert_float32(tp, got[4])
    if model_type in SPIKING:
        assert got[0][0]["spike_rate"] > 0.01  # the layers spike
    assert got[0] == want[0] and got[3] == want[3]
    for i in (1, 2):
        assert set(got[i]) == set(want[i])
        for k, v in want[i].items():
            assert torch.equal(got[i][k], v), (i, k)
    assert np.isfinite([m["loss"] for m in got[0]]).all()


@pytest.mark.parametrize("model_type", TYPES)
def test_tp_bf16_model_matches_jax_scan_bf16(model_type):
    if model_type in SPIKING:
        jmodel, variables, x = jax_snn(model_type, "scan", shape=(B, T, F),
                                       sizes=(H, H, C))
        kw = dict(state_init="zeros")
    else:
        jmodel, variables, x = jax_ann(model_type, "scan", shape=(B, T, F),
                                       sizes=(H, H, C))
        kw = {}
    j16 = jmodel.clone(compute_dtype=jnp.bfloat16)
    model = build_model(model_type, (B, T, F), [H, H, C], **_tp_kw(), **kw)
    model.load_state_dict(variables_from_flax(variables), strict=True)
    # the converter carries the float32 leaves across unchanged
    back = dict(_leaves(variables_to_flax(model.state_dict())))
    for path, leaf in _leaves(variables):
        assert np.array_equal(back[path], leaf), path

    want, _ = j16.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out, _ = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=OUT_ATOL,
                               rtol=OUT_RTOL)

    y = np.random.default_rng(1).integers(0, C, B)

    def loss_fn(params):
        (o, _), _ = j16.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            o.astype(jnp.float32), jnp.asarray(y)).mean()

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    model.train()
    o, _ = model(torch.from_numpy(x))
    loss = F_.cross_entropy(o, torch.from_numpy(y))
    loss.backward()
    _assert_float32(model)
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL
    want_g = variables_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    got_g = {k: p.grad for k, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    cos = _cosines(got_g, want_g)
    worst = min(cos, key=cos.get)
    assert cos[worst] >= COS_MIN, (worst, cos[worst])


@pytest.mark.parametrize("model_type", TYPES)
def test_tp_bf16_trains_and_evaluates_as_the_port_scan(model_type):
    kw = dict(dropout=0.1, compute_dtype=BF16,
              generator=torch.Generator().manual_seed(0))
    if model_type in SPIKING:
        kw.update(state_init="uniform")
    scan = build_model(model_type, (B, T, F), [H, H, C], cell_impl="scan",
                       **kw)
    with torch.no_grad():  # V on the 2^-8 grid: a bf16 value
        for layer in scan.hidden_layers():
            if model_type in SPIKING and hasattr(layer, "V"):
                layer.V.copy_(torch.round(layer.V * 256.0) / 256.0)
    tp = build_model(model_type, (B, T, F), [H, H, C], cell_impl="pallas_tp",
                     tp_mesh=_mesh(), **kw)
    tp.load_state_dict(scan.state_dict(), strict=True)
    x, y = _batch(model_type)
    s_mets, s_grads, _, s_ev, _ = _steps(scan, x, y)
    t_mets, t_grads, _, t_ev, state = _steps(tp, x, y)
    _assert_float32(tp, state)
    assert abs(t_mets[0]["loss"] - s_mets[0]["loss"]) <= LOSS_TOL
    assert np.isfinite([m["loss"] for m in t_mets]).all()
    cos = _cosines(t_grads, s_grads)
    worst = min(cos, key=cos.get)
    assert cos[worst] >= COS_MIN, (worst, cos[worst])
    assert set(t_ev) == set(s_ev) and np.isfinite(list(t_ev.values())).all()
