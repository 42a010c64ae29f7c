"""``compute_dtype=bfloat16`` in the port against the JAX package in the
same mode, on the CPU: the ``Dense`` and ``SeqNorm`` building blocks, the
four spiking and the three recurrent non-spiking models with
``cell_impl="pallas"`` (the JAX side runs its Pallas kernels in interpret
mode with ``mxu_bf16=True``, the port its plain versions), training steps,
the Predictor and streaming.

The two frameworks round a bf16 product's sum at their own places, so a
projection may differ by one bf16 ulp, and a spike or a rounding downstream
may then fall on the other side. What is held:

- ``Dense(dtype=bfloat16)``: output bf16 within one bf16 ulp (2^-7
  relative) of the JAX layer's on the same bf16-exact operands; the weight
  gradient float32 and summed in float32, within 1e-3 of its largest
  magnitude of JAX's; the parameter float32.
- ``SeqNorm`` on a bf16 stream: sums in float32, ``affine`` within 1e-5 of
  the JAX module's, ``forward`` returns float32 within 1e-5.
- models: outputs within atol 0.3 / rtol 0.1 and the mean cross-entropy
  within 0.05 of the JAX model's in the same mode (the JAX package's own
  bounds between its bf16 and float32 modes) and within 0.1 of the port's
  float32 loss; parameters, gradients and Adam's moments float32.
- a bf16 integer raster into a float32 model is lossless: the step equals
  the float32-input step bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F_

from sparch_tpu.models import common as jax_common
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.models.common import Dense, SeqNorm
from sparch_tpu_torch.serve import Predictor, streaming_init, streaming_step
from sparch_tpu_torch.train import create_train_state, make_train_step

from tests.test_torch_ann_models import jax_ann, port_ann
from tests.test_torch_models import jax_snn

BF16 = torch.bfloat16
ULP = 2.0 ** -7
OUT_ATOL, OUT_RTOL = 0.3, 0.1
LOSS_VS_JAX, LOSS_VS_F32 = 0.05, 0.1
SPIKING = ["LIF", "adLIF", "RLIF", "RadLIF"]
RECURRENT_ANN = ["RNN", "LiGRU", "GRU"]


def _bf16_exact(a):
    return torch.from_numpy(a).to(BF16).float().numpy()


@pytest.mark.parametrize("use_bias", [False, True])
def test_dense_casts_at_use_and_sums_the_weight_gradient_in_float32(use_bias):
    rng = np.random.default_rng(0)
    x = _bf16_exact(rng.normal(0, 1, (4, 7, 12)).astype(np.float32))
    w = rng.uniform(-0.3, 0.3, (12, 9)).astype(np.float32)  # flax layout
    b = rng.uniform(-0.3, 0.3, 9).astype(np.float32)
    g = _bf16_exact(rng.normal(0, 1, (4, 7, 9)).astype(np.float32))
    params = {"kernel": jnp.asarray(w)}
    if use_bias:
        params["bias"] = jnp.asarray(b)
    jdense = jax_common.Dense(9, use_bias=use_bias, dtype=jnp.bfloat16)

    def jloss(p, xj):
        y = jdense.apply({"params": p}, xj)
        return (y.astype(jnp.float32) * g).sum(), y

    (_, want), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x).astype(jnp.bfloat16))

    dense = Dense(12, 9, use_bias, dtype=BF16)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T))
        if use_bias:
            dense.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)  # a float32 input is cast
    got = dense(xt)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    (got.float() * torch.from_numpy(g)).sum().backward()
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=ULP,
                               atol=ULP * np.abs(want).max() / 64)
    assert dense.weight.dtype == dense.weight.grad.dtype == torch.float32
    jw = np.asarray(jgp["kernel"]).T
    assert jgp["kernel"].dtype == jnp.float32
    assert np.abs(dense.weight.grad.numpy() - jw).max() <= \
        1e-3 * np.abs(jw).max()
    # summed in float32: the gradient is no bf16 value
    assert not torch.equal(dense.weight.grad,
                           dense.weight.grad.to(BF16).float())
    if use_bias:
        jb = np.asarray(jgp["bias"])
        assert dense.bias.grad.dtype == torch.float32
        np.testing.assert_allclose(dense.bias.grad.numpy(), jb, rtol=1e-5,
                                   atol=1e-5)
    jx = np.asarray(jgx).astype(np.float32)
    np.testing.assert_allclose(xt.grad.numpy(), jx, rtol=2 * ULP,
                               atol=ULP * np.abs(jx).max())


def test_dense_without_dtype_promotes_a_narrower_input():
    dense = Dense(6, 4)
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    want = dense(x)
    got = dense(x.to(BF16))  # small integers: exact in bf16
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("kind", ["batchnorm", "layernorm", "none"])
def test_seqnorm_takes_float32_sums_over_a_bf16_stream(kind):
    rng = np.random.default_rng(1)
    x = _bf16_exact(rng.normal(0.3, 1.5, (6, 11, 10)).astype(np.float32))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(BF16)
    norm = SeqNorm(kind, 10).train()
    jnorm = jax_common.SeqNorm(kind)
    variables = jnorm.init(jax.random.PRNGKey(0), xj)
    want, mut = jnorm.apply(variables, xj, mutable=["batch_stats"])
    got = norm(xt)
    if kind == "none":
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        assert torch.equal(got, xt)
        assert norm.affine(xt) == (None, None)
        return
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if kind == "batchnorm":
        stats = mut["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(norm.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(norm.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-6)
        jaff = jax_common.SeqNormAffine(kind)
        (jscale, jshift), _ = jaff.apply(variables, xj,
                                         mutable=["batch_stats"])
        scale, shift = SeqNorm(kind, 10).train().affine(xt)
        assert scale.dtype == shift.dtype == torch.float32
        np.testing.assert_allclose(scale.detach().numpy(),
                                   np.asarray(jscale), rtol=1e-5)
        np.testing.assert_allclose(shift.detach().numpy(),
                                   np.asarray(jshift), rtol=1e-5, atol=1e-6)


def test_scan_cells_follow_a_bf16_stream():
    """An un-normalised projection under compute_dtype=bfloat16 hands the
    scan cells a bf16 drive: they run in it, with the float32 constants and
    matrices cast where they are used, and stay near the float32 cell."""
    from sparch_tpu_torch.ops import cells

    from tests.test_torch_kernels import (ANN_MODES, FORMS, ann_call, call,
                                          make_ann_inputs, make_inputs)

    def half(a):
        t = torch.from_numpy(a)
        return t.to(BF16) if t.ndim > 1 else t  # streams, states, matrices

    for name in FORMS:
        d = make_inputs(4, 9, 16, seed=3)
        got = call(cells, "scan", name, d, half)
        want = call(cells, "scan", name, d, torch.from_numpy)
        assert got.dtype == BF16
        assert float((got.float() == want).float().mean()) > 0.9
    for mode in ANN_MODES:
        d = make_ann_inputs(mode, 4, 9, 16, seed=3)
        got = ann_call(cells, "scan", mode, d, half)
        want = ann_call(cells, "scan", mode, d, torch.from_numpy)
        assert got.dtype == BF16
        torch.testing.assert_close(got.float(), want, rtol=0, atol=0.1)
    model = build_model("RadLIF", (4, 9, 10), [16, 3], normalization="none",
                        cell_impl="scan", compute_dtype=BF16,
                        state_init="zeros")
    out, _ = model(torch.ones(4, 9, 10))
    out.sum().backward()
    assert out.dtype == torch.float32
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


def _loss(out, y):
    return float(F_.cross_entropy(torch.as_tensor(np.array(out)).float(),
                                  torch.as_tensor(y)))


def _check_model(jmodel, variables, x, port, is_snn):
    """Eval-mode outputs of the JAX model and the port, both under
    compute_dtype=bfloat16 with cell_impl='pallas', and the port in
    float32."""
    y = np.arange(x.shape[0]) % jmodel.layer_sizes[-1]
    j16 = jmodel.clone(compute_dtype=jnp.bfloat16)
    want, _ = j16.apply(variables, jnp.asarray(x), train=False)
    model = port(jmodel, variables, "pallas", compute_dtype=BF16)
    f32 = port(jmodel, variables, "pallas")
    with torch.no_grad():
        got, rates = model(torch.from_numpy(x))
        ref, _ = f32(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=OUT_RTOL)
    assert abs(_loss(got, y) - _loss(want, y)) <= LOSS_VS_JAX
    assert abs(_loss(got, y) - _loss(ref, y)) <= LOSS_VS_F32
    if is_snn:
        assert 0.01 < float(rates.mean()) < 0.9  # it spikes
    return model


def _port_snn(jmodel, variables, cell_impl, **kw):
    from sparch_tpu_torch.convert import variables_from_flax

    model = build_model(
        jmodel.neuron_type, jmodel.input_shape, jmodel.layer_sizes,
        normalization=jmodel.normalization, use_bias=jmodel.use_bias,
        bidirectional=jmodel.bidirectional, state_init="zeros",
        cell_impl=cell_impl, **kw)
    model.load_state_dict(variables_from_flax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("neuron_type", SPIKING)
def test_spiking_model_matches_jax_under_bf16(neuron_type):
    jmodel, variables, x = jax_snn(neuron_type, "pallas")
    model = _check_model(jmodel, variables, x, _port_snn, True)
    # the hidden layers hand bf16 spikes on, the readout runs in float32
    with torch.no_grad():
        s = model.layer_0(torch.from_numpy(x))
    assert s.dtype == BF16


@pytest.mark.parametrize("ann_type", RECURRENT_ANN)
def test_ann_model_matches_jax_under_bf16(ann_type):
    jmodel, variables, x = jax_ann(ann_type, "pallas")
    model = _check_model(jmodel, variables, x, port_ann, False)
    with torch.no_grad():
        h = model.layer_0(torch.from_numpy(x))
    assert h.dtype == BF16


@pytest.mark.parametrize("model_type", SPIKING + RECURRENT_ANN)
def test_train_mode_loss_is_close_to_jax_and_state_stays_float32(model_type):
    """One train-mode forward with batch statistics (the JAX package's own
    model-level bf16 check) and one optimizer step."""
    rng = np.random.default_rng(3)
    B, T, F, H, C = 4, 19, 13, 24, 6
    x = rng.normal(0, 1, (B, T, F)).astype(np.float32)
    y = np.arange(B) % C
    if model_type in SPIKING:
        jmodel, variables, _ = jax_snn(model_type, "pallas", shape=(B, T, F),
                                       sizes=(H, C))
        port = _port_snn
    else:
        jmodel, variables, _ = jax_ann(model_type, "pallas", shape=(B, T, F),
                                       sizes=(H, C))
        port = port_ann
    j16 = jmodel.clone(compute_dtype=jnp.bfloat16)
    (out, _), _ = j16.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    want = float(optax.softmax_cross_entropy_with_integer_labels(
        out.astype(jnp.float32), jnp.asarray(y)).mean())
    model = port(jmodel, variables, "pallas", compute_dtype=BF16)
    state = create_train_state(model, 1e-2, device="cpu")
    state, met = make_train_step(model)(state, torch.from_numpy(x),
                                        torch.from_numpy(y))
    assert abs(float(met["loss"]) - want) <= LOSS_VS_JAX
    assert met["loss"].dtype == met["acc"].dtype == torch.float32
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()
    moments = [v for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v)]
    assert moments and all(v.dtype == torch.float32 for v in moments)


def _separable_batch(B=8, T=12, F=10, C=3):
    rng = np.random.default_rng(0)
    y = np.arange(B) % C
    x = np.zeros((B, T, F), np.float32)
    blk = F // C
    for i in range(B):
        x[i, :, y[i] * blk:(y[i] + 1) * blk] = rng.random((T, blk)) > 0.3
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("model_type,cell_impl",
                         [("LIF", "scan"), ("LIF", "pallas"),
                          ("RadLIF", "pallas"), ("GRU", "pallas")])
def test_bf16_training_runs_and_learns(model_type, cell_impl):
    x, y = _separable_batch()
    model = build_model(model_type, tuple(x.shape), [16, 3], dropout=0.0,
                        state_init="zeros", cell_impl=cell_impl,
                        compute_dtype=BF16,
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, 1e-2, device="cpu")
    step = make_train_step(model)
    losses = []
    for _ in range(40):
        state, met = step(state, x, y)
        losses.append(float(met["loss"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("cell_impl", ["scan", "pallas"])
def test_bf16_integer_raster_input_is_lossless(cell_impl):
    rng = np.random.default_rng(1)
    x32 = rng.poisson(0.8, (8, 12, 10)).astype(np.float32)
    assert x32.max() < 256  # the exact-in-bf16 integer range
    y = torch.from_numpy(np.arange(8) % 3)

    def one_step(x):
        model = build_model("adLIF", (8, 12, 10), [16, 3], dropout=0.1,
                            state_init="uniform", normalization="none",
                            cell_impl=cell_impl,
                            generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, 1e-2, device="cpu", seed=0)
        state, met = make_train_step(model)(state, x, y)
        return met, model.state_dict()

    m32, p32 = one_step(torch.from_numpy(x32))
    m16, p16 = one_step(torch.from_numpy(x32).to(BF16))
    assert float(m32["loss"]) == float(m16["loss"])
    assert float(m32["acc"]) == float(m16["acc"])
    for k in p32:
        assert torch.equal(p32[k], p16[k]), k


@pytest.mark.parametrize("model_type", ["RadLIF", "GRU"])
def test_predictor_and_streaming_under_bf16(model_type):
    """The Predictor takes float32 input and returns float32
    probabilities; streaming reads the float32 weights and carries float32
    state, whatever the model computes in."""
    rng = np.random.default_rng(5)
    B, T, F, C = 6, 11, 10, 4
    x = (rng.random((B, T, F)) > 0.6).astype(np.float32)
    kw = dict(state_init="zeros", cell_impl="pallas",
              generator=torch.Generator().manual_seed(0))
    model = build_model(model_type, (B, T, F), [16, C], compute_dtype=BF16,
                        **kw)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    labels, probs = Predictor(model, sd, batch_size=4, device="cpu")(x)
    assert probs.dtype == np.float32 and probs.shape == (B, C)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    f32 = build_model(model_type, (B, T, F), [16, C], **kw)
    _, want = Predictor(f32, sd, batch_size=4, device="cpu")(x)
    assert np.abs(probs - want).max() <= 0.1
    state = streaming_init(model, sd, B)
    for t in range(T):
        state, out = streaming_step(model, sd, state,
                                    torch.from_numpy(x[:, t]))
    assert out.dtype == torch.float32
    for layer in state["layers"]:
        assert all(v.dtype == torch.float32 for v in layer.values())
    # streaming computes in float32: it is the float32 model's forward
    with torch.no_grad():
        batch, _ = f32.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), batch.numpy(), rtol=1e-4,
                               atol=1e-5)
