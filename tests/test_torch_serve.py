"""Serving in the port (sparch_tpu_torch.serve) against sparch_tpu.serve on
the CPU: the batch Predictor, with its fixed-shape padding, and
frame-by-frame streaming."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.serve import Predictor as JaxPredictor
from sparch_tpu.serve import streaming_init as jax_streaming_init
from sparch_tpu.serve import streaming_step as jax_streaming_step
from sparch_tpu_torch.convert import variables_from_flax
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.parallel import make_seq_mesh
from sparch_tpu_torch.serve import Predictor, streaming_init, streaming_step

from tests.test_torch_models import B, C, T, jax_snn, port_snn


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
def test_predictor_matches_jax(cell_impl):
    """n = 9 rows with batch_size 4: the last chunk is padded."""
    jmodel, variables, x = jax_snn("RadLIF", cell_impl)
    want_labels, want_probs = JaxPredictor(jmodel, variables, batch_size=4)(x)
    model = port_snn(jmodel, variables, cell_impl)
    pred = Predictor(model, variables_from_flax(variables), batch_size=4,
                     device="cpu")
    labels, probs = pred(x)
    assert labels.shape == (B,) and probs.shape == (B, C)
    assert labels.dtype == want_labels.dtype
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-6)


def test_predictor_uniform_state_init_is_deterministic():
    jmodel, variables, x = jax_snn("RadLIF")
    model = build_model("RadLIF", (B, T, x.shape[-1]), jmodel.layer_sizes,
                        state_init="uniform")
    pred = Predictor(model, variables_from_flax(variables), batch_size=4,
                     seed=5, device="cpu")
    labels, probs = pred(x)
    labels2, probs2 = pred(x)
    np.testing.assert_array_equal(probs, probs2)
    np.testing.assert_allclose(probs.sum(-1), np.ones(B), rtol=1e-6)
    # the states differ from zeros: so do the outputs
    zeros = Predictor(port_snn(jmodel, variables, "scan"),
                      variables_from_flax(variables), batch_size=4,
                      device="cpu")
    assert not np.array_equal(zeros(x)[1], probs)


def test_predictor_edges():
    jmodel, variables, x = jax_snn("LIF")
    model = port_snn(jmodel, variables, "scan")
    pred = Predictor(model, variables_from_flax(variables), device="cpu")
    labels, probs = pred(x[:0])
    assert labels.shape == (0,) and probs.shape == (0, C)
    # lengths= belongs to waveform models, as in the JAX Predictor
    with pytest.raises(ValueError, match="device-frontend"):
        pred(x, lengths=np.ones(B))
    with pytest.raises(ValueError, match="device-frontend"):
        JaxPredictor(jmodel, variables)(x, lengths=np.ones(B))
    # a mesh with a seq axis serves through the sequence pipeline (the
    # same answers); any other mesh raises
    stages = make_seq_mesh([torch.device("cpu")] * T)
    seq = Predictor(model, model.state_dict(), device="cpu", mesh=stages,
                    n_micro=1)
    np.testing.assert_array_equal(seq(x)[0], pred(x)[0])
    np.testing.assert_allclose(seq(x)[1], pred(x)[1], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="no 'seq' axis"):
        Predictor(model, model.state_dict(), mesh=object(), device="cpu")
    # pad_multiple buckets waveform frames: a feature model serves alike
    other = Predictor(model, model.state_dict(), pad_multiple=50,
                      device="cpu")
    np.testing.assert_array_equal(other(x)[1], pred(x)[1])
    # from_experiment is ported (tests/test_torch_cli.py): without a card
    # and without device="cpu" it raises before reading anything
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_experiment("exp")


@pytest.mark.parametrize("neuron_type", ["RadLIF", "LIF"])
def test_streaming_matches_batch_and_jax(neuron_type):
    jmodel, variables, x = jax_snn(neuron_type, "scan")
    model = port_snn(jmodel, variables, "scan")
    sd = variables_from_flax(variables)
    state = streaming_init(model, sd, B)
    jstate = jax_streaming_init(jmodel, variables, B)
    for t in range(T):
        state, out = streaming_step(model, sd, state, torch.from_numpy(x[:, t]))
        jstate, jout = jax_streaming_step(jmodel, variables, jstate,
                                          jnp.asarray(x[:, t]))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-6, err_msg=f"frame {t}")
    with torch.no_grad():
        batch_out, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), batch_out.numpy(), rtol=0,
                               atol=1e-5)
    assert state["t"] == T


def test_streaming_rejects_bidirectional():
    jmodel, variables, _ = jax_snn("RadLIF", bidirectional=True)
    model = port_snn(jmodel, variables, "scan")
    with pytest.raises(ValueError, match="Bidirectional"):
        streaming_init(model, variables_from_flax(variables), 2)


def test_predictor_needs_a_card_unless_asked_for_the_cpu():
    """The default device is the CUDA card: without one the Predictor
    raises instead of carrying on on the CPU; device='cpu' serves there."""
    jmodel, variables, x = jax_snn("LIF")
    model = port_snn(jmodel, variables, "scan")
    sd = variables_from_flax(variables)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model, sd)
    pred = Predictor(model, sd, device="cpu")
    assert pred.device == torch.device("cpu")
    labels, probs = pred(x)
    assert labels.shape == (B,) and np.isfinite(probs).all()
