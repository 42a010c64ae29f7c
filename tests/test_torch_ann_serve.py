"""Serving the ANN family in the port (sparch_tpu_torch.serve) against
sparch_tpu.serve on the CPU: the batch Predictor, whose class probabilities
are a softmax of an ANN's logits, and frame-by-frame streaming, where the
readout's running sum of softmaxes is carried and its linear layer and norm
are applied at every frame."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.serve import Predictor as JaxPredictor
from sparch_tpu.serve import streaming_init as jax_streaming_init
from sparch_tpu.serve import streaming_step as jax_streaming_step
from sparch_tpu_torch.convert import variables_from_flax
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.serve import Predictor, streaming_init, streaming_step

from tests.test_torch_ann_models import B, C, H, T, jax_ann, port_ann


@pytest.mark.parametrize("cell_impl", ["pallas", "scan"])
@pytest.mark.parametrize("ann_type", ["GRU", "LiGRU", "MLP"])
def test_ann_predictor_matches_jax(ann_type, cell_impl):
    """n = 8 rows with batch_size 3: the last chunk is padded."""
    jmodel, variables, x = jax_ann(ann_type, cell_impl)
    want_labels, want_probs = JaxPredictor(jmodel, variables, batch_size=3)(x)
    model = port_ann(jmodel, variables, cell_impl)
    pred = Predictor(model, variables_from_flax(variables), batch_size=3,
                     device="cpu")
    labels, probs = pred(x)
    assert labels.shape == (B,) and probs.shape == (B, C)
    assert labels.dtype == want_labels.dtype
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-6)
    # a softmax of the logits, not the logits over their sum
    np.testing.assert_allclose(probs.sum(-1), np.ones(B), rtol=1e-6)
    assert (probs > 0).all()
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(x))
    assert (logits < 0).any()
    np.testing.assert_allclose(probs, torch.softmax(logits, -1).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("ann_type", ["GRU", "LiGRU", "RNN", "MLP"])
def test_ann_streaming_matches_batch_and_jax(ann_type):
    jmodel, variables, x = jax_ann(ann_type, "scan")
    model = port_ann(jmodel, variables, "scan")
    sd = variables_from_flax(variables)
    state = streaming_init(model, sd, B)
    jstate = jax_streaming_init(jmodel, variables, B)
    assert [tuple(layer["y"].shape) for layer in state["layers"]] == \
        [(B, H), (B, H)]
    assert tuple(state["readout"]["acc"].shape) == (B, H)
    for t in range(T):
        state, out = streaming_step(model, sd, state,
                                    torch.from_numpy(x[:, t]))
        jstate, jout = jax_streaming_step(jmodel, variables, jstate,
                                          jnp.asarray(x[:, t]))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=2e-6, err_msg=f"frame {t}")
    for layer, jlayer in zip(state["layers"], jstate["layers"]):
        np.testing.assert_allclose(layer["y"].numpy(),
                                   np.asarray(jlayer["y"]), rtol=0,
                                   atol=2e-5)
    # T frames one at a time are one (B, T, F) forward
    with torch.no_grad():
        batch_out, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), batch_out.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert state["t"] == T == int(jstate["t"])


def test_ann_streaming_without_readout_and_layernorm():
    jmodel, variables, x = jax_ann("GRU", "scan", "layernorm",
                                   use_bias=True)
    model = port_ann(jmodel, variables, "scan")
    sd = variables_from_flax(variables)
    state = streaming_init(model, sd, B)
    jstate = jax_streaming_init(jmodel, variables, B)
    for t in range(3):
        state, out = streaming_step(model, sd, state,
                                    torch.from_numpy(x[:, t]))
        jstate, jout = jax_streaming_step(jmodel, variables, jstate,
                                          jnp.asarray(x[:, t]))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=2e-6)
    # without a readout layer a step returns the top layer's output
    model = build_model("GRU", (B, T, x.shape[-1]), [H, H],
                        use_readout_layer=False)
    sd = model.state_dict()
    state = streaming_init(model, sd, B)
    assert "readout" not in state and len(state["layers"]) == 2
    state, out = streaming_step(model, sd, state, torch.from_numpy(x[:, 0]))
    assert out.shape == (B, H) and torch.equal(out, state["layers"][-1]["y"])
    with torch.no_grad():
        batch_out, _ = model.eval()(torch.from_numpy(x[:, :1]))
    np.testing.assert_allclose(out.numpy(), batch_out[:, 0].numpy(), rtol=0,
                               atol=1e-6)


def test_ann_streaming_rejects_bidirectional():
    jmodel, variables, _ = jax_ann("LiGRU", bidirectional=True)
    model = port_ann(jmodel, variables, "scan")
    with pytest.raises(ValueError, match="Bidirectional"):
        streaming_init(model, variables_from_flax(variables), 2)
    with pytest.raises(ValueError, match="Bidirectional"):
        streaming_step(model, variables_from_flax(variables), {},
                       torch.zeros(2, 3))
