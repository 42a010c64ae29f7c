"""The port's sequence pipeline (``parallel/seqpipe.py``) against the port's
own single-device ``scan`` step on the CPU, at the JAX test's shapes (B, T,
F, H, C = 8, 24, 12, 16, 5) with the stages ``[torch.device("cpu")] * S``.
That step is held to the JAX package elsewhere; three cases against the
JAX pipeline itself are in ``test_torch_seqpipe_jax.py``.

- The matrix (``CASES``): the eight model types, the three norms,
  bidirectional SNN and ANN, ``model = 2``, ``compute_dtype=bfloat16``, S
  in {2, 4} and M in {1, 2, 4}, the default recipe (dropout 0.1, uniform
  states: the pipeline draws the noise the scan step draws from the same
  generator state). Loss rtol 1e-5 (ANN 2e-4), the weights after one Adam
  step atol 2e-5 (ANN 5e-5), running statistics atol 1e-5; the bf16 cases
  at ``tests/test_seqpipe.py``'s bf16 tolerances on the gradients (Adam's
  first moment).
- The eval step and the inference forward against ``make_eval_step`` and
  the model's forward.
- ``draw_noise``: shapes, distribution, and one step's result for any S
  and M; the refusals; ``Predictor(mesh=...)`` against the single-device
  Predictor; ``--seq_parallel 2`` through ``run_exp_torch.main`` against
  ``--seq_parallel 1``, its ragged last batch on the ordinary step.
"""
import copy

import numpy as np
import pytest
import torch

import run_exp_torch
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.parallel import (
    draw_noise,
    make_mesh,
    make_seq_mesh,
    make_seqpipe_eval_step,
    make_seqpipe_predict,
    make_seqpipe_train_step,
)
from sparch_tpu_torch.serve import Predictor
from sparch_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from sparch_tpu_torch.train.loop import Experiment

from .fixtures import make_shd_h5

B, T, F, H, C = 8, 24, 12, 16, 5
CPU = torch.device("cpu")
LR = 1e-2


def lively(model):
    """Norm gains of 4 and biases of 1/2 (weights x 8 without a norm), so
    that every spiking layer fires."""
    with torch.no_grad():
        for layer in model.hidden_layers():
            for name, mod in layer.named_children():
                if getattr(mod, "kind", None) in ("batchnorm", "layernorm"):
                    mod.weight.fill_(4.0)
                    mod.bias.fill_(0.5)
                elif model.normalization == "none" and name.startswith("W"):
                    mod.weight.mul_(8.0)
    return model


def make_case(model_type, norm="batchnorm", bidir=False, dropout=0.0,
              init="zeros", dtype=None, sizes=(H, H, C), seed=0):
    model = build_model(model_type, (B, T, F), list(sizes), dropout=dropout,
                        normalization=norm, bidirectional=bidir,
                        state_init=init, cell_impl="scan",
                        compute_dtype=dtype,
                        generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.random((B, T, F)) < 0.3).astype(np.float32))
    y = torch.arange(B) % C
    return lively(model), x, y


def states(model, seed=3):
    """A fresh state of ``model`` and of a copy of it, one seed."""
    twin = copy.deepcopy(model)
    return (create_train_state(model, LR, device="cpu", seed=seed),
            create_train_state(twin, LR, device="cpu", seed=seed))


# (model type, norm, bidirectional, S, M, model axis, dropout, init, dtype)
CASES = [
    ("LIF", "batchnorm", False, 4, 2, 1, 0.0, "zeros", None),
    ("LIF", "layernorm", False, 4, 2, 1, 0.0, "zeros", None),
    ("LIF", "none", False, 2, 1, 1, 0.0, "zeros", None),
    ("RadLIF", "batchnorm", False, 4, 2, 1, 0.0, "zeros", None),
    ("RadLIF", "layernorm", False, 2, 4, 1, 0.0, "zeros", None),
    ("RadLIF", "none", False, 4, 4, 1, 0.0, "zeros", None),
    ("adLIF", "batchnorm", False, 2, 2, 1, 0.0, "zeros", None),
    ("RLIF", "batchnorm", False, 4, 1, 1, 0.0, "zeros", None),
    ("MLP", "batchnorm", False, 4, 2, 1, 0.0, "zeros", None),
    ("RNN", "batchnorm", False, 4, 2, 1, 0.0, "zeros", None),
    ("LiGRU", "layernorm", False, 2, 4, 1, 0.0, "zeros", None),
    ("GRU", "batchnorm", False, 4, 2, 1, 0.0, "zeros", None),
    ("LIF", "batchnorm", True, 4, 2, 1, 0.0, "zeros", None),
    ("RadLIF", "layernorm", True, 2, 2, 1, 0.0, "zeros", None),
    ("RNN", "none", True, 4, 2, 1, 0.0, "zeros", None),
    ("LiGRU", "batchnorm", True, 2, 1, 1, 0.0, "zeros", None),
    ("RadLIF", "batchnorm", False, 2, 2, 2, 0.0, "zeros", None),
    ("GRU", "layernorm", False, 2, 2, 2, 0.0, "zeros", None),
    ("RadLIF", "batchnorm", True, 4, 2, 1, 0.1, "uniform", None),
    ("LIF", "none", False, 2, 4, 1, 0.1, "uniform", None),
    ("GRU", "batchnorm", False, 2, 2, 1, 0.1, "zeros", None),
    ("RadLIF", "none", False, 4, 2, 1, 0.0, "zeros", torch.bfloat16),
    ("RadLIF", "batchnorm", False, 2, 2, 1, 0.1, "uniform", torch.bfloat16),
    ("LiGRU", "batchnorm", False, 4, 2, 1, 0.0, "zeros", torch.bfloat16),
    ("GRU", "none", True, 2, 4, 1, 0.0, "zeros", torch.bfloat16),
]


def _id(case):
    mt, norm, bidir, S, M, P, p, init, dt = case
    return (f"{mt}-{norm}{'-bidir' if bidir else ''}-S{S}M{M}"
            f"{f'P{P}' if P > 1 else ''}{'-recipe' if p else ''}"
            f"{'-bf16' if dt else ''}")


def exp_avg(state):
    """Adam's first moments after step 1: (1 - 0.9) x the gradients."""
    return [state.optimizer.state[p]["exp_avg"].double()
            for p in state.model.parameters()]


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_pipelined_step_matches_the_scan_step(case):
    mt, norm, bidir, S, M, P, p, init, dt = case
    model, x, y = make_case(mt, norm, bidir, p, init, dt)
    ref, pipe = states(model)
    ref, want = make_train_step(ref.model, use_regularizers=True)(ref, x, y)
    mesh = make_seq_mesh([CPU] * (S * P), model=P)
    assert mesh.shape == {"data": 1, "seq": S, "model": P}
    pipe, got = make_seqpipe_train_step(pipe.model, mesh, n_micro=M,
                                        use_regularizers=True)(pipe, x, y)
    assert pipe.step == 1
    snn = model.is_snn
    if snn:
        assert float(want["spike_rate"]) > 0.0
    if dt is not None:
        # bf16: the recurrent products sum their gradients in float32 here
        # (the JAX chunk's rec_dot), in bf16 in the scan cell
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=4e-3)
        flipped = abs(float(got["loss"]) - float(want["loss"])) > \
            1e-5 * max(1.0, abs(float(want["loss"])))
        factor = 0.15 if flipped else 0.025
        for a, b in zip(exp_avg(ref), exp_avg(pipe)):
            tol = max(factor * float(a.abs().max()), 1e-3)
            np.testing.assert_allclose(b, a, atol=tol)
        for a, b in zip(ref.model.buffers(), pipe.model.buffers()):
            a = a.double()
            np.testing.assert_allclose(
                b.double(), a, atol=5e-3 * max(1.0, float(a.abs().max())))
        return
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5 if snn else 2e-4)
    if snn:
        assert float(got["acc"]) == float(want["acc"])
    np.testing.assert_allclose(float(got["spike_rate"]),
                               float(want["spike_rate"]), rtol=1e-5)
    got_sd, want_sd = pipe.model.state_dict(), ref.model.state_dict()
    for k, v in want_sd.items():
        atol = 1e-5 if "running" in k else (2e-5 if snn else 5e-5)
        np.testing.assert_allclose(got_sd[k], v, atol=atol, err_msg=k)


@pytest.mark.parametrize("bidir", [False, True], ids=["udir", "bidir"])
def test_eval_step_and_predict_match_the_model(bidir):
    """After one train step (non-trivial running statistics), the pipelined
    eval step and inference forward against ``make_eval_step`` and the
    model's eval forward, uniform states drawn from generators of one
    seed."""
    model, x, y = make_case("RadLIF", "batchnorm", bidir, 0.1, "uniform")
    state = create_train_state(model, LR, device="cpu", seed=1)
    state, _ = make_train_step(model)(state, x, y)
    mesh = make_seq_mesh([CPU] * 4)
    want = make_eval_step(model)(state, x, y, torch.Generator().manual_seed(5))
    got = make_seqpipe_eval_step(model, mesh, n_micro=2)(
        state, x, y, torch.Generator().manual_seed(5))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    with torch.no_grad():
        out, _ = model.eval()(x, torch.Generator().manual_seed(6))
    pred = make_seqpipe_predict(model, mesh, n_micro=4)(
        x, torch.Generator().manual_seed(6))
    np.testing.assert_allclose(pred, out, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="generator"):
        make_seqpipe_eval_step(model, mesh)(state, x, y)


def test_draw_noise_shapes_and_distribution():
    """Scaled keep masks in {0, 1/(1-p)} with a keep share near 1-p, layers
    independent; uniform states in [0, 1), w drawn only with adaptation;
    eval draws no mask; the bidirectional layout."""
    Bn, Tn = 64, 50
    model = build_model("RadLIF", (Bn, Tn, F), [H, H, C], dropout=0.25,
                        state_init="uniform", cell_impl="scan")
    g = torch.Generator().manual_seed(0)
    noise = draw_noise(model, g, (Bn, Tn, F))
    m0, m1 = noise["layer_0"]["mask"], noise["layer_1"]["mask"]
    assert m0.shape == (Bn, Tn, H)
    np.testing.assert_allclose(torch.unique(m0), [0.0, 1.0 / 0.75],
                               rtol=1e-6)
    assert abs(float((m0 > 0).float().mean()) - 0.75) < 0.02
    assert not torch.equal(m0 > 0, m1 > 0)
    u0, w0, s0 = noise["layer_0"]["states"]
    assert u0.shape == (Bn, H) and 0 <= u0.min() and u0.max() < 1
    assert u0.std() > 0.2 and w0.std() > 0.2 and s0.std() > 0.2
    ur = noise["readout"]["u0"]
    assert ur.shape == (Bn, C) and ur.std() > 0.2
    ev = draw_noise(model, g, (Bn, Tn, F), train=False)
    assert "mask" not in ev["layer_0"] and "states" in ev["layer_0"]
    lif = build_model("LIF", (Bn, Tn, F), [H, C], state_init="uniform",
                      bidirectional=True, dropout=0.1)
    bid = draw_noise(lif, g, (Bn, Tn, F))
    assert bid["layer_0"]["mask"].shape == (Bn, Tn, 2 * H)
    u0, w0, s0 = bid["layer_0"]["states"]
    assert u0.shape == (2, Bn, H) and not w0.any() and s0.std() > 0.2
    # an ANN draws masks only; no noise at all without dropout
    gru = build_model("GRU", (Bn, Tn, F), [H, C], dropout=0.1)
    assert set(draw_noise(gru, g, (Bn, Tn, F))) == {"layer_0"}
    assert draw_noise(gru, g, (Bn, Tn, F), train=False) == {}


def test_noise_and_result_do_not_depend_on_s_and_m():
    """The same generator state gives the same noise and the same step at
    (S, M) = (2, 1), (4, 4) and (8, 2)."""
    model, x, y = make_case("RadLIF", "batchnorm", False, 0.1, "uniform")
    runs = []
    for S, M in ((2, 1), (4, 4), (8, 2)):
        state = create_train_state(copy.deepcopy(model), LR, device="cpu",
                                   seed=4)
        noise = draw_noise(model, torch.Generator().manual_seed(4), x.shape)
        state, met = make_seqpipe_train_step(
            state.model, make_seq_mesh([CPU] * S), n_micro=M)(state, x, y)
        runs.append((noise, float(met["loss"]), state.model.state_dict()))
    for noise, loss, sd in runs[1:]:
        for i in range(2):
            assert torch.equal(noise[f"layer_{i}"]["mask"],
                               runs[0][0][f"layer_{i}"]["mask"])
        np.testing.assert_allclose(loss, runs[0][1], rtol=1e-6)
        for k, v in runs[0][2].items():
            np.testing.assert_allclose(sd[k], v, atol=1e-5, err_msg=k)


def test_refusals():
    lif = build_model("LIF", (B, T, F), [H, C], state_init="zeros",
                      use_readout_layer=False)
    mesh = make_seq_mesh([CPU] * 2)
    with pytest.raises(ValueError, match="readout"):
        make_seqpipe_train_step(lif, mesh)
    odd = build_model("LIF", (B, T, F), [H + 1, C], state_init="zeros")
    with pytest.raises(ValueError, match="divisible by the 'model'"):
        make_seqpipe_train_step(odd, make_seq_mesh([CPU] * 4, model=2))
    model, x, y = make_case("LIF")
    state = create_train_state(model, LR, device="cpu")
    with pytest.raises(ValueError, match="not divisible by microbatches 3"):
        make_seqpipe_train_step(model, mesh, n_micro=3)(state, x, y)
    with pytest.raises(ValueError, match="seq axis"):
        make_seqpipe_train_step(model, make_seq_mesh([CPU] * 5))(state, x, y)
    with pytest.raises(NotImplementedError, match="item 7b"):
        make_seq_mesh([CPU, torch.device("cuda", 1)])
    with pytest.raises(ValueError, match="seq="):
        make_seq_mesh([CPU] * 3, seq=2)
    with pytest.raises(NotImplementedError, match="processes"):
        make_seq_mesh([CPU] * 2, data=2)
    if not torch.cuda.is_available():
        # the default mesh is the card's: none here, and no quiet CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_seq_mesh(seq=2)


@pytest.mark.parametrize("argv,message", [
    (["--remat", "true"], "--remat has no effect"),
    (["--frontend", "device", "--dataset_name", "sc"], "--frontend host"),
    (["--cell_impl", "pallas_tp", "--mesh_model", "2"], "does not compose"),
], ids=["remat", "frontend", "pallas_tp"])
def test_the_loop_refuses_as_the_jax_loop(tmp_path, argv, message):
    exp = str(tmp_path / "exp")
    args = run_exp_torch.parse_args(argv + ["--seq_parallel", "2",
                                            "--new_exp_folder", exp])
    with pytest.raises(ValueError, match=message):
        Experiment(args, device="cpu")
    assert not (tmp_path / "exp").exists()


def test_predictor_with_a_seq_mesh_serves_as_the_one_device_predictor():
    """n = 9 rows, batch 4 (the last chunk padded), a bidirectional RadLIF
    with uniform states: the same probabilities through the pipeline."""
    model, _, _ = make_case("RadLIF", "batchnorm", True, 0.1, "uniform")
    sd = model.state_dict()
    x = (np.random.default_rng(7).random((9, T, F)) < 0.3).astype(np.float32)
    want = Predictor(copy.deepcopy(model), sd, batch_size=4, seed=2,
                     device="cpu")(x)
    mesh = make_seq_mesh(devices=[CPU] * 2, seq=2)
    pred = Predictor(model, sd, batch_size=4, seed=2, device="cpu",
                     mesh=mesh, n_micro=2)
    labels, probs = pred(x)
    np.testing.assert_array_equal(labels, want[0])
    np.testing.assert_allclose(probs, want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(probs.sum(-1), np.ones(9), rtol=1e-6)
    with pytest.raises(ValueError, match="not divisible by the mesh's seq"):
        pred(x[:, :T - 1])
    with pytest.raises(ValueError, match="n_micro"):
        Predictor(model, sd, batch_size=6, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="no 'seq' axis"):
        Predictor(model, sd, device="cpu", mesh=make_mesh([CPU]))


def test_seq_parallel_through_the_cli(tmp_path):
    """LIF, the default recipe (dropout 0.1, uniform states), batches of 8
    over 21 utterances: the ragged batch of 5 takes the ordinary step, the
    rest the pipeline; every epoch's loss as at ``--seq_parallel 1``."""
    d = str(tmp_path)
    make_shd_h5(f"{d}/shd_train.h5", n=21, nb_classes=4, seed=0,
                noise_frac=0.3)
    make_shd_h5(f"{d}/shd_test.h5", n=16, nb_classes=4, seed=1,
                noise_frac=0.3)
    argv = ["--dataset_name", "shd", "--data_folder", d, "--batch_size", "8",
            "--nb_hiddens", "16", "--nb_layers", "2", "--nb_epochs", "2",
            "--nb_steps", "20"]
    one = run_exp_torch.main(argv + ["--new_exp_folder", f"{d}/s1"],
                             device="cpu")
    two = run_exp_torch.main(argv + ["--seq_parallel", "2",
                                     "--seq_microbatches", "2",
                                     "--new_exp_folder", f"{d}/s2"],
                             device="cpu")
    assert two.seq_mesh.shape == {"data": 1, "seq": 2, "model": 1}
    assert one.seq_mesh is None
    assert [h["split"] for h in two.history] == \
        ["train", "valid", "train", "valid", "test"]
    for a, b in zip(one.history, two.history):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5,
                                   err_msg=a["split"])
        paths = {"seqpipe": 2, "ordinary": 1 if a["split"] == "train" else 0}
        assert b["steps_by_path"] == paths
        assert "steps_by_path" not in a
    assert any(h["rate"] > 0 for h in two.history)
