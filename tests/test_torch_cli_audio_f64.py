"""The port's CLI against the JAX CLI on pure tones, both in float64.

``tests/test_torch_cli_audio.py`` holds the two CLIs to rtol 1e-4 in
float32 on WAVs with a noise floor. On the pure tones of
``tests/fixtures.py`` (no floor) its HD ``--frontend host`` flow misses
that bound: after 2 epochs the first layer's weights are 4.7e-5 apart and
its running variances 4.5e-3 apart (3.7x the bound). The JAX CLI run
again with the rows of every batch reversed, which changes only the order
of its sums, parts from itself 3-18x less than that. So a float32 witness
of the JAX package's own spread does not cover the gap. Its cause is the
order of the batch sums: the port's float32 batch variance of the first
step is nearer the float64 value than the JAX package's (7e-5 against
5e-4), since XLA's sums in either row order err alike.

Float64 tells rounding from a fault: a fault in the port stays in
float64, while rounding shrinks by ~2^29. Here both CLIs run that pure-tone
HD flow with the same argv, the same initial weights and the same features
(``fbank_np``, bit for bit). Every parameter, statistic, optimizer moment
and input batch is in float64. The train losses must agree within rtol
1e-8, the accuracies must be equal, and the final weights must agree
within rtol 1e-6 / atol 1e-7. That is 100x tighter than the float32
bound. The measured gaps are <= 2e-7 on running variances of ~4 and 4e-9
on the weights. What is left is of the size of the constants that the
JAX package keeps in float32; its learning rate alone accounts for about
half."""
import numpy as np
import pytest
import torch

import run_exp_torch
from sparch_tpu_torch.convert import variables_from_flax
from sparch_tpu_torch.train.loop import Experiment

from .fixtures import make_hd_tree
from .test_torch_cli import RootMessages, numbers, run_jax


def argv_of(data, folder):
    return ["--dataset_name", "hd", "--data_folder", data,
            "--model_type", "LIF", "--nb_layers", "2", "--nb_hiddens", "16",
            "--batch_size", "4", "--nb_epochs", "2", "--pad_multiple", "20",
            "--frontend", "host", "--state_init", "zeros", "--pdrop", "0",
            "--cell_impl", "scan", "--new_exp_folder", folder]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("tones_f64")
    data = str(root / "hd")
    make_hd_tree(data, n_per_digit=3, digits=(0, 1))
    _, jmsg, init, final = run_jax(argv_of(data, str(root / "jax")),
                                   float64=True)
    with RootMessages() as tmsg:
        texp = Experiment(run_exp_torch.parse_args(
            argv_of(data, str(root / "port"))), device="cpu")
        texp.state.model.load_state_dict(variables_from_flax(init))
        texp.net.double()  # in place: the optimizer keeps its parameters
        put = texp._put_batch
        texp._put_batch = lambda x, y: put(x.double(), y)
        texp.forward()
    return jmsg, final, texp, tmsg


def test_pure_tones_in_float64_match_jax(pair):
    jmsg, jfinal, texp, tmsg = pair
    for pattern, rtol in ((r"Epoch \d+: train loss=.*", 1e-8),
                          (r"Epoch \d+: valid acc=.*", 0.0),
                          (r"Test acc=.*", 0.0)):
        got, want = numbers(tmsg, pattern), numbers(jmsg, pattern)
        assert len(got) == len(want) > 0, pattern
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   err_msg=pattern)
    want = variables_from_flax(jfinal)
    got = texp.state.model.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype == torch.float64, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
