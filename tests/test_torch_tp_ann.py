"""The port's tensor-parallel RNN, LiGRU and GRU cells
(sparch_tpu_torch.ops.fused_tp_ann) against the JAX package's
(sparch_tpu.ops.pallas_tp_ann) on the CPU.

The JAX kernels run as tests/test_pallas_tp_ann.py runs them: jitted
shard_map on the virtual 8-device CPU mesh, TPU interpret mode. Those calls
are dear, so they are few and at P = 2: one forward per cell and one GRU
gradient (the two-exchange forward step and the stacked backward
exchanges). Everything else, P = 4 included, is held against the JAX scan
cells and ``jax.grad`` of them, which the JAX package pins its kernels to
(its LiGRU gradient at P = 4 in interpret mode is a known flake of that
suite, so the port is not held to it). The port runs its plain versions
(CPU tensors) in the one-card form.

Inputs as tests/test_pallas_tp_ann.py makes them: normal input streams,
recurrent matrices orthogonal * 0.5 (the LiGRU's relu candidate stays
bounded), a uniform y0. Bounds are that file's: the forward within 2e-6 of
max(1, |output|), every gradient within 5e-6 of its largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from sparch_tpu.ops import cells as jcells
from sparch_tpu.ops import pallas_tp_ann
from sparch_tpu_torch.ops import fused_tp_ann
from sparch_tpu_torch.parallel import make_mesh

FWD_ATOL = 2e-6  # of max(1, the output's largest magnitude)
GRAD_ATOL = 5e-6  # of the gradient's largest magnitude
N_WX = {"rnn": 1, "ligru": 2, "gru": 3}
SCAN = {"rnn": jcells.rnn_scan, "ligru": jcells.ligru_scan,
        "gru": jcells.gru_scan}
PALLAS = {"rnn": pallas_tp_ann.rnn_tp_pallas,
          "ligru": pallas_tp_ann.ligru_tp_pallas,
          "gru": pallas_tp_ann.gru_tp_pallas}
PORT = {"rnn": fused_tp_ann.rnn_tp, "ligru": fused_tp_ann.ligru_tp,
        "gru": fused_tp_ann.gru_tp}


@pytest.fixture(autouse=True)
def _reset_interpret_state():
    """The interpret mode keeps its simulated devices in process-global
    state (tests/test_pallas_tp_ann.py:21-30)."""
    from jax.experimental.pallas import tpu as pltpu

    pltpu.reset_tpu_interpret_mode_state()
    yield
    pltpu.reset_tpu_interpret_mode_state()


def _inputs(mode, B, T, H, seed):
    """Numpy operands: the input streams, the recurrent matrices, y0 and a
    cotangent R."""
    rng = np.random.default_rng(seed)
    n = N_WX[mode]
    f32 = np.float32
    vs = []
    for _ in range(n):
        q, r = np.linalg.qr(rng.normal(0, 1, (H, H)))
        vs.append((q * np.sign(np.diag(r)) * 0.5).astype(f32))
    return dict(
        wxs=[rng.normal(0, 1, (B, T, H)).astype(f32) for _ in range(n)],
        vs=vs,
        y0=rng.uniform(0, 1, (B, H)).astype(f32),
        R=rng.normal(0, 1, (B, T, H)).astype(f32),
    )


def _args(d):
    return [*d["wxs"], *d["vs"], d["y0"]]


def _pallas_fn(mode, nd):
    """The JAX TP kernel, sharded over an ``nd``-device 'model' mesh, as a
    full-array function of (*wxs, *vs, y0)."""
    devs = jax.devices()
    if len(devs) < nd:
        pytest.skip(f"needs {nd} devices")
    mesh = JaxMesh(np.array(devs[:nd]), ("model",))
    n = N_WX[mode]
    per_shard = functools.partial(PALLAS[mode], axis_name="model",
                                  num_devices=nd)
    return jax.jit(jax.shard_map(
        lambda *a: per_shard(*a), mesh=mesh,
        in_specs=(P(None, None, "model"),) * n + (P(None, "model"),) * n
        + (P(None, "model"),),
        out_specs=P(None, None, "model"), check_vma=False))


def _port(mode, d, nd):
    """The port's output and every gradient of sum(out * R)."""
    args = [torch.from_numpy(a).requires_grad_() for a in _args(d)]
    out = PORT[mode](*args, mesh=make_mesh([torch.device("cpu")] * nd,
                                           model=nd))
    (out * torch.from_numpy(d["R"])).sum().backward()
    return out.detach().numpy(), [a.grad.numpy() for a in args]


def _assert_forward(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL * scale)


def _assert_grads(got, want, mode, what):
    n = N_WX[mode]
    names = [f"wx{i}" for i in range(n)] + [f"v{i}" for i in range(n)] + [
        "y0"]
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL * scale,
                                   err_msg=f"{what}: d{name}")


@pytest.mark.parametrize("mode", ["rnn", "ligru", "gru"])
def test_forward_matches_pallas(mode):
    nd, B, T, H = 2, 8, 12, 256
    d = _inputs(mode, B, T, H, seed=1)
    want = np.asarray(_pallas_fn(mode, nd)(*map(jnp.asarray, _args(d))))
    with torch.no_grad():
        got = PORT[mode](*map(torch.from_numpy, _args(d)),
                         mesh=make_mesh([torch.device("cpu")] * nd,
                                        model=nd)).numpy()
    _assert_forward(got, want)


def test_gru_gradients_match_pallas():
    mode, nd, B, T, H = "gru", 2, 8, 11, 256
    d = _inputs(mode, B, T, H, seed=2)
    fn = _pallas_fn(mode, nd)
    R = jnp.asarray(d["R"])
    args = list(map(jnp.asarray, _args(d)))
    want = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * R),
                            tuple(range(len(args)))))(*args)
    _, got = _port(mode, d, nd)
    _assert_grads(got, want, mode, "gru vs pallas")


@pytest.mark.parametrize("nd,T", [(2, 17), (4, 11)])
@pytest.mark.parametrize("mode", ["rnn", "ligru", "gru"])
def test_cells_match_scan(mode, nd, T):
    B, H = 8, 128 * nd
    d = _inputs(mode, B, T, H, seed=3)
    args = list(map(jnp.asarray, _args(d)))
    R = jnp.asarray(d["R"])
    want = np.asarray(SCAN[mode](*args))
    want_g = jax.grad(lambda *a: jnp.sum(SCAN[mode](*a) * R),
                      tuple(range(len(args))))(*args)
    got, got_g = _port(mode, d, nd)
    _assert_forward(got, want)
    _assert_grads(got_g, want_g, mode, f"{mode} P={nd} vs scan")
