"""Gradients of the port's fused cells and readout against the JAX Pallas
ops and against torch autograd through the port's own scan cells.

On the CPU the port's ``autograd.Function``s run their plain backward
versions; ``jax.grad`` runs the Pallas backward kernels in interpret mode.
The loss is a weighted sum of the output. V and the initial spikes sit on
dyadic grids, so the forward spike trains of all three are identical and
the gradients differ only by rounding. Tolerance: atol 2e-3, rtol 1e-4,
what the JAX package holds its own kernels to against its scan cells.

The inputs of ``make_inputs`` put some neuron constants outside their
clamp ranges and give V a diagonal: those entries must get a gradient of
exactly 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.ops import pallas_cells
from sparch_tpu_torch.ops import cells, fused_cells

from tests.test_torch_kernels import _ARGS, FORMS, call, make_inputs

ATOL, RTOL = 2e-3, 1e-4
B, T, H = 9, 13, 40
P_DROP, SEED = 0.25, (42, 7)
_LIMS = {"alpha": cells.ALPHA_LIM, "beta": cells.BETA_LIM,
         "a": cells.A_LIM, "b": cells.B_LIM}


def _inputs(name, affine):
    d = make_inputs(B, T, H, seed=4)
    rng = np.random.default_rng(5)
    # s0 need not be 0/1; sixteenths keep s0 @ V exact
    d["s0"] = (np.round(rng.uniform(0, 1, (B, H)) * 16) / 16).astype(
        np.float32)
    keys = [k for k in _ARGS[name] if isinstance(k, str)]
    if affine:
        keys += ["scale", "shift"]
    weights = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    return d, keys, weights


def _port_grads(fn, d, keys):
    t = {k: torch.from_numpy(d[k]).clone().requires_grad_(k in keys)
         for k in d}
    fn(t).backward()
    return {k: t[k].grad.numpy() for k in keys}


def _jax_grads(name, d, keys, weights, affine, kw):
    def loss(vals):
        out = call(pallas_cells, "pallas", name, {**d, **vals}, jnp.asarray,
                   affine, **kw)
        return (out * weights).sum()

    return jax.grad(loss)({k: jnp.asarray(d[k]) for k in keys})


def _assert_close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what}: d{k}")


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("name", FORMS)
def test_cell_gradients_match_pallas_and_scan(name, affine, dropout):
    d, keys, weights = _inputs(name, affine)
    wt = torch.from_numpy(weights)
    seed = torch.tensor(SEED, dtype=torch.int32)
    kw = dict(drop_rate=P_DROP, drop_seed=seed) if dropout else {}

    def fused_loss(t):
        return (call(fused_cells, "fused", name, t, lambda x: x, affine,
                     **kw) * wt).sum()

    def scan_loss(t):
        t = dict(t)
        if affine:
            t["Wx"] = t["scale"] * t["Wx"] + t["shift"]
        out = call(cells, "scan", name, t, lambda x: x)
        if dropout:
            keep = fused_cells.keep_u32(P_DROP)
            mask = torch.stack(
                [fused_cells._keep_rows(B, H, seed, i, keep)
                 for i in range(T)], dim=1)
            out = out * mask * (1.0 / (1.0 - P_DROP))
        return (out * wt).sum()

    got = _port_grads(fused_loss, d, keys)
    jkw = dict(drop_rate=P_DROP,
               drop_seed=jnp.array(SEED, jnp.int32)) if dropout else {}
    _assert_close(got, _jax_grads(name, d, keys, weights, affine, jkw),
                  "vs jax.grad of the Pallas op")
    _assert_close(got, _port_grads(scan_loss, d, keys),
                  "vs autograd through the scan cell")
    assert np.abs(got["Wx"]).max() > 1e-2  # a real gradient
    for k, (lo, hi) in _LIMS.items():
        if k in got:
            outside = (d[k] < lo) | (d[k] > hi)
            assert outside.any() and not outside.all()
            assert (got[k][outside] == 0).all()
            assert (got[k][~outside] != 0).any()
    if "V" in got:
        assert (np.diag(d["V"]) != 0).any()
        assert (np.diag(got["V"]) == 0).all()
        assert (got["V"] != 0).any()


def test_cell_forward_without_grad_saves_nothing():
    d, keys, _ = _inputs("radlif", True)
    t = {k: torch.from_numpy(d[k]).requires_grad_(k in keys) for k in d}
    with torch.no_grad():
        out = call(fused_cells, "fused", "radlif", t, lambda x: x, True)
    assert out.grad_fn is None and not out.requires_grad
    out = call(fused_cells, "fused", "radlif", t, lambda x: x, True)
    assert out.requires_grad
    # a cotangent that is a view (a broadcast, a flipped half) is taken
    g = torch.ones(B, 1, 1).expand(B, T, H)
    assert not g.is_contiguous()
    out.backward(g)
    assert torch.isfinite(t["Wx"].grad).all()
    # the bf16-stream mode runs, and saves nothing without a gradient either
    with torch.no_grad():
        out = call(fused_cells, "fused", "radlif", t, lambda x: x,
                   mxu_bf16=True)
    assert out.dtype == torch.bfloat16 and out.grad_fn is None
    with pytest.raises(ValueError, match="drop_rate"):
        call(fused_cells, "fused", "lif", t, lambda x: x, drop_rate=1.0)


@pytest.mark.parametrize("shape", [(9, 13, 5), (3, 11, 35)])
def test_readout_gradients_match_pallas_and_scan(shape):
    d = make_inputs(*shape, seed=6)
    keys = ["Wx", "alpha", "u0"]
    weights = np.random.default_rng(7).normal(
        0, 1, (shape[0], shape[2])).astype(np.float32)
    wt = torch.from_numpy(weights)

    def loss(fn):
        return lambda t: (fn(*[t[k] for k in keys]) * wt).sum()

    got = _port_grads(loss(fused_cells.readout_fused), d, keys)
    want = jax.grad(lambda v: (pallas_cells.readout_pallas(
        *[v[k] for k in keys]) * weights).sum())(
            {k: jnp.asarray(d[k]) for k in keys})
    _assert_close(got, want, "vs jax.grad of readout_pallas")
    _assert_close(got, _port_grads(loss(cells.readout_sum_scan), d, keys),
                  "vs autograd through readout_sum_scan")
    outside = (d["alpha"] < cells.ALPHA_LIM[0]) | \
        (d["alpha"] > cells.ALPHA_LIM[1])
    assert outside.any() and (got["alpha"][outside] == 0).all()
    assert (got["alpha"][~outside] != 0).any()
