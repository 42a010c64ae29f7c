"""The bf16-stream mode (``mxu_bf16=True``) of the port's fused spiking
cells against the JAX Pallas kernels in the same mode, which run in
interpret mode on the CPU. On CPU tensors the port runs its plain versions.

Both packages get the same arrays from a numpy seed; a bf16 drive is made
with ``ml_dtypes`` and handed to both. What is exact and what is bounded:

- forward. LIF and adLIF have no product, and with a bf16-exact V (the 2^-8
  grid, ``|k| <= 255``) and an s0 on sixteenths every ``s @ V`` is exact in
  float32 in any order: the bf16 spike streams (dropped or not; a kept
  value is ``bf16(1/(1-p))``) are equal element for element. With a generic
  V and a uniform s0 the sums round by their order and a spike may flip:
  at least 99 % of the elements agree.
- the membrane residual stays float32 and, with a uniform s0, agrees with
  the JAX kernel's to 1e-5: s0 is rounded to bf16 for the first product
  only, a rounded state would show as ~1e-3.
- backward, against ``jax.grad`` of the Pallas op: the two compute the
  same function with the same rounding points, but sum in another order,
  and a float32 sum that differs in its last bit can tip a rounding to
  bf16, one ulp (2^-8 relative) of an element of the dWx stream or of an
  operand of the next product. Every gradient is held to 2^-7 of its
  largest magnitude, one bf16 ulp at the top of its range; the JAX
  package allows 0.1 (0.02 for dWx) between its bf16 mode and float32.
  A bf16 drive gets a bf16 gradient, every other operand a float32 one.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sparch_tpu.ops import pallas_cells
from sparch_tpu_torch.ops import cells, fused_cells

from tests.test_torch_kernels import _ARGS, FORMS, call, make_inputs

B, T, H = 7, 13, 40
P_DROP, SEED = 0.25, (42, 7)
GRAD_REL = 2.0 ** -7


def _inputs(wx_bf16: bool, seed=2):
    d = make_inputs(B, T, H, seed=seed)
    d["V"] = np.clip(d["V"], -255 / 256, 255 / 256)  # exact in bf16
    rng = np.random.default_rng(seed + 1)
    d["s0"] = (np.round(rng.uniform(0, 1, (B, H)) * 16) / 16).astype(
        np.float32)
    if wx_bf16:
        d["Wx"] = d["Wx"].astype(ml_dtypes.bfloat16)
    return d


def to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a)


def _drop(array):
    return dict(drop_rate=P_DROP, drop_seed=array(SEED))


def _f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("affine,wx_bf16", [(True, True), (False, False)])
@pytest.mark.parametrize("name", FORMS)
def test_bf16_forward_matches_pallas(name, affine, wx_bf16, dropout):
    d = _inputs(wx_bf16)
    fused_cells.reset_launch_counts()
    got = call(fused_cells, "fused", name, d, to_torch, affine,
               mxu_bf16=True,
               **(_drop(lambda s: torch.tensor(s, dtype=torch.int32))
                  if dropout else {}))
    want = call(pallas_cells, "pallas", name, d, jnp.asarray, affine,
                mxu_bf16=True,
                **(_drop(lambda s: jnp.array(s, jnp.int32))
                   if dropout else {}))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got = got.float().numpy()
    assert 0.02 < (got != 0).mean() < 0.9  # a real spike train
    np.testing.assert_array_equal(got, _f32(want))
    if dropout:
        kept = float(torch.tensor(1.0 / (1.0 - P_DROP)).bfloat16())
        assert set(np.unique(got)) == {0.0, kept}
    assert not any(fused_cells.launch_counts().values())


@pytest.mark.parametrize("name", FORMS)
def test_bf16_residual_is_float32_and_s0_rounds_for_the_product_only(name):
    """The membrane series of the port's plain forward against the JAX
    kernel's residual stream, with a uniform s0 and a generic V."""
    rng = np.random.default_rng(9)
    d = make_inputs(B, T, H, seed=8)
    d["V"] = rng.normal(0, 0.15, (H, H)).astype(np.float32)
    d["s0"] = rng.uniform(0, 1, (B, H)).astype(np.float32)
    rec, ada = "V" in _ARGS[name], "beta" in _ARGS[name]
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    cm = fused_cells.clip_and_mask(t["alpha"], t["beta"], t["a"], t["b"],
                                   t["V"])
    out, u_seq = fused_cells.fused_cell_plain(
        t["Wx"], t["scale"], t["shift"], *cm, 1.0, t["u0"], t["w0"],
        t["s0"], recurrent=rec, adaptive=ada, save_residuals=True,
        mxu_bf16=True)
    assert out.dtype == torch.bfloat16 and u_seq.dtype == torch.float32
    j = {k: jnp.asarray(v) for k, v in d.items()}
    jcm = pallas_cells._clip_and_mask(j["alpha"], j["beta"], j["a"], j["b"],
                                      j["V"], rec, ada)
    s_j, res = pallas_cells._forward_pallas(
        j["Wx"], j["scale"], j["shift"], *jcm, 1.0, j["u0"], j["w0"],
        j["s0"], jnp.zeros(2, jnp.int32), recurrent=rec, adaptive=ada,
        affine=True, drop_rate=0.0, save_residuals=True, mxu_bf16=True)
    u_j = np.swapaxes(np.asarray(res[0]), 0, 1)[:B, :, :H]  # time-major
    assert res[0].dtype == jnp.float32
    agree = (out.float().numpy() == _f32(s_j)).mean()
    assert agree >= 0.99, agree
    # rows whose spikes agree throughout have the same membrane series
    same = (out.float().numpy() == _f32(s_j)).all(axis=(1, 2))
    assert same.sum() >= B - 2
    np.testing.assert_allclose(u_seq.numpy()[same], u_j[same], atol=1e-5,
                               rtol=1e-5)


def _port_grads(name, d, keys, weights, affine, kw):
    t = {k: to_torch(d[k]).clone().requires_grad_(k in keys) for k in d}
    out = call(fused_cells, "fused", name, t, lambda x: x, affine,
               mxu_bf16=True, **kw)
    (out * torch.from_numpy(weights)).sum().backward()
    return {k: t[k].grad for k in keys}


def _jax_grads(name, d, keys, weights, affine, kw):
    def loss(vals):
        out = call(pallas_cells, "pallas", name, {**d, **vals}, jnp.asarray,
                   affine, mxu_bf16=True, **kw)
        return (out * weights).sum()

    return jax.grad(loss)({k: jnp.asarray(d[k]) for k in keys})


# (without dropout the adaptive forms' bf16 backward takes XLA's CPU compiler
# over a minute in interpret mode; LIF and RLIF cover that switch)
@pytest.mark.parametrize(
    "name,affine,wx_bf16,dropout",
    [(n, True, True, True) for n in FORMS]
    + [(n, False, False, True) for n in FORMS]
    + [(n, True, False, False) for n in ("lif", "rlif")])
def test_bf16_gradients_match_pallas(name, affine, wx_bf16, dropout):
    d = _inputs(wx_bf16, seed=4)
    keys = [k for k in _ARGS[name] if isinstance(k, str)]
    if affine:
        keys += ["scale", "shift"]
    weights = np.random.default_rng(5).normal(0, 1, (B, T, H)).astype(
        np.float32)
    got = _port_grads(
        name, d, keys, weights, affine,
        _drop(lambda s: torch.tensor(s, dtype=torch.int32)) if dropout
        else {})
    want = _jax_grads(
        name, d, keys, weights, affine,
        _drop(lambda s: jnp.array(s, jnp.int32)) if dropout else {})
    for k in keys:
        # each gradient in its operand's type, in both packages
        stream = torch.bfloat16 if (k == "Wx" and wx_bf16) else torch.float32
        assert got[k].dtype == stream, k
        assert want[k].dtype == (jnp.bfloat16 if stream == torch.bfloat16
                                 else jnp.float32), k
        g, w = got[k].float().numpy(), _f32(want[k])
        top = np.abs(w).max()
        assert np.abs(g - w).max() <= GRAD_REL * top, \
            (k, np.abs(g - w).max() / top)
    assert np.abs(_f32(want["Wx"])).max() > 1e-2  # a real gradient
    lims = {"alpha": cells.ALPHA_LIM, "beta": cells.BETA_LIM,
            "a": cells.A_LIM, "b": cells.B_LIM}
    for k, (lo, hi) in lims.items():
        if k in got:  # clamped constants get exactly 0
            outside = (d[k] < lo) | (d[k] > hi)
            assert (got[k].numpy()[outside] == 0).all()
    if "V" in got:
        assert (np.diag(got["V"].numpy()) == 0).all()


def test_bf16_float32_drive_gets_the_rounded_gradient_back_in_float32():
    """With a float32 Wx the kernel's bf16 dWx stream goes back up: the
    gradient is float32 and every value is a bf16 value."""
    d = _inputs(False, seed=4)
    keys = ["Wx", "V"]
    weights = np.ones((B, T, H), np.float32)
    got = _port_grads("radlif", d, keys, weights, False, {})
    assert got["Wx"].dtype == torch.float32
    assert torch.equal(got["Wx"], got["Wx"].bfloat16().float())
    assert got["V"].dtype == torch.float32
    assert not torch.equal(got["V"], got["V"].bfloat16().float())
