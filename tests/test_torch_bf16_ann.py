"""The bf16-stream mode (``mxu_bf16=True``) of the port's fused non-spiking
cells (RNN, LiGRU, GRU) against the JAX Pallas kernels in the same mode,
which run in interpret mode on the CPU. On CPU tensors the port runs its
plain versions. Both packages get the same arrays from a numpy seed; bf16
input streams are made with ``ml_dtypes`` and handed to both.

Nothing here is bit-equal: the products sum in another order, ``exp`` and
``tanh`` come from another library, and a float32 value that differs in its
last bits can tip a rounding to bf16 (one ulp, 2^-8 relative) of the output
or of the next product's operand.

- forward: the bf16 output within ``atol`` 2e-2, the JAX package's own
  bound for this mode (against its float32 scan); the dropped positions
  equal exactly. Measured here the two agree far closer, see ``FWD_MEAN``.
- backward, against ``jax.grad`` of the Pallas op: every gradient within
  2e-2 of its largest magnitude; for the LiGRU by the flip-fraction rule of
  the JAX package's own test (the backward masks on the saved ``c > 0``, and
  a candidate within rounding of the relu's kink may fall on either side:
  fewer than 3 % of a stream's elements may differ by more, the rest are
  held). One difference of form is inside the bound: at a time-chunk
  boundary the JAX kernel reads ``y_{t-1}`` from its float32 boundary state,
  the port always from the bf16 series (``y0`` apart).
- types: a bf16 stream gets a bf16 gradient, a float32 stream a float32
  one whose values are bf16 values; dV, dscale, dshift and dy0 are float32.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sparch_tpu.ops import pallas_ann
from sparch_tpu_torch.ops import fused_ann

from tests.test_torch_ann_cells import dropout_kw, jax_seed, torch_seed
from tests.test_torch_kernels import ANN_MODES, ann_call, make_ann_inputs

B, T, H = 8, 13, 24
ATOL = 2e-2
FWD_MEAN = 1e-3  # mean |difference| of the outputs, far inside ATOL
GRAD_REL = 2e-2
KINK_SHARE = 0.03


def _inputs(mode, wx_bf16, seed):
    d = make_ann_inputs(mode, B, T, H, seed=seed)
    if wx_bf16:
        d["wxs"] = [w.astype(ml_dtypes.bfloat16) for w in d["wxs"]]
    return d


def to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a)


def _f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("affine,wx_bf16,drop_rate",
                         [(True, True, 0.25), (True, True, 0.0),
                          (False, False, 0.0)])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_bf16_forward_matches_pallas(mode, affine, wx_bf16, drop_rate):
    d = _inputs(mode, wx_bf16, seed=11)
    got = ann_call(fused_ann, "fused", mode, d, to_torch, affine,
                   mxu_bf16=True, **dropout_kw(drop_rate, torch_seed))
    want = ann_call(pallas_ann, "pallas", mode, d, jnp.asarray, affine,
                    mxu_bf16=True, **dropout_kw(drop_rate, jax_seed))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), _f32(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got - want).mean() <= FWD_MEAN
    if drop_rate:
        np.testing.assert_array_equal(got == 0, want == 0)
        assert 0.15 < (got == 0).mean() < 0.35


@pytest.mark.parametrize("mode", ANN_MODES)
def test_bf16_residuals_are_bf16_and_the_state_is_float32(mode):
    """The residual series of the training form are bf16 streams; the
    carried state is not rounded: the bf16 mode's output differs from the
    float32 mode's by the rounding of the products, not by a step-wise
    rounding of y (which the 2e-2 bound over 13 steps would not survive at
    these gains)."""
    d = make_ann_inputs(mode, B, T, H, seed=11)
    ops = [[torch.from_numpy(a) for a in d[k]]
           for k in ("wxs", "scales", "shifts", "vs")]
    y0 = torch.from_numpy(d["y0"])
    seed = torch.tensor((42, 7), dtype=torch.int32)
    out, y_raw, gates = fused_ann.ann_cell_plain(
        mode, *ops, y0, drop_rate=0.25, seed=seed, save_residuals=True,
        mxu_bf16=True)
    assert out.dtype == y_raw.dtype == torch.bfloat16
    assert len(gates) == len(fused_ann._GATE_SERIES[mode])
    assert all(g.dtype == torch.bfloat16 for g in gates)
    f32 = fused_ann.ann_cell_plain(mode, *ops, y0)
    served = fused_ann.ann_cell_plain(mode, *ops, y0, mxu_bf16=True)
    torch.testing.assert_close(served.float(), f32, rtol=0, atol=ATOL)


def _weights():
    size = B * T * H
    return (np.arange(size, dtype=np.float32) / size).reshape(B, T, H)


def _port_grads(mode, d, affine, drop_rate):
    leaves = {}

    def leaf(a):
        leaves[id(a)] = to_torch(a).clone().requires_grad_(True)
        return leaves[id(a)]

    out = ann_call(fused_ann, "fused", mode, d, leaf, affine, mxu_bf16=True,
                   **dropout_kw(drop_rate, torch_seed))
    (out * torch.from_numpy(_weights())).sum().backward()
    keys = ("wxs", "vs", "scales", "shifts") if affine else ("wxs", "vs")
    grads = {k: [leaves[id(a)].grad for a in d[k]] for k in keys}
    grads["y0"] = [leaves[id(d["y0"])].grad]
    return grads


def _jax_grads(mode, d, affine, drop_rate):
    w = _weights()

    def loss(d):
        out = ann_call(pallas_ann, "pallas", mode, d, jnp.asarray, affine,
                       mxu_bf16=True, **dropout_kw(drop_rate, jax_seed))
        return (out * w).sum()

    g = jax.grad(loss)({k: ([jnp.asarray(a) for a in v]
                            if isinstance(v, list) else jnp.asarray(v))
                        for k, v in d.items()})
    return {**g, "y0": [g["y0"]]}


@pytest.mark.parametrize("affine,wx_bf16,drop_rate",
                         [(True, True, 0.25), (False, False, 0.0)])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_bf16_gradients_match_pallas(mode, affine, wx_bf16, drop_rate):
    d = _inputs(mode, wx_bf16, seed=3)
    got = _port_grads(mode, d, affine, drop_rate)
    want = _jax_grads(mode, d, affine, drop_rate)
    n = 0
    for key, grads in got.items():
        for i, (a, b) in enumerate(zip(grads, want[key])):
            stream = key == "wxs" and wx_bf16
            assert a.dtype == (torch.bfloat16 if stream else torch.float32)
            assert b.dtype == (jnp.bfloat16 if stream else jnp.float32)
            a, b = a.float().numpy(), _f32(b)
            assert a.shape == b.shape
            top = np.abs(b).max()
            assert top > 1e-3, (key, i)  # a gradient that is there
            bad = np.abs(a - b) > GRAD_REL * top
            if mode == "ligru":
                assert bad.mean() < KINK_SHARE, (key, i, bad.mean())
            else:
                assert not bad.any(), (key, i, np.abs(a - b).max() / top)
            n += 1
    assert n == (4 if affine else 2) * fused_ann.MODES[mode] + 1
    if not wx_bf16:
        # a float32 stream gets the kernel's bf16 dWx back in float32
        for g in got["wxs"]:
            assert torch.equal(g, g.bfloat16().float())
