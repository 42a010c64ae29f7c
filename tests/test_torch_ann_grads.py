"""Every operand gradient of the port's fused non-spiking cells
(``ops.fused_ann``: one ``autograd.Function`` over the plain forward and the
plain backward on the CPU) against ``jax.grad`` of the JAX package's Pallas
ops in interpret mode: the per-gate dWx, dscale, dshift, dV/dVz/dVr and dy0,
under a non-uniform cotangent.

Tolerance atol 3e-5 / rtol 1e-4, the JAX package's own bound between its
kernel's and its scan's gradients. The LiGRU's backward masks on the saved
``c > 0``; the inputs are drawn so that no candidate pre-activation lies
within rounding of the kink (checked below), so no element may differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.ops import pallas_ann
from sparch_tpu_torch.ops import fused_ann

from tests.test_torch_ann_cells import (
    B,
    H,
    T,
    dropout_kw,
    jax_seed,
    torch_seed,
)
from tests.test_torch_kernels import ANN_MODES, ann_call, make_ann_inputs

ATOL, RTOL = 3e-5, 1e-4
OPERANDS = ("wxs", "vs", "scales", "shifts")


def _cotangent(shape):
    size = int(np.prod(shape))
    return (np.arange(size, dtype=np.float32) / size).reshape(shape)


def port_grads(mode, d, affine, drop_rate, w):
    """{operand: list of gradients by gate, 'y0': gradient} of
    ``sum(w * fused(...))``."""
    leaves = {}

    def leaf(a):
        leaves[id(a)] = torch.from_numpy(a).clone().requires_grad_(True)
        return leaves[id(a)]

    out = ann_call(fused_ann, "fused", mode, d, leaf, affine,
                   **dropout_kw(drop_rate, torch_seed))
    (out * torch.from_numpy(w)).sum().backward()
    keys = OPERANDS if affine else OPERANDS[:2]
    grads = {k: [leaves[id(a)].grad.numpy() for a in d[k]] for k in keys}
    grads["y0"] = leaves[id(d["y0"])].grad.numpy()
    return grads


def jax_grads(mode, d, affine, drop_rate, w):
    def loss(d):
        out = ann_call(pallas_ann, "pallas", mode, d, jnp.asarray, affine,
                       **dropout_kw(drop_rate, jax_seed))
        return (out * w).sum()

    return jax.tree_util.tree_map(np.asarray, jax.grad(loss)(d))


@pytest.mark.parametrize("drop_rate", [0.0, 0.25])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_every_gradient_matches_jax_grad(mode, affine, drop_rate):
    d = make_ann_inputs(mode, B, T, H, seed=3)
    w = _cotangent((B, T, H))
    got = port_grads(mode, d, affine, drop_rate, w)
    want = jax_grads(mode, d, affine, drop_rate, w)
    n = 0
    for key, g in got.items():
        for i, (a, b) in enumerate(zip(*(([g], [want[key]]) if key == "y0"
                                         else (g, want[key])))):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{mode} d{key}[{i}]")
            assert np.abs(b).max() > 1e-3, (key, i)  # a gradient that is there
            n += 1
    gates = fused_ann.MODES[mode]
    assert n == (4 if affine else 2) * gates + 1
    if not affine:
        # operands that were not passed get no gradient on the JAX side
        # either
        assert all(not np.any(x) for k in OPERANDS[2:] for x in want[k])


def test_ligru_inputs_stay_clear_of_the_relu_kink():
    """The smallest candidate pre-activation of the LiGRU cases above is
    far above float32 rounding, so the saved ``c > 0`` and ``jax.grad``'s
    own mask cannot disagree."""
    d = make_ann_inputs("ligru", B, T, H, seed=3)
    wxs, vs = ([torch.from_numpy(a) for a in d[k]] for k in ("wxs", "vs"))
    y = torch.from_numpy(d["y0"])
    smallest = np.inf
    for affine in (False, True):
        sc = [torch.from_numpy(a) for a in d["scales"]] if affine else None
        sh = [torch.from_numpy(a) for a in d["shifts"]] if affine else None
        out = fused_ann.ann_cell_plain("ligru", wxs, sc, sh, vs, y)
        y_prev = torch.cat([y[:, None], out[:, :-1]], dim=1)
        drive = wxs[0] if not affine else sc[0] * wxs[0] + sh[0]
        pre = drive + torch.matmul(y_prev, vs[0])
        smallest = min(smallest, float(pre.abs().min()))
    assert smallest > 1e-5


@pytest.mark.parametrize("mode", ANN_MODES)
def test_backward_takes_a_strided_cotangent(mode):
    """The bidirectional split hands the backward a view: the gradients
    are those of the contiguous cotangent."""
    d = make_ann_inputs(mode, 4, 5, 8, seed=1)
    w = np.random.default_rng(0).normal(size=(4, 5, 16)).astype(np.float32)
    want = port_grads(mode, d, True, 0.0, np.ascontiguousarray(w[..., ::2]))

    leaves = []

    def leaf(a):
        leaves.append(torch.from_numpy(a).clone().requires_grad_(True))
        return leaves[-1]

    out = ann_call(fused_ann, "fused", mode, d, leaf, True)
    out.backward(torch.from_numpy(w)[..., ::2])
    got = [t.grad.numpy() for t in leaves]
    flat = [g for k in OPERANDS for g in want[k]] + [want["y0"]]
    # ann_call converts the affine pairs first, then the streams and the
    # matrices, then y0
    n = fused_ann.MODES[mode]
    order = flat[2 * n:4 * n] + flat[:2 * n] + [flat[-1]]
    assert len(got) == len(order)
    for a, b in zip(got, order):
        np.testing.assert_array_equal(a, b)
