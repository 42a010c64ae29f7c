"""The port's non-spiking cells against the JAX package on the CPU: the
plain loops of ``ops.cells`` (``rnn_scan``, ``ligru_scan``, ``gru_scan``,
``cumulative_softmax``) against the JAX scan cells, and the plain forward of
``ops.fused_ann`` against ``rnn_pallas`` / ``ligru_pallas`` / ``gru_pallas``
in interpret mode.

Inputs come from numpy seeds: a nonzero ``y0``, a prime ``T`` and an ``H``
that is no multiple of 8. Values agree to atol 2e-5, the JAX package's own
bound between its scan cells and its kernels (the products sum in another
order, ``exp`` and ``tanh`` come from another library). Under dropout the
positions that are dropped are equal exactly, at one batch tile (B = 8),
three tiles (B = 24) and a ragged batch (B = 5), because both sides draw
the mask from the same hash of (seed, batch tile, row, column, step)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.ops import cells as jax_cells
from sparch_tpu.ops import pallas_ann
from sparch_tpu_torch.ops import cells, fused_ann

from tests.test_torch_kernels import ANN_MODES, ann_call, make_ann_inputs

B, T, H = 8, 13, 24
ATOL = 2e-5
SEED = (42, 7)


def dropout_kw(p, array):
    """``drop_rate``/``drop_seed`` keywords for either package."""
    return dict(drop_rate=p, drop_seed=array(SEED)) if p else {}


def jax_seed(seed):
    return jnp.array(seed, jnp.int32)


def torch_seed(seed):
    return torch.tensor(seed, dtype=torch.int32)


@pytest.mark.parametrize("mode", ANN_MODES)
def test_scan_cells_match_jax(mode):
    d = make_ann_inputs(mode, B, T, H, seed=11)
    got = ann_call(cells, "scan", mode, d, torch.from_numpy)
    want = ann_call(jax_cells, "scan", mode, d, jnp.asarray)
    assert got.shape == (B, T, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cumulative_softmax_matches_jax(dtype):
    """Summed in float32 whatever the input's type."""
    x = np.random.default_rng(3).normal(0, 2, (B, T, H)).astype(np.float32)
    got = cells.cumulative_softmax(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    want = jax_cells.cumulative_softmax(jnp.asarray(x).astype(dtype))
    assert got.dtype == torch.float32 and got.shape == (B, H)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), np.full(B, T), rtol=1e-5)


@pytest.mark.parametrize("drop_rate", [0.0, 0.25])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_plain_forward_matches_pallas(mode, affine, drop_rate):
    d = make_ann_inputs(mode, B, T, H, seed=3)
    got = ann_call(fused_ann, "fused", mode, d, torch.from_numpy, affine,
                   **dropout_kw(drop_rate, torch_seed)).numpy()
    want = np.asarray(ann_call(pallas_ann, "pallas", mode, d, jnp.asarray,
                               affine, **dropout_kw(drop_rate, jax_seed)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if drop_rate:
        # a gated output is never exactly 0 unless it was dropped (the RNN's
        # sigmoid never, a LiGRU state only if relu and y0 both vanish)
        np.testing.assert_array_equal(got == 0, want == 0)
        assert 0.15 < (got == 0).mean() < 0.35
    else:
        # the affine on load is the same as normalising the stream first
        pre = dict(d)
        if affine:
            pre["wxs"] = [sc * wx + sh for sc, wx, sh in
                          zip(d["scales"], d["wxs"], d["shifts"])]
        scan = ann_call(cells, "scan", mode, pre, torch.from_numpy).numpy()
        np.testing.assert_allclose(got, scan, rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch", [5, 24])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_dropped_positions_match_pallas_across_batch_tiles(mode, batch):
    p = 0.25
    d = make_ann_inputs(mode, batch, T, H, seed=batch)
    got = ann_call(fused_ann, "fused", mode, d, torch.from_numpy, True,
                   **dropout_kw(p, torch_seed)).numpy()
    want = np.asarray(ann_call(pallas_ann, "pallas", mode, d, jnp.asarray,
                               True, **dropout_kw(p, jax_seed)))
    raw = ann_call(fused_ann, "fused", mode, d, torch.from_numpy,
                   True).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # what is kept is the raw output over 1 - p: the recurrence never sees
    # the mask
    kept = got != 0
    np.testing.assert_allclose(got[kept], raw[kept] / (1.0 - p), rtol=1e-6)
    assert 0.15 < 1.0 - kept.mean() < 0.35


def test_no_grad_forward_saves_nothing_and_matches():
    """The serving form (no residuals) gives the training form's output."""
    d = make_ann_inputs("gru", B, T, H, seed=5)
    leaves = []

    def leaf(a):
        leaves.append(torch.from_numpy(a).requires_grad_(True))
        return leaves[-1]

    trained = ann_call(fused_ann, "fused", "gru", d, leaf, True)
    assert trained.grad_fn is not None
    with torch.no_grad():
        served = ann_call(fused_ann, "fused", "gru", d, leaf, True)
    assert served.grad_fn is None
    assert torch.equal(served, trained.detach())
