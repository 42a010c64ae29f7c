"""The port's dropout hash and dropped forward outputs against the JAX
Pallas kernels in interpret mode, bit for bit.

``random_keep_plain`` is held against the hash branch of
``pallas_cells._random_keep``; the dropped output of each fused cell against
``*_pallas(..., drop_rate=p, drop_seed=seed)`` at one batch tile (B=8),
three tiles of 8 (B=24) and a ragged batch (B=5). V sits on a dyadic grid,
so the spike trains are identical and what is compared is the mask and the
kept value ``float32(1/(1-p))``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.ops import pallas_cells
from sparch_tpu_torch.ops import fused_cells

from tests.test_torch_kernels import FORMS, call, make_inputs


@pytest.mark.parametrize(
    "shape,seed,tile_i,t,p",
    [((8, 40), (42, 7), 0, 0, 0.1), ((8, 128), (123456789, 2**31 - 2), 2, 99,
                                     0.5),
     ((128, 24), (0, 0), 5, 13, 0.25), ((16, 7), (2**31 - 2, 1), 1, 3, 0.9)],
)
def test_random_keep_matches_jax_hash(shape, seed, tile_i, t, p):
    keep = fused_cells.keep_u32(p)
    assert keep == pallas_cells._keep_u32(p)
    got = fused_cells.random_keep_plain(
        shape, torch.tensor(seed, dtype=torch.int32), tile_i, t, keep)
    want = pallas_cells._random_keep(
        shape, jnp.int32(seed[0]), jnp.int32(seed[1]), jnp.int32(tile_i), t,
        keep, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.bool


def test_keep_share_and_tile_rows():
    keep = fused_cells.keep_u32(0.1)
    mask = fused_cells.random_keep_plain(
        (128, 512), torch.tensor([3, 4], dtype=torch.int32), 0, 5, keep)
    assert abs(float(mask.float().mean()) - 0.9) < 0.005
    assert fused_cells.keep_u32(0.0) == 2**32 - 1
    rows = {5: 8, 8: 8, 24: 8, 48: 16, 96: 32, 128: 128, 200: 8, 256: 128}
    for B, want in rows.items():
        assert fused_cells.dropout_tile_rows(B) == want
        assert pallas_cells._tile_plan(-(-B // 8) * 8, 128, streams=4) == want


@pytest.mark.parametrize("B", [8, 24, 5])
@pytest.mark.parametrize("name", FORMS)
def test_dropped_forward_matches_pallas(name, B):
    p, seed = 0.25, (42, 7)
    d = make_inputs(B, 13, 40, seed=B)
    got = call(fused_cells, "fused", name, d, torch.from_numpy, True,
               drop_rate=p, drop_seed=torch.tensor(seed, dtype=torch.int32))
    want = np.asarray(call(pallas_cells, "pallas", name, d, jnp.asarray,
                           True, drop_rate=p,
                           drop_seed=jnp.array(seed, jnp.int32)))
    raw = call(fused_cells, "fused", name, d, torch.from_numpy, True).numpy()
    np.testing.assert_array_equal(got.numpy(), want)
    # only kept spikes survive, scaled by float32(1/(1-p)); some are dropped
    kept = np.float32(1.0 / (1.0 - p))
    assert set(np.unique(got.numpy())) == {np.float32(0.0), kept}
    assert 0.6 < (got.numpy() > 0).sum() / raw.sum() < 0.9
    # the seed matters, and a list of two ints is taken as a seed too
    other = call(fused_cells, "fused", name, d, torch.from_numpy, True,
                 drop_rate=p, drop_seed=[43, 7])
    assert not torch.equal(other, got)
