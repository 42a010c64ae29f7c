"""The split and the tile plans of the dV products (csrc/dv_product.cuh),
and an ordered mirror of the spiking product against the JAX package.

The bits of every dV are fixed by which rows each chain of fmaf sums: the
split of B*T (``fused_ann._dv_split``) and the rows of a split
(``_dv_rows_per_split``, the launchers' rounding to 16). Both are pinned
here at the main shapes and at odd ones, beside the C constants they
mirror, so that the bits cannot drift silently. The tile plan of the
product (spiking and not) covers every output element once and gives every
SM of the card a block where the output allows it. On the card the spiking
product equals ``ordered_spike_dv`` (tests/test_torch_kernels.py) bit for
bit; here that
mirror is held against ``jax.grad`` of the JAX Pallas RadLIF cell (in
interpret mode) with a binary s0, within the float32 tolerance of the other
gradient tests (atol 2e-3, rtol 1e-4)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.ops import pallas_cells
from sparch_tpu_torch.ops import fused_ann, fused_cells

from tests.test_torch_kernels import (call, make_inputs, ordered_spike_dv,
                                      spike_dv_plain)

HEADER = (Path(fused_cells.__file__).resolve().parent.parent / "csrc"
          / "dv_product.cuh").read_text()
ATOL, RTOL = 2e-3, 1e-4


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


def _array(name):
    body = re.search(rf"constexpr int {name}\[kDvTiles\] = \{{([^}}]*)\}};",
                     HEADER).group(1)
    return tuple(int(x) for x in body.split(","))


def test_python_mirrors_the_c_constants():
    """The constants the Python plans compute with are the header's."""
    assert _const("kBK") == fused_ann._DV_BK == 16
    assert tuple(zip(_array("kDvTileM"), _array("kDvTileN"))) == \
        fused_ann._DV_TILES
    # the SMs the plan fills are the card's, not a constant
    assert "cudaDevAttrMultiProcessorCount" in HEADER
    assert not re.search(r"constexpr int \w*SMs", HEADER)
    # the launchers' rounding of a split's rows, as _dv_rows_per_split
    assert ("const int rows = (R + ksplit - 1) / ksplit;\n"
            "  return (rows + kBK - 1) / kBK * kBK;") in HEADER


# (B, T, H, gates, ksplit, rows a split): the main shapes (RadLIF 1024 and
# 512, GRU 512 and 1024, LiGRU, RNN), then widths off the tiles, B*T no
# multiple of 16, and splits that end inside a 32-row word
SPLITS = [
    (256, 100, 1024, 1, 1, 25600),
    (128, 100, 512, 1, 4, 3200),
    (128, 100, 512, 3, 1, 12800),
    (128, 100, 1024, 3, 1, 12800),
    (128, 100, 512, 2, 2, 6400),
    (128, 100, 1024, 2, 1, 12800),
    (128, 100, 1024, 1, 1, 12800),
    (16, 20, 200, 1, 3, 112),
    (16, 20, 1001, 1, 1, 320),
    (16, 20, 1001, 3, 1, 320),
    (5, 13, 40, 1, 1, 80),
    (7, 30, 96, 1, 2, 112),
    (9, 37, 300, 2, 3, 112),
    (128, 100, 256, 1, 16, 800),
    (12, 30, 40, 1, 3, 128),
    (4, 20, 4096, 1, 1, 80),
]


@pytest.mark.parametrize("B,T,H,n,ksplit,rows", SPLITS)
def test_split_is_pinned(B, T, H, n, ksplit, rows):
    assert fused_ann._dv_split(B, T, H, n) == ksplit
    assert fused_ann._dv_rows_per_split(B, T, ksplit) == rows
    # every row in exactly one split, the last one possibly short
    assert (ksplit - 1) * rows < B * T <= ksplit * rows


def _covered(H, bm, bn):
    count = np.zeros((H, H), dtype=np.int32)
    for m0 in range(0, H, bm):
        for n0 in range(0, H, bn):
            count[m0:m0 + bm, n0:n0 + bn] += 1
    return count


@pytest.mark.parametrize("H", [40, 200, 256, 512, 1001, 1024, 2048])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_ann_tile_plan_covers_and_fills(H, n):
    """Each ksplit, on a card of 132 SMs (H100 SXM) and of 114 (H100
    PCIe): the chosen tile covers every output element once; where a tile
    gives every SM a block, the chosen one does, and no such tile fills its
    last round of blocks better. n = 1 is the spiking product's plan too."""
    for sms in (132, 114):
        for ksplit in sorted({1, 2, 4, fused_ann._dv_split(128, 100, H, n)}):
            tile = fused_ann._dv_tile(H, n, ksplit, sms)
            bm, bn = fused_ann._DV_TILES[tile]
            assert (_covered(H, bm, bn) == 1).all()

            def blocks(t):
                return n * ksplit * -(-H // t[0]) * -(-H // t[1])

            def fill(t):
                return blocks(t) / (sms * -(-blocks(t) // sms))

            full = [t for t in fused_ann._DV_TILES if blocks(t) >= sms]
            if full:
                assert blocks((bm, bn)) >= sms
                assert fill((bm, bn)) == max(fill(t) for t in full)
            else:
                assert (bm, bn) == fused_ann._DV_TILES[-1]


@pytest.mark.parametrize("H,n,ksplit,tile", [
    (1024, 3, 1, (128, 64)),   # GRU 1024: 384 blocks
    (1024, 2, 1, (128, 64)),   # LiGRU 1024
    (1024, 1, 1, (64, 64)),    # RNN and RadLIF 1024: 256 blocks
    (512, 3, 1, (64, 64)),     # GRU 512: 192 blocks
    (512, 2, 2, (64, 64)),     # LiGRU 512
    (512, 1, 4, (64, 64)),     # RNN and RadLIF 512
    (2048, 3, 1, (128, 128)),  # GRU 2048: 768 blocks
])
def test_ann_tile_plan_at_the_main_shapes(H, n, ksplit, tile):
    assert fused_ann._DV_TILES[fused_ann._dv_tile(H, n, ksplit, 132)] == tile


@pytest.mark.parametrize("B,T,H", [(256, 100, 1024), (128, 100, 512),
                                   (16, 20, 200), (16, 20, 1001),
                                   (4, 20, 4096)])
def test_spiking_tile_and_words(B, T, H):
    """The spiking product runs the one-gate plan: every output element
    once; 256 blocks of 64 x 64 at both RadLIF main shapes (RadLIF 512 in
    four splits), so every SM of an H100 has one. It takes no words of
    spike bits: the dense product forms its left operand from u_seq."""
    assert not hasattr(fused_cells, "_spike_words")
    assert "spike_words" not in HEADER
    ksplit = fused_ann._dv_split(B, T, H, 1)
    bm, bn = fused_ann._DV_TILES[fused_ann._dv_tile(H, 1, ksplit, 132)]
    assert (_covered(H, bm, bn) == 1).all()
    blocks = -(-H // bm) * -(-H // bn) * ksplit
    if (B, T, H) in ((256, 100, 1024), (128, 100, 512)):
        assert (bm, bn) == (64, 64) and blocks == 256


def test_ordered_mirror_sums_in_order():
    """The mirror adds row by row: a later row that cancels an earlier one
    leaves what float32 addition in that order leaves (1e8 + 1 - 1e8 is 0,
    not 1), and split partials are added in ascending order."""
    u = torch.tensor([[[2.0], [2.0], [2.0]]])
    s0 = torch.ones((1, 1))
    dd = torch.tensor([[[1e8], [1.0], [-1e8]]])
    assert float(ordered_spike_dv(u, s0, dd, 1.0)[0, 0]) == 0.0
    assert float(spike_dv_plain(u.double(), s0.double(), dd, 1.0)[0, 0]) \
        == 1.0


@pytest.mark.parametrize("B,T,H", [(9, 13, 40), (12, 30, 40)])
def test_ordered_mirror_matches_jax_dv(B, T, H):
    """RadLIF without the affine, binary s0: the dV of ``jax.grad`` of the
    JAX Pallas cell (V's diagonal masked there) against the mirror over the
    JAX forward's spikes and its dWx (the dDrive the product takes). (12,
    30, 40) splits its 360 rows in three."""
    d = make_inputs(B, T, H, seed=21)
    weights = np.random.default_rng(22).normal(0, 1, (B, T, H)).astype(
        np.float32)

    def loss(vals):
        out = call(pallas_cells, "pallas", "radlif", {**d, **vals},
                   jnp.asarray)
        return (out * weights).sum()

    grads = jax.grad(loss)({k: jnp.asarray(d[k]) for k in ("Wx", "V")})
    spikes = np.array(call(pallas_cells, "pallas", "radlif", d,
                           jnp.asarray))
    mirror = ordered_spike_dv(torch.from_numpy(spikes),
                              torch.from_numpy(d["s0"]),
                              torch.from_numpy(np.array(grads["Wx"])), 0.5)
    mirror = mirror.numpy() * (1.0 - np.eye(H, dtype=np.float32))
    np.testing.assert_allclose(mirror, np.asarray(grads["V"]), atol=ATOL,
                               rtol=RTOL)
