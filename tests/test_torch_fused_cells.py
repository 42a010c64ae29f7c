"""The port's fused cells (sparch_tpu_torch.ops.fused_cells) against the
JAX Pallas kernels, which run in interpret mode on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; those are
held here against pallas_cells.*_pallas with identical spike trains (V on a
dyadic grid) and the readout to rtol 1e-5. B and H are not multiples of
the TPU tile (8, 128) and T is prime, so the JAX kernel pads and runs a
tail chunk: the port's output must show no phantom spikes from either.
The CUDA kernels are held against the same plain versions in
tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.ops import pallas_cells
from sparch_tpu_torch.ops import fused_cells

from tests.test_torch_kernels import FORMS, call, make_inputs


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("name", FORMS)
def test_plain_fused_cell_matches_pallas(name, affine):
    # both shapes are unaligned; the affine cases take the larger one
    d = make_inputs(*((9, 13, 40) if affine else (3, 11, 24)))
    fused_cells.reset_launch_counts()
    got = call(fused_cells, "fused", name, d, torch.from_numpy, affine)
    want = np.asarray(call(pallas_cells, "pallas", name, d, jnp.asarray,
                           affine))
    assert got.shape == want.shape
    assert 0.02 < want.mean() < 0.9  # a real spike train
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors take the plain version: no kernel was launched
    assert not any(fused_cells.launch_counts().values())


# the last past the port's lane layout (256 classes): the TPU kernel pads
# it to 384 lanes, the port's kernels run their wide forms on it
@pytest.mark.parametrize("shape", [(3, 11, 24), (9, 13, 40), (2, 5, 300)])
def test_plain_readout_matches_pallas(shape):
    d = make_inputs(*shape)
    args = ("Wx", "alpha", "u0")
    got = fused_cells.readout_fused(*[torch.from_numpy(d[a]) for a in args])
    want = pallas_cells.readout_pallas(*[jnp.asarray(d[a]) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert fused_cells.READOUT_FWD.launches == 0
