"""The port's plain PyTorch cells (sparch_tpu_torch.ops) against
sparch_tpu.ops.cells on the CPU, on the same numpy inputs.

Recurrent cases put V on a grid of 2^-8, so s @ V is exact in any
summation order and the spike trains must be identical."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.ops import cells as jcells
from sparch_tpu.ops import surrogate as jsurrogate
from sparch_tpu_torch.ops import cells, surrogate

from tests.test_torch_kernels import call, make_inputs

SHAPES = [(3, 11, 24), (9, 13, 40)]  # B, T, H: prime T, unaligned B and H


def test_spike_boxcar_forward_and_surrogate():
    x = np.array([-1.0, -0.5, -0.49, -1e-7, 0.0, 1e-7, 0.5, 0.51, 2.0],
                 np.float32)
    xt = torch.tensor(x, requires_grad=True)
    s = surrogate.spike_boxcar(xt)
    (g,) = torch.autograd.grad(s.sum(), xt)
    want_s = jsurrogate.spike_boxcar(jnp.asarray(x))
    want_g = jax.grad(lambda v: jsurrogate.spike_boxcar(v).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want_g))


def test_constants_and_helpers():
    assert cells.ALPHA_LIM == jcells.ALPHA_LIM
    assert cells.BETA_LIM == jcells.BETA_LIM
    assert cells.A_LIM == jcells.A_LIM and cells.B_LIM == jcells.B_LIM
    V = np.random.default_rng(1).normal(size=(6, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        cells.zero_diag(torch.from_numpy(V)).numpy(),
        np.asarray(jcells.zero_diag(jnp.asarray(V))),
    )
    g = torch.Generator().manual_seed(3)
    u = cells.init_state(g, (4, 5), mode="uniform")
    g.manual_seed(3)
    assert torch.equal(u, cells.init_state(g, (4, 5), mode="uniform"))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert not cells.init_state(None, (4, 5), mode="zeros").any()
    with pytest.raises(ValueError):
        cells.init_state(None, (4, 5), mode="normal")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["lif", "adlif", "rlif", "radlif"])
def test_scan_cells_match_jax(name, shape):
    d = make_inputs(*shape)
    got = call(cells, "scan", name, d, torch.from_numpy)
    want = np.asarray(call(jcells, "scan", name, d, jnp.asarray))
    assert 0.02 < want.mean() < 0.9  # a real spike train
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_leaky_cumsum_matches_jax(shape):
    d = make_inputs(*shape)
    alpha = np.clip(d["alpha"], *cells.ALPHA_LIM)
    got = cells.leaky_cumsum(torch.from_numpy(d["Wx"]),
                             torch.from_numpy(alpha), torch.from_numpy(d["u0"]))
    want = jcells.leaky_cumsum(jnp.asarray(d["Wx"]), jnp.asarray(alpha),
                               jnp.asarray(d["u0"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["readout_sum", "readout_sum_scan"])
def test_readouts_match_jax(name, shape):
    d = make_inputs(*shape)
    args = ("Wx", "alpha", "u0")
    got = getattr(cells, name)(*[torch.from_numpy(d[a]) for a in args])
    want = getattr(jcells, name)(*[jnp.asarray(d[a]) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_readout_closed_form_matches_its_scan():
    d = make_inputs(9, 100, 35)
    args = [torch.from_numpy(d[a]) for a in ("Wx", "alpha", "u0")]
    torch.testing.assert_close(cells.readout_sum(*args),
                               cells.readout_sum_scan(*args),
                               rtol=1e-5, atol=1e-5)


def test_port_imports_no_jax():
    """The port, chip_smoke.py and the port's tools never import jax,
    flax or sparch_tpu."""
    code = (
        "import sys\n"
        "import sparch_tpu_torch, sparch_tpu_torch._build, "
        "sparch_tpu_torch.convert, sparch_tpu_torch.models, "
        "sparch_tpu_torch.ops.fused_cells, sparch_tpu_torch.serve, "
        "sparch_tpu_torch.utils.timing, sparch_tpu_torch.migrate, "
        "sparch_tpu_torch.utils.cache, sparch_tpu_torch.utils.profiling, "
        "sparch_tpu_torch.train.loop, run_exp_torch, chip_smoke\n"
        "sys.path.insert(0, 'tools')\n"
        "import import_torch_checkpoint_torch, fuzz_kernels_torch\n"
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'flax', 'sparch_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
