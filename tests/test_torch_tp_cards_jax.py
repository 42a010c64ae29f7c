"""The form across cards of the port's tensor-parallel RadLIF cell against
the JAX package's ``radlif_tp_sharded`` on the virtual 8-device CPU mesh
(``tests/conftest.py``) at P = 2, once: one ``jax.vjp`` of the Pallas TP
kernels in interpret mode, the JAX package's cross-chip form (a rank a
device, remote DMAs between them).

The port runs ``fused_tp.radlif_tp`` with its cell through the rank-by-rank
mirrors of the form across cards (``tp_cell_cards_plain``,
``tp_cell_bwd_cards_plain``), on operands made from one numpy seed; the
tolerances are ``tests/test_torch_tp.py``'s: V on a 1/64 grid and s0 on
sixteenths, so the spikes are equal bit for bit, and every gradient within
5e-5 of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from sparch_tpu.ops import pallas_tp
from sparch_tpu_torch.ops import fused_tp
from sparch_tpu_torch.parallel import make_mesh

from .test_torch_tp import _assert_grads, _inputs

THR = 1.0
NAMES = ("Wx", "alpha", "beta", "a", "b", "V", "u0", "w0", "s0")


@pytest.fixture(autouse=True)
def _reset_interpret_state():
    from jax.experimental.pallas import tpu as pltpu

    pltpu.reset_tpu_interpret_mode_state()
    yield
    pltpu.reset_tpu_interpret_mode_state()


def test_radlif_across_cards_matches_the_jax_sharded_cell(monkeypatch):
    nd, B, T, H = 2, 8, 12, 256
    devs = jax.devices()
    if len(devs) < nd:
        pytest.skip(f"needs {nd} devices")
    d = _inputs(B, T, H, seed=9)
    jmesh = JaxMesh(np.array(devs[:nd]), ("model",))

    def cell(*a):
        return pallas_tp.radlif_tp_sharded(jmesh, *a[:6], THR, *a[6:])

    want, vjp = jax.vjp(cell, *[jnp.asarray(d[k]) for k in NAMES])
    want_g = vjp(jnp.asarray(d["R"]))

    monkeypatch.setattr(fused_tp, "tp_cell_plain",
                        fused_tp.tp_cell_cards_plain)
    monkeypatch.setattr(fused_tp, "tp_cell_bwd_plain",
                        fused_tp.tp_cell_bwd_cards_plain)
    t = {k: torch.from_numpy(d[k]).requires_grad_() for k in NAMES}
    out = fused_tp.radlif_tp(t["Wx"], t["alpha"], t["beta"], t["a"],
                             t["b"], t["V"], THR, t["u0"], t["w0"], t["s0"],
                             mesh=make_mesh([torch.device("cpu")] * nd,
                                            model=nd))
    (out * torch.from_numpy(d["R"])).sum().backward()
    assert np.asarray(want).sum() > 0, "degenerate case: no spikes"
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    _assert_grads({k: t[k].grad.numpy() for k in NAMES},
                  dict(zip(NAMES, want_g)), "radlif across cards vs JAX")
