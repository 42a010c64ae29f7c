"""The port's fused-cell wrappers and CUDA kernels, without JAX.

On the CPU: each wrapper dispatches a CPU tensor to its plain version and
launches nothing, the plain fused cell without the affine is the scan cell,
and the modes of later slices raise.

On a card (tests marked ``cuda``, which skip without one): each CUDA
kernel against its plain version. With V on a dyadic grid the spike trains
must be bit-identical; the readout agrees to rtol 1e-5. This file imports
no JAX, so it runs where the JAX package is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.ops import cells, fused_cells

_ARGS = {
    "lif": ("Wx", "alpha", 1.0, "u0", "s0"),
    "adlif": ("Wx", "alpha", "beta", "a", "b", 1.0, "u0", "w0", "s0"),
    "rlif": ("Wx", "alpha", "V", 1.0, "u0", "s0"),
    "radlif": ("Wx", "alpha", "beta", "a", "b", "V", 1.0, "u0", "w0", "s0"),
}
FORMS = list(_ARGS)


def make_inputs(B, T, H, seed=0):
    """Numpy inputs for every cell: drive, neuron constants (some outside
    their clamp ranges), dyadic V, states with binary s0, affine."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        Wx=rng.uniform(-2.0, 4.0, (B, T, H)).astype(f32),
        alpha=rng.uniform(0.75, 0.99, H).astype(f32),
        beta=rng.uniform(0.95, 1.0, H).astype(f32),
        a=rng.uniform(-1.2, 1.2, H).astype(f32),
        b=rng.uniform(-0.2, 2.2, H).astype(f32),
        V=(np.round(rng.normal(0, 0.3, (H, H)) * 256) / 256).astype(f32),
        u0=rng.uniform(0.0, 1.0, (B, H)).astype(f32),
        w0=rng.uniform(0.0, 1.0, (B, H)).astype(f32),
        s0=(rng.uniform(size=(B, H)) > 0.7).astype(f32),
        scale=rng.uniform(0.5, 2.0, H).astype(f32),
        shift=rng.uniform(-0.5, 0.5, H).astype(f32),
    )


def call(module, suffix, name, d, to, affine=False):
    """``module.<name>_<suffix>`` on the inputs ``d`` converted by ``to``."""
    args = [to(d[a]) if isinstance(a, str) else a for a in _ARGS[name]]
    kw = dict(scale=to(d["scale"]), shift=to(d["shift"])) if affine else {}
    return getattr(module, f"{name}_{suffix}")(*args, **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name", FORMS)
def test_cpu_tensors_take_the_plain_version(name):
    """Without the affine the fused cell is the scan cell, and a CPU
    tensor launches no kernel."""
    d = make_inputs(9, 13, 40, seed=1)
    fused_cells.reset_launch_counts()
    got = call(fused_cells, "fused", name, d, torch.from_numpy)
    want = call(cells, "scan", name, d, torch.from_numpy)
    assert torch.equal(got, want)
    args = [torch.from_numpy(d[a]) for a in ("Wx", "alpha", "u0")]
    fused_cells.readout_fused(*args)
    assert fused_cells.launch_counts() == {"fused_cell_fwd": 0,
                                           "readout_fwd": 0}


def test_unported_modes_raise():
    d = make_inputs(3, 11, 24)
    args = [torch.from_numpy(d[a]) if isinstance(a, str) else a
            for a in _ARGS["radlif"]]
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_cells.radlif_fused(*args, drop_rate=0.1)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_cells.radlif_fused(*args, drop_seed=3)
    with pytest.raises(NotImplementedError, match="bf16"):
        fused_cells.radlif_fused(*args, mxu_bf16=True)
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fused_cells.radlif_fused(*args)
    with torch.no_grad():
        fused_cells.radlif_fused(*args)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        fused_cells.radlif_fused(*meta)


def test_kernel_wrappers_raise_past_their_width():
    """Past the widths the kernels take, the kernel path raises (it is
    never swapped for a plain loop on the card); the checks run before any
    launch, so CPU tensors show it."""
    H = fused_cells._MAX_H + 1
    d = make_inputs(1, 1, H)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    with pytest.raises(ValueError, match=f"H <= {fused_cells._MAX_H}"):
        fused_cells._fused_cell_cuda(
            t["Wx"], None, None, t["alpha"], None, None, None, None, 1.0,
            t["u0"], None, t["s0"], recurrent=False, adaptive=False)
    C = fused_cells._MAX_C + 1
    with pytest.raises(ValueError, match=f"C <= {fused_cells._MAX_C}"):
        fused_cells._readout_cuda(torch.zeros(1, 1, C), torch.zeros(C),
                                  torch.zeros(1, C))
    assert fused_cells.launch_counts() == {"fused_cell_fwd": 0,
                                           "readout_fwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(5, 13, 40), (16, 20, 512), (4, 7, 1000), (2, 5, 2100)]
)
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("name", FORMS)
def test_kernel_matches_plain_on_card(cuda, name, affine, shape):
    """The CUDA kernel's spike trains equal the plain version's, bit for
    bit, at 1, 2, 4 and 8 neurons per thread; the wrapper counts the
    launch."""
    d = make_inputs(*shape, seed=2)
    before = fused_cells.FUSED_CELL_FWD.launches
    got = call(fused_cells, "fused", name, d,
               lambda a: torch.from_numpy(a).to(cuda), affine)
    torch.cuda.synchronize()
    assert fused_cells.FUSED_CELL_FWD.launches == before + 1
    want = call(fused_cells, "fused", name, d, torch.from_numpy, affine)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 13, 5), (128, 100, 35), (3, 9, 70)])
def test_readout_kernel_matches_plain_on_card(cuda, shape):
    d = make_inputs(*shape, seed=3)
    args = [torch.from_numpy(d[a]) for a in ("Wx", "alpha", "u0")]
    before = fused_cells.READOUT_FWD.launches
    got = fused_cells.readout_fused(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert fused_cells.READOUT_FWD.launches == before + 1
    torch.testing.assert_close(got.cpu(), fused_cells.readout_fused(*args),
                               rtol=1e-5, atol=1e-6)
