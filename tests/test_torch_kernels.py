"""The port's fused-cell wrappers and CUDA kernels, without JAX.

On the CPU: each wrapper dispatches a CPU tensor to its plain version and
launches nothing, the plain fused cell without the affine is the scan cell,
and the modes of later slices raise.

On a card (tests marked ``cuda``, which skip without one): each CUDA
kernel against its plain version. With V on a dyadic grid the spike trains,
the membrane series and the dropped outputs must be bit-identical; the
readout agrees to rtol 1e-5; every gradient of the backward kernels agrees
with the plain backward on the same residuals to 1e-4 of that gradient's
largest magnitude, and two launches give the same bits. This file imports
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


def call(module, suffix, name, d, to, affine=False, **kw):
    """``module.<name>_<suffix>`` on the inputs ``d`` converted by ``to``;
    ``kw`` (the dropout arguments) is passed on as it is."""
    args = [to(d[a]) if isinstance(a, str) else a for a in _ARGS[name]]
    if affine:
        kw.update(scale=to(d["scale"]), shift=to(d["shift"]))
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
    assert not any(fused_cells.launch_counts().values())


def test_unported_modes_raise():
    d = make_inputs(3, 11, 24)
    args = [torch.from_numpy(d[a]) if isinstance(a, str) else a
            for a in _ARGS["radlif"]]
    with pytest.raises(NotImplementedError, match="bf16"):
        fused_cells.radlif_fused(*args, mxu_bf16=True)
    with pytest.raises(ValueError, match="two int32"):
        fused_cells.radlif_fused(*args, drop_rate=0.1, drop_seed=3)
    with pytest.raises(ValueError, match="both scale and shift"):
        fused_cells.radlif_fused(*args, scale=torch.ones(24))
    # dropout and gradients are ported: both run on CPU tensors
    fused_cells.radlif_fused(*args, drop_rate=0.1)
    args[0].requires_grad_(True)
    fused_cells.radlif_fused(*args).sum().backward()
    assert args[0].grad is not None
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
    assert not any(fused_cells.launch_counts().values())
    assert set(fused_cells.launch_counts()) == {
        "fused_cell_fwd", "fused_cell_fwd_train", "fused_cell_bwd",
        "readout_fwd", "readout_bwd"}


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


def _clamped(d, dev):
    """The inputs on ``dev`` with the constants clamped and V masked, as
    the kernels and their plain versions take them."""
    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    (t["alpha"], t["beta"], t["a"], t["b"],
     t["V"]) = fused_cells.clip_and_mask(t["alpha"], t["beta"], t["a"],
                                         t["b"], t["V"])
    return t


def _cell_args(t, name, affine):
    rec, ada = "V" in _ARGS[name], "beta" in _ARGS[name]
    args = (t["Wx"], t["scale"] if affine else None,
            t["shift"] if affine else None, t["alpha"],
            t["beta"] if ada else None, t["a"] if ada else None,
            t["b"] if ada else None, t["V"] if rec else None, 1.0, t["u0"],
            t["w0"] if ada else None, t["s0"])
    return args, dict(recurrent=rec, adaptive=ada)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 13, 40), (24, 20, 512), (3, 7, 1000)])
@pytest.mark.parametrize("drop_rate", [0.0, 0.25])
@pytest.mark.parametrize("name", FORMS)
def test_training_forward_matches_plain_on_card(cuda, name, drop_rate, shape):
    """Spikes (dropped or not) and the membrane series, bit for bit."""
    t = _clamped(make_inputs(*shape, seed=4), cuda)
    args, kw = _cell_args(t, name, True)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    kw.update(drop_rate=drop_rate, seed=seed, save_residuals=True)
    before = fused_cells.FUSED_CELL_FWD_TRAIN.launches
    out, u_seq = fused_cells._fused_cell_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert fused_cells.FUSED_CELL_FWD_TRAIN.launches == before + 1
    want_out, want_u = fused_cells.fused_cell_plain(*args, **kw)
    assert torch.equal(out, want_out)
    assert torch.equal(u_seq, want_u)
    if drop_rate:
        raw = fused_cells._fused_cell_cuda(*args, recurrent=kw["recurrent"],
                                           adaptive=kw["adaptive"])
        assert 0.6 < float((out > 0).sum() / raw.sum()) < 0.9


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 13, 40), (24, 20, 512), (3, 7, 1000),
                                   (2, 5, 2100)])
@pytest.mark.parametrize("affine,drop_rate", [(True, 0.25), (False, 0.0)])
@pytest.mark.parametrize("name", FORMS)
def test_backward_kernel_matches_plain_on_card(cuda, name, affine, drop_rate,
                                               shape):
    """Every gradient against the plain backward on the same residuals,
    to 1e-4 of its largest magnitude; two launches give the same bits."""
    d = make_inputs(*shape, seed=5)
    d["s0"] = np.random.default_rng(6).uniform(0, 1, d["s0"].shape).astype(
        np.float32)
    t = _clamped(d, cuda)
    args, kw = _cell_args(t, name, affine)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    kw.update(drop_rate=drop_rate, seed=seed)
    _, u_seq = fused_cells.fused_cell_plain(*args, save_residuals=True, **kw)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, shape).astype(np.float32)).to(cuda)
    Wx, scale, _, alpha, beta, a, b, V, thr, u0, w0, s0 = args
    bargs = (g, Wx, u_seq, scale, alpha, beta, a, b, V, thr, u0, w0, s0)
    before = fused_cells.FUSED_CELL_BWD.launches
    got = fused_cells._fused_cell_bwd_cuda(*bargs, **kw)
    again = fused_cells._fused_cell_bwd_cuda(*bargs, **kw)
    torch.cuda.synchronize()
    assert fused_cells.FUSED_CELL_BWD.launches == before + 2
    want = fused_cells.fused_cell_bwd_plain(*bargs, **kw)
    names = ("dWx", "dscale", "dshift", "dV", "dalpha", "dbeta", "da", "db",
             "du0", "dw0", "ds0")
    for n, x, y, z in zip(names, got, want, again):
        assert (x is None) == (y is None), n
        if x is not None:
            assert torch.equal(x, z), f"{n} differs between two launches"
            assert _rel_err(x, y) <= 1e-4, (n, _rel_err(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 13, 5), (128, 100, 35), (3, 9, 70)])
def test_readout_backward_kernel_matches_plain_on_card(cuda, shape):
    d = make_inputs(*shape, seed=3)
    Wx, alpha, u0 = [torch.from_numpy(d[a]).to(cuda)
                     for a in ("Wx", "alpha", "u0")]
    alpha = fused_cells.clip_and_mask(alpha)[0]
    out, u_seq = fused_cells._readout_cuda(Wx, alpha, u0, save_residuals=True)
    want_out, want_u = fused_cells.readout_plain(Wx, alpha, u0,
                                                 save_residuals=True)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-6)
    assert torch.equal(u_seq, want_u)
    gout = torch.from_numpy(np.random.default_rng(8).normal(
        0, 1, (shape[0], shape[2])).astype(np.float32)).to(cuda)
    before = fused_cells.READOUT_BWD.launches
    got = fused_cells._readout_bwd_cuda(gout, u_seq, alpha, u0)
    again = fused_cells._readout_bwd_cuda(gout, u_seq, alpha, u0)
    torch.cuda.synchronize()
    assert fused_cells.READOUT_BWD.launches == before + 2
    want = fused_cells.readout_bwd_plain(gout, u_seq, alpha, u0)
    for n, x, y, z in zip(("dWx", "dalpha", "du0"), got, want, again):
        assert torch.equal(x, z), n
        assert _rel_err(x, y) <= 1e-4, (n, _rel_err(x, y))


@pytest.mark.cuda
def test_autograd_reaches_the_kernels_on_card(cuda):
    """A CUDA tensor that needs a gradient goes through the training
    forward and the backward kernel, and never the plain versions."""
    d = make_inputs(8, 13, 40, seed=9)
    t = {k: torch.from_numpy(v).to(cuda).requires_grad_(True)
         for k, v in d.items()}
    fused_cells.reset_launch_counts()
    out = call(fused_cells, "fused", "radlif", t, lambda x: x, True,
               drop_rate=0.1, drop_seed=[1, 2])
    ro = fused_cells.readout_fused(out[:, :, :5].contiguous(),
                                   t["alpha"][:5],
                                   t["u0"][:, :5].contiguous())
    ro.sum().backward()
    torch.cuda.synchronize()
    assert fused_cells.launch_counts() == {
        "fused_cell_fwd": 0, "fused_cell_fwd_train": 1, "fused_cell_bwd": 1,
        "readout_fwd": 1, "readout_bwd": 1}
    for k in ("Wx", "scale", "shift", "alpha", "beta", "a", "b", "V", "u0",
              "w0", "s0"):
        assert torch.isfinite(t[k].grad).all(), k
    assert float(torch.diagonal(t["V"].grad).abs().max()) == 0.0
