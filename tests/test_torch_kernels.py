"""The port's fused-cell wrappers and CUDA kernels, without JAX.

On the CPU: each wrapper dispatches a CPU tensor to its plain version and
launches nothing, the plain fused cell without the affine is the scan cell,
and the modes of later slices raise.

On a card (tests marked ``cuda``, which skip without one): each CUDA
kernel against its plain version. With V on a dyadic grid the spike trains,
the membrane series and the dropped outputs must be bit-identical; the
readout agrees to rtol 1e-5; every gradient of the backward kernels agrees
with the plain backward on the same residuals to 1e-4 of that gradient's
largest magnitude, and two launches give the same bits. The ANN kernels
(RNN, LiGRU, GRU) sum their dense products in another order than the plain
version's matmul and take exp and tanh from the card's library, so nothing
there is bit-equal: outputs and residuals agree to atol 2e-5, gradients to
1e-4 of their largest magnitude. This file imports no JAX, so it runs where
the JAX package is not installed. The bf16-stream forms (``mxu_bf16=True``)
are held at the end of the file: the spiking forward bit for bit, the rest
within bounds stated there.

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.ops import cells, fused_ann, fused_cells

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
    # the bf16-stream mode is ported: it runs on CPU tensors, with a
    # float32 and with a bf16 drive, and gives bf16 spikes
    assert fused_cells.radlif_fused(*args, mxu_bf16=True).dtype == \
        torch.bfloat16
    half = [args[0].bfloat16()] + args[1:]
    assert fused_cells.radlif_fused(*half, mxu_bf16=True).dtype == \
        torch.bfloat16
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
    cell = {"fused_cell_fwd", "fused_cell_fwd_train", "fused_cell_bwd"}
    ann = {f"fused_ann_{d}_{m}" for d in ("fwd", "bwd") for m in ANN_MODES}
    tp_cells = {"tp_cell_fwd", "tp_cell_bwd", "tp_ann_fwd", "tp_ann_bwd"}
    tp = {"tp_all_gather", "tp_reduce_scatter"} | tp_cells
    assert set(fused_cells.launch_counts()) == (
        cell | ann | tp | {"readout_fwd", "readout_bwd"}
        | {f"{k}_bf16" for k in cell | ann | tp_cells})


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
    want = {k: 0 for k in fused_cells.launch_counts()}
    want.update(fused_cell_fwd_train=1, fused_cell_bwd=1, readout_fwd=1,
                readout_bwd=1)
    assert fused_cells.launch_counts() == want
    for k in ("Wx", "scale", "shift", "alpha", "beta", "a", "b", "V", "u0",
              "w0", "s0"):
        assert torch.isfinite(t[k].grad).all(), k
    assert float(torch.diagonal(t["V"].grad).abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The non-spiking cells (ops/fused_ann.py)
# ---------------------------------------------------------------------------

ANN_MODES = list(fused_ann.MODES)
# (5, 6, 512): a partial cluster with resident slices (the float32 RNN,
# every bf16 forward); (130, 6, 1001): 17 clusters, the last of two rows,
# streamed slices; (5, 3, 2048): the widest layer, four rows a cluster in
# the LiGRU's and the GRU's backward
ANN_SHAPES = [(5, 13, 40), (16, 20, 512), (4, 7, 1001), (2, 5, 1100),
              (5, 6, 512), (130, 6, 1001), (5, 3, 2048)]


def make_ann_inputs(mode, B, T, H, seed=0):
    """Numpy inputs of one ANN cell, lists by gate: input streams,
    orthogonal recurrent matrices, affine pairs; a nonzero y0."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    n = fused_ann.MODES[mode]
    return dict(
        wxs=[(0.8 * rng.normal(size=(B, T, H))).astype(f32)
             for _ in range(n)],
        vs=[np.linalg.qr(rng.normal(size=(H, H)))[0].astype(f32)
            for _ in range(n)],
        scales=[(1.0 + 0.2 * rng.normal(size=H)).astype(f32)
                for _ in range(n)],
        shifts=[(0.1 * rng.normal(size=H)).astype(f32) for _ in range(n)],
        y0=rng.uniform(0.0, 1.0, (B, H)).astype(f32),
    )


def ann_call(module, suffix, mode, d, to, affine=False, **kw):
    """``module.<mode>_<suffix>`` (``fused_ann.gru_fused``, the scan cell,
    the JAX op) on the inputs ``d`` converted by ``to``."""
    if affine:
        kw.update(scales=[to(a) for a in d["scales"]],
                  shifts=[to(a) for a in d["shifts"]])
    args = [to(a) for a in d["wxs"]] + [to(a) for a in d["vs"]]
    return getattr(module, f"{mode}_{suffix}")(*args, to(d["y0"]), **kw)


def _ann_operands(d, dev, affine):
    t = {k: ([torch.from_numpy(a).to(dev) for a in v] if isinstance(v, list)
             else torch.from_numpy(v).to(dev)) for k, v in d.items()}
    return (t["wxs"], t["scales"] if affine else None,
            t["shifts"] if affine else None, t["vs"], t["y0"])


@pytest.mark.parametrize("mode", ANN_MODES)
def test_ann_cpu_tensors_take_the_plain_version(mode):
    """Without the affine the fused ANN cell is the scan cell, op for op,
    and a CPU tensor launches no kernel."""
    d = make_ann_inputs(mode, 5, 13, 24, seed=1)
    fused_cells.reset_launch_counts()
    got = ann_call(fused_ann, "fused", mode, d, torch.from_numpy)
    want = ann_call(cells, "scan", mode, d, torch.from_numpy)
    assert torch.equal(got, want)
    assert not any(fused_cells.launch_counts().values())


def test_ann_wrappers_raise_on_what_they_do_not_take():
    d = make_ann_inputs("gru", 2, 3, 8)
    # the bf16-stream mode is ported and runs on CPU tensors
    assert ann_call(fused_ann, "fused", "gru", d, torch.from_numpy,
                    mxu_bf16=True).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="both scales and shifts"):
        ann_call(fused_ann, "fused", "gru", d, torch.from_numpy,
                 scales=[torch.ones(8)] * 3)
    with pytest.raises(ValueError, match="3 scales"):
        ann_call(fused_ann, "fused", "gru", d, torch.from_numpy,
                 scales=[torch.ones(8)], shifts=[torch.ones(8)])
    with pytest.raises(ValueError, match="drop_rate"):
        ann_call(fused_ann, "fused", "gru", d, torch.from_numpy,
                 drop_rate=1.0)
    with pytest.raises(ValueError, match="two int32"):
        ann_call(fused_ann, "fused", "gru", d, torch.from_numpy,
                 drop_rate=0.1, drop_seed=3)
    # past its width the kernel path raises before any launch
    H = fused_ann._MAX_H + 1
    wide = make_ann_inputs("rnn", 1, 1, 8)
    wide["wxs"] = [np.zeros((1, 1, H), np.float32)]
    ops = _ann_operands(wide, "cpu", False)
    with pytest.raises(ValueError, match=f"H <= {fused_ann._MAX_H}"):
        fused_ann._ann_cell_cuda("rnn", *ops)
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        ann_call(fused_ann, "fused", "rnn", make_ann_inputs("rnn", 2, 3, 8),
                 lambda a: torch.from_numpy(a).to("meta"))
    assert not any(fused_cells.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ANN_SHAPES)
@pytest.mark.parametrize("affine,drop_rate",
                         [(True, 0.25), (True, 0.0), (False, 0.0)])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_ann_forward_kernel_matches_plain_on_card(cuda, mode, affine,
                                                  drop_rate, shape):
    """The output and every residual series within atol 2e-5 of the plain
    version at 1, 2 and 4 neurons per thread (H = 1001: rows of the packed
    matrices padded); the dropped positions are the same; the serving form
    (no residuals) gives the same output."""
    ops = _ann_operands(make_ann_inputs(mode, *shape, seed=2), cuda, affine)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    kw = dict(drop_rate=drop_rate, seed=seed)
    counter = fused_ann.FUSED_ANN_FWD[mode]
    before = counter.launches
    out, y_raw, gates = fused_ann._ann_cell_cuda(mode, *ops,
                                                 save_residuals=True, **kw)
    served = fused_ann._ann_cell_cuda(mode, *ops, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    want, want_raw, want_gates = fused_ann.ann_cell_plain(
        mode, *ops, save_residuals=True, **kw)
    assert torch.equal(served, out)
    # a kept output is y / (1 - p)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=2e-5 / (1.0 - drop_rate))
    assert (y_raw is None) == (want_raw is None) == (drop_rate == 0.0)
    if drop_rate:
        torch.testing.assert_close(y_raw, want_raw, rtol=0, atol=2e-5)
        assert torch.equal(out == 0, want == 0)
        assert 0.15 < float((out == 0).float().mean()) < 0.35
    assert len(gates) == len(want_gates)
    for got_g, want_g in zip(gates, want_gates):
        torch.testing.assert_close(got_g, want_g, rtol=0, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ANN_SHAPES)
@pytest.mark.parametrize("affine,drop_rate", [(True, 0.25), (False, 0.0)])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_ann_backward_kernel_matches_plain_on_card(cuda, mode, affine,
                                                   drop_rate, shape):
    """Every gradient against the plain backward on the same residuals, to
    1e-4 of its largest magnitude; two launches give the same bits."""
    wxs, scales, shifts, vs, y0 = _ann_operands(
        make_ann_inputs(mode, *shape, seed=5), cuda, affine)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    kw = dict(drop_rate=drop_rate, seed=seed)
    out, y_raw, gates = fused_ann.ann_cell_plain(
        mode, wxs, scales, shifts, vs, y0, save_residuals=True, **kw)
    y_seq = out if y_raw is None else y_raw
    g = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, shape).astype(np.float32)).to(cuda)
    bargs = (mode, g, wxs if affine else None, y_seq, gates, scales, vs, y0)
    counter = fused_ann.FUSED_ANN_BWD[mode]
    before = counter.launches
    got = fused_ann._ann_cell_bwd_cuda(*bargs, **kw)
    again = fused_ann._ann_cell_bwd_cuda(*bargs, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    want = fused_ann.ann_cell_bwd_plain(*bargs, **kw)
    for n, x, y, z in zip(("dwxs", "dscales", "dshifts", "dvs", "dy0"), got,
                          want, again):
        assert (x is None) == (y is None) == (n[:2] == "ds" and not affine)
        if x is None:
            continue
        for i, (xi, yi, zi) in enumerate(
                zip(*([x], [y], [z]) if n == "dy0" else (x, y, z))):
            assert torch.equal(xi, zi), f"{n}[{i}] differs between launches"
            assert _rel_err(xi, yi) <= 1e-4, (n, i, _rel_err(xi, yi))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ANN_MODES)
def test_ann_autograd_reaches_the_kernels_on_card(cuda, mode):
    """A CUDA tensor that needs a gradient goes through the forward and
    the backward kernel of its mode, and no other."""
    d = make_ann_inputs(mode, 8, 13, 40, seed=9)
    leaves = []

    def to(a):
        leaves.append(torch.from_numpy(a).to(cuda).requires_grad_(True))
        return leaves[-1]

    fused_cells.reset_launch_counts()
    out = ann_call(fused_ann, "fused", mode, d, to, True, drop_rate=0.1,
                   drop_seed=[1, 2])
    out.sum().backward()
    torch.cuda.synchronize()
    want = {k: 0 for k in fused_cells.launch_counts()}
    want[f"fused_ann_fwd_{mode}"] = want[f"fused_ann_bwd_{mode}"] = 1
    assert fused_cells.launch_counts() == want
    assert len(leaves) == 4 * fused_ann.MODES[mode] + 1
    for t in leaves:
        assert t.grad is not None and torch.isfinite(t.grad).all()
    with torch.no_grad():
        ann_call(fused_ann, "fused", mode, d, to, True)
    want[f"fused_ann_fwd_{mode}"] += 1
    assert fused_cells.launch_counts() == want


# ---------------------------------------------------------------------------
# The bf16-stream forms on the card
# ---------------------------------------------------------------------------
#
# Bounds. The spiking forward is exact: V lies on the 2^-8 grid, so every
# s @ V is exact in float32 in any order and the kernel equals its plain
# version bit for bit (the first product, where s0 need not be 0/1, sums in
# the same order on both sides). Everywhere else a float32 sum taken in
# another order can tip a later rounding to bf16, so two right
# implementations may land on neighbouring bf16 values: an output stream is
# held to one bf16 ulp of a value in [1, 2), 2^-7, relative to max(1, |v|)
# (forward) or to the gradient's largest magnitude (backward). A gradient
# reduced in float32 is held to the same 2^-7 of its largest magnitude: at
# these shapes it sums as few as B*T = 10 terms, so one operand that tipped
# to its neighbour shows in full (at B*T = 12800 the tipped terms average
# out, and the full-size check on the card holds such a gradient to 1e-3).
# A value past its bound is held by the witness rule instead: with the plain
# version in float64 (same rounding points) as the truth, the kernel may be
# no further from it than 4 times the float32 plain version is.

BF16_ULP = 2.0 ** -7
WITNESS_FACTOR = 4.0
BF16_SHAPES = [(5, 13, 40), (16, 20, 512), (4, 7, 1001), (2, 5, 2100)]


def _held(name, got, want, truth, bound, scale):
    """``got`` within ``bound*scale`` of ``want`` elementwise, or else no
    further from ``truth()`` than WITNESS_FACTOR times ``want`` is."""
    got, want = got.double(), want.double()
    if bool(((got - want).abs() <= bound * scale).all()):
        return
    t = truth().double()
    far, base = (got - t).abs().max(), (want - t).abs().max()
    assert far <= WITNESS_FACTOR * base, (name, float(far), float(base))


def _bf16_cell_inputs(shape, dev, uniform_s0=False, seed=2):
    d = make_inputs(*shape, seed=seed)
    # |k| <= 255 on the 2^-8 grid: bf16 holds V exactly
    d["V"] = np.clip(d["V"], -255 / 256, 255 / 256)
    if uniform_s0:
        d["s0"] = np.random.default_rng(6).uniform(
            0, 1, d["s0"].shape).astype(np.float32)
    return _clamped(d, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("wx_bf16", [False, True])
@pytest.mark.parametrize("name", FORMS)
def test_bf16_forward_kernel_matches_plain_on_card(cuda, name, wx_bf16,
                                                   affine, shape):
    """Serving and training form of the bf16-stream forward, with a uniform
    s0: bf16 spikes and the float32 membrane series equal the plain
    version's bit for bit and a kept value is bf16(1/(1-p)); LIF and adLIF
    have no product, so with a float32 drive their membrane series and
    dropped positions are the float32 kernel's."""
    t = _bf16_cell_inputs(shape, cuda, uniform_s0=True)
    if wx_bf16:
        t["Wx"] = t["Wx"].bfloat16()
    args, kw = _cell_args(t, name, affine)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    train = dict(drop_rate=0.25, seed=seed, save_residuals=True)
    c_serve = fused_cells.FUSED_CELL_FWD_BF16
    c_train = fused_cells.FUSED_CELL_FWD_TRAIN_BF16
    before = (c_serve.launches, c_train.launches)
    served = fused_cells._fused_cell_cuda(*args, **kw, mxu_bf16=True)
    out, u_seq = fused_cells._fused_cell_cuda(*args, **kw, **train,
                                              mxu_bf16=True)
    torch.cuda.synchronize()
    assert (c_serve.launches, c_train.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert served.dtype == out.dtype == torch.bfloat16
    assert u_seq.dtype == torch.float32
    want_served = fused_cells.fused_cell_plain(*args, **kw, mxu_bf16=True)
    want, want_u = fused_cells.fused_cell_plain(*args, **kw, **train,
                                                mxu_bf16=True)
    assert torch.equal(served, want_served)
    assert torch.equal(out, want)
    assert torch.equal(u_seq, want_u)
    kept = torch.tensor(1.0 / 0.75, dtype=torch.float32).bfloat16()
    assert bool(((out == 0) | (out == kept.to(cuda))).all())
    if not (wx_bf16 or kw["recurrent"]):
        # no product: the mode changes the streams only
        f32_out, f32_u = fused_cells._fused_cell_cuda(*args, **kw, **train)
        assert torch.equal(out == 0, f32_out == 0)
        assert torch.equal(u_seq, f32_u)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rlif", "radlif"])
def test_bf16_forward_equals_float32_kernel_on_card(cuda, name):
    """With a 0/1 s0, a bf16-exact V and a float32 drive nothing is rounded
    on the way to a spike: the bf16 form's spikes, membrane series and
    dropped positions are the float32 form's."""
    t = _bf16_cell_inputs((16, 20, 512), cuda)
    args, kw = _cell_args(t, name, True)
    got = fused_cells._fused_cell_cuda(*args, **kw, mxu_bf16=True)
    want = fused_cells._fused_cell_cuda(*args, **kw)
    assert torch.equal(got.float(), want)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    train = dict(drop_rate=0.25, seed=seed, save_residuals=True)
    out, u_seq = fused_cells._fused_cell_cuda(*args, **kw, **train,
                                              mxu_bf16=True)
    f32_out, f32_u = fused_cells._fused_cell_cuda(*args, **kw, **train)
    assert torch.equal(out == 0, f32_out == 0)
    assert torch.equal(u_seq, f32_u)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("affine,drop_rate,wx_bf16",
                         [(True, 0.25, True), (True, 0.0, False),
                          (False, 0.0, False)])
@pytest.mark.parametrize("name", FORMS)
def test_bf16_backward_kernel_matches_plain_on_card(cuda, name, affine,
                                                    drop_rate, wx_bf16,
                                                    shape):
    """Every gradient of the bf16-stream backward against its plain version
    on the same residuals, by the bounds above; the types; two launches
    give the same bits."""
    t = _bf16_cell_inputs(shape, cuda, uniform_s0=True, seed=5)
    if wx_bf16:
        t["Wx"] = t["Wx"].bfloat16()
    args, kw = _cell_args(t, name, affine)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    kw.update(drop_rate=drop_rate, seed=seed, mxu_bf16=True)
    _, u_seq = fused_cells.fused_cell_plain(*args, save_residuals=True, **kw)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, shape).astype(np.float32)).to(cuda).bfloat16()
    Wx, scale, _, alpha, beta, a, b, V, thr, u0, w0, s0 = args
    bargs = (g, Wx, u_seq, scale, alpha, beta, a, b, V, thr, u0, w0, s0)
    counter = fused_cells.FUSED_CELL_BWD_BF16
    before = counter.launches
    got = fused_cells._fused_cell_bwd_cuda(*bargs, **kw)
    again = fused_cells._fused_cell_bwd_cuda(*bargs, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    want = fused_cells.fused_cell_bwd_plain(*bargs, **kw)
    truth = []

    def witness(i):
        if not truth:
            truth.extend(fused_cells.fused_cell_bwd_plain(
                *[x.double() if isinstance(x, torch.Tensor) else x
                  for x in bargs], **kw))
        return truth[i]

    names = ("dWx", "dscale", "dshift", "dV", "dalpha", "dbeta", "da", "db",
             "du0", "dw0", "ds0")
    for i, (n, x, y, z) in enumerate(zip(names, got, want, again)):
        assert (x is None) == (y is None), n
        if x is None:
            continue
        assert x.dtype == (torch.bfloat16 if n == "dWx" else torch.float32)
        assert torch.equal(x, z), f"{n} differs between two launches"
        _held(n, x, y, lambda i=i: witness(i), BF16_ULP,
              y.double().abs().max())


def _bf16_ann_operands(mode, shape, dev, affine, wx_bf16, seed):
    wxs, scales, shifts, vs, y0 = _ann_operands(
        make_ann_inputs(mode, *shape, seed=seed), dev, affine)
    if wx_bf16:
        wxs = [w.bfloat16() for w in wxs]
    return wxs, scales, shifts, vs, y0


def _double(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    if isinstance(x, (list, tuple)):
        return [_double(v) for v in x]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ANN_SHAPES)
@pytest.mark.parametrize("affine,drop_rate,wx_bf16",
                         [(True, 0.25, True), (True, 0.0, False),
                          (False, 0.0, True)])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_bf16_ann_forward_kernel_matches_plain_on_card(cuda, mode, affine,
                                                       drop_rate, wx_bf16,
                                                       shape):
    """The bf16 output and residual series within one bf16 ulp of the plain
    version's (or by the witness rule); the dropped positions are the same;
    the serving form gives the training form's output."""
    ops = _bf16_ann_operands(mode, shape, cuda, affine, wx_bf16, 2)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    kw = dict(drop_rate=drop_rate, seed=seed, mxu_bf16=True)
    counter = fused_ann.FUSED_ANN_FWD_BF16[mode]
    before = counter.launches
    out, y_raw, gates = fused_ann._ann_cell_cuda(mode, *ops,
                                                 save_residuals=True, **kw)
    served = fused_ann._ann_cell_cuda(mode, *ops, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    want, want_raw, want_gates = fused_ann.ann_cell_plain(
        mode, *ops, save_residuals=True, **kw)
    assert torch.equal(served, out)
    assert (y_raw is None) == (want_raw is None) == (drop_rate == 0.0)
    if drop_rate:
        assert torch.equal(out == 0, want == 0)
    truth = []

    def witness(i):
        if not truth:
            t_out, t_raw, t_gates = fused_ann.ann_cell_plain(
                mode, *_double(list(ops)), save_residuals=True, **kw)
            truth.extend([t_out, t_raw, *t_gates])
        return truth[i]

    series = [out, y_raw, *gates]
    wants = [want, want_raw, *want_gates]
    for i, (x, y) in enumerate(zip(series, wants)):
        if x is None:
            continue
        assert x.dtype == torch.bfloat16
        _held(f"{mode} series {i}", x, y, lambda i=i: witness(i), BF16_ULP,
              y.double().abs().clamp_min(1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ANN_SHAPES)
@pytest.mark.parametrize("affine,drop_rate,wx_bf16",
                         [(True, 0.25, True), (False, 0.0, False)])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_bf16_ann_backward_kernel_matches_plain_on_card(cuda, mode, affine,
                                                        drop_rate, wx_bf16,
                                                        shape):
    """Every gradient of the bf16-stream backward against its plain version
    on the same residuals, by the bounds above; the types; two launches
    give the same bits."""
    wxs, scales, shifts, vs, y0 = _bf16_ann_operands(
        mode, shape, cuda, affine, wx_bf16, 5)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    kw = dict(drop_rate=drop_rate, seed=seed, mxu_bf16=True)
    out, y_raw, gates = fused_ann.ann_cell_plain(
        mode, wxs, scales, shifts, vs, y0, save_residuals=True, **kw)
    y_seq = out if y_raw is None else y_raw
    g = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, shape).astype(np.float32)).to(cuda).bfloat16()
    bargs = (mode, g, wxs if affine else None, y_seq, gates, scales, vs, y0)
    counter = fused_ann.FUSED_ANN_BWD_BF16[mode]
    before = counter.launches
    got = fused_ann._ann_cell_bwd_cuda(*bargs, **kw)
    again = fused_ann._ann_cell_bwd_cuda(*bargs, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    want = fused_ann.ann_cell_bwd_plain(*bargs, **kw)
    truth = []

    def witness(k, i):
        if not truth:
            truth.extend(fused_ann.ann_cell_bwd_plain(
                *_double(list(bargs)), **kw))
        return truth[k] if i is None else truth[k][i]

    for k, (n, x, y, z) in enumerate(zip(
            ("dwxs", "dscales", "dshifts", "dvs", "dy0"), got, want, again)):
        assert (x is None) == (y is None) == (n[:2] == "ds" and not affine)
        if x is None:
            continue
        items = [(None, x, y, z)] if n == "dy0" else \
            [(i, *v) for i, v in enumerate(zip(x, y, z))]
        for i, xi, yi, zi in items:
            assert xi.dtype == (torch.bfloat16 if n == "dwxs"
                                else torch.float32)
            assert torch.equal(xi, zi), f"{n}[{i}] differs between launches"
            _held(f"{mode} {n}[{i}]", xi, yi, lambda k=k, i=i: witness(k, i),
                  BF16_ULP, yi.double().abs().max())


@pytest.mark.cuda
def test_bf16_autograd_reaches_the_bf16_kernels_on_card(cuda):
    """A bf16-stream call on CUDA tensors goes through the bf16 kernels and
    no other, and each gradient comes back in its operand's type."""
    d = make_inputs(8, 13, 40, seed=9)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in d.items()}
    t["Wx"] = t["Wx"].bfloat16()
    t = {k: v.requires_grad_(True) for k, v in t.items()}
    fused_cells.reset_launch_counts()
    out = call(fused_cells, "fused", "radlif", t, lambda x: x, True,
               drop_rate=0.1, drop_seed=[1, 2], mxu_bf16=True)
    out.float().sum().backward()
    n = fused_ann.MODES["gru"]
    a = make_ann_inputs("gru", 8, 13, 40, seed=9)
    leaves = []

    def to(x):
        leaves.append(torch.from_numpy(x).to(cuda).requires_grad_(True))
        return leaves[-1]

    y = ann_call(fused_ann, "fused", "gru", a, to, True, drop_rate=0.1,
                 drop_seed=[1, 2], mxu_bf16=True)
    y.float().sum().backward()
    torch.cuda.synchronize()
    want = {k: 0 for k in fused_cells.launch_counts()}
    want.update(fused_cell_fwd_train_bf16=1, fused_cell_bwd_bf16=1,
                fused_ann_fwd_gru_bf16=1, fused_ann_bwd_gru_bf16=1)
    assert fused_cells.launch_counts() == want
    assert out.dtype == y.dtype == torch.bfloat16
    assert t["Wx"].grad.dtype == torch.bfloat16
    for k in ("scale", "shift", "alpha", "beta", "a", "b", "V", "u0", "w0",
              "s0"):
        assert t[k].grad.dtype == torch.float32, k
        assert torch.isfinite(t[k].grad).all(), k
    assert len(leaves) == 4 * n + 1
    for leaf in leaves:  # float32 streams get float32 gradients
        assert leaf.grad.dtype == torch.float32
        assert torch.isfinite(leaf.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 9, 200), (16, 6, 1001),
                                   (128, 20, 512), (256, 4, 1024),
                                   (4, 3, 4096)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", ["rlif", "radlif"])
def test_cluster_backward_matches_plain_on_card(cuda, name, bf16, shape):
    """The recurrent forms' time loop as thread-block clusters
    (``fused_cells._bwd_plan``) at a partial row group (B = 12), a width no
    multiple of a cluster's columns (H = 1001), the main paths' widths (512:
    the slice resident; 1024: streamed, two waves at B = 256) and the
    widest layer (4096: clusters of eight blocks, four rows), with the
    affine and the dropout: the launch ran the mirror's plan, every
    gradient agrees with the plain backward on the same residuals (float32:
    to 1e-4 of its largest magnitude; bf16: by the bounds above), and two
    launches give the same bits."""
    if bf16:
        t = _bf16_cell_inputs(shape, cuda, uniform_s0=True, seed=5)
        t["Wx"] = t["Wx"].bfloat16()
    else:
        d = make_inputs(*shape, seed=5)
        d["s0"] = np.random.default_rng(6).uniform(
            0, 1, d["s0"].shape).astype(np.float32)
        t = _clamped(d, cuda)
    args, kw = _cell_args(t, name, True)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    kw.update(drop_rate=0.25, seed=seed, mxu_bf16=bf16)
    _, u_seq = fused_cells.fused_cell_plain(*args, save_residuals=True, **kw)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, shape).astype(np.float32)).to(cuda)
    if bf16:
        g = g.bfloat16()
    Wx, scale, _, alpha, beta, a, b, V, thr, u0, w0, s0 = args
    bargs = (g, Wx, u_seq, scale, alpha, beta, a, b, V, thr, u0, w0, s0)
    got = fused_cells._fused_cell_bwd_cuda(*bargs, **kw)
    plan = fused_cells.last_plans()["fused_cell_bwd"]
    again = fused_cells._fused_cell_bwd_cuda(*bargs, **kw)
    want = fused_cells.fused_cell_bwd_plain(*bargs, **kw)
    torch.cuda.synchronize()
    mirror = fused_cells._cluster_plan(shape[0], shape[2], bf16)
    assert plan["cluster"] == mirror.cluster == (8 if shape[2] > 3072 else
                                                 plan["cluster"])
    assert (plan["rows"], plan["resident"]) == (mirror.rows, mirror.resident)
    names = ("dWx", "dscale", "dshift", "dV", "dalpha", "dbeta", "da", "db",
             "du0", "dw0", "ds0")
    for i, (n, x, y, z) in enumerate(zip(names, got, want, again)):
        assert (x is None) == (y is None), n
        if x is None:
            continue
        assert torch.equal(x, z), f"{n} differs between two launches"
        if not bf16:
            assert _rel_err(x, y) <= 1e-4, (n, _rel_err(x, y))
            continue
        _held(n, x, y, lambda i=i: fused_cells.fused_cell_bwd_plain(
            *[x.double() if isinstance(x, torch.Tensor) else x
              for x in bargs], **kw)[i], BF16_ULP, y.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 9, 200), (16, 6, 1001),
                                   (130, 5, 512), (256, 4, 1024),
                                   (5, 3, 1536), (3, 4, 2048)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", ["rlif", "radlif"])
def test_slice_forward_matches_plain_on_card(cuda, name, bf16, shape):
    """The recurrent forms in the column-slice layout
    (``fused_cells._fwd_plan``): partial slices (H = 200, 1001: the last
    slice holds 8 or 9 neurons), batches no multiple of a group's rows (B =
    12, 130), the main paths' widths, the widest resident width (1536) and
    one past it (2048: a block a row). The launch ran the plan's layout, and
    the spikes of the serving form and the spikes and the membrane series
    of the training form (affine, dropout), with s0 drawn from U[0, 1),
    equal the plain version's bit for bit on a dyadic V; ``split_ms`` gives
    the first product and the time loop."""
    t = _bf16_cell_inputs(shape, cuda, uniform_s0=True, seed=8)
    if bf16:
        t["Wx"] = t["Wx"].bfloat16()
    args, kw = _cell_args(t, name, True)
    kw.update(mxu_bf16=bf16)
    seed = torch.tensor([42, 7], dtype=torch.int32, device=cuda)
    train = dict(drop_rate=0.25, seed=seed, save_residuals=True)
    served = fused_cells._fused_cell_cuda(*args, **kw)
    out, u_seq = fused_cells._fused_cell_cuda(*args, **kw, **train)
    plan = fused_cells.last_plans()["fused_cell_fwd"]
    want_served = fused_cells.fused_cell_plain(*args, **kw)
    want, want_u = fused_cells.fused_cell_plain(*args, **kw, **train)
    torch.cuda.synchronize()
    with torch.cuda.device(cuda):
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        mirror = fused_cells._fwd_plan(
            shape[0], shape[2], 1, bf16, sms,
            lambda c, r, th: fused_cells.slice_blocks(
                "fused_cell_fwd", int(name == "radlif"), 1, 1, 1, int(bf16),
                shape[2], c, r, th))
    assert plan["layout"] == ("rows" if mirror is None else "slices")
    if mirror is not None:
        assert plan == mirror._asdict()
        split = []
        fused_cells._fused_cell_cuda(*args, **kw, **train, split_ms=split)
        assert len(split) == 2 and min(split) > 0.0
    assert torch.equal(served, want_served)
    assert torch.equal(out, want) and torch.equal(u_seq, want_u)


# ---------------------------------------------------------------------------
# The dV products (csrc/dv_product.cuh). Each element of dV is one chain of
# fmaf over its split's rows in ascending (b, t), the splits added in
# ascending order; with a binary left operand fmaf(1, x, acc) is acc + x and
# fmaf(0, x, acc) is acc, so ``ordered_spike_dv`` gives the kernel's bits.
# On a dyadic grid every product and partial sum is exact in float32, so the
# kernels equal a float64 matmul.
# ---------------------------------------------------------------------------

def ordered_spike_dv(u_seq, s0, dd, threshold):
    """The spiking dV product summed as ``dv_kernel`` sums it, for a
    binary s0: per split (``fused_ann._dv_split``, ``_dv_rows_per_split``)
    the dd rows at which each neuron spiked at t - 1 (s0 at t = 0), added in
    ascending (b, t) from +0 in float32; then the splits in ascending
    order."""
    B, T, H = dd.shape
    assert bool(((s0 == 0) | (s0 == 1)).all()), "the mirror takes a binary s0"
    left = torch.cat([s0[:, None] != 0, u_seq[:, :-1] > threshold], 1)
    left, rows = left.reshape(B * T, H), dd.float().reshape(B * T, H)
    ksplit = fused_ann._dv_split(B, T, H, 1)
    per = fused_ann._dv_rows_per_split(B, T, ksplit)
    parts = []
    for z in range(ksplit):
        acc = torch.zeros((H, H), dtype=torch.float32, device=dd.device)
        for q in range(z * per, min(B * T, (z + 1) * per)):
            acc[left[q]] += rows[q]
        parts.append(acc)
    if ksplit == 1:
        return parts[0]
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out


def spike_dv_plain(u_seq, s0, dd, threshold, *, mxu_bf16=False):
    """The spiking dV product as ``fused_cell_bwd_plain`` forms it: the sum
    over rows (b, t) of s_{t-1}[b]^T dd[b, t] with s_{-1} = s0 (rounded to
    bf16 with ``mxu_bf16``, where dd is bf16), in s0's type."""
    B, T, H = dd.shape
    s_prev = torch.cat([(s0.bfloat16().to(s0.dtype) if mxu_bf16 else s0)
                        [:, None],
                        (u_seq[:, :-1] > threshold).to(s0.dtype)], dim=1)
    return torch.matmul(s_prev.reshape(-1, H).t(),
                        dd.to(s0.dtype).reshape(-1, H))


def ann_dv_plain(mode, y_seq, y0, r, dpres, *, mxu_bf16=False):
    """The non-spiking dV products as ``ann_cell_bwd_plain`` forms them: by
    gate, the sum over rows (b, t) of left[b, t]^T dpre[b, t], left =
    y_{t-1} (y0 at t = 0), times r for the GRU's candidate (gate 0),
    rounded to bf16 with ``mxu_bf16`` (where the series are bf16), in y0's
    type."""
    H = y0.shape[1]
    y_prev = torch.cat([y0[:, None], y_seq[:, :-1].to(y0.dtype)], dim=1)
    dvs = []
    for i, dpre in enumerate(dpres):
        left = r.to(y0.dtype) * y_prev if (mode == "gru" and i == 0) \
            else y_prev
        if mxu_bf16:
            left = left.bfloat16().to(y0.dtype)
        dvs.append(torch.matmul(left.reshape(-1, H).t(),
                                dpre.to(y0.dtype).reshape(-1, H)))
    return dvs


def _silent_and_saturated(u_seq, s0, threshold):
    """u_seq and a binary s0 edited so that some rows of dV see no spike
    and some a spike at every step, and some (b, t) rows none or all."""
    u, s = u_seq.clone(), s0.clone()
    u[:, :, :3] = threshold - 1.0   # never spike
    u[:, :, 3:6] = threshold + 1.0  # spike at every step
    u[0] = threshold - 1.0          # a batch row without a spike
    u[-1, :, 6:] = threshold + 1.0  # one where every other neuron spikes
    s[:, :3], s[:, 3:6] = 0.0, 1.0
    s[0], s[-1, 6:] = 0.0, 1.0
    return u, s


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 20, 200), (16, 20, 1001),
                                   (4, 20, 4096)])
@pytest.mark.parametrize("bf16", [False, True])
def test_spiking_dv_equals_ordered_mirror_on_card(cuda, bf16, shape):
    """The backward's dV (RadLIF, no affine: its right operand is dWx),
    with a binary s0, equals ``ordered_spike_dv`` bit for bit, and so does
    the product alone; the backward's on rows with no spike or every spike
    too. H = 200 splits in three."""
    d = make_inputs(*shape, seed=11)
    t = _clamped(d, cuda)
    args, kw = _cell_args(t, "radlif", False)
    _, u_seq = fused_cells.fused_cell_plain(*args, save_residuals=True, **kw)
    g = torch.from_numpy(np.random.default_rng(12).normal(
        0, 1, shape).astype(np.float32)).to(cuda)
    Wx, _, _, alpha, beta, a, b, V, thr, u0, w0, s0 = args
    got = fused_cells._fused_cell_bwd_cuda(
        g.bfloat16() if bf16 else g, Wx, u_seq, None, alpha, beta, a, b, V,
        thr, u0, w0, s0, **kw, mxu_bf16=bf16)
    dWx, dV = got[0], got[3]
    assert torch.equal(dV, ordered_spike_dv(u_seq, s0, dWx, thr))
    alone = fused_ann._dv_product_cuda(u_seq, s0, None, [dWx], threshold=thr,
                                       mxu_bf16=bf16)[0]
    assert torch.equal(alone, dV)
    u, s = _silent_and_saturated(u_seq, s0, thr)
    edge = fused_cells._fused_cell_bwd_cuda(
        g.bfloat16() if bf16 else g, Wx, u, None, alpha, beta, a, b, V, thr,
        u0, w0, s, **kw, mxu_bf16=bf16)
    assert torch.equal(edge[3], ordered_spike_dv(u, s, edge[0], thr))
    assert torch.equal(edge[3][:3], torch.zeros_like(edge[3][:3]))
    torch.cuda.synchronize()


def _dyadic(rng, shape, k, den, dev, dtype=torch.float32):
    """Integers in [-k, k] over ``den``: exact in bf16 for k < 256."""
    return torch.from_numpy((rng.integers(-k, k + 1, shape) / den).astype(
        np.float32)).to(dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 20, 200), (8, 30, 512),
                                   (4, 20, 1001), (2, 10, 2048)])
@pytest.mark.parametrize("s0_kind", ["binary", "sixteenths"])
@pytest.mark.parametrize("bf16", [False, True])
def test_spiking_dv_is_exact_on_a_dyadic_grid_on_card(cuda, bf16, s0_kind,
                                                      shape):
    """With dd on 1/16 and s0 binary or on 1/16, every product and partial
    sum is exact: the product alone equals the float64 matmul, on rows with
    no spike or every spike too."""
    B, T, H = shape
    rng = np.random.default_rng(13)
    u_seq = torch.from_numpy(rng.normal(0.8, 0.6, shape).astype(
        np.float32)).to(cuda)
    s0 = torch.from_numpy(((rng.uniform(size=(B, H)) > 0.7) if s0_kind ==
                           "binary" else rng.integers(0, 17, (B, H)) / 16)
                          .astype(np.float32)).to(cuda)
    u_seq, s0b = _silent_and_saturated(u_seq, (s0 != 0).float(), 1.0)
    if s0_kind == "binary":
        s0 = s0b
    dd = _dyadic(rng, shape, 64, 16, cuda,
                 torch.bfloat16 if bf16 else torch.float32)
    got = fused_ann._dv_product_cuda(u_seq, s0, None, [dd], threshold=1.0,
                                     mxu_bf16=bf16)[0]
    want = spike_dv_plain(u_seq.double(), s0.double(), dd, 1.0,
                          mxu_bf16=bf16)
    torch.cuda.synchronize()
    assert torch.equal(got, want.float())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 20, 200), (8, 30, 512),
                                   (4, 20, 1001), (2, 10, 2048)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("mode", ["rnn", "ligru", "gru"])
def test_ann_dv_is_exact_on_a_dyadic_grid_on_card(cuda, mode, bf16, shape):
    """y, y0 and r on 1/16, dpre on 1/16 up to 4: every product (the GRU's
    r*y too) and partial sum is exact, so the products equal the float64
    matmul in every tile of the plan (H = 2048: 128 x 128; 1001: 128 x 64,
    unaligned rows; 200, 512: 64 x 64, several splits)."""
    B, T, H = shape
    n = fused_ann.MODES[mode]
    sdt = torch.bfloat16 if bf16 else torch.float32
    rng = np.random.default_rng(14)
    y_seq = _dyadic(rng, shape, 16, 16, cuda, sdt)
    y0 = _dyadic(rng, (B, H), 16, 16, cuda)
    r = torch.from_numpy((rng.integers(0, 17, shape) / 16).astype(
        np.float32)).to(cuda).to(sdt) if mode == "gru" else None
    dpres = [_dyadic(rng, shape, 64, 16, cuda, sdt) for _ in range(n)]
    got = fused_ann._dv_product_cuda(y_seq, y0, r, dpres, mxu_bf16=bf16)
    want = ann_dv_plain(mode, y_seq, y0.double(), r, dpres, mxu_bf16=bf16)
    torch.cuda.synchronize()
    for i, (x, w) in enumerate(zip(got, want)):
        assert torch.equal(x, w.float()), i
