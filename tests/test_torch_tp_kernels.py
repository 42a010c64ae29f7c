"""The port's tensor-parallel wrappers and CUDA kernels (ops/fused_tp.py,
ops/fused_tp_ann.py), without JAX.

On the CPU: a CPU tensor runs the plain versions and launches nothing; the
plain TP cell at any P equals the single-card plain fused cell without the
affine, bit for bit; the checks the JAX package makes raise here too.

On a card (tests marked ``cuda``, which skip without one), in the one-card
form: the exchange harnesses equal their plain versions bit for bit at P =
1, 2, 3, 4, 8, ragged B and rounds 1-5, launch after launch and replayed
from a CUDA graph with nothing zeroed between; at P = 1, 2, 4 the TP
forward's spikes and membrane series
equal the plain version's and the single-card kernel's bit for bit (V on a
dyadic grid, s0 on sixteenths, so every product is exact); every gradient
of the TP backward agrees with the plain backward on the same residuals to
1e-4 of that gradient's largest magnitude, two launches give the same bits,
and the gradients that no reduction over rows touches are equal across P.
The TP RNN/LiGRU/GRU kernels agree with their plain versions within the
bounds of the single-card ANN kernels (the products sum in another order,
exp and tanh come from the card's library), and equal the single-card
kernels without the affine and the dropout, and themselves at every P, bit
for bit: every product sums its Hg terms in the same ascending order,
whatever the plan of thread-block clusters (a partial row group, a rank
width that is no multiple of a cluster's columns, clusters that walk their
row groups, H = 2048).

    python -m pytest tests/test_torch_tp_kernels.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.ops import fused_ann, fused_cells, fused_tp, fused_tp_ann
from sparch_tpu_torch.parallel import make_mesh

PS = (1, 2, 4)
GRAD_REL = 1e-4
GRADS = ("dWx", "dV", "dalpha", "dbeta", "da", "db", "du0", "dw0", "ds0")
ANN_MODES = ("rnn", "ligru", "gru")
ANN_FWD_ATOL = 2e-5  # the single-card ANN forward's bound (chip_smoke.py)
# (B, T, H/P) of the TP ANN kernel tests: a rank of 128 neurons (clusters
# of four 32-column slices); 256 (six slices of 48 columns, the last
# ragged); 200 rows short of a multiple of the cluster's columns and B = 12,
# so the second row group of eight is partial
ANN_SHAPES = [(8, 13, 128), (24, 20, 256), (12, 9, 200), (13, 7, 128)]
# batches of rows no multiple of 8 (the TPU kernels' sublane), which the
# CUDA kernels take
RAGGED = [(4, 13, 128), (13, 20, 256), (100, 30, 128)]


def tp_inputs(B, T, H, seed=0, device="cpu"):
    """Clamped constants, a zero-diagonal V on the 2^-8 grid, s0 on
    sixteenths (not 0/1, as a uniform state init draws it, but exact in any
    product with V)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    V = (np.round(rng.normal(0, 0.3, (H, H)) * 256) / 256).astype(f32)
    np.fill_diagonal(V, 0.0)
    d = dict(
        Wx=rng.uniform(-1.0, 3.0, (B, T, H)).astype(f32),
        alpha=rng.uniform(0.82, 0.96, H).astype(f32),
        beta=rng.uniform(0.97, 0.99, H).astype(f32),
        a=rng.uniform(-1.0, 1.0, H).astype(f32),
        b=rng.uniform(0.0, 2.0, H).astype(f32),
        V=V,
        u0=rng.uniform(0.0, 1.0, (B, H)).astype(f32),
        w0=rng.uniform(0.0, 1.0, (B, H)).astype(f32),
        s0=(np.round(rng.uniform(0, 1, (B, H)) * 16) / 16).astype(f32),
        g=rng.normal(0, 1, (B, T, H)).astype(f32),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


def cell_args(d, adaptive):
    return (d["Wx"], d["alpha"], d["beta"] if adaptive else None,
            d["a"] if adaptive else None, d["b"] if adaptive else None,
            d["V"], 1.0, d["u0"], d["w0"] if adaptive else None, d["s0"])


def bwd_args(d, u_seq, adaptive):
    Wx, alpha, beta, a, b, V, thr, u0, w0, s0 = cell_args(d, adaptive)
    return (d["g"], u_seq, alpha, beta, a, b, V, thr, u0, w0, s0)


def _mesh(P, device):
    return make_mesh([torch.device(device)] * P, model=P)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True])
def test_plain_tp_cell_is_the_plain_fused_cell_at_every_p(adaptive):
    d = tp_inputs(8, 9, 512, seed=1)
    Wx, alpha, beta, a, b, V, thr, u0, w0, s0 = cell_args(d, adaptive)
    want, want_u = fused_cells.fused_cell_plain(
        Wx, None, None, alpha, beta, a, b, V, thr, u0, w0, s0,
        recurrent=True, adaptive=adaptive, save_residuals=True)
    assert 0 < float(want.mean()) < 0.5
    for P in PS:
        got, got_u = fused_tp.tp_cell_plain(
            *cell_args(d, adaptive), num_devices=P, adaptive=adaptive,
            save_residuals=True)
        assert torch.equal(got, want) and torch.equal(got_u, want_u), P


def test_cpu_tensors_take_the_plain_versions():
    fused_cells.reset_launch_counts()
    d = tp_inputs(8, 5, 256)
    mesh = _mesh(2, "cpu")
    fused_tp.radlif_tp(*[d[k] for k in ("Wx", "alpha", "beta", "a", "b",
                                        "V")], 1.0, d["u0"], d["w0"],
                       d["s0"], mesh=mesh)
    fused_tp.tp_all_gather(d["u0"], num_devices=2)
    fused_tp.tp_reduce_scatter(torch.stack([d["u0"], d["w0"]]),
                               num_devices=2)
    assert not any(fused_cells.launch_counts().values())
    assert {k.name for k in fused_tp.KERNELS} <= set(
        fused_cells.launch_counts())


def test_plain_collectives_pin_their_recurrences():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (8, 512)).astype(np.float32))
    got = fused_tp.tp_all_gather(x, num_devices=4, rounds=3)
    assert got.shape == (4, 3, 8, 512)
    for r in range(3):
        for q in range(4):
            torch.testing.assert_close(got[q, r], x + r, atol=1e-5, rtol=0)
    parts = torch.from_numpy(rng.normal(0, 1, (4, 8, 512)).astype(
        np.float32))
    out = fused_tp.tp_reduce_scatter(parts, num_devices=4, rounds=2)
    torch.testing.assert_close(out[0], parts.sum(0), atol=1e-5, rtol=0)
    # round 1: every rank's partial plus its own reduced first column
    shift = out[0][:, ::128].sum(1, keepdim=True)
    torch.testing.assert_close(out[1], parts.sum(0) + shift, atol=1e-4,
                               rtol=0)


def test_tp_checks_raise():
    d = tp_inputs(8, 3, 256)
    args = [d[k] for k in ("Wx", "alpha", "V")]
    with pytest.raises(ValueError, match="divisible by num_model_devices"):
        fused_tp.rlif_tp(*args, 1.0, d["u0"], d["s0"], mesh=_mesh(4, "cpu"))
    # any number of rows (the TPU kernels wanted a multiple of 8): B = 6
    # at P = 2 gives P = 1's spikes
    e = tp_inputs(6, 3, 256)
    six = [e[k] for k in ("Wx", "alpha", "V")]
    assert torch.equal(
        fused_tp.rlif_tp(*six, 1.0, e["u0"], e["s0"], mesh=_mesh(2, "cpu")),
        fused_tp.rlif_tp(*six, 1.0, e["u0"], e["s0"], mesh=_mesh(1, "cpu")))
    # the bf16-stream form runs: bf16 spikes from a bf16 drive
    s = fused_tp.rlif_tp(args[0].bfloat16(), *args[1:], 1.0, d["u0"],
                         d["s0"], mesh=_mesh(2, "cpu"), mxu_bf16=True)
    assert s.dtype == torch.bfloat16 and s.shape == args[0].shape
    meta = make_mesh([torch.device("meta")] * 2, model=2)
    with pytest.raises(ValueError, match="the mesh on"):
        fused_tp.rlif_tp(*args, 1.0, d["u0"], d["s0"], mesh=meta)
    with pytest.raises(ValueError, match="lane-aligned"):
        fused_tp.tp_all_gather(torch.zeros(8, 192), num_devices=2)
    # the kernel wrappers check before they launch
    with pytest.raises(ValueError, match="H/P <= 2048"):
        fused_tp._tp_cell_cuda(*cell_args(tp_inputs(8, 1, 2176), False),
                               num_devices=1, adaptive=False)


# ---------------------------------------------------------------------------
# Card
# ---------------------------------------------------------------------------


def collective_inputs(P, B, Hl, device):
    rng = np.random.default_rng(P * 1000 + B)
    H = P * Hl
    x = torch.from_numpy(rng.normal(0, 1, (B, H)).astype(np.float32))
    parts = torch.from_numpy(rng.normal(0, 1, (P, B, H)).astype(np.float32))
    return x.to(device), parts.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("P", (1, 2, 3, 4, 8))
@pytest.mark.parametrize("B,Hl", [(1, 128), (13, 256), (128, 256)])
@pytest.mark.parametrize("rounds", (1, 3, 5))
def test_collectives_match_plain_on_card(cuda, P, B, Hl, rounds):
    x, parts = collective_inputs(P, B, Hl, cuda)
    want_ag = fused_tp.tp_all_gather_plain(x, num_devices=P, rounds=rounds)
    want_rs = fused_tp.tp_reduce_scatter_plain(parts, num_devices=P,
                                               rounds=rounds)
    fused_cells.reset_launch_counts()
    # back to back: every launch leaves its counters zero for the next
    for _ in range(3):
        got_ag = fused_tp.tp_all_gather(x, num_devices=P, rounds=rounds)
        got_rs = fused_tp.tp_reduce_scatter(parts, num_devices=P,
                                            rounds=rounds)
        torch.cuda.synchronize()
        assert torch.equal(got_ag, want_ag)
        assert torch.equal(got_rs, want_rs)
    counts = fused_cells.launch_counts()
    assert counts["tp_all_gather"] == counts["tp_reduce_scatter"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("P", (1, 3, 8))
def test_collectives_replay_from_a_graph_on_card(cuda, P):
    """A CUDA graph of one call of each replays its frozen arguments twice,
    nothing zeroed between, bit for bit: the counters are fresh because
    each launch zeroes its own."""
    x, parts = collective_inputs(P, 13, 256, cuda)
    calls = ((fused_tp.tp_all_gather, fused_tp.tp_all_gather_plain, x),
             (fused_tp.tp_reduce_scatter, fused_tp.tp_reduce_scatter_plain,
              parts))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the counters of the capture stream
        for fn, _, arg in calls:
            fn(arg, num_devices=P, rounds=3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [fn(arg, num_devices=P, rounds=3) for fn, _, arg in calls]
    wants = [plain(arg, num_devices=P, rounds=3) for _, plain, arg in calls]
    for _ in range(2):
        for out in outs:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, wants):
            assert torch.equal(out, want)
    # an eager call on the capture stream after the replays
    with torch.cuda.stream(side):
        again = [fn(arg, num_devices=P, rounds=3) for fn, _, arg in calls]
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(again, wants))


@pytest.mark.cuda
@pytest.mark.parametrize("P", (2, 4))
def test_collectives_replay_on_another_stream_on_card(cuda, P):
    """A graph captured on one stream replays on another while eager calls
    run on the capture stream: a capture takes counters of its own, so
    neither launch resets the other's."""
    x, parts = collective_inputs(P, 128, 256, cuda)
    calls = ((fused_tp.tp_all_gather, fused_tp.tp_all_gather_plain, x),
             (fused_tp.tp_reduce_scatter, fused_tp.tp_reduce_scatter_plain,
              parts))
    wants = [plain(arg, num_devices=P, rounds=5) for _, plain, arg in calls]
    capture, other = torch.cuda.Stream(), torch.cuda.Stream()
    capture.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(capture):
        for fn, _, arg in calls:
            fn(arg, num_devices=P, rounds=5)
    torch.cuda.current_stream().wait_stream(capture)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture):
        outs = [fn(arg, num_devices=P, rounds=5) for fn, _, arg in calls]
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.cuda.stream(other):
            graph.replay()
        with torch.cuda.stream(capture):
            eager = [[fn(arg, num_devices=P, rounds=5)
                      for fn, _, arg in calls] for _ in range(3)]
        torch.cuda.synchronize()
        for out, want in zip(outs, wants):
            assert torch.equal(out, want)
        for got in eager:
            assert all(torch.equal(g, w) for g, w in zip(got, wants))


@pytest.mark.cuda
def test_collectives_refuse_a_first_call_inside_a_capture(cuda):
    x, _ = collective_inputs(2, 8, 128, cuda)
    # as on a fresh process: no counters zeroed yet
    fused_tp._COUNTERS.clear()
    fused_tp._SPARE.clear()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before capturing"):
        with torch.cuda.graph(graph):
            fused_tp.tp_all_gather(x, num_devices=2)


@pytest.mark.cuda
def test_collective_plan_is_the_cards(cuda):
    """The plan a launch takes is ``_collective_plan`` over the card's SM
    count and occupancy, cached: one occupancy query a shape."""
    x, parts = collective_inputs(4, 128, 256, cuda)
    index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    for fn, name, reduce, arg in (
            (fused_tp.tp_all_gather, "tp_all_gather", False, x),
            (fused_tp.tp_reduce_scatter, "tp_reduce_scatter", True, parts)):
        fn(arg, num_devices=4)
        want = fused_tp._collective_plan(
            128, 1024, 4, reduce, sms,
            lambda smem: fused_tp.collective_blocks(reduce, smem, index))
        assert fused_tp.last_plans()[name] == want._asdict()
        hits = fused_tp._card_collective_plan.cache_info().hits
        fn(arg, num_devices=4)
        assert fused_tp._card_collective_plan.cache_info().hits == hits + 1


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", [(8, 13, 128), (24, 20, 256),
                                   (256, 100, 256)] + RAGGED)
@pytest.mark.parametrize("adaptive", [False, True])
def test_forward_kernel_matches_plain_on_card(cuda, adaptive, shape, P):
    B, T, hl = shape
    H = P * hl if B < 256 else 1024
    d = tp_inputs(B, T, H, seed=2, device=cuda)
    args = cell_args(d, adaptive)
    want, want_u = fused_tp.tp_cell_plain(*args, num_devices=P,
                                          adaptive=adaptive,
                                          save_residuals=True)
    fused_cells.reset_launch_counts()
    got, got_u = fused_tp._tp_cell_cuda(*args, num_devices=P,
                                        adaptive=adaptive,
                                        save_residuals=True)
    again = fused_tp._tp_cell_cuda(*args, num_devices=P, adaptive=adaptive)
    single = fused_cells._fused_cell_cuda(
        args[0], None, None, *args[1:], recurrent=True, adaptive=adaptive)
    torch.cuda.synchronize()
    assert 0 < float(want.mean()) < 0.5
    assert torch.equal(got, want) and torch.equal(got_u, want_u)
    assert torch.equal(again, want) and torch.equal(single, want)
    assert fused_cells.launch_counts()["tp_cell_fwd"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(24, 9, 128, 1), (24, 9, 128, 2),
                                  (24, 9, 128, 4), (136, 5, 256, 1),
                                  (136, 5, 256, 2), (136, 5, 256, 4),
                                  (16, 4, 512, 2), (8, 3, 2048, 2)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_slice_forward_matches_plain_on_card(cuda, adaptive, bf16, case):
    """(B, T, H/P, P): the column-slice layout over the P ranks' slices
    (``fused_cells._fwd_plan``) with a batch no multiple of a group's rows
    (B = 24, 136), P = 1, 2, 4, and at H = 1024 over two ranks; past the
    widest resident width (P = 2, H = 4096) the layout of a block a row.
    The launch ran the plan's layout, and the spikes and the membrane
    series equal the plain version's and the single-card kernel's without
    the affine, bit for bit (dyadic V, s0 on sixteenths)."""
    B, T, hl, P = case
    d = tp_inputs(B, T, P * hl, seed=3, device=cuda)
    if bf16:
        d["V"] = d["V"].clamp(-255 / 256, 255 / 256)
    args = cell_args(d, adaptive)
    kw = dict(num_devices=P, adaptive=adaptive, mxu_bf16=bf16)
    got, got_u = fused_tp._tp_cell_cuda(*args, save_residuals=True, **kw)
    plan = fused_tp.last_plans()["tp_cell_fwd"]
    want, want_u = fused_tp.tp_cell_plain(*args, save_residuals=True, **kw)
    single, single_u = fused_cells._fused_cell_cuda(
        args[0], None, None, *args[1:], recurrent=True, adaptive=adaptive,
        save_residuals=True, mxu_bf16=bf16)
    torch.cuda.synchronize()
    assert plan["layout"] == ("rows" if P * hl >= 2048 else "slices"), plan
    assert torch.equal(got, want) and torch.equal(got_u, want_u)
    assert torch.equal(got, single) and torch.equal(got_u, single_u)


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", [(8, 13, 128), (24, 20, 256),
                                   (256, 100, 256)] + RAGGED)
@pytest.mark.parametrize("adaptive", [False, True])
def test_backward_kernel_matches_plain_on_card(cuda, adaptive, shape, P):
    B, T, hl = shape
    H = P * hl if B < 256 else 1024
    d = tp_inputs(B, T, H, seed=3, device=cuda)
    _, u_seq = fused_tp.tp_cell_plain(*cell_args(d, adaptive),
                                      num_devices=P, adaptive=adaptive,
                                      save_residuals=True)
    args = bwd_args(d, u_seq, adaptive)
    kw = dict(num_devices=P, adaptive=adaptive)
    got = fused_tp._tp_cell_bwd_cuda(*args, **kw)
    again = fused_tp._tp_cell_bwd_cuda(*args, **kw)
    want = fused_tp.tp_cell_bwd_plain(*args, **kw)
    one = fused_tp._tp_cell_bwd_cuda(*args, num_devices=1, adaptive=adaptive)
    torch.cuda.synchronize()
    for name, x, y, z, w in zip(GRADS, got, want, again, one):
        assert (x is None) == (y is None) == (not adaptive and name in (
            "dbeta", "da", "db", "dw0")), name
        if x is None:
            continue
        err = float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
        assert err <= GRAD_REL, (name, err)
        assert torch.equal(x, z), name
        if name in ("dWx", "dV", "du0", "dw0", "ds0"):
            # no reduction over rows: the split changes no sum
            assert torch.equal(x, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(16, 20, 512, 1), (16, 20, 512, 2),
                                  (16, 20, 512, 4), (8, 20, 4096, 2),
                                  (8, 20, 4096, 4)])
@pytest.mark.parametrize("bf16", [False, True])
def test_backward_dv_equals_ordered_mirror_on_card(cuda, bf16, case):
    """With a binary s0 the TP backward's dV (over every rank's dWx)
    equals ``ordered_spike_dv`` bit for bit at every P, both modes: each
    element adds its dWx rows in ascending (b, t), whatever the ranks."""
    from tests.test_torch_kernels import ordered_spike_dv

    B, T, H, P = case
    d = tp_inputs(B, T, H, seed=15, device=cuda)
    d["s0"] = (d["s0"] > 0.5).float()
    _, u_seq = fused_tp.tp_cell_plain(*cell_args(d, True), num_devices=P,
                                      adaptive=True, save_residuals=True)
    args = bwd_args(d, u_seq, True)
    if bf16:
        args = (args[0].bfloat16(), *args[1:])
    dWx, dV = fused_tp._tp_cell_bwd_cuda(*args, num_devices=P, adaptive=True,
                                         mxu_bf16=bf16)[:2]
    torch.cuda.synchronize()
    assert torch.equal(dV, ordered_spike_dv(u_seq, d["s0"], dWx, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("neuron", ["RLIF", "RadLIF", "LIF", "adLIF"])
def test_model_reaches_the_tp_kernels_on_card(cuda, neuron):
    B, T, F, H, C, P = 16, 20, 24, 256, 5, 2
    mesh = _mesh(P, "cuda")
    model = build_model(neuron, (B, T, F), [H, H, C], dropout=0.1,
                        cell_impl="pallas_tp", tp_mesh=mesh,
                        bidirectional=True,
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.rand((B, T, F), device=cuda) * 3
    fused_cells.reset_launch_counts()
    out, rates = model(x, torch.Generator(device=cuda).manual_seed(1))
    out.sum().backward()
    torch.cuda.synchronize()
    counts = {k: n for k, n in fused_cells.launch_counts().items() if n}
    if neuron in ("RLIF", "RadLIF"):
        assert counts == {"tp_cell_fwd": 2, "tp_cell_bwd": 2}
    else:
        assert counts == {"fused_cell_fwd_train": 2 * P,
                          "fused_cell_bwd": 2 * P}
    assert torch.isfinite(out).all() and float(rates.mean()) > 0
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# The TP RNN / LiGRU / GRU (ops/fused_tp_ann.py)
# ---------------------------------------------------------------------------


def ann_tp_inputs(mode, B, T, H, seed=0, device="cpu"):
    """Normal input streams, recurrent matrices of spectral norm about 0.5
    (the conditioning tests/test_pallas_tp_ann.py keeps for the LiGRU's relu
    candidate), a uniform y0 and a cotangent."""
    rng = np.random.default_rng(seed)
    n = fused_ann.MODES[mode]
    f32 = np.float32

    def t(a):
        return torch.from_numpy(a.astype(f32)).to(device)

    return dict(
        wxs=[t(rng.normal(0, 1, (B, T, H))) for _ in range(n)],
        vs=[t(rng.normal(0, 0.25 / np.sqrt(H), (H, H))) for _ in range(n)],
        y0=t(rng.uniform(0, 1, (B, H))),
        g=t(rng.normal(0, 1, (B, T, H))),
    )


def ann_bwd_args(mode, d, P):
    """The backward's operands on the plain forward's residuals."""
    out, gates = fused_tp_ann.tp_ann_cell_plain(
        mode, d["wxs"], d["vs"], d["y0"], num_devices=P, save_residuals=True)
    return (mode, d["g"], out, gates, d["vs"], d["y0"])


def _rel(x, y):
    return float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("mode", ANN_MODES)
def test_plain_tp_ann_cell_is_the_plain_fused_ann_cell(mode):
    """At every P the plain TP forward is the single-card plain cell without
    the affine and the dropout, and the plain TP backward its backward; the
    column blocks of a product may round otherwise than the whole product."""
    d = ann_tp_inputs(mode, 8, 9, 512, seed=1)
    want, _, want_g = fused_ann.ann_cell_plain(
        mode, d["wxs"], None, None, d["vs"], d["y0"], save_residuals=True)
    bwant = fused_ann.ann_cell_bwd_plain(mode, d["g"], None, want, want_g,
                                         None, d["vs"], d["y0"])
    for P in PS:
        got, got_g = fused_tp_ann.tp_ann_cell_plain(
            mode, d["wxs"], d["vs"], d["y0"], num_devices=P,
            save_residuals=True)
        for x, y in zip((got, *got_g), (want, *want_g)):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
        dwxs, dvs, dy0 = fused_tp_ann.tp_ann_cell_bwd_plain(
            mode, d["g"], want, want_g, d["vs"], d["y0"], num_devices=P)
        for x, y in zip((*dwxs, *dvs, dy0),
                        (*bwant[0], *bwant[3], bwant[4])):
            assert _rel(x, y) <= 1e-5, (mode, P)


def test_tp_ann_cpu_tensors_take_the_plain_versions():
    fused_cells.reset_launch_counts()
    d = ann_tp_inputs("gru", 8, 4, 256)
    for p in (*d["wxs"], *d["vs"]):
        p.requires_grad_(True)
    out = fused_tp_ann.gru_tp(*d["wxs"], *d["vs"], d["y0"],
                              mesh=_mesh(2, "cpu"))
    (out * d["g"]).sum().backward()
    assert not any(fused_cells.launch_counts().values())
    assert {k.name for k in fused_tp_ann.KERNELS} <= set(
        fused_cells.launch_counts())


def test_tp_ann_checks_raise():
    d = ann_tp_inputs("gru", 8, 2, 256)
    args = (*d["wxs"], *d["vs"], d["y0"])
    with pytest.raises(ValueError, match="divisible by num_model_devices"):
        fused_tp_ann.gru_tp(*args, mesh=_mesh(4, "cpu"))
    # any number of rows: B = 6 at P = 2 gives P = 1's output
    e = ann_tp_inputs("rnn", 6, 2, 256)
    assert torch.equal(
        fused_tp_ann.rnn_tp(*e["wxs"], *e["vs"], e["y0"],
                            mesh=_mesh(2, "cpu")),
        fused_tp_ann.rnn_tp(*e["wxs"], *e["vs"], e["y0"],
                            mesh=_mesh(1, "cpu")))
    # the bf16-stream form runs: a bf16 output from bf16 streams
    y = fused_tp_ann.gru_tp(*[w.bfloat16() for w in d["wxs"]], *args[3:],
                            mesh=_mesh(2, "cpu"), mxu_bf16=True)
    assert y.dtype == torch.bfloat16 and y.shape == d["wxs"][0].shape
    with pytest.raises(ValueError, match="differ in type"):
        fused_tp_ann._tp_ann_cell_cuda(
            "gru", [d["wxs"][0].bfloat16(), *d["wxs"][1:]], d["vs"],
            d["y0"], num_devices=2, mxu_bf16=True)
    # the kernel wrappers check their widths before they launch
    wide = ann_tp_inputs("rnn", 8, 1, 2176)
    with pytest.raises(ValueError, match="H/P <= 2048"):
        fused_tp_ann._tp_ann_cell_cuda("rnn", wide["wxs"], wide["vs"],
                                       wide["y0"], num_devices=1)
    # the stacked exchange's two gathered planes and the tile stages must
    # share one block's shared memory
    wide = ann_tp_inputs("ligru", 8, 1, 4608)
    with pytest.raises(ValueError, match="shared memory"):
        fused_tp_ann._tp_ann_cell_cuda("ligru", wide["wxs"], wide["vs"],
                                       wide["y0"], num_devices=4)


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", ANN_SHAPES)
@pytest.mark.parametrize("mode", ANN_MODES)
def test_tp_ann_forward_kernel_matches_plain_on_card(cuda, mode, shape, P):
    B, T, hl = shape
    d = ann_tp_inputs(mode, B, T, P * hl, seed=2, device=cuda)
    args = (mode, d["wxs"], d["vs"], d["y0"])
    want, want_g = fused_tp_ann.tp_ann_cell_plain(*args, num_devices=P,
                                                  save_residuals=True)
    fused_cells.reset_launch_counts()
    got, got_g = fused_tp_ann._tp_ann_cell_cuda(*args, num_devices=P,
                                                save_residuals=True)
    served = fused_tp_ann._tp_ann_cell_cuda(*args, num_devices=P)
    one, one_g = fused_tp_ann._tp_ann_cell_cuda(*args, num_devices=1,
                                                save_residuals=True)
    single, _, single_g = fused_ann._ann_cell_cuda(
        mode, d["wxs"], None, None, d["vs"], d["y0"], save_residuals=True)
    torch.cuda.synchronize()
    for x, y in zip((got, *got_g), (want, *want_g)):
        assert float((x - y).abs().max()) <= ANN_FWD_ATOL
    assert torch.equal(served, got)
    for x, y, z in zip((got, *got_g), (one, *one_g), (single, *single_g)):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert fused_cells.launch_counts()["tp_ann_fwd"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", ANN_SHAPES)
@pytest.mark.parametrize("mode", ANN_MODES)
def test_tp_ann_backward_kernel_matches_plain_on_card(cuda, mode, shape, P):
    B, T, hl = shape
    d = ann_tp_inputs(mode, B, T, P * hl, seed=3, device=cuda)
    args = ann_bwd_args(mode, d, P)
    got = fused_tp_ann._tp_ann_cell_bwd_cuda(*args, num_devices=P)
    again = fused_tp_ann._tp_ann_cell_bwd_cuda(*args, num_devices=P)
    one = fused_tp_ann._tp_ann_cell_bwd_cuda(*args, num_devices=1)
    want = fused_tp_ann.tp_ann_cell_bwd_plain(*args, num_devices=P)
    _, _, y_seq, gates, vs, y0 = args
    single = fused_ann._ann_cell_bwd_cuda(mode, d["g"], None, y_seq, gates,
                                          None, vs, y0)
    torch.cuda.synchronize()

    def flat(r):
        return (*r[0], *r[1], r[2])

    single = (*single[0], *single[3], single[4])
    for x, y, z, w, s in zip(flat(got), flat(want), flat(again), flat(one),
                             single):
        assert _rel(x, y) <= GRAD_REL
        assert torch.equal(x, z) and torch.equal(x, w) and torch.equal(x, s)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [(8, 5, 512), (136, 3, 512), (16, 4, 1024),
                                   (8, 3, 2048)])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_cluster_ann_kernels_equal_tp_p1_on_card(cuda, mode, shape, bf16):
    """The single-card kernels, each matrix split by columns over the blocks
    of a cluster, give the P = 1 TP kernels' forward output and gate series
    and time-loop gradients (dWx, dy0; dV, their product) bit for bit, in
    both stream modes, at the plan cases these shapes reach: resident and
    streamed slices, 17 clusters, H = 2048 (four rows a cluster in the
    LiGRU's and the GRU's backward); two launches give the same bits."""
    B, T, H = shape
    d = ann_tp_inputs(mode, B, T, H, seed=6, device=cuda)
    wxs, g, vs, y0 = d["wxs"], d["g"], d["vs"], d["y0"]
    if bf16:
        wxs, g = [w.to(torch.bfloat16) for w in wxs], g.to(torch.bfloat16)
    kw = dict(mxu_bf16=bf16)
    one, one_g = fused_tp_ann._tp_ann_cell_cuda(
        mode, wxs, vs, y0, num_devices=1, save_residuals=True, **kw)
    tp = fused_tp_ann._tp_ann_cell_bwd_cuda(mode, g, one, one_g, vs, y0,
                                            num_devices=1, **kw)
    for _ in range(2):
        out, y_raw, gates = fused_ann._ann_cell_cuda(
            mode, wxs, None, None, vs, y0, save_residuals=True, **kw)
        dwxs, dsc, dsh, dvs, dy0 = fused_ann._ann_cell_bwd_cuda(
            mode, g, None, one, list(one_g), None, vs, y0, **kw)
        torch.cuda.synchronize()
        assert y_raw is None and dsc is None and dsh is None
        for x, y in zip((out, *gates), (one, *one_g)):
            assert torch.equal(x, y)
        for x, y in zip((*dwxs, *dvs, dy0), (*tp[0], *tp[1], tp[2])):
            assert torch.equal(x, y)


def _walks(plan, P):
    """The plan walks: fewer clusters a rank than row groups, and no more
    clusters than the card holds."""
    return (plan["walks"] > 1 and plan["clusters_per_rank"] * P
            <= plan["max_active_clusters"])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("mode", ANN_MODES)
def test_tp_ann_kernels_at_h2048_on_card(cuda, mode, P, bf16):
    """H = 2048, the single-card kernels' widest layer, over P ranks in
    both stream modes: the forward's output and gate series and the time
    loop's gradients (dWx, dy0; dV, their product) equal the single-card
    kernels' without the affine bit for bit (the LiGRU's and the GRU's
    backward at four rows a cluster)."""
    B, T, H = 16, 3, 2048
    d = ann_tp_inputs(mode, B, T, H, seed=7, device=cuda)
    wxs, g, vs, y0 = d["wxs"], d["g"], d["vs"], d["y0"]
    if bf16:
        wxs, g = [w.to(torch.bfloat16) for w in wxs], g.to(torch.bfloat16)
    kw = dict(mxu_bf16=bf16)
    out, gates = fused_tp_ann._tp_ann_cell_cuda(
        mode, wxs, vs, y0, num_devices=P, save_residuals=True, **kw)
    grads = fused_tp_ann._tp_ann_cell_bwd_cuda(mode, g, out, gates, vs, y0,
                                               num_devices=P, **kw)
    bwd_plan = fused_tp_ann.last_plan("tp_ann_bwd")
    single, _, single_g = fused_ann._ann_cell_cuda(
        mode, wxs, None, None, vs, y0, save_residuals=True, **kw)
    sgrads = fused_ann._ann_cell_bwd_cuda(mode, g, None, out, list(gates),
                                          None, vs, y0, **kw)
    torch.cuda.synchronize()
    assert mode == "rnn" or bwd_plan["rows"] == 4, bwd_plan
    assert torch.isfinite(out.float()).all()
    for x, y in zip((out, *gates), (single, *single_g)):
        assert torch.equal(x, y)
    for x, y in zip((*grads[0], *grads[1], grads[2]),
                    (*sgrads[0], *sgrads[3], sgrads[4])):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ANN_MODES)
def test_tp_ann_kernels_walk_row_groups_on_card(cuda, mode):
    """More row groups than the card holds clusters: at P = 4 and B = 1024
    each rank has 128 groups of 8 rows, and a cluster walks several, in the
    same order on every rank."""
    P = 4
    d = ann_tp_inputs(mode, 1024, 6, P * 128, seed=4, device=cuda)
    args = (mode, d["wxs"], d["vs"], d["y0"])
    got, got_g = fused_tp_ann._tp_ann_cell_cuda(*args, num_devices=P,
                                                save_residuals=True)
    plan = fused_tp_ann.last_plan("tp_ann_fwd")
    bargs = (mode, d["g"], got, got_g, d["vs"], d["y0"])
    grads = fused_tp_ann._tp_ann_cell_bwd_cuda(*bargs, num_devices=P)
    bwd_plan = fused_tp_ann.last_plan("tp_ann_bwd")
    want, want_g = fused_tp_ann.tp_ann_cell_plain(*args, num_devices=P,
                                                  save_residuals=True)
    want_grads = fused_tp_ann.tp_ann_cell_bwd_plain(*bargs, num_devices=P)
    torch.cuda.synchronize()
    assert _walks(plan, P) and _walks(bwd_plan, P), (plan, bwd_plan)
    for x, y in zip((got, *got_g), (want, *want_g)):
        assert float((x - y).abs().max()) <= ANN_FWD_ATOL
    for x, y in zip((*grads[0], *grads[1], grads[2]),
                    (*want_grads[0], *want_grads[1], want_grads[2])):
        assert _rel(x, y) <= GRAD_REL


@pytest.mark.cuda
def test_tp_ann_gru_at_its_widest_on_card(cuda):
    """The GRU at the widest layer two ranks take, H = 4096 (H/P = 2048;
    one more lane of 128 a rank fails ``_check_width``): four rows a
    cluster, and the backward's three planes of gathered rows (the stacked
    [dcpre | dzpre] and drpre) fill a block's shared memory beside stages
    of a few rows of the slice."""
    P, B, T, H = 2, 8, 3, 4096
    fused_tp_ann._check_width("gru", H, P, False)
    with pytest.raises(ValueError, match="H/P <= 2048"):
        fused_tp_ann._check_width("gru", H + P * 128, P, False)
    d = ann_tp_inputs("gru", B, T, H, seed=5, device=cuda)
    args = ("gru", d["wxs"], d["vs"], d["y0"])
    got, got_g = fused_tp_ann._tp_ann_cell_cuda(*args, num_devices=P,
                                                save_residuals=True)
    bargs = ("gru", d["g"], got, got_g, d["vs"], d["y0"])
    grads = fused_tp_ann._tp_ann_cell_bwd_cuda(*bargs, num_devices=P)
    want, want_g = fused_tp_ann.tp_ann_cell_plain(*args, num_devices=P,
                                                  save_residuals=True)
    want_grads = fused_tp_ann.tp_ann_cell_bwd_plain(*bargs, num_devices=P)
    torch.cuda.synchronize()
    plan = fused_tp_ann.last_plan("tp_ann_bwd")
    assert plan["rows"] == 4 and not plan["resident"], plan
    for x, y in zip((got, *got_g), (want, *want_g)):
        assert float((x - y).abs().max()) <= ANN_FWD_ATOL
    for x, y in zip((*grads[0], *grads[1], grads[2]),
                    (*want_grads[0], *want_grads[1], want_grads[2])):
        assert _rel(x, y) <= GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("ann_type,cell", [("GRU", "gru"), ("LiGRU", "ligru"),
                                           ("RNN", "rnn")])
def test_model_reaches_the_tp_ann_kernels_on_card(cuda, ann_type, cell):
    B, T, F, H, C, P = 16, 20, 24, 256, 5, 2
    model = build_model(ann_type, (B, T, F), [H, H, C], dropout=0.1,
                        cell_impl="pallas_tp", tp_mesh=_mesh(P, "cuda"),
                        bidirectional=ann_type == "LiGRU",
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.randn((B, T, F), device=cuda)
    fused_cells.reset_launch_counts()
    out, _ = model(x, torch.Generator(device=cuda).manual_seed(1))
    out.sum().backward()
    torch.cuda.synchronize()
    counts = {k: n for k, n in fused_cells.launch_counts().items() if n}
    assert counts == {"tp_ann_fwd": 2, "tp_ann_bwd": 2}
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("P", (2, 4))
def test_tp_ann_gru_exchanges_land_on_fixed_parities_on_card(cuda, P,
                                                             monkeypatch):
    """The GRU's two exchanges of a step have consecutive indices, so r*y
    always lands in slot 0 and y in slot 1 (the backpressure argument of
    pallas_tp_ann.py:38-44), and in the backward [dcpre|dzpre] in slot 0
    and drpre in slot 1. After a launch every rank's slots hold the last
    exchange of each kind: in the forward r*y of step T-1 and y of step T-2
    (the last y gather is skipped), in the backward those of step 0."""
    slots = []
    exchange_buffers = fused_tp._exchange_buffers

    def keep(*args, **kw):
        bufs = exchange_buffers(*args, **kw)
        slots.append(bufs[0])
        return bufs

    monkeypatch.setattr(fused_tp, "_exchange_buffers", keep)
    B, T, H = 8, 7, P * 128
    d = ann_tp_inputs("gru", B, T, H, seed=6, device=cuda)
    out, (z, r, c) = fused_tp_ann._tp_ann_cell_cuda(
        "gru", d["wxs"], d["vs"], d["y0"], num_devices=P,
        save_residuals=True)
    dwxs, _, _ = fused_tp_ann._tp_ann_cell_bwd_cuda(
        "gru", d["g"], out, (z, r, c), d["vs"], d["y0"], num_devices=P)
    torch.cuda.synchronize()
    fwd, bwd = slots  # (P, 2, B, H) and (P, 2, B, 2H)
    for q in range(P):
        assert torch.equal(fwd[q, 0], r[:, -1] * out[:, -2])
        assert torch.equal(fwd[q, 1], out[:, -2])
        assert torch.equal(bwd[q, 0], torch.cat([dwxs[0][:, 0],
                                                 dwxs[1][:, 0]], dim=1))
        assert torch.equal(bwd[q, 1, :, :H], dwxs[2][:, 0])


# ---------------------------------------------------------------------------
# The bf16-stream form of the four TP kernels (mxu_bf16=True)
# ---------------------------------------------------------------------------
#
# Bounds, as for the single-card bf16 kernels (tests/test_torch_kernels.py):
# the spiking forward is exact (V on the 2^-8 grid and s0 on sixteenths are
# bf16 values, so every product is exact in float32 in any order); elsewhere
# a float32 sum taken in another order than the plain version's can tip a
# rounding to bf16, and a tipped operand moves the next step's sums, so a
# bf16 stream is held to one bf16 ulp of a value in [1, 2), 2^-7, relative
# to max(1, |v|) (forward) or to the gradient's largest magnitude
# (backward), and a gradient reduced in float32 to 2^-7 of its largest
# magnitude too (at these shapes it may sum few terms); a value past its
# bound is held by the witness rule: with the plain version in float64
# (same rounding points) as the truth, the kernel may be no further from it
# than 4 times the float32 plain version is. Across P and between launches
# everything is bit for bit; against the single-card bf16 kernels the
# forward is bit for bit (every product sums its rows in one ascending
# order), the backward's gradients that sum over no rows too, and the rest
# within the bounds above.

BF16_ULP = 2.0 ** -7
WITNESS_FACTOR = 4.0


def _within(x, y, scale, what, truth=None):
    """``x`` within ``BF16_ULP * scale`` of ``y`` elementwise, or else (with
    ``truth``, a function that gives the float64 plain version) no further
    from the truth than WITNESS_FACTOR times ``y`` is."""
    x, y = x.double(), y.double()
    err = (x - y).abs()
    if bool((err <= BF16_ULP * scale).all()):
        return
    assert truth is not None, (what, float(err.max()))
    t = truth().double()
    far, base = float((x - t).abs().max()), float((y - t).abs().max())
    assert far <= WITNESS_FACTOR * base, (what, far, base)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    if isinstance(x, (list, tuple)):
        return [_f64(v) for v in x]
    return x


def _bf16_tp_inputs(B, T, H, seed, device, wx_bf16):
    d = tp_inputs(B, T, H, seed=seed, device=device)
    # |k| <= 255 on the 2^-8 grid: bf16 holds V exactly
    d["V"] = d["V"].clamp(-255 / 256, 255 / 256)
    if wx_bf16:
        d["Wx"] = d["Wx"].bfloat16()
    d["g"] = d["g"].bfloat16()
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", [(8, 13, 128), (24, 20, 256),
                                   (256, 100, 256)] + RAGGED)
@pytest.mark.parametrize("wx_bf16", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_bf16_forward_kernel_matches_plain_on_card(cuda, adaptive, wx_bf16,
                                                   shape, P):
    B, T, hl = shape
    H = P * hl if B < 256 else 1024
    d = _bf16_tp_inputs(B, T, H, 2, cuda, wx_bf16)
    args = cell_args(d, adaptive)
    kw = dict(adaptive=adaptive, mxu_bf16=True)
    want, want_u = fused_tp.tp_cell_plain(*args, num_devices=P,
                                          save_residuals=True, **kw)
    fused_cells.reset_launch_counts()
    got, got_u = fused_tp._tp_cell_cuda(*args, num_devices=P,
                                        save_residuals=True, **kw)
    again = fused_tp._tp_cell_cuda(*args, num_devices=P, **kw)
    one, one_u = fused_tp._tp_cell_cuda(*args, num_devices=1,
                                        save_residuals=True, **kw)
    single, single_u = fused_cells._fused_cell_cuda(
        args[0], None, None, *args[1:], recurrent=True, adaptive=adaptive,
        save_residuals=True, mxu_bf16=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got_u.dtype == torch.float32
    assert 0 < float(want.float().mean()) < 0.5
    for x, y in ((got, want), (got_u, want_u), (again, want), (got, one),
                 (got_u, one_u), (got, single), (got_u, single_u)):
        assert torch.equal(x, y)
    assert fused_cells.launch_counts()["tp_cell_fwd_bf16"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", [(8, 13, 128), (24, 20, 256),
                                   (256, 100, 256)] + RAGGED)
@pytest.mark.parametrize("adaptive", [False, True])
def test_bf16_backward_kernel_matches_plain_on_card(cuda, adaptive, shape, P):
    """s0 uniform, as the uniform state init draws it: the first product
    and dV round it to bf16."""
    B, T, hl = shape
    H = P * hl if B < 256 else 1024
    d = _bf16_tp_inputs(B, T, H, 3, cuda, False)
    d["s0"] = torch.rand(d["s0"].shape, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(3))
    kw = dict(adaptive=adaptive, mxu_bf16=True)
    _, u_seq = fused_tp.tp_cell_plain(*cell_args(d, adaptive), num_devices=P,
                                      save_residuals=True, **kw)
    args = bwd_args(d, u_seq, adaptive)
    fused_cells.reset_launch_counts()
    got = fused_tp._tp_cell_bwd_cuda(*args, num_devices=P, **kw)
    again = fused_tp._tp_cell_bwd_cuda(*args, num_devices=P, **kw)
    one = fused_tp._tp_cell_bwd_cuda(*args, num_devices=1, **kw)
    want = fused_tp.tp_cell_bwd_plain(*args, num_devices=P, **kw)
    g, u_seq, *rest = args
    single = fused_cells._fused_cell_bwd_cuda(
        g, None, u_seq, None, *rest, recurrent=True, adaptive=adaptive,
        mxu_bf16=True)
    single = dict(zip(("dWx", "dscale", "dshift", "dV", "dalpha", "dbeta",
                       "da", "db", "du0", "dw0", "ds0"), single))
    torch.cuda.synchronize()
    assert fused_cells.launch_counts()["tp_cell_bwd_bf16"] == 3
    truth = []

    def witness(k):
        if not truth:
            truth.extend(fused_tp.tp_cell_bwd_plain(*_f64(list(args)),
                                                    num_devices=P, **kw))
        return truth[k]

    for k, (name, x, y, z, w) in enumerate(zip(GRADS, got, want, again,
                                               one)):
        if x is None:
            assert y is None and not adaptive
            continue
        assert x.dtype == (torch.bfloat16 if name == "dWx"
                           else torch.float32), name
        scale = y.double().abs().max()
        _within(x, y, scale, name, lambda k=k: witness(k))
        _within(x, single[name], scale, f"{name} vs the single-card kernel",
                lambda k=k: witness(k))
        assert torch.equal(x, z), name
        if name in ("dWx", "dV", "du0", "dw0", "ds0"):
            # no reduction over rows: the split changes no sum, and the
            # single-card kernel takes the same arithmetic in the same order
            assert torch.equal(x, w), name
            assert torch.equal(x, single[name]), name


@pytest.mark.cuda
def test_bf16_tp_cell_kernels_walk_row_groups_on_card(cuda):
    """At P = 4 and B = 1024 a rank has more rows (forward) and row groups
    (backward) than the card holds blocks."""
    P = 4
    d = _bf16_tp_inputs(1024, 6, P * 128, 4, cuda, True)
    args = cell_args(d, True)
    kw = dict(num_devices=P, adaptive=True, mxu_bf16=True)
    got, u_seq = fused_tp._tp_cell_cuda(*args, save_residuals=True, **kw)
    fwd_plan = fused_tp.last_plans()["tp_cell_fwd"]
    grads = fused_tp._tp_cell_bwd_cuda(*bwd_args(d, u_seq, True), **kw)
    bwd_plan = fused_tp.last_bwd_plan()
    want, want_u = fused_tp.tp_cell_plain(*args, save_residuals=True, **kw)
    want_grads = fused_tp.tp_cell_bwd_plain(*bwd_args(d, u_seq, True), **kw)
    torch.cuda.synchronize()
    assert fwd_plan["walks"] > 1 and bwd_plan["walks"] > 1, (fwd_plan,
                                                          bwd_plan)
    assert torch.equal(got, want) and torch.equal(u_seq, want_u)
    for k, (name, x, y) in enumerate(zip(GRADS, grads, want_grads)):
        _within(x, y, y.double().abs().max(), name,
                lambda k=k: fused_tp.tp_cell_bwd_plain(
                    *_f64(list(bwd_args(d, u_seq, True))), **kw)[k])


def _bf16_ann_inputs(mode, B, T, H, seed, device, wx_bf16):
    d = ann_tp_inputs(mode, B, T, H, seed=seed, device=device)
    if wx_bf16:
        d["wxs"] = [w.bfloat16() for w in d["wxs"]]
    d["g"] = d["g"].bfloat16()
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", ANN_SHAPES)
@pytest.mark.parametrize("wx_bf16", [False, True])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_bf16_tp_ann_forward_kernel_matches_plain_on_card(cuda, mode,
                                                          wx_bf16, shape, P):
    B, T, hl = shape
    d = _bf16_ann_inputs(mode, B, T, P * hl, 2, cuda, wx_bf16)
    args = (mode, d["wxs"], d["vs"], d["y0"])
    kw = dict(mxu_bf16=True)
    want, want_g = fused_tp_ann.tp_ann_cell_plain(
        *args, num_devices=P, save_residuals=True, **kw)
    fused_cells.reset_launch_counts()
    got, got_g = fused_tp_ann._tp_ann_cell_cuda(
        *args, num_devices=P, save_residuals=True, **kw)
    served = fused_tp_ann._tp_ann_cell_cuda(*args, num_devices=P, **kw)
    one, one_g = fused_tp_ann._tp_ann_cell_cuda(
        *args, num_devices=1, save_residuals=True, **kw)
    single, _, single_g = fused_ann._ann_cell_cuda(
        mode, d["wxs"], None, None, d["vs"], d["y0"], save_residuals=True,
        **kw)
    torch.cuda.synchronize()
    assert fused_cells.launch_counts()["tp_ann_fwd_bf16"] == 3
    truth = []

    def witness(i):
        if not truth:
            t_out, t_g = fused_tp_ann.tp_ann_cell_plain(
                mode, *_f64(list(args[1:])), num_devices=P,
                save_residuals=True, **kw)
            truth.extend([t_out, *t_g])
        return truth[i]

    for i, (x, y) in enumerate(zip((got, *got_g), (want, *want_g))):
        assert x.dtype == torch.bfloat16
        _within(x, y, y.double().abs().clamp_min(1.0), (mode, i),
                lambda i=i: witness(i))
    assert torch.equal(served, got)
    for x, y, z in zip((got, *got_g), (one, *one_g), (single, *single_g)):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", ANN_SHAPES)
@pytest.mark.parametrize("mode", ANN_MODES)
def test_bf16_tp_ann_backward_kernel_matches_plain_on_card(cuda, mode, shape,
                                                           P):
    B, T, hl = shape
    d = _bf16_ann_inputs(mode, B, T, P * hl, 3, cuda, False)
    kw = dict(mxu_bf16=True)
    out, gates = fused_tp_ann.tp_ann_cell_plain(
        mode, d["wxs"], d["vs"], d["y0"], num_devices=P, save_residuals=True,
        **kw)
    args = (mode, d["g"], out, gates, d["vs"], d["y0"])
    fused_cells.reset_launch_counts()
    got = fused_tp_ann._tp_ann_cell_bwd_cuda(*args, num_devices=P, **kw)
    again = fused_tp_ann._tp_ann_cell_bwd_cuda(*args, num_devices=P, **kw)
    one = fused_tp_ann._tp_ann_cell_bwd_cuda(*args, num_devices=1, **kw)
    want = fused_tp_ann.tp_ann_cell_bwd_plain(*args, num_devices=P, **kw)
    single = fused_ann._ann_cell_bwd_cuda(mode, d["g"], None, out,
                                          list(gates), None, d["vs"],
                                          d["y0"], **kw)
    torch.cuda.synchronize()
    assert fused_cells.launch_counts()["tp_ann_bwd_bf16"] == 3

    def flat(r):
        return (*r[0], *r[1], r[2])

    truth = []

    def witness(k):
        if not truth:
            truth.extend(flat(fused_tp_ann.tp_ann_cell_bwd_plain(
                mode, *_f64(list(args[1:])), num_devices=P, **kw)))
        return truth[k]

    n = fused_ann.MODES[mode]
    single = (*single[0], *single[3], single[4])
    for k, (x, y, z, w, s) in enumerate(zip(flat(got), flat(want),
                                            flat(again), flat(one), single)):
        assert x.dtype == (torch.bfloat16 if k < n else torch.float32)
        _within(x, y, y.double().abs().max(), (mode, k),
                lambda k=k: witness(k))
        assert torch.equal(x, z) and torch.equal(x, w) and torch.equal(x, s)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ANN_MODES)
def test_bf16_tp_ann_kernels_walk_row_groups_on_card(cuda, mode):
    P = 4
    d = _bf16_ann_inputs(mode, 1024, 6, P * 128, 4, cuda, True)
    args = (mode, d["wxs"], d["vs"], d["y0"])
    kw = dict(num_devices=P, mxu_bf16=True)
    got, got_g = fused_tp_ann._tp_ann_cell_cuda(*args, save_residuals=True,
                                                **kw)
    plan = fused_tp_ann.last_plan("tp_ann_fwd")
    bargs = (mode, d["g"], got, got_g, d["vs"], d["y0"])
    grads = fused_tp_ann._tp_ann_cell_bwd_cuda(*bargs, **kw)
    bwd_plan = fused_tp_ann.last_plan("tp_ann_bwd")
    want, want_g = fused_tp_ann.tp_ann_cell_plain(*args, save_residuals=True,
                                                  **kw)
    want_grads = fused_tp_ann.tp_ann_cell_bwd_plain(*bargs, **kw)
    torch.cuda.synchronize()
    assert _walks(plan, P) and _walks(bwd_plan, P), (plan, bwd_plan)
    truth = []

    def witness(k):
        if not truth:
            t_out, t_g = fused_tp_ann.tp_ann_cell_plain(
                mode, *_f64(list(args[1:])), save_residuals=True, **kw)
            t_grads = fused_tp_ann.tp_ann_cell_bwd_plain(
                mode, *_f64(list(bargs[1:])), **kw)
            truth.extend([t_out, *t_g, *t_grads[0], *t_grads[1],
                          t_grads[2]])
        return truth[k]

    pairs = list(zip((got, *got_g), (want, *want_g)))
    n_fwd = len(pairs)
    pairs += list(zip((*grads[0], *grads[1], grads[2]),
                      (*want_grads[0], *want_grads[1], want_grads[2])))
    for k, (x, y) in enumerate(pairs):
        scale = (y.double().abs().clamp_min(1.0) if k < n_fwd
                 else y.double().abs().max())
        _within(x, y, scale, (mode, k), lambda k=k: witness(k))


@pytest.mark.cuda
@pytest.mark.parametrize("P", (2, 4))
def test_bf16_wire_slots_hold_bf16_values_on_card(cuda, P, monkeypatch):
    """The bf16 wire: every slot buffer is bf16 and holds, after a launch,
    the last exchange of each kind rounded once. The GRU forward's y slot
    holds y of step T-2, the very bf16 value of the output stream; its r*y
    slot bf16(r*y) of step T-1 from the float32 r and y, within one ulp of
    the product of the two bf16 series; the backward's slots hold the dpre
    of step 0, equal to the dWx streams; the spiking backward's slot the D
    of step 0, equal to dWx."""
    slots = []
    exchange_buffers = fused_tp._exchange_buffers

    def keep(*args, **kw):
        bufs = exchange_buffers(*args, **kw)
        slots.append(bufs[0])
        return bufs

    monkeypatch.setattr(fused_tp, "_exchange_buffers", keep)
    B, T, H = 8, 7, P * 128
    d = _bf16_ann_inputs("gru", B, T, H, 6, cuda, False)
    out, (z, r, c) = fused_tp_ann._tp_ann_cell_cuda(
        "gru", d["wxs"], d["vs"], d["y0"], num_devices=P,
        save_residuals=True, mxu_bf16=True)
    dwxs, _, _ = fused_tp_ann._tp_ann_cell_bwd_cuda(
        "gru", d["g"], out, (z, r, c), d["vs"], d["y0"], num_devices=P,
        mxu_bf16=True)
    e = _bf16_tp_inputs(B, T, H, 6, cuda, False)
    _, u_seq = fused_tp.tp_cell_plain(*cell_args(e, True), num_devices=P,
                                      adaptive=True, save_residuals=True,
                                      mxu_bf16=True)
    grads = fused_tp._tp_cell_bwd_cuda(*bwd_args(e, u_seq, True),
                                       num_devices=P, adaptive=True,
                                       mxu_bf16=True)
    torch.cuda.synchronize()
    fwd, bwd, spk = slots  # (P, 2, B, H), (P, 2, B, 2H), (P, 2, B, H)
    assert fwd.dtype == bwd.dtype == spk.dtype == torch.bfloat16
    ry = r[:, -1].float() * out[:, -2].float()
    for q in range(P):
        assert torch.equal(fwd[q, 1], out[:, -2])
        _within(fwd[q, 0], ry, 1.0, "r*y")  # r*y lies in (-1, 1)
        assert torch.equal(bwd[q, 0], torch.cat([dwxs[0][:, 0],
                                                 dwxs[1][:, 0]], dim=1))
        assert torch.equal(bwd[q, 1, :, :H], dwxs[2][:, 0])
        # T exchanges: step 0's is the last, on parity (T - 1) & 1
        assert torch.equal(spk[q, (T - 1) & 1], grads[0][:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["RLIF", "RadLIF", "LIF", "adLIF",
                                        "RNN", "LiGRU", "GRU"])
def test_model_reaches_the_bf16_tp_kernels_on_card(cuda, model_type):
    B, T, F, H, C, P = 16, 20, 24, 256, 5, 2
    model = build_model(model_type, (B, T, F), [H, H, C], dropout=0.1,
                        cell_impl="pallas_tp", tp_mesh=_mesh(P, "cuda"),
                        bidirectional=model_type in ("RadLIF", "LiGRU"),
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.rand((B, T, F), device=cuda) * 3
    fused_cells.reset_launch_counts()
    out, _ = model(x, torch.Generator(device=cuda).manual_seed(1))
    out.float().sum().backward()
    torch.cuda.synchronize()
    counts = {k: n for k, n in fused_cells.launch_counts().items() if n}
    if model_type in ("RLIF", "RadLIF"):
        want = {"tp_cell_fwd_bf16": 2, "tp_cell_bwd_bf16": 2}
    elif model_type in ("LIF", "adLIF"):
        want = {"fused_cell_fwd_train_bf16": 2 * P,
                "fused_cell_bwd_bf16": 2 * P}
    else:
        want = {"tp_ann_fwd_bf16": 2, "tp_ann_bwd_bf16": 2}
    assert counts == want
    assert torch.isfinite(out).all()
    assert all(p.dtype == p.grad.dtype == torch.float32 and
               torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("P", PS)
def test_tp_backward_at_the_widest_rank_on_card(cuda, P, bf16):
    """H/P = 2048, the widest rank: H = 2048, 4096, 8192 at P = 1, 2, 4, so
    eight, four and two rows a cluster (a thread owns them all): every
    gradient against the plain backward (float32: 1e-4 of its largest
    magnitude; bf16: the bounds above), two launches give the same bits,
    and where the single-card kernel takes the width (H <= 4096) the
    gradients that sum over no rows equal its own."""
    B, T, H = 8, 3, 2048 * P
    d = _bf16_tp_inputs(B, T, H, 6, cuda, False) if bf16 else \
        tp_inputs(B, T, H, seed=6, device=cuda)
    kw = dict(num_devices=P, adaptive=True, mxu_bf16=bf16)
    _, u_seq = fused_tp.tp_cell_plain(*cell_args(d, True),
                                      save_residuals=True, **kw)
    args = bwd_args(d, u_seq, True)
    got = fused_tp._tp_cell_bwd_cuda(*args, **kw)
    plan = fused_tp.last_bwd_plan()
    again = fused_tp._tp_cell_bwd_cuda(*args, **kw)
    want = fused_tp.tp_cell_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert plan["rows"] == {1: 8, 2: 4, 4: 2}[P], plan
    for k, (name, x, y, z) in enumerate(zip(GRADS, got, want, again)):
        assert torch.equal(x, z), name
        if bf16:
            _within(x, y, y.double().abs().max(), name,
                    lambda k=k: fused_tp.tp_cell_bwd_plain(
                        *_f64(list(args)), **kw)[k])
        else:
            assert _rel(x, y) <= GRAD_REL, (name, _rel(x, y))
    if H <= 4096:
        single = fused_cells._fused_cell_bwd_cuda(
            args[0], d["Wx"], args[1], None, *args[2:], recurrent=True,
            adaptive=True, mxu_bf16=bf16)
        single = dict(zip(("dWx", "dscale", "dshift", "dV", "dalpha", "dbeta",
                           "da", "db", "du0", "dw0", "ds0"), single))
        for name, x in zip(GRADS, got):
            if name in ("dWx", "dV", "du0", "dw0", "ds0"):
                assert torch.equal(x, single[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_cluster_tp_backward_equals_across_p_on_card(cuda, adaptive, bf16):
    """At (16, 7, 512) the clusters of P = 1, 2, 4 (their own cluster
    sizes and partials) give the gradients that sum over no rows bit for
    bit alike, and those of the single-card kernel without the affine and
    the dropout: every column sums its H rows in one ascending order,
    whatever the plan."""
    B, T, H = 16, 7, 512
    d = _bf16_tp_inputs(B, T, H, 8, cuda, False) if bf16 else \
        tp_inputs(B, T, H, seed=8, device=cuda)
    _, u_seq = fused_tp.tp_cell_plain(*cell_args(d, adaptive), num_devices=1,
                                      adaptive=adaptive, save_residuals=True,
                                      mxu_bf16=bf16)
    args = bwd_args(d, u_seq, adaptive)
    single = fused_cells._fused_cell_bwd_cuda(
        args[0], d["Wx"], args[1], None, *args[2:], recurrent=True,
        adaptive=adaptive, mxu_bf16=bf16)
    single = dict(zip(("dWx", "dscale", "dshift", "dV", "dalpha", "dbeta",
                       "da", "db", "du0", "dw0", "ds0"), single))
    for P in PS:
        got = fused_tp._tp_cell_bwd_cuda(*args, num_devices=P,
                                         adaptive=adaptive, mxu_bf16=bf16)
        torch.cuda.synchronize()
        for name, x in zip(GRADS, got):
            if name in ("dWx", "dV", "du0", "dw0", "ds0") and x is not None:
                assert torch.equal(x, single[name]), (P, name)
