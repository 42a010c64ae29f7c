"""The port's tensor-parallel wrappers and CUDA kernels (ops/fused_tp.py),
without JAX.

On the CPU: a CPU tensor runs the plain versions and launches nothing; the
plain TP cell at any P equals the single-card plain fused cell without the
affine, bit for bit; the checks the JAX package makes raise here too.

On a card (tests marked ``cuda``, which skip without one), in the one-card
form at P = 1, 2, 4: the exchange harnesses equal their plain versions bit
for bit, launch after launch; the TP forward's spikes and membrane series
equal the plain version's and the single-card kernel's bit for bit (V on a
dyadic grid, s0 on sixteenths, so every product is exact); every gradient
of the TP backward agrees with the plain backward on the same residuals to
1e-4 of that gradient's largest magnitude, two launches give the same bits,
and the gradients that no reduction over rows touches are equal across P.

    python -m pytest tests/test_torch_tp_kernels.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.ops import fused_cells, fused_tp
from sparch_tpu_torch.parallel import make_mesh

PS = (1, 2, 4)
GRAD_REL = 1e-4
GRADS = ("dWx", "dV", "dalpha", "dbeta", "da", "db", "du0", "dw0", "ds0")


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
    e = tp_inputs(6, 3, 256)
    with pytest.raises(ValueError, match="B%8==0"):
        fused_tp.rlif_tp(*[e[k] for k in ("Wx", "alpha", "V")], 1.0,
                         e["u0"], e["s0"], mesh=_mesh(2, "cpu"))
    with pytest.raises(NotImplementedError, match="item 11"):
        fused_tp.rlif_tp(args[0].bfloat16(), *args[1:], 1.0, d["u0"],
                         d["s0"], mesh=_mesh(2, "cpu"))
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


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("B,Hl", [(8, 128), (128, 256)])
def test_collectives_match_plain_on_card(cuda, P, B, Hl):
    rng = np.random.default_rng(P)
    H = P * Hl
    x = torch.from_numpy(rng.normal(0, 1, (B, H)).astype(np.float32)).to(cuda)
    parts = torch.from_numpy(rng.normal(0, 1, (P, B, H)).astype(
        np.float32)).to(cuda)
    want_ag = fused_tp.tp_all_gather_plain(x, num_devices=P, rounds=3)
    want_rs = fused_tp.tp_reduce_scatter_plain(parts, num_devices=P,
                                               rounds=3)
    fused_cells.reset_launch_counts()
    # back to back: every launch zeroes its own counters
    for _ in range(3):
        got_ag = fused_tp.tp_all_gather(x, num_devices=P, rounds=3)
        got_rs = fused_tp.tp_reduce_scatter(parts, num_devices=P, rounds=3)
        torch.cuda.synchronize()
        assert torch.equal(got_ag, want_ag)
        assert torch.equal(got_rs, want_rs)
    counts = fused_cells.launch_counts()
    assert counts["tp_all_gather"] == counts["tp_reduce_scatter"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", [(8, 13, 128), (24, 20, 256),
                                   (256, 100, 256)])
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
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("shape", [(8, 13, 128), (24, 20, 256),
                                   (256, 100, 256)])
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
