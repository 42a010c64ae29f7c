"""The tensor-parallel kernels across cards (``ops/tp_cards.py``, one rank a
card), without JAX. Every test is marked ``cuda`` and skips where the
process sees fewer cards than it needs (two, four for P = 4).

- The collectives (``csrc/tp_collectives.cu``) across P cards equal their
  plain versions bit for bit at ragged and full B and 1 and 3 rounds.
- The RLIF/RadLIF forward and backward (``csrc/tp_cell_fwd.cu``,
  ``tp_cell_bwd.cu``) across P cards equal the one-card form at the same P
  bit for bit, both stream modes, on a non-dyadic V: the spikes, the
  membrane series, and every gradient, dV (each rank's block from the full
  u series gathered onto its card) and the partial sums of dalpha, dbeta,
  da and db included; also in the forward's layout of a block a row (H =
  2048, where no slice of V fits in shared memory).
- ``radlif_tp`` with autograd and ``lif_tp`` on a mesh across cards equal
  the one-card mesh's outputs and gradients bit for bit.
- The entry barrier: 100 calls back to back with no host wait between them
  give the first call's bits every time.

    python -m pytest tests/test_torch_tp_cards_kernels.py -m cuda --noconftest -q
"""
import pytest
import torch

from sparch_tpu_torch.ops import fused_cells, fused_tp
from sparch_tpu_torch.parallel import make_mesh

pytestmark = pytest.mark.cuda

THR = 1.0
GRADS = ("dWx", "dV", "dalpha", "dbeta", "da", "db", "du0", "dw0", "ds0")


def cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    return tuple(torch.device("cuda", i) for i in range(n))


def cell_inputs(B, T, H, seed, dev):
    """Operands as ``fused_tp._prepare`` leaves them (V zero-diagonal, not
    on a grid), s0 uniform, g for the backward."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=g)).to(dev)

    V = (torch.randn(H, H, generator=g) * 0.3 * (1 - torch.eye(H))).to(dev)
    return dict(Wx=(torch.randn(B, T, H, generator=g) * 1.5).to(dev),
                alpha=r(H, lo=0.6, hi=0.96), beta=r(H, lo=0.6, hi=0.96),
                a=r(H, lo=-1.0), b=r(H, hi=2.0), V=V, u0=r(B, H),
                w0=r(B, H), s0=r(B, H),
                g=torch.randn(B, T, H, generator=g).to(dev))


def args_of(d, adaptive):
    return (d["Wx"], d["alpha"], d["beta"] if adaptive else None,
            d["a"] if adaptive else None, d["b"] if adaptive else None,
            d["V"], THR, d["u0"], d["w0"] if adaptive else None, d["s0"])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("B,rounds", [(13, 1), (128, 3)])
def test_collectives_across_cards_equal_plain(P, B, rounds):
    on = cards(P)
    g = torch.Generator(device=on[0]).manual_seed(P)
    x = torch.randn(B, P * 256, device=on[0], generator=g)
    parts = torch.randn(P, B, P * 256, device=on[0], generator=g)
    kw = dict(num_devices=P, rounds=rounds)
    ag = fused_tp.tp_all_gather(x, cards=on, **kw)
    rs = fused_tp.tp_reduce_scatter(parts, cards=on, **kw)
    assert ag.device == rs.device == on[0]
    assert torch.equal(ag.cpu(), fused_tp.tp_all_gather_plain(x.cpu(), **kw))
    assert torch.equal(rs.cpu(),
                       fused_tp.tp_reduce_scatter_plain(parts.cpu(), **kw))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("cell", ["rlif", "radlif"])
@pytest.mark.parametrize("B,T,H", [(16, 20, 1024), (8, 7, 2048)],
                         ids=["slices", "rows"])
def test_cell_across_cards_equals_one_card(cell, P, bf16, B, T, H):
    on = cards(P)
    adaptive = cell == "radlif"
    d = cell_inputs(B, T, H, seed=P, dev=on[0])
    args = args_of(d, adaptive)
    kw = dict(adaptive=adaptive, mxu_bf16=bf16)
    with torch.no_grad():
        s, u = fused_tp._tp_cell_cuda(*args, num_devices=P,
                                      save_residuals=True, **kw)
        cs, cu = fused_tp._tp_cell_cards(*args, cards=on,
                                         save_residuals=True, **kw)
        layout = fused_tp.last_plans()["tp_cell_fwd"]["layout"]
        assert layout == ("slices" if H == 1024 else "rows")
        assert [x.device for x in cu] == list(on)
        assert torch.equal(cs, s)
        assert torch.equal(torch.cat([x.to(on[0]) for x in cu], -1), u)
        gd = d["g"].to(torch.bfloat16) if bf16 else d["g"]
        want = fused_tp._tp_cell_bwd_cuda(gd, u, *args[1:], num_devices=P,
                                          **kw)
        got = fused_tp._tp_cell_bwd_cards(gd, cu, *args[1:], cards=on, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(GRADS, got, want):
        assert (x is None) == (y is None), name
        assert x is None or torch.equal(x, y), name


@pytest.mark.parametrize("P", [2, 4])
def test_entry_points_across_cards_equal_one_card(P):
    on = cards(P)
    B, T, H = 8, 16, 512
    d = cell_inputs(B, T, H, seed=5, dev=on[0])
    names = ("Wx", "alpha", "beta", "a", "b", "V", "u0", "w0", "s0")

    def run(mesh):
        t = {k: d[k].clone().requires_grad_() for k in names}
        out = fused_tp.radlif_tp(t["Wx"], t["alpha"], t["beta"], t["a"],
                                 t["b"], t["V"], THR, t["u0"], t["w0"],
                                 t["s0"], mesh=mesh)
        lif = fused_tp.lif_tp(t["Wx"], t["alpha"], THR, t["u0"], t["s0"],
                              mesh=mesh)
        ((out + 0.5 * lif) * d["g"]).sum().backward()
        return out.detach(), lif.detach(), {k: t[k].grad for k in names}

    one = run(make_mesh([on[0]] * P, model=P))
    fused_cells.reset_launch_counts()
    across = run(make_mesh(list(on), model=P))
    torch.cuda.synchronize()
    by_card = fused_cells.launch_counts_by_device()
    for i in range(P):
        assert by_card[i]["tp_cell_fwd"] == 1 and by_card[i]["tp_cell_bwd"] == 1
        assert any(n.startswith("fused_cell") for n in by_card[i])
    assert torch.equal(across[0], one[0]) and torch.equal(across[1], one[1])
    for k in names:
        assert torch.equal(across[2][k], one[2][k]), k


@pytest.mark.parametrize("P", [2, 4])
def test_entry_barrier_back_to_back(P):
    on = cards(P)
    d = cell_inputs(32, 10, 1024, seed=7, dev=on[0])
    args = args_of(d, True)
    x = torch.randn(64, P * 256, device=on[0])
    with torch.no_grad():
        outs = [fused_tp._tp_cell_cards(*args, cards=on, adaptive=True)
                for _ in range(100)]
        gathers = [fused_tp.tp_all_gather(x, num_devices=P, cards=on)
                   for _ in range(100)]
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = fused_tp.tp_all_gather_plain(x.cpu(), num_devices=P)
    for o in gathers:
        assert torch.equal(o.cpu(), want)
