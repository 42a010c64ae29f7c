"""The global-row map of the in-kernel dropout on the card, without JAX.

Under data parallelism each rank launches the fused kernels on its rows of
the global batch with ``drop_rows=(seg, stride, off)``, and the dropout
hash (``csrc/dropout_hash.cuh``) then keeps the global batch's rows. Two
half-batch launches with the map must equal one whole-batch launch bit for
bit: the spiking forward and backward (``fused_cell_fwd.cu`` in both
layouts, ``fused_cell_bwd.cu``; LIF, adLIF, RLIF, RadLIF) and the GRU's
(``fused_ann_fwd.cu``, ``fused_ann_bwd.cu``), in the float32 and the bf16
stream modes, and a bidirectional batch (the flipped sequence stacked on
the batch: rank r's rows are r's slice of each half). Compared are the
row-wise outputs: the spikes or outputs, the membrane or gate series, dWx
and the initial states' gradients; V is dyadic, so the forward's products
are exact in any order. The parameter gradients sum over the rows, and a
rank's half is the data-parallel step's business (``tests/
test_torch_multihost.py``).

    python -m pytest tests/test_torch_dp_kernels.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.ops import fused_ann, fused_cells

FORMS = {"lif": (False, False), "adlif": (False, True),
         "rlif": (True, False), "radlif": (True, True)}
DROP = 0.25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _halves(Bg, bidir):
    """Each of two ranks' row map and its rows of the whole (stacked)
    batch."""
    Bl = Bg // 2
    segs = 2 if bidir else 1
    return [((Bl, Bg, r * Bl),
             torch.cat([torch.arange(s * Bg + r * Bl, s * Bg + (r + 1) * Bl)
                        for s in range(segs)])) for r in (0, 1)]


def _inputs(n, T, H, dev, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return dict(
        Wx=t(rng.uniform(-2.0, 4.0, (n, T, H))),
        alpha=t(rng.uniform(0.75, 0.95, H)),
        beta=t(rng.uniform(0.95, 0.99, H)),
        a=t(rng.uniform(-1.0, 1.0, H)),
        b=t(rng.uniform(0.0, 2.0, H)),
        V=t(np.round(rng.normal(0, 0.3, (H, H)) * 256) / 256),
        u0=t(rng.uniform(0.0, 1.0, (n, H))),
        w0=t(rng.uniform(0.0, 1.0, (n, H))),
        s0=t(rng.uniform(size=(n, H)) > 0.7),
        g=t(rng.normal(0, 1, (n, T, H))),
    )


def _cell(d, recurrent, adaptive, mxu_bf16, drop_rows, rows=slice(None)):
    """The forward (training form) and backward kernels on ``rows``."""
    alpha, beta, a, b, V = fused_cells.clip_and_mask(
        d["alpha"], d["beta"] if adaptive else None,
        d["a"] if adaptive else None, d["b"] if adaptive else None,
        d["V"] if recurrent else None)
    seed = torch.tensor([1234, -99], dtype=torch.int32, device=d["Wx"].device)
    Wx = d["Wx"][rows]
    if mxu_bf16:
        Wx = Wx.to(torch.bfloat16)
    st = [d[k][rows].contiguous() for k in ("u0", "w0", "s0")]
    flags = dict(recurrent=recurrent, adaptive=adaptive, drop_rate=DROP,
                 seed=seed, mxu_bf16=mxu_bf16, drop_rows=drop_rows)
    out, u = fused_cells._fused_cell_cuda(
        Wx.contiguous(), None, None, alpha, beta, a, b, V, 1.0, *st,
        save_residuals=True, **flags)
    g = d["g"][rows].to(out.dtype).contiguous()
    back = fused_cells._fused_cell_bwd_cuda(
        g, None, u, None, alpha, beta, a, b, V, 1.0, *st, **flags)
    dwx, du0, dw0, ds0 = back[0], back[8], back[9], back[10]
    return [t for t in (out, u, dwx, du0, dw0, ds0) if t is not None]


CASES = [(name, bf16, bidir, H)
         for name in FORMS for bf16 in (False, True)
         for bidir, H in ((False, 256),)] + [("radlif", False, True, 96),
                                             ("radlif", True, True, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,bf16,bidir,H", CASES)
def test_spiking_halves_equal_the_whole_on_card(cuda, name, bf16, bidir, H):
    recurrent, adaptive = FORMS[name]
    Bg, T = 16, 30
    n = 2 * Bg if bidir else Bg
    d = _inputs(n, T, H, cuda)
    whole = _cell(d, recurrent, adaptive, bf16, None)
    torch.cuda.synchronize()
    assert 0.05 < float((whole[0] != 0).float().mean()) < 0.9
    for m, idx in _halves(Bg, bidir):
        half = _cell(d, recurrent, adaptive, bf16, m, idx.to(cuda))
        torch.cuda.synchronize()
        for i, (h, w) in enumerate(zip(half, whole)):
            assert torch.equal(h, w[idx.to(cuda)]), (m, i)
    # the identity map is the one-process launch
    again = _cell(d, recurrent, adaptive, bf16, (n, n, 0))
    for a, w in zip(again, whole):
        assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16,bidir", [(False, False), (True, False),
                                        (False, True)])
def test_gru_halves_equal_the_whole_on_card(cuda, bf16, bidir):
    Bg, T, H = 16, 20, 128
    n = 2 * Bg if bidir else Bg
    d = _inputs(n, T, H, cuda, seed=1)
    g = torch.Generator(device=cuda).manual_seed(0)
    wxs = [torch.randn(n, T, H, device=cuda, generator=g) for _ in range(3)]
    vs = [torch.randn(H, H, device=cuda, generator=g) * 0.1
          for _ in range(3)]
    y0 = torch.rand(n, H, device=cuda, generator=g)
    seed = torch.tensor([7, 8], dtype=torch.int32, device=cuda)

    def run(rows, drop_rows):
        ws = [w[rows].contiguous() for w in wxs]
        if bf16:
            ws = [w.to(torch.bfloat16) for w in ws]
        kw = dict(drop_rate=DROP, seed=seed, mxu_bf16=bf16,
                  drop_rows=drop_rows)
        out, y_raw, gates = fused_ann._ann_cell_cuda(
            "gru", ws, None, None, vs, y0[rows].contiguous(),
            save_residuals=True, **kw)
        gout = d["g"][rows].to(out.dtype).contiguous()
        dwxs, _, _, _, dy0 = fused_ann._ann_cell_bwd_cuda(
            "gru", gout, None, y_raw, gates, None, vs, y0[rows].contiguous(),
            **kw)
        return [out, y_raw, *gates, *dwxs, dy0]

    whole = run(slice(None), None)
    torch.cuda.synchronize()
    for m, idx in _halves(Bg, bidir):
        idx = idx.to(cuda)
        for i, (h, w) in enumerate(zip(run(idx, m), whole)):
            assert torch.equal(h, w[idx]), (m, i)
