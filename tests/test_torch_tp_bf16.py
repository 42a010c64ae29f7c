"""The bf16-stream form (``mxu_bf16=True``) of the port's tensor-parallel
cells (``ops.fused_tp``, ``ops.fused_tp_ann``) on the CPU, where they run
their plain versions in the one-card form.

Against the JAX package: its TP kernels in the same mode
(``pallas_tp.radlif_tp_pallas``, ``pallas_tp_ann.gru_tp_pallas`` with
``mxu_bf16=True``), run as tests/test_pallas_tp.py and
tests/test_pallas_tp_ann.py run them (jitted shard_map on the virtual CPU
mesh, TPU interpret mode). Those calls are dear, so there are two, at P = 2,
each one forward and one backward (``jax.vjp``), with T within one of the
JAX kernels' time chunks (at a chunk's first step the JAX ANN backward
reads its float32 boundary state where the port reads the bf16 y series).

- RadLIF: V on a 1/64 grid and s0 on sixteenths are bf16 values, so every
  product is exact in float32 in any order: the spikes bit for bit.
- GRU: the output, a bf16 stream, element for element within one bf16 ulp
  at the top of its range, 2^-7 relative to max(1, |v|) (the bound of the
  single-card bf16 kernels, tests/test_torch_kernels.py): the two
  frameworks sum a product's float32 terms in other orders, which may tip
  a rounding to bf16, and the tipped operand moves later steps by far less
  than that. At most 1 % of the elements may differ at all; the test
  prints how many do (61 of 24 576 here, none in the first five steps) and
  the largest distance in bf16 steps of the value itself (a value near
  1e-3, whose own step is small, may sit several steps off).
- gradients: within 2^-7 of each gradient's largest magnitude.

Against the port's own single-card bf16 path (``ops.fused_cells``,
``ops.fused_ann`` without affine and dropout), at P = 1, 2 and 4, cheap:
the TP plain versions round where the single-card ones round, and sum
each product over all of its rows at once, so outputs and gradients are
equal bit for bit, with one named exception: RadLIF's ds0 adds the
recurrent term before ``b * B`` (the TP kernel's order), the single-card
plain version after it, within 1e-6 of its largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sparch_tpu.ops import pallas_tp, pallas_tp_ann
from sparch_tpu_torch.ops import fused_ann, fused_cells, fused_tp, fused_tp_ann
from sparch_tpu_torch.parallel import make_mesh

from tests.test_torch_tp import _ARGS, THR, _inputs, _jax_mesh, _shmap
from tests.test_torch_tp_ann import _inputs as _ann_inputs

BF16 = torch.bfloat16
ULP = 2.0 ** -7  # one bf16 ulp of a value in [1, 2)
GRAD_REL = ULP  # of the gradient's largest magnitude
DS0_REL = 1e-6  # RadLIF's ds0, TP against single-card: one sum order


@pytest.fixture(autouse=True)
def _reset_interpret_state():
    """The interpret mode keeps its simulated devices in process-global
    state (tests/test_pallas_tp.py:21-31)."""
    from jax.experimental.pallas import tpu as pltpu

    pltpu.reset_tpu_interpret_mode_state()
    yield
    pltpu.reset_tpu_interpret_mode_state()


def _mesh(n):
    return make_mesh([torch.device("cpu")] * n, model=n)


def _bf16_exact(a):
    return torch.from_numpy(a).to(BF16).float().numpy()


def _assert_grads(got, want, names, what):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, dtype=np.float32)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(np.asarray(g, dtype=np.float32), w,
                                   rtol=0, atol=GRAD_REL * scale,
                                   err_msg=f"{what}: d{name}")


def _steps(a, b):
    """Distance in bf16 steps between two arrays of bf16 values: the bit
    patterns mapped onto one ordered integer line."""
    def line(x):
        bits = torch.tensor(x, dtype=torch.float32).to(BF16).view(
            torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (line(a) - line(b)).abs()


# ---------------------------------------------------------------------------
# Against the JAX kernels in interpret mode (P = 2)
# ---------------------------------------------------------------------------


def test_radlif_matches_pallas_bf16():
    nd, B, T, H = 2, 8, 14, 256
    kind = "radlif"
    d = _inputs(B, T, H, seed=7)
    d["R"] = _bf16_exact(d["R"])  # the cotangent both sides round to bf16
    specs = {"Wx": P(None, None, "model"), "V": P(None, "model"),
             "u0": P(None, "model"), "w0": P(None, "model"),
             "s0": P(None, "model")}

    def per_shard(*args):
        a = dict(zip(_ARGS[kind], args))
        return pallas_tp.radlif_tp_pallas(
            a["Wx"], a["alpha"], a["beta"], a["a"], a["b"], a["V"], THR,
            a["u0"], a["w0"], a["s0"], axis_name="model", num_devices=nd,
            mxu_bf16=True)

    fn = _shmap(per_shard, _jax_mesh(nd),
                tuple(specs.get(k, P("model")) for k in _ARGS[kind]),
                P(None, None, "model"))
    want, vjp = jax.vjp(fn, *[jnp.asarray(d[k]) for k in _ARGS[kind]])
    want_g = vjp(jnp.asarray(d["R"]))

    t = {k: torch.from_numpy(v).requires_grad_(k in _ARGS[kind])
         for k, v in d.items()}
    out = fused_tp.radlif_tp(t["Wx"], t["alpha"], t["beta"], t["a"],
                             t["b"], t["V"], THR, t["u0"], t["w0"], t["s0"],
                             mesh=_mesh(nd), mxu_bf16=True)
    (out.float() * t["R"]).sum().backward()
    assert out.dtype == BF16
    want = np.asarray(want)
    assert want.sum() > 0, "degenerate case: no spikes"
    np.testing.assert_array_equal(out.detach().float().numpy(), want)
    _assert_grads([t[k].grad.numpy() for k in _ARGS[kind]], want_g,
                  _ARGS[kind], "radlif bf16 vs pallas")


def test_gru_matches_pallas_bf16():
    mode, nd, B, T, H = "gru", 2, 8, 12, 256
    d = _ann_inputs(mode, B, T, H, seed=8)
    d["R"] = _bf16_exact(d["R"])
    args = [*d["wxs"], *d["vs"], d["y0"]]
    n = 3
    per_shard = functools.partial(pallas_tp_ann.gru_tp_pallas,
                                  axis_name="model", num_devices=nd,
                                  mxu_bf16=True)
    fn = _shmap(lambda *a: per_shard(*a), _jax_mesh(nd),
                (P(None, None, "model"),) * n + (P(None, "model"),) * n
                + (P(None, "model"),), P(None, None, "model"))
    want, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    want_g = vjp(jnp.asarray(d["R"]))

    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_tp_ann.gru_tp(*targs, mesh=_mesh(nd), mxu_bf16=True)
    (out.float() * torch.from_numpy(d["R"])).sum().backward()
    assert out.dtype == BF16
    got, want = out.detach().float().numpy(), np.asarray(want)
    np.testing.assert_array_less(np.abs(got - want),
                                 ULP * np.maximum(1.0, np.abs(want)) + 1e-12)
    steps = _steps(got, want)
    differ = int((steps > 0).sum())
    print(f"GRU bf16 output vs the JAX kernel: {differ} of {steps.numel()} "
          f"elements differ, by at most {float(np.abs(got - want).max())} "
          f"({int(steps.max())} bf16 steps of the value)")
    assert differ <= 0.01 * steps.numel()
    names = [f"wx{i}" for i in range(n)] + [f"v{i}" for i in range(n)] + [
        "y0"]
    _assert_grads([a.grad.numpy() for a in targs], want_g, names,
                  "gru bf16 vs pallas")


# ---------------------------------------------------------------------------
# Against the port's single-card bf16 plain versions (P = 1, 2, 4)
# ---------------------------------------------------------------------------

def _spiking(kind, t, P_):
    """The TP entry point over ``P_`` ranks or, with ``P_`` None, the
    single-card fused cell without affine and dropout, in the bf16 mode."""
    a = [t[k] for k in _ARGS[kind]]
    cut = -2 if kind in ("lif", "rlif") else -3  # the states
    if P_ is None:
        fn, kw = getattr(fused_cells, f"{kind}_fused"), {}
    else:
        fn, kw = getattr(fused_tp, f"{kind}_tp"), dict(mesh=_mesh(P_))
    return fn(*a[:cut], THR, *a[cut:], mxu_bf16=True, **kw)


def _spiking_run(kind, d, P_, wx_bf16):
    t = {k: torch.from_numpy(v).requires_grad_(k in _ARGS[kind])
         for k, v in d.items()}
    if wx_bf16:
        with torch.no_grad():
            t["Wx"] = t["Wx"].to(BF16).requires_grad_()
    out = _spiking(kind, t, P_)
    (out.float() * t["R"]).sum().backward()
    return out.detach(), {k: t[k].grad for k in _ARGS[kind]}


@pytest.mark.parametrize("wx_bf16", [False, True])
@pytest.mark.parametrize("kind", ["lif", "adlif", "rlif", "radlif"])
def test_spiking_tp_bf16_equals_single_card_bf16(kind, wx_bf16):
    d = _inputs(8, 11, 512, seed=9)
    d["s0"] = np.random.default_rng(10).uniform(
        0, 1, d["s0"].shape).astype(np.float32)  # a uniform state init
    want, want_g = _spiking_run(kind, d, None, wx_bf16)
    assert want.dtype == BF16 and 0 < float(want.float().mean()) < 0.5
    for P_ in (1, 2, 4):
        got, got_g = _spiking_run(kind, d, P_, wx_bf16)
        assert torch.equal(got, want), P_
        for k, g in got_g.items():
            w = want_g[k]
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            if kind == "radlif" and k == "s0":
                err = float((g - w).abs().max() / w.abs().max())
                assert err <= DS0_REL, (P_, err)
            else:
                assert torch.equal(g, w), (kind, P_, k)


@pytest.mark.parametrize("wx_bf16", [False, True])
@pytest.mark.parametrize("mode", ["rnn", "ligru", "gru"])
def test_ann_tp_bf16_equals_single_card_bf16(mode, wx_bf16):
    d = _ann_inputs(mode, 8, 11, 512, seed=11)
    n = fused_ann.MODES[mode]
    single = {"rnn": fused_ann.rnn_fused, "ligru": fused_ann.ligru_fused,
              "gru": fused_ann.gru_fused}[mode]
    tp = {"rnn": fused_tp_ann.rnn_tp, "ligru": fused_tp_ann.ligru_tp,
          "gru": fused_tp_ann.gru_tp}[mode]

    def run(P_):
        args = [torch.from_numpy(a) for a in (*d["wxs"], *d["vs"], d["y0"])]
        if wx_bf16:
            args[:n] = [w.to(BF16) for w in args[:n]]
        for a in args:
            a.requires_grad_()
        out = (single(*args, mxu_bf16=True) if P_ is None else
               tp(*args, mesh=_mesh(P_), mxu_bf16=True))
        (out.float() * torch.from_numpy(d["R"])).sum().backward()
        return out.detach(), [a.grad for a in args]

    want, want_g = run(None)
    assert want.dtype == BF16
    for P_ in (1, 2, 4):
        got, got_g = run(P_)
        assert torch.equal(got, want), P_
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            assert g.dtype == w.dtype and torch.equal(g, w), (mode, P_, i)
