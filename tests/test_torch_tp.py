"""The port's tensor-parallel cells (sparch_tpu_torch.ops.fused_tp) against
the JAX package's (sparch_tpu.ops.pallas_tp) on the CPU.

The JAX kernels run as tests/test_pallas_tp.py runs them: jitted shard_map
on the virtual 8-device CPU mesh, TPU interpret mode. Those calls are dear
(seconds each), so they are few and at P = 2: both exchange harnesses, one
RLIF and one RadLIF forward, one RadLIF gradient. Everything else (P = 4,
LIF/adLIF, the gradients of RLIF) is held against the JAX scan cells and
``jax.grad`` of them, which the JAX package pins its own kernels to. The
port runs its plain versions (CPU tensors) in the one-card form.

Inputs: V on a 1/64 grid and s0 on sixteenths, so every product is exact
in any order and the spike trains must be equal bit for bit; gradients
within 5e-5 of their largest magnitude, the bound tests/test_pallas_tp.py
holds the JAX TP model to.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from sparch_tpu.models import build_model as jax_build_model
from sparch_tpu.ops import cells as jcells
from sparch_tpu.ops import pallas_tp
from sparch_tpu.parallel import mesh as jmesh
from sparch_tpu_torch.convert import _target, variables_from_flax
from sparch_tpu_torch.ops import fused_tp
from sparch_tpu_torch.parallel import make_mesh, model_param_shard_dims

GRAD_ATOL = 5e-5  # of the gradient's largest magnitude
THR = 1.0


@pytest.fixture(autouse=True)
def _reset_interpret_state():
    """The interpret mode keeps its simulated devices in process-global
    state (tests/test_pallas_tp.py:21-31)."""
    from jax.experimental.pallas import tpu as pltpu

    pltpu.reset_tpu_interpret_mode_state()
    yield
    pltpu.reset_tpu_interpret_mode_state()


def _jax_mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return JaxMesh(np.array(devs[:n]), ("model",))


def _shmap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _mesh(n):
    return make_mesh([torch.device("cpu")] * n, model=n)


def _inputs(B, T, H, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    V = np.clip(np.round(rng.normal(0, 0.3, (H, H)) * 64) / 64, -1, 1)
    return dict(
        Wx=(rng.normal(0, 1, (B, T, H)) * 1.5).astype(f32),
        alpha=rng.uniform(*jcells.ALPHA_LIM, H).astype(f32),
        beta=rng.uniform(*jcells.BETA_LIM, H).astype(f32),
        a=rng.uniform(-1.0, 1.0, H).astype(f32),
        b=rng.uniform(0.0, 2.0, H).astype(f32),
        V=V.astype(f32),
        u0=rng.uniform(0, 1, (B, H)).astype(f32),
        w0=rng.uniform(0, 1, (B, H)).astype(f32),
        s0=(np.round(rng.uniform(0, 1, (B, H)) * 16) / 16).astype(f32),
        R=rng.normal(0, 1, (B, T, H)).astype(f32),
    )


_ARGS = {"rlif": ("Wx", "alpha", "V", "u0", "s0"),
         "radlif": ("Wx", "alpha", "beta", "a", "b", "V", "u0", "w0", "s0"),
         "lif": ("Wx", "alpha", "u0", "s0"),
         "adlif": ("Wx", "alpha", "beta", "a", "b", "u0", "w0", "s0")}


def _port(kind, t, nd):
    """The port's TP entry point on torch tensors ``t``."""
    mesh = _mesh(nd)
    if kind == "rlif":
        return fused_tp.rlif_tp(t["Wx"], t["alpha"], t["V"], THR, t["u0"],
                                t["s0"], mesh=mesh)
    if kind == "radlif":
        return fused_tp.radlif_tp(t["Wx"], t["alpha"], t["beta"], t["a"],
                                  t["b"], t["V"], THR, t["u0"], t["w0"],
                                  t["s0"], mesh=mesh)
    if kind == "lif":
        return fused_tp.lif_tp(t["Wx"], t["alpha"], THR, t["u0"], t["s0"],
                               mesh=mesh)
    return fused_tp.adlif_tp(t["Wx"], t["alpha"], t["beta"], t["a"], t["b"],
                             THR, t["u0"], t["w0"], t["s0"], mesh=mesh)


def _scan(kind, j):
    """The JAX scan cell on jax arrays ``j``."""
    if kind == "rlif":
        return jcells.rlif_scan(j["Wx"], j["alpha"], j["V"], THR, j["u0"],
                                j["s0"])
    if kind == "radlif":
        return jcells.radlif_scan(j["Wx"], j["alpha"], j["beta"], j["a"],
                                  j["b"], j["V"], THR, j["u0"], j["w0"],
                                  j["s0"])
    if kind == "lif":
        return jcells.lif_scan(j["Wx"], j["alpha"], THR, j["u0"], j["s0"])
    return jcells.adlif_scan(j["Wx"], j["alpha"], j["beta"], j["a"], j["b"],
                             THR, j["u0"], j["w0"], j["s0"])


def _pallas_fn(kind, nd):
    """The JAX TP kernel, sharded over a ``nd``-device 'model' mesh,
    as a full-array function of the arguments of ``_ARGS[kind]``."""
    mesh = _jax_mesh(nd)
    specs = {"Wx": P(None, None, "model"), "V": P(None, "model"),
             "u0": P(None, "model"), "w0": P(None, "model"),
             "s0": P(None, "model")}

    def per_shard(*args):
        d = dict(zip(_ARGS[kind], args))
        if kind == "rlif":
            return pallas_tp.rlif_tp_pallas(
                d["Wx"], d["alpha"], d["V"], THR, d["u0"], d["s0"],
                axis_name="model", num_devices=nd)
        return pallas_tp.radlif_tp_pallas(
            d["Wx"], d["alpha"], d["beta"], d["a"], d["b"], d["V"], THR,
            d["u0"], d["w0"], d["s0"], axis_name="model", num_devices=nd)

    return _shmap(per_shard, mesh,
                  tuple(specs.get(k, P("model")) for k in _ARGS[kind]),
                  P(None, None, "model"))


def _port_grads(kind, d, nd):
    t = {k: torch.from_numpy(v).requires_grad_(k in _ARGS[kind])
         for k, v in d.items()}
    out = _port(kind, t, nd)
    (out * t["R"]).sum().backward()
    return out.detach().numpy(), {k: t[k].grad.numpy() for k in _ARGS[kind]}


def _assert_grads(got, want, what):
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_ATOL * scale,
                                   err_msg=f"{what}: d{k}")


# ---------------------------------------------------------------------------
# Against the JAX kernels (interpret mode, P = 2)
# ---------------------------------------------------------------------------


def test_all_gather_matches_pallas():
    nd, B, hloc = 2, 8, 128
    x = np.random.default_rng(0).normal(0, 1, (B, nd * hloc)).astype(
        np.float32)
    fn = _shmap(functools.partial(pallas_tp.tp_all_gather, axis_name="model",
                                  num_devices=nd, rounds=3),
                _jax_mesh(nd), P(None, "model"), P(None, None, None))
    want = np.asarray(fn(jnp.asarray(x)))
    got = fused_tp.tp_all_gather(torch.from_numpy(x), num_devices=nd)
    for q in range(nd):  # every rank gathered the same planes
        np.testing.assert_array_equal(got[q].numpy(), want)


def test_reduce_scatter_matches_pallas():
    nd, B, hloc = 2, 8, 128
    parts = np.random.default_rng(1).normal(
        0, 1, (nd, B, nd * hloc)).astype(np.float32)
    fn = _shmap(lambda p: pallas_tp.tp_reduce_scatter(
        p[0], axis_name="model", num_devices=nd, rounds=3),
        _jax_mesh(nd), P("model", None, None), P(None, None, "model"))
    want = np.asarray(fn(jnp.asarray(parts)))
    got = fused_tp.tp_reduce_scatter(torch.from_numpy(parts), num_devices=nd)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["rlif", "radlif"])
def test_forward_matches_pallas(kind):
    nd, B, T, H = 2, 8, 20, 256
    d = _inputs(B, T, H, seed=2)
    want = np.asarray(_pallas_fn(kind, nd)(
        *[jnp.asarray(d[k]) for k in _ARGS[kind]]))
    with torch.no_grad():
        got = _port(kind, {k: torch.from_numpy(v) for k, v in d.items()},
                    nd).numpy()
    assert want.sum() > 0, "degenerate case: no spikes"
    np.testing.assert_array_equal(got, want)


def test_radlif_gradients_match_pallas():
    kind, nd, B, T, H = "radlif", 2, 8, 20, 256
    d = _inputs(B, T, H, seed=3)
    fn = _pallas_fn(kind, nd)
    R = jnp.asarray(d["R"])
    argnums = tuple(range(len(_ARGS[kind])))
    want = jax.grad(lambda *a: jnp.sum(fn(*a) * R), argnums)(
        *[jnp.asarray(d[k]) for k in _ARGS[kind]])
    _, got = _port_grads(kind, d, nd)
    _assert_grads(got, dict(zip(_ARGS[kind], want)), "radlif vs pallas")


# ---------------------------------------------------------------------------
# Against the JAX scan cells (cheap: P = 4, every form)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nd,T", [(4, 23), (2, 17)])
@pytest.mark.parametrize("kind", ["rlif", "radlif", "lif", "adlif"])
def test_cells_match_scan(kind, nd, T):
    B, H = 8, 128 * nd
    d = _inputs(B, T, H, seed=4)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = np.asarray(_scan(kind, j))
    R = j["R"]
    want_g = jax.grad(
        lambda vals: jnp.sum(_scan(kind, {**j, **vals}) * R))(
            {k: j[k] for k in _ARGS[kind]})
    got, got_g = _port_grads(kind, d, nd)
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)
    _assert_grads(got_g, want_g, f"{kind} P={nd} vs scan")


def test_plain_versions_agree_across_p():
    """The split changes no bit of the forward, and of the backward only
    the sums over rows (dalpha, dbeta, da, db: a block's own order)."""
    d = _inputs(8, 11, 512, seed=5)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    alpha, beta, a, b = (t[k] for k in ("alpha", "beta", "a", "b"))
    V = t["V"] * (1 - torch.eye(512))
    args = (t["Wx"], alpha, beta, a, b, V, THR, t["u0"], t["w0"], t["s0"])
    ref, ref_u = fused_tp.tp_cell_plain(*args, num_devices=1, adaptive=True,
                                        save_residuals=True)
    bargs = (t["R"], ref_u, alpha, beta, a, b, V, THR, t["u0"], t["w0"],
             t["s0"])
    ref_g = fused_tp.tp_cell_bwd_plain(*bargs, num_devices=1, adaptive=True)
    for nd in (2, 4):
        s, u = fused_tp.tp_cell_plain(*args, num_devices=nd, adaptive=True,
                                      save_residuals=True)
        assert torch.equal(s, ref) and torch.equal(u, ref_u)
        g = fused_tp.tp_cell_bwd_plain(*bargs, num_devices=nd, adaptive=True)
        for x, y in zip(g, ref_g):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_zero_diag_shard_matches_pallas():
    nd, H = 4, 512
    V = np.random.default_rng(6).normal(0, 1, (H, H)).astype(np.float32)
    fn = _shmap(lambda v: pallas_tp.zero_diag_shard(v, "model"),
                _jax_mesh(nd), P(None, "model"), P(None, "model"))
    want = np.asarray(fn(jnp.asarray(V)))
    hl = H // nd
    got = torch.cat([fused_tp.zero_diag_shard(
        torch.from_numpy(V[:, r * hl:(r + 1) * hl]), r) for r in range(nd)],
        dim=1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want.diagonal().any()


# ---------------------------------------------------------------------------
# The mesh and the sharding rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v_cols", [False, True])
@pytest.mark.parametrize("model_type", ["RadLIF", "GRU"])
def test_shard_dims_follow_the_jax_rules(model_type, v_cols):
    """``model_param_shard_dims`` gives, name for name, the dimension that
    ``_pspec_for_param`` puts on 'model' (a flax kernel is the transpose of
    the port's weight)."""
    shape = (8, 5, 6)
    jmodel = jax_build_model(model_type, shape, [8, 8, 3],
                             normalization="batchnorm", use_bias=True,
                             cell_impl="scan")
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "state": jax.random.PRNGKey(1)},
                            jnp.zeros(shape), train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    dims = model_param_shard_dims(variables_from_flax(variables),
                                  v_cols=v_cols)
    seen = set()
    for coll in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(
            jmesh.model_param_pspecs(variables[coll], v_cols=v_cols),
            is_leaf=lambda x: isinstance(x, P))[0]
        for kp, spec in flat:
            path = (coll,) + tuple(str(k.key) for k in kp)
            key, transpose = _target(path)
            want = spec.index("model") if "model" in spec else None
            if want is not None and transpose:
                want = 1 - want
            assert dims[key] == want, (key, spec)
            seen.add(key)
    assert seen == set(dims)


def test_mesh_forms():
    mesh = make_mesh([torch.device("cpu")] * 4, model=4)
    assert mesh.shape == {"data": 1, "model": 4} and mesh.one_card
    assert mesh.device == torch.device("cpu")
    # the data axis is the processes: without a process group it is 1
    with pytest.raises(NotImplementedError, match="torch.distributed.run"):
        make_mesh([torch.device("cpu")] * 4, data=2, model=2)
    with pytest.raises(NotImplementedError, match="queue 1 item 7b"):
        make_mesh([torch.device("cpu"), torch.device("meta")], model=2)
    with pytest.raises(ValueError, match="2x2 != 3"):
        make_mesh([torch.device("cpu")] * 3, data=2, model=2)
