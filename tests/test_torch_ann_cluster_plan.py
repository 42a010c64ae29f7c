"""The launch plan and the matrix layout of the single-card non-spiking cell
kernels (``ops.fused_ann``: ``_fwd_plan``, ``_bwd_plan``, ``_pack_slices``),
which split each recurrent matrix by columns over the blocks of a
thread-block cluster (``csrc/cluster_slice.cuh``).

On the CPU: every batch row and every neuron is owned by exactly one thread
of the plan, the slice is resident exactly where its bytes fit, the packing
unpacks to the matrices, the dscale/dshift partials group the rows as the
kernel before the cluster split did, and the plain backward's dscale and
dshift match ``jax.grad`` of the JAX package's Pallas op in interpret mode
at a batch that is no multiple of the groups, within the tolerance of
tests/test_torch_ann_grads.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparch_tpu.ops import pallas_ann
from sparch_tpu_torch.ops import fused_ann

from tests.test_torch_ann_cells import dropout_kw, jax_seed, torch_seed
from tests.test_torch_kernels import ANN_MODES, ann_call, make_ann_inputs

BS = (1, 5, 128, 130)
HS = (8, 512, 1001, 1024, 2048)
RT = fused_ann._ROWS_PER_THREAD
SMEM_BLOCK = 232448  # shared memory of an H100 block (dynamic and static)


def plans(B, H, n, bf16):
    """The forward's and the backward's plans, with the operand planes each
    exchanges per parity."""
    return (("fwd", fused_ann._fwd_plan(B, H, n, bf16), 1),
            ("bwd", fused_ann._bwd_plan(B, 20, H, n, bf16)[0],
             1 if n == 1 else 2))


@pytest.mark.parametrize("H", HS)
@pytest.mark.parametrize("B", BS)
def test_plan_owns_every_row_and_neuron_once(B, H):
    """Cluster c, block k, thread (tx, ty) owns neuron k*cols + tx of rows
    c*rows + ty*4 .. +3 (``fused_ann_fwd.cu``); over all of them every (row,
    neuron) of the layer is owned once, and the block fits its threads."""
    for n in fused_ann.MODES.values():
        for bf16 in (False, True):
            for what, p, _ in plans(B, H, n, bf16):
                owned = np.zeros((p.clusters * p.rows, p.cluster * p.cols),
                                 np.int32)
                assert p.threads % 32 == 0
                assert p.threads <= fused_ann._MAX_THREADS
                live = p.cols * (p.rows // RT)
                assert live <= p.threads < live + 32
                tid = np.arange(live)
                tx, ty = tid % p.cols, tid // p.cols
                rows = (np.arange(p.clusters)[:, None, None] * p.rows
                        + ty[None, :, None] * RT + np.arange(RT))
                for k in range(p.cluster):
                    cols = np.broadcast_to((k * p.cols + tx)[None, :, None],
                                           rows.shape)
                    np.add.at(owned, (rows.ravel(), cols.ravel()), 1)
                assert (owned[:B, :H] == 1).all(), (what, n, bf16, p)
                # no cluster without a row of its own; no slice narrower
                # than 32 columns where H has them
                assert (p.clusters - 1) * p.rows < B
                assert p.cols >= min(H, fused_ann._MIN_COLS)
                assert p.cols % 8 == 0 and p.rows % RT == 0


@pytest.mark.parametrize("H", HS)
def test_plan_keeps_the_slice_resident_where_its_bytes_fit(H):
    """Resident exactly where the block's slice and its operands' two
    parities fit in shared memory; else three stages of at most 64 KB
    beside the operands, each holding a row of every pass."""
    for n in fused_ann.MODES.values():
        for bf16 in (False, True):
            for what, p, planes in plans(128, H, n, bf16):
                operands = 2 * planes * p.rows * H * 4
                slice_bytes = n * H * p.cols * (2 if bf16 else 4)
                budget = SMEM_BLOCK - 1024
                assert operands <= 128 * 1024
                assert p.resident == (operands + slice_bytes <= budget)
                if p.resident:
                    assert p.stage_bytes == 0
                else:
                    assert 0 < p.stage_bytes <= 65536
                    assert p.stage_bytes % 16 == 0
                    assert operands + 3 * p.stage_bytes <= budget
                    assert p.stage_bytes >= 2 * p.cols * (2 if bf16 else 4)


def test_plan_of_the_main_shapes():
    """At B = 128: 16 clusters of 6 blocks (96 SMs; an H100 holds 17 such
    clusters at once, and only 15 of 8 blocks), 8 rows a cluster; at H = 512
    the slice is resident for the RNN in both modes and the bf16 LiGRU's
    forward, and streamed at H = 1024."""
    for n, bf16, fwd, bwd in ((1, False, True, True), (2, False, False, False),
                              (3, False, False, False), (1, True, True, True),
                              (2, True, True, False), (3, True, False, False)):
        p = fused_ann._fwd_plan(128, 512, n, bf16)
        q = fused_ann._bwd_plan(128, 100, 512, n, bf16)[0]
        assert (p.cluster, p.rows, p.cols, p.clusters) == (6, 8, 88, 16)
        assert (q.cluster, q.rows, q.cols, q.clusters) == (6, 8, 88, 16)
        assert (p.resident, q.resident) == (fwd, bwd), (n, bf16)
        for bf in (False, True):
            p = fused_ann._fwd_plan(128, 1024, n, bf)
            assert not p.resident and (p.cluster, p.clusters) == (6, 16)


def test_plan_raises_past_the_widest_layer():
    H = fused_ann._MAX_H
    fused_ann._fwd_plan(4, H, 3)
    fused_ann._bwd_plan(4, 2, H, 3, True)
    for fn in (lambda: fused_ann._fwd_plan(4, H + 1, 1),
               lambda: fused_ann._bwd_plan(4, 2, H + 1, 2)):
        with pytest.raises(ValueError, match=f"H <= {H}"):
            fn()


def unpack(packed, passes, plan, H):
    """The matrices back from ``_pack_slices``: a list by gate."""
    C, w = plan.cluster, plan.cols
    mats = {}
    flat = packed.reshape(C, -1)
    off = 0
    for gates in passes:
        size = H * len(gates) * w
        block = flat[:, off:off + size].reshape(C, H, len(gates), w)
        off += size
        for i, g in enumerate(gates):
            mats[g] = block[:, :, i].permute(1, 0, 2).reshape(H, C * w)
    assert off == flat.shape[1]
    return [mats[g] for g in sorted(mats)], flat


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H", [8, 40, 130, 1001])
@pytest.mark.parametrize("mode", ANN_MODES)
def test_packing_unpacks_to_the_matrices(mode, H, bf16):
    """Block k's row of the packing holds columns k*cols .. of V, Vz, Vr
    (the backward's: of V^T, Vz^T, Vr^T), each pass's gates side by side,
    zero past H; in the bf16 mode rounded to bf16."""
    n = fused_ann.MODES[mode]
    rng = np.random.default_rng(H)
    vs = [torch.from_numpy(rng.normal(0, 1, (H, H)).astype(np.float32))
          for _ in range(n)]
    for passes, mats, p in (
            (fused_ann._FWD_PASSES[mode], vs,
             fused_ann._fwd_plan(3, H, n, bf16)),
            (fused_ann._BWD_PASSES[mode], [v.t() for v in vs],
             fused_ann._bwd_plan(3, 2, H, n, bf16)[0])):
        packed = fused_ann._pack_slices(mats, passes, p, bf16)
        assert packed.shape == (p.cluster, n * H * p.cols)
        assert packed.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert packed.is_contiguous()
        assert sorted(g for gates in passes for g in gates) == list(range(n))
        got, _ = unpack(packed, passes, p, H)
        for m, x in zip(mats, got):
            want = m.to(torch.bfloat16) if bf16 else m
            assert torch.equal(x[:, :H], want)
            assert not x[:, H:].float().any()


def test_gru_pass_order_is_the_step_order():
    """The GRU's forward reads [Vz | Vr] (against y), then V (against
    r*y); its backward [V^T | Vz^T] (against dcpre, dzpre), then Vr^T
    (against drpre)."""
    assert fused_ann._FWD_PASSES["gru"] == ((1, 2), (0,))
    assert fused_ann._BWD_PASSES["gru"] == ((0, 1), (2,))
    assert fused_ann._FWD_PASSES["ligru"] == fused_ann._BWD_PASSES["ligru"] \
        == ((0, 1),)


@pytest.mark.parametrize("H", [8, 512, 513, 1024, 2048])
@pytest.mark.parametrize("B", BS)
def test_dscale_partials_group_rows_as_before_the_split(B, H):
    """One dscale/dshift partial per two rows up to H = 512, else per row:
    the rows of a block of the kernel before the cluster split (one block
    for two rows, or one, as its 512 threads allowed), whose sums, and so
    whose bits, the kernel keeps. Each partial's rows lie in one thread's
    four rows."""
    for n in fused_ann.MODES.values():
        plan, n_parts, _ = fused_ann._bwd_plan(B, 20, H, n)
        per = 2 if H <= 512 else 1
        assert fused_ann._part_rows(H) == per
        assert n_parts == -(-B // per)
        assert RT % per == 0 and plan.rows % RT == 0


@pytest.mark.parametrize("mode", ANN_MODES)
def test_plain_dscale_matches_jax_grad(mode):
    """The plain backward's dscale and dshift at B = 7 (a cluster's rows in
    part, an odd last pair), under dropout, against ``jax.grad`` of
    ``pallas_ann.<mode>_pallas`` in interpret mode: atol 3e-5 / rtol 1e-4,
    tests/test_torch_ann_grads.py's bound."""
    B, T, H = 7, 9, 16
    d = make_ann_inputs(mode, B, T, H, seed=13)
    w = np.random.default_rng(5).uniform(-1, 1, (B, T, H)).astype(np.float32)
    kw = dict(drop_rate=0.25)
    leaves = {}

    def leaf(a):
        leaves[id(a)] = torch.from_numpy(a).clone().requires_grad_(True)
        return leaves[id(a)]

    out = ann_call(fused_ann, "fused", mode, d, leaf, True,
                   **dropout_kw(kw["drop_rate"], torch_seed))
    (out * torch.from_numpy(w)).sum().backward()

    def loss(d):
        y = ann_call(pallas_ann, "pallas", mode, d, jnp.asarray, True,
                     **dropout_kw(kw["drop_rate"], jax_seed))
        return (y * w).sum()

    want = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(d))
    for key in ("scales", "shifts"):
        for i, a in enumerate(d[key]):
            got = leaves[id(a)].grad.numpy()
            np.testing.assert_allclose(got, want[key][i], atol=3e-5,
                                       rtol=1e-4, err_msg=f"d{key}[{i}]")
            assert np.abs(want[key][i]).max() > 1e-3
