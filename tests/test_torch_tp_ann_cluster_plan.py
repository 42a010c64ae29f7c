"""The launch plan and the matrix layout of the tensor-parallel non-spiking
cell kernels (``ops.fused_tp_ann``: ``_tp_plan``, ``_pack_slices``), which
run thread-block clusters per rank (``csrc/tp_ann.cuh``).

On the CPU, at P = 1, 2, 4, 8, for the RNN, the LiGRU and the GRU in both
stream modes: every (rank, batch row, neuron) is owned by exactly one
thread of the plan; the clusters of all ranks fit in what the card holds,
and the plan raises where they cannot; every rank walks the row groups in
one order; the slice is resident exactly where its bytes fit; each rank's
packing unpacks to its column blocks of V, Vz, Vr (the backward's: of their
transposes); at P = 1 the plan is the single-card kernels'. The card is
modelled by what an NVIDIA H100 80GB HBM3 reported for clusters of one-SM
blocks (``cudaOccupancyMaxActiveClusters``)."""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.ops import fused_ann, fused_tp_ann

PS = (1, 2, 4, 8)
MODES = ("rnn", "ligru", "gru")
RT = fused_ann._ROWS_PER_THREAD
SMEM_BUDGET = 232448 - 1024  # an H100 block's shared memory less the static
# clusters of 1..6 one-SM blocks an H100 80GB HBM3 holds at once
H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17}


def planes_of(mode, backward):
    return fused_tp_ann._MODES[mode]["bwd_stack"] if backward else 1


def operands_of(mode, backward):
    """The operand planes a block holds: two parities of ``planes_of``,
    but the GRU backward's second exchange (drpre) has one plane."""
    ops = fused_tp_ann._MODES[mode]["bwd_operands"] if backward else None
    return ops or 2 * planes_of(mode, backward)


def plan_of(mode, B, H, P, bf16, backward, held=H100.get):
    n = fused_tp_ann._MODES[mode]["n_wx"]
    return fused_tp_ann._tp_plan(B, H, P, n, bf16, planes_of(mode, backward),
                                 held, operands_of(mode, backward))


def cases():
    """(B, H/P): a rank of 8 neurons (one cluster of one slice), 136 (a
    ragged last slice), 256 (main path at P = 4); B = 12 leaves a partial
    row group, 1024 walks."""
    for hl in (8, 136, 256):
        for B in (1, 12, 128, 1024):
            yield B, hl


def groups_walked(plan, P):
    """The row groups each cluster walks, by rank and cluster of the rank
    (tp_ann_fwd.cu: cluster i of rank r walks i, i + per_rank, ...)."""
    groups = plan.rank.clusters
    return [[list(range(i, groups, plan.per_rank))
             for i in range(plan.per_rank)] for _ in range(P)]


@pytest.mark.parametrize("P", PS)
def test_plan_owns_every_rank_row_and_neuron_once(P):
    """Cluster i of rank r, block k, thread (tx, ty) owns neuron k*cols + tx
    of rank r for rows g*rows + ty*4 .. +3 of each group g it walks: over
    all of them every (rank, row, neuron) is owned once, in every mode."""
    for B, hl in cases():
        H = P * hl
        for mode in MODES:
            for bf16 in (False, True):
                for backward in (False, True):
                    p = plan_of(mode, B, H, P, bf16, backward)
                    q = p.rank
                    owned = np.zeros((P, q.clusters * q.rows,
                                      q.cluster * q.cols), np.int32)
                    live = q.cols * (q.rows // RT)
                    assert q.threads % 32 == 0
                    assert live <= q.threads < live + 32
                    assert q.threads <= fused_ann._MAX_THREADS
                    tid = np.arange(live)
                    tx, ty = tid % q.cols, tid // q.cols
                    for r, walks in enumerate(groups_walked(p, P)):
                        for walk in walks:
                            g = np.array(walk)
                            rows = (g[:, None, None] * q.rows
                                    + ty[None, :, None] * RT + np.arange(RT))
                            for k in range(q.cluster):
                                cols = np.broadcast_to(
                                    (k * q.cols + tx)[None, :, None],
                                    rows.shape)
                                np.add.at(owned[r], (rows.ravel(),
                                                     cols.ravel()), 1)
                    what = (B, H, mode, bf16, backward, p)
                    assert (owned[:, :B, :hl] == 1).all(), what
                    assert (q.clusters - 1) * q.rows < B
                    assert q.cols % 8 == 0 and q.rows % RT == 0


@pytest.mark.parametrize("P", PS)
def test_plan_fits_what_the_card_holds(P):
    """P ranks times the clusters a rank runs fit in what the card holds of
    clusters of that size; every group is at work at once where some size
    lets it, else the clusters walk; of the sizes that run, the plan has
    the fewest warps a block times walks; and the plan raises where the
    card holds fewer clusters of every size than ranks."""
    for B, hl in cases():
        H = P * hl
        for mode in MODES:
            n = fused_tp_ann._MODES[mode]["n_wx"]
            for backward in (False, True):
                p = plan_of(mode, B, H, P, False, backward)
                assert P * p.per_rank <= H100[p.rank.cluster] == p.max_active
                assert 1 <= p.per_rank <= p.rank.clusters
                assert p.walks == -(-p.rank.clusters // p.per_rank)
                others = []
                for c in range(1, 7):
                    q = fused_tp_ann._rank_plan(B, H, P, n, False,
                                                planes_of(mode, backward), c)
                    per = min(q.clusters, H100[c] // P)
                    if fused_tp_ann._runs(q, n, False) and per >= 1 and \
                            c <= max(1, min(6, hl // 32)):
                        others.append(fused_tp_ann.TPPlan(
                            q, per, -(-q.clusters // per), H100[c]))
                assert fused_tp_ann._cost(p) == min(map(fused_tp_ann._cost,
                                                        others))
                if any(o.walks == 1 and o.rank.threads <= p.rank.threads
                       for o in others):
                    assert p.walks == 1, (B, H, mode, p)
    with pytest.raises(ValueError, match="fewer than"):
        plan_of("gru", 128, P * 256, P, False, False, lambda c: P - 1)


@pytest.mark.parametrize("P", PS)
def test_every_rank_walks_the_row_groups_in_one_order(P):
    """Cluster i walks the same groups on every rank, in the same order,
    and the clusters of a rank cover each group once: peers that wait on
    each other work on one group at a time."""
    for B, hl in cases():
        for mode in MODES:
            p = plan_of(mode, B, P * hl, P, True, True)
            walked = groups_walked(p, P)
            assert all(w == walked[0] for w in walked)
            flat = sorted(g for w in walked[0] for g in w)
            assert flat == list(range(p.rank.clusters))
            assert max(map(len, walked[0])) == p.walks


@pytest.mark.parametrize("P", PS)
def test_resident_follows_from_the_bytes(P):
    """Resident exactly where the block's slice and its operands (two
    parities; the GRU backward's three planes) fit in shared memory; else
    three stages of at most 64 KB beside the operands, each holding a row
    of the widest pass."""
    for hl in (8, 64, 136, 256, 512):
        H = P * hl
        for mode in MODES:
            n = fused_tp_ann._MODES[mode]["n_wx"]
            for bf16 in (False, True):
                for backward in (False, True):
                    try:
                        p = plan_of(mode, 128, H, P, bf16, backward).rank
                    except ValueError:
                        continue
                    elem = 2 if bf16 else 4
                    operands = (operands_of(mode, backward) * p.rows * H
                                * 4)
                    slice_bytes = n * H * p.cols * elem
                    assert p.resident == (operands + slice_bytes
                                          <= SMEM_BUDGET)
                    if not p.resident:
                        assert 0 < p.stage_bytes <= 65536
                        assert operands + 3 * p.stage_bytes <= SMEM_BUDGET
                        assert p.stage_bytes >= min(n, 2) * p.cols * elem


def unpack_rank(packed, passes, plan, H):
    """One rank's (H, Hl) blocks back from its row of ``_pack_slices``, a
    list by gate, each (H, cluster*cols) with the padding."""
    C, w = plan.cluster, plan.cols
    mats, off = {}, 0
    for gates in passes:
        size = H * len(gates) * w
        block = packed[:, off:off + size].reshape(C, H, len(gates), w)
        off += size
        for i, g in enumerate(gates):
            mats[g] = block[:, :, i].permute(1, 0, 2).reshape(H, C * w)
    assert off == packed.shape[1]
    return [mats[g] for g in sorted(mats)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("mode", MODES)
def test_packing_unpacks_to_each_ranks_column_blocks(mode, P, bf16):
    """Rank r's row of the forward's packing holds, block by block,
    columns k*cols .. of V[:, shard_r], Vz[:, shard_r], Vr[:, shard_r] in
    the step's passes (zero past H/P); the backward's those of V^T, Vz^T,
    Vr^T; in the bf16 mode rounded to bf16."""
    n = fused_tp_ann._MODES[mode]["n_wx"]
    hl, B = 40, 12
    H = P * hl
    rng = np.random.default_rng(P)
    vs = [torch.from_numpy(rng.normal(0, 1, (H, H)).astype(np.float32))
          for _ in range(n)]
    for backward, passes in ((False, fused_ann._FWD_PASSES[mode]),
                             (True, fused_ann._BWD_PASSES[mode])):
        plan = plan_of(mode, B, H, P, bf16, backward).rank
        packed = fused_tp_ann._pack_slices(vs, passes, plan, P, bf16,
                                           transpose=backward)
        assert packed.shape == (P, plan.cluster, n * H * plan.cols)
        assert packed.is_contiguous()
        assert packed.dtype == (torch.bfloat16 if bf16 else torch.float32)
        mats = [v.t() for v in vs] if backward else vs
        for r in range(P):
            got = unpack_rank(packed[r], passes, plan, H)
            for m, x in zip(mats, got):
                want = m[:, r * hl:(r + 1) * hl]
                want = want.to(torch.bfloat16) if bf16 else want
                assert torch.equal(x[:, :hl], want), (backward, r)
                assert not x[:, hl:].float().any()


@pytest.mark.parametrize("H", (256, 512, 1024, 2048))
@pytest.mark.parametrize("B", (128, 136))
def test_plan_at_p1_is_the_single_card_plan(B, H):
    """At P = 1, at the batches that fill the card (B = 128: sixteen
    clusters of six; 136: seventeen), the TP kernels' time loop has the
    single-card kernels' plan: the same cluster, rows, slice and residency.
    (Their bits agree whatever the plans; at a batch that leaves SMs idle,
    B = 8, the TP plan takes more of them with smaller clusters.) The GRU
    backward's stages may be larger: its block holds three operand planes,
    the single-card kernel's four."""
    for mode in MODES:
        n = fused_tp_ann._MODES[mode]["n_wx"]
        for bf16 in (False, True):
            assert plan_of(mode, B, H, 1, bf16, False).rank == \
                fused_ann._fwd_plan(B, H, n, bf16)
            tp = plan_of(mode, B, H, 1, bf16, True).rank
            single = fused_ann._bwd_plan(B, 20, H, n, bf16)[0]
            if mode == "gru":
                tp, single = tp._replace(stage_bytes=0), \
                    single._replace(stage_bytes=0)
            assert tp == single


def test_the_main_paths_plans():
    """GRU (128, 100, 1024): P = 1 sixteen clusters of six blocks, 8 rows
    each (the single-card plan); P = 2 thirty-two clusters of two a rank,
    4 rows each (256 threads; three blocks of 352 would fit 8 rows); P = 4
    sixteen clusters of two a rank, 8 rows; every group at once."""
    want = {1: (6, 8, 176, 16), 2: (2, 4, 256, 32), 4: (2, 8, 128, 16)}
    for P, (c, rows, cols, per_rank) in want.items():
        for bf16 in (False, True):
            for backward in (False, True):
                p = plan_of("gru", 128, 1024, P, bf16, backward)
                assert (p.rank.cluster, p.rank.rows, p.rank.cols,
                        p.per_rank, p.walks) == (c, rows, cols, per_rank, 1)
                assert not p.rank.resident


def test_widths_the_kernels_refuse():
    """H/P a multiple of 8, at most 2048, at most 8 ranks, and the
    operands with room for a stage of the slice: the GRU takes H = 4096 at
    P = 2 (its backward's three operand planes), the LiGRU's four stop
    short of it."""
    ok = fused_tp_ann._check_width
    ok("gru", 4096, 2, False)
    for args, match in ((("rnn", 2176, 1, False), "H/P <= 2048"),
                        (("gru", 4096 + 256, 2, False), "H/P <= 2048"),
                        (("rnn", 12, 2, False), "multiple of 8"),
                        (("ligru", 3584, 2, False), "shared memory"),
                        (("rnn", 9 * 128, 9, False), "at most 8 ranks")):
        with pytest.raises(ValueError, match=match):
            ok(*args)


@pytest.mark.parametrize("held", [H100.get, lambda c: 2, lambda c: 64])
@pytest.mark.parametrize("H", range(3456, 4097, 128))
def test_gru_takes_the_widest_layers_at_p2(H, held):
    """The widths the JAX entry takes at P = 2 past H = 3328: the
    GRU's plans run in both directions and modes (four rows a cluster, the
    backward's three planes of gathered rows beside stages that hold a row
    of its widest pass), whatever the card holds (``max_active``
    injected)."""
    for bf16 in (False, True):
        for backward in (False, True):
            p = plan_of("gru", 8, H, 2, bf16, backward, held)
            elem = 2 if bf16 else 4
            operands = operands_of("gru", backward) * p.rank.rows * H * 4
            assert p.rank.rows == 4 and not p.rank.resident
            assert p.rank.threads <= fused_ann._MAX_THREADS
            assert operands + 3 * p.rank.stage_bytes <= SMEM_BUDGET
            assert p.rank.stage_bytes >= 2 * p.rank.cols * elem
            assert p.per_rank * 2 <= held(p.rank.cluster)
