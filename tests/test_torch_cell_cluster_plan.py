"""The launch plans of the spiking backward kernels, which run their time
loops as thread-block clusters (``csrc/cluster_slice.cuh``): the
single-card ``csrc/fused_cell_bwd.cu`` (``ops.fused_cells._bwd_plan``) and
the tensor-parallel ``csrc/tp_cell_bwd.cu`` (``ops.fused_tp._bwd_plan``,
clusters per rank).

On the CPU, over widths from 1 to 4096, batches with partial row groups,
P = 1, 2, 4 and the cluster counts a card holds injected: every (rank,
batch row, neuron) is owned by exactly one thread; blocks fit their
threads; the slice is resident exactly where its bytes fit beside the
operands, else a stage holds rows of it; the clusters of all ranks fit in
what the card holds and walk their row groups in one order; the partials
of the parameter gradients group the rows as the kernels before the
cluster split did (the single-card kernel's blocks of two rows at H <= 512,
else one; the TP kernel's blocks, whose plan the wrapper mirrors); and the
TP packing unpacks to each rank's block of V^T."""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.ops import fused_ann, fused_cells, fused_tp, fused_tp_ann

HS = (1, 8, 40, 200, 512, 520, 1001, 1024, 2048, 2056, 3072, 3080, 4096)
BS = (1, 5, 12, 128, 130, 256)
SMEM_BUDGET = 232448 - 1024  # an H100 block's shared memory less the static
# clusters of 1..6 one-SM blocks an H100 80GB HBM3 holds at once
H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17}
RT = fused_ann._ROWS_PER_THREAD


def _owned_once(rows, cols, n_rows, width):
    """Every (row, neuron) of an (n_rows, width) grid is owned once, where
    ``rows`` and ``cols`` (arrays that broadcast to one shape, one entry a
    thread and owned row) say which the plan's threads own."""
    rows, cols = np.broadcast_arrays(rows, cols)
    owned = np.zeros((n_rows, int(cols.max()) + 1), np.int32)
    np.add.at(owned, (rows.ravel(), cols.ravel()), 1)
    assert (owned[:, :width] == 1).all()
    assert (owned[:, width:] <= 1).all()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H", HS)
def test_single_card_plan_owns_every_row_and_neuron_once(H, bf16):
    """Cluster i, block k, thread (tx, ty) owns neuron k*cols + tx of rows
    i*rows + 4*ty .. +3 (``cell_bwd_cluster_kernel``); a block fits its
    threads (512 at most), clusters of six up to H = 3072, of eight past
    it; four rows a cluster past H = 2048."""
    for B in BS:
        p, n_parts, ksplit = fused_cells._bwd_plan(B, 100, H, True, bf16)
        assert p.cluster == (8 if H > 3072 else max(1, min(6, H // 32)))
        assert p.rows == 8 if H <= 2048 and p.cols <= 192 else p.rows == 4
        assert p.threads % 32 == 0 and p.threads <= 512
        live = p.cols * (p.rows // RT)
        assert live <= p.threads < live + 32
        assert p.clusters == -(-B // p.rows)
        t = np.arange(live)
        # [block k, cluster i, thread, row of the thread]
        rows = (np.arange(p.clusters)[None, :, None, None] * p.rows
                + (t // p.cols)[None, None, :, None] * RT
                + np.arange(RT)[None, None, None, :])
        cols = (np.arange(p.cluster)[:, None, None, None] * p.cols
                + (t % p.cols)[None, None, :, None])
        _owned_once(rows, cols, p.clusters * p.rows, H)
        assert n_parts == -(-B // (2 if H <= 512 else 1))
        assert ksplit == fused_ann._dv_split(B, 100, H, 1)


@pytest.mark.parametrize("H", HS)
def test_single_card_plan_is_resident_where_its_bytes_fit(H):
    """The slice of V^T (H rows of cols elements) is resident exactly where
    it fits beside the operand's two parities (rows x H floats each); else
    three stages of at most 64 KB hold whole rows of it."""
    for bf16 in (False, True):
        p = fused_cells._cluster_plan(128, H, bf16)
        elem = 2 if bf16 else 4
        operands = 2 * p.rows * H * 4
        assert p.resident == (operands + H * p.cols * elem <= SMEM_BUDGET)
        if not p.resident:
            assert p.cols * elem <= p.stage_bytes <= 65536
            assert operands + 3 * p.stage_bytes <= SMEM_BUDGET


def test_single_card_main_shapes():
    """RadLIF (128, 100, 512): sixteen clusters of six blocks of 88
    columns, eight rows, the slice resident (one wave); (256, 100, 1024):
    32 clusters of six of 176 columns, streamed; H = 4096: eight blocks of
    512 columns, four rows."""
    for bf16 in (False, True):
        p = fused_cells._cluster_plan(128, 512, bf16)
        assert (p.cluster, p.rows, p.cols, p.resident, p.clusters) == \
            (6, 8, 88, True, 16)
        p = fused_cells._cluster_plan(256, 1024, bf16)
        assert (p.cluster, p.rows, p.cols, p.resident, p.clusters) == \
            (6, 8, 176, False, 32)
        p = fused_cells._cluster_plan(4, 4096, bf16)
        assert (p.cluster, p.rows, p.cols, p.threads) == (8, 4, 512, 512)
    assert fused_cells._bwd_plan(8, 3, 512, False)[0] is None


@pytest.mark.parametrize("H", (40, 512, 1001, 4096))
@pytest.mark.parametrize("B", BS)
def test_single_card_partials_group_rows_as_before_the_split(B, H):
    """A thread sums partial ``row // part_rows`` for each of its rows, and
    the rows of each partial are those of a block of the kernel before the
    cluster split (two rows at H <= 512: one neuron a thread; else one)."""
    p, n_parts, _ = fused_cells._bwd_plan(B, 20, H, True)
    pr = fused_cells._part_rows(H)
    npt = 1
    while -(-H // npt) > 512:
        npt *= 2
    assert pr == max(1, 2 // npt)
    assert RT % pr == 0 and p.rows % pr == 0
    parts = [[r for r in range(B) if r // pr == q] for q in range(n_parts)]
    assert parts == [list(range(q * pr, min(B, q * pr + pr)))
                     for q in range(n_parts)]


def tp_plan(B, H, P, bf16, held=H100.get):
    return fused_tp._bwd_plan(B, H, P, bf16, held)


def tp_cases():
    """(B, H/P): ranks of 128 (clusters of four slices), 256 (the main
    path at P = 4), 1024 and 2048 (the widest); batches with a partial
    group, the main path's 256, and 1024 (walks)."""
    for hl in (128, 256, 1024, 2048):
        for B in (8, 24, 256, 1024):
            yield B, hl


@pytest.mark.parametrize("P", (1, 2, 4))
def test_tp_plan_owns_every_rank_row_and_neuron_once(P):
    """Cluster i of rank r, block k, thread tx owns neuron k*cols + tx of
    every row of group i (``tp_cell_bwd_kernel``: a thread owns them all);
    the rows a cluster are 8, 4, 2 or 1 as two parities of H floats fit in
    128 KB; a block fits its threads (384 at most)."""
    for B, hl in tp_cases():
        H = P * hl
        for bf16 in (False, True):
            q = tp_plan(B, H, P, bf16).rank
            assert q.rows == fused_tp._bwd_rows(H)
            assert 2 * q.rows * H * 4 <= 131072
            assert q.rows == 8 or 2 * (2 * q.rows) * H * 4 > 131072
            assert q.threads == -(-q.cols // 32) * 32 <= 384
            # [block k, cluster i, thread tx, row]
            rows = (np.arange(q.clusters)[None, :, None, None] * q.rows
                    + np.arange(q.rows)[None, None, None, :])
            cols = (np.arange(q.cluster)[:, None, None, None] * q.cols
                    + np.arange(q.cols)[None, None, :, None])
            _owned_once(rows, cols, q.clusters * q.rows, hl)


@pytest.mark.parametrize("held", [H100.get, lambda c: 4, lambda c: 64])
@pytest.mark.parametrize("P", (1, 2, 4))
def test_tp_plan_fits_what_the_card_holds_and_walks_in_one_order(P, held):
    """All ranks' clusters fit at once in what the card holds (injected);
    where a rank has more row groups than that, its clusters walk them, i,
    i + per_rank, ..., every group once, in the same order on every rank;
    the plan is the cheapest in warps a block times walks."""
    for B, hl in tp_cases():
        H = P * hl
        plan = tp_plan(B, H, P, False, held)
        q = plan.rank
        assert plan.per_rank * P <= held(q.cluster)
        assert plan.walks == -(-q.clusters // plan.per_rank)
        walked = sorted(g for i in range(plan.per_rank)
                        for g in range(i, q.clusters, plan.per_rank))
        assert walked == list(range(q.clusters))
        first = fused_tp._bwd_rank_plan(B, H, P, False)
        for c in range(first.cluster, 0, -1):
            other = fused_tp._bwd_rank_plan(B, H, P, False, c)
            per = min(other.clusters, held(c) // P)
            if not fused_tp_ann._runs(other, 1, False) or per < 1:
                continue
            cost = -(-other.clusters // per) * other.threads // 32
            assert fused_tp_ann._cost(plan) <= cost


@pytest.mark.parametrize("P", (1, 2, 4))
def test_tp_plan_is_resident_where_its_bytes_fit(P):
    for B, hl in tp_cases():
        H = P * hl
        for bf16 in (False, True):
            q = tp_plan(B, H, P, bf16).rank
            elem = 2 if bf16 else 4
            operands = 2 * q.rows * H * 4
            assert q.resident == (operands + H * q.cols * elem
                                  <= SMEM_BUDGET)
            if not q.resident:
                assert q.cols * elem <= q.stage_bytes <= 65536
                assert operands + 3 * q.stage_bytes <= SMEM_BUDGET


def test_tp_main_path_plans_and_partials():
    """RadLIF (256, 100, 1024) on an H100 (132 SMs, the cluster counts
    above): P = 1 clusters of three, P = 2 and 4 of two, eight rows; the
    partials keep the rows of the kernel before the split, whose plans ran
    2, 4 and 8 rows a block there (128, 64, 32 blocks a rank: every group
    at once)."""
    want = {1: (3, 344, 32, 1, 2), 2: (2, 256, 32, 1, 4),
            4: (2, 128, 16, 2, 8)}
    for P, (c, cols, per_rank, walks, pr) in want.items():
        plan = tp_plan(256, 1024, P, False)
        assert (plan.rank.cluster, plan.rank.rows, plan.rank.cols,
                plan.per_rank, plan.walks) == (c, 8, cols, per_rank, walks)
        assert fused_tp._bwd_part_rows(256, 1024, P, 132) == pr


@pytest.mark.parametrize("P", (1, 2, 4))
def test_tp_partials_divide_the_rows_of_a_cluster(P):
    """The rows of a partial are 1, 2, 4 or 8, divide the rows of a
    cluster at every width a rank takes, and are those of the first plan of
    the kernel before the split at which every group of every rank was at
    work at once (else of the most rows at work)."""
    for hl in (128, 256, 512, 1024, 2048):
        H = P * hl
        for B in (8, 16, 64, 256, 264, 1024, 4096):
            for sms in (132, 114):
                pr = fused_tp._bwd_part_rows(B, H, P, sms)
                assert pr in (1, 2, 4, 8)
                assert fused_tp._bwd_rows(H) % pr == 0
                fit = -(-B // pr) <= sms // P
                smaller = [bt for bt in (1, 2, 4, 8) if bt < pr]
                if fit:
                    # no smaller block held every group
                    assert all(-(-B // bt) > sms // P for bt in smaller)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("P", (1, 2, 4))
def test_tp_packing_unpacks_to_each_ranks_block_of_vt(P, bf16):
    """Rank r's row of the packing holds, block by block, columns k*cols ..
    of V[shard_r, :]^T (zero past H/P), rounded to bf16 in that mode."""
    hl, B = 136, 16
    H = P * hl
    V = torch.from_numpy(np.random.default_rng(P).normal(
        0, 1, (H, H)).astype(np.float32))
    plan = tp_plan(B, H, P, bf16).rank
    packed = fused_tp_ann._pack_slices([V], ((0,),), plan, P, bf16,
                                       transpose=True)
    C, w = plan.cluster, plan.cols
    assert packed.shape == (P, C, H * w) and packed.is_contiguous()
    for r in range(P):
        got = packed[r].reshape(C, H, w).permute(1, 0, 2).reshape(H, C * w)
        want = V.t()[:, r * hl:(r + 1) * hl]
        want = want.to(torch.bfloat16) if bf16 else want
        assert torch.equal(got[:, :hl], want)
        assert not got[:, hl:].float().any()
