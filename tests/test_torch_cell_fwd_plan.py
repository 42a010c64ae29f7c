"""The launch plans of the recurrent spiking forwards in their column-slice
layout (``csrc/spike_slices.cuh``): the single-card ``csrc/fused_cell_fwd.cu``
(RLIF/RadLIF; P = 1) and the tensor-parallel ``csrc/tp_cell_fwd.cu`` (P
ranks in one launch), both planned by ``ops.fused_cells._fwd_plan``.

On the CPU, over widths, batches with partial row groups, P = 1, 2, 4, both
stream modes and injected occupancies: every (rank, batch row, neuron) is
owned by exactly one lane of one block; a block's slice of V, its words and
its lists fit in shared memory exactly where the plan is a slice plan, and
the layout of one block a row remains only where no slice fits; all blocks
of the launch fit in what the card holds, and a block walks its groups in
one order; the main shapes get the plans ``PERF.md`` states; and the
TP forward's slice layout takes one slot of spike words."""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.ops import fused_cells

SMS = 132
SMEM = fused_cells._SLICE_SMEM
HS = (40, 128, 200, 512, 1001, 1024, 1536, 2048, 4096)
BS = (1, 5, 12, 128, 130, 256, 1024)


def smem_model(H, bf16):
    """Blocks an SM holds by shared memory (228 KB an SM, 1 KB of each
    block reserved) and by threads (2048), at most 2 at 512 threads (128
    registers a thread)."""
    def per_sm(cols, rows, threads):
        smem = fused_cells._slice_smem(H, cols, rows, threads, bf16)
        by_regs = 65536 // (threads * 64)
        return max(0, min(233472 // (smem + 1024), 2048 // threads,
                          by_regs))
    return per_sm


OCCUPANCIES = {
    "one": lambda H, bf16: (lambda c, r, t: 1),
    "smem": smem_model,
    "two": lambda H, bf16: (lambda c, r, t: 2),
}


def plan(B, H, P, bf16, occupancy="smem", sms=SMS):
    return fused_cells._fwd_plan(B, H, P, bf16, sms,
                                 OCCUPANCIES[occupancy](H, bf16))


def cases():
    for H in HS:
        for P in (1, 2, 4):
            if P > 1 and H % (P * 128):
                continue
            yield H, P


def owners(B, H, P, bf16, p):
    """(row, global column) of every live lane of every block and task
    (``slice_fwd_kernel``'s mapping), as two flat arrays."""
    cpt, nr = fused_cells._slice_lane(bf16)
    hl = H // P
    m = p.cols // (32 * cpt)
    q = p.threads // 32 // m
    rows, cols = [], []
    lane = np.arange(32)
    for sl in range(P * p.slices):
        rank, s = divmod(sl, p.slices)
        c0 = rank * hl + s * p.cols
        end = rank * hl + min(hl, (s + 1) * p.cols)
        for res in range(p.n_res):
            for g in range(res, p.n_groups, p.n_res):
                row0 = g * p.rows
                nrow = min(p.rows, B - row0)
                for warp in range(p.threads // 32):
                    chunk, rsub = warp % m, warp // m
                    for i in range(nr):
                        r = rsub + i * q
                        if r >= nrow:
                            continue
                        for c in range(cpt):
                            gc = c0 + chunk * 32 * cpt + lane * cpt + c
                            gc = gc[gc < end]
                            rows.append(np.full(gc.shape, row0 + r))
                            cols.append(gc)
    return np.concatenate(rows), np.concatenate(cols)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("P", (1, 2, 4))
def test_plan_owns_every_row_and_neuron_once(P, bf16):
    """Slice s of rank r, group g, warp (chunk, rsub), walk i and lane own
    neuron r*H/P + s*cols + chunk*32*cpt + lane*cpt + c of row g*rows + rsub
    + i*q: every (row, neuron) once, no lane past its rank's block, no warp
    more rows than it walks."""
    for H, p_ in cases():
        if p_ != P:
            continue
        for B in (1, 12, 130):
            p = plan(B, H, P, bf16)
            if p is None:
                continue
            cpt, nr = fused_cells._slice_lane(bf16)
            m = p.cols // (32 * cpt)
            assert p.threads % (32 * m) == 0 and p.threads <= 512
            assert -(-p.rows // (p.threads // 32 // m)) <= nr
            rows, cols = owners(B, H, P, bf16, p)
            owned = np.zeros((B, H), np.int32)
            np.add.at(owned, (rows, cols), 1)
            assert (owned == 1).all(), (B, H, P, bf16, p)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H", HS)
def test_plan_is_resident_where_the_bytes_fit(H, bf16):
    """A slice plan's slice (H + 1 rows of cols elements), words and lists
    fit in a block's shared memory; there is no slice plan exactly where
    not even the narrowest slice with one warp fits (H = 2048 and 4096:
    the layout of one block a row)."""
    cpt = fused_cells._slice_lane(bf16)[0]
    narrowest = fused_cells._slice_smem(H, 32 * cpt, 1, 32, bf16)
    for B in BS:
        for P in (1, 2, 4):
            if P > 1 and H % (P * 128):
                continue
            p = plan(B, H, P, bf16)
            assert (p is None) == (narrowest > SMEM), (B, H, P)
            if p is None:
                continue
            assert fused_cells._slice_smem(H, p.cols, p.rows, p.threads,
                                           bf16) <= SMEM
            assert p.cols % (32 * cpt) == 0
            assert p.slices == -(-(H // P) // p.cols)
            # no slice wider than needed: the last one holds a column
            assert (p.slices - 1) * p.cols < H // P
    assert (narrowest > SMEM) == (H >= 2048)


def work(p, P, sms):
    """Batch rows x columns an SM runs a step, over the walks."""
    return p.walks * -(-P * p.slices * p.n_res // sms) * p.rows * p.cols


def least_work(B, H, P, bf16, occupancy, sms):
    """The least ``work`` over every slice width and group size the kernel
    takes that fits in shared memory and on the card."""
    cpt, nr = fused_cells._slice_lane(bf16)
    held = OCCUPANCIES[occupancy](H, bf16)
    hl, best = H // P, None
    for m in range(1, 17):
        cols = 32 * cpt * m
        if cols - 32 * cpt >= hl:
            break
        per_group = P * -(-hl // cols)
        for rows in range(1, min(B, 16 // m * nr) + 1):
            threads = 32 * m * min(16 // m, rows)
            if fused_cells._slice_smem(H, cols, rows, threads, bf16) > SMEM:
                continue
            n_groups = -(-B // rows)
            n_res = min(n_groups, held(cols, rows, threads) * sms // per_group)
            if n_res < 1:
                continue
            w = -(-n_groups // n_res) * -(-per_group * n_res // sms) * \
                rows * cols
            best = w if best is None else min(best, w)
    return best


@pytest.mark.parametrize("occupancy", sorted(OCCUPANCIES))
@pytest.mark.parametrize("bf16", [False, True])
def test_plan_fits_what_the_card_holds_and_walks_in_one_order(bf16,
                                                             occupancy):
    """All slices of all ranks times n_res groups fit at once in what the
    card holds (injected); a block walks groups res, res + n_res, ...,
    every group once; the plan's work an SM and step is the least over the
    widths and rows the kernel takes."""
    for sms in (SMS, 16):
        for H, P in cases():
            for B in (5, 128, 256, 1024):
                p = plan(B, H, P, bf16, occupancy, sms)
                if p is None:
                    continue
                held = OCCUPANCIES[occupancy](H, bf16)(p.cols, p.rows,
                                                       p.threads)
                assert p.per_sm == held
                assert P * p.slices * p.n_res <= held * sms
                assert p.n_groups == -(-B // p.rows)
                assert p.walks == -(-p.n_groups // p.n_res)
                walked = sorted(g for res in range(p.n_res)
                                for g in range(res, p.n_groups, p.n_res))
                assert walked == list(range(p.n_groups))
                assert work(p, P, sms) == least_work(B, H, P, bf16,
                                                     occupancy, sms)


def test_main_shapes():
    """The plans that PERF.md section 6 states, one block an SM: RadLIF
    (256, 100, 1024) float32 32 slices of 32 columns x 4 groups of 64 rows,
    bf16 16 slices of 64 columns x 8 groups of 32; (128, 100, 512) float32
    8 x 64 columns x 16 groups of 8, bf16 4 x 128 x 32 groups of 4; the TP
    kernel at (256, 100, 1024) the single card's plan at every P; H = 2048
    and 4096 keep one block a row."""
    one = "one"
    want = {(256, 1024, False): (32, 64, 4, 32, 512),
            (256, 1024, True): (64, 32, 8, 16, 512),
            (128, 512, False): (64, 8, 16, 8, 512),
            (128, 512, True): (128, 4, 32, 4, 256)}
    for (B, H, bf16), (cols, rows, n_res, slices, threads) in want.items():
        p = plan(B, H, 1, bf16, one)
        assert (p.layout, p.cols, p.rows, p.n_res, p.slices, p.threads,
                p.walks) == ("slices", cols, rows, n_res, slices, threads, 1)
    for bf16 in (False, True):
        single = plan(256, 1024, 1, bf16, one)
        for P in (2, 4):
            p = plan(256, 1024, P, bf16, one)
            assert (p.cols, p.rows, p.n_res, P * p.slices) == \
                (single.cols, single.rows, single.n_res, single.slices)
        assert plan(16, 2048, 1, bf16, one) is None
        assert plan(8, 4096, 2, bf16, one) is None


@pytest.mark.parametrize("P", (1, 2, 4))
def test_tp_slice_layout_takes_one_slot_and_no_counters(P):
    """The TP forward's column-slice layout exchanges through one slot of
    tagged spike words ([2][B][H/32] u64), which the pointer of every rank
    names in the one-card form; it allocates no counters."""
    from sparch_tpu_torch.ops import fused_tp

    B, H = 12, P * 256
    slot, ptrs = fused_tp._slice_slots(B, H, P, torch.device("cpu"))
    assert slot.shape == (2, B, H // 32) and slot.dtype == torch.int64
    assert list(ptrs) == [slot.data_ptr()] * P
