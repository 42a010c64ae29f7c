"""The TP collectives' launch plan (ops/fused_tp.py ``_collective_plan``) and
their plain versions, on the CPU, without JAX.

The plan: over injected SM counts and occupancies (as the other plan tests
inject them), every batch row lies in exactly one group, the blocks of
every rank walk the same groups in the same order and together cover each
group once, the grid fits on the card at once (the cooperative launch's
condition), and a block's shared memory fits. The plain versions
(``tp_all_gather_plain``, ``tp_reduce_scatter_plain``) at P = 3 and 8
against a numpy loop of the JAX kernels' recurrence: each rank's stage sent
to its peers at offsets 1 .. P-1 into two parity slots, as
sparch_tpu/ops/pallas_tp.py ``_ag_kernel`` (:180-212) and ``_rs_kernel``
(:241-258) run it, bit for bit.
"""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.ops import fused_tp


def blocks_model(cap):
    """Blocks an SM holds at ``smem`` bytes: by threads (2048 a SM) and by
    shared memory (233472 bytes, 1 KB of it reserved a block), at most
    ``cap`` (an occupancy the card may report lower)."""
    def per_sm(smem):
        return max(0, min(cap, 2048 // fused_tp._COLL_THREADS,
                          233472 // (smem + 1024)))
    return per_sm


def walk(plan, k):
    """The groups block k of a rank runs, in order."""
    return list(range(k, plan.groups, plan.per_rank))


SHAPES = [(1, 128, 1), (13, 256, 3), (128, 256, 4), (128, 256, 8),
          (300, 1024, 8), (300, 1024, 5), (256, 2048, 2), (8, 8192, 1),
          (97, 384, 3), (1, 1024, 8)]


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("cap", [8, 2, 1])
@pytest.mark.parametrize("reduce", [False, True])
def test_plan_covers_every_row_once_and_fits(sms, cap, reduce):
    per_sm = blocks_model(cap)
    for B, hl, P in SHAPES:
        H = P * hl
        plan = fused_tp._collective_plan(B, H, P, reduce, sms, per_sm)
        assert plan.rows >= 1 and plan.per_rank >= 1
        assert plan.groups == -(-B // plan.rows)
        rows = [r for g in range(plan.groups)
                for r in range(g * plan.rows, min(B, (g + 1) * plan.rows))]
        assert rows == list(range(B))  # each row in exactly one group
        walks = [walk(plan, k) for k in range(plan.per_rank)]
        assert sorted(g for w in walks for g in w) == list(
            range(plan.groups))
        assert max(len(w) for w in walks) == plan.walks
        # every rank runs the same walks (blocks rank * per_rank + k)
        assert all(walk(plan, k) == walks[k] for _ in range(P)
                   for k in range(plan.per_rank))
        # the grid held at once, the shared memory within a block's
        assert P * plan.per_rank <= plan.per_sm * sms
        assert plan.per_sm == per_sm(plan.smem)
        assert plan.smem == fused_tp._collective_smem(plan.rows, H, P,
                                                      reduce)
        assert plan.smem <= fused_tp._COLL_SMEM
        # about one block an SM, at most _COLL_MAX_ROWS rows, fewer only
        # where memory forces it: one row more would not fit
        spread = min(-(-P * B // sms), fused_tp._COLL_MAX_ROWS, B)
        assert plan.rows == spread or fused_tp._collective_smem(
            plan.rows + 1, H, P, reduce) > fused_tp._COLL_SMEM
        assert plan.rows <= spread
        # the counters a launch takes fit in a counter buffer
        assert P * P * plan.per_rank * 2 <= \
            2 * fused_tp._MAX_RANKS * (2048 // plan.threads) * sms


def test_plan_at_the_smoke_shape():
    plan = fused_tp._collective_plan(128, 1024, 4, False, 132,
                                     blocks_model(8))
    assert (plan.rows, plan.groups, plan.per_rank, plan.walks) == \
        (4, 32, 32, 1)
    plan = fused_tp._collective_plan(128, 2048, 8, True, 132,
                                     blocks_model(8))
    assert (plan.rows, plan.groups, plan.per_rank, plan.walks) == \
        (4, 32, 32, 1)


def test_plan_refuses_what_cannot_run():
    with pytest.raises(ValueError, match="does not fit"):
        fused_tp._collective_plan(8, 8 * 8192, 8, True, 132, blocks_model(8))
    with pytest.raises(ValueError, match="too few"):
        fused_tp._collective_plan(8, 1024, 4, False, 132, lambda smem: 0)
    with pytest.raises(ValueError, match="1 to 8 ranks"):
        fused_tp._collective_plan(8, 9 * 128, 9, False, 132, blocks_model(8))


def numpy_all_gather(x, P, rounds):
    """``_ag_kernel`` on P simulated ranks: (P, rounds, B, H)."""
    B, H = x.shape
    hl = H // P
    slots = np.zeros((P, 2, B, H), np.float32)
    out = np.zeros((P, rounds, B, H), np.float32)
    for r in range(rounds):
        par = r % 2
        stages = [x[:, q * hl:(q + 1) * hl] if r == 0
                  else slots[q, (r - 1) % 2, :, q * hl:(q + 1) * hl]
                  + np.float32(1.0) for q in range(P)]
        for q in range(P):
            slots[q, par, :, q * hl:(q + 1) * hl] = stages[q]
            for d in range(1, P):
                dst = (q + d) % P
                slots[dst, par, :, q * hl:(q + 1) * hl] = stages[q]
        out[:, r] = slots[:, par]
    return out


def numpy_reduce_scatter(parts, P, rounds):
    """``_rs_kernel`` on P simulated ranks: (rounds, B, H), rank q's
    reduced block at its columns."""
    _, B, H = parts.shape
    hl = H // P
    slots = np.zeros((P, 2, max(P - 1, 1), B, hl), np.float32)
    out = np.zeros((rounds, B, H), np.float32)
    acc = [None] * P
    for r in range(rounds):
        par = r % 2
        stages = [parts[q] if r == 0 else parts[q] + acc[q][:, 0:1]
                  for q in range(P)]
        for q in range(P):
            for d in range(1, P):
                dst = (q + d) % P
                slots[dst, par, d - 1] = stages[q][:, dst * hl:(dst + 1) * hl]
        for q in range(P):
            a = stages[q][:, q * hl:(q + 1) * hl]
            for d in range(1, P):
                a = a + slots[q, par, d - 1]
            acc[q] = a
            out[r, :, q * hl:(q + 1) * hl] = a
    return out


@pytest.mark.parametrize("P", [3, 8])
@pytest.mark.parametrize("B,rounds", [(13, 1), (8, 3), (5, 5)])
def test_plain_collectives_follow_the_jax_recurrence(P, B, rounds):
    rng = np.random.default_rng(P * 100 + B)
    H = P * 128
    x = rng.normal(0, 1, (B, H)).astype(np.float32)
    parts = rng.normal(0, 1, (P, B, H)).astype(np.float32)
    ag = fused_tp.tp_all_gather(torch.from_numpy(x), num_devices=P,
                                rounds=rounds)
    rs = fused_tp.tp_reduce_scatter(torch.from_numpy(parts), num_devices=P,
                                    rounds=rounds)
    np.testing.assert_array_equal(ag.numpy(), numpy_all_gather(x, P, rounds))
    np.testing.assert_array_equal(rs.numpy(),
                                  numpy_reduce_scatter(parts, P, rounds))
