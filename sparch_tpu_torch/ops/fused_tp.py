"""Tensor-parallel fused spiking cells (counterpart of
sparch_tpu/ops/pallas_tp.py): the neurons of a layer split into P column
blocks of Hl = H/P, one per rank of the TP axis, with an exchange inside the
kernel at every step.

- RLIF/RadLIF (``rlif_tp``, ``radlif_tp``): each step's recurrent drive
  ``s_full @ V[:, shard]`` needs every rank's spikes of the step before, so
  the forward all-gathers the spike blocks at every step, and the backward
  all-gathers the adjoint blocks D = (1-alpha)*A for ``R = D_full @
  V[shard, :]^T``. One ``torch.autograd.Function`` holds the two kernels
  (``csrc/tp_cell_fwd.cu``, ``csrc/tp_cell_bwd.cu``), as the JAX
  ``custom_vjp`` does.
- LIF/adLIF (``lif_tp``, ``adlif_tp``): no recurrence, so no exchange: the
  single-card fused cell (``ops.fused_cells``) runs on each block, without
  the affine and the dropout.
- ``tp_all_gather``, ``tp_reduce_scatter``: the harnesses that pin the
  exchange (``csrc/tp_collectives.cu``).

Two forms, one function, the same bits. The one-card form runs all P ranks
of a mesh that repeats one device (``parallel.make_mesh([dev] * P,
model=P)``) in one cooperative launch on that device, each rank storing into
its peers' buffers in the one card's memory. The form across cards runs a
mesh of P distinct cards (``make_mesh([cuda:0, .., cuda:P-1], model=P)``),
one rank a card: the entry points scatter rank r's column blocks to card r,
make one launch a card with ``rank0 = r``, ``n_local = 1`` behind one entry
barrier, the peers' buffers on their cards (``ops/tp_cards.py``), and gather
the outputs back. Either way the entry points take the full tensors, as the
layer holds them on the mesh's ``home`` card: ``Wx (B, T, H)``, ``V (H,
H)``, the states ``(B, H)``; rank r's block is columns ``r*Hl .. (r+1)*Hl``
of each, and the gathered initial spikes are the full ``s0``. Across cards
the backward's dV block of rank r takes the full u series, gathered onto its
card after the forward (``tp_cell_bwd.cu``). The ``*_cards_plain``
functions mirror that form rank by rank on the CPU.

The backward's time loop runs thread-block clusters per rank, as the TP
non-spiking kernels do (``csrc/tp_ann.cuh``): ``_bwd_plan`` chooses the
cluster size from what the card holds, and ``_bwd_part_rows`` the rows of
a partial of dalpha, dbeta, da and db (those of a block of the kernel
before the cluster split, so that these sums keep its bits).

Dispatch is ``ops.fused_cells``': a CPU tensor runs the plain versions
(``tp_all_gather_plain``, ``tp_reduce_scatter_plain``, ``tp_cell_plain``,
``tp_cell_bwd_plain``), loops over T and over the P blocks in the kernels'
rounding order; a CUDA tensor launches the kernels or raises. Normalisation
and dropout stay outside these cells (the layer applies them), as in the JAX
package. Widths as the JAX kernels take them: H divisible by P*128, B by 8.

The bf16-stream mode (``mxu_bf16=True``, the JAX kernels' mode of that name)
rounds where ``ops.fused_cells``' bf16 mode rounds, and the JAX TP kernels
with it: V is rounded to bf16 once, the spikes, the cotangent and ``dWx``
are bf16 streams, ``Wx`` keeps the type it arrives in (float32, or bf16) and
is promoted on load, the gathered s0 is rounded for the first product only,
and the exchanged adjoint D is rounded to bf16 (the bf16 wire), so both the
recurrent product and ``dV`` see the rounded value; the membrane series, the
state, the adjoints and every reduced gradient stay float32. The spike
exchange moves bit words in either mode. The kernels' launches are counted
apart (``tp_cell_fwd_bf16``, ``tp_cell_bwd_bf16``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from sparch_tpu_torch._build import Kernel
from sparch_tpu_torch.ops import fused_cells, tp_cards
from sparch_tpu_torch.ops.fused_cells import (
    _BF16,
    _rb,
    _stream_dtype,
    _work_dtype,
    _wx_dtypes,
)

__all__ = [
    "KERNELS",
    "LANE",
    "last_plans",
    "last_bwd_plan",
    "tp_all_gather",
    "tp_reduce_scatter",
    "tp_all_gather_plain",
    "tp_reduce_scatter_plain",
    "tp_all_gather_cards_plain",
    "tp_reduce_scatter_cards_plain",
    "tp_cell_plain",
    "tp_cell_bwd_plain",
    "tp_cell_cards_plain",
    "tp_cell_bwd_cards_plain",
    "zero_diag_shard",
    "rlif_tp",
    "radlif_tp",
    "lif_tp",
    "adlif_tp",
]

LANE = 128
# widest block a rank takes (csrc/tp_cell_*.cu kThreads * kMaxNpt)
_MAX_HL = 2048

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_COLLECTIVE_ARGS = [_P] * 4 + [_I] * 7 + [_P, _P]
TP_ALL_GATHER = Kernel("tp_collectives", "sparch_tp_all_gather",
                       _COLLECTIVE_ARGS, name="tp_all_gather")
TP_REDUCE_SCATTER = Kernel("tp_collectives", "sparch_tp_reduce_scatter",
                           _COLLECTIVE_ARGS, name="tp_reduce_scatter")
# one C entry point per direction serves both stream modes; the modes are
# counted apart
_FWD_ARGS = [_P] * 13 + [_I] * 7 + [_F] + [_I] * 3 + [_P] * 5
_BWD_ARGS = [_P] * 21 + [_I] * 7 + [_F] + [_I] * 8 + [_P] * 3
TP_CELL_FWD = Kernel("tp_cell_fwd", "sparch_tp_cell_fwd", _FWD_ARGS)
TP_CELL_BWD = Kernel("tp_cell_bwd", "sparch_tp_cell_bwd", _BWD_ARGS)
TP_CELL_FWD_BF16 = Kernel("tp_cell_fwd", "sparch_tp_cell_fwd", _FWD_ARGS,
                          name="tp_cell_fwd_bf16")
TP_CELL_BWD_BF16 = Kernel("tp_cell_bwd", "sparch_tp_cell_bwd", _BWD_ARGS,
                          name="tp_cell_bwd_bf16")
KERNELS = (TP_ALL_GATHER, TP_REDUCE_SCATTER, TP_CELL_FWD, TP_CELL_BWD,
           TP_CELL_FWD_BF16, TP_CELL_BWD_BF16)

# csrc/tp_cell_bwd.cu: the bytes of a cluster's two parities of gathered
# rows at most (they fix its rows: 8, 4, 2 or 1)
_OPERAND_BYTES = 131072
# the backward before the cluster split, whose row grouping the partials of
# dalpha, dbeta, da and db keep: its threads a block at most, its neurons a
# thread times rows a block at most, the bytes of its stream's stages, and
# the shared memory a block could ask for (one block an SM)
_SPLIT_THREADS = 512
_SPLIT_WORK = 16
_SPLIT_STAGE_BYTES = 3 * 65536
_SPLIT_SMEM = 227 * 1024 - 256

_PLANS: Dict[str, Union[Tuple[int, ...], dict]] = {}


def last_plans() -> Dict[str, Union[Tuple[int, ...], dict]]:
    """The launch plan of each kernel's last launch: the collectives'
    (``CollectivePlan``'s fields), the spiking forward's
    (``fused_cells.FwdPlan``'s fields, as ``fused_cells.last_plans`` holds
    them), the spiking backward's (``last_bwd_plan``) and the non-spiking
    cells' as ``fused_tp_ann.last_plan`` names them."""
    return dict(_PLANS)


def last_bwd_plan() -> dict:
    """The plan of the last launch of ``tp_cell_bwd`` (either stream mode):
    ``fused_tp_ann.last_plan``'s keys and the rows of a partial."""
    from sparch_tpu_torch.ops import fused_tp_ann

    *plan, part_rows = _PLANS["tp_cell_bwd"]
    return dict(zip(fused_tp_ann._PLAN_KEYS, plan), part_rows=part_rows,
                launch_mode=fused_tp_ann.LAUNCH_MODE)


def _shards(H: int, P: int) -> List[slice]:
    hl = H // P
    return [slice(r * hl, (r + 1) * hl) for r in range(P)]


def _validate(H: int, P: int) -> None:
    """The JAX package's width check (pallas_tp.py:964-970). Its kernels
    also wanted the rows a multiple of 8 (a TPU sublane); the CUDA kernels
    take any number."""
    if H % (P * LANE):
        raise ValueError(
            f"tensor-parallel fused cells need hidden_size divisible by "
            f"num_model_devices*{LANE} (got H={H}, tp={P}); use the scan "
            f"cells for other widths"
        )


# ---------------------------------------------------------------------------
# The exchange harnesses
# ---------------------------------------------------------------------------


def tp_all_gather_plain(x, *, num_devices: int, rounds: int = 3):
    """Plain version of ``csrc/tp_collectives.cu`` ``tp_all_gather``:
    ``x`` (B, H) holds the P ranks' (B, H/P) blocks side by side; returns
    (P, rounds, B, H), every rank's gathered planes. Round 0 gathers x;
    round r > 0 gathers each rank's own block of round r-1's gather + 1
    (JAX ``_ag_kernel``), so round r holds x + r."""
    B, H = x.shape
    out = x.new_empty((num_devices, rounds, B, H))
    for r in range(rounds):
        for q, c in enumerate(_shards(H, num_devices)):
            stage = x[:, c] if r == 0 else out[q, r - 1][:, c] + 1.0
            out[:, r, :, c] = stage  # every rank receives rank q's block
    return out


def tp_reduce_scatter_plain(parts, *, num_devices: int, rounds: int = 3):
    """Plain version of ``tp_reduce_scatter``: ``parts`` (P, B, H) holds
    each rank's partial; returns (rounds, B, H), rank q's reduced block at
    its columns. Round 0 reduces the partials; round r > 0 reduces
    ``parts[q] + acc_{r-1}[:, first column of q]`` (JAX ``_rs_kernel``).
    Rank q adds its own block first, then the blocks of the ranks q-1,
    q-2, ... (sender offset d = 1..P-1), the JAX kernel's order."""
    P, B, H = parts.shape
    sl = _shards(H, num_devices)
    out = parts.new_empty((rounds, B, H))
    for r in range(rounds):
        stages = [parts[q] if r == 0
                  else parts[q] + out[r - 1][:, c.start:c.start + 1]
                  for q, c in enumerate(sl)]
        for q, c in enumerate(sl):
            acc = stages[q][:, c]
            for d in range(1, num_devices):
                acc = acc + stages[(q - d) % num_devices][:, c]
            out[r][:, c] = acc
    return out


def tp_all_gather_cards_plain(x, *, num_devices: int, rounds: int = 3):
    """``tp_all_gather_plain`` as the form across cards computes it, rank
    by rank: rank q holds only its block of ``x`` and its own planes, and
    each round takes what every rank sent it."""
    P = num_devices
    own = [tp_cards.columns(x, P, q) for q in range(P)]
    planes = [[] for _ in range(P)]
    for r in range(rounds):
        sent = own if r == 0 else [
            tp_cards.columns(planes[q][r - 1], P, q) + 1.0 for q in range(P)]
        for q in range(P):
            planes[q].append(torch.cat(sent, dim=1))
    return torch.stack([torch.stack(p) for p in planes])


def tp_reduce_scatter_cards_plain(parts, *, num_devices: int,
                                  rounds: int = 3):
    """``tp_reduce_scatter_plain`` as the form across cards computes it,
    rank by rank: rank q holds only its partial and its reduced block, sends
    column block d to rank d, and adds what it receives in the kernel's
    order (its own first, then sender offsets 1 .. P-1)."""
    P = num_devices
    acc = [[] for _ in range(P)]
    for r in range(rounds):
        stages = [parts[q] if r == 0 else parts[q] + acc[q][r - 1][:, :1]
                  for q in range(P)]
        for d in range(P):
            got = stages[d]
            total = tp_cards.columns(got, P, d)
            for off in range(1, P):
                total = total + tp_cards.columns(stages[(d - off) % P], P, d)
            acc[d].append(total)
    return torch.stack([torch.cat([acc[d][r] for d in range(P)], dim=1)
                        for r in range(rounds)])


def _check_collective(x, num_devices: int, rounds: int) -> None:
    H = x.shape[-1]
    if H % (num_devices * LANE):
        raise ValueError(
            f"TP shard width must be lane-aligned: H={H} over "
            f"{num_devices} ranks")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")


def _exchange_buffers(slot_shape, dtype, P: int, groups: int, dev):
    """Every rank's slots and zeroed counters, and the host arrays of their
    bases that the kernels take (the one-card form: rank q's at index q)."""
    slots = torch.empty((P,) + tuple(slot_shape), dtype=dtype, device=dev)
    flags = torch.zeros((P, P, groups, 2), dtype=torch.int32, device=dev)
    slot_ptrs = (ctypes.c_void_p * P)(*[slots[q].data_ptr()
                                        for q in range(P)])
    flag_ptrs = (ctypes.c_void_p * P)(*[flags[q].data_ptr()
                                        for q in range(P)])
    return (slots, flags, ctypes.cast(slot_ptrs, ctypes.c_void_p),
            ctypes.cast(flag_ptrs, ctypes.c_void_p), (slot_ptrs, flag_ptrs))


def _slice_slots(B: int, H: int, P: int, dev):
    """The slot of the column-slice layout's tagged spike words ([2][B]
    [H/32] u64; the first product's launch zeroes it), which every rank of
    the one-card form reads, and the host array of P pointers to it that
    the kernel takes."""
    slot = torch.empty((2, B, H // 32), dtype=torch.int64, device=dev)
    return slot, (ctypes.c_void_p * P)(*[slot.data_ptr()] * P)


def _launch(kernel: Kernel, dev, *args, n_plan: int):
    plan = (ctypes.c_int * n_plan)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel(*args, ctypes.cast(plan, ctypes.c_void_p), stream)
    # both stream modes of a kernel under one name
    _PLANS[kernel.name.removesuffix("_bf16")] = tuple(plan)
    return tuple(plan)


class CollectivePlan(NamedTuple):
    """A launch of ``csrc/tp_collectives.cu``: a block owns ``rows`` batch
    rows of one rank; ``groups`` = ceil(B / rows) groups a rank, of which
    ``per_rank`` run at once and ``walks`` one after another;
    ``per_sm`` blocks of ``smem`` bytes an SM holds."""

    rows: int
    groups: int
    per_rank: int
    walks: int
    per_sm: int
    smem: int
    threads: int


# csrc/tp_collectives.cu: threads a block, and the dynamic shared memory a
# block may take (kSmemMax); csrc/tp_exchange.cuh kMaxRanks
_COLL_THREADS = 256
_COLL_SMEM = 232448 - 1024
_MAX_RANKS = 8
# the most rows a group takes (chip_profile.py collective_forms' sweep of
# the rows a group, PERF.md: at P = 8 four rows two blocks an SM beat
# eight rows one)
_COLL_MAX_ROWS = 4


def _collective_smem(rows: int, H: int, P: int, reduce: bool) -> int:
    """Bytes of shared memory of a collective's block of ``rows`` rows:
    all-gather the payload and two gathered stages, reduce-scatter the
    partial, the payload, the arrivals and two reduced stages."""
    hl = H // P
    return 4 * rows * ((3 * H + 2 * hl) if reduce else (hl + 2 * H))


def _collective_plan(B: int, H: int, P: int, reduce: bool, sms: int,
                     per_sm: Callable[[int], int],
                     n_local: Optional[int] = None) -> CollectivePlan:
    """Rows a block and blocks a rank of a collective on a card of ``sms``
    SMs, ``per_sm(smem)`` the blocks an SM holds at ``smem`` bytes: the
    fewest rows that spread the card's ranks' groups over about one block
    an SM, at most ``_COLL_MAX_ROWS`` and what shared memory holds; every
    group at once where the card holds them, else the blocks of a rank walk
    them. ``n_local``: the ranks the card runs (default P, the one-card
    form; 1 across cards)."""
    if not 1 <= P <= _MAX_RANKS:
        raise ValueError(f"TP collective: 1 to {_MAX_RANKS} ranks, got {P}")
    n = P if n_local is None else n_local
    fit = _COLL_SMEM // _collective_smem(1, H, P, reduce)
    if fit < 1:
        raise ValueError(f"TP collective: a row of H={H} over {P} ranks "
                         f"does not fit in a block's shared memory")
    rows = max(1, min(-(-n * B // sms), _COLL_MAX_ROWS, fit, B))
    groups = -(-B // rows)
    smem = _collective_smem(rows, H, P, reduce)
    held = per_sm(smem)
    per_rank = min(groups, held * sms // n)
    if per_rank < 1:
        raise ValueError(f"TP collective: the card holds {held} blocks of "
                         f"{smem} bytes an SM, too few for {n} ranks")
    return CollectivePlan(rows, groups, per_rank, -(-groups // per_rank),
                          held, smem, _COLL_THREADS)


@functools.lru_cache(maxsize=None)
def collective_blocks(reduce: bool, smem: int, device_index: int) -> int:
    """Blocks of a collective with ``smem`` bytes an SM of the card
    ``device_index`` holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from sparch_tpu_torch import _build

    fn = _build.load("tp_collectives").sparch_tp_collective_blocks
    fn.argtypes = [_I, _I]
    fn.restype = _I
    with torch.cuda.device(device_index):
        return fn(int(reduce), smem)


@functools.lru_cache(maxsize=None)
def _card_collective_plan(B: int, H: int, P: int, reduce: bool,
                          device_index: int,
                          n_local: Optional[int] = None) -> CollectivePlan:
    """``_collective_plan`` on the card ``device_index``, once a shape."""
    sms = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    return _collective_plan(
        B, H, P, reduce, sms,
        lambda smem: collective_blocks(reduce, smem, device_index), n_local)


# The collectives' exchange counters: zeroed once when allocated, left zero
# by every launch (each block zeroes its own after its last exchange), never
# freed (a CUDA graph keeps their address). Two launches that run at once
# must not share them: eager launches take those of their (device,
# stream), and the launches that one capture of a CUDA graph records on one
# stream take a buffer of their own, by (device, stream, capture). So a
# replay, on any stream, shares its counters only with another replay of
# the same graph that overlaps it, which its slots forbid anyway. Sized for
# the most any plan takes: P * P ranks' counters of at most 2048 / threads
# blocks an SM, two parities.
_COUNTERS: Dict[Tuple[int, ...], torch.Tensor] = {}
# zeroed buffers for the captures to come, by device, refilled by eager calls
# (a capture cannot zero memory outside its graph)
_SPARE: Dict[int, List[torch.Tensor]] = {}
_SPARES = 4


def _capture_id(stream) -> int:
    """The id of the CUDA graph capture under way on ``stream``; 0 where
    none."""
    if not torch.cuda.is_current_stream_capturing():
        return 0
    from sparch_tpu_torch import _build

    fn = _build.load("tp_collectives").sparch_tp_capture_id
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_ulonglong
    return fn(stream.cuda_stream)


def _zeroed_counters(dev, n: int) -> List[torch.Tensor]:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    words = 2 * _MAX_RANKS * (2048 // _COLL_THREADS) * sms
    return list(torch.zeros((n, words), dtype=torch.int32,
                            device=dev).unbind())


def _counters(dev, stream) -> torch.Tensor:
    spare = _SPARE.setdefault(dev.index, [])
    capture = _capture_id(stream)
    if not capture and len(spare) < _SPARES:
        spare += _zeroed_counters(dev, _SPARES - len(spare))
        stream.synchronize()  # zero before any capture's replay
    key = (dev.index, stream.cuda_stream) + ((capture,) if capture else ())
    buf = _COUNTERS.get(key)
    if buf is None:
        if not capture:
            buf = _zeroed_counters(dev, 1)[0]
        elif spare:
            buf = spare.pop()
        else:
            raise RuntimeError(
                "TP collectives: call once on this device before capturing "
                f"them in a CUDA graph, and capture them on at most "
                f"{_SPARES} streams between eager calls (their exchange "
                "counters are zeroed outside the capture)")
        _COUNTERS[key] = buf
    return buf


def _collective_launch(kernel: Kernel, plan: CollectivePlan, x, out, slots,
                       P: int, rounds: int) -> None:
    """One launch of a collective in the one-card form (every rank here,
    rank q's slots and counters at index q)."""
    dev = x.device
    B, H = x.shape[-2:]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        counters = _counters(dev, stream)
        span = 4 * P * plan.per_rank * 2  # bytes of a rank's counters
        slot_ptrs = (ctypes.c_void_p * P)(*[slots[q].data_ptr()
                                            for q in range(P)])
        flag_ptrs = (ctypes.c_void_p * P)(*[counters.data_ptr() + q * span
                                            for q in range(P)])
        kernel(x.data_ptr(), out.data_ptr(), slot_ptrs, flag_ptrs, B, H, P,
               0, P, H, rounds, (ctypes.c_int * 2)(plan.rows, plan.per_rank),
               stream.cuda_stream)
    _PLANS[kernel.name] = plan._asdict()


def _tp_all_gather_cuda(x, *, num_devices: int, rounds: int = 3):
    B, H = x.shape
    P, dev = num_devices, x.device
    fused_cells._check("x", x, (B, H), dev)
    plan = _card_collective_plan(B, H, P, False, dev.index)
    out = torch.empty((P, rounds, B, H), dtype=torch.float32, device=dev)
    slots = torch.empty((P, 2, P, B, H // P), dtype=torch.float32, device=dev)
    _collective_launch(TP_ALL_GATHER, plan, x, out, slots, P, rounds)
    return out


def _tp_reduce_scatter_cuda(parts, *, num_devices: int, rounds: int = 3):
    P, B, H = parts.shape
    dev = parts.device
    fused_cells._check("parts", parts, (num_devices, B, H), dev)
    plan = _card_collective_plan(B, H, P, True, dev.index)
    out = torch.empty((rounds, B, H), dtype=torch.float32, device=dev)
    slots = torch.empty((P, 2, P, B, H // P), dtype=torch.float32, device=dev)
    _collective_launch(TP_REDUCE_SCATTER, plan, parts, out, slots, P, rounds)
    return out


class CardsCollective(NamedTuple):
    """A collective across cards with its operands placed: rank r's input
    and output on card r, the plan every card agreed on, the exchange."""

    kernel: Kernel
    cards: Tuple[torch.device, ...]
    plan: CollectivePlan
    ins: List[torch.Tensor]
    outs: List[torch.Tensor]
    ex: tp_cards.Exchange
    B: int
    H: int
    rounds: int

    def __call__(self) -> None:
        """One launch a card behind the entry barrier; no host wait."""
        P, hl = len(self.cards), self.H // len(self.cards)
        plan = (ctypes.c_int * 2)(self.plan.rows, self.plan.per_rank)
        streams = self.ex.enter()
        for r, card in enumerate(self.cards):
            with torch.cuda.device(card):
                self.kernel(self.ins[r].data_ptr(), self.outs[r].data_ptr(),
                            self.ex.slot_ptrs, self.ex.flag_ptrs, self.B,
                            self.H, P, r, 1, hl, self.rounds, plan,
                            streams[r].cuda_stream)
        self.ex.leave(streams)
        _PLANS[self.kernel.name] = dict(self.plan._asdict(),
                                        cards=[str(c) for c in self.cards])


def cards_collective(x, cards, *, reduce: bool,
                     rounds: int = 3) -> CardsCollective:
    """A collective of ``x`` (all-gather: (B, H); reduce-scatter: (P, B,
    H)) across ``cards``, its operands scattered: rank r's block of x (its
    partial) to card r."""
    cards = tuple(torch.device(c) for c in cards)
    P = len(cards)
    B, H = x.shape[-2:]
    tp_cards.enable_peers(cards)
    plan = tp_cards.agreed_plan(cards, lambda c: _card_collective_plan(
        B, H, P, reduce, c.index, 1))
    hl = H // P
    if reduce:
        ins = [x[r:r + 1].contiguous().to(c) for r, c in enumerate(cards)]
        outs = [torch.empty((rounds, B, hl), dtype=torch.float32, device=c)
                for c in cards]
    else:
        ins = [tp_cards.columns(x, P, r).contiguous().to(c)
               for r, c in enumerate(cards)]
        outs = [torch.empty((1, rounds, B, H), dtype=torch.float32,
                            device=c) for c in cards]
    kernel = TP_REDUCE_SCATTER if reduce else TP_ALL_GATHER
    ex = tp_cards.exchange(kernel.name, cards, (2, P, B, hl), torch.float32,
                           P * plan.per_rank * 2)
    return CardsCollective(kernel, cards, plan, ins, outs, ex, B, H, rounds)


def _collective_cards(x, cards, *, reduce: bool, rounds: int):
    run = cards_collective(x, cards, reduce=reduce, rounds=rounds)
    run()
    if reduce:
        return tp_cards.gather_columns(run.outs, x.device)
    return torch.cat([o.to(x.device) for o in run.outs])


def _cards_of(cards) -> Optional[Tuple[torch.device, ...]]:
    """The distinct cards of a mesh across cards (or of a device list);
    None for the one-card form."""
    if cards is None:
        return None
    devs = tuple(cards.cards) if hasattr(cards, "cards") else tuple(
        torch.device(c) for c in cards)
    return devs if len(set(devs)) > 1 else None


def tp_all_gather(x, *, num_devices: int, rounds: int = 3, cards=None):
    """``rounds`` chained all-gathers over the TP axis (JAX
    ``tp_all_gather``); see ``tp_all_gather_plain``. On the card the P
    ranks run in one launch. A CUDA graph may hold the call once it has
    run eagerly on that device: its replays need nothing zeroed between
    them and may run on any stream beside other launches, but not beside
    another replay of the same graph. ``cards`` (a mesh across cards or a
    list of distinct cards): one rank a card, ``x`` and the result on the
    first card."""
    _check_collective(x, num_devices, rounds)
    on = _cards_of(cards)
    if on is not None:
        _check_cards(x, on, num_devices, "TP all-gather")
        return _collective_cards(x, on, reduce=False, rounds=rounds)
    fn = fused_cells._by_device(x, tp_all_gather_plain, _tp_all_gather_cuda,
                                "TP all-gather")
    return fn(x, num_devices=num_devices, rounds=rounds)


def tp_reduce_scatter(parts, *, num_devices: int, rounds: int = 3,
                      cards=None):
    """``rounds`` chained reduce-scatters over the TP axis (JAX
    ``tp_reduce_scatter``); see ``tp_reduce_scatter_plain``. On the card
    and in a CUDA graph, and across ``cards``, as ``tp_all_gather``."""
    _check_collective(parts, num_devices, rounds)
    if parts.shape[0] != num_devices:
        raise ValueError(f"want one partial per rank, got {parts.shape[0]} "
                         f"for {num_devices}")
    on = _cards_of(cards)
    if on is not None:
        _check_cards(parts, on, num_devices, "TP reduce-scatter")
        return _collective_cards(parts, on, reduce=True, rounds=rounds)
    fn = fused_cells._by_device(parts, tp_reduce_scatter_plain,
                                _tp_reduce_scatter_cuda, "TP reduce-scatter")
    return fn(parts, num_devices=num_devices, rounds=rounds)


def _check_cards(x, cards, P: int, what: str) -> None:
    if len(cards) != P:
        raise ValueError(f"{what}: {len(cards)} cards for {P} ranks")
    if any(c.type != "cuda" for c in cards) or x.device != cards[0]:
        raise ValueError(f"{what} across cards: want the tensors on "
                         f"{cards[0]}, the first of {len(cards)} CUDA "
                         f"cards; got {x.device}")
    fused_cells._check("x", x, tuple(x.shape), cards[0])


# ---------------------------------------------------------------------------
# RLIF / RadLIF: plain versions
# ---------------------------------------------------------------------------


def _rank_columns(x_full, M, sl):
    """Each rank's columns of ``x_full @ M``: the kernels sum all rows of
    a rank's column block in one ascending order whatever P is, so the
    plain versions take the whole product once and cut it into blocks."""
    full = torch.matmul(x_full, M)
    return [full[:, c] for c in sl]


def tp_cell_plain(Wx, alpha, beta, a, b, V, threshold, u0, w0, s0, *,
                  num_devices: int, adaptive: bool,
                  save_residuals: bool = False, mxu_bf16: bool = False):
    """Plain version of ``csrc/tp_cell_fwd.cu``: the TPU ``_tp_fwd_kernel``'s
    per-step arithmetic as a loop over T and over the P blocks. Params must
    already be clamped and V zero-diagonal. Each rank's first product is
    its columns of ``s0 @ V`` summed over k ascending (s0 need not be 0/1);
    every later product ``s_full @ V[:, shard]`` has 0/1 spikes on the left.
    Returns the spikes (B, T, H), and with ``save_residuals`` also the
    membrane series.

    ``mxu_bf16``: the spikes come back bf16, V is rounded to bf16, ``Wx``
    (float32 or bf16) is promoted on load and the gathered s0 is rounded
    for the first product only; the membrane series and the state stay
    float32."""
    T = Wx.shape[1]
    work = _work_dtype(Wx)
    sl = _shards(Wx.shape[2], num_devices)
    if mxu_bf16:
        V = _rb(V)
    u = [u0[:, c] for c in sl]
    s = [s0[:, c] for c in sl]
    w = [w0[:, c] for c in sl] if adaptive else None
    first = fused_cells._first_product(_rb(s0) if mxu_bf16 else s0, V)
    sV = [first[:, c] for c in sl]
    out = torch.empty(Wx.shape, dtype=_stream_dtype(mxu_bf16, Wx),
                      device=Wx.device)
    u_seq = torch.empty(Wx.shape, dtype=work, device=Wx.device) \
        if save_residuals else None
    for t in range(T):
        for r, c in enumerate(sl):
            drive = Wx[:, t, c].to(work) + sV[r]
            if adaptive:
                w[r] = beta[c] * w[r] + a[c] * u[r] + b[c] * s[r]
                drive = drive - w[r]
            u[r] = alpha[c] * (u[r] - s[r]) + (1.0 - alpha[c]) * drive
            s[r] = (u[r] > threshold).to(u[r].dtype)
            out[:, t, c] = s[r]
            if save_residuals:
                u_seq[:, t, c] = u[r]
        if t + 1 < T:  # the gather of the last step feeds nothing
            sV = _rank_columns(torch.cat(s, dim=1), V, sl)
    return (out, u_seq) if save_residuals else out


def tp_cell_bwd_plain(g, u_seq, alpha, beta, a, b, V, threshold, u0, w0, s0,
                      *, num_devices: int, adaptive: bool,
                      mxu_bf16: bool = False):
    """Plain version of ``csrc/tp_cell_bwd.cu``: the TPU ``_tp_bwd_kernel``'s
    adjoint recurrence as a loop over reversed T and over the P blocks. Per
    step each rank computes D = (1-alpha)*A on its block, the blocks are
    gathered into D_full, and rank r's recurrent term for the step before
    is ``D_full @ V[shard_r, :]^T``; dbeta without the w series and dV
    after the loop, as ``fused_cells.fused_cell_bwd_plain`` takes them.
    Returns (dWx, dV, dalpha, dbeta, da, db, du0, dw0, ds0), None where
    RLIF has no such operand.

    ``mxu_bf16``: ``g`` arrives bf16 and is read up to float32, V is
    rounded to bf16, and D is rounded to bf16 where it is gathered (the
    bf16 wire): ``dWx`` is that value as a bf16 stream, and both the
    recurrent product and ``dV`` (whose other operand, ``s_{t-1}``, is
    rounded too: ``s0`` need not be 0/1) take it; B_t, the adjoints and
    every reduced gradient take the float32 D."""
    T = g.shape[1]
    work = _work_dtype(u_seq)
    sl = _shards(g.shape[2], num_devices)
    if mxu_bf16:
        V = _rb(V)
    zero = [torch.zeros_like(u0[:, c]) for c in sl]
    A, Bw, Pq, R = list(zero), list(zero), list(zero), list(zero)
    dal, dbe, daa, dbb = list(zero), list(zero), list(zero), list(zero)
    dWx = torch.empty(g.shape, dtype=_stream_dtype(mxu_bf16, u_seq),
                      device=g.device)
    for t in range(T - 1, -1, -1):
        dd = []
        for r, c in enumerate(sl):
            al = alpha[c]
            u_t = u_seq[:, t, c]
            u_p = u_seq[:, t - 1, c] if t > 0 else u0[:, c]
            s_p = (u_p > threshold).to(u_p.dtype) if t > 0 else s0[:, c]
            alphaA = al * A[r]
            C = g[:, t, c].to(work) - alphaA + R[r]
            if adaptive:
                C = C + b[c] * Bw[r]
            wsub = u_t - threshold
            window = (wsub > -0.5) & (wsub <= 0.5)
            A_new = torch.where(window, C, torch.zeros_like(C)) + alphaA
            if adaptive:
                A_new = A_new + a[c] * Bw[r]
            d = (1.0 - al) * A_new
            dal[r] = dal[r] + A_new * (u_p - s_p - u_t)
            if adaptive:
                B_new = beta[c] * Bw[r] - d
                dbe[r] = dbe[r] + (a[c] * u_p + b[c] * s_p) * Pq[r]
                Pq[r] = B_new + beta[c] * Pq[r]
                daa[r] = daa[r] + B_new * u_p
                dbb[r] = dbb[r] + B_new * s_p
                Bw[r] = B_new
            A[r] = A_new
            dd.append(d)
        # the gathered D, as the wire carries it
        D_full = torch.cat(dd, dim=1)
        if mxu_bf16:
            D_full = _rb(D_full)
        dWx[:, t] = D_full
        R = _rank_columns(D_full, V.t(), sl)

    def cat(xs):
        return torch.cat(xs, dim=-1)

    dalpha = cat([x.sum(0) for x in dal]) / (1.0 - alpha)
    du0 = cat([alpha[c] * A[r] for r, c in enumerate(sl)])
    ds0 = cat([-(alpha[c] * A[r]) + R[r] for r, c in enumerate(sl)])
    dbeta = da = db = dw0 = None
    if adaptive:
        du0 = du0 + cat([a[c] * Bw[r] for r, c in enumerate(sl)])
        ds0 = ds0 + cat([b[c] * Bw[r] for r, c in enumerate(sl)])
        dw0 = cat([beta[c] * Bw[r] for r, c in enumerate(sl)])
        dbeta = cat([(dbe[r] + w0[:, c] * Pq[r]).sum(0)
                     for r, c in enumerate(sl)])
        da = cat([x.sum(0) for x in daa])
        db = cat([x.sum(0) for x in dbb])
    H = g.shape[2]
    s_prev = torch.cat([(_rb(s0) if mxu_bf16 else s0)[:, None],
                        (u_seq[:, :-1] > threshold).to(work)], dim=1)
    dV = torch.matmul(s_prev.reshape(-1, H).t(), dWx.reshape(-1, H).to(work))
    return dWx, dV, dalpha, dbeta, da, db, du0, dw0, ds0


def _own_columns(x_full, M_r, r: int, P: int, transposed: bool = False):
    """Rank r's columns of ``x_full @ M``, from its block ``M_r`` alone
    (``transposed``: of ``x_full @ V^T`` from its rows of V): the product
    at the full width, zero past the rank's block, so that it has the
    one-card plain version's shapes and layouts and its columns take the
    same sums."""
    if transposed:
        hl = M_r.shape[0]
        M = M_r.new_zeros((hl * P, M_r.shape[1]))
        M[r * hl:(r + 1) * hl] = M_r
        M = M.t()
    else:
        hl = M_r.shape[1]
        M = M_r.new_zeros((M_r.shape[0], hl * P))
        M[:, r * hl:(r + 1) * hl] = M_r
    return tp_cards.columns(torch.matmul(x_full, M), P, r)


def _scatter(P: int, cards, blocks=(), whole=()):
    """Rank r's operands on ``cards[r]``: its column blocks of
    ``blocks`` (None stays None) and the whole of ``whole``."""
    def put(t, r, cut):
        if t is None:
            return None
        part = tp_cards.columns(t, P, r) if cut else t
        return part.contiguous().to(cards[r])

    return [([put(t, r, True) for t in blocks],
             [put(t, r, False) for t in whole]) for r in range(P)]


def tp_cell_cards_plain(Wx, alpha, beta, a, b, V, threshold, u0, w0, s0, *,
                        num_devices: int, adaptive: bool,
                        save_residuals: bool = False,
                        mxu_bf16: bool = False):
    """``tp_cell_plain`` as the form across cards computes it, rank by
    rank: rank r holds its column blocks of Wx, the constants, V and the
    states, and the full s0; each step it takes the spikes every rank sent
    it. Same contract and bits as ``tp_cell_plain``."""
    P = num_devices
    B, T, H = Wx.shape
    work = _work_dtype(Wx)
    ranks = _scatter(P, [Wx.device] * P,
                     (Wx, alpha, beta, a, b, _rb(V) if mxu_bf16 else V, u0,
                      w0), (s0,))
    state, out, u_out = [], [], []
    for (wx, al, be, aa, bb, v, u, w), (s_full,) in ranks:
        # fused_cells._first_product on the rank's columns
        first = torch.zeros((B, v.shape[1]), dtype=s_full.dtype)
        for k in range(H):
            first = first + (_rb(s_full) if mxu_bf16 else s_full)[:, k:k + 1] \
                * v[k]
        state.append([u, w, tp_cards.columns(s_full, P, len(state)), first])
        out.append(torch.empty(wx.shape, dtype=_stream_dtype(mxu_bf16, Wx)))
        u_out.append(torch.empty(wx.shape, dtype=work))
    for t in range(T):
        for r, ((wx, al, be, aa, bb, _, _, _), _) in enumerate(ranks):
            u, w, s, sV = state[r]
            drive = wx[:, t].to(work) + sV
            if adaptive:
                w = be * w + aa * u + bb * s
                drive = drive - w
            u = al * (u - s) + (1.0 - al) * drive
            s = (u > threshold).to(u.dtype)
            out[r][:, t] = s
            u_out[r][:, t] = u
            state[r][:3] = [u, w, s]
        if t + 1 < T:  # every rank receives every rank's spikes
            s_full = torch.cat([st[2] for st in state], dim=1)
            for r, ((_, _, _, _, _, v, _, _), _) in enumerate(ranks):
                state[r][3] = _own_columns(s_full, v, r, P)
    spikes = tp_cards.gather_columns(out, Wx.device)
    if save_residuals:
        return spikes, tp_cards.gather_columns(u_out, Wx.device)
    return spikes


def tp_cell_bwd_cards_plain(g, u_seq, alpha, beta, a, b, V, threshold, u0,
                            w0, s0, *, num_devices: int, adaptive: bool,
                            mxu_bf16: bool = False):
    """``tp_cell_bwd_plain`` as the form across cards computes it, rank
    by rank: rank r holds its column blocks of g, u_seq, the constants,
    V^T (V's rows of its neurons) and the states, and the full s0; each
    step it takes the adjoint blocks every rank sent it; its dV block is
    the product of the full u series, gathered onto it, and its own D
    series. Same contract and bits as ``tp_cell_bwd_plain``."""
    P = num_devices
    B, T, H = g.shape
    work = _work_dtype(u_seq)
    VT = (_rb(V) if mxu_bf16 else V).t()
    home = g.device
    ranks = _scatter(P, [home] * P,
                     (g, u_seq, alpha, beta, a, b, VT, u0, w0), (s0,))
    zero = torch.zeros((B, H // P), dtype=work)
    st = [dict(A=zero, Bw=zero, Pq=zero, R=zero, dal=zero, dbe=zero,
               daa=zero, dbb=zero) for _ in range(P)]
    dWx = [torch.empty((B, T, H // P), dtype=_stream_dtype(mxu_bf16, u_seq))
           for _ in range(P)]
    for t in range(T - 1, -1, -1):
        dd = []
        for r, ((gr, ur, al, be, aa, bb, _, u0r, _), (s_full,)) in \
                enumerate(ranks):
            x = st[r]
            u_t = ur[:, t]
            u_p = ur[:, t - 1] if t > 0 else u0r
            s_p = (u_p > threshold).to(u_p.dtype) if t > 0 \
                else tp_cards.columns(s_full, P, r)
            alphaA = al * x["A"]
            C = gr[:, t].to(work) - alphaA + x["R"]
            if adaptive:
                C = C + bb * x["Bw"]
            wsub = u_t - threshold
            window = (wsub > -0.5) & (wsub <= 0.5)
            A_new = torch.where(window, C, torch.zeros_like(C)) + alphaA
            if adaptive:
                A_new = A_new + aa * x["Bw"]
            d = (1.0 - al) * A_new
            x["dal"] = x["dal"] + A_new * (u_p - s_p - u_t)
            if adaptive:
                B_new = be * x["Bw"] - d
                x["dbe"] = x["dbe"] + (aa * u_p + bb * s_p) * x["Pq"]
                x["Pq"] = B_new + be * x["Pq"]
                x["daa"] = x["daa"] + B_new * u_p
                x["dbb"] = x["dbb"] + B_new * s_p
                x["Bw"] = B_new
            x["A"] = A_new
            dd.append(d)
        # every rank receives every rank's D, as the wire carries it
        D_full = torch.cat(dd, dim=1)
        if mxu_bf16:
            D_full = _rb(D_full)
        for r, ((_, _, _, _, _, _, vt, _, _), _) in enumerate(ranks):
            dWx[r][:, t] = tp_cards.columns(D_full, P, r)
            st[r]["R"] = _own_columns(D_full, vt.t(), r, P, transposed=True)
    # dV: each rank's block from the full u series, gathered onto it
    u_full = tp_cards.gather_columns([rk[0][1] for rk in ranks], home)
    out = {k: [] for k in ("dV", "dalpha", "du0", "ds0", "dw0", "dbeta",
                           "da", "db")}
    for r, ((_, _, al, be, aa, bb, _, _, w0r), (s_full,)) in \
            enumerate(ranks):
        x = st[r]
        s_prev = torch.cat([(_rb(s_full) if mxu_bf16 else s_full)[:, None],
                            (u_full[:, :-1] > threshold).to(work)], dim=1)
        D_r = u_full.new_zeros((B, T, H)).to(work)
        D_r[..., r * (H // P):(r + 1) * (H // P)] = dWx[r].to(work)
        out["dV"].append(tp_cards.columns(torch.matmul(
            s_prev.reshape(-1, H).t(), D_r.reshape(-1, H)), P, r))
        out["dalpha"].append(x["dal"].sum(0) / (1.0 - al))
        du0 = al * x["A"]
        ds0 = -(al * x["A"]) + x["R"]
        if adaptive:
            du0 = du0 + aa * x["Bw"]
            ds0 = ds0 + bb * x["Bw"]
            out["dw0"].append(be * x["Bw"])
            out["dbeta"].append((x["dbe"] + w0r * x["Pq"]).sum(0))
            out["da"].append(x["daa"].sum(0))
            out["db"].append(x["dbb"].sum(0))
        out["du0"].append(du0)
        out["ds0"].append(ds0)

    def cat(k):
        return tp_cards.gather_columns(out[k], home) if out[k] else None

    return (tp_cards.gather_columns(dWx, home), cat("dV"), cat("dalpha"),
            cat("dbeta"), cat("da"), cat("db"), cat("du0"), cat("dw0"),
            cat("ds0"))


# ---------------------------------------------------------------------------
# RLIF / RadLIF: kernels
# ---------------------------------------------------------------------------


def _check_cell(Wx, alpha, beta, a, b, V, u0, w0, s0, adaptive, P):
    B, T, H = Wx.shape
    dev = Wx.device
    _validate(H, P)
    if H // P > _MAX_HL:
        raise ValueError(f"the TP cell kernels take H/P <= {_MAX_HL}, got "
                         f"{H // P}")
    vecs = {"alpha": alpha, **({"beta": beta, "a": a, "b": b}
                               if adaptive else {})}
    for name, t in vecs.items():
        fused_cells._check(name, t, (H,), dev)
    states = {"u0": u0, "s0": s0, **({"w0": w0} if adaptive else {})}
    for name, t in states.items():
        fused_cells._check(name, t, (B, H), dev)
    fused_cells._check("V", V, (H, H), dev)


def _tp_cell_cuda(Wx, alpha, beta, a, b, V, threshold, u0, w0, s0, *,
                  num_devices: int, adaptive: bool,
                  save_residuals: bool = False, mxu_bf16: bool = False,
                  split_ms=None):
    """Launch ``csrc/tp_cell_fwd.cu`` over all P ranks (the one-card form)
    in the float32 or the bf16 stream mode, in the column-slice layout
    where ``fused_cells._fwd_plan`` finds one (else a block a batch row and
    rank). Same contract as ``tp_cell_plain``. ``split_ms``: as
    ``fused_cells._fused_cell_cuda`` takes it."""
    B, T, H = Wx.shape
    P, dev = num_devices, Wx.device
    fused_cells._check("Wx", Wx, (B, T, H), dev, _wx_dtypes(mxu_bf16))
    _check_cell(Wx, alpha, beta, a, b, V, u0, w0, s0, adaptive, P)
    out = torch.empty(Wx.shape, dtype=_stream_dtype(mxu_bf16, Wx),
                      device=dev)
    u_seq = torch.empty(Wx.shape, dtype=torch.float32, device=dev) \
        if save_residuals else None
    if not adaptive:
        beta = a = b = w0 = None
    if mxu_bf16:
        V = V.to(_BF16)  # rounded once, as the JAX wrapper does
    ptr = fused_cells._ptr
    with torch.cuda.device(dev):
        plan = fused_cells.card_plan(
            "tp_cell_fwd", (int(adaptive), int(save_residuals),
                            int(mxu_bf16)), B, H, P, mxu_bf16,
            torch.cuda.current_device())
    tail, split = (None,) * 3, None
    if plan is not None:
        # the tagged spike words, no counters
        bufs = _slice_slots(B, H, P, dev)
        peers = (ctypes.cast(bufs[1], ctypes.c_void_p), None)
        plan_arr, sv0 = fused_cells._slice_launch_args(plan, B, H, dev)
        split = (ctypes.c_float * 2)() if split_ms is not None else None
        tail = (ctypes.cast(plan_arr, ctypes.c_void_p), ptr(sv0),
                ctypes.cast(split, ctypes.c_void_p) if split else None)
    elif split_ms is not None:
        raise ValueError("split_ms: the slice layout only")
    else:
        # the spike words (u32) and zeroed counters of a block a row
        bufs = _exchange_buffers((2, B, H // 32), torch.int32, P, B, dev)
        peers = bufs[2:4]
    rows = _launch(TP_CELL_FWD_BF16 if mxu_bf16 else TP_CELL_FWD, dev,
                   ptr(Wx), ptr(alpha), ptr(beta), ptr(a), ptr(b), ptr(V),
                   ptr(u0), ptr(w0), ptr(s0), ptr(out), ptr(u_seq), *peers,
                   B, T, H, P, 0, P, H, float(threshold),
                   int(adaptive), int(mxu_bf16), int(Wx.dtype == _BF16),
                   *tail, n_plan=4)
    _PLANS["tp_cell_fwd"] = (plan if plan is not None else
                             fused_cells._rows_plan(B, H, P, rows[3], rows[1],
                                                    rows[2]))._asdict()
    if split is not None:
        split_ms[:] = list(split)
    return (out, u_seq) if save_residuals else out


def _bwd_rows(H: int) -> int:
    """Rows of a cluster of the backward's time loop: the most of 8, 4, 2,
    1 whose two parities of gathered rows (H floats each) take at most
    128 KB."""
    rows = 8
    while rows > 1 and 2 * rows * H * 4 > _OPERAND_BYTES:
        rows //= 2
    return rows


def _bwd_rank_plan(B: int, H: int, P: int, mxu_bf16: bool,
                   cluster: Optional[int] = None):
    """One rank's plan of the backward's time loop at ``cluster`` blocks
    (None: the most, up to 6, that leave each slice 32 columns;
    ``cell_plan`` of ``csrc/tp_cell_bwd.cu``): ``csrc/cluster_slice.cuh``'s
    rule for one matrix (the rank's block of V^T) and one operand plane (the
    gathered D) with ``_bwd_rows(H)`` rows a cluster and one thread a column
    (it owns every row of the cluster)."""
    from sparch_tpu_torch.ops import fused_ann

    q = fused_ann._cluster_plan(B, H, 1, mxu_bf16, 1, width=H // P,
                                cluster=cluster, rows=_bwd_rows(H))
    return q._replace(threads=-(-q.cols // 32) * 32)


def _bwd_part_rows(B: int, H: int, P: int, sms: int) -> int:
    """Rows of a partial of dalpha, dbeta, da and db: those of a block of
    the backward before the cluster split (one block for BT rows of a rank,
    one block an SM on a card of ``sms`` SMs), so that these gradients keep
    its bits wherever its blocks held every row group of every rank at
    once. Its plan took the fewest of 1, 2, 4, 8 rows a block (its neurons a
    thread times rows at most 16, its shared memory allowing) at which the
    card held every group of every rank, else the most rows at work."""
    hl = H // P
    npt = 1
    while hl // npt > _SPLIT_THREADS:
        npt *= 2
    best = best_rows = 0
    for bt in (1, 2, 4, 8):
        smem = -(-H * bt // 4) * 16 + _SPLIT_STAGE_BYTES
        if npt * bt > _SPLIT_WORK or smem > _SPLIT_SMEM:
            continue
        groups = -(-B // bt)
        per_rank = min(sms // P, groups)
        if per_rank < 1:
            continue
        if per_rank * bt > best_rows:
            best, best_rows = bt, per_rank * bt
        if per_rank == groups:
            break
    return best or 1


@functools.lru_cache(maxsize=None)
def _bwd_max_active(B: int, H: int, P: int, adaptive: bool, mxu_bf16: bool,
                    cluster: int, part_rows: int,
                    device_index: Optional[int] = None) -> int:
    """How many clusters of ``cluster`` blocks of the backward's plan the
    card ``device_index`` (None: the current card) holds at once
    (``cudaOccupancyMaxActiveClusters``); -1 where that plan does not run
    or the query fails."""
    from sparch_tpu_torch import _build

    fn = getattr(_build.load("tp_cell_bwd"), "sparch_tp_cell_bwd_max_clusters")
    fn.argtypes = [_I] * 7
    fn.restype = _I
    with torch.cuda.device(device_index):
        return fn(B, H, P, int(adaptive), int(mxu_bf16), cluster, part_rows)


def _bwd_plan(B: int, H: int, P: int, mxu_bf16: bool,
              max_active: Callable[[int], int],
              n_local: Optional[int] = None):
    """The backward's launch plan (``fused_tp_ann.TPPlan``): the cluster
    size by ``fused_tp_ann.choose_plan``'s rule over what the card holds
    for its ``n_local`` ranks (default P, the one-card form; 1 across
    cards)."""
    from sparch_tpu_torch.ops import fused_tp_ann

    return fused_tp_ann.choose_plan(
        lambda c: _bwd_rank_plan(B, H, P, mxu_bf16, c),
        lambda q: fused_tp_ann._runs(q, 1, mxu_bf16),
        P if n_local is None else n_local, max_active,
        f"the TP cell backward takes no H={H} over {P} ranks")


def _tp_cell_bwd_cuda(g, u_seq, alpha, beta, a, b, V, threshold, u0, w0, s0,
                      *, num_devices: int, adaptive: bool,
                      mxu_bf16: bool = False, split_ms=None):
    """Launch ``csrc/tp_cell_bwd.cu`` over all P ranks (the one-card form)
    in the float32 or the bf16 stream mode. Same contract as
    ``tp_cell_bwd_plain``. ``split_ms``: as ``fused_cells``'
    ``_fused_cell_bwd_cuda`` takes it."""
    from sparch_tpu_torch.ops import fused_ann, fused_tp_ann

    B, T, H = g.shape
    P, dev = num_devices, g.device
    sdt = _BF16 if mxu_bf16 else torch.float32
    fused_cells._check("g", g, (B, T, H), dev, sdt)
    fused_cells._check("u_seq", u_seq, (B, T, H), dev)
    _check_cell(g, alpha, beta, a, b, V, u0, w0, s0, adaptive, P)
    part_rows = _bwd_part_rows(
        B, H, P, torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        plan = _bwd_plan(B, H, P, mxu_bf16, lambda c: _bwd_max_active(
            B, H, P, adaptive, mxu_bf16, c, part_rows)).rank
    # every block's slice of rank r's block of V^T (V[shard_r, :]^T)
    VT = fused_tp_ann._pack_slices([V], ((0,),), plan, P, mxu_bf16,
                                   transpose=True)
    ksplit = fused_ann._dv_split(B, T, H, 1)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dWx = torch.empty_like(g)
    partials, vecs = new(P, -(-B // part_rows), 4, H // P), new(4, H)
    dV = new(H, H)
    dv_partials = new(ksplit, H, H) if ksplit > 1 else None
    du0, ds0 = new(B, H), new(B, H)
    dw0 = new(B, H) if adaptive else None
    if not adaptive:
        beta = a = b = w0 = None
    ptr = fused_cells._ptr
    bufs = _exchange_buffers((2, B, H), sdt, P, plan.clusters, dev)
    split = (ctypes.c_float * 3)() if split_ms is not None else None
    _launch(TP_CELL_BWD_BF16 if mxu_bf16 else TP_CELL_BWD, dev, ptr(g),
            ptr(u_seq), None, ptr(alpha), ptr(beta), ptr(a), ptr(b), ptr(VT),
            ptr(u0), ptr(w0), ptr(s0), ptr(dWx), ptr(partials), ptr(vecs),
            ptr(dV), ptr(dv_partials), ptr(du0), ptr(dw0), ptr(ds0),
            bufs[2], bufs[3], B, T, H, P, 0, P, H, float(threshold),
            int(adaptive), ksplit, fused_ann._card_dv_tile(H, 1, ksplit, dev),
            int(mxu_bf16), plan.cluster, plan.rows,
            int(plan.resident), part_rows, split,
            n_plan=len(fused_tp_ann._PLAN_KEYS))
    _PLANS["tp_cell_bwd"] += (part_rows,)
    if split is not None:
        split_ms[:] = list(split)
    dalpha, dbeta, da, db = vecs.unbind(0)
    if not adaptive:
        dbeta = da = db = None
    return dWx, dV, dalpha, dbeta, da, db, du0, dw0, ds0


def _row_blocks(adaptive: bool, resid: bool, mxu_bf16: bool, H: int,
                P: int, device_index: int) -> int:
    """Blocks of the forward's layout of a block a row an SM of the card
    holds (``sparch_tp_cell_fwd_row_blocks``)."""
    from sparch_tpu_torch import _build

    fn = _build.load("tp_cell_fwd").sparch_tp_cell_fwd_row_blocks
    fn.argtypes = [_I] * 5
    fn.restype = _I
    with torch.cuda.device(device_index):
        return fn(int(adaptive), int(resid), int(mxu_bf16), H, P)


def _cards_fwd_plan(B, H, P, adaptive, resid, mxu_bf16, card):
    """One card's plan of the forward across cards (one rank a card):
    the column-slice plan, else the layout of a block a row (blocks a
    rank, blocks an SM)."""
    plan = fused_cells.card_plan(
        "tp_cell_fwd", (int(adaptive), int(resid), int(mxu_bf16)), B, H, P,
        mxu_bf16, card.index, 1)
    if plan is not None:
        return plan
    per_sm = _row_blocks(adaptive, resid, mxu_bf16, H, P, card.index)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    return ("rows", min(B, per_sm * sms), per_sm)


def _tp_cell_cards(Wx, alpha, beta, a, b, V, threshold, u0, w0, s0, *,
                   cards, adaptive: bool, save_residuals: bool = False,
                   mxu_bf16: bool = False):
    """``csrc/tp_cell_fwd.cu`` across ``cards``, one rank a card: the
    operands (full, on the first card) scattered by rank, one launch a card
    behind the entry barrier (``ops/tp_cards.py``), the spikes gathered.
    Returns the spikes, and with ``save_residuals`` also each rank's
    membrane series on its card (the backward's residuals)."""
    B, T, H = Wx.shape
    P, home = len(cards), cards[0]
    hl = H // P
    fused_cells._check("Wx", Wx, (B, T, H), home, _wx_dtypes(mxu_bf16))
    _check_cell(Wx, alpha, beta, a, b, V, u0, w0, s0, adaptive, P)
    if not adaptive:
        beta = a = b = w0 = None
    if mxu_bf16:
        V = V.to(_BF16)  # rounded once, as the JAX wrapper does
    tp_cards.enable_peers(cards)
    plan = tp_cards.agreed_plan(cards, lambda c: _cards_fwd_plan(
        B, H, P, adaptive, save_residuals, mxu_bf16, c))
    slices = isinstance(plan, fused_cells.FwdPlan)
    if slices:  # tagged spike words, no counters
        ex = tp_cards.exchange("tp_cell_fwd_slices", cards, (2, B, H // 32),
                               torch.int64, 0)
    else:  # spike words and the counters of a block a row
        ex = tp_cards.exchange("tp_cell_fwd_rows", cards, (2, B, H // 32),
                               torch.int32, P * B * 2)
    ranks = _scatter(P, cards, (Wx, alpha, beta, a, b, V, u0, w0), (s0,))
    ptr = fused_cells._ptr
    outs, us, tails = [], [], []
    for r, card in enumerate(cards):
        outs.append(torch.empty((B, T, hl), dtype=_stream_dtype(mxu_bf16, Wx),
                                device=card))
        us.append(torch.empty((B, T, hl), dtype=torch.float32, device=card)
                  if save_residuals else None)
        if slices:
            plan_arr, sv0 = fused_cells._slice_launch_args(plan, B, hl, card)
            tails.append((ctypes.cast(plan_arr, ctypes.c_void_p), ptr(sv0),
                          None, plan_arr, sv0))
        else:
            tails.append((None,) * 3)
    streams = ex.enter(zero_slots=slices)
    reported = []
    for r, card in enumerate(cards):
        (wx, al, be, aa, bb, v, u0r, w0r), (s0r,) = ranks[r]
        reported.append(_launch(
            TP_CELL_FWD_BF16 if mxu_bf16 else TP_CELL_FWD, card, ptr(wx),
            ptr(al), ptr(be), ptr(aa), ptr(bb), ptr(v), ptr(u0r), ptr(w0r),
            ptr(s0r), ptr(outs[r]), ptr(us[r]), ex.slot_ptrs, ex.flag_ptrs,
            B, T, H, P, r, 1, hl, float(threshold), int(adaptive),
            int(mxu_bf16), int(Wx.dtype == _BF16), *tails[r][:3], n_plan=4))
    ex.leave(streams)
    if slices:
        _PLANS["tp_cell_fwd"] = dict(plan._asdict(), cards=P)
    else:
        row_plan = fused_cells._rows_plan(B, H, P, reported[0][3], plan[1],
                                          plan[2])
        if any(rep[1:3] != (plan[1], plan[2]) for rep in reported):
            raise tp_cards.PlanDisagreement(
                f"tp_cell_fwd across cards launched {reported}, agreed "
                f"on {plan}")
        _PLANS["tp_cell_fwd"] = dict(row_plan._asdict(), cards=P)
    out = tp_cards.gather_columns(outs, home)
    return (out, us) if save_residuals else out


def _tp_cell_bwd_cards(g, u_blocks, alpha, beta, a, b, V, threshold, u0, w0,
                       s0, *, cards, adaptive: bool, mxu_bf16: bool = False):
    """``csrc/tp_cell_bwd.cu`` across ``cards``, one rank a card: ``g``
    and the operands (on the first card) scattered by rank, ``u_blocks``
    each rank's membrane series on its card (from ``_tp_cell_cards``),
    gathered whole onto every card for the rank's dV block; one launch a
    card behind the entry barrier; the gradients gathered. Same contract
    as ``tp_cell_bwd_plain`` otherwise, and its one-card form's bits."""
    from sparch_tpu_torch.ops import fused_ann, fused_tp_ann

    B, T, H = g.shape
    P, home = len(cards), cards[0]
    hl = H // P
    sdt = _BF16 if mxu_bf16 else torch.float32
    fused_cells._check("g", g, (B, T, H), home, sdt)
    for r, (u, card) in enumerate(zip(u_blocks, cards)):
        fused_cells._check(f"u_seq[{r}]", u, (B, T, hl), card)
    _check_cell(g, alpha, beta, a, b, V, u0, w0, s0, adaptive, P)
    tp_cards.enable_peers(cards)
    # the one-card form's rows of a partial at this P keep its bits
    part_rows = _bwd_part_rows(
        B, H, P, torch.cuda.get_device_properties(home).multi_processor_count)
    plan = tp_cards.agreed_plan(cards, lambda c: _bwd_plan(
        B, H, P, mxu_bf16, lambda cl: _bwd_max_active(
            B, H, P, adaptive, mxu_bf16, cl, part_rows, c.index), 1)).rank
    VT = fused_tp_ann._pack_slices([V], ((0,),), plan, P, mxu_bf16,
                                   transpose=True)
    ksplit = fused_ann._dv_split(B, T, H, 1)
    if not adaptive:
        beta = a = b = w0 = None
    ranks = _scatter(P, cards, (g, alpha, beta, a, b, u0, w0), (s0,))
    u_full = [tp_cards.gather_columns(u_blocks, c) for c in cards]
    vts = [VT[r].to(c) for r, c in enumerate(cards)]
    ex = tp_cards.exchange("tp_cell_bwd", cards, (2, B, H), sdt,
                           P * plan.clusters * 2)
    n_parts = -(-B // part_rows)
    res = []
    for r, card in enumerate(cards):
        def new(*shape):
            return torch.empty(shape, dtype=torch.float32, device=card)

        res.append(dict(
            dWx=torch.empty((B, T, hl), dtype=sdt, device=card),
            partials=new(1, n_parts, 4, hl), vecs=new(4, hl), dV=new(H, hl),
            dv_partials=new(ksplit, H, hl) if ksplit > 1 else None,
            du0=new(B, hl), ds0=new(B, hl),
            dw0=new(B, hl) if adaptive else None,
            tile=fused_ann._card_dv_tile(H, 1, ksplit, card, hl)))
    ptr = fused_cells._ptr
    streams = ex.enter()
    for r, card in enumerate(cards):
        (gr, al, be, aa, bb, u0r, w0r), (s0r,) = ranks[r]
        o = res[r]
        _launch(TP_CELL_BWD_BF16 if mxu_bf16 else TP_CELL_BWD, card,
                ptr(gr), ptr(u_blocks[r]), ptr(u_full[r]), ptr(al), ptr(be),
                ptr(aa), ptr(bb), ptr(vts[r]), ptr(u0r), ptr(w0r), ptr(s0r),
                ptr(o["dWx"]), ptr(o["partials"]), ptr(o["vecs"]),
                ptr(o["dV"]), ptr(o["dv_partials"]), ptr(o["du0"]),
                ptr(o["dw0"]), ptr(o["ds0"]), ex.slot_ptrs, ex.flag_ptrs, B,
                T, H, P, r, 1, hl, float(threshold), int(adaptive), ksplit,
                o["tile"], int(mxu_bf16), plan.cluster, plan.rows,
                int(plan.resident), part_rows, None,
                n_plan=len(fused_tp_ann._PLAN_KEYS))
    ex.leave(streams)
    _PLANS["tp_cell_bwd"] += (part_rows,)

    def cat(k):
        return None if res[0][k] is None else \
            tp_cards.gather_columns([o[k] for o in res], home)

    dalpha, dbeta, da, db = cat("vecs").unbind(0)
    if not adaptive:
        dbeta = da = db = None
    return (cat("dWx"), cat("dV"), dalpha, dbeta, da, db, cat("du0"),
            cat("dw0"), cat("ds0"))


class _TPCell(torch.autograd.Function):
    """The TP cell on clamped and masked operands (JAX ``_get_tp_op``). A
    None operand (RLIF: beta, a, b, w0) gets no gradient. ``cards``: the
    distinct cards of a mesh across cards (the residuals then stay on
    them), None for the one-card form."""

    @staticmethod
    def forward(ctx, Wx, alpha, beta, a, b, V, u0, w0, s0, threshold,
                adaptive, num_devices, mxu_bf16, cards=None):
        if cards is not None:
            fwd = functools.partial(_tp_cell_cards, cards=cards)
            flags = dict(adaptive=adaptive, mxu_bf16=mxu_bf16)
        else:
            fwd = fused_cells._by_device(Wx, tp_cell_plain, _tp_cell_cuda,
                                         "TP cell")
            flags = dict(num_devices=num_devices, adaptive=adaptive,
                         mxu_bf16=mxu_bf16)
        args = (Wx, alpha, beta, a, b, V, threshold, u0, w0, s0)
        if not any(ctx.needs_input_grad):
            return fwd(*args, **flags)
        out, u_seq = fwd(*args, save_residuals=True, **flags)
        ctx.flags = dict(flags, threshold=threshold)
        ctx.cards = cards
        ctx.wx_dtype = Wx.dtype
        u_list = list(u_seq) if cards is not None else [u_seq]
        ctx.save_for_backward(alpha, beta, a, b, V, u0, w0, s0, *u_list)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        alpha, beta, a, b, V, u0, w0, s0, *u_seq = ctx.saved_tensors
        flags = dict(ctx.flags)
        threshold = flags.pop("threshold")
        if ctx.cards is not None:
            bwd = functools.partial(_tp_cell_bwd_cards, cards=ctx.cards)
        else:
            bwd = fused_cells._by_device(g, tp_cell_bwd_plain,
                                         _tp_cell_bwd_cuda,
                                         "TP cell backward")
            (u_seq,) = u_seq
        # the cotangent often arrives as a view (the bidirectional split)
        (dWx, dV, dalpha, dbeta, da, db, du0, dw0,
         ds0) = bwd(g.contiguous(), u_seq, alpha, beta, a, b, V, threshold,
                    u0, w0, s0, **flags)
        # the bf16 mode's dWx stream goes back up where Wx arrived float32
        return (dWx.to(ctx.wx_dtype), dalpha, dbeta, da, db, dV, du0, dw0,
                ds0, None, None, None, None, None)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def zero_diag_shard(Vcol, rank: int):
    """Zero the global diagonal of rank ``rank``'s column block (H, Hl) of V
    (JAX ``zero_diag_shard``): row ``rank*Hl + c`` of column c. A
    differentiable mask, so no gradient reaches the diagonal."""
    Hg, Hl = Vcol.shape
    rows = torch.arange(Hg, device=Vcol.device)[:, None]
    cols = torch.arange(Hl, device=Vcol.device)[None, :] + rank * Hl
    return Vcol * (rows != cols).to(Vcol.dtype)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _tp_size(mesh, tp_axis: str, x) -> int:
    """P, the length of the mesh's TP axis, for a mesh in either form
    whose ``home`` (its one device, or its first card) holds ``x``."""
    if tp_axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {tp_axis!r}: {mesh.shape}")
    if not _same_device(x.device, mesh.home):
        raise ValueError(f"the tensors lie on {x.device}, the mesh on "
                         f"{mesh.home}")
    return mesh.shape[tp_axis]


def mesh_cards(mesh) -> Optional[Tuple[torch.device, ...]]:
    """The cards of a mesh across cards, rank order; None for the
    one-card form."""
    return None if mesh.one_card else tuple(mesh.cards)


def _prepare(Wx, alpha, beta, a, b, V, u0, w0, s0, mesh, tp_axis):
    P = _tp_size(mesh, tp_axis, Wx)
    H = Wx.shape[2]
    _validate(H, P)
    # the state is float32 (float64 with a float64 stream), whatever type it
    # was drawn in
    work = _work_dtype(Wx)
    u0, s0 = u0.to(work), s0.to(work)
    if w0 is not None:
        w0 = w0.to(work)
    alpha, beta, a, b, _ = fused_cells.clip_and_mask(alpha, beta, a, b)
    V = torch.cat([zero_diag_shard(V[:, c], r)
                   for r, c in enumerate(_shards(H, P))], dim=1)
    return P, (alpha, beta, a, b, V, u0, w0, s0)


def rlif_tp(Wx, alpha, V, threshold, u0, s0, *, mesh, tp_axis="model",
            mxu_bf16: bool = False):
    """Tensor-parallel fused RLIF over the mesh's TP axis (JAX
    ``rlif_tp_sharded``; semantics ``cells.rlif_scan``)."""
    P, (alpha, _, _, _, V, u0, _, s0) = _prepare(
        Wx, alpha, None, None, None, V, u0, None, s0, mesh, tp_axis)
    return _TPCell.apply(Wx, alpha, None, None, None, V, u0, None, s0,
                         float(threshold), False, P, bool(mxu_bf16),
                         mesh_cards(mesh))


def radlif_tp(Wx, alpha, beta, a, b, V, threshold, u0, w0, s0, *, mesh,
              tp_axis="model", mxu_bf16: bool = False):
    """Tensor-parallel fused RadLIF over the mesh's TP axis (JAX
    ``radlif_tp_sharded``; semantics ``cells.radlif_scan``)."""
    P, (alpha, beta, a, b, V, u0, w0, s0) = _prepare(
        Wx, alpha, beta, a, b, V, u0, w0, s0, mesh, tp_axis)
    return _TPCell.apply(Wx, alpha, beta, a, b, V, u0, w0, s0,
                         float(threshold), True, P, bool(mxu_bf16),
                         mesh_cards(mesh))


def _per_block(fn, Wx, mesh, tp_axis, vecs, states):
    """``fn`` on each rank's column block, the outputs side by side;
    across cards each block on its rank's card (autograd brings the
    gradients home)."""
    P = _tp_size(mesh, tp_axis, Wx)
    H = Wx.shape[-1]
    if H % P:
        raise ValueError(f"H={H} does not split over {P} ranks")
    cards = mesh_cards(mesh) or (Wx.device,) * P
    outs = []
    for c, card in zip(_shards(H, P), cards):
        with torch.cuda.device(card) if card.type == "cuda" else \
                contextlib.nullcontext():
            outs.append(fn(Wx[..., c].contiguous().to(card),
                           *[v[c].to(card) for v in vecs],
                           *[s[:, c].contiguous().to(card) for s in states]))
    return torch.cat([o.to(Wx.device) for o in outs], dim=-1)


def lif_tp(Wx, alpha, threshold, u0, s0, *, mesh, tp_axis="model",
           mxu_bf16: bool = False):
    """Neuron-sharded LIF (JAX ``lif_tp_sharded``): no recurrence, so no
    exchange; the single-card fused cell runs on each block, in the stream
    mode ``mxu_bf16`` selects."""
    return _per_block(
        lambda x, al, u, s: fused_cells.lif_fused(x, al, threshold, u, s,
                                                  mxu_bf16=mxu_bf16),
        Wx, mesh, tp_axis, (alpha,), (u0, s0))


def adlif_tp(Wx, alpha, beta, a, b, threshold, u0, w0, s0, *, mesh,
             tp_axis="model", mxu_bf16: bool = False):
    """Neuron-sharded adLIF (JAX ``adlif_tp_sharded``)."""
    return _per_block(
        lambda x, al, be, aa, bb, u, w, s: fused_cells.adlif_fused(
            x, al, be, aa, bb, threshold, u, w, s, mxu_bf16=mxu_bf16),
        Wx, mesh, tp_axis, (alpha, beta, a, b), (u0, w0, s0))
