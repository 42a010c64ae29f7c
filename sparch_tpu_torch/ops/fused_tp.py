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

The one-card form: the port runs all P ranks of a mesh that repeats one
device (``parallel.make_mesh([dev] * P, model=P)``) in one cooperative launch
on that device, each rank storing into its peers' buffers in the one card's
memory. The kernels are written against an array of every rank's buffer
base and a rank (``csrc/tp_exchange.cuh``), but no multi-card run has been
made (ROADMAP queue 1 item 7b). In this form the entry points take the full
tensors, as the layer holds them: ``Wx (B, T, H)``, ``V (H, H)``, the states
``(B, H)``; rank r's block is columns ``r*Hl .. (r+1)*Hl`` of each, and the
gathered initial spikes are the full ``s0``.

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

import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from sparch_tpu_torch._build import Kernel
from sparch_tpu_torch.ops import fused_cells
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
    "tp_cell_plain",
    "tp_cell_bwd_plain",
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
_BWD_ARGS = [_P] * 20 + [_I] * 7 + [_F] + [_I] * 8 + [_P] * 3
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
                     per_sm: Callable[[int], int]) -> CollectivePlan:
    """Rows a block and blocks a rank of a collective on a card of ``sms``
    SMs, ``per_sm(smem)`` the blocks an SM holds at ``smem`` bytes: the
    fewest rows that spread the P ranks' groups over about one block an SM,
    at most ``_COLL_MAX_ROWS`` and what shared memory holds; every group at
    once where the card holds them, else the blocks of a rank walk them."""
    if not 1 <= P <= _MAX_RANKS:
        raise ValueError(f"TP collective: 1 to {_MAX_RANKS} ranks, got {P}")
    fit = _COLL_SMEM // _collective_smem(1, H, P, reduce)
    if fit < 1:
        raise ValueError(f"TP collective: a row of H={H} over {P} ranks "
                         f"does not fit in a block's shared memory")
    rows = max(1, min(-(-P * B // sms), _COLL_MAX_ROWS, fit, B))
    groups = -(-B // rows)
    smem = _collective_smem(rows, H, P, reduce)
    held = per_sm(smem)
    per_rank = min(groups, held * sms // P)
    if per_rank < 1:
        raise ValueError(f"TP collective: the card holds {held} blocks of "
                         f"{smem} bytes an SM, too few for {P} ranks")
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
                          device_index: int) -> CollectivePlan:
    """``_collective_plan`` on the card ``device_index``, once a shape."""
    sms = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    return _collective_plan(
        B, H, P, reduce, sms,
        lambda smem: collective_blocks(reduce, smem, device_index))


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


def tp_all_gather(x, *, num_devices: int, rounds: int = 3):
    """``rounds`` chained all-gathers over the TP axis (JAX
    ``tp_all_gather``); see ``tp_all_gather_plain``. On the card the P
    ranks run in one launch. A CUDA graph may hold the call once it has
    run eagerly on that device: its replays need nothing zeroed between
    them and may run on any stream beside other launches, but not beside
    another replay of the same graph."""
    _check_collective(x, num_devices, rounds)
    fn = fused_cells._by_device(x, tp_all_gather_plain, _tp_all_gather_cuda,
                                "TP all-gather")
    return fn(x, num_devices=num_devices, rounds=rounds)


def tp_reduce_scatter(parts, *, num_devices: int, rounds: int = 3):
    """``rounds`` chained reduce-scatters over the TP axis (JAX
    ``tp_reduce_scatter``); see ``tp_reduce_scatter_plain``. On the card
    and in a CUDA graph as ``tp_all_gather``."""
    _check_collective(parts, num_devices, rounds)
    if parts.shape[0] != num_devices:
        raise ValueError(f"want one partial per rank, got {parts.shape[0]} "
                         f"for {num_devices}")
    fn = fused_cells._by_device(parts, tp_reduce_scatter_plain,
                                _tp_reduce_scatter_cuda, "TP reduce-scatter")
    return fn(parts, num_devices=num_devices, rounds=rounds)


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
                    cluster: int, part_rows: int) -> int:
    """How many clusters of ``cluster`` blocks of the backward's plan the
    current card holds at once (``cudaOccupancyMaxActiveClusters``); -1
    where that plan does not run or the query fails."""
    from sparch_tpu_torch import _build

    fn = getattr(_build.load("tp_cell_bwd"), "sparch_tp_cell_bwd_max_clusters")
    fn.argtypes = [_I] * 7
    fn.restype = _I
    return fn(B, H, P, int(adaptive), int(mxu_bf16), cluster, part_rows)


def _bwd_plan(B: int, H: int, P: int, mxu_bf16: bool,
              max_active: Callable[[int], int]):
    """The backward's launch plan (``fused_tp_ann.TPPlan``): the cluster
    size by ``fused_tp_ann.choose_plan``'s rule over what the card holds."""
    from sparch_tpu_torch.ops import fused_tp_ann

    return fused_tp_ann.choose_plan(
        lambda c: _bwd_rank_plan(B, H, P, mxu_bf16, c),
        lambda q: fused_tp_ann._runs(q, 1, mxu_bf16), P, max_active,
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
            ptr(u_seq), ptr(alpha), ptr(beta), ptr(a), ptr(b), ptr(VT),
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


class _TPCell(torch.autograd.Function):
    """The TP cell on clamped and masked operands (JAX ``_get_tp_op``). A
    None operand (RLIF: beta, a, b, w0) gets no gradient."""

    @staticmethod
    def forward(ctx, Wx, alpha, beta, a, b, V, u0, w0, s0, threshold,
                adaptive, num_devices, mxu_bf16):
        fwd = fused_cells._by_device(Wx, tp_cell_plain, _tp_cell_cuda,
                                     "TP cell")
        flags = dict(num_devices=num_devices, adaptive=adaptive,
                     mxu_bf16=mxu_bf16)
        args = (Wx, alpha, beta, a, b, V, threshold, u0, w0, s0)
        if not any(ctx.needs_input_grad):
            return fwd(*args, **flags)
        out, u_seq = fwd(*args, save_residuals=True, **flags)
        ctx.flags = dict(flags, threshold=threshold)
        ctx.wx_dtype = Wx.dtype
        ctx.save_for_backward(u_seq, alpha, beta, a, b, V, u0, w0, s0)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u_seq, alpha, beta, a, b, V, u0, w0, s0 = ctx.saved_tensors
        flags = dict(ctx.flags)
        threshold = flags.pop("threshold")
        bwd = fused_cells._by_device(g, tp_cell_bwd_plain, _tp_cell_bwd_cuda,
                                     "TP cell backward")
        # the cotangent often arrives as a view (the bidirectional split)
        (dWx, dV, dalpha, dbeta, da, db, du0, dw0,
         ds0) = bwd(g.contiguous(), u_seq, alpha, beta, a, b, V, threshold,
                    u0, w0, s0, **flags)
        # the bf16 mode's dWx stream goes back up where Wx arrived float32
        return (dWx.to(ctx.wx_dtype), dalpha, dbeta, da, db, dV, du0, dw0,
                ds0, None, None, None, None)


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
    """P, the length of the mesh's TP axis, for a one-card mesh on the
    device of ``x``."""
    if tp_axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {tp_axis!r}: {mesh.shape}")
    if not mesh.one_card:
        raise NotImplementedError(
            "TP ranks on distinct cards: ROADMAP queue 1 item 7b")
    if not _same_device(x.device, mesh.device):
        raise ValueError(f"the tensors lie on {x.device}, the mesh on "
                         f"{mesh.device}")
    return mesh.shape[tp_axis]


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
                         float(threshold), False, P, bool(mxu_bf16))


def radlif_tp(Wx, alpha, beta, a, b, V, threshold, u0, w0, s0, *, mesh,
              tp_axis="model", mxu_bf16: bool = False):
    """Tensor-parallel fused RadLIF over the mesh's TP axis (JAX
    ``radlif_tp_sharded``; semantics ``cells.radlif_scan``)."""
    P, (alpha, beta, a, b, V, u0, w0, s0) = _prepare(
        Wx, alpha, beta, a, b, V, u0, w0, s0, mesh, tp_axis)
    return _TPCell.apply(Wx, alpha, beta, a, b, V, u0, w0, s0,
                         float(threshold), True, P, bool(mxu_bf16))


def _per_block(fn, Wx, mesh, tp_axis, vecs, states):
    """``fn`` on each rank's column block, the outputs side by side."""
    P = _tp_size(mesh, tp_axis, Wx)
    H = Wx.shape[-1]
    if H % P:
        raise ValueError(f"H={H} does not split over {P} ranks")
    return torch.cat([
        fn(Wx[..., c].contiguous(), *[v[c] for v in vecs],
           *[s[:, c].contiguous() for s in states])
        for c in _shards(H, P)], dim=-1)


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
