"""Fused non-spiking recurrent cells (counterpart of
sparch_tpu/ops/pallas_ann.py), forward and backward: the sigmoid RNN, the
LiGRU and the GRU.

    RNN:    y_t = sigmoid(wx_t + y @ V)
    LiGRU:  z = sigmoid(wzx_t + y @ Vz); c = relu(wx_t + y @ V)
            y_t = z*y + (1-z)*c
    GRU:    z = sigmoid(wzx_t + y @ Vz); r = sigmoid(wrx_t + y @ Vr)
            c = tanh(wx_t + (r*y) @ V);  y_t = z*y + (1-z)*c

A cell has one input stream and one recurrent matrix per gate. Gates are
numbered 0 (the candidate: ``Wx``, ``V``), 1 (update: ``Wzx``, ``Vz``) and
2 (reset: ``Wrx``, ``Vr``); the RNN has gate 0 only. ``scales``/``shifts``
(one ``(H,)`` pair per gate) apply the normalization affine on load,
``drive = scale*wx + shift``, and their gradients are returned.

Each entry point runs one ``torch.autograd.Function`` that dispatches on
the device of ``Wx`` as ``ops.fused_cells`` does: a CPU tensor runs the
plain PyTorch versions (``ann_cell_plain``, ``ann_cell_bwd_plain``), a CUDA
tensor launches ``csrc/fused_ann_fwd.cu`` and ``csrc/fused_ann_bwd.cu`` and
nothing else, any other device raises.

Residuals: with a gradient to compute the forward also writes the gate
series (LiGRU z, c; GRU z, r, c) and, only under dropout, the raw ``y``
series beside the dropped output; without dropout the output is the ``y``
residual. Without a gradient it writes the output alone.

Output dropout is the hash of ``ops.fused_cells`` (same seed, same batch
tile): the raw ``y`` stays in the recurrence, only the stored output is
dropped, and the backward regenerates the mask.

The bf16-stream mode (``mxu_bf16=True``, the JAX kernels' mode of that
name): the output, the raw-``y`` series, the gate residuals, the cotangent
and the per-gate ``dWx`` are bf16 streams, the recurrent matrices are
rounded to bf16 once, each ``Wx`` keeps the type it arrives in (float32 or
bf16) and is promoted on load, and both operands of every product
(``y @ V``, ``(r*y) @ V``, ``dpre @ V^T``, ``y_{t-1}^T dpre``) are rounded
to bf16 and summed in float32; the carried ``y``, the adjoint and every
reduced gradient stay float32. Each gradient comes back in its operand's
type.

Launches are counted per cell and stream mode (``fused_ann_fwd_gru``,
``fused_ann_fwd_gru_bf16``, ...) and reported by
``fused_cells.launch_counts()``.

The kernels run as thread-block clusters (``csrc/cluster_slice.cuh``): a
cluster of ``cluster`` blocks owns ``rows`` batch rows for the whole
sequence, each block one column slice of every recurrent matrix, and the
blocks exchange each step's left operand through distributed shared
memory. ``_fwd_plan`` and ``_bwd_plan`` give the plan (the kernels check
that they get the plan they compute themselves), ``_pack_slices`` lays the
matrices out for it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from sparch_tpu_torch._build import Kernel
from sparch_tpu_torch.ops import fused_cells
from sparch_tpu_torch.ops.fused_cells import (
    _BF16,
    _as_seed,
    _check,
    _inv_keep,
    _keep_rows,
    _ptr,
    _rb,
    _stream_dtype,
    _work_dtype,
    _wx_dtypes,
    dropout_tile_rows,
    keep_u32,
)

__all__ = [
    "MODES",
    "FUSED_ANN_FWD",
    "FUSED_ANN_BWD",
    "FUSED_ANN_FWD_BF16",
    "FUSED_ANN_BWD_BF16",
    "KERNELS",
    "ann_cell_plain",
    "ann_cell_bwd_plain",
    "rnn_fused",
    "ligru_fused",
    "gru_fused",
]

# gates per mode, and the gate series the backward reads
MODES = {"rnn": 1, "ligru": 2, "gru": 3}
_GATE_SERIES = {"rnn": (), "ligru": ("z", "c"), "gru": ("z", "r", "c")}
_MODE_ID = {"rnn": 0, "ligru": 1, "gru": 2}
# the passes of one step of csrc/fused_ann_*.cu, by gate: the gates of a
# pass share its loop over the rows of the matrices (the backward's: V^T)
_FWD_PASSES = {"rnn": ((0,),), "ligru": ((0, 1),), "gru": ((1, 2), (0,))}
_BWD_PASSES = {"rnn": ((0,),), "ligru": ((0, 1),), "gru": ((0, 1), (2,))}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_FWD_ARGS = [_P] * 13 + [_I] * 4 + [_U, _F, _I] + [_I] * 5 + [_P]
_BWD_ARGS = [_P] * 23 + [_I] * 4 + [_U, _F, _I] + [_I] * 8 + [_P] * 2


def _per_mode(source: str, suffix: str = ""):
    """One counter per cell for an entry point (which serves both stream
    modes; they are counted apart)."""
    args = _FWD_ARGS if source == "fused_ann_fwd" else _BWD_ARGS
    return {mode: Kernel(source, f"sparch_{source}", args,
                         name=f"{source}_{mode}{suffix}") for mode in MODES}


FUSED_ANN_FWD = _per_mode("fused_ann_fwd")
FUSED_ANN_BWD = _per_mode("fused_ann_bwd")
FUSED_ANN_FWD_BF16 = _per_mode("fused_ann_fwd", "_bf16")
FUSED_ANN_BWD_BF16 = _per_mode("fused_ann_bwd", "_bf16")
# the dV product alone, for the card tests (the backwards launch it on the
# main path)
DV_PRODUCT = Kernel("fused_ann_bwd", "sparch_dv_product",
                    [_P] * 8 + [_I] * 5 + [_F] + [_I] * 3 + [_P],
                    name="dv_product")
KERNELS = tuple(k for group in (FUSED_ANN_FWD, FUSED_ANN_BWD,
                                FUSED_ANN_FWD_BF16, FUSED_ANN_BWD_BF16)
                for k in group.values())
# csrc/fused_ann_*.cu: the widest layer
_MAX_H = 2048
# csrc/dv_product.cuh: the split of the dV products over B*T counts tiles
# of 64 x 64 and rounds a split's rows to 16 (kBK), whatever tile the
# product runs: the split fixes which rows each chain of fmaf sums, so it
# fixes the bits. The product's tiles (dV rows x columns a block), largest
# first.
_DV_TILE = 64
_DV_BK = 16
_DV_TILES = ((128, 128), (128, 64), (64, 64))
# csrc/cluster_slice.cuh: blocks of a cluster at most (kMaxCluster, which
# says why six), a slice's columns at least (H allowing), the slice widths'
# multiple, the rows a thread owns, the threads of a block at most, the
# shared memory of a block less the static part, the stream's stages and
# their largest size (tile_stream.cuh's kStages, kTileBytes)
_MAX_CLUSTER = 6
_MIN_COLS = 32
_COL_ALIGN = 8
_ROWS_PER_THREAD = 4
_MAX_THREADS = 384
_SMEM_BUDGET = 232448 - 1024
_STAGES = 3
_MAX_STAGE_BYTES = 65536


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _dot(x, v, mxu_bf16: bool):
    """``x @ v``; in the bf16 mode ``x`` is rounded to bf16 (``v`` is
    already) and the sum stays float32."""
    return torch.matmul(_rb(x) if mxu_bf16 else x, v)


def ann_cell_plain(mode: str, wxs, scales, shifts, vs, y0, *,
                   drop_rate: float = 0.0, seed=None,
                   save_residuals: bool = False, mxu_bf16: bool = False):
    """Plain PyTorch version of ``csrc/fused_ann_fwd.cu``: the TPU
    ``_ann_fwd_kernel``'s per-step arithmetic as a loop over T. ``wxs``,
    ``vs`` (and ``scales``/``shifts``, or None for no affine) are lists by
    gate. Returns the output (B,T,H), dropped under ``drop_rate > 0``; with
    ``save_residuals`` returns ``(out, y_raw, gates)``: the raw y series
    (None without dropout, where ``out`` is it) and the tuple of gate
    series.

    ``mxu_bf16``: the output and the residual series come back bf16, the
    matrices are rounded to bf16, each ``wx`` (float32 or bf16) is promoted
    on load, and the left operand of every product is rounded to bf16; the
    carried ``y`` stays float32."""
    B, T, H = wxs[0].shape
    # float64 matrices (the witness of a whole model) lift the arithmetic
    work = torch.promote_types(_work_dtype(wxs[0]), vs[0].dtype)
    y = y0.to(work)
    if mxu_bf16:
        vs = [_rb(v) for v in vs]
    out = torch.empty(wxs[0].shape, dtype=_stream_dtype(mxu_bf16, wxs[0]),
                      device=wxs[0].device)
    dropout = drop_rate > 0.0
    y_raw = torch.empty_like(out) if (save_residuals and dropout) else None
    gates = tuple(torch.empty_like(out) for _ in _GATE_SERIES[mode]) \
        if save_residuals else ()
    if dropout:
        keep, inv = keep_u32(drop_rate), _inv_keep(drop_rate)
    for t in range(T):
        d = [w[:, t].to(work) for w in wxs]
        if scales is not None:
            d = [sc * x + sh for sc, x, sh in zip(scales, d, shifts)]
        if mode == "rnn":
            y = torch.sigmoid(d[0] + _dot(y, vs[0], mxu_bf16))
            vals = ()
        elif mode == "ligru":
            z = torch.sigmoid(d[1] + _dot(y, vs[1], mxu_bf16))
            c = torch.relu(d[0] + _dot(y, vs[0], mxu_bf16))
            y = z * y + (1.0 - z) * c
            vals = (z, c)
        else:
            z = torch.sigmoid(d[1] + _dot(y, vs[1], mxu_bf16))
            r = torch.sigmoid(d[2] + _dot(y, vs[2], mxu_bf16))
            c = torch.tanh(d[0] + _dot(r * y, vs[0], mxu_bf16))
            y = z * y + (1.0 - z) * c
            vals = (z, r, c)
        if dropout:
            # the raw y stays in the recurrence
            mask = _keep_rows(B, H, seed, t, keep)
            out[:, t] = torch.where(mask, y * inv, torch.zeros_like(y))
            if y_raw is not None:
                y_raw[:, t] = y
        else:
            out[:, t] = y
        for series, val in zip(gates, vals):
            series[:, t] = val
    return (out, y_raw, gates) if save_residuals else out


def ann_cell_bwd_plain(mode: str, g, wxs, y_seq, gates, scales, vs, y0, *,
                       drop_rate: float = 0.0, seed=None,
                       mxu_bf16: bool = False):
    """Plain PyTorch version of ``csrc/fused_ann_bwd.cu``: reverse-time
    BPTT, the adjoint equations of the TPU ``_ann_bwd_kernel``. With G_t the
    total adjoint of y_t (the masked output cotangent plus what step t+1
    carries back) and y_p = y_{t-1} (y0 at the first step), walking
    t = T..1:

        RNN:   dpre = G*y_t*(1-y_t);  G_{t-1} += dpre @ V^T
        LiGRU: dcpre = G*(1-z)*[c > 0];  dzpre = G*(y_p-c)*z*(1-z)
               G_{t-1} += G*z + dcpre @ V^T + dzpre @ Vz^T
        GRU:   dcpre = G*(1-z)*(1-c^2);  dzpre = G*(y_p-c)*z*(1-z)
               dry = dcpre @ V^T;  drpre = dry*y_p*r*(1-r)
               G_{t-1} += G*z + dry*r + dzpre @ Vz^T + drpre @ Vr^T

    and per gate dWx = dpre*scale, dscale = sum dpre*wx, dshift = sum dpre,
    dV = sum y_p^T dpre (the GRU's candidate: (r*y_p)^T dcpre), dy0 = G_0.
    ``y_seq`` is the raw y series; ``wxs`` (the raw streams) is read only
    with the affine. Returns ``(dwxs, dscales, dshifts, dvs, dy0)``, lists
    by gate, the affine ones None without it.

    ``mxu_bf16``: ``g`` and the residual series arrive bf16 and are read up
    to float32, each ``dWx`` comes back bf16 (``bf16(dpre*scale)``), the
    matrices are rounded to bf16, and each dpre is rounded to bf16 where it
    enters the adjoint product and ``dV``, whose left operand (``y0``, or
    ``r*y_p``) is rounded too; ``dscale``/``dshift`` sum the float32 dpre."""
    B, T, H = g.shape
    n = MODES[mode]
    affine = scales is not None
    work = torch.promote_types(_work_dtype(y0), vs[0].dtype)
    sdt = _stream_dtype(mxu_bf16, y0)
    y0 = y0.to(work)
    zeros = torch.zeros_like(y0)
    D = zeros
    # dpre as it enters the products, and the gradient streams
    dpres = [torch.empty(g.shape, dtype=work, device=g.device)
             for _ in range(n)]
    dwxs = [torch.empty(g.shape, dtype=sdt, device=g.device)
            for _ in range(n)]
    dsc, dsh = [zeros] * n, [zeros] * n
    if mxu_bf16:
        vs = [_rb(v) for v in vs]

    def dotT(x, v):
        return torch.matmul(_rb(x) if mxu_bf16 else x, v.t())

    dropout = drop_rate > 0.0
    if dropout:
        keep, inv = keep_u32(drop_rate), _inv_keep(drop_rate)
    for t in range(T - 1, -1, -1):
        g_t = g[:, t].to(work)
        if dropout:
            mask = _keep_rows(B, H, seed, t, keep)
            g_t = torch.where(mask, g_t * inv, torch.zeros_like(g_t))
        y_p = y_seq[:, t - 1].to(work) if t > 0 else y0
        G = g_t + D
        if mode == "rnn":
            y_t = y_seq[:, t].to(work)
            step = (G * y_t * (1.0 - y_t),)
            D = dotT(step[0], vs[0])
        elif mode == "ligru":
            z, c = gates[0][:, t].to(work), gates[1][:, t].to(work)
            dc = torch.where(c > 0, G * (1.0 - z), torch.zeros_like(G))
            dz = G * (y_p - c) * z * (1.0 - z)
            D = G * z + dotT(dc, vs[0]) + dotT(dz, vs[1])
            step = (dc, dz)
        else:
            z, r, c = (x[:, t].to(work) for x in gates)
            dc = G * (1.0 - z) * (1.0 - c * c)
            dz = G * (y_p - c) * z * (1.0 - z)
            dry = dotT(dc, vs[0])
            dr = dry * y_p * r * (1.0 - r)
            D = G * z + dry * r + dotT(dz, vs[1]) + dotT(dr, vs[2])
            step = (dc, dz, dr)
        for i, dpre in enumerate(step):
            dpres[i][:, t] = _rb(dpre) if mxu_bf16 else dpre
            if affine:
                dsc[i] = dsc[i] + dpre * wxs[i][:, t].to(work)
                dsh[i] = dsh[i] + dpre
                dwxs[i][:, t] = dpre * scales[i]
            else:
                dwxs[i][:, t] = dpre
    y_prev = torch.cat([y0[:, None], y_seq[:, :-1].to(work)], dim=1)
    dvs = []
    for i, dpre in enumerate(dpres):
        left = gates[1].to(work) * y_prev if (mode == "gru" and i == 0) \
            else y_prev
        if mxu_bf16:
            left = _rb(left)
        dvs.append(torch.matmul(left.reshape(-1, H).t(),
                                dpre.reshape(-1, H)))
    if not affine:
        return dwxs, None, None, dvs, D
    return (dwxs, [x.sum(0) for x in dsc], [x.sum(0) for x in dsh], dvs, D)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _check_operands(mode, wxs, scales, shifts, vs, y0,
                    wx_dtype=torch.float32):
    """``wx_dtype``: the type(s) the input streams may have; they must all
    have the same one."""
    n = MODES[mode]
    B, T, H = wxs[0].shape
    dev = wxs[0].device
    if H > _MAX_H:
        raise ValueError(
            f"the fused ANN cell kernel takes H <= {_MAX_H}, got {H}")
    for name, group, shape in (("wx", wxs, (B, T, H)), ("V", vs, (H, H)),
                               ("scale", scales, (H,)),
                               ("shift", shifts, (H,))):
        if group is None:
            continue
        if len(group) != n:
            raise ValueError(f"{mode}: want {n} of {name}, got {len(group)}")
        for i, t in enumerate(group):
            _check(f"{name}[{i}]", t, shape, dev,
                   wx_dtype if name == "wx" else torch.float32)
    if len({w.dtype for w in wxs}) != 1:
        raise ValueError(f"{mode}: the input streams differ in type")
    _check("y0", y0, (B, H), dev)


class ClusterPlan(NamedTuple):
    """The launch plan of a kernel's time loop (csrc/cluster_slice.cuh
    ``make_plan`` computes the same)."""

    cluster: int      # blocks of a cluster, one column slice each
    rows: int         # batch rows of a cluster
    cols: int         # columns of a block's slice (padded)
    resident: bool    # the slice stays in shared memory for all T
    stage_bytes: int  # else: bytes of each stage of its stream from L2
    clusters: int
    threads: int      # of a block


def _cluster_plan(B: int, H: int, n: int, mxu_bf16: bool, planes: int,
                  width: Optional[int] = None,
                  cluster: Optional[int] = None,
                  rows: Optional[int] = None,
                  operands: Optional[int] = None) -> ClusterPlan:
    """The plan of a time loop over ``n`` recurrent matrices of H rows
    whose left operand is ``planes`` (H,) planes a row, with ``width``
    columns (None: H; a tensor-parallel rank's block is narrower) split
    over ``cluster`` blocks (None: the most, up to 6, that leave each slice
    32 columns or more); ``rows`` a cluster (None: 8, or 4 where the
    operands would pass 128 KB or the threads 384); the slice resident
    where it fits in shared memory beside the ``operands`` planes of
    gathered rows (None: the two parities of ``planes``), else streamed in
    three stages of what is left (at most 64 KB each)."""
    width = H if width is None else width
    if cluster is None:
        cluster = max(1, min(_MAX_CLUSTER, width // _MIN_COLS))
    per_block = -(-width // cluster)
    cols = -(-per_block // _COL_ALIGN) * _COL_ALIGN
    if rows is None:
        rows = 8 if planes * H <= 2048 and \
            cols * 8 // _ROWS_PER_THREAD <= _MAX_THREADS else 4
    operand_bytes = (operands or 2 * planes) * rows * H * 4
    slices = n * H * cols * (2 if mxu_bf16 else 4)
    resident = operand_bytes + slices <= _SMEM_BUDGET
    stage = min(_MAX_STAGE_BYTES,
                (_SMEM_BUDGET - operand_bytes) // _STAGES // 16 * 16)
    threads = -(-cols * (rows // _ROWS_PER_THREAD) // 32) * 32
    return ClusterPlan(cluster, rows, cols, resident,
                       0 if resident else stage, -(-B // rows), threads)


def _check_h(H: int) -> None:
    if H > _MAX_H:
        raise ValueError(
            f"the fused ANN cell kernel takes H <= {_MAX_H}, got {H}")


def _fwd_plan(B: int, H: int, n: int, mxu_bf16: bool = False) -> ClusterPlan:
    """The plan that ``csrc/fused_ann_fwd.cu`` checks its arguments
    against: one left operand (y, or the GRU's r*y)."""
    _check_h(H)
    return _cluster_plan(B, H, n, mxu_bf16, 1)


def _dv_split(B: int, T: int, H: int, n: int) -> int:
    """The split of the dV products over B*T (``dv_product.cuh``)."""
    tiles = n * (-(-H // _DV_TILE)) ** 2
    return max(1, min(264 // tiles, -(-(B * T) // (8 * _DV_BK))))


def _dv_rows_per_split(B: int, T: int, ksplit: int) -> int:
    """The rows of each split but the last (``dv_rows_per_split``)."""
    return -(-(-(-(B * T) // ksplit)) // _DV_BK) * _DV_BK


def _dv_tile(H: int, n: int, ksplit: int, sms: int) -> int:
    """The dV product's tile, an index into ``_DV_TILES`` (``dv_tile`` of
    ``csrc/dv_product.cuh``, which checks it): among the tiles whose grid
    gives each of the card's ``sms`` SMs a block, the one whose last round
    of blocks is fullest, the larger on a tie; where none does, the
    smallest."""
    best, best_blocks, best_rounds = -1, 0, 1
    for i, (bm, bn) in enumerate(_DV_TILES):
        blocks = n * ksplit * -(-H // bm) * -(-H // bn)
        if blocks < sms:
            continue
        rounds = -(-blocks // sms)
        if best < 0 or blocks * best_rounds > best_blocks * rounds:
            best, best_blocks, best_rounds = i, blocks, rounds
    return len(_DV_TILES) - 1 if best < 0 else best


def _card_dv_tile(H: int, n: int, ksplit: int, dev) -> int:
    """``_dv_tile`` for the SMs of the card ``dev``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _dv_tile(H, n, ksplit, sms)


def _dv_product_cuda(left, left0, r, rights, *, threshold=None,
                     mxu_bf16: bool = False):
    """Launch the dV product alone (``sparch_dv_product``) in the split and
    tile the backwards take: by gate, the sum over rows (b, t) of
    l[b, t]^T rights[gate][b, t], one fmaf chain an element, with l the
    left operand of the row before (``left0`` at t = 0). With a
    ``threshold`` the spiking product (``left`` the float32 u series, l =
    left > threshold, one gate), else l = ``left`` (y), times ``r`` for
    the GRU's candidate (gate 0); rounded to bf16 with ``mxu_bf16``, where
    the right series (and y, r) are bf16. Returns the gates' dV."""
    spiking = threshold is not None
    n = len(rights)
    B, T, H = rights[0].shape
    dev = rights[0].device
    sdt = _BF16 if mxu_bf16 else torch.float32
    _check("left", left, (B, T, H), dev, torch.float32 if spiking else sdt)
    _check("left0", left0, (B, H), dev)
    if r is not None:
        _check("r", r, (B, T, H), dev, sdt)
    if not 1 <= n <= (1 if spiking else 3):
        raise ValueError(f"the dV product takes 1-3 gates (spiking: 1), "
                         f"got {n}")
    for i, right in enumerate(rights):
        _check(f"rights[{i}]", right, (B, T, H), dev, sdt)
    ksplit = _dv_split(B, T, H, n)
    dvs = torch.empty((n, H, H), dtype=torch.float32, device=dev)
    parts = torch.empty((ksplit, n, H, H), dtype=torch.float32, device=dev) \
        if ksplit > 1 else None
    with torch.cuda.device(dev):
        DV_PRODUCT(_ptr(left), _ptr(left0), _ptr(r), *_three(rights),
                   _ptr(dvs), _ptr(parts), B, T, H, n, int(spiking),
                   float(threshold or 0.0), ksplit,
                   _card_dv_tile(H, n, ksplit, dev), int(mxu_bf16),
                   torch.cuda.current_stream(dev).cuda_stream)
    return list(dvs.unbind(0))


def _bwd_plan(B: int, T: int, H: int, n: int, mxu_bf16: bool = False):
    """(the time loop's plan, partials of dscale/dshift, split of the dV
    products), the plan that ``csrc/fused_ann_bwd.cu`` checks its
    arguments against: a gate's dpre per plane (the LiGRU's and the GRU's
    two at once); one partial per ``_part_rows(H)`` rows."""
    _check_h(H)
    plan = _cluster_plan(B, H, n, mxu_bf16, 1 if n == 1 else 2)
    return plan, -(-B // _part_rows(H)), _dv_split(B, T, H, n)


def _part_rows(H: int) -> int:
    """Rows summed into one dscale/dshift partial: two at H <= 512, else
    one, the rows of a block of the kernel that owned whole rows before the
    cluster split, so that the reduced gradients keep their bits."""
    return 2 if H <= 512 else 1


def max_active_clusters(mode: str, B: int, H: int, mxu_bf16: bool = False,
                        backward: bool = False) -> int:
    """How many clusters of the forward's plan (``backward``: of the
    backward's time loop) the card holds at once, from
    ``cudaOccupancyMaxActiveClusters``; -1 where the query fails. For
    reports: a plan with more clusters than this runs in waves."""
    from sparch_tpu_torch import _build

    source = "fused_ann_bwd" if backward else "fused_ann_fwd"
    fn = getattr(_build.load(source), f"sparch_{source}_max_clusters")
    fn.argtypes = [_I] * 4
    fn.restype = _I
    return fn(B, H, _MODE_ID[mode], int(mxu_bf16))


def _pack_slices(mats: Sequence[torch.Tensor], passes, plan: ClusterPlan,
                 mxu_bf16: bool = False) -> torch.Tensor:
    """Every block's slice of the (H, width) matrices, ``(cluster,
    gates*H*cols)``: block k's row holds columns k*cols .. k*cols+cols-1 of
    each matrix (zero past its width), pass after pass, a pass's gates side
    by side in each of its H rows, so that a block copies its slice as one
    contiguous piece. In the bf16 mode the matrices are rounded to bf16
    here."""
    H, width = mats[0].shape
    C, w = plan.cluster, plan.cols
    dtype = _BF16 if mxu_bf16 else mats[0].dtype

    def sliced(m):  # (C, H, w)
        m = torch.nn.functional.pad(m.to(dtype), (0, C * w - width))
        return m.reshape(H, C, w).permute(1, 0, 2)

    return torch.cat([
        torch.stack([sliced(mats[i]) for i in gates], dim=2).reshape(C, -1)
        for gates in passes], dim=1).contiguous()


def _three(ts):
    """Pointers of up to three tensors, None for the gates a mode lacks."""
    ts = list(ts) if ts is not None else []
    return tuple(_ptr(t) for t in ts + [None] * (3 - len(ts)))


def _dropout_args(B, drop_rate, seed, dev):
    if not drop_rate > 0.0:
        return None, 0, 1.0, dropout_tile_rows(B)
    _check("seed", seed, (2,), dev, torch.int32)
    return (_ptr(seed), keep_u32(drop_rate), _inv_keep(drop_rate),
            dropout_tile_rows(B))


def _ann_cell_cuda(mode: str, wxs, scales, shifts, vs, y0, *,
                   drop_rate: float = 0.0, seed=None,
                   save_residuals: bool = False, mxu_bf16: bool = False):
    """Launch ``csrc/fused_ann_fwd.cu`` in the float32 or the bf16 stream
    mode. Same contract as ``ann_cell_plain``."""
    if (scales is None) != (shifts is None):
        raise ValueError("pass both scales and shifts, or neither")
    _check_operands(mode, wxs, scales, shifts, vs, y0, _wx_dtypes(mxu_bf16))
    B, T, H = wxs[0].shape
    dev = wxs[0].device
    seed_p, keep, inv, tile = _dropout_args(B, drop_rate, seed, dev)
    out = torch.empty(wxs[0].shape, dtype=_stream_dtype(mxu_bf16, wxs[0]),
                      device=dev)
    y_raw = torch.empty_like(out) if (save_residuals and seed_p) else None
    names = _GATE_SERIES[mode] if save_residuals else ()
    series = {k: torch.empty_like(out) for k in names}
    result = (out, y_raw, tuple(series.values()))
    if out.numel() == 0:
        return result if save_residuals else out
    plan = _fwd_plan(B, H, MODES[mode], mxu_bf16)
    # named, so that they live until the launch is enqueued
    scale = torch.stack(scales) if scales is not None else None
    shift = torch.stack(shifts) if shifts is not None else None
    packed = _pack_slices(vs, _FWD_PASSES[mode], plan, mxu_bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        (FUSED_ANN_FWD_BF16 if mxu_bf16 else FUSED_ANN_FWD)[mode](
            *_three(wxs), _ptr(scale), _ptr(shift), _ptr(packed), _ptr(y0),
            seed_p, _ptr(out),
            _ptr(y_raw), _ptr(series.get("z")), _ptr(series.get("r")),
            _ptr(series.get("c")), B, T, H, _MODE_ID[mode], keep, inv, tile,
            int(mxu_bf16), int(wxs[0].dtype == _BF16), plan.cluster,
            plan.rows, int(plan.resident), stream,
        )
    return result if save_residuals else out


def _ann_cell_bwd_cuda(mode: str, g, wxs, y_seq, gates, scales, vs, y0, *,
                       drop_rate: float = 0.0, seed=None,
                       mxu_bf16: bool = False, split_ms=None):
    """Launch ``csrc/fused_ann_bwd.cu`` in the float32 or the bf16 stream
    mode. Same contract as ``ann_cell_bwd_plain``. ``split_ms`` (a list, for
    timing only) receives the milliseconds of the time loop, the dV product
    and the second passes, CUDA events around each launch; the call then
    waits for the card."""
    n = MODES[mode]
    affine = scales is not None
    B, T, H = g.shape
    dev = g.device
    sdt = _BF16 if mxu_bf16 else torch.float32
    _check("g", g, (B, T, H), dev, sdt)
    _check_operands(mode, wxs if affine else [g] * n, scales, None, vs, y0,
                    _wx_dtypes(mxu_bf16))
    _check("y_seq", y_seq, (B, T, H), dev, sdt)
    if len(gates) != len(_GATE_SERIES[mode]):
        raise ValueError(f"{mode}: want the series {_GATE_SERIES[mode]}")
    for name, t in zip(_GATE_SERIES[mode], gates):
        _check(name, t, (B, T, H), dev, sdt)
    series = dict(zip(_GATE_SERIES[mode], gates))
    seed_p, keep, inv, tile = _dropout_args(B, drop_rate, seed, dev)
    plan, n_parts, ksplit = _bwd_plan(B, T, H, n, mxu_bf16)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dwxs = [torch.empty_like(g) for _ in range(n)]
    # dpre before the scale, the right operand of the dV products (in the
    # bf16 mode stored as the bf16 the products consume)
    dds = [torch.empty_like(g) for _ in range(n)] if affine else []
    partials = new(n_parts, 2 * n, H)
    vecs = new(2 * n, H)
    dvs = new(n, H, H)
    dv_partials = new(ksplit, n, H, H) if ksplit > 1 else None
    dv_tile = _card_dv_tile(H, n, ksplit, dev)
    dy0 = new(B, H)
    # V^T per gate: the adjoint products contract V's second axis
    vts = _pack_slices([v.t() for v in vs], _BWD_PASSES[mode], plan,
                       mxu_bf16)
    scale = torch.stack(scales) if affine else None
    split = (ctypes.c_float * 3)() if split_ms is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        (FUSED_ANN_BWD_BF16 if mxu_bf16 else FUSED_ANN_BWD)[mode](
            _ptr(g), *_three(wxs if affine else None), _ptr(y_seq),
            _ptr(series.get("z")), _ptr(series.get("r")),
            _ptr(series.get("c")),
            _ptr(scale), _ptr(vts), _ptr(y0), seed_p, *_three(dwxs),
            *_three(dds), _ptr(partials), _ptr(vecs), _ptr(dvs),
            _ptr(dv_partials), _ptr(dy0),
            B, T, H, _MODE_ID[mode], keep, inv, tile, plan.cluster,
            plan.rows, int(plan.resident), n_parts, ksplit, dv_tile,
            int(mxu_bf16),
            int(affine and wxs[0].dtype == _BF16), split, stream,
        )
    if split is not None:
        split_ms[:] = list(split)
    if not affine:
        return dwxs, None, None, list(dvs.unbind(0)), dy0
    return (dwxs, list(vecs[:n].unbind(0)), list(vecs[n:].unbind(0)),
            list(dvs.unbind(0)), dy0)


class _FusedANN(torch.autograd.Function):
    """The fused cell (JAX ``_make_ann_op``). ``ops`` are the per-gate
    operands in a row: the input streams, then the scales and the shifts
    (with the affine), then the recurrent matrices."""

    @staticmethod
    def forward(ctx, mode, mxu_bf16, drop_rate, seed, y0, *ops):
        n = MODES[mode]
        affine = len(ops) == 4 * n
        wxs = list(ops[:n])
        scales = list(ops[n:2 * n]) if affine else None
        shifts = list(ops[2 * n:3 * n]) if affine else None
        vs = list(ops[-n:])
        fwd = fused_cells._by_device(wxs[0], ann_cell_plain, _ann_cell_cuda,
                                     "fused ANN cell")
        flags = dict(drop_rate=drop_rate, seed=seed, mxu_bf16=mxu_bf16)
        if not any(ctx.needs_input_grad):
            return fwd(mode, wxs, scales, shifts, vs, y0, **flags)
        out, y_raw, gates = fwd(mode, wxs, scales, shifts, vs, y0,
                                save_residuals=True, **flags)
        ctx.mode, ctx.drop_rate, ctx.affine = mode, drop_rate, affine
        ctx.mxu_bf16, ctx.wx_dtype = mxu_bf16, wxs[0].dtype
        ctx.save_for_backward(out if y_raw is None else y_raw, y0, seed,
                              *gates, *vs, *(wxs + scales if affine else ()))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mode, n = ctx.mode, MODES[ctx.mode]
        n_gates = len(_GATE_SERIES[mode])
        y_seq, y0, seed, *rest = ctx.saved_tensors
        gates, rest = rest[:n_gates], rest[n_gates:]
        vs, rest = rest[:n], rest[n:]
        wxs, scales = (rest[:n], rest[n:]) if ctx.affine else (None, None)
        bwd = fused_cells._by_device(g, ann_cell_bwd_plain,
                                     _ann_cell_bwd_cuda,
                                     "fused ANN cell backward")
        # the cotangent often arrives as a view (the bidirectional split)
        dwxs, dscales, dshifts, dvs, dy0 = bwd(
            mode, g.contiguous(), wxs, y_seq, gates, scales, vs, y0,
            drop_rate=ctx.drop_rate, seed=seed, mxu_bf16=ctx.mxu_bf16)
        aff = (*dscales, *dshifts) if ctx.affine else ()
        # each gradient in its operand's type: the bf16 mode's dWx streams
        # go back up where the streams arrived float32
        dwxs = [d.to(ctx.wx_dtype) for d in dwxs]
        return (None, None, None, None, dy0, *dwxs, *aff, *dvs)


def _fused_ann(mode, wxs, vs, y0, mxu_bf16, scales, shifts, drop_rate,
               drop_seed):
    if (scales is None) != (shifts is None):
        raise ValueError("pass both scales and shifts, or neither")
    n = MODES[mode]
    if scales is not None and not len(scales) == len(shifts) == n:
        raise ValueError(f"{mode}: want {n} scales and {n} shifts")
    drop_rate = float(drop_rate)
    if not 0.0 <= drop_rate < 1.0:
        raise ValueError(f"drop_rate must lie in [0, 1), got {drop_rate}")
    seed = _as_seed(drop_seed, wxs[0].device) if drop_rate > 0.0 else None
    aff = (*scales, *shifts) if scales is not None else ()
    # the carried state is float32 (float64 with float64 streams)
    y0 = y0.to(_work_dtype(wxs[0]))
    return _FusedANN.apply(mode, bool(mxu_bf16), drop_rate, seed, y0, *wxs,
                           *aff, *vs)


def rnn_fused(Wx, V, y0, mxu_bf16: bool = False, scales=None, shifts=None,
              drop_rate: float = 0.0, drop_seed: Optional[object] = None):
    """Fused sigmoid-RNN recurrence (drop-in for cells.rnn_scan). With
    ``scales``/``shifts`` (one (H,) pair per gate) the normalization affine
    is applied on load and their gradients are returned; with
    ``drop_rate``/``drop_seed`` (two int32) the layer-output dropout is
    fused and the backward regenerates the mask from the seed."""
    return _fused_ann("rnn", [Wx], [V], y0, mxu_bf16, scales, shifts,
                      drop_rate, drop_seed)


def ligru_fused(Wx, Wzx, V, Vz, y0, mxu_bf16: bool = False, scales=None,
                shifts=None, drop_rate: float = 0.0, drop_seed=None):
    """Fused LiGRU recurrence (drop-in for cells.ligru_scan)."""
    return _fused_ann("ligru", [Wx, Wzx], [V, Vz], y0, mxu_bf16, scales,
                      shifts, drop_rate, drop_seed)


def gru_fused(Wx, Wzx, Wrx, V, Vz, Vr, y0, mxu_bf16: bool = False,
              scales=None, shifts=None, drop_rate: float = 0.0,
              drop_seed=None):
    """Fused GRU recurrence (drop-in for cells.gru_scan)."""
    return _fused_ann("gru", [Wx, Wzx, Wrx], [V, Vz, Vr], y0, mxu_bf16,
                      scales, shifts, drop_rate, drop_seed)
