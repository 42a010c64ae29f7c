"""Tensor-parallel fused non-spiking cells (counterpart of
sparch_tpu/ops/pallas_tp_ann.py): the sigmoid RNN, the LiGRU and the GRU
with the neurons of a layer split into P column blocks of Hl = H/P, one per
rank of the TP axis, and an exchange inside the kernel at every step.

    RNN:    y_t = sigmoid(wx_t + y_full @ V[:, shard])
    LiGRU:  z = sigmoid(wzx_t + y_full @ Vz[:, shard])
            c = relu(wx_t + y_full @ V[:, shard]);  y_t = z*y + (1-z)*c
    GRU:    z = sigmoid(wzx_t + y_full @ Vz[:, shard])
            r = sigmoid(wrx_t + y_full @ Vr[:, shard])
            c = tanh(wx_t + (r*y)_full @ V[:, shard]);  y_t = z*y + (1-z)*c

The forward (``csrc/tp_ann_fwd.cu``) all-gathers the new y at every step
(the GRU first r*y, then y); the backward (``csrc/tp_ann_bwd.cu``) all-gathers
the adjoint blocks for the products with the rows of V: dpre (RNN), one
stacked [dcpre|dzpre] (LiGRU and GRU), then the GRU's drpre. One
``torch.autograd.Function`` holds the two kernels, as the JAX
``custom_vjp`` does (``_get_tp_ann_op``). Gates are numbered as in
``ops.fused_ann``: 0 the candidate (``Wx``, ``V``), 1 the update (``Wzx``,
``Vz``), 2 the reset (``Wrx``, ``Vr``).

Layout, against the JAX kernels. The JAX backward turns each rank's column
shard of V into a row shard by an all_to_all (``_row_shard``), interleaves
the row shards per peer (``_interleave``) so that one dot against the
stacked gathered plane sums every gate's product at once, and turns the
accumulated dV row shards back (``_deinterleave``, ``_col_shard``). In the
one-card form every all_to_all is a slice of the full V, so the wrapper
takes each rank's blocks of V^T directly, and nothing is interleaved: the
stacked gather is one exchange of two planes side by side, and each gate's
product runs on its own over the Hg gathered columns in ascending order;
the backward then adds D = G*z + dry*r + (dzpre_full @ Vz^T) + (drpre_full @
Vr^T) (LiGRU: G*z + dcpre-term + dzpre-term), the order of
``csrc/fused_ann_bwd.cu``. dV is not accumulated by outer products per step:
it is the single-card backward's product after the time loop, y_p^T @ dpre
per gate ((r*y_p)^T @ dcpre for the GRU's candidate), over the stored
series; in the one-card form the ranks' dWx blocks side by side are the
gathered dpre series, and across cards that product would need them
gathered (ROADMAP queue 1 item 7).

The kernels run thread-block clusters per rank (``csrc/tp_ann.cuh``): a
cluster owns a row group of one rank, each of its blocks a column slice of
the rank's column blocks, and the blocks exchange through distributed
shared memory inside a cluster and through the slots across ranks.
``_tp_plan`` chooses the cluster size from what the card holds (the
kernels check the plan they are given against their own), ``_pack_slices``
lays the matrices out for it; ``last_plan`` reports the plan a launch ran.

The one-card form (``ops.fused_tp``): the P ranks of a mesh that repeats one
device run in one cooperative launch on it. The entry points take the full
tensors, ``Wx (B, T, H)``, ``V (H, H)``, ``y0 (B, H)``; rank r's block is
columns ``r*Hl .. (r+1)*Hl``, and the gathered initial state is the full y0.
Dispatch is ``ops.fused_cells``': a CPU tensor runs the plain versions
(``tp_ann_cell_plain``, ``tp_ann_cell_bwd_plain``), loops over T and over the
P blocks in the kernels' order; a CUDA tensor launches the kernels or
raises. Normalisation and dropout stay outside (the layer applies them), as
in the JAX package. The entry points hold the widths to the JAX kernels'
checks (H divisible by P*128, B by 8); the kernels take any B, H/P a
multiple of 8 up to 2048, and H up to what a block's shared memory leaves
(``_check_width``).

The bf16-stream mode (``mxu_bf16=True``, the JAX kernels' mode of that name)
rounds where ``ops.fused_ann``'s bf16 mode rounds, and the JAX TP kernels
with it: the recurrent matrices are rounded to bf16 once, the exchanged
values are bf16 (the wire), so the gathered y, r*y and dpre that enter the
products are rounded, and so is the gathered y0 of the first products; the
output, the gate series, the cotangent and each ``dWx`` are bf16 streams
(``dWx`` is the exchanged dpre), each ``Wx`` keeps the type it arrives in
(float32 or bf16), ``dV``'s left operand is rounded too, and the carried
``y``, the adjoint and ``dV`` stay float32. The kernels' launches are
counted apart (``tp_ann_fwd_bf16``, ``tp_ann_bwd_bf16``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from sparch_tpu_torch._build import Kernel
from sparch_tpu_torch.ops import fused_ann, fused_cells, fused_tp
from sparch_tpu_torch.ops.fused_cells import (
    _BF16,
    _check,
    _ptr,
    _rb,
    _stream_dtype,
    _work_dtype,
    _wx_dtypes,
)
from sparch_tpu_torch.ops.fused_tp import _rank_columns, _shards

__all__ = [
    "KERNELS",
    "TP_ANN_FWD",
    "TP_ANN_BWD",
    "TP_ANN_FWD_BF16",
    "TP_ANN_BWD_BF16",
    "tp_ann_cell_plain",
    "tp_ann_cell_bwd_plain",
    "rnn_tp",
    "ligru_tp",
    "gru_tp",
]

# per-mode structure (pallas_tp_ann._MODES): input streams (one recurrent
# matrix each), the gate series the backward reads, the planes of the
# backward's widest exchange, and the operand planes its block holds (None:
# two parities of them; the GRU's second exchange, drpre, has one plane)
_MODES = {
    "rnn": dict(n_wx=1, gates=(), bwd_stack=1, bwd_operands=None),
    "ligru": dict(n_wx=2, gates=("z", "c"), bwd_stack=2, bwd_operands=None),
    "gru": dict(n_wx=3, gates=("z", "r", "c"), bwd_stack=2, bwd_operands=3),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
# one C entry point per direction serves both stream modes; the modes are
# counted apart
_FWD_ARGS = [_P] * 11 + [_I] * 13 + [_P, _P]
_BWD_ARGS = [_P] * 15 + [_I] * 14 + [_P, _P, _P]
TP_ANN_FWD = Kernel("tp_ann_fwd", "sparch_tp_ann_fwd", _FWD_ARGS)
TP_ANN_BWD = Kernel("tp_ann_bwd", "sparch_tp_ann_bwd", _BWD_ARGS)
TP_ANN_FWD_BF16 = Kernel("tp_ann_fwd", "sparch_tp_ann_fwd", _FWD_ARGS,
                         name="tp_ann_fwd_bf16")
TP_ANN_BWD_BF16 = Kernel("tp_ann_bwd", "sparch_tp_ann_bwd", _BWD_ARGS,
                         name="tp_ann_bwd_bf16")
KERNELS = (TP_ANN_FWD, TP_ANN_BWD, TP_ANN_FWD_BF16, TP_ANN_BWD_BF16)

# csrc/tp_ann.cuh: the widest block a rank takes, the ranks of a launch, the
# multiple a rank's width is of (16-byte slot rows), the plan a launch
# reports (`report`) and how it launches
_MAX_HL = 2048
_MAX_RANKS = 8
_COL_UNIT = 8
_PLAN_KEYS = ("cluster", "rows", "cols", "resident", "clusters_per_rank",
              "walks", "max_active_clusters", "threads")
LAUNCH_MODE = "cooperative clusters"


class TPPlan(NamedTuple):
    """The launch plan of a TP kernel's time loop (csrc/tp_ann.cuh)."""

    rank: fused_ann.ClusterPlan  # one rank's; its clusters: the row groups
    per_rank: int     # clusters a rank runs at once
    walks: int        # row groups a cluster walks, at most
    max_active: int   # clusters of that size the card holds at once


def _rank_plan(B: int, H: int, P: int, n: int, mxu_bf16: bool, planes: int,
               cluster: Optional[int] = None,
               operands: Optional[int] = None) -> fused_ann.ClusterPlan:
    """One rank's time-loop plan at ``cluster`` blocks (None: the most, up
    to 6, that leave each slice 32 columns): the single-card plan with the
    rank's H/P neurons split over the cluster and the operand H wide;
    ``operands``: the operand planes a block holds (None: two parities)."""
    return fused_ann._cluster_plan(B, H, n, mxu_bf16, planes, width=H // P,
                                   cluster=cluster, operands=operands)


def _runs(plan: fused_ann.ClusterPlan, n: int, mxu_bf16: bool) -> bool:
    """tp_ann.cuh ``runs``: the block fits its threads, and the slice is
    resident or a stream stage holds a row of the widest pass."""
    row = min(n, 2) * plan.cols * (2 if mxu_bf16 else 4)
    return plan.threads <= fused_ann._MAX_THREADS and (
        plan.resident or plan.stage_bytes >= row)


def _tp_plan(B: int, H: int, P: int, n: int, mxu_bf16: bool, planes: int,
             max_active: Callable[[int], int],
             operands: Optional[int] = None) -> TPPlan:
    """The plan of a time loop over ``n`` matrices with ``planes`` operand
    planes (``operands`` in all, None: two parities of them), the P ranks in
    one launch; ``max_active(cluster)``: how many clusters of that many
    blocks the card holds at once (``choose_plan``). Raises where no
    cluster size runs or the card holds fewer clusters of every size than
    ranks."""
    return choose_plan(
        lambda c: _rank_plan(B, H, P, n, mxu_bf16, planes, c, operands),
        lambda q: _runs(q, n, mxu_bf16), P, max_active,
        f"the TP ANN kernels take no H={H} over {P} ranks with {planes} "
        f"operand plane(s): the gathered rows of a cluster's operands leave "
        f"no room for its slice in a block's shared memory")


def choose_plan(plan_of: Callable[[Optional[int]], fused_ann.ClusterPlan],
                runs: Callable[[fused_ann.ClusterPlan], bool], P: int,
                max_active: Callable[[int], int], refusal: str) -> TPPlan:
    """The TP launch plan among one rank's plans ``plan_of(cluster)``
    (None: the most blocks) that ``runs``. Every cluster size that runs is
    tried, from the most blocks down; a rank gets every row group at once
    where the card holds P times as many clusters, else as many as it holds,
    walking the groups. A thread's work a step is the same in every plan,
    and an SM issues for the warps of its one block, so the plan of the
    fewest warps a block times walks wins (the first of them: the most
    blocks a cluster, the fewest L2 reads). Raises ``refusal`` where the
    first plan does not run, and where the card holds fewer clusters of
    every size than ranks."""
    first = plan_of(None)
    if not runs(first):
        raise ValueError(refusal)
    best, held = None, {}
    for c in range(first.cluster, 0, -1):
        q = plan_of(c)
        if not runs(q):
            continue
        held[c] = max_active(c)
        per_rank = min(q.clusters, held[c] // P)
        if per_rank < 1:
            continue
        plan = TPPlan(q, per_rank, -(-q.clusters // per_rank), held[c])
        if best is None or _cost(plan) < _cost(best):
            best = plan
    if best is None:
        raise ValueError(f"the card holds fewer than {P} clusters of any "
                         f"size ({held}): the TP kernels run every rank at "
                         f"once")
    return best


def _cost(plan: TPPlan) -> int:
    """The warps an SM issues for, a step, times the row groups a cluster
    walks: what ``_tp_plan`` minimises."""
    return plan.walks * plan.rank.threads // 32


@functools.lru_cache(maxsize=None)
def max_active_clusters(mode: str, B: int, H: int, P: int, cluster: int,
                        mxu_bf16: bool = False,
                        backward: bool = False) -> int:
    """How many clusters of ``cluster`` blocks of the forward's plan
    (``backward``: of the backward's time loop) the card holds at once,
    from ``cudaOccupancyMaxActiveClusters`` on the current card; -1 where
    that plan does not run or the query fails."""
    from sparch_tpu_torch import _build

    source = "tp_ann_bwd" if backward else "tp_ann_fwd"
    fn = getattr(_build.load(source), f"sparch_{source}_max_clusters")
    fn.argtypes = [_I] * 6
    fn.restype = _I
    return fn(B, H, P, fused_ann._MODE_ID[mode], int(mxu_bf16), cluster)


def launch_plan(mode: str, B: int, H: int, P: int, mxu_bf16: bool,
                backward: bool, dev) -> TPPlan:
    """The plan the wrappers launch on ``dev``: ``_tp_plan`` with what the
    card holds."""
    planes = _MODES[mode]["bwd_stack"] if backward else 1
    operands = _MODES[mode]["bwd_operands"] if backward else None
    with torch.cuda.device(dev):
        return _tp_plan(B, H, P, _MODES[mode]["n_wx"], mxu_bf16, planes,
                        lambda c: max_active_clusters(mode, B, H, P, c,
                                                      mxu_bf16, backward),
                        operands)


def last_plan(name: str) -> dict:
    """The plan of the last launch of ``tp_ann_fwd`` or ``tp_ann_bwd``
    (either stream mode), as the kernel reported it, and the launch mode."""
    return dict(zip(_PLAN_KEYS, fused_tp.last_plans()[name]),
                launch_mode=LAUNCH_MODE)


def _check_width(mode: str, H: int, P: int, mxu_bf16: bool) -> None:
    """The kernels' limits: P <= 8, H/P a multiple of 8 and at most 2048,
    and the gathered rows of a cluster (one plane for the RNN, two for the
    backward's stacked exchanges) beside a stage of the slice in one
    block's shared memory."""
    if P > _MAX_RANKS:
        raise ValueError(f"the TP ANN kernels take at most {_MAX_RANKS} "
                         f"ranks, got {P}")
    if H % P or (H // P) % _COL_UNIT:
        raise ValueError(f"the TP ANN kernels take H/P a multiple of "
                         f"{_COL_UNIT}, got H={H}, P={P}")
    if H // P > _MAX_HL:
        raise ValueError(f"the TP ANN kernels take H/P <= {_MAX_HL}, got "
                         f"{H // P}")
    n = _MODES[mode]["n_wx"]
    _tp_plan(1, H, P, n, mxu_bf16, 1, lambda c: P)
    _tp_plan(1, H, P, n, mxu_bf16, _MODES[mode]["bwd_stack"], lambda c: P,
             _MODES[mode]["bwd_operands"])


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def tp_ann_cell_plain(mode: str, wxs, vs, y0, *, num_devices: int,
                      save_residuals: bool = False, mxu_bf16: bool = False):
    """Plain version of ``csrc/tp_ann_fwd.cu``: the TPU ``_tp_ann_fwd_kernel``'s
    per-step arithmetic as a loop over T and over the P column blocks.
    ``wxs``/``vs`` are lists by gate; each rank's products take the gathered
    state (the GRU's candidate the gathered r*y). Returns the output
    (B, T, H), and with ``save_residuals`` ``(out, gates)``: the gate series
    the backward reads (LiGRU z, c; GRU z, r, c).

    ``mxu_bf16``: the output and the gate series come back bf16, the
    matrices are rounded to bf16, each ``wx`` (float32 or bf16) is promoted
    on load, and every gathered left operand (y0, y, r*y) is rounded to
    bf16, as the bf16 wire carries it; the carried ``y`` stays float32."""
    B, T, H = wxs[0].shape
    sl = _shards(H, num_devices)
    # float64 matrices (the witness of a whole model) lift the arithmetic
    work = torch.promote_types(_work_dtype(wxs[0]), vs[0].dtype)
    vs = [(_rb(v) if mxu_bf16 else v).to(work) for v in vs]

    def gather(blocks):
        """The rank blocks side by side, as the wire carries them."""
        full = torch.cat(blocks, dim=1)
        return _rb(full) if mxu_bf16 else full

    y = [y0.to(work)[:, c] for c in sl]
    y_full = gather(y)
    out = torch.empty((B, T, H), dtype=_stream_dtype(mxu_bf16, wxs[0]),
                      device=wxs[0].device)
    gates = tuple(torch.empty_like(out) for _ in _MODES[mode]["gates"]) \
        if save_residuals else ()
    for t in range(T):
        d = [w[:, t].to(work) for w in wxs]
        if mode == "gru":
            zv = _rank_columns(y_full, vs[1], sl)
            rv = _rank_columns(y_full, vs[2], sl)
            z = [torch.sigmoid(d[1][:, c] + zv[k]) for k, c in enumerate(sl)]
            r = [torch.sigmoid(d[2][:, c] + rv[k]) for k, c in enumerate(sl)]
            cv = _rank_columns(gather([rk * yk for rk, yk in zip(r, y)]),
                               vs[0], sl)
        else:
            cv = _rank_columns(y_full, vs[0], sl)
            if mode == "ligru":
                zv = _rank_columns(y_full, vs[1], sl)
        for k, c in enumerate(sl):
            if mode == "rnn":
                y[k] = torch.sigmoid(d[0][:, c] + cv[k])
                vals = ()
            elif mode == "ligru":
                zk = torch.sigmoid(d[1][:, c] + zv[k])
                ck = torch.relu(d[0][:, c] + cv[k])
                y[k] = zk * y[k] + (1.0 - zk) * ck
                vals = (zk, ck)
            else:
                ck = torch.tanh(d[0][:, c] + cv[k])
                y[k] = z[k] * y[k] + (1.0 - z[k]) * ck
                vals = (z[k], r[k], ck)
            out[:, t, c] = y[k]
            for series, val in zip(gates, vals):
                series[:, t, c] = val
        if t + 1 < T:  # the gather of the last step feeds nothing
            y_full = gather(y)
    return (out, gates) if save_residuals else out


def tp_ann_cell_bwd_plain(mode: str, g, y_seq, gates, vs, y0, *,
                          num_devices: int, mxu_bf16: bool = False):
    """Plain version of ``csrc/tp_ann_bwd.cu``: the TPU
    ``_tp_ann_bwd_kernel``'s adjoint recurrence as a loop over reversed T and
    over the P blocks (the equations of ``fused_ann.ann_cell_bwd_plain``, no
    affine, no dropout). Per step each rank computes its dpre blocks, the
    blocks are gathered, and rank r's products are its columns of
    ``x_full @ V^T`` (``x_full @ V[shard_r, :]^T``); the GRU's dry feeds
    drpre before the second gather. dV after the loop, over the stored
    series. Returns ``(dwxs, dvs, dy0)``, lists by gate.

    ``mxu_bf16``: ``g`` and the series arrive bf16 and are read up to
    float32, the matrices are rounded to bf16, each gathered dpre is rounded
    to bf16 (the wire): the products take it, and ``dWx`` is it as a bf16
    stream, which ``dV`` takes with its left operand (``y0``, ``r*y_p``)
    rounded too; the adjoint, ``dV`` and ``dy0`` stay float32."""
    B, T, H = g.shape
    n = _MODES[mode]["n_wx"]
    sl = _shards(H, num_devices)
    work = torch.promote_types(_work_dtype(y0), vs[0].dtype)
    vs = [(_rb(v) if mxu_bf16 else v).to(work) for v in vs]
    y0 = y0.to(work)
    D = [torch.zeros_like(y0[:, c]) for c in sl]
    # dpre as the wire carries it, the right operand of dV
    dpres = [torch.empty((B, T, H), dtype=work, device=g.device)
             for _ in range(n)]

    def gather(blocks):
        full = torch.cat(blocks, dim=1)
        return _rb(full) if mxu_bf16 else full

    def rows_t(x_full, i):
        """Each rank's columns of ``x_full @ vs[i]^T``."""
        return _rank_columns(x_full, vs[i].t(), sl)

    for t in range(T - 1, -1, -1):
        y_p = y_seq[:, t - 1].to(work) if t > 0 else y0
        Gs = [g[:, t, c].to(work) + D[k] for k, c in enumerate(sl)]
        if mode == "rnn":
            y_t = y_seq[:, t].to(work)
            dp = [Gs[k] * y_t[:, c] * (1.0 - y_t[:, c])
                  for k, c in enumerate(sl)]
            step = (gather(dp),)
            D = rows_t(step[0], 0)
        else:
            z, c_ = gates[0][:, t].to(work), gates[-1][:, t].to(work)
            dz = [Gs[k] * (y_p[:, c] - c_[:, c]) * z[:, c] * (1.0 - z[:, c])
                  for k, c in enumerate(sl)]
            if mode == "ligru":
                dc = [torch.where(c_[:, c] > 0, Gs[k] * (1.0 - z[:, c]),
                                  torch.zeros_like(Gs[k]))
                      for k, c in enumerate(sl)]
                step = (gather(dc), gather(dz))
                cterm, zterm = rows_t(step[0], 0), rows_t(step[1], 1)
                D = [Gs[k] * z[:, c] + cterm[k] + zterm[k]
                     for k, c in enumerate(sl)]
            else:
                r = gates[1][:, t].to(work)
                dc = [Gs[k] * (1.0 - z[:, c]) * (1.0 - c_[:, c] * c_[:, c])
                      for k, c in enumerate(sl)]
                dc_full = gather(dc)
                dry = rows_t(dc_full, 0)
                dr = [dry[k] * y_p[:, c] * r[:, c] * (1.0 - r[:, c])
                      for k, c in enumerate(sl)]
                step = (dc_full, gather(dz), gather(dr))
                zterm, rterm = rows_t(step[1], 1), rows_t(step[2], 2)
                D = [Gs[k] * z[:, c] + dry[k] * r[:, c] + zterm[k] + rterm[k]
                     for k, c in enumerate(sl)]
        for i, dpre in enumerate(step):
            dpres[i][:, t] = dpre
    y_prev = torch.cat([y0[:, None], y_seq[:, :-1].to(work)], dim=1)
    dvs = []
    for i, dpre in enumerate(dpres):
        left = gates[1].to(work) * y_prev if (mode == "gru" and i == 0) \
            else y_prev
        if mxu_bf16:
            left = _rb(left)
        dvs.append(torch.matmul(left.reshape(-1, H).t(),
                                dpre.reshape(-1, H)))
    sdt = _stream_dtype(mxu_bf16, y0)
    return [d.to(sdt) for d in dpres], dvs, torch.cat(D, dim=1)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _check_operands(mode, wxs, vs, y0, P, mxu_bf16, wx_dtype=torch.float32):
    """``wx_dtype``: the type(s) the input streams may have; they must all
    have the same one. The kernels take any B and any H/P that is a
    multiple of 8 within ``_check_width``; the entry points hold the
    operands to the JAX package's checks besides."""
    n = _MODES[mode]["n_wx"]
    B, T, H = wxs[0].shape
    dev = wxs[0].device
    _check_width(mode, H, P, mxu_bf16)
    if len(wxs) != n or len(vs) != n:
        raise ValueError(f"{mode}: want {n} input streams and {n} matrices")
    for i, (w, v) in enumerate(zip(wxs, vs)):
        _check(f"wx[{i}]", w, (B, T, H), dev, wx_dtype)
        _check(f"V[{i}]", v, (H, H), dev)
    if len({w.dtype for w in wxs}) != 1:
        raise ValueError(f"{mode}: the input streams differ in type")
    _check("y0", y0, (B, H), dev)


def _pack_slices(vs, passes, plan: fused_ann.ClusterPlan, P: int,
                 mxu_bf16: bool, transpose: bool = False) -> torch.Tensor:
    """Every block's slice of every rank's column blocks of the matrices
    (``transpose``: of their transposes, the backward's V^T), ``(P,
    cluster, gates*H*cols)``: rank r's blocks ``V[:, shard_r]`` laid out by
    ``fused_ann._pack_slices`` for the rank's plan, pass after pass, so
    that a block copies its slice as one contiguous piece; in the bf16 mode
    rounded to bf16 once here."""
    mats = [v.t() for v in vs] if transpose else list(vs)
    return torch.stack([
        fused_ann._pack_slices([m[:, c] for m in mats], passes, plan,
                               mxu_bf16)
        for c in _shards(mats[0].shape[0], P)]).contiguous()


def _tp_ann_cell_cuda(mode: str, wxs, vs, y0, *, num_devices: int,
                      save_residuals: bool = False, mxu_bf16: bool = False):
    """Launch ``csrc/tp_ann_fwd.cu`` over all P ranks (the one-card form)
    in the float32 or the bf16 stream mode. Same contract as
    ``tp_ann_cell_plain``."""
    P = num_devices
    _check_operands(mode, wxs, vs, y0, P, mxu_bf16, _wx_dtypes(mxu_bf16))
    B, T, H = wxs[0].shape
    dev = wxs[0].device
    sdt = _BF16 if mxu_bf16 else torch.float32
    out = torch.empty(wxs[0].shape, dtype=sdt, device=dev)
    names = _MODES[mode]["gates"] if save_residuals else ()
    series = {k: torch.empty_like(out) for k in names}
    plan = launch_plan(mode, B, H, P, mxu_bf16, False, dev).rank
    packed = _pack_slices(vs, fused_ann._FWD_PASSES[mode], plan, P, mxu_bf16)
    bufs = fused_tp._exchange_buffers((2, B, H), sdt, P, plan.clusters, dev)
    fused_tp._launch(TP_ANN_FWD_BF16 if mxu_bf16 else TP_ANN_FWD, dev,
                     *fused_ann._three(wxs), _ptr(packed), _ptr(y0),
                     _ptr(out), _ptr(series.get("z")), _ptr(series.get("r")),
                     _ptr(series.get("c")), bufs[2], bufs[3], B, T, H, P, 0,
                     P, H, fused_ann._MODE_ID[mode], int(mxu_bf16),
                     int(wxs[0].dtype == _BF16), plan.cluster, plan.rows,
                     int(plan.resident), n_plan=len(_PLAN_KEYS))
    return (out, tuple(series.values())) if save_residuals else out


def _tp_ann_cell_bwd_cuda(mode: str, g, y_seq, gates, vs, y0, *,
                          num_devices: int, mxu_bf16: bool = False,
                          split_ms=None):
    """Launch ``csrc/tp_ann_bwd.cu`` over all P ranks (the one-card form)
    in the float32 or the bf16 stream mode. Same contract as
    ``tp_ann_cell_bwd_plain``. ``split_ms`` (a list, for timing only)
    receives the milliseconds of the time loop, the dV product and its
    second pass, CUDA events around each launch; the call then waits for
    the card."""
    P = num_devices
    n = _MODES[mode]["n_wx"]
    sdt = _BF16 if mxu_bf16 else torch.float32
    _check_operands(mode, [g] * n, vs, y0, P, mxu_bf16, sdt)
    B, T, H = g.shape
    dev = g.device
    _check("y_seq", y_seq, (B, T, H), dev, sdt)
    if len(gates) != len(_MODES[mode]["gates"]):
        raise ValueError(f"{mode}: want the series {_MODES[mode]['gates']}")
    for name, t in zip(_MODES[mode]["gates"], gates):
        _check(name, t, (B, T, H), dev, sdt)
    series = dict(zip(_MODES[mode]["gates"], gates))
    ksplit = fused_ann._dv_split(B, T, H, n)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dwxs = [torch.empty_like(g) for _ in range(n)]
    dvs, dy0 = new(n, H, H), new(B, H)
    dv_partials = new(ksplit, n, H, H) if ksplit > 1 else None
    plan = launch_plan(mode, B, H, P, mxu_bf16, True, dev).rank
    # the rank's columns of V^T (V[shard, :]^T), by gate
    packed = _pack_slices(vs, fused_ann._BWD_PASSES[mode], plan, P,
                          mxu_bf16, transpose=True)
    width = _MODES[mode]["bwd_stack"] * H
    bufs = fused_tp._exchange_buffers((2, B, width), sdt, P, plan.clusters,
                                      dev)
    split = (ctypes.c_float * 3)() if split_ms is not None else None
    fused_tp._launch(TP_ANN_BWD_BF16 if mxu_bf16 else TP_ANN_BWD, dev,
                     _ptr(g), _ptr(y_seq), _ptr(series.get("z")),
                     _ptr(series.get("r")), _ptr(series.get("c")),
                     _ptr(packed), _ptr(y0), *fused_ann._three(dwxs),
                     _ptr(dvs), _ptr(dv_partials), _ptr(dy0), bufs[2],
                     bufs[3], B, T, H, P, 0, P, H, fused_ann._MODE_ID[mode],
                     ksplit, fused_ann._card_dv_tile(H, n, ksplit, dev),
                     int(mxu_bf16),
                     plan.cluster, plan.rows,
                     int(plan.resident), split, n_plan=len(_PLAN_KEYS))
    if split is not None:
        split_ms[:] = list(split)
    return dwxs, list(dvs.unbind(0)), dy0


class _TPANN(torch.autograd.Function):
    """The TP cell (JAX ``_get_tp_ann_op``). ``ops`` are the input streams,
    then the recurrent matrices, by gate."""

    @staticmethod
    def forward(ctx, mode, num_devices, mxu_bf16, y0, *ops):
        n = _MODES[mode]["n_wx"]
        wxs, vs = list(ops[:n]), list(ops[n:])
        fwd = fused_cells._by_device(wxs[0], tp_ann_cell_plain,
                                     _tp_ann_cell_cuda, "TP ANN cell")
        flags = dict(num_devices=num_devices, mxu_bf16=mxu_bf16)
        if not any(ctx.needs_input_grad):
            return fwd(mode, wxs, vs, y0, **flags)
        out, gates = fwd(mode, wxs, vs, y0, save_residuals=True, **flags)
        ctx.mode, ctx.flags, ctx.wx_dtype = mode, flags, wxs[0].dtype
        ctx.save_for_backward(out, y0, *gates, *vs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mode = ctx.mode
        out, y0, *rest = ctx.saved_tensors
        n_gates = len(_MODES[mode]["gates"])
        gates, vs = rest[:n_gates], rest[n_gates:]
        bwd = fused_cells._by_device(g, tp_ann_cell_bwd_plain,
                                     _tp_ann_cell_bwd_cuda,
                                     "TP ANN cell backward")
        # the cotangent often arrives as a view (the bidirectional split)
        dwxs, dvs, dy0 = bwd(mode, g.contiguous(), out, gates, vs, y0,
                             **ctx.flags)
        # the bf16 mode's dWx streams go back up where the streams arrived
        # float32
        dwxs = [d.to(ctx.wx_dtype) for d in dwxs]
        return (None, None, None, dy0, *dwxs, *dvs)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _tp_ann(mode, wxs, vs, y0, mesh, tp_axis, mxu_bf16):
    P = fused_tp._tp_size(mesh, tp_axis, wxs[0])
    B, _, H = wxs[0].shape
    fused_tp._validate(B, H, P)
    # the carried state is float32 (float64 with float64 streams)
    y0 = y0.to(_work_dtype(wxs[0]))
    return _TPANN.apply(mode, P, bool(mxu_bf16), y0, *wxs, *vs)


def rnn_tp(Wx, V, y0, *, mesh, tp_axis="model", mxu_bf16: bool = False):
    """Tensor-parallel fused sigmoid-RNN over the mesh's TP axis (JAX
    ``rnn_tp_sharded``; semantics ``cells.rnn_scan``)."""
    return _tp_ann("rnn", [Wx], [V], y0, mesh, tp_axis, mxu_bf16)


def ligru_tp(Wx, Wzx, V, Vz, y0, *, mesh, tp_axis="model",
             mxu_bf16: bool = False):
    """Tensor-parallel fused LiGRU over the mesh's TP axis (JAX
    ``ligru_tp_sharded``; semantics ``cells.ligru_scan``)."""
    return _tp_ann("ligru", [Wx, Wzx], [V, Vz], y0, mesh, tp_axis, mxu_bf16)


def gru_tp(Wx, Wzx, Wrx, V, Vz, Vr, y0, *, mesh, tp_axis="model",
           mxu_bf16: bool = False):
    """Tensor-parallel fused GRU over the mesh's TP axis (JAX
    ``gru_tp_sharded``; semantics ``cells.gru_scan``)."""
    return _tp_ann("gru", [Wx, Wzx, Wrx], [V, Vz, Vr], y0, mesh, tp_axis,
                   mxu_bf16)
