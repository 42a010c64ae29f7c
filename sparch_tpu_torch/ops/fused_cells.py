"""Fused spiking cells and readout (counterpart of
sparch_tpu/ops/pallas_cells.py), forward and backward.

Each entry point clamps its neuron constants and masks the diagonal of V
with ordinary torch ops (so autograd pulls the gradients back through the
clamps and the mask), then runs a ``torch.autograd.Function`` that
dispatches on the device of ``Wx``:

- a CPU tensor runs the plain PyTorch versions (``fused_cell_plain``,
  ``fused_cell_bwd_plain``, ``readout_plain``, ``readout_bwd_plain``): the
  per-step arithmetic of the kernels as loops over T;
- a CUDA tensor launches the hand-written kernels of ``csrc/``
  (``fused_cell_fwd.cu``, ``fused_cell_bwd.cu``, ``readout_fwd.cu``,
  ``readout_bwd.cu``) and nothing else: a kernel that cannot launch raises;
- any other device raises.

The readout kernels launch on a plan of rows, warps and T chunk a block
(``_readout_plan`` over the card's SMs, checked in C); the backward is one
launch. They take any class count: past ``_LANE_C`` classes (the widest
row their lane layout holds) they run their wide forms, a block a row.

Without a gradient to compute (eval, serving, ``torch.no_grad``) the
forward saves nothing. With one it also writes the membrane series ``u``,
the only full-length residual: the backward recomputes the spikes as
``u > threshold``, regenerates the dropout mask from the seed, and needs
no ``w`` series (see ``fused_cell_bwd_plain``).

Output dropout is a counter hash of (seed, batch tile, row in the tile,
column, timestep) (``random_keep_plain``, ``csrc/dropout_hash.cuh``), the
hash branch of the JAX ``_random_keep``. The batch tile is the port's own
convention: ``dropout_tile_rows(B)`` rows, the largest of 128, 64, 32, 16, 8
that divides B rounded up to a multiple of 8. The JAX kernel picks the same
tile unless its VMEM plan shrinks it (very wide layers), so at every other
size the masks of the two packages are equal bit for bit.

The bf16-stream mode (``mxu_bf16=True``, the JAX kernels' mode of that
name): the spike output, the cotangent and ``dWx`` are bf16 streams, ``V``
is rounded to bf16 once, ``Wx`` keeps the type it arrives in (float32, or
bf16 where the projection emitted bf16) and is promoted on load, and every
operand of a product is rounded to bf16 where the JAX kernel rounds it; the
membrane series, all state, all elementwise arithmetic and every reduced
gradient stay float32. LIF and adLIF have no product, so only their
streams change. The readout has no such mode. Each gradient comes back in
its operand's type.

``launch_counts()`` counts kernel launches by entry point, the bf16 forms
under names of their own (``fused_cell_fwd_bf16``, ...), so a run can show
which kernels it went through.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from sparch_tpu_torch._build import Kernel
from sparch_tpu_torch.ops import cells

__all__ = [
    "FUSED_CELL_FWD",
    "FUSED_CELL_FWD_TRAIN",
    "FUSED_CELL_BWD",
    "FUSED_CELL_FWD_BF16",
    "FUSED_CELL_FWD_TRAIN_BF16",
    "FUSED_CELL_BWD_BF16",
    "READOUT_FWD",
    "READOUT_BWD",
    "launch_counts",
    "reset_launch_counts",
    "last_plans",
    "clip_and_mask",
    "keep_u32",
    "dropout_tile_rows",
    "random_keep_plain",
    "fused_cell_plain",
    "fused_cell_bwd_plain",
    "readout_plain",
    "readout_bwd_plain",
    "lif_fused",
    "adlif_fused",
    "rlif_fused",
    "radlif_fused",
    "readout_fused",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
# both entry points end in the column-slice layout's plan, first product,
# exchange buffers and split (csrc/spike_slices.cuh)
_FWD_ARGS = [_P] * 12 + [_I] * 3 + [_F] + [_I] * 5 + [_P] * 5
_FWD_TRAIN_ARGS = ([_P] * 14 + [_I] * 3 + [_F] + [_I] * 3 + [_U, _F, _I]
                   + [_I] * 2 + [_P] * 5)
_BWD_ARGS = ([_P] * 22 + [_I] * 3 + [_F] + [_I] * 3 + [_U, _F, _I]
             + [_I] * 8 + [_P, _P])
# one C entry point per form serves both stream modes; the modes are
# counted apart
FUSED_CELL_FWD = Kernel(
    "fused_cell_fwd", "sparch_fused_cell_fwd", _FWD_ARGS)
FUSED_CELL_FWD_BF16 = Kernel(
    "fused_cell_fwd", "sparch_fused_cell_fwd", _FWD_ARGS,
    name="fused_cell_fwd_bf16")
FUSED_CELL_FWD_TRAIN = Kernel(
    "fused_cell_fwd", "sparch_fused_cell_fwd_train", _FWD_TRAIN_ARGS,
    name="fused_cell_fwd_train")
FUSED_CELL_FWD_TRAIN_BF16 = Kernel(
    "fused_cell_fwd", "sparch_fused_cell_fwd_train", _FWD_TRAIN_ARGS,
    name="fused_cell_fwd_train_bf16")
FUSED_CELL_BWD = Kernel(
    "fused_cell_bwd", "sparch_fused_cell_bwd", _BWD_ARGS)
FUSED_CELL_BWD_BF16 = Kernel(
    "fused_cell_bwd", "sparch_fused_cell_bwd", _BWD_ARGS,
    name="fused_cell_bwd_bf16")
# the readout pair ends in its plan (rows, warps, T chunk) and the stream
READOUT_FWD = Kernel(
    "readout_fwd", "sparch_readout_fwd", [_P] * 5 + [_I] * 6 + [_P]
)
READOUT_BWD = Kernel(
    "readout_bwd", "sparch_readout_bwd", [_P] * 8 + [_I] * 6 + [_P]
)
_KERNELS = (FUSED_CELL_FWD, FUSED_CELL_FWD_TRAIN, FUSED_CELL_BWD,
            READOUT_FWD, READOUT_BWD, FUSED_CELL_FWD_BF16,
            FUSED_CELL_FWD_TRAIN_BF16, FUSED_CELL_BWD_BF16)
# widest layer the kernels take (csrc/*.cu kMaxThreads * kMaxNpt), and the
# widest row of classes the readout kernels' lane layout holds, past which
# they run their wide forms (csrc/readout.cuh 32 * kMaxVpl)
_MAX_H = 4096
_LANE_C = 256
# csrc/fused_cell_bwd.cu: partials of the parameter gradients of two rows
# up to this width (else one), and the most columns of a slice of six
# blocks before the cluster takes eight
_PAIR_H = 512
_MAX_SIX_COLS = 512
_PLANS: Dict[str, dict] = {}


def _all_kernels():
    # ops.fused_ann, ops.fused_tp and ops.fused_tp_ann import this module,
    # so they are looked up at call time
    from sparch_tpu_torch.ops import fused_ann, fused_tp, fused_tp_ann

    return (_KERNELS + fused_ann.KERNELS + fused_tp.KERNELS
            + fused_tp_ann.KERNELS)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by entry point: the spiking kernels of this
    module, the ANN kernels of ``ops.fused_ann`` and the tensor-parallel
    kernels of ``ops.fused_tp`` and ``ops.fused_tp_ann``."""
    return {k.name: k.launches for k in _all_kernels()}


def reset_launch_counts() -> None:
    for k in _all_kernels():
        k.launches = 0


def last_plans() -> Dict[str, dict]:
    """The plan of the last launch of ``fused_cell_fwd`` (any form, either
    stream mode): ``FwdPlan``'s fields; and of ``fused_cell_bwd``: the time
    loop's cluster plan (recurrent forms), the partials of the parameter
    gradients and the split of the dV product."""
    return dict(_PLANS)


def _check(name: str, t: torch.Tensor, shape, device,
           dtype=torch.float32) -> None:
    """``dtype`` is one type or a tuple of the types the kernel takes."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device or t.dtype not in dtypes:
        want = " or ".join(str(d) for d in dtypes)
        raise ValueError(
            f"{name}: want {want} on {device}, got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {tuple(shape)} tensor, got "
            f"{tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# The two stream modes
# ---------------------------------------------------------------------------

_BF16 = torch.bfloat16


def _rb(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 (ties to even), in its own type:
    the value a bf16 operand of a product carries."""
    return x.to(_BF16).to(x.dtype)


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """The type of the state and the arithmetic for an input stream ``x``:
    float32 for a bf16 stream, else the stream's own."""
    return torch.float32 if x.dtype == _BF16 else x.dtype


def _stream_dtype(mxu_bf16: bool, x: torch.Tensor) -> torch.dtype:
    """The type of the output streams: bf16 in the bf16-stream mode, else
    the working type. A float64 call in the bf16 mode (the plain versions
    only) is the witness of that mode: it rounds the operands of the
    products where the mode rounds them and keeps its outputs float64."""
    work = _work_dtype(x)
    return _BF16 if (mxu_bf16 and work != torch.float64) else work


def _wx_dtypes(mxu_bf16: bool):
    """The types a kernel takes for an input stream in a mode."""
    return (torch.float32, _BF16) if mxu_bf16 else torch.float32


# ---------------------------------------------------------------------------
# Dropout hash
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def keep_u32(drop_rate: float) -> int:
    """uint32 threshold such that P(bits < threshold) = 1 - drop_rate."""
    return min(2**32 - 1, int(round((1.0 - drop_rate) * 2**32)))


def dropout_tile_rows(B: int) -> int:
    """Rows of one batch tile of the dropout hash: the largest of 128, 64,
    32, 16, 8 that divides B rounded up to a multiple of 8."""
    Bp = -(-B // 8) * 8
    return next(c for c in (128, 64, 32, 16, 8) if Bp % c == 0)


def _hash_keep(r, c, seed, t, tile_i, keep):
    """The uint32 index hash, carried in int64 with the low 32 bits masked
    after every product (int64 wraps modulo 2^64, which keeps them)."""
    s0 = seed[0].to(torch.int64) & _M32
    s1 = seed[1].to(torch.int64) & _M32
    z = (r * 0x9E3779B1 + c * 0x85EBCA77 + s0 * 0xC2B2AE3D + s1
         + t * 0x27D4EB2F + tile_i * 0x165667B1) & _M32
    z = z ^ (z >> 16)
    z = (z * 0x7FEB352D) & _M32
    z = z ^ (z >> 15)
    z = (z * 0x846CA68B) & _M32
    z = z ^ (z >> 16)
    return z < keep


def random_keep_plain(shape, seed, tile_i: int, t: int, keep: int):
    """Plain version of ``csrc/dropout_hash.cuh``: the keep mask of one
    ``(rows, H)`` batch tile at timestep ``t`` (0-based). ``seed`` is an
    int32 tensor of two; ``keep`` is ``keep_u32(drop_rate)``. Equals the
    hash branch of the JAX ``_random_keep`` bit for bit."""
    dev = seed.device
    r = torch.arange(shape[0], device=dev)[:, None]
    c = torch.arange(shape[1], device=dev)[None, :]
    return _hash_keep(r, c, seed, t, tile_i, keep)


def _keep_rows(B: int, H: int, seed, t: int, keep: int):
    """The keep mask of all B rows at timestep ``t``: row ``b`` is row
    ``b % tile_rows`` of tile ``b // tile_rows``."""
    dev = seed.device
    rows = torch.arange(B, device=dev)[:, None]
    tr = dropout_tile_rows(B)
    c = torch.arange(H, device=dev)[None, :]
    return _hash_keep(rows % tr, c, seed, t, rows // tr, keep)


def _inv_keep(drop_rate: float) -> float:
    # float32(1 / (1 - p)), the factor both packages multiply kept values by
    return float(torch.tensor(1.0 / (1.0 - drop_rate), dtype=torch.float32))


def _as_seed(drop_seed, device) -> torch.Tensor:
    if drop_seed is None:
        return torch.zeros(2, dtype=torch.int32, device=device)
    seed = torch.as_tensor(drop_seed, dtype=torch.int32, device=device)
    if seed.shape != (2,):
        raise ValueError(f"drop_seed: want two int32, got {tuple(seed.shape)}")
    return seed.contiguous()


# ---------------------------------------------------------------------------
# Spiking cell: plain versions
# ---------------------------------------------------------------------------


def _first_product(s0, V):
    """``s0 @ V`` summed over k in ascending order, product then sum, as
    the kernel takes it: s0 need not be 0/1 (a uniform state init), so
    unlike the later products this one is not exact in any order."""
    sV = torch.zeros_like(s0)
    for k in range(V.shape[0]):
        sV = sV + s0[:, k:k + 1] * V[k]
    return sV


def fused_cell_plain(Wx, scale, shift, alpha, beta, a, b, V, threshold,
                     u0, w0, s0, *, recurrent: bool, adaptive: bool,
                     drop_rate: float = 0.0, seed=None,
                     save_residuals: bool = False, mxu_bf16: bool = False):
    """Plain PyTorch version of ``csrc/fused_cell_fwd.cu``: the TPU
    ``_fwd_kernel``'s per-step arithmetic as a loop over T. Params must
    already be clamped (and V zero-diagonal); ``scale``/``shift`` None
    means no affine. With ``drop_rate > 0`` the raw spike stays in the
    recurrence and only the stored output is dropped. Returns the spikes
    (B,T,H), and with ``save_residuals`` also the membrane series.

    ``mxu_bf16``: the spikes come back bf16 (a kept value under dropout is
    ``bf16(s/(1-p))``), ``V`` is rounded to bf16, ``Wx`` (float32 or bf16)
    is promoted on load, and the first product rounds ``s0`` for the
    product only; the membrane series and the state stay float32."""
    B, T, H = Wx.shape
    work = _work_dtype(Wx)
    u, s = u0, s0
    w = w0
    if recurrent and mxu_bf16:
        V = _rb(V)
    sV = None
    if recurrent:
        # the state keeps the float32 s0
        sV = _first_product(_rb(s) if mxu_bf16 else s, V)
    out = torch.empty(Wx.shape, dtype=_stream_dtype(mxu_bf16, Wx),
                      device=Wx.device)
    u_seq = torch.empty(Wx.shape, dtype=work, device=Wx.device) \
        if save_residuals else None
    if drop_rate > 0.0:
        keep, inv = keep_u32(drop_rate), _inv_keep(drop_rate)
    for t in range(T):
        drive = Wx[:, t].to(work)
        if scale is not None:
            drive = scale * drive + shift
        if recurrent:
            drive = drive + sV
        if adaptive:
            w = beta * w + a * u + b * s
            drive = drive - w
        u = alpha * (u - s) + (1.0 - alpha) * drive
        s = (u > threshold).to(u.dtype)
        if recurrent:
            sV = torch.matmul(s, V)
        if drop_rate > 0.0:
            mask = _keep_rows(B, H, seed, t, keep)
            out[:, t] = torch.where(mask, s * inv, torch.zeros_like(s))
        else:
            out[:, t] = s
        if save_residuals:
            u_seq[:, t] = u
    return (out, u_seq) if save_residuals else out


def fused_cell_bwd_plain(g, Wx, u_seq, scale, alpha, beta, a, b, V,
                         threshold, u0, w0, s0, *, recurrent: bool,
                         adaptive: bool, drop_rate: float = 0.0, seed=None,
                         mxu_bf16: bool = False):
    """Plain PyTorch version of ``csrc/fused_cell_bwd.cu``: reverse-time
    BPTT with the boxcar surrogate, the adjoint recurrence of the TPU
    ``_bwd_kernel``. With A_t = dL/du_t, B_t = dL/dw_t and g_t the (masked)
    output cotangent, walking t = T..1:

        C_t = g_t - alpha*A_{t+1} + ((1-alpha)*A_{t+1}) @ V^T + b*B_{t+1}
        A_t = window(u_t - thr)*C_t + alpha*A_{t+1} + a*B_{t+1}
        B_t = beta*B_{t+1} - (1-alpha)*A_t

    The only series it reads is u: s_t = u_t > thr is recomputed, and
    dbeta = sum_t B_t*w_{t-1} is taken without the w series through
    P_t = B_t + beta*P_{t+1}, as w_0*P_1 + sum_t (a*u_{t-1} + b*s_{t-1})*P_{t+1}
    (the same sum with w_{t-1} written out and the order of summation
    exchanged). ``Wx`` is read only with the affine. Params must already be
    clamped and V zero-diagonal. Returns (dWx, dscale, dshift, dV, dalpha,
    dbeta, da, db, du0, dw0, ds0) with respect to those, None where the
    form has no such operand.

    ``mxu_bf16``: ``g`` arrives bf16 and is read up to float32, ``dWx``
    comes back bf16 (``bf16(dDrive*scale)``), ``V`` is rounded to bf16, and
    dDrive is rounded to bf16 where it enters the adjoint product and
    ``dV`` (whose other operand, ``s_{t-1}``, is rounded too: ``s0`` need
    not be 0/1); ``dscale`` and ``dshift`` sum the float32 dDrive, and
    everything else stays float32."""
    B, T, H = g.shape
    affine = scale is not None
    work = _work_dtype(u_seq)
    zeros = torch.zeros_like(u0)
    A, Bw, P, AV = zeros, zeros, zeros, zeros
    oma = 1.0 - alpha
    dWx = torch.empty(g.shape, dtype=_stream_dtype(mxu_bf16, u_seq),
                      device=g.device)
    dd_seq = torch.empty(g.shape, dtype=work, device=g.device) \
        if recurrent else None
    if recurrent and mxu_bf16:
        V = _rb(V)
    dal, dbe, daa, dbb, dsc, dsh = (zeros,) * 6
    if drop_rate > 0.0:
        keep, inv = keep_u32(drop_rate), _inv_keep(drop_rate)
    for t in range(T - 1, -1, -1):
        g_t = g[:, t].to(work)
        if drop_rate > 0.0:
            mask = _keep_rows(B, H, seed, t, keep)
            g_t = torch.where(mask, g_t * inv, torch.zeros_like(g_t))
        u_t = u_seq[:, t]
        u_p = u_seq[:, t - 1] if t > 0 else u0
        s_p = (u_p > threshold).to(u_p.dtype) if t > 0 else s0
        alphaA = alpha * A
        C = g_t - alphaA
        if recurrent:
            C = C + AV
        if adaptive:
            C = C + b * Bw
        wsub = u_t - threshold
        window = (wsub > -0.5) & (wsub <= 0.5)
        A = torch.where(window, C, torch.zeros_like(C)) + alphaA
        if adaptive:
            A = A + a * Bw
        dd = oma * A
        if recurrent:
            dd_in = _rb(dd) if mxu_bf16 else dd
            AV = torch.matmul(dd_in, V.t())
            dd_seq[:, t] = dd_in
        if affine:
            dsc = dsc + dd * Wx[:, t].to(work)
            dsh = dsh + dd
            dWx[:, t] = dd * scale
        else:
            dWx[:, t] = dd
        dal = dal + A * (u_p - s_p - u_t)
        if adaptive:
            Bw = beta * Bw - dd
            dbe = dbe + (a * u_p + b * s_p) * P
            P = Bw + beta * P
            daa = daa + Bw * u_p
            dbb = dbb + Bw * s_p
    dalpha = dal.sum(0) / oma
    dscale = dsc.sum(0) if affine else None
    dshift = dsh.sum(0) if affine else None
    dbeta = da = db = dw0 = dV = None
    du0 = alpha * A
    ds0 = -(alpha * A)
    if adaptive:
        dbeta = (dbe + w0 * P).sum(0)
        da, db = daa.sum(0), dbb.sum(0)
        du0 = du0 + a * Bw
        dw0 = beta * Bw
        ds0 = ds0 + b * Bw
    if recurrent:
        ds0 = ds0 + AV
        s_prev = torch.cat(
            [(_rb(s0) if mxu_bf16 else s0)[:, None],
             (u_seq[:, :-1] > threshold).to(work)], dim=1)
        dV = torch.matmul(s_prev.reshape(-1, H).t(), dd_seq.reshape(-1, H))
    return dWx, dscale, dshift, dV, dalpha, dbeta, da, db, du0, dw0, ds0


# ---------------------------------------------------------------------------
# Spiking cell: kernels
# ---------------------------------------------------------------------------


def _check_cell_operands(Wx, scale, alpha, beta, a, b, V, u0, w0, s0,
                         recurrent, adaptive, shift=None, wx_dtype=None):
    """``wx_dtype``: the type(s) ``Wx`` may have, or None where the caller
    has checked the stream it passes in ``Wx``'s place already."""
    B, T, H = Wx.shape
    dev = Wx.device
    if wx_dtype is not None:
        _check("Wx", Wx, (B, T, H), dev, wx_dtype)
    if H > _MAX_H:
        raise ValueError(f"the fused cell kernel takes H <= {_MAX_H}, got {H}")
    vecs = {"alpha": alpha}
    if scale is not None:
        vecs.update(scale=scale)
    if shift is not None:
        vecs.update(shift=shift)
    if adaptive:
        vecs.update(beta=beta, a=a, b=b)
    for name, t in vecs.items():
        _check(name, t, (H,), dev)
    states = {"u0": u0, "s0": s0, **({"w0": w0} if adaptive else {})}
    for name, t in states.items():
        _check(name, t, (B, H), dev)
    if recurrent:
        _check("V", V, (H, H), dev)


# csrc/spike_slices.cuh: threads of a block at most, the shared memory a
# block can ask for, batch rows of a first-product block
_SLICE_THREADS = 512
_SLICE_SMEM = 232448


class FwdPlan(NamedTuple):
    """The launch plan of a recurrent spiking forward (``csrc/fused_cell_fwd.cu``,
    ``csrc/tp_cell_fwd.cu``), from ``_fwd_plan``."""

    layout: str    # "slices": csrc/spike_slices.cuh; "rows": a block a row
    cols: int      # columns of a block's slice of a rank's block (padded)
    rows: int      # batch rows of a group
    n_res: int     # groups at work at once (blocks of each slice)
    n_groups: int
    slices: int    # slices of a rank
    threads: int   # of a block
    per_sm: int    # blocks an SM holds at this plan (0: not asked)
    walks: int     # groups a block walks, one after another


def _slice_lane(mxu_bf16: bool):
    """(columns a lane owns, rows a warp walks at most): ``Lane`` of
    ``csrc/spike_slices.cuh``."""
    return (2, 2) if mxu_bf16 else (1, 4)


def _slice_smem(H: int, cols: int, rows: int, threads: int,
                mxu_bf16: bool) -> int:
    """Dynamic shared memory of a slice block (``smem_bytes``): the slice
    and its zero row, two parities of the group's spike words, one list a
    warp of 4-byte entries."""
    e = 2 if mxu_bf16 else 4
    words = -(-H // 32)
    return (-(-(H + 1) * cols * e // 16) * 16 + -(-rows * words * 8 // 16) * 16
            + threads // 32 * ((H + 11) // 4 * 4) * 4)


def _fwd_plan(B: int, H: int, P: int, mxu_bf16: bool, sms: int,
              per_sm: Callable[[int, int, int], int]) -> Optional[FwdPlan]:
    """The column-slice plan of a recurrent spiking forward over P ranks of
    H/P columns (P = 1: the single-card kernel) on a card of ``sms`` SMs,
    whose kernel an SM holds ``per_sm(cols, rows, threads)`` blocks of; None
    where no slice of V fits in shared memory (the kernels then take their
    layout of one block a batch row and rank).

    A block holds ``cols`` columns of a rank's block (a multiple of 32, 64
    in the bf16 mode) of all H rows of V, and the neurons of those columns
    for ``rows`` batch rows; a warp owns a row's 32 (64) columns, so
    ``threads`` is 32 x warps a slice row x rows at a time (up to 512), and
    a warp walks at most ``_slice_lane`` rows. The launch holds the slices of
    all ranks times ``n_res`` groups at once; a block walks its groups. The
    plan takes the least work an SM and step (rows x cols x the blocks an SM
    runs x walks), then the fewest walks, the fewest blocks a group (the
    exchange), the most threads."""
    cpt, nr = _slice_lane(mxu_bf16)
    hl = H // P
    best, best_key = None, None
    for m in range(1, _SLICE_THREADS // 32 + 1):
        cols = 32 * cpt * m
        if cols - 32 * cpt >= hl or \
                _slice_smem(H, cols, 1, 32 * m, mxu_bf16) > _SLICE_SMEM:
            break
        slices = -(-hl // cols)
        per_group = P * slices
        q_max = _SLICE_THREADS // 32 // m
        for rows in range(1, min(B, q_max * nr) + 1):
            q = min(q_max, rows)
            threads = 32 * m * q
            if _slice_smem(H, cols, rows, threads, mxu_bf16) > _SLICE_SMEM:
                break
            held = per_sm(cols, rows, threads)
            n_res = min(-(-B // rows), held * sms // per_group)
            if n_res < 1:
                continue
            n_groups = -(-B // rows)
            walks = -(-n_groups // n_res)
            work = walks * -(-per_group * n_res // sms) * rows * cols
            key = (work, walks, per_group, -threads)
            if best_key is None or key < best_key:
                best_key = key
                best = FwdPlan("slices", cols, rows, n_res, n_groups, slices,
                               threads, held, walks)
    return best


def _rows_plan(B: int, H: int, P: int, threads: int, per_rank: int = 0,
               per_sm: int = 0) -> FwdPlan:
    """The layout of one block a batch row and rank, as a ``FwdPlan``
    (``per_rank``: blocks a rank, 0 for B)."""
    per_rank = per_rank or B
    return FwdPlan("rows", H // P, 1, per_rank, B, 1, threads, per_sm,
                   -(-B // per_rank))


@functools.lru_cache(maxsize=None)
def card_plan(source: str, form: tuple, B: int, H: int, P: int,
              mxu_bf16: bool, device_index: int) -> Optional[FwdPlan]:
    """``_fwd_plan`` on the card ``device_index`` for the kernel form
    ``form`` of ``source`` (``slice_blocks``' leading arguments), computed
    once a shape."""
    with torch.cuda.device(device_index):
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
        return _fwd_plan(B, H, P, mxu_bf16, sms,
                         lambda c, r, t: slice_blocks(source, *form, H, c, r,
                                                      t))


@functools.lru_cache(maxsize=None)
def slice_blocks(source: str, *form: int) -> int:
    """Blocks of the column-slice time loop of ``source`` (``fused_cell_fwd``:
    form adaptive, affine, resid, dropout, bf16; ``tp_cell_fwd``: adaptive,
    resid, bf16; then H, cols, rows, threads) that an SM of the current card
    holds, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; 0 where
    the plan cannot run."""
    from sparch_tpu_torch import _build

    fn = getattr(_build.load(source), f"sparch_{source}_slice_blocks")
    fn.argtypes = [_I] * len(form)
    fn.restype = _I
    return fn(*form)


def _slice_launch_args(plan: FwdPlan, B: int, H: int, dev):
    """What a slice launch takes beside the operands and the slot of the
    spike words: the plan array and the first product's buffer."""
    plan_arr = (ctypes.c_int * 5)(plan.cols, plan.rows, plan.n_res,
                                  plan.n_groups, plan.threads)
    sv0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    return plan_arr, sv0


def _fused_cell_cuda(Wx, scale, shift, alpha, beta, a, b, V, threshold,
                     u0, w0, s0, *, recurrent: bool, adaptive: bool,
                     drop_rate: float = 0.0, seed=None,
                     save_residuals: bool = False, mxu_bf16: bool = False,
                     split_ms=None):
    """Launch ``csrc/fused_cell_fwd.cu``: its serving entry point without
    dropout and residuals, else its training entry point, in the float32
    or the bf16 stream mode; the recurrent forms in the column-slice layout
    where ``_fwd_plan`` finds one. Same contract as ``fused_cell_plain``.
    ``split_ms`` (a list, for timing only; slice layout) receives the
    milliseconds of the first product and of the time loop, CUDA events
    around each launch; the call then waits for the card."""
    B, T, H = Wx.shape
    dev = Wx.device
    _check_cell_operands(Wx, scale, alpha, beta, a, b, V, u0, w0, s0,
                         recurrent, adaptive, shift=shift,
                         wx_dtype=_wx_dtypes(mxu_bf16))
    dropout = drop_rate > 0.0
    training_form = save_residuals or dropout
    if dropout:
        _check("seed", seed, (2,), dev, torch.int32)
    out = torch.empty(Wx.shape, dtype=_stream_dtype(mxu_bf16, Wx),
                      device=dev)
    u_seq = torch.empty(Wx.shape, dtype=torch.float32, device=dev) \
        if save_residuals else None
    if out.numel() == 0:
        return (out, u_seq) if save_residuals else out
    if not adaptive:
        beta = a = b = w0 = None
    if recurrent and mxu_bf16:
        V = V.to(_BF16)  # rounded once, as the JAX wrapper does
    affine = scale is not None
    mode = (int(mxu_bf16), int(Wx.dtype == _BF16))
    plan = None
    with torch.cuda.device(dev):
        if recurrent:
            form = (int(adaptive), int(affine), int(save_residuals),
                    int(dropout), int(mxu_bf16))
            plan = card_plan("fused_cell_fwd", form, B, H, 1, mxu_bf16,
                             torch.cuda.current_device())
        if plan is None:
            if split_ms is not None:
                raise ValueError("split_ms: the slice layout only")
            npt = 1
            while -(-H // npt) > 512:
                npt *= 2
            plan = _rows_plan(B, H, 1, -(-H // npt // 32) * 32)
            tail = (None,) * 4
        else:
            plan_arr, sv0 = _slice_launch_args(plan, B, H, dev)
            # the tagged spike words ([2][B][ceil(H/32)] u64; the first
            # product's launch zeroes them)
            slots = torch.empty((2, B, -(-H // 32)), dtype=torch.int64,
                                device=dev)
            split = (ctypes.c_float * 2)() if split_ms is not None else None
            tail = (ctypes.cast(plan_arr, ctypes.c_void_p), _ptr(sv0),
                    _ptr(slots),
                    ctypes.cast(split, ctypes.c_void_p) if split else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (_ptr(Wx), _ptr(scale), _ptr(shift), _ptr(alpha), _ptr(beta),
                _ptr(a), _ptr(b), _ptr(V) if recurrent else None, _ptr(u0),
                _ptr(w0), _ptr(s0), _ptr(out))
        shape = (B, T, H, float(threshold), int(recurrent), int(adaptive),
                 int(affine))
        if training_form:
            launch = FUSED_CELL_FWD_TRAIN_BF16 if mxu_bf16 \
                else FUSED_CELL_FWD_TRAIN
            launch(
                *head, _ptr(u_seq), _ptr(seed) if dropout else None, *shape,
                keep_u32(drop_rate) if dropout else 0,
                _inv_keep(drop_rate) if dropout else 1.0,
                dropout_tile_rows(B), *mode, *tail, stream,
            )
        else:
            launch = FUSED_CELL_FWD_BF16 if mxu_bf16 else FUSED_CELL_FWD
            launch(*head, *shape, *mode, *tail, stream)
    _PLANS["fused_cell_fwd"] = plan._asdict()
    if split_ms is not None:
        split_ms[:] = list(split)
    return (out, u_seq) if save_residuals else out


def _part_rows(H: int) -> int:
    """Rows summed into one partial of the parameter gradients: two at
    H <= 512, else one, the rows of a block of the kernel before the
    cluster split, so that the reduced gradients keep their bits."""
    return 2 if H <= _PAIR_H else 1


def _cluster_plan(B: int, H: int, mxu_bf16: bool = False):
    """The time loop's plan of the recurrent forms (``cluster_plan`` of
    ``csrc/fused_cell_bwd.cu``): ``csrc/cluster_slice.cuh``'s rule for one
    matrix (V^T) and one operand plane (dDrive), in clusters of up to six
    blocks, or of eight where a slice of six would pass 512 columns."""
    from sparch_tpu_torch.ops import fused_ann

    cols_at_six = -(-H // 6)
    cols_at_six = -(-cols_at_six // fused_ann._COL_ALIGN) * fused_ann._COL_ALIGN
    return fused_ann._cluster_plan(
        B, H, 1, mxu_bf16, 1,
        cluster=8 if cols_at_six > _MAX_SIX_COLS else None)


def _bwd_plan(B: int, T: int, H: int, recurrent: bool,
              mxu_bf16: bool = False):
    """(the time loop's cluster plan, None for the non-recurrent forms;
    partials of the parameter gradients; split of the dV product over
    B*T), the plan that ``csrc/fused_cell_bwd.cu`` checks its arguments
    against."""
    from sparch_tpu_torch.ops import fused_ann

    plan = _cluster_plan(B, H, mxu_bf16) if recurrent else None
    return plan, -(-B // _part_rows(H)), fused_ann._dv_split(B, T, H, 1)


def _fused_cell_bwd_cuda(g, Wx, u_seq, scale, alpha, beta, a, b, V,
                         threshold, u0, w0, s0, *, recurrent: bool,
                         adaptive: bool, drop_rate: float = 0.0, seed=None,
                         mxu_bf16: bool = False, split_ms=None):
    """Launch ``csrc/fused_cell_bwd.cu`` in the float32 or the bf16 stream
    mode. Same contract as ``fused_cell_bwd_plain``. ``split_ms`` (a list,
    for timing only) receives the milliseconds of the time loop, the dV
    product and the second passes, CUDA events around each launch; the call
    then waits for the card."""
    B, T, H = g.shape
    dev = g.device
    affine = scale is not None
    sdt = _BF16 if mxu_bf16 else torch.float32
    _check("g", g, (B, T, H), dev, sdt)
    _check("u_seq", u_seq, (B, T, H), dev)
    _check_cell_operands(Wx if affine else g, scale, alpha, beta, a, b, V,
                         u0, w0, s0, recurrent, adaptive,
                         wx_dtype=_wx_dtypes(mxu_bf16) if affine else None)
    dropout = drop_rate > 0.0
    if dropout:
        _check("seed", seed, (2,), dev, torch.int32)
    plan, n_parts, ksplit = _bwd_plan(B, T, H, recurrent, mxu_bf16)
    new = lambda *shape: torch.empty(  # noqa: E731
        shape, dtype=torch.float32, device=dev)
    dWx = torch.empty_like(g)
    # dDrive before the scale, the right operand of the dV product (in the
    # bf16 mode stored as the bf16 the product consumes)
    dd = torch.empty_like(g) if (affine and recurrent) else None
    partials = new(n_parts, 6, H)
    vecs = new(6, H)
    # every cluster block's slice of V^T (the rows of V for its neurons),
    # rounded to bf16 in that mode
    VT = None
    from sparch_tpu_torch.ops import fused_ann

    if recurrent:
        VT = fused_ann._pack_slices([V.t()], ((0,),), plan, mxu_bf16)
    dV = new(H, H) if recurrent else None
    dv_partials = new(ksplit, H, H) if recurrent and ksplit > 1 else None
    dv_tile = fused_ann._card_dv_tile(H, 1, ksplit, dev) if recurrent else 0
    du0, ds0 = new(B, H), new(B, H)
    dw0 = new(B, H) if adaptive else None
    if not adaptive:
        beta = a = b = w0 = None
    split = (ctypes.c_float * 3)() if split_ms is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch = FUSED_CELL_BWD_BF16 if mxu_bf16 else FUSED_CELL_BWD
        launch(
            _ptr(g), _ptr(Wx) if affine else None, _ptr(u_seq), _ptr(scale),
            _ptr(alpha), _ptr(beta), _ptr(a), _ptr(b), _ptr(VT), _ptr(u0),
            _ptr(w0), _ptr(s0), _ptr(seed) if dropout else None, _ptr(dWx),
            _ptr(dd), _ptr(partials), _ptr(vecs), _ptr(dV),
            _ptr(dv_partials), _ptr(du0), _ptr(dw0), _ptr(ds0),
            B, T, H, float(threshold), int(recurrent), int(adaptive),
            int(affine), keep_u32(drop_rate) if dropout else 0,
            _inv_keep(drop_rate) if dropout else 1.0, dropout_tile_rows(B),
            n_parts, ksplit, dv_tile, plan.cluster if plan else 0,
            plan.rows if plan else 0, int(plan.resident) if plan else 0,
            int(mxu_bf16), int(affine and Wx.dtype == _BF16), split, stream,
        )
    _PLANS["fused_cell_bwd"] = dict(
        (plan._asdict() if plan else {}), n_parts=n_parts, ksplit=ksplit,
        dv_tile=fused_ann._DV_TILES[dv_tile] if recurrent else None)
    if split is not None:
        split_ms[:] = list(split)
    dalpha, dbeta, da, db, dscale, dshift = vecs.unbind(0)
    if not adaptive:
        dbeta = da = db = None
    if not affine:
        dscale = dshift = None
    return dWx, dscale, dshift, dV, dalpha, dbeta, da, db, du0, dw0, ds0


def _by_device(t: torch.Tensor, plain, kernel, what: str):
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return kernel
    raise ValueError(f"no {what} for device {t.device}")


class _FusedCell(torch.autograd.Function):
    """The fused cell on clamped and masked operands (JAX ``_make_op``).
    A None operand (no affine, not adaptive, not recurrent) gets no
    gradient."""

    @staticmethod
    def forward(ctx, Wx, scale, shift, alpha, beta, a, b, V, u0, w0, s0,
                seed, threshold, recurrent, adaptive, drop_rate, mxu_bf16):
        fwd = _by_device(Wx, fused_cell_plain, _fused_cell_cuda,
                         "fused cell")
        flags = dict(recurrent=recurrent, adaptive=adaptive,
                     drop_rate=drop_rate, seed=seed, mxu_bf16=mxu_bf16)
        args = (Wx, scale, shift, alpha, beta, a, b, V, threshold, u0, w0,
                s0)
        if not any(ctx.needs_input_grad):
            return fwd(*args, **flags)
        out, u_seq = fwd(*args, save_residuals=True, **flags)
        ctx.flags = dict(flags, threshold=threshold)
        ctx.wx_dtype = Wx.dtype
        ctx.save_for_backward(Wx if scale is not None else None, u_seq,
                              scale, alpha, beta, a, b, V, u0, w0, s0, seed)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (Wx, u_seq, scale, alpha, beta, a, b, V, u0, w0, s0,
         seed) = ctx.saved_tensors
        flags = dict(ctx.flags)
        threshold = flags.pop("threshold")
        flags["seed"] = seed
        bwd = _by_device(g, fused_cell_bwd_plain, _fused_cell_bwd_cuda,
                         "fused cell backward")
        # the cotangent often arrives as a view (the bidirectional split, a
        # broadcast from the firing-rate mean)
        (dWx, dscale, dshift, dV, dalpha, dbeta, da, db, du0, dw0,
         ds0) = bwd(g.contiguous(), Wx, u_seq, scale, alpha, beta, a, b, V,
                    threshold, u0, w0, s0, **flags)
        # each gradient in its operand's type: the bf16 mode's dWx stream
        # goes back up where Wx arrived float32
        return (dWx.to(ctx.wx_dtype), dscale, dshift, dalpha, dbeta, da, db,
                dV, du0, dw0, ds0, None, None, None, None, None, None)


def clip_and_mask(alpha, beta=None, a=None, b=None, V=None):
    """Clamp the neuron constants into their ranges and zero the diagonal
    of V, as every fused entry point does before its kernel (JAX
    ``_clip_and_mask``); a None argument stays None."""
    alpha = torch.clamp(alpha, *cells.ALPHA_LIM)
    if beta is not None:
        beta = torch.clamp(beta, *cells.BETA_LIM)
    if a is not None:
        a = torch.clamp(a, *cells.A_LIM)
    if b is not None:
        b = torch.clamp(b, *cells.B_LIM)
    if V is not None:
        V = cells.zero_diag(V)
    return alpha, beta, a, b, V


def _fused_cell(Wx, scale, shift, alpha, beta, a, b, V, threshold, u0, w0,
                s0, *, recurrent, adaptive, drop_rate, drop_seed, mxu_bf16):
    if (scale is None) != (shift is None):
        raise ValueError("pass both scale and shift, or neither")
    # the state is float32 (float64 with a float64 stream) whatever type it
    # was drawn in; autograd carries a gradient back through the cast
    work = _work_dtype(Wx)
    u0, s0 = u0.to(work), s0.to(work)
    if w0 is not None:
        w0 = w0.to(work)
    drop_rate = float(drop_rate)
    if not 0.0 <= drop_rate < 1.0:
        raise ValueError(f"drop_rate must lie in [0, 1), got {drop_rate}")
    seed = _as_seed(drop_seed, Wx.device) if drop_rate > 0.0 else None
    alpha, beta, a, b, V = clip_and_mask(alpha, beta, a, b, V)
    return _FusedCell.apply(Wx, scale, shift, alpha, beta, a, b, V, u0, w0,
                            s0, seed, float(threshold), recurrent, adaptive,
                            drop_rate, bool(mxu_bf16))


def radlif_fused(Wx, alpha, beta, a, b, V, threshold, u0, w0, s0,
                 mxu_bf16: bool = False, scale=None, shift=None,
                 drop_rate: float = 0.0, drop_seed=None):
    """Fused RadLIF recurrence (drop-in for cells.radlif_scan). With
    ``scale``/``shift`` the normalization affine is applied on load
    (drive = scale*Wx + shift) and their gradients are returned. With
    ``drop_rate``/``drop_seed`` (two int32) the layer-output dropout is
    fused: the backward regenerates the mask from the seed."""
    return _fused_cell(Wx, scale, shift, alpha, beta, a, b, V, threshold,
                       u0, w0, s0, recurrent=True, adaptive=True,
                       drop_rate=drop_rate, drop_seed=drop_seed,
                       mxu_bf16=mxu_bf16)


def rlif_fused(Wx, alpha, V, threshold, u0, s0, mxu_bf16: bool = False,
               scale=None, shift=None, drop_rate: float = 0.0,
               drop_seed=None):
    """Fused RLIF recurrence (drop-in for cells.rlif_scan)."""
    return _fused_cell(Wx, scale, shift, alpha, None, None, None, V,
                       threshold, u0, None, s0, recurrent=True,
                       adaptive=False, drop_rate=drop_rate,
                       drop_seed=drop_seed, mxu_bf16=mxu_bf16)


def adlif_fused(Wx, alpha, beta, a, b, threshold, u0, w0, s0,
                scale=None, shift=None, drop_rate: float = 0.0,
                drop_seed=None, mxu_bf16: bool = False):
    """Fused adLIF recurrence (drop-in for cells.adlif_scan)."""
    return _fused_cell(Wx, scale, shift, alpha, beta, a, b, None, threshold,
                       u0, w0, s0, recurrent=False, adaptive=True,
                       drop_rate=drop_rate, drop_seed=drop_seed,
                       mxu_bf16=mxu_bf16)


def lif_fused(Wx, alpha, threshold, u0, s0, scale=None, shift=None,
              drop_rate: float = 0.0, drop_seed=None,
              mxu_bf16: bool = False):
    """Fused LIF recurrence (drop-in for cells.lif_scan)."""
    return _fused_cell(Wx, scale, shift, alpha, None, None, None, None,
                       threshold, u0, None, s0, recurrent=False,
                       adaptive=False, drop_rate=drop_rate,
                       drop_seed=drop_seed, mxu_bf16=mxu_bf16)


# ---------------------------------------------------------------------------
# Readout
# ---------------------------------------------------------------------------


def _softmax(u):
    e = torch.exp(u - u.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def readout_plain(Wx, alpha, u0, save_residuals: bool = False):
    """Plain PyTorch version of ``csrc/readout_fwd.cu``: the TPU
    ``_readout_fwd_kernel``'s per-step arithmetic as a loop over T.
    ``alpha`` must already be clamped. Returns (B, C), and with
    ``save_residuals`` also the membrane series (B, T, C)."""
    u = u0
    acc = torch.zeros_like(u0)
    u_seq = torch.empty_like(Wx) if save_residuals else None
    for t in range(Wx.shape[1]):
        u = alpha * u + (1.0 - alpha) * Wx[:, t]
        acc = acc + _softmax(u)
        if save_residuals:
            u_seq[:, t] = u
    return (acc, u_seq) if save_residuals else acc


def readout_bwd_plain(gout, u_seq, alpha, u0):
    """Plain PyTorch version of ``csrc/readout_bwd.cu``, the TPU
    ``_readout_bwd_kernel``: with p_t = softmax(u_t) recomputed from the
    saved series,

        G_t = p_t*(gout - <p_t, gout>) + alpha*G_{t+1}
        dWx_t = (1-alpha)*G_t
        dalpha = sum_{b,t} G_t*(u_{t-1} - u_t) / (1-alpha)
        du0 = alpha*G_1

    Returns (dWx, dalpha, du0) with respect to the clamped alpha."""
    oma = 1.0 - alpha
    G = torch.zeros_like(u0)
    dal = torch.zeros_like(u0)
    dWx = torch.empty_like(u_seq)
    for t in range(u_seq.shape[1] - 1, -1, -1):
        u_t = u_seq[:, t]
        u_p = u_seq[:, t - 1] if t > 0 else u0
        p = _softmax(u_t)
        G = p * (gout - (p * gout).sum(dim=-1, keepdim=True)) + alpha * G
        dWx[:, t] = oma * G
        dal = dal + G * (u_p - u_t)
    return dWx, dal.sum(0) / oma, alpha * G


# csrc/readout.cuh: the shared memory a readout block stages its rows'
# chunk into, threads of a block at most, warps the softmaxes take at most
_READOUT_SMEM = 96 * 1024
_READOUT_THREADS = 1024
_READOUT_SOFTMAX_WARPS = 16
# and the steps whose softmax statistics a block of the wide forms holds
_READOUT_WIDE_CHUNK = 1024


class ReadoutPlan(NamedTuple):
    """The launch plan of the readout pair (``readout_plan`` of
    ``csrc/readout.cuh``, which checks it), from ``_readout_plan``."""

    rows: int     # batch rows of a block: block i owns rows i*rows ..
    warps: int    # warps of a block
    t_chunk: int  # steps of each row staged in shared memory at once
    smem: int     # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=None)
def _readout_plan(B: int, T: int, C: int, sms: int,
                  backward: bool) -> ReadoutPlan:
    """Rows, warps and T chunk of a readout launch on a card of ``sms``
    SMs. A block owns ceil(B / sms) rows (so B = 128 and 256 give one
    block an SM), at most as many as its threads hold (a thread a row and
    class); it stages ``t_chunk`` steps of each row in ``_READOUT_SMEM``
    bytes (forward: the C floats of u a step; backward: those, p and
    <p, gout>, beside u before the chunk and gout), in equal chunks where
    T does not fit; its warps take the (row, step) softmaxes, up to
    ``_READOUT_SOFTMAX_WARPS`` unless the (row, class) threads need more.
    Past ``_LANE_C`` classes (the wide forms): a row a block, a warp per
    32 classes up to the block's threads, and the softmax statistics of
    ``t_chunk`` steps (forward: max and sum; backward: those and
    <p, gout>)."""
    if C > _LANE_C:
        t_chunk = min(T, _READOUT_WIDE_CHUNK)
        return ReadoutPlan(1, min(_READOUT_THREADS // 32, -(-C // 32)),
                           t_chunk, 4 * t_chunk * (3 if backward else 2))
    step = 2 * C + 1 if backward else C
    fixed = 2 * C if backward else 0
    rows = max(1, min(-(-B // sms), _READOUT_THREADS // C, B))
    fit = (_READOUT_SMEM // 4 - rows * fixed) // (rows * step)
    chunks = -(-T // min(T, fit))
    t_chunk = -(-T // chunks)
    warps = min(_READOUT_THREADS // 32,
                max(-(-rows * C // 32),
                    min(_READOUT_SOFTMAX_WARPS, rows * t_chunk)))
    return ReadoutPlan(rows, warps, t_chunk, 4 * rows * (fixed + t_chunk
                                                         * step))


def _card_readout_plan(B: int, T: int, C: int, dev,
                       backward: bool) -> ReadoutPlan:
    """``_readout_plan`` for the SMs of the card ``dev``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _readout_plan(B, T, C, sms, backward)


def _check_readout(Wx, alpha, u0):
    B, T, C = Wx.shape
    dev = Wx.device
    _check("Wx", Wx, (B, T, C), dev)
    _check("alpha", alpha, (C,), dev)
    _check("u0", u0, (B, C), dev)


def _readout_cuda(Wx, alpha, u0, save_residuals: bool = False):
    B, T, C = Wx.shape
    dev = Wx.device
    _check_readout(Wx, alpha, u0)
    out = torch.empty_like(u0)
    # the wide form keeps the membrane series in global memory, whatever
    # the form
    u_seq = (torch.empty_like(Wx) if save_residuals or C > _LANE_C
             else None)
    if Wx.numel() == 0:
        out.zero_()
    else:
        plan = _card_readout_plan(B, T, C, dev, False)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            READOUT_FWD(_ptr(Wx), _ptr(alpha), _ptr(u0), _ptr(out),
                        _ptr(u_seq), B, T, C, *plan[:3], stream)
    return (out, u_seq) if save_residuals else out


def _readout_bwd_cuda(gout, u_seq, alpha, u0):
    B, T, C = u_seq.shape
    dev = u_seq.device
    _check_readout(u_seq, alpha, u0)
    _check("gout", gout, (B, C), dev)
    dWx = torch.empty_like(u_seq)
    dalpha = torch.empty_like(alpha)
    # du0 and the per-row dalpha partials that the launch's last block adds
    du0, partials = torch.empty((2, B, C), device=dev).unbind(0)
    plan = _card_readout_plan(B, T, C, dev, True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        READOUT_BWD(_ptr(gout), _ptr(u_seq), _ptr(alpha), _ptr(u0),
                    _ptr(dWx), _ptr(partials), _ptr(dalpha), _ptr(du0),
                    B, T, C, *plan[:3], stream)
    return dWx, dalpha, du0


class _Readout(torch.autograd.Function):
    """The fused readout on a clamped alpha (JAX ``_make_readout_op``)."""

    @staticmethod
    def forward(ctx, Wx, alpha, u0):
        fwd = _by_device(Wx, readout_plain, _readout_cuda, "fused readout")
        if not any(ctx.needs_input_grad):
            return fwd(Wx, alpha, u0)
        out, u_seq = fwd(Wx, alpha, u0, save_residuals=True)
        ctx.save_for_backward(u_seq, alpha, u0)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        u_seq, alpha, u0 = ctx.saved_tensors
        if u_seq.numel() == 0:
            return (torch.zeros_like(u_seq), torch.zeros_like(alpha),
                    torch.zeros_like(u0))
        bwd = _by_device(gout, readout_bwd_plain, _readout_bwd_cuda,
                         "fused readout backward")
        return bwd(gout.contiguous(), u_seq, alpha, u0)


def readout_fused(Wx, alpha, u0):
    """Fused cumulative-softmax readout (drop-in for cells.readout_sum)."""
    alpha = torch.clamp(alpha, *cells.ALPHA_LIM)
    return _Readout.apply(Wx, alpha, u0)
