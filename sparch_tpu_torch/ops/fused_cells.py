"""Fused spiking cells and readout (counterpart of
sparch_tpu/ops/pallas_cells.py), forward only.

Each entry point clamps its neuron constants and masks the diagonal of V
once, then dispatches on the device of ``Wx``:

- a CPU tensor runs the plain PyTorch version (``fused_cell_plain``,
  ``readout_plain``): the per-step arithmetic of the TPU kernel as a loop
  over T, rounded op by op in the kernel's order;
- a CUDA tensor launches the hand-written kernel of ``csrc/``
  (``fused_cell_fwd.cu``, ``readout_fwd.cu``) and nothing else: a kernel
  that cannot launch raises;
- any other device raises.

``FUSED_CELL_FWD.launches`` and ``READOUT_FWD.launches`` count kernel
launches, so a run can show that it went through the kernels.

The backward kernels, the fused output dropout and the bf16-stream mode
belong to later slices of the port and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from sparch_tpu_torch._build import Kernel
from sparch_tpu_torch.ops import cells

__all__ = [
    "FUSED_CELL_FWD",
    "READOUT_FWD",
    "launch_counts",
    "reset_launch_counts",
    "clip_and_mask",
    "fused_cell_plain",
    "readout_plain",
    "lif_fused",
    "adlif_fused",
    "rlif_fused",
    "radlif_fused",
    "readout_fused",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
FUSED_CELL_FWD = Kernel(
    "fused_cell_fwd", "sparch_fused_cell_fwd",
    [_P] * 12 + [_I] * 3 + [ctypes.c_float] + [_I] * 3 + [_P],
)
READOUT_FWD = Kernel(
    "readout_fwd", "sparch_readout_fwd", [_P] * 4 + [_I] * 3 + [_P]
)
_KERNELS = (FUSED_CELL_FWD, READOUT_FWD)
# widest layer and class count the kernels take (csrc/*.cu kMaxThreads *
# kMaxNpt and 32 * kMaxVpl)
_MAX_H = 4096
_MAX_C = 256

_TRAINING_SLICE = (
    "the training slice of the port (ROADMAP queue 1 item 1: _bwd_kernel, "
    "_random_keep, _readout_bwd_kernel)"
)
_BF16_ITEM = (
    "ROADMAP queue 2 item 4, the bf16-stream mode of the fused cells"
)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel source name."""
    return {k.source: k.launches for k in _KERNELS}


def reset_launch_counts() -> None:
    for k in _KERNELS:
        k.launches = 0


def _forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise NotImplementedError(
            "the fused cells are forward-only in this slice; gradients "
            f"come with {_TRAINING_SLICE}. Use cell_impl='scan' to train."
        )


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(
            f"{name}: want float32 on {device}, got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {tuple(shape)} tensor, got "
            f"{tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Spiking cell
# ---------------------------------------------------------------------------


def fused_cell_plain(Wx, scale, shift, alpha, beta, a, b, V, threshold,
                     u0, w0, s0, *, recurrent: bool, adaptive: bool):
    """Plain PyTorch version of ``csrc/fused_cell_fwd.cu``: the TPU
    ``_fwd_kernel``'s per-step arithmetic as a loop over T. Params must
    already be clamped (and V zero-diagonal); ``scale``/``shift`` None
    means no affine. Returns the spikes (B,T,H)."""
    u, s = u0, s0
    w = w0
    sV = torch.matmul(s, V) if recurrent else None
    out = torch.empty_like(Wx)
    for t in range(Wx.shape[1]):
        drive = Wx[:, t]
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
        out[:, t] = s
    return out


def _fused_cell_cuda(Wx, scale, shift, alpha, beta, a, b, V, threshold,
                     u0, w0, s0, *, recurrent: bool, adaptive: bool):
    B, T, H = Wx.shape
    dev = Wx.device
    _check("Wx", Wx, (B, T, H), dev)
    if H > _MAX_H:
        raise ValueError(f"the fused cell kernel takes H <= {_MAX_H}, got {H}")
    vecs = {"alpha": alpha}
    if scale is not None:
        vecs.update(scale=scale, shift=shift)
    if adaptive:
        vecs.update(beta=beta, a=a, b=b)
    for name, t in vecs.items():
        _check(name, t, (H,), dev)
    states = {"u0": u0, "s0": s0, **({"w0": w0} if adaptive else {})}
    for name, t in states.items():
        _check(name, t, (B, H), dev)
    if recurrent:
        _check("V", V, (H, H), dev)
    out = torch.empty_like(Wx)
    if out.numel() == 0:
        return out
    if not adaptive:
        beta = a = b = w0 = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        FUSED_CELL_FWD(
            _ptr(Wx), _ptr(scale), _ptr(shift), _ptr(alpha), _ptr(beta),
            _ptr(a), _ptr(b), _ptr(V) if recurrent else None, _ptr(u0),
            _ptr(w0), _ptr(s0), _ptr(out), B, T, H, float(threshold),
            int(recurrent), int(adaptive), int(scale is not None), stream,
        )
    return out


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
    if drop_rate > 0.0 or drop_seed is not None:
        raise NotImplementedError(
            f"fused output dropout (drop_rate > 0, drop_seed) comes with "
            f"{_TRAINING_SLICE}"
        )
    if mxu_bf16:
        raise NotImplementedError(f"mxu_bf16=True is {_BF16_ITEM}")
    if (scale is None) != (shift is None):
        raise ValueError("pass both scale and shift, or neither")
    _forward_only(Wx, scale, shift, alpha, beta, a, b, V, u0, w0, s0)
    alpha, beta, a, b, V = clip_and_mask(alpha, beta, a, b, V)
    args = (Wx, scale, shift, alpha, beta, a, b, V, threshold, u0, w0, s0)
    if Wx.device.type == "cpu":
        return fused_cell_plain(*args, recurrent=recurrent,
                                adaptive=adaptive)
    if Wx.device.type == "cuda":
        return _fused_cell_cuda(*args, recurrent=recurrent,
                                adaptive=adaptive)
    raise ValueError(f"no fused cell for device {Wx.device}")


def radlif_fused(Wx, alpha, beta, a, b, V, threshold, u0, w0, s0,
                 mxu_bf16: bool = False, scale=None, shift=None,
                 drop_rate: float = 0.0, drop_seed=None):
    """Fused RadLIF recurrence (drop-in for cells.radlif_scan). With
    ``scale``/``shift`` the normalization affine is applied on load
    (drive = scale*Wx + shift)."""
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


def readout_plain(Wx, alpha, u0):
    """Plain PyTorch version of ``csrc/readout_fwd.cu``: the TPU
    ``_readout_fwd_kernel``'s per-step arithmetic as a loop over T.
    ``alpha`` must already be clamped. Returns (B, C)."""
    u = u0
    acc = torch.zeros_like(u0)
    for t in range(Wx.shape[1]):
        u = alpha * u + (1.0 - alpha) * Wx[:, t]
        e = torch.exp(u - u.amax(dim=-1, keepdim=True))
        acc = acc + e / e.sum(dim=-1, keepdim=True)
    return acc


def _readout_cuda(Wx, alpha, u0):
    B, T, C = Wx.shape
    dev = Wx.device
    _check("Wx", Wx, (B, T, C), dev)
    if C > _MAX_C:
        raise ValueError(f"the readout kernel takes C <= {_MAX_C}, got {C}")
    _check("alpha", alpha, (C,), dev)
    _check("u0", u0, (B, C), dev)
    out = torch.empty_like(u0)
    if Wx.numel() == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        READOUT_FWD(_ptr(Wx), _ptr(alpha), _ptr(u0), _ptr(out), B, T, C,
                    stream)
    return out


def readout_fused(Wx, alpha, u0):
    """Fused cumulative-softmax readout (drop-in for cells.readout_sum)."""
    _forward_only(Wx, alpha, u0)
    alpha = torch.clamp(alpha, *cells.ALPHA_LIM)
    if Wx.device.type == "cpu":
        return readout_plain(Wx, alpha, u0)
    if Wx.device.type == "cuda":
        return _readout_cuda(Wx, alpha, u0)
    raise ValueError(f"no fused readout for device {Wx.device}")
