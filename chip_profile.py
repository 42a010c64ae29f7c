#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's serving and training paths on one CUDA
card.

    python3 chip_profile.py [phase ...]

With phase names (``sweep``, ``profile``, ``h2d``, ``bwd_sweep``,
``profile_training``, ``bf16``, ``tp_exchange``, ``spiking_bwd``,
``spiking_fwd``, ``dv_products``, ``ab=DIR``, ``bits=DIR``) only those
run. Prints
JSON lines (tables of the profiler in between), each measured in
this run:

1. ``device``: the card's name and power limit (``nvidia-smi``).
2. ``sweep``: the fused-cell kernel alone at (B, T, H) = (128, 100, 512),
   LIF, RLIF and RadLIF, with scale 1 and the shift swept to move the
   firing rate; kernel ms (CUDA events) and the rate at which V rows are
   gathered (firing rate * H * H * 4 B * B * T over the kernel time).
3. ``profile``: ``torch.profiler`` over 5 forwards of one batch of the
   RadLIF [512, 512, 35] serving model of ``chip_smoke.py`` (its
   "calibrated" state) and of its GRU [512, 512, 35] serving model, per
   ``cell_impl``: device time and kernel launches per forward, the share
   of the fused cell, the readout kernel and the cuBLAS projections, and
   the idle share of the card against the un-profiled forward (CUDA events
   over 20 forwards).
4. ``h2d``: the pageable numpy -> card copy of one float32 raster batch,
   the first step ``Predictor`` takes per batch.
5. ``bwd_sweep``: the backward kernel alone at (128, 100, 512) over the
   same shifts, on the residuals of the training forward at that shift:
   kernel ms against the firing rate (the backward's products are dense,
   so its time should not follow the rate).
6. ``profile_training``: ``torch.profiler`` over 3 training steps of the
   RadLIF [512, 512, 35] trainer of ``chip_smoke.py`` and of its GRU
   [512, 512, 35] trainer, per ``cell_impl``:
   device time and kernel launches per step, the share of each
   hand-written kernel and of the cuBLAS products, and the idle share of
   the card (1 - device time / elapsed time between CUDA events around
   the profiled steps, profiler overhead included), and the same share
   against the un-profiled step time (CUDA events over 20 steps).
7. ``bf16``: phases 3 and 6 for the same two models under
   ``compute_dtype=bfloat16`` (``cell_impl="auto"``; lines ``profile`` and
   ``profile_training`` with ``compute_dtype`` "bfloat16"), beside their
   float32 ``auto`` runs in the same call.
8. ``ab=DIR`` (only when named): the kernels of the tree unpacked in
   ``DIR`` (another commit of this repository, e.g. from ``git archive``)
   against this tree's, in one call on one card, in the order DIR, this,
   this, DIR, each in a process of its own that builds that tree's
   kernels: kernel ms (CUDA events) and the bits of every output of the
   spiking cells (the recurrent forwards in every form and mode at (128,
   100, 512) and (256, 100, 1024), the TP forward and backward at P = 1,
   2, 4; the backwards), of the fused RNN/LiGRU/GRU kernels (with the affine; the
   forward's serving and training form and the backward) at (128, 100,
   512) and (128, 100, 1024) in float32 and bf16, of the tensor-parallel
   cells at their main shapes (RadLIF at (256, 100, 1024), float32;
   RNN/LiGRU/GRU at (128, 100, 1024) in float32 and bf16, the forward's
   training and serving form and the backward; P = 1, 2, 4); the ``auto``
   training step of the GRU [512, 512, 35] (float32 and bf16) and [1024,
   1024, 35] trainers, and the ``pallas_tp`` step of the latter at P = 1,
   2, 4 in both modes; the RadLIF [512, 512, 35] ``auto`` and the
   bidirectional RadLIF [1024, 1024, 35] ``auto`` and ``pallas_tp`` (P =
   1, 2, 4) steps in both modes; the ptxas report of the cell kernels
   with a product; and, per library in ``AB_UNTOUCHED``, the kernels
   whose SASS count, registers or stack bytes (``cuobjdump -sass``,
   ``-res-usage``) differ between the trees (whole records in
   ``build/ab/ab_<i>.json``). Then ``ab_step``: the RadLIF [512, 512, 35]
   ``auto`` step (float32, bf16) of both trees, each tree's trainer in a
   process that stays up: ten alternating pairs (DIR, this, this, DIR,
   ...) of the step's ms (CUDA events), then its kernels and copies a
   step (profiler, by name) and the device's idle share.

9. ``tp_exchange``: what one exchange between ranks costs the TP ANN
   kernels (GRU and RNN at (128, 100, 1024), float32 and bf16): P = 2 run
   in P = 1's block shape (clusters of three of the same 352-thread
   blocks on the same 96 SMs) against P = 1, the difference over the
   exchanges on a cluster's chain; beside it P = 2 in the plan the wrapper
   takes.

10. ``spiking_bwd``: the spiking backward kernels apart (``fused_cell_bwd``
   at (128, 100, 512) and (256, 100, 1024), ``tp_cell_bwd`` at (256, 100,
   1024), P = 1, 2, 4; both modes): kernel ms, ``split_ms`` (time loop, dV
   product, second passes), the dV product's ``torch.matmul`` yardstick,
   the plan, the two libraries' ptxas report.
11. ``bits=DIR`` (only when named): where the single-card spiking
   backward's outputs differ between the tree in ``DIR`` and this one
   (RadLIF, H = 200 .. 4096, every affine / dropout form, both modes), and
   the recurrent spiking forwards' (RLIF and RadLIF, H = 200 .. 4096,
   serving and training form, affine and dropout on and off, both modes,
   non-dyadic V; the TP forward at P = 1, 2, 4 and at P = 2, H = 4096);
   the non-spiking backwards' (RNN, LiGRU, GRU, H = 200 .. 2048, affine on
   and off, both modes); the TP backwards' (RadLIF and RNN/LiGRU/GRU at P
   = 1, 2, 4; RadLIF at P = 2, H = 4096).
12. ``spiking_fwd``: the spiking forward kernels apart (``fused_cell_fwd``,
   RadLIF with the affine, training form with the dropout and serving
   form, and ``tp_cell_fwd``, RadLIF at P = 1, 2, 4, training form; at
   (128, 100, 512) and (256, 100, 1024), both modes): kernel ms with s0
   drawn from U[0, 1) as the training path's state init draws it; the
   first product's share as the difference of two launches of one step
   (T = 1), with that s0 and with s0 = 0 (the product then skips every
   row), for a tree whose wrappers take no ``split_ms``; ``split_ms``
   (first product, time loop: CUDA events around each launch) where they
   take it; the plan; at P > 1 the time over P = 1 per exchange; and the
   two libraries' ptxas report.
13. ``dv_products``: the dV products of the backwards apart (RadLIF's at
   (128, 100, 512) and (256, 100, 1024), the GRU's at (128, 100, 512) and
   (128, 100, 1024), both modes): their share of the backward
   (``split_ms``), the product alone, ``dv_library_ms`` (one
   ``torch.matmul`` of the same float32 operands, TF32 off), the bound and
   what binds it, the tile.

The ``ab`` phase also times the dV product of each backward at those four
shapes in both modes (``dv_*`` in ``ms``: its ``split_ms`` share), in the
same turns as the rest. Without a CUDA card it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
SHIFTS = (-20.0, -1.0, 0.0, 0.5, 1.0, 2.0, 4.0)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def sweep(dev):
    import chip_smoke as cs
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    B, T, H = cs.B, cs.T, cs.H
    for name in ("lif", "rlif", "radlif"):
        for shift in SHIFTS:
            d = cs.cell_inputs((B, T, H), dyadic=False, seed=1, dev=dev)
            d["shift"] = torch.full_like(d["shift"], shift)
            d["scale"] = torch.ones_like(d["scale"])
            with torch.no_grad():
                rate = float(cs.kernel_call(name, d, True).mean())
                ms = cuda_time_ms(cs.kernel_call, name, d, True, iters=20)
            gathered = rate * H * H * 4 * B * T if cs.FORMS[name][0] else 0.0
            emit("sweep", cell=name, shift=shift, firing_rate=rate, ms=ms,
                 v_row_bytes=gathered, v_row_GBps=gathered / ms / 1e6)


def _share(events, *needles):
    return sum(e.device_time for e in events
               if any(n in e.name for n in needles))


def _serving_case(dev, model_type):
    """(state dict, one input batch, cell_impls) of ``chip_smoke.py``'s
    serving model of this type."""
    import chip_smoke as cs

    g = torch.Generator(device=dev).manual_seed(12)
    if model_type == "RadLIF":
        x = torch.rand((cs.B, cs.T, cs.F), generator=g, device=dev) < 0.02
        return (cs.serving_state(dev, zero_means=False), x.float(),
                ("auto", "pallas", "scan"))
    x = torch.randn((cs.B, cs.T, cs.F_ANN), generator=g, device=dev)
    return cs.ann_state(dev, model_type), x, ("auto", "scan")


def _dtype_name(model_kw):
    return "bfloat16" if model_kw.get("compute_dtype") == torch.bfloat16 \
        else "float32"


def profile(dev, model_type="RadLIF", impls=None, **model_kw):
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    state, x, all_impls = _serving_case(dev, model_type)
    for impl in impls or all_impls:
        m = build_model(model_type, tuple(x.shape), [cs.H, cs.H, cs.C],
                        state_init="zeros", cell_impl=impl,
                        **model_kw).to(dev).eval()
        m.load_state_dict(state)
        with torch.no_grad():
            for _ in range(3):
                m(x)
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    m(x)
                torch.cuda.synchronize()
            forward_us = 1e3 * cuda_time_ms(m, x, warmup=1, iters=20,
                                            repeats=3)
        print(f"=== {model_type} {impl} {_dtype_name(model_kw)}")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=14,
                                        max_name_column_width=60))
        ev = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy = sum(e.device_time for e in ev)
        emit("profile", model=model_type, variant=impl,
             compute_dtype=_dtype_name(model_kw),
             device_us_per_forward=busy / 5,
             kernels_per_forward=len(ev) / 5,
             unprofiled_us_per_forward=forward_us,
             idle_share=1.0 - busy / 5 / forward_us,
             fused_cell_share=_share(ev, "fused_cell_fwd",
                                     "fused_ann_fwd") / busy,
             readout_kernel_share=_share(ev, "readout_fwd") / busy,
             gemm_share=_share(ev, "gemm", "sgemm", "cutlass") / busy)


def bwd_sweep(dev):
    import chip_smoke as cs
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    B, T, H = cs.B, cs.T, cs.H
    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
    g = torch.randn((B, T, H), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    for name in ("lif", "rlif", "radlif"):
        rec, ada = cs.FORMS[name]
        for shift in SHIFTS:
            d = cs.cell_inputs((B, T, H), dyadic=False, seed=1, dev=dev)
            d["shift"] = torch.full_like(d["shift"], shift)
            d["scale"] = torch.ones_like(d["scale"])
            with torch.no_grad():
                _, u_seq = cs.train_forward_call(name, d, True, seed=seed)
                rate = float((u_seq > 1.0).float().mean())
                ms = cuda_time_ms(
                    lambda: fused_cells._fused_cell_bwd_cuda(
                        g, d["Wx"], u_seq, d["scale"], d["alpha"], d["beta"],
                        d["a"], d["b"], d["V"], 1.0, d["u0"], d["w0"],
                        d["s0"], recurrent=rec, adaptive=ada,
                        drop_rate=cs.P_DROP, seed=seed), iters=5)
            emit("bwd_sweep", cell=name, shift=shift, firing_rate=rate, ms=ms)


# shares of a training step, by kernel name; the dV products and the
# fixed-order second passes have one name in both backward sources
_TRAIN_KERNELS = {
    "fused_cell_fwd": ("fused_cell_fwd_kernel",),
    "fused_cell_bwd_time_loop": ("fused_cell_bwd_kernel",),
    "fused_ann_fwd": ("fused_ann_fwd_kernel",),
    "fused_ann_bwd_time_loop": ("fused_ann_bwd_kernel",),
    "bwd_dv": ("dv_kernel",),
    "bwd_reduce": ("vec_reduce_kernel", "sum_parts_kernel"),
    "readout_fwd": ("readout_fwd_kernel",),
    "readout_bwd": ("readout_bwd_kernel", "dalpha_reduce_kernel"),
    "gemm": ("gemm", "sgemm", "cutlass"),
}


def profile_training(dev, model_type="RadLIF", impls=None, **model_kw):
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.train import make_train_step
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(21)
    if model_type == "RadLIF":
        state_dict = cs.training_state(dev)
        x = torch.rand((cs.B, cs.T, cs.F), generator=gen, device=dev) < 0.02
        x, all_impls = x.float(), ("auto", "pallas", "scan")
    else:
        state_dict = build_model(
            model_type, (cs.B, cs.T, cs.F_ANN), [cs.H, cs.H, cs.C],
            dropout=cs.P_DROP,
            generator=torch.Generator().manual_seed(0)).state_dict()
        x = torch.randn((cs.B, cs.T, cs.F_ANN), generator=gen, device=dev)
        all_impls = ("auto", "scan")
    y = torch.randint(0, cs.C, (cs.B,), generator=gen, device=dev)
    n = 3
    for impl in impls or all_impls:
        model, state, _, _, _ = cs.train_run(dev, impl, state_dict, x, y, 3,
                                             model_type=model_type,
                                             **model_kw)
        step = make_train_step(model)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(n):
                step(state, x, y)
            end.record()
            torch.cuda.synchronize()
        elapsed_us = 1e3 * start.elapsed_time(end)
        step_us = 1e3 * cuda_time_ms(step, state, x, y, warmup=1, iters=20,
                                     repeats=3)
        print(f"=== training {model_type} {impl} {_dtype_name(model_kw)}")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=16,
                                        max_name_column_width=60))
        ev = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy = sum(e.device_time for e in ev)
        emit("profile_training", model=model_type, variant=impl,
             compute_dtype=_dtype_name(model_kw), steps=n,
             device_us_per_step=busy / n, elapsed_us_per_step=elapsed_us / n,
             idle_share_profiled=1.0 - busy / elapsed_us,
             unprofiled_us_per_step=step_us,
             idle_share=1.0 - busy / n / step_us,
             kernels_per_step=len(ev) / n,
             shares={k: _share(ev, *needles) / busy
                     for k, needles in _TRAIN_KERNELS.items()})


def spiking_bwd(dev):
    """Phase 10: the spiking backward kernels apart, at the main path's
    shapes, float32 and bf16: ``fused_cell_bwd`` (RadLIF with the affine and
    the dropout) at (128, 100, 512) and at the (256, 100, 1024) of the
    bidirectional RadLIF 1024 ``auto`` trainer, ``tp_cell_bwd`` (RadLIF) at
    (256, 100, 1024) at P = 1, 2, 4: kernel ms, ``split_ms`` (the time loop,
    the dV product and the second passes, CUDA events around each launch),
    ``dv_library_ms`` (``torch.matmul`` of the same (H, B*T) x (B*T, H)
    float32 product, TF32 off: a yardstick the port never calls), the plan
    the launch ran, and the ptxas report of the two libraries, built in this
    process."""
    import chip_smoke as cs
    from sparch_tpu_torch import _build
    from sparch_tpu_torch.ops import fused_cells, fused_tp
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    libs = ("fused_cell_bwd", "tp_cell_bwd")
    for lib in libs:
        _build.library_path(lib).unlink(missing_ok=True)
    logs = _build.build(libs)
    emit("spiking_bwd_ptxas",
         **{lib: cs.ptxas_summary(logs[lib]) for lib in libs})
    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)

    with torch.no_grad():
        for shape in ((cs.B, cs.T, cs.H), (2 * cs.B, cs.T, cs.TP_H)):
            d = cs.cell_inputs(shape, dyadic=True, seed=1, dev=dev)
            g = torch.randn(shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(6))
            for mx in (False, True):
                dm = dict(d, Wx=d["Wx"].to(cs.BF16)) if mx else d
                gm = g.to(cs.BF16) if mx else g
                _, u_seq = cs.train_forward_call("radlif", dm, True, seed=seed,
                                                 bf16=mx)
                args = (gm, dm["Wx"], u_seq, d["scale"], d["alpha"],
                        d["beta"], d["a"], d["b"], d["V"], 1.0, d["u0"],
                        d["w0"], d["s0"])
                kw = dict(recurrent=True, adaptive=True, drop_rate=cs.P_DROP,
                          seed=seed, mxu_bf16=mx)
                run = lambda split=None: fused_cells._fused_cell_bwd_cuda(
                    *args, **kw, split_ms=split)  # noqa: E731
                ms = cuda_time_ms(run)
                emit("spiking_bwd", kernel="fused_cell_bwd", shape=list(shape),
                     mxu_bf16=mx, ms=ms, split_ms=cs.split_ms_of(run),
                     dv_library_ms=cs.dv_library_ms(*shape, dev),
                     plan=fused_cells.last_plans()["fused_cell_bwd"])
        shape = (2 * cs.B, cs.T, cs.TP_H)
        d = cs.tp_cell_inputs(shape, seed=1, dev=dev, uniform_s0=True)
        args, ada = cs._tp_args("radlif", d)
        g = torch.randn(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
        for mx in (False, True):
            gm = g.to(cs.BF16) if mx else g
            for P in (1, 2, 4):
                kw = dict(num_devices=P, adaptive=ada, mxu_bf16=mx)
                _, u_seq = fused_tp._tp_cell_cuda(*args, save_residuals=True,
                                                  **kw)
                run = lambda split=None: fused_tp._tp_cell_bwd_cuda(
                    gm, u_seq, *args[1:], **kw, split_ms=split)  # noqa: E731
                ms = cuda_time_ms(run)
                emit("spiking_bwd", kernel="tp_cell_bwd", shape=list(shape),
                     P=P, mxu_bf16=mx, ms=ms, split_ms=cs.split_ms_of(run),
                     dv_library_ms=cs.dv_library_ms(*shape, dev),
                     plan=fused_tp.last_bwd_plan())


def dv_products(dev):
    """Phase 13: the dV products of the backwards apart, at the main
    path's four shapes, float32 and bf16: RadLIF's (``fused_cell_bwd``,
    affine, dropout, s0 drawn from U[0, 1)) at (128, 100, 512) and (256,
    100, 1024), the GRU's (``fused_ann_bwd``, affine) at (128, 100, 512)
    and (128, 100, 1024). Per case: ``split_ms`` (the time loop, the dV
    product, the second passes, CUDA events around each launch), the
    product alone (``fused_ann._dv_product_cuda``; CUDA events),
    ``dv_library_ms`` (one ``torch.matmul`` of (H, B*T) x (B*T, gates*H),
    TF32 off: a yardstick the port never calls), the bound: the larger of
    the bytes it must move (the left operand's series, the right ones and
    s0 or y0 read once, dV written once) over 3.35 TB/s and its operations
    over 67 TFLOP/s (float32): 2 x H per nonzero left element for the
    spiking product (this run's spikes), 2 x gates x B*T x H^2 for the
    GRU's; the GRU's tile; and the two libraries' ptxas report."""
    import chip_smoke as cs
    from sparch_tpu_torch import _build
    from sparch_tpu_torch.ops import fused_ann, fused_cells
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    libs = ("fused_cell_bwd", "fused_ann_bwd")
    for lib in libs:
        _build.library_path(lib).unlink(missing_ok=True)
    logs = _build.build(libs)
    emit("dv_products_ptxas",
         **{lib: cs.ptxas_summary(logs[lib]) for lib in libs})
    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)

    def bound(n_bytes, n_ops):
        ms = (1e3 * n_bytes / cs.PEAK_BYTES_S, 1e3 * n_ops / cs.PEAK_F32_S)
        return dict(bound_ms=max(ms),
                    bound_by="bytes" if ms[0] >= ms[1] else "operations")

    with torch.no_grad():
        for shape in ((cs.B, cs.T, cs.H), (2 * cs.B, cs.T, cs.TP_H)):
            b, t, h = shape
            d = cs.cell_inputs(shape, dyadic=True, seed=1, dev=dev)
            d["s0"] = torch.rand(d["s0"].shape, device=dev,
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(5))
            g = torch.randn(shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(6))
            for mx in (False, True):
                dm = dict(d, Wx=d["Wx"].to(cs.BF16)) if mx else d
                gm = g.to(cs.BF16) if mx else g
                _, u_seq = cs.train_forward_call("radlif", dm, True, seed=seed,
                                                 bf16=mx)
                args = (gm, dm["Wx"], u_seq, d["scale"], d["alpha"],
                        d["beta"], d["a"], d["b"], d["V"], 1.0, d["u0"],
                        d["w0"], d["s0"])
                kw = dict(recurrent=True, adaptive=True, drop_rate=cs.P_DROP,
                          seed=seed, mxu_bf16=mx)
                nnz = int((u_seq[:, :-1] > 1.0).sum()
                          + (d["s0"] != 0).sum())
                elt = 2 if mx else 4
                emit("dv_products", product="spike_dv", cell="radlif",
                     shape=list(shape), mxu_bf16=mx,
                     split_ms=cs.split_ms_of(
                         lambda split: fused_cells._fused_cell_bwd_cuda(
                             *args, **kw, split_ms=split), n=9),
                     ms_alone=cuda_time_ms(
                         lambda: fused_ann._dv_product_cuda(
                             u_seq, d["s0"], None, [gm], threshold=1.0,
                             mxu_bf16=mx)),
                     dv_library_ms=cs.dv_library_ms(*shape, dev),
                     firing_rate=nnz / (b * t * h),
                     tile=fused_ann._DV_TILES[fused_ann._card_dv_tile(
                         h, 1, fused_ann._dv_split(b, t, h, 1), dev)],
                     **bound(b * t * h * (4 + elt) + b * h * 4 + h * h * 4,
                             2.0 * nnz * h))
        for h in (cs.H, cs.TP_H):
            shape = (cs.B, cs.T, h)
            b, t, _ = shape
            a = cs.ann_inputs("gru", shape, 4, dev)
            g = torch.randn(shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(6))
            for mx in (False, True):
                am = dict(a, wxs=[w.to(cs.BF16) for w in a["wxs"]]) if mx else a
                gm = g.to(cs.BF16) if mx else g
                r = cs.ann_forward("gru", am, True, cs.P_DROP, seed, True,
                                   bf16=mx)[1:]
                y_raw, _, reset, _ = r
                dpres = [gm.clone() for _ in range(3)]
                ksplit = fused_ann._dv_split(b, t, h, 3)
                elt = 2 if mx else 4
                emit("dv_products", product="ann_dv", cell="gru",
                     shape=list(shape), mxu_bf16=mx,
                     split_ms=cs.split_ms_of(
                         lambda split: cs.ann_backward(
                             "gru", am, gm, r, seed, True, bf16=mx,
                             split_ms=split), n=9),
                     ms_alone=cuda_time_ms(
                         lambda: fused_ann._dv_product_cuda(
                             y_raw, a["y0"], reset, dpres, mxu_bf16=mx)),
                     dv_library_ms=cs.dv_library_ms(*shape, dev, 3),
                     ksplit=ksplit,
                     tile=fused_ann._DV_TILES[fused_ann._card_dv_tile(
                         h, 3, ksplit, dev)],
                     **bound(b * t * h * elt * 5 + b * h * 4 + 3 * h * h * 4,
                             2.0 * 3 * b * t * h * h))


def spiking_fwd(dev):
    """Phase 12: the spiking forward kernels apart, at the main paths'
    shapes, float32 and bf16: ``fused_cell_fwd`` (RadLIF with the affine:
    the training form with the dropout and the residuals, as the ``auto``
    trainer launches it, and the serving form) and ``tp_cell_fwd`` (RadLIF,
    training form, P = 1, 2, 4), each at (128, 100, 512) and (256, 100,
    1024). Per case: ``ms`` with s0 drawn from U[0, 1); ``split_ms`` (the
    first product and the time loop, CUDA events around each launch) where
    the wrappers take ``split_ms``, else ``first_product_ms``, the
    difference of one-step launches (T = 1) with that s0 and with s0 = 0,
    where the product skips every row of V (over all T, s0 = 0 moves the
    firing rate, so only one step is compared); the plan of the launch; at
    P > 1 ``exchange_us``, the time over P = 1 over the T - 1 exchanges;
    and the ptxas report of the two libraries, built in this process."""
    import inspect

    import chip_smoke as cs
    from sparch_tpu_torch import _build
    from sparch_tpu_torch.ops import fused_cells, fused_tp
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    libs = ("fused_cell_fwd", "tp_cell_fwd")
    for lib in libs:
        _build.library_path(lib).unlink(missing_ok=True)
    logs = _build.build(libs)
    emit("spiking_fwd_ptxas",
         **{lib: cs.ptxas_summary(logs[lib]) for lib in libs})
    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
    takes_split = "split_ms" in inspect.signature(
        fused_cells._fused_cell_cuda).parameters

    def split_of(run, arg, arg1, arg0):
        """``split_ms`` where the wrapper takes it, else the first
        product's ms from one-step launches."""
        if takes_split:
            return dict(split_ms=cs.split_ms_of(
                lambda sp: run(arg, sp), names=cs.FWD_SPLIT_NAMES))
        return dict(first_product_ms=cuda_time_ms(run, arg1)
                    - cuda_time_ms(run, arg0))

    def uniform(like):
        return torch.rand(like.shape, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(5))

    with torch.no_grad():
        for shape in ((cs.B, cs.T, cs.H), (2 * cs.B, cs.T, cs.TP_H)):
            d = cs.cell_inputs(shape, dyadic=True, seed=1, dev=dev)
            d["s0"] = uniform(d["s0"])
            d1 = dict(d, Wx=d["Wx"][:, :1].contiguous())
            d0 = dict(d1, s0=torch.zeros_like(d["s0"]))
            for mx in (False, True):
                for form in ("training", "serving"):
                    drop = cs.P_DROP if form == "training" else 0.0
                    kw = dict(drop_rate=drop, seed=seed if drop else None,
                              save_residuals=form == "training", bf16=mx)

                    def run(dd, split=None):
                        p = cs._prepared("radlif", dd, True)
                        extra = {} if split is None else dict(split_ms=split)
                        return fused_cells._fused_cell_cuda(
                            *p["args"], **p["kw"], drop_rate=kw["drop_rate"],
                            seed=kw["seed"],
                            save_residuals=kw["save_residuals"],
                            mxu_bf16=mx, **extra)

                    ms = cuda_time_ms(run, d)
                    out = run(d)
                    s = out[0] if isinstance(out, tuple) else out
                    emit("spiking_fwd", kernel="fused_cell_fwd", form=form,
                         shape=list(shape), mxu_bf16=mx, ms=ms,
                         **split_of(run, d, d1, d0),
                         plan=fused_cells.last_plans().get("fused_cell_fwd"),
                         firing_rate=float(s.float().mean()))
            dt = cs.tp_cell_inputs(shape, seed=1, dev=dev, uniform_s0=True)
            args, ada = cs._tp_args("radlif", dt)
            args1 = (args[0][:, :1].contiguous(),) + args[1:]
            args0 = args1[:-1] + (torch.zeros_like(args[-1]),)
            for mx in (False, True):
                at_p1 = None
                for P in (1, 2, 4):
                    kw = dict(num_devices=P, adaptive=ada, mxu_bf16=mx,
                              save_residuals=True)

                    def run(a, split=None):
                        extra = {} if split is None else dict(split_ms=split)
                        return fused_tp._tp_cell_cuda(*a, **kw, **extra)

                    ms = cuda_time_ms(run, args)
                    s = run(args)[0]
                    plan = fused_tp.last_plans()["tp_cell_fwd"]
                    at_p1 = ms if P == 1 else at_p1
                    emit("spiking_fwd", kernel="tp_cell_fwd", form="training",
                         shape=list(shape), P=P, mxu_bf16=mx, ms=ms,
                         **split_of(run, args, args1, args0), plan=plan,
                         exchange_us=None if P == 1 else
                         (ms - at_p1) * 1e3 / (shape[1] - 1),
                         firing_rate=float(s.float().mean()))


def tp_exchange(dev):
    """Phase 9: what one exchange between ranks costs the TP ANN kernels.
    At (128, 100, 1024) the P = 1 plan is sixteen clusters of six blocks of
    352 threads (96 SMs); P = 2 in clusters of three has the same blocks on
    the same 96 SMs, so the time it adds over P = 1, over the exchanges on
    a cluster's chain, is the exchange's (with the cluster barrier of three
    blocks instead of six). Beside it the P = 2 plan the wrapper takes
    (clusters of two, four rows, 128 SMs): what the plan buys. GRU and RNN,
    float32 and bf16, forward (training form) and backward."""
    import chip_smoke as cs
    from sparch_tpu_torch.ops import fused_tp_ann
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    shape = (cs.B, cs.T, cs.TP_H)
    g = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    chosen = fused_tp_ann.launch_plan
    fast = dict(warmup=1, iters=5, repeats=3)

    def as_p1(mode, B, H, P, mxu_bf16, backward, dev_):
        """The plan of P = 1's block shape: clusters of 6 // P blocks."""
        n = fused_tp_ann._MODES[mode]["n_wx"]
        planes = fused_tp_ann._MODES[mode]["bwd_stack"] if backward else 1
        c = 6 // P
        q = fused_tp_ann._rank_plan(B, H, P, n, mxu_bf16, planes, c)
        with torch.cuda.device(dev_):
            m = fused_tp_ann.max_active_clusters(mode, B, H, P, c, mxu_bf16,
                                                 backward)
        per = min(q.clusters, m // P)
        return fused_tp_ann.TPPlan(q, per, -(-q.clusters // per), m)

    with torch.no_grad():
        for mode in ("gru", "rnn"):
            d = cs.tp_ann_inputs(mode, shape, 4, dev)
            args = (mode, d["wxs"], d["vs"], d["y0"])
            for mx in (False, True):
                gm = g.to(torch.bfloat16) if mx else g
                row = {}
                cases = (("p1", 1, chosen), ("p2_as_p1", 2, as_p1),
                         ("p2", 2, chosen))
                for case, P, plan in cases:
                    kw = dict(num_devices=P, mxu_bf16=mx)
                    fused_tp_ann.launch_plan = plan
                    try:
                        fwd = cuda_time_ms(
                            lambda: fused_tp_ann._tp_ann_cell_cuda(
                                *args, save_residuals=True, **kw), **fast)
                        fplan = fused_tp_ann.last_plan("tp_ann_fwd")
                        out, gates = fused_tp_ann._tp_ann_cell_cuda(
                            *args, save_residuals=True, **kw)
                        ba = (mode, gm, out, gates, d["vs"], d["y0"])
                        bwd = cuda_time_ms(
                            lambda: fused_tp_ann._tp_ann_cell_bwd_cuda(
                                *ba, **kw), **fast)
                        bplan = fused_tp_ann.last_plan("tp_ann_bwd")
                    finally:
                        fused_tp_ann.launch_plan = chosen
                    row[case] = dict(fwd_ms=fwd, bwd_ms=bwd, fwd_plan=fplan,
                                     bwd_plan=bplan)
                for direction in ("fwd", "bwd"):
                    n = cs.tp_ann_exchanges(
                        mode, direction, row["p2_as_p1"][direction + "_plan"])
                    row[direction + "_exchange_us"] = (
                        row["p2_as_p1"][direction + "_ms"]
                        - row["p1"][direction + "_ms"]) * 1e3 / n
                emit("tp_exchange", cell=mode, shape=list(shape),
                     mxu_bf16=mx, **row)


# runs in a process of its own with a tree's root as argv[1]: that tree's
# chip_smoke helpers and kernels, whatever commit it is
_AB_CODE = r"""
import importlib.util, json, re, subprocess, sys
import torch
root = sys.argv[1]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("smoke", root + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from sparch_tpu_torch import _build
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.ops import fused_cells
from sparch_tpu_torch.train import make_train_step
from sparch_tpu_torch.utils.timing import cuda_time_ms
if not _build.__file__.startswith(root):
    raise RuntimeError("imported the package of another tree: "
                       + _build.__file__)
torch.backends.cuda.matmul.allow_tf32 = False
# the cell kernels with a product on their time loop build in this
# process, whatever was built before, so that their ptxas report is at hand
REPORT_LIBS = ("fused_cell_fwd", "tp_cell_fwd", "fused_cell_bwd",
               "tp_cell_bwd", "fused_ann_fwd", "fused_ann_bwd", "tp_ann_fwd",
               "tp_ann_bwd")
for lib in REPORT_LIBS:
    _build.library_path(lib).unlink(missing_ok=True)
logs = _build.build()
import hashlib
def digest(ts):
    # the bits of a list of tensors (None skipped), in order
    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()[:16]
dig = {}
dev = torch.device("cuda", 0)
shape = (smoke.B, smoke.T, smoke.H)
seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
bf16 = torch.bfloat16
res = {}
fast = dict(warmup=1, iters=5, repeats=3)
with torch.no_grad():
    d = smoke.cell_inputs(shape, dyadic=True, seed=1, dev=dev)
    g = torch.randn(shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    for name in ("rlif", "radlif"):
        rec, ada = smoke.FORMS[name]
        res["cell_fwd_" + name] = cuda_time_ms(smoke.kernel_call, name, d,
                                               True)
        res["cell_fwd_train_" + name] = cuda_time_ms(
            smoke.train_forward_call, name, d, True, smoke.P_DROP, seed)
        _, u_seq = smoke.train_forward_call(name, d, True, seed=seed)
        args = (g, d["Wx"], u_seq, d["scale"], d["alpha"], d["beta"], d["a"],
                d["b"], d["V"], 1.0, d["u0"], d["w0"], d["s0"])
        kw = dict(recurrent=rec, adaptive=ada, drop_rate=smoke.P_DROP,
                  seed=seed)
        res["cell_bwd_" + name] = cuda_time_ms(
            lambda: fused_cells._fused_cell_bwd_cuda(*args, **kw))
    # rows 6 and 7: the fused ANN kernels with the affine, serving and
    # training form, and the backward, at H = 512 and 1024, both modes
    for h in (smoke.H, smoke.TP_H):
        ashape = (smoke.B, smoke.T, h)
        ga = torch.randn(ashape, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
        for mode in ("rnn", "ligru", "gru"):
            for mx in (False, True):
                a = smoke.ann_inputs(mode, ashape, 4, dev)
                gm = ga
                if mx:
                    a["wxs"] = [w.to(bf16) for w in a["wxs"]]
                    gm = ga.to(bf16)
                key = f"{mode}_h{h}" + ("_bf16" if mx else "")
                res["ann_fwd_" + key] = cuda_time_ms(
                    lambda: smoke.ann_forward(mode, a, True, bf16=mx), **fast)
                res["ann_fwd_train_" + key] = cuda_time_ms(
                    lambda: smoke.ann_forward(mode, a, True, smoke.P_DROP,
                                              seed, True, bf16=mx), **fast)
                r = smoke.ann_forward(mode, a, True, smoke.P_DROP, seed, True,
                                      bf16=mx)[1:]
                res["ann_bwd_" + key] = cuda_time_ms(
                    lambda: smoke.ann_backward(mode, a, gm, r, seed, True,
                                               bf16=mx), **fast)
    # the float32 tensor-parallel cells at their main shapes, P = 1, 2, 4
    from sparch_tpu_torch.ops import fused_tp, fused_tp_ann
    tshape = (2 * smoke.B, smoke.T, smoke.TP_H)
    gt = torch.randn(tshape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(6))
    ashape = (smoke.B, smoke.T, smoke.TP_H)
    ga = torch.randn(ashape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(6))
    for P in (1, 2, 4):
        dt = smoke.tp_cell_inputs(tshape, seed=1, dev=dev, uniform_s0=True)
        args, ada = smoke._tp_args("radlif", dt)
        kw = dict(num_devices=P, adaptive=ada)
        res[f"tp_cell_fwd_p{P}"] = cuda_time_ms(
            lambda: fused_tp._tp_cell_cuda(*args, save_residuals=True, **kw))
        _, u_seq = fused_tp._tp_cell_cuda(*args, save_residuals=True, **kw)
        res[f"tp_cell_bwd_p{P}"] = cuda_time_ms(
            lambda: fused_tp._tp_cell_bwd_cuda(gt, u_seq, *args[1:], **kw))
        # rows 12-13: the TP RNN/LiGRU/GRU in both modes, the forward's
        # training and serving form and the backward
        for mode in ("rnn", "ligru", "gru"):
            da = smoke.tp_ann_inputs(mode, ashape, 4, dev)
            fa = (mode, da["wxs"], da["vs"], da["y0"])
            for mx in (False, True):
                sfx = f"_{mode}_p{P}" + ("_bf16" if mx else "")
                tk = dict(num_devices=P, mxu_bf16=mx)
                res["tp_ann_fwd" + sfx] = cuda_time_ms(
                    lambda: fused_tp_ann._tp_ann_cell_cuda(
                        *fa, save_residuals=True, **tk), **fast)
                res["tp_ann_fwd_serving" + sfx] = cuda_time_ms(
                    lambda: fused_tp_ann._tp_ann_cell_cuda(*fa, **tk), **fast)
                out, gates = fused_tp_ann._tp_ann_cell_cuda(
                    *fa, save_residuals=True, **tk)
                ba = (mode, ga.to(bf16) if mx else ga, out, gates, da["vs"],
                      da["y0"])
                res["tp_ann_bwd" + sfx] = cuda_time_ms(
                    lambda: fused_tp_ann._tp_ann_cell_bwd_cuda(*ba, **tk),
                    **fast)
# the dV products inside their backwards (split_ms: CUDA events around each
# launch, median of 9) at the four main shapes, both modes: RadLIF's at
# (128, 100, 512) and (256, 100, 1024), the GRU's at (128, 100, 512) and
# (128, 100, 1024)
with torch.no_grad():
    for shape in ((smoke.B, smoke.T, smoke.H),
                  (2 * smoke.B, smoke.T, smoke.TP_H)):
        d = smoke.cell_inputs(shape, dyadic=True, seed=1, dev=dev)
        d["s0"] = torch.rand(d["s0"].shape, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5))
        g = torch.randn(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
        for mx in (False, True):
            dm = dict(d, Wx=d["Wx"].to(bf16)) if mx else d
            _, u_seq = smoke.train_forward_call("radlif", dm, True, seed=seed,
                                                bf16=mx)
            args = (g.to(bf16) if mx else g, dm["Wx"], u_seq, d["scale"],
                    d["alpha"], d["beta"], d["a"], d["b"], d["V"], 1.0,
                    d["u0"], d["w0"], d["s0"])
            kw = dict(recurrent=True, adaptive=True, drop_rate=smoke.P_DROP,
                      seed=seed, mxu_bf16=mx)
            res[f"dv_radlif_{shape[0]}x{shape[2]}" + ("_bf16" if mx else "")] \
                = smoke.split_ms_of(
                    lambda split: fused_cells._fused_cell_bwd_cuda(
                        *args, **kw, split_ms=split), n=9)["dv_product"]
    for h in (smoke.H, smoke.TP_H):
        ashape = (smoke.B, smoke.T, h)
        ga = torch.randn(ashape, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
        a = smoke.ann_inputs("gru", ashape, 4, dev)
        for mx in (False, True):
            am = dict(a, wxs=[w.to(bf16) for w in a["wxs"]]) if mx else a
            r = smoke.ann_forward("gru", am, True, smoke.P_DROP, seed, True,
                                  bf16=mx)[1:]
            res[f"dv_gru_h{h}" + ("_bf16" if mx else "")] = smoke.split_ms_of(
                lambda split: smoke.ann_backward(
                    "gru", am, ga.to(bf16) if mx else ga, r, seed, True,
                    bf16=mx, split_ms=split), n=9)["dv_product"]
# the recurrent spiking forwards, every output's bits on a non-dyadic V
# with s0 drawn from U[0, 1): RLIF and RadLIF, the serving form with the
# affine on and off and the training form with the affine and the dropout
# on and off, both modes, at (128, 100, 512) and (256, 100, 1024); the TP
# forward (RLIF, RadLIF) at (256, 100, 1024), P = 1, 2, 4, both modes,
# training and serving form; RadLIF's training forms timed
with torch.no_grad():
    for shape in ((smoke.B, smoke.T, smoke.H),
                  (2 * smoke.B, smoke.T, smoke.TP_H)):
        d = smoke.cell_inputs(shape, dyadic=False, seed=1, dev=dev)
        d["s0"] = torch.rand(d["s0"].shape, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5))
        for name in ("rlif", "radlif"):
            rec, ada = smoke.FORMS[name]
            for mx in (False, True):
                dm = dict(d, Wx=d["Wx"].to(bf16)) if mx else d
                base = (f"cell_fwd_{name}_{shape[0]}x{shape[2]}"
                        + ("_bf16" if mx else ""))
                for affine in (True, False):
                    p = smoke._prepared(name, dm, affine)
                    dig[base + "_serving" + ("_affine" if affine else "")] = \
                        digest([fused_cells._fused_cell_cuda(
                            *p["args"], **p["kw"], mxu_bf16=mx)])
                for drop in (smoke.P_DROP, 0.0):
                    key = base + "_train" + ("_dropout" if drop else "")
                    run = lambda: smoke.train_forward_call(
                        name, dm, True, drop, seed if drop else None,
                        bf16=mx)
                    dig[key] = digest(run())
                    if name == "radlif":
                        res[key] = cuda_time_ms(run)
        for P in (1, 2, 4):
            dt = smoke.tp_cell_inputs(shape, seed=1, dev=dev, uniform_s0=True)
            dt["V"] = smoke.cell_inputs(shape, dyadic=False, seed=1,
                                        dev=dev)["V"]
            for name in ("rlif", "radlif"):
                args, ada = smoke._tp_args(name, dt)
                for mx in (False, True):
                    kw = dict(num_devices=P, adaptive=ada, mxu_bf16=mx)
                    key = (f"tp_cell_fwd_{name}_{shape[0]}x{shape[2]}_p{P}"
                           + ("_bf16" if mx else ""))
                    run = lambda: fused_tp._tp_cell_cuda(
                        *args, save_residuals=True, **kw)
                    dig[key] = digest(run())
                    dig[key + "_serving"] = digest(
                        [fused_tp._tp_cell_cuda(*args, **kw)])
                    if name == "radlif":
                        res[key] = cuda_time_ms(run)
# the spiking backwards, every output's bits: every form with the affine
# and the dropout on and off in both modes at (128, 100, 512), RadLIF at
# the (256, 100, 1024) of the bidirectional RadLIF 1024 auto trainer; the
# TP backward (RLIF, RadLIF) at (256, 100, 1024), P = 1, 2, 4, both modes
with torch.no_grad():
    for shape in ((smoke.B, smoke.T, smoke.H),
                  (2 * smoke.B, smoke.T, smoke.TP_H)):
        main = shape[2] == smoke.H
        d = smoke.cell_inputs(shape, dyadic=True, seed=1, dev=dev)
        d["s0"] = torch.rand(d["s0"].shape, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5))
        g = torch.randn(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
        for name in smoke.FORMS if main else ("radlif",):
            rec, ada = smoke.FORMS[name]
            for mx in (False, True):
                dm = dict(d, Wx=d["Wx"].to(bf16)) if mx else d
                gm = g.to(bf16) if mx else g
                _, u_seq = smoke.train_forward_call(name, dm, True, seed=seed,
                                                    bf16=mx)
                flags = ((True, smoke.P_DROP), (True, 0.0), (False, smoke.P_DROP),
                         (False, 0.0)) if main else ((True, smoke.P_DROP),)
                for affine, drop in flags:
                    args = (gm, dm["Wx"], u_seq, d["scale"] if affine else None,
                            d["alpha"], d["beta"], d["a"], d["b"], d["V"], 1.0,
                            d["u0"], d["w0"], d["s0"])
                    kw = dict(recurrent=rec, adaptive=ada, drop_rate=drop,
                              seed=seed, mxu_bf16=mx)
                    key = (f"cell_bwd_{name}_{shape[0]}x{shape[2]}"
                           + ("_affine" if affine else "")
                           + ("_dropout" if drop else "")
                           + ("_bf16" if mx else ""))
                    dig[key] = digest(
                        fused_cells._fused_cell_bwd_cuda(*args, **kw))
                    if name == "radlif" and affine and drop:
                        res[key] = cuda_time_ms(
                            lambda: fused_cells._fused_cell_bwd_cuda(*args,
                                                                     **kw))
    tshape = (2 * smoke.B, smoke.T, smoke.TP_H)
    gt = torch.randn(tshape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(6))
    for name in ("rlif", "radlif"):
        dt = smoke.tp_cell_inputs(tshape, seed=1, dev=dev, uniform_s0=True)
        args, ada = smoke._tp_args(name, dt)
        for mx in (False, True):
            for P in (1, 2, 4):
                kw = dict(num_devices=P, adaptive=ada, mxu_bf16=mx)
                _, u_seq = fused_tp._tp_cell_cuda(*args, save_residuals=True,
                                                  **kw)
                ba = (gt.to(bf16) if mx else gt, u_seq, *args[1:])
                key = f"tp_cell_bwd_{name}_p{P}" + ("_bf16" if mx else "")
                dig[key] = digest(fused_tp._tp_cell_bwd_cuda(*ba, **kw))
                if name == "radlif":
                    res[key] = cuda_time_ms(
                        lambda: fused_tp._tp_cell_bwd_cuda(*ba, **kw))
# training steps through the spiking kernels, both modes: the RadLIF
# [512, 512, 35] auto trainer, and the bidirectional RadLIF [1024, 1024, 35]
# trainer through auto and pallas_tp at P = 1, 2, 4 (losses of two steps and
# the first step's gradients digested)
gen = torch.Generator(device=dev).manual_seed(21)
xr = (torch.rand((smoke.B, smoke.T, smoke.F), generator=gen, device=dev)
      < 0.02).float()
yr = torch.randint(0, smoke.C, (smoke.B,), generator=gen, device=dev)
xt = torch.randn((smoke.B, smoke.T, smoke.TP_F), generator=gen, device=dev)
yt = torch.randint(0, smoke.C, (smoke.B,), generator=gen, device=dev)
sd512, sd1024 = smoke.training_state(dev), smoke.tp_training_state()
big = dict(sizes=smoke.TP_SIZES, bidirectional=True)
for mx in (False, True):
    sfx, kw16 = ("_bf16", dict(compute_dtype=bf16)) if mx else ("", {})
    for key, impl, sd, x, y, kw in (
            ("radlif512_auto", "auto", sd512, xr, yr, {}),
            ("radlif1024_auto", "auto", sd1024, xt, yt, big),
            *((f"radlif1024_tp_p{P}", "pallas_tp", sd1024, xt, yt,
               dict(big, tp_mesh=smoke.tp_mesh(dev, P))) for P in (1, 2, 4))):
        model, state, losses, grads, _ = smoke.train_run(
            dev, impl, sd, x, y, 2, **kw, **kw16)
        dig["train_" + key + sfx] = digest(
            [torch.tensor(losses)] + [grads[k] for k in sorted(grads)])
        res["train_step_" + key + sfx] = cuda_time_ms(
            make_train_step(model), state, x, y, warmup=3, iters=20,
            repeats=3)
        if key == "radlif1024_auto":
            # the same step after 25 more steps, its layers firing as a
            # trained run's do (the spiking dV product is dense: its time
            # must not move with the rate), and those rates
            step = make_train_step(model)
            for _ in range(25):
                state = step(state, x, y)[0]
            res["train_step_" + key + "_trained" + sfx] = cuda_time_ms(
                step, state, x, y, warmup=3, iters=20, repeats=3)
            with torch.no_grad():
                rates = model(x, state.generator)[1].float()
            layers = rates.reshape(len(smoke.TP_SIZES) - 1, -1).mean(1)
            for i, r in enumerate(layers.tolist()):
                res[f"rate_{key}_trained_l{i}" + sfx] = r
# training steps through cell_impl="auto": the GRU [512, 512, 35] trainer
# of training_ann and its bf16 twin, and the GRU [1024, 1024, 35] auto
# trainer of training_tp_ann
gen = torch.Generator(device=dev).manual_seed(21)
x = torch.randn((smoke.B, smoke.T, smoke.F_ANN), generator=gen, device=dev)
y = torch.randint(0, smoke.C, (smoke.B,), generator=gen, device=dev)
sd = build_model("GRU", (smoke.B, smoke.T, smoke.F_ANN),
                 [smoke.H, smoke.H, smoke.C], dropout=smoke.P_DROP,
                 generator=torch.Generator().manual_seed(0)).state_dict()
sd1024 = smoke.tp_ann_state("GRU")
cases = [("gru512", "auto", sd, {}),
         ("gru512_bf16", "auto", sd, dict(compute_dtype=bf16)),
         ("gru1024", "auto", sd1024, dict(sizes=smoke.TP_SIZES))]
# and the pallas_tp GRU [1024, 1024, 35] trainer of training_tp_ann at
# each P, in both modes
for P in (1, 2, 4):
    for mx in (False, True):
        cases.append((f"gru1024_tp_p{P}" + ("_bf16" if mx else ""),
                      "pallas_tp", sd1024,
                      dict(sizes=smoke.TP_SIZES, tp_mesh=smoke.tp_mesh(dev, P),
                           **(dict(compute_dtype=bf16) if mx else {}))))
for key, impl, state_dict, kw in cases:
    model, state = smoke.train_run(dev, impl, state_dict, x, y, 1,
                                   model_type="GRU", **kw)[:2]
    res["train_step_" + key] = cuda_time_ms(make_train_step(model), state, x,
                                            y, warmup=3, iters=20, repeats=3)
from pathlib import Path
tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
# every kernel of every library: SASS instructions, registers and stack
# bytes (spills included), by mangled name, less the hash that names the
# anonymous namespace of each tree's build
def name(fn):
    return re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "anon::", fn)
code = {}
for lib in _build.SOURCES:
    def dump(flag):
        return subprocess.run([tool, flag, str(_build.library_path(lib))],
                              capture_output=True, text=True).stdout
    funcs = code.setdefault(lib, {})
    for m in re.finditer(r"Function : (\S+)\n(.*?)(?=\n\s*Function :|\Z)",
                         dump("-sass"), re.S):
        funcs.setdefault(name(m.group(1)), {})["sass"] = len(
            re.findall(r"^\s+/\*[0-9a-f]{4}\*/", m.group(2), re.M))
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+) STACK:(\d+)",
                         dump("-res-usage")):
        funcs.setdefault(name(m.group(1)), {}).update(regs=int(m.group(2)),
                                                      stack=int(m.group(3)))
# the ptxas report (-Xptxas -v) of the cell kernels with a product: each
# library's summary, and every entry that spills
ptxas = {}
for lib in REPORT_LIBS:
    entries = re.findall(
        r"Compiling entry function '(\S+)' for[^\n]*\n(?:[^\n]*\n)*?"
        r"[^\n]*?(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers",
        logs.get(lib, ""))
    ptxas[lib] = dict(smoke.ptxas_summary(logs.get(lib, "")),
                      spilling={name(e): [int(r), int(sp)]
                                for e, sp, r in entries if int(sp)})
print(json.dumps({"phase": "ab", "tree": root, "ms": res, "digests": dig,
                  "code": code, "ptxas": ptxas}), flush=True)
"""

# the libraries, and within four of them the kernels, that the change to the
# dV products leaves alone (value: a pattern of the kernels left out of the
# comparison): their code must stay as the other tree compiles it
AB_UNTOUCHED = {
    "readout_fwd": None, "readout_bwd": None, "fused_ann_fwd": None,
    "tp_collectives": None, "tp_ann_fwd": None, "fused_cell_fwd": None,
    "tp_cell_fwd": None,
    # every kernel of the backwards but the dV products (dv_product.cuh)
    "fused_cell_bwd": r"dv_kernel", "tp_cell_bwd": r"dv_kernel",
    "fused_ann_bwd": r"dv_kernel",
    "tp_ann_bwd": r"dv_kernel",
}


def ab(dev, other: str):
    """Phase 8: ``other`` and this tree in turns, each in its own process.
    Each run's whole record goes to build/ab/ab_<i>.json; the output
    has each run's times and ptxas report, then, per untouched library,
    the kernels whose SASS count, registers or stack bytes differ between
    the two trees; then ``ab_step`` (``step_pairs``)."""
    here = str(REPO)
    out_dir = REPO / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, root in enumerate((str(Path(other).resolve()), here, here,
                              str(Path(other).resolve()))):
        proc = subprocess.run([sys.executable, "-c", _AB_CODE, root],
                              capture_output=True, text=True, timeout=1500,
                              cwd=root)
        if proc.returncode != 0:
            raise RuntimeError(f"ab: {root} failed:\n{proc.stderr[-2000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        (out_dir / f"ab_{i}.json").write_text(line)
        run = json.loads(line)
        runs.append(run)
        emit("ab", tree=run["tree"], ms=run["ms"], ptxas=run["ptxas"])
    digests = [r["digests"] for r in runs]
    keys = sorted(set().union(*digests))
    emit("ab_digests", cases=len(keys),
         equal=[k for k in keys if len({d.get(k) for d in digests}) == 1],
         differ={k: [d.get(k) for d in digests] for k in keys
                 if len({d.get(k) for d in digests}) != 1})
    parent, change = runs[0]["code"], runs[1]["code"]
    for lib, skip in AB_UNTOUCHED.items():
        a, b = ({k: v for k, v in x.get(lib, {}).items()
                 if not (skip and re.search(skip, k))}
                for x in (parent, change))
        moved = {k: [a.get(k), b.get(k)] for k in sorted(set(a) | set(b))
                 if a.get(k) != b.get(k)}
        emit("ab_code", library=lib, kernels=len(b), same=len(b) - len(moved),
             moved=moved)
    step_pairs(other)


# runs in a process of its own with a tree's root as argv[1] and stays up:
# the RadLIF [512, 512, 35] auto trainer of that tree's chip_smoke, float32
# and bf16; prints the names of its steps, then for each line it reads the
# named step's ms, or for "profile" (the profiler stays attached to the
# process once it ran, so it comes last) each step's kernels and copies by
# name and the device's idle share
_STEP_CODE = r"""
import collections, importlib.util, json, re, sys
import torch
root = sys.argv[1]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("smoke", root + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from torch.profiler import ProfilerActivity, profile
from sparch_tpu_torch import _build
from sparch_tpu_torch.train import make_train_step
from sparch_tpu_torch.utils.timing import cuda_time_ms
if not _build.__file__.startswith(root):
    raise RuntimeError("imported the package of another tree")
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(21)
x = (torch.rand((smoke.B, smoke.T, smoke.F), generator=gen, device=dev)
     < 0.02).float()
y = torch.randint(0, smoke.C, (smoke.B,), generator=gen, device=dev)
sd = smoke.training_state(dev)
steps = {}
for mx in (False, True):
    kw = dict(compute_dtype=torch.bfloat16) if mx else {}
    model, state = smoke.train_run(dev, "auto", sd, x, y, 3, **kw)[:2]
    steps["radlif512_auto" + ("_bf16" if mx else "")] = (
        make_train_step(model), state)
print(json.dumps({"tree": root, "steps": list(steps)}), flush=True)


def per_step(fn, state, n=5):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            fn(state, x, y)
        end.record()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    names = collections.Counter(
        re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
        .split("<")[0].split("(")[0] for e in ev)
    copies = sum(c for k, c in names.items()
                 if k.startswith(("Memcpy", "Memset")))
    busy = sum(e.device_time for e in ev)
    return dict(kernels=(len(ev) - copies) / n, copies_and_sets=copies / n,
                device_us=busy / n,
                idle_share_profiled=1.0 - busy / (1e3 * start.elapsed_time(
                    end)),
                by_name={k: c / n for k, c in names.most_common()})


for line in sys.stdin:
    key = line.strip()
    if key == "profile":
        out = {k: per_step(*v) for k, v in steps.items()}
    else:
        fn, state = steps[key]
        out = cuda_time_ms(fn, state, x, y, warmup=3, iters=20, repeats=3)
    print(json.dumps(out), flush=True)
"""


def step_pairs(other: str, pairs: int = 10):
    """The RadLIF [512, 512, 35] ``auto`` step of ``other`` and this tree
    (float32, bf16), each tree's trainer in one process that stays up (its
    kernels are built once): ``pairs`` alternating pairs (other, this,
    this, other, ...) of the step's ms, the idle process waiting on its
    input meanwhile; then each tree's kernels and copies a step."""
    out_dir = REPO / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    roots = (str(Path(other).resolve()), str(REPO))
    procs = []

    def ask(i, line=None):
        if line is not None:
            procs[i].stdin.write(line + "\n")
            procs[i].stdin.flush()
        out = procs[i].stdout.readline()
        if not out:
            raise RuntimeError(f"ab_step: {roots[i]} failed; see "
                               f"{out_dir / f'step_{i}.err'}")
        return json.loads(out)

    try:
        for i, root in enumerate(roots):
            with open(out_dir / f"step_{i}.err", "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _STEP_CODE, root], cwd=root,
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=err, text=True))
            keys = ask(i)["steps"]
        ms = [{k: [] for k in keys} for _ in roots]
        for r in range(pairs):
            for i in ((0, 1) if r % 2 == 0 else (1, 0)):
                for k in keys:
                    ms[i][k].append(ask(i, k))
        counts = [ask(i, "profile") for i in range(2)]
    finally:
        for p in procs:
            p.stdin.close()
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for i, root in enumerate(roots):
        (out_dir / f"step_{i}.json").write_text(json.dumps(
            dict(tree=root, ms=ms[i], per_step=counts[i])))
        emit("ab_step", tree=root, ms=ms[i],
             per_step={k: {f: v for f, v in h.items() if f != "by_name"}
                       for k, h in counts[i].items()})


# runs in a process of its own with a tree's root and an output path: the
# single-card spiking backward's outputs (RadLIF) at widths on both sides
# of H = 512, every affine / dropout form and both modes; the recurrent
# spiking forwards' (RLIF, RadLIF; serving and training form, affine and
# dropout on and off, both modes, a non-dyadic V and s0 drawn from U[0, 1))
# at those widths, and the TP forward's at P = 1, 2, 4; saved for ``bits``
_BITS_CODE = r"""
import importlib.util, sys
import torch
root, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("smoke", root + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from sparch_tpu_torch import _build
from sparch_tpu_torch.ops import fused_cells
if not fused_cells.__file__.startswith(root):
    raise RuntimeError("imported the package of another tree")
_build.build()  # every library at once, not one at its first launch
dev = torch.device("cuda", 0)
seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
res = {}
with torch.no_grad():
    for b, h in ((128, 512), (16, 200), (256, 1024), (16, 600), (16, 1001),
                 (16, 1536), (16, 2048), (8, 3000), (4, 4096)):
        shape = (b, 20, h)
        d = smoke.cell_inputs(shape, dyadic=True, seed=1, dev=dev)
        d["s0"] = torch.rand(d["s0"].shape, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5))
        g = torch.randn(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
        for mx in (False, True):
            dm = dict(d, Wx=d["Wx"].to(torch.bfloat16)) if mx else d
            gm = g.to(torch.bfloat16) if mx else g
            _, u_seq = smoke.train_forward_call("radlif", dm, True,
                                                seed=seed, bf16=mx)
            for affine, drop in ((True, 0.1), (False, 0.0), (True, 0.0),
                                 (False, 0.1)):
                args = (gm, dm["Wx"], u_seq, d["scale"] if affine else None,
                        d["alpha"], d["beta"], d["a"], d["b"], d["V"], 1.0,
                        d["u0"], d["w0"], d["s0"])
                o = fused_cells._fused_cell_bwd_cuda(
                    *args, recurrent=True, adaptive=True, drop_rate=drop,
                    seed=seed, mxu_bf16=mx)
                res[(b, h, affine, drop, mx)] = [
                    None if x is None else x.cpu() for x in o]
    from sparch_tpu_torch.ops import fused_tp
    for b, h in ((128, 512), (12, 200), (256, 1024), (130, 600), (16, 1001),
                 (16, 1536), (16, 2048), (4, 4096)):
        d = smoke.cell_inputs((b, 20, h), dyadic=False, seed=1, dev=dev)
        d["s0"] = torch.rand(d["s0"].shape, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5))
        for name in ("rlif", "radlif"):
            for mx in (False, True):
                dm = dict(d, Wx=d["Wx"].to(torch.bfloat16)) if mx else d
                for affine in (True, False):
                    p = smoke._prepared(name, dm, affine)
                    o = fused_cells._fused_cell_cuda(*p["args"], **p["kw"],
                                                     mxu_bf16=mx)
                    res[("fwd", name, b, h, affine, -1.0, mx)] = [o.cpu()]
                    for drop in (0.1, 0.0):
                        o = fused_cells._fused_cell_cuda(
                            *p["args"], **p["kw"], drop_rate=drop,
                            seed=seed if drop else None, save_residuals=True,
                            mxu_bf16=mx)
                        res[("fwd", name, b, h, affine, drop, mx)] = [
                            x.cpu() for x in o]
    for b, h, ps in ((256, 1024, (1, 2, 4)), (24, 512, (1, 2, 4)),
                     (8, 4096, (2,))):
        d = smoke.cell_inputs((b, 20, h), dyadic=False, seed=2, dev=dev)
        d["s0"] = torch.rand(d["s0"].shape, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(5))
        for name in ("rlif", "radlif"):
            args, ada = smoke._tp_args(name, d)
            for P in ps:
                for mx in (False, True):
                    o = fused_tp._tp_cell_cuda(*args, num_devices=P,
                                               adaptive=ada, mxu_bf16=mx,
                                               save_residuals=True)
                    res[("tp_fwd", name, b, h, P, -1.0, mx)] = [
                        x.cpu() for x in o]
    # the backwards of the non-spiking cells (RNN, LiGRU, GRU) at widths on
    # both sides of the dV tiles, affine on and off, both modes, on the
    # residuals of their training forward; the TP backwards (spiking and
    # non-spiking) at P = 1, 2, 4
    from sparch_tpu_torch.ops import fused_ann, fused_tp_ann
    for b, h in ((128, 512), (16, 200), (128, 1024), (16, 1001), (8, 2048)):
        shape = (b, 20, h)
        g = torch.randn(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
        for mode in ("rnn", "ligru", "gru"):
            a = smoke.ann_inputs(mode, shape, 4, dev)
            for mx in (False, True):
                am = dict(a, wxs=[w.to(torch.bfloat16) for w in a["wxs"]]) \
                    if mx else a
                gm = g.to(torch.bfloat16) if mx else g
                y_raw, *gates = smoke.ann_forward(mode, am, True, 0.1, seed,
                                                  True, bf16=mx)[1:]
                for affine in (True, False):
                    o = fused_ann._ann_cell_bwd_cuda(
                        mode, gm, am["wxs"], y_raw, gates,
                        am["scales"] if affine else None, am["vs"], am["y0"],
                        drop_rate=0.1, seed=seed, mxu_bf16=mx)
                    res[("ann_bwd", mode, b, h, affine, mx)] = [
                        x.cpu() for x in (*o[0], *(o[1] or ()), *(o[2] or ()),
                                          *o[3], o[4])]
    for b, h, ps in ((16, 512, (1, 2, 4)), (64, 1024, (1, 2, 4)),
                     (8, 4096, (2,))):
        shape = (b, 20, h)
        g = torch.randn(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
        d = smoke.tp_cell_inputs(shape, seed=2, dev=dev, uniform_s0=True)
        args, ada = smoke._tp_args("radlif", d)
        for P in ps:
            for mx in (False, True):
                kw = dict(num_devices=P, adaptive=ada, mxu_bf16=mx)
                _, u_seq = fused_tp._tp_cell_cuda(*args, save_residuals=True,
                                                  **kw)
                o = fused_tp._tp_cell_bwd_cuda(
                    g.to(torch.bfloat16) if mx else g, u_seq, *args[1:], **kw)
                res[("tp_bwd", "radlif", b, h, P, mx)] = [
                    None if x is None else x.cpu() for x in o]
        if h > 2048:
            continue
        for mode in ("rnn", "ligru", "gru"):
            da = smoke.tp_ann_inputs(mode, shape, 4, dev)
            for P in ps:
                for mx in (False, True):
                    tk = dict(num_devices=P, mxu_bf16=mx)
                    y, gates = fused_tp_ann._tp_ann_cell_cuda(
                        mode, da["wxs"], da["vs"], da["y0"],
                        save_residuals=True, **tk)
                    o = fused_tp_ann._tp_ann_cell_bwd_cuda(
                        mode, g.to(torch.bfloat16) if mx else g, y, gates,
                        da["vs"], da["y0"], **tk)
                    res[("tp_ann_bwd", mode, b, h, P, mx)] = [
                        x.cpu() for x in (*o[0], *o[1], o[2])]
torch.save(res, out)
"""


def bits(dev, other: str):
    """Phase 11: where the single-card spiking backward's outputs differ
    between the tree ``other`` and this one (RadLIF, H = 200 .. 4096, every
    affine / dropout form, both modes), each tree in its own process: per
    case and gradient, the elements that differ and the largest difference
    relative to the gradient's largest magnitude."""
    out_dir = REPO / "build" / "bits"
    out_dir.mkdir(parents=True, exist_ok=True)
    saved = []
    for i, root in enumerate((str(Path(other).resolve()), str(REPO))):
        path = out_dir / f"bits_{i}.pt"
        proc = subprocess.run([sys.executable, "-c", _BITS_CODE, root,
                               str(path)], capture_output=True, text=True,
                              timeout=900, cwd=root)
        if proc.returncode != 0:
            raise RuntimeError(f"bits: {root} failed:\n{proc.stderr[-2000:]}")
        saved.append(torch.load(path))
    names = ("dWx", "dscale", "dshift", "dV", "dalpha", "dbeta", "da", "db",
             "du0", "dw0", "ds0")
    for key, a in saved[0].items():
        moved = {}
        kind = key[0] if isinstance(key[0], str) else "bwd"
        if kind not in ("bwd", "fwd", "tp_fwd"):
            # the backwards added later: outputs by position
            for i, (x, y) in enumerate(zip(a, saved[1][key])):
                if x is None or torch.equal(x, y):
                    continue
                gap = (x.float() - y.float()).abs()
                moved[i] = dict(elements=int((gap > 0).sum()),
                                max_rel=float(gap.max()
                                              / x.float().abs().max()))
            _, cell, b, h, flag, mx = key
            emit("bits", kernel={"ann_bwd": "fused_ann_bwd",
                                 "tp_bwd": "tp_cell_bwd",
                                 "tp_ann_bwd": "tp_ann_bwd"}[kind],
                 cell=cell, shape=[b, 20, h],
                 **({"affine": flag} if kind == "ann_bwd" else {"P": flag}),
                 mxu_bf16=mx, outputs=len(a), equal=not moved, differ=moved)
            continue
        for n, x, y in zip(("s", "u_seq") if kind != "bwd" else names, a,
                           saved[1][key]):
            if x is None or torch.equal(x, y):
                continue
            gap = (x.float() - y.float()).abs()
            moved[n] = dict(elements=int((gap > 0).sum()),
                            max_rel=float(gap.max()
                                          / x.float().abs().max()))
        if kind == "bwd":
            b, h, affine, drop, mx = key
            emit("bits", shape=[b, 20, h], affine=affine, drop_rate=drop,
                 mxu_bf16=mx, equal=not moved, differ=moved)
            continue
        _, name, b, h, flag, drop, mx = key
        emit("bits", kernel="tp_cell_fwd" if kind == "tp_fwd"
             else "fused_cell_fwd", cell=name, shape=[b, 20, h],
             **({"P": flag} if kind == "tp_fwd" else
                {"affine": flag, "form": "serving" if drop < 0 else
                 "training", "drop_rate": max(drop, 0.0)}),
             mxu_bf16=mx, equal=not moved, differ=moved)


def h2d(dev):
    import chip_smoke as cs

    xn = (torch.rand((cs.B, cs.T, cs.F)) < 0.02).float().numpy()
    torch.from_numpy(xn).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        torch.from_numpy(xn).to(dev)
    torch.cuda.synchronize()
    emit("h2d", ms_per_batch=(time.perf_counter() - t0) * 100,
         batch_bytes=xn.nbytes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from sparch_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _build.build()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0))

    def bf16(dev):
        for model_type in ("RadLIF", "GRU"):
            for kw in ({}, {"compute_dtype": torch.bfloat16}):
                profile(dev, model_type, impls=("auto",), **kw)
                profile_training(dev, model_type, impls=("auto",), **kw)

    phases = {
        "sweep": sweep,
        "profile": lambda dev: (profile(dev), profile(dev, "GRU")),
        "h2d": h2d,
        "bwd_sweep": bwd_sweep,
        "profile_training": lambda dev: (profile_training(dev),
                                         profile_training(dev, "GRU")),
        "bf16": bf16,
        "tp_exchange": tp_exchange,
        "spiking_bwd": spiking_bwd,
        "spiking_fwd": spiking_fwd,
        "dv_products": dv_products,
    }
    chosen = sys.argv[1:] or list(phases)
    unknown = [name for name in chosen
               if name not in phases
               and not name.startswith(("ab=", "bits="))]
    if unknown:
        print(f"chip_profile: unknown phases {unknown}", file=sys.stderr)
        return 2
    for name in chosen:
        if name.startswith("ab="):
            ab(dev, name[3:])
        elif name.startswith("bits="):
            bits(dev, name[5:])
        else:
            phases[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
