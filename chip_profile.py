#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's serving path on one CUDA card.

    python3 chip_profile.py

Prints JSON lines (tables of the profiler in between), each measured in
this run:

1. ``device``: the card's name and power limit (``nvidia-smi``).
2. ``sweep``: the fused-cell kernel alone at (B, T, H) = (128, 100, 512),
   LIF, RLIF and RadLIF, with scale 1 and the shift swept to move the
   firing rate; kernel ms (CUDA events) and the rate at which V rows are
   gathered (firing rate * H * H * 4 B * B * T over the kernel time).
3. ``profile``: ``torch.profiler`` over 5 forwards of one batch of the
   RadLIF [512, 512, 35] serving model of ``chip_smoke.py`` (its
   "calibrated" state), per ``cell_impl``: device time and kernel launches
   per forward, and the share of the fused cell, the readout kernel and
   the cuBLAS projections.
4. ``h2d``: the pageable numpy -> card copy of one float32 raster batch,
   the first step ``Predictor`` takes per batch.

Without a CUDA card it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
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


def profile(dev):
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from sparch_tpu_torch.models import build_model

    state = cs.serving_state(dev, zero_means=False)
    g = torch.Generator(device=dev).manual_seed(12)
    x = (torch.rand((cs.B, cs.T, cs.F), generator=g, device=dev) < 0.02)
    x = x.float()
    for impl in ("auto", "pallas", "scan"):
        m = build_model("RadLIF", (cs.B, cs.T, cs.F), [cs.H, cs.H, cs.C],
                        state_init="zeros", cell_impl=impl).to(dev).eval()
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
        print(f"=== {impl}")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=14,
                                        max_name_column_width=60))
        ev = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy = sum(e.device_time for e in ev)
        emit("profile", variant=impl,
             device_us_per_forward=busy / 5,
             kernels_per_forward=len(ev) / 5,
             fused_cell_share=_share(ev, "fused_cell_fwd") / busy,
             readout_kernel_share=_share(ev, "readout_fwd") / busy,
             gemm_share=_share(ev, "gemm", "sgemm", "cutlass") / busy)


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
    sweep(dev)
    profile(dev)
    h2d(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
