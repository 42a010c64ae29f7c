"""Device timing on a CUDA card (counterpart of sparch_tpu/utils/timing.py).

A host clock around asynchronous launches measures only the enqueue, so
the time comes from CUDA events recorded on the current stream around
``iters`` back-to-back calls, after ``warmup`` calls; the result is the
median over ``repeats`` such windows. There is no CPU fallback: without a
card this raises.
"""
from __future__ import annotations

import statistics
from typing import Callable

import torch

__all__ = ["cuda_time_ms"]


def cuda_time_ms(fn: Callable, *args, warmup: int = 3, iters: int = 10,
                 repeats: int = 5) -> float:
    """Median milliseconds per call of ``fn(*args)`` on the current CUDA
    device."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)
