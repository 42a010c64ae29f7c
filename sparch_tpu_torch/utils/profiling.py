"""Profiler traces (counterpart of sparch_tpu/utils/profiling.py).

``trace(dir)`` wraps ``torch.profiler`` so that a training run can be
captured with ``--profile_dir``: the host's operators and, on a CUDA
device, the card's kernels and copies, written as one Chrome trace
(``chrome://tracing``, Perfetto) into the directory.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["trace"]


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """A ``torch.profiler`` trace of the block, written to
    ``<log_dir>/trace_<time>_<pid>.json`` at its end; CUDA activities too
    where ``device`` is a CUDA device (None: where a card is present).
    Does nothing when ``log_dir`` is None or empty. Yields the profiler
    (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))
