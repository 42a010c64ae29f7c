"""Multi-process runs: data parallelism over ``torch.distributed``
(counterpart of sparch_tpu/parallel/multihost.py).

The recipe, one process (rank) a card or several ranks on one card:

1. ``maybe_initialize()`` initialises the process group when the launcher's
   variables are set (``python -m torch.distributed.run --nproc_per_node R
   run_exp_torch.py ...`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
   ``MASTER_ADDR``/``MASTER_PORT``), or takes up a group the caller has
   initialised already; without either it does nothing (one process).
2. Each rank's loader takes ``num_shards=R`` and ``shard_index=r``:
   disjoint contiguous slices of the same global batch order (a shared
   shuffle seed), the counterpart of the JAX ``global_batch``.
3. Inside ``sharded()``, which the training loop opens around its train
   and eval steps, the model computes the single-process step of the
   global batch: its random draws are taken at the global batch's shape
   and each rank keeps its rows (``batch_rows``, ``draw_rows``), the batch
   statistics and the firing rates are means over the ranks
   (``mean_over_ranks``, whose backward all-reduces the incoming gradient
   too), and the train step averages the ranks' gradients
   (``all_reduce_mean_``). The JAX package has all of this by
   construction: its arrays are global. Outside ``sharded()`` a forward is
   its process's batch alone, process group or not (a server, streaming,
   an eval that one rank runs).

The backend is ``nccl`` when every rank has a card of its own, ``gloo``
when ranks share a card or run on the CPU. On CUDA tensors gloo implements
``all_reduce``, ``broadcast`` and ``barrier``, and only those are used.

``collective_counts()`` counts the all-reduces and their bytes by kind
since ``reset_collective_counts()``; inside ``timed()`` each also waits
for the card before and after and adds its milliseconds.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from datetime import timedelta
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "maybe_initialize",
    "data_parallel",
    "sharded",
    "is_sharded",
    "rank",
    "world_size",
    "backend",
    "local_device",
    "RowMap",
    "batch_rows",
    "draw_rows",
    "mean_over_ranks",
    "all_reduce_mean_",
    "broadcast_",
    "max_over_ranks",
    "barrier",
    "is_main",
    "collective_counts",
    "reset_collective_counts",
    "timed",
]

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# a rendezvous or a collective that waits longer than this raises
_TIMEOUT = timedelta(minutes=10)

_COUNTS = {"calls": {}, "bytes": {}, "ms": {}}
_TIMED = False
_SHARDED = False


def _choose_backend() -> str:
    """``nccl`` when every rank of this node has a card of its own."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    if torch.cuda.is_available() and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize() -> bool:
    """Initialise the process group when the launcher's variables are set;
    returns whether more than one process runs.

    Like the JAX function, it decides from the environment alone: with
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set it
    initialises from them (``env://``), with a group already initialised
    (a test's ``file://`` store) it takes that one, and otherwise it does
    nothing."""
    if not dist.is_available():
        return False
    if not dist.is_initialized():
        if not all(os.environ.get(k) for k in _LAUNCHER_VARS):
            return False
        be = _choose_backend()
        if be == "nccl":
            torch.cuda.set_device(local_device())
        dist.init_process_group(be, init_method="env://", timeout=_TIMEOUT)
    return dist.get_world_size() > 1


def data_parallel() -> bool:
    """Whether this process is one rank of several."""
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if data_parallel() else 0


def world_size() -> int:
    return dist.get_world_size() if data_parallel() else 1


def is_main() -> bool:
    """Rank 0, the one that writes folders, logs and checkpoints."""
    return rank() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if data_parallel() else None


def local_device() -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK % device_count`` (ranks beyond
    the cards share them)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % n)


@contextmanager
def sharded():
    """Mark the forwards and train steps run inside as a rank's slice of
    the global batch (see the module docstring); the training loop's
    decision, not the model's."""
    global _SHARDED
    was, _SHARDED = _SHARDED, True
    try:
        yield
    finally:
        _SHARDED = was


def is_sharded() -> bool:
    """Inside ``sharded()`` on one rank of several."""
    return _SHARDED and data_parallel()


class RowMap(NamedTuple):
    """Where a rank's rows lie in the global batch: local row ``b`` is
    global row ``(b // seg) * stride + off + b % seg``. ``seg`` is the
    rank's rows of one segment: the batch, of which a bidirectional layer
    stacks a second (the flipped sequence) on the batch dim."""

    seg: int
    stride: int
    off: int

    def global_rows(self, n_local: int) -> int:
        return n_local // self.seg * self.stride

    def index(self, n_local: int, device=None) -> torch.Tensor:
        b = torch.arange(n_local, device=device)
        return b // self.seg * self.stride + self.off + b % self.seg


def batch_rows(n: int) -> Optional[RowMap]:
    """The map of a rank's ``n`` batch rows (one segment) into the global
    batch of ``n * R`` rows; None outside ``sharded()``."""
    if not is_sharded():
        return None
    return RowMap(n, n * world_size(), n * rank())


def draw_rows(draw, shape: Sequence[int], rows: Optional[RowMap]):
    """``draw(global_shape)`` for the global batch, then the rank's rows
    (dim 0): a random draw that every world size takes alike."""
    if rows is None:
        return draw(tuple(shape))
    n = shape[0]
    t = draw((rows.global_rows(n),) + tuple(shape[1:]))
    return t.index_select(0, rows.index(n, t.device))


def _all_reduce(t: torch.Tensor, kind: str,
                op=dist.ReduceOp.SUM) -> None:
    """Reduce ``t`` over the ranks in place (a sum), counted under
    ``kind``."""
    calls, nbytes, ms = _COUNTS["calls"], _COUNTS["bytes"], _COUNTS["ms"]
    calls[kind] = calls.get(kind, 0) + 1
    nbytes[kind] = nbytes.get(kind, 0) + t.numel() * t.element_size()
    if _TIMED and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op)
    if _TIMED:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        ms[kind] = ms.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3


class _MeanOverRanks(torch.autograd.Function):
    """The mean over the ranks; its backward all-reduces the incoming
    gradient the same way, so that the ranks' parameter gradients, once
    averaged, are the global batch's."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        y = x.detach().clone()
        _all_reduce(y, kind)
        return y / world_size()

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone()
        _all_reduce(g, ctx.kind + "_grad")
        return g / world_size(), None


def mean_over_ranks(x: torch.Tensor, kind: str = "stats") -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiable (the identity
    outside ``sharded()``). Each rank must pass the same shape."""
    if not is_sharded():
        return x
    return _MeanOverRanks.apply(x, kind)


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     kind: str = "grads") -> None:
    """Replace each tensor by its mean over the ranks, in place, through
    one all-reduce of them flattened together."""
    if not data_parallel() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, kind)
    flat /= world_size()
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by rank 0's, in place, through one broadcast
    of them flattened together (counted under ``broadcast``)."""
    if not data_parallel() or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _COUNTS["calls"]["broadcast"] = _COUNTS["calls"].get("broadcast", 0) + 1
    _COUNTS["bytes"]["broadcast"] = (_COUNTS["bytes"].get("broadcast", 0)
                                     + flat.numel() * flat.element_size())
    dist.broadcast(flat, src=0)
    i = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[i:i + n].view_as(t))
            i += n


def max_over_ranks(n: int, device) -> int:
    """The largest of the ranks' ``n`` (a host sync; ``n`` on one
    process)."""
    if not data_parallel():
        return n
    t = torch.tensor([n], dtype=torch.int64, device=device)
    _all_reduce(t, "shape", op=dist.ReduceOp.MAX)
    return int(t.item())


def barrier() -> None:
    if data_parallel():
        dist.barrier()


def collective_counts() -> dict:
    """{"calls", "bytes", "ms"} by kind since the last reset (``ms`` only
    inside ``timed()``)."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def reset_collective_counts() -> None:
    for v in _COUNTS.values():
        v.clear()


@contextmanager
def timed():
    """Time each all-reduce (host clock, the card waited for on both
    sides) while the context is open."""
    global _TIMED
    was, _TIMED = _TIMED, True
    try:
        yield
    finally:
        _TIMED = was
