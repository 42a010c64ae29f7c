"""Device mesh and tensor-parallel sharding rules (counterpart of the TP half
of sparch_tpu/parallel/mesh.py).

A :class:`Mesh` lays devices out on the axes ``('data', 'model')``. The
``'model'`` axis is the tensor-parallel (TP) axis of the fused TP cells
(``ops/fused_tp.py``): each of its P ranks owns H/P neurons of a layer.

Two forms of the ``'model'`` axis, one function:

- the **one-card form**: ``make_mesh([dev] * P, model=P)`` repeats one
  device P times, and the TP kernels run all P ranks in one cooperative
  launch on that device, each rank storing into its peers' exchange buffers
  in the one card's memory (``mesh.one_card``);
- the **form across cards**: ``make_mesh([cuda:0, .., cuda:P-1], model=P)``
  puts rank r on the r-th card, each card at most once, as the JAX mesh puts
  a rank on each chip. The TP spiking kernels and collectives then make one
  launch a card and store into the peers' buffers over NVLink
  (``ops/tp_cards.py``); building the mesh checks and enables peer access
  between every pair (a pair without it raises). ``mesh.cards`` are the
  rank devices, ``mesh.home`` rank 0's card, where the layer's tensors
  live: the entry points scatter the blocks and gather the results.

A list that mixes repeated and distinct devices is refused, and so is any
device beside a CUDA card but another card. Still refused (ROADMAP queue 1
item 7c): the TP ANN cells across cards, a data axis of processes that
hold several cards each, and the JAX module's ``shard_state``/``replicate``
(parameters stay whole on ``home``).

The ``'data'`` axis is the processes of a data-parallel run
(``parallel.multihost``, started with ``python -m torch.distributed.run
--nproc_per_node R``): each process holds one row of the mesh, its
``'model'`` axis in the one-card form on its own card, so under R ranks
``make_mesh([dev] * P, model=P)`` is the (R, P) mesh. A ``'data'`` axis
longer than the processes is refused.

:func:`model_param_shard_dims` carries the JAX ``_pspec_for_param`` name
rules over to the port's ``state_dict`` names: which dimension of each
tensor the ``'model'`` axis would shard, for item 7c to place them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from sparch_tpu_torch.parallel import multihost

__all__ = ["Mesh", "make_mesh", "model_param_shard_dims", "visible_cards",
           "placement"]

AXES = ("data", "model")


class Mesh:
    """Devices on the axes ``('data', 'model')``: ``devices[d][m]``, the
    rows this process holds; ``processes`` data-parallel processes hold one
    such block each."""

    axis_names = AXES

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 processes: int = 1):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in devices)
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty rectangle of devices")
        self.processes = processes

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices) * self.processes,
                "model": len(self.devices[0])}

    @property
    def one_card(self) -> bool:
        """Every rank of the mesh lies on one device: the form in which the
        TP kernels run all ranks in one launch."""
        return len({d for row in self.devices for d in row}) == 1

    @property
    def device(self) -> torch.device:
        """The one device of a one-card mesh."""
        if not self.one_card:
            raise ValueError("a mesh over several devices has no one device")
        return self.devices[0][0]

    @property
    def cards(self):
        """The ``'model'`` axis' devices in rank order (one device repeated
        in the one-card form)."""
        return self.devices[0]

    @property
    def home(self) -> torch.device:
        """Where the layer's tensors live: rank 0's device."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        ranks = (f", one of {self.processes} processes"
                 if self.processes > 1 else "")
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}"
                f", devices={[str(d) for d in self.devices[0]]}{ranks})")


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """A ``('data', 'model')`` mesh over this process's ``devices``
    (default: its card, ``multihost.local_device()``, repeated ``model``
    times).
    A list that repeats one device P times is the one-card form of a P-rank
    TP axis: ``make_mesh([torch.device('cuda')] * 4, model=4)``; P distinct
    cards are the form across cards, ``make_mesh([torch.device('cuda', i)
    for i in range(4)], model=4)``. Under R data-parallel processes each
    holds one row, and the mesh's ``data`` axis is R."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices= (e.g. [torch.device('cpu')] "
                "* P for the plain versions on the CPU)"
            )
        devices = [multihost.local_device()] * model
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    procs = multihost.world_size()
    if data is None:
        data = n // model * procs
    if data * model != n * procs:
        raise ValueError(f"mesh {data}x{model} != {n * procs} devices")
    if data > procs:
        raise NotImplementedError(
            f"a 'data' axis of {data} over {procs} process(es): the data "
            "axis is the processes, one row of the mesh each; start the "
            f"ranks with python -m torch.distributed.run --nproc_per_node "
            f"{data} (parallel/multihost.py)"
        )
    mesh = Mesh([devices], processes=procs)
    if not mesh.one_card:
        check_cards(devices, "TP ranks")
        if procs > 1:
            raise NotImplementedError(
                "TP ranks across cards under data-parallel processes (each "
                "process holds one card): ROADMAP queue 1 item 7c")
        from sparch_tpu_torch.ops import tp_cards

        tp_cards.enable_peers(devices)
    return mesh


def check_cards(devices: Sequence[torch.device], what: str) -> None:
    """The rule of a list of devices that is not one device repeated: P
    distinct CUDA cards, each at most once."""
    if len(set(devices)) != len(devices):
        raise ValueError(
            f"{what}: {[str(d) for d in devices]} mixes repeated and distinct "
            "devices; give one device repeated (the one-card form) or "
            "distinct cards, each once")
    if any(d.type != "cuda" or d.index is None for d in devices):
        raise NotImplementedError(
            f"{what} on distinct devices run across CUDA cards only (ROADMAP "
            f"queue 1 item 7b), each named by its index: got "
            f"{[str(d) for d in devices]}; the one-card form repeats one "
            "device (make_mesh([dev] * P, model=P))")


def visible_cards(device: torch.device) -> int:
    """C, the cards this process may place a mesh on: every card it sees
    for a CUDA device, except under data-parallel processes (one card a
    process, ``parallel/multihost.py``); 1 elsewhere."""
    device = torch.device(device)
    if device.type != "cuda" or multihost.data_parallel():
        return 1
    return torch.cuda.device_count()


def placement(S: int, P: int, C: int):
    """Where the S x P stages and ranks of a run go, given C visible cards:
    ``(None, note)`` for the one-card form (C = 1, or S*P = 1 whatever C
    is: every stage and rank on the process's one device), ``(cards,
    note)`` for the form across cards (C >= S*P > 1: ``cuda:0 .. S*P-1``,
    the note naming the cards left idle); raises where 1 < C < S*P. The
    note is the log's."""
    n = S * P
    if C <= 1 or n == 1:
        return None, (f"the one-card form: the {n} stage(s) x rank(s) on "
                      "the process's one device")
    if C < n:
        raise ValueError(
            f"{S} pipeline stage(s) x {P} TP rank(s) = {n} cards, but this "
            f"process sees {C}: the form across cards takes one card each; "
            "show it one card (CUDA_VISIBLE_DEVICES) for the one-card form")
    cards = [torch.device("cuda", i) for i in range(n)]
    idle = [f"cuda:{i}" for i in range(n, C)]
    return cards, (f"across cards: {[str(c) for c in cards]}"
                   + (f", idle: {idle}" if idle else ""))


_DENSES = ("W", "Wz", "Wr")
_RECURRENT = ("V", "Vz", "Vr")


def _shard_dim(key: str, v_cols: bool) -> Optional[int]:
    """The JAX ``_pspec_for_param`` rule for one port ``state_dict`` key.
    A flax kernel is (in, out) and sharded on out; the port's weight is
    (out, in), so it is sharded on dim 0."""
    parts = key.split(".")
    if parts[0] == "readout":
        return None
    leaf = parts[-1]
    if len(parts) == 3 and parts[1] in _DENSES:
        return 0  # kernel (P(None, 'model')) and bias (P('model'))
    if leaf in ("alpha", "beta", "a", "b"):
        return 0
    if leaf in _RECURRENT:
        return 1 if v_cols else 0
    if len(parts) == 3 and leaf in ("weight", "bias", "running_mean",
                                    "running_var"):
        return 0  # a norm's scale/bias and batch statistics
    return None


def model_param_shard_dims(state_dict: Mapping[str, torch.Tensor],
                           v_cols: bool = False) -> Dict[str, Optional[int]]:
    """For each ``state_dict`` key, the dimension the ``'model'`` axis
    shards, or None where the tensor is replicated (the readout, and
    anything the rules do not name). ``v_cols`` shards the recurrent
    matrices by column, the layout the fused TP cells read (each rank's
    ``V[:, shard]``), else by row."""
    return {k: _shard_dim(k, v_cols) for k in state_dict}
