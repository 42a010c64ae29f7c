"""Device mesh and tensor-parallel sharding rules (counterpart of the TP half
of sparch_tpu/parallel/mesh.py).

A :class:`Mesh` lays devices out on the axes ``('data', 'model')``. The
``'model'`` axis is the tensor-parallel (TP) axis of the fused TP cells
(``ops/fused_tp.py``): each of its P ranks owns H/P neurons of a layer.

The port runs TP in its **one-card form**: ``make_mesh([dev] * P,
model=P)`` repeats one device P times, and the TP kernels then run all P
ranks in one cooperative launch on that device, each rank storing into its
peers' exchange buffers in the one card's memory (``mesh.one_card``). A mesh
whose TP ranks lie on distinct cards needs the peers' buffers mapped across
cards (CUDA IPC), an entry barrier and the cross-card dV forms of the TP
backwards; that is ROADMAP queue 1 item 7b, and such a mesh is refused until
then. So are the JAX module's ``shard_state``/``replicate``: the one-card
form keeps every tensor whole on its one device.

The ``'data'`` axis is the processes of a data-parallel run
(``parallel.multihost``, started with ``python -m torch.distributed.run
--nproc_per_node R``): each process holds one row of the mesh, its
``'model'`` axis in the one-card form on its own card, so under R ranks
``make_mesh([dev] * P, model=P)`` is the (R, P) mesh. A ``'data'`` axis
longer than the processes is refused.

:func:`model_param_shard_dims` carries the JAX ``_pspec_for_param`` name
rules over to the port's ``state_dict`` names: which dimension of each
tensor the ``'model'`` axis would shard, for item 7b to place them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from sparch_tpu_torch.parallel import multihost

__all__ = ["Mesh", "make_mesh", "model_param_shard_dims"]

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
    TP axis: ``make_mesh([torch.device('cuda')] * 4, model=4)``. Under R
    data-parallel processes each holds one row, and the mesh's ``data``
    axis is R."""
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
        raise NotImplementedError(
            "TP ranks on distinct cards need their exchange buffers mapped "
            "across cards: ROADMAP queue 1 item 7b; the one-card form "
            "repeats one device (make_mesh([dev] * P, model=P))"
        )
    return mesh


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
