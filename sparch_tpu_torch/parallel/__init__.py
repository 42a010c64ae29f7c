"""Parallel layouts (counterpart of sparch_tpu/parallel): the device mesh,
the tensor-parallel sharding rules and multi-process data parallelism
(``multihost``: the process group, the global batch's statistics, draws
and gradient). TP ranks on distinct cards and the sequence pipeline wait
(ROADMAP queue 1 items 7b and 8).
"""
from sparch_tpu_torch.parallel import multihost
from sparch_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    model_param_shard_dims,
)

__all__ = ["Mesh", "make_mesh", "model_param_shard_dims", "multihost"]
