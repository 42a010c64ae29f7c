"""Parallel layouts (counterpart of sparch_tpu/parallel): the device mesh and
the tensor-parallel sharding rules. Data parallelism, multi-host runs and the
sequence pipeline wait for ``torch.distributed`` (ROADMAP queue 1 items 7-8).
"""
from sparch_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    model_param_shard_dims,
)

__all__ = ["Mesh", "make_mesh", "model_param_shard_dims"]
