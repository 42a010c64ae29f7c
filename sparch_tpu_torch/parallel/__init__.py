"""Parallel layouts (counterpart of sparch_tpu/parallel): the device mesh,
the tensor-parallel sharding rules, multi-process data parallelism
(``multihost``: the process group, the global batch's statistics, draws
and gradient) and the sequence pipeline (``seqpipe``: the time-pipelined
steps over a ``seq`` axis). TP ranks and pipeline stages run on one card
or one a card (``placement``: the rule over the cards a process sees);
what is still refused across cards is ROADMAP queue 1 item 7c.
"""
from sparch_tpu_torch.parallel import multihost
from sparch_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    model_param_shard_dims,
    placement,
    visible_cards,
)
from sparch_tpu_torch.parallel.seqpipe import (
    SeqMesh,
    draw_noise,
    make_seq_mesh,
    make_seqpipe_eval_step,
    make_seqpipe_predict,
    make_seqpipe_train_step,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "model_param_shard_dims",
    "placement",
    "visible_cards",
    "multihost",
    "SeqMesh",
    "make_seq_mesh",
    "draw_noise",
    "make_seqpipe_train_step",
    "make_seqpipe_eval_step",
    "make_seqpipe_predict",
]
