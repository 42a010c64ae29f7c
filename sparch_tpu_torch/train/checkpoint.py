"""Checkpoints of the whole training state (counterpart of
sparch_tpu/train/checkpoint.py).

``<exp>/checkpoints/best_model/`` is a directory, as the JAX package's
Orbax checkpoint is, holding one ``torch.save`` file: the model's
``state_dict`` (parameters and running statistics), the optimizer's
``state_dict`` (Adam's moments, its step and the learning rate), the
state of the run's random generator and the step count. A restored state
continues the run it was saved from bit for bit. ``meta.json`` beside it
(the epoch, the best accuracy, the scheduler and the ``model`` record) is
written to a temporary file and moved into place, so that a crash never
leaves half a file for the next ``--auto_resume``.

Under data parallelism every rank holds the same state: rank 0 writes and
the others wait at a barrier until it is written, and a restore reads the
same files on every rank (the JAX ``save_checkpoint`` writes its metadata
from process 0 alone).
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import torch

from sparch_tpu_torch.parallel import multihost
from sparch_tpu_torch.train.state import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "checkpoint_exists"]

_STATE_DIR = "best_model"
_STATE_FILE = "state.pt"
_META_FILE = "meta.json"


def checkpoint_exists(checkpoint_dir: str) -> bool:
    return os.path.isdir(os.path.join(checkpoint_dir, _STATE_DIR))


def _replace_write(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(checkpoint_dir: str, state: TrainState, meta: dict) -> None:
    """Save (overwrite) the best-model checkpoint and its JSON metadata
    (rank 0's; every rank returns once it is written)."""
    if multihost.is_main():
        _write(checkpoint_dir, state, meta)
    multihost.barrier()


def _write(checkpoint_dir: str, state: TrainState, meta: dict) -> None:
    path = os.path.join(checkpoint_dir, _STATE_DIR)
    os.makedirs(path, exist_ok=True)
    tree = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "step": state.step,
    }
    _replace_write(os.path.join(path, _STATE_FILE),
                   lambda tmp: torch.save(tree, tmp))

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)

    _replace_write(os.path.join(checkpoint_dir, _META_FILE), write_meta)


def load_state_tree(checkpoint_dir: str, device) -> dict:
    """The saved tree, its tensors on ``device``."""
    path = os.path.join(checkpoint_dir, _STATE_DIR, _STATE_FILE)
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(
    checkpoint_dir: str, template: TrainState
) -> Tuple[TrainState, dict]:
    """Restore into ``template`` (a state of the same model and optimizer
    configuration), in place; returns it and the metadata."""
    tree = load_state_tree(checkpoint_dir, template.device)
    template.model.load_state_dict(tree["model"], strict=True)
    template.optimizer.load_state_dict(tree["optimizer"])
    # Adam (create_train_state's, neither capturable nor fused) counts its
    # steps on the host, as a fresh optimizer does: a step count on the
    # card would cost a host sync a parameter and step
    for st in template.optimizer.state.values():
        if torch.is_tensor(st.get("step")):
            st["step"] = st["step"].cpu()
    # a generator's state is a CPU byte tensor, whatever its device
    template.generator.set_state(tree["generator"].cpu())
    template.step = int(tree["step"])
    meta_path = os.path.join(checkpoint_dir, _META_FILE)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return template, meta
