"""Training state (counterpart of sparch_tpu/train/state.py): the model,
its Adam optimizer, the step count and the run's random generator.

The JAX package threads an immutable pytree through jitted steps; here the
state is a small mutable object, and a step updates the model's parameters
and the optimizer's moments in place. Adam has torch's default
hyperparameters (betas 0.9/0.999, eps 1e-8 outside the root, as in optax's
``adam``), and a learning rate that ``set_lr`` can change between epochs
for the plateau schedule (``train/schedule.py``).
"""
from __future__ import annotations

import torch

from sparch_tpu_torch.utils.device import resolve_device

__all__ = ["TrainState", "create_train_state"]


class TrainState:
    """``model`` (on its device), ``optimizer``, ``step`` (Python int, the
    number of updates taken) and ``generator`` (on the model's device):
    uniform state inits, dropout seeds and dropout masks are drawn from
    it, so one seed fixes a run."""

    def __init__(self, model, optimizer, generator, device):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.device = device
        self.step = 0

    @property
    def lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def set_lr(self, lr: float) -> "TrainState":
        """Set the learning rate of the next step; returns the state."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        return self


def create_train_state(model, lr: float, device=None,
                       seed: int = 0) -> TrainState:
    """Move ``model`` to ``device`` and build its training state.
    ``device=None`` is the CUDA card and raises without one;
    ``device="cpu"`` trains on the CPU. The model keeps the parameters it
    was built with (``build_model(..., generator=...)`` seeds them)."""
    device = resolve_device(device)
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model, optimizer, generator, device)
