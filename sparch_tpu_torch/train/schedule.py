"""Reduce-on-plateau learning-rate schedule as explicit state (counterpart
of sparch_tpu/train/schedule.py, which it repeats line for line).

Plateau scheduling is driven by a metric, once per validation epoch: a
small pure-Python state machine with the semantics of torch's
``ReduceLROnPlateau`` defaults (the original sparch uses mode='max',
factor=0.7, patience=1, min_lr=1e-6): relative threshold 1e-4, `mode='max'`
comparison ``metric > best * (1 + threshold)`` and `mode='min'` comparison
``metric < best * (1 - threshold)`` whatever the sign of ``best``, the LR
reduced when the number of bad epochs exceeds ``patience`` and floored at
``min_lr``. The new LR goes to the optimizer through
``TrainState.set_lr``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ReduceLROnPlateau"]


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    mode: str = "max"
    factor: float = 0.7
    patience: int = 1
    threshold: float = 1e-4
    min_lr: float = 1e-6
    best: float = None  # type: ignore[assignment]
    num_bad_epochs: int = 0

    def __post_init__(self):
        if self.best is None:
            self.best = float("-inf") if self.mode == "max" else float("inf")

    def _is_better(self, metric: float) -> bool:
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold)
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Update with this epoch's metric; returns the (possibly reduced)
        LR."""
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "ReduceLROnPlateau":
        return cls(**d)
