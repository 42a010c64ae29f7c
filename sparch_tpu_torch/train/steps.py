"""Train and eval steps (counterpart of sparch_tpu/train/steps.py).

A train step is the forward (hoisted projections, fused or plain cells),
the mean cross-entropy plus the optional firing-rate hinge regularizer,
the backward (through the fused backward kernels on the fused path) and
the Adam update. Metrics come back as device tensors and nothing inside a
step reads a value on the host, so steps queue on the card back to back;
the caller fetches metrics when it wants them.

Under data parallelism (``parallel.multihost``) each rank runs the step on
its slice of the global batch; the model's statistics and firing rates are
the global batch's, and one all-reduce of the flattened gradients, divided
by the ranks, gives every rank the global batch's gradient before the Adam
update, so that every rank takes the same step.

The logged loss is the cross-entropy *before* the regularizer is added, as
in the JAX package and the original sparch. Under
``compute_dtype=bfloat16`` the parameters, their gradients and Adam's
moments are float32 (the casts are inside the model); a bf16 input batch
is taken as it is (an integer spike raster is exact in bf16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sparch_tpu_torch.parallel import multihost

__all__ = ["make_train_step", "make_eval_step", "take_step", "eval_metrics"]


def _metrics(ce, out, rates, y, is_snn):
    pred = out.argmax(dim=-1)
    return {
        "loss": ce.detach(),
        "acc": (pred == y).float().mean(),
        "spike_rate": rates.detach().mean() if is_snn
        else torch.zeros((), device=out.device),
    }


def _f32_logits(out):
    """The loss is taken in float32 at least: an un-normalised ANN readout
    under ``compute_dtype=bfloat16`` emits bf16 logits."""
    return out.float() if out.dtype == torch.bfloat16 else out


def _check_state(state, model):
    if state.model is not model:
        raise ValueError("the state was created for another model")


def take_step(state, model, forward, y, use_regularizers: bool = False,
              reg_factor: float = 0.5, reg_fmin: float = 0.01,
              reg_fmax: float = 0.5):
    """The body of a train step, shared by :func:`make_train_step` and the
    time-pipelined step (``parallel/seqpipe.py``): ``forward()`` gives the
    model's ``(out, rates)``; the mean cross-entropy plus the optional
    firing-rate hinge, the backward, the gradients' mean over the ranks
    inside ``multihost.sharded()``, the Adam update. Returns ``(state,
    metrics)``."""
    is_snn = getattr(model, "is_snn", False)
    state.optimizer.zero_grad(set_to_none=True)
    out, rates = forward()
    ce = F.cross_entropy(_f32_logits(out), y)
    loss = ce
    if is_snn and use_regularizers:
        # hinge penalty on per-neuron firing rates
        reg_quiet = F.relu(reg_fmin - rates).sum()
        reg_burst = F.relu(rates - reg_fmax).sum()
        loss = loss + reg_factor * (reg_quiet + reg_burst)
    loss.backward()
    if multihost.is_sharded():
        # the global batch's gradient: the ranks' mean
        multihost.all_reduce_mean_(
            [p.grad for p in model.parameters() if p.grad is not None])
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        return state, _metrics(ce, out, rates, y, is_snn)


def make_train_step(model, use_regularizers: bool = False,
                    reg_factor: float = 0.5, reg_fmin: float = 0.01,
                    reg_fmax: float = 0.5):
    """Build the training step for ``model``.

    Returns ``train_step(state, x, y) -> (state, metrics)``: ``state`` is
    the ``TrainState`` of this model, updated in place and handed back;
    ``x`` is ``(B, T, F)`` and ``y`` integer labels ``(B,)``, both on the
    state's device; ``metrics`` = {loss, acc, spike_rate} as device
    tensors.
    """
    reg = dict(use_regularizers=use_regularizers, reg_factor=reg_factor,
               reg_fmin=reg_fmin, reg_fmax=reg_fmax)

    def train_step(state, x, y):
        _check_state(state, model)
        model.train()
        return take_step(state, model, lambda: model(x, state.generator), y,
                         **reg)

    return train_step


def make_eval_step(model):
    """Build the eval step: ``eval_step(state, x, y, generator=None) ->
    metrics``. ``generator`` drives the uniform state init (the original
    sparch randomises the states in eval too); it is unused with
    ``state_init='zeros'``."""

    @torch.no_grad()
    def eval_step(state, x, y, generator=None):
        _check_state(state, model)
        model.eval()
        return eval_metrics(model, *model(x, generator), y)

    return eval_step


def eval_metrics(model, out, rates, y):
    """The eval step's metrics of the model's ``(out, rates)``."""
    ce = F.cross_entropy(_f32_logits(out), y)
    return _metrics(ce, out, rates, y, getattr(model, "is_snn", False))
