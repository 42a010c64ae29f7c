"""Offline batch inference (counterpart of sparch_tpu/serve/predictor.py).

Every chunk of the input is padded to ``batch_size``, so each forward sees
one shape; an SNN's summed softmax is normalised by its own mass and an
ANN's logits go through a softmax; models with ``state_init='uniform'``
draw their states from a generator re-seeded
with ``seed`` before every forward, so calls are deterministic. The input
goes in as float32 and the probabilities come back float32 whatever the
model's ``compute_dtype``.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from sparch_tpu_torch.utils.device import resolve_device

__all__ = ["Predictor", "load_experiment"]


def load_experiment(exp_folder: str, device=None):
    """Rebuild the trained model and its ``state_dict`` from an experiment
    folder of ``run_exp_torch.py``: the training loop records the
    architecture in the checkpoint's ``meta.json``. Returns
    ``(model, state_dict)``, the state dict on ``device`` (None: the CUDA
    card, which raises without one); feed them to :class:`Predictor` or
    to ``streaming_init``."""
    from sparch_tpu_torch.models import build_model_from_config
    from sparch_tpu_torch.train.checkpoint import load_state_tree

    device = resolve_device(device)
    ckdir = os.path.join(exp_folder, "checkpoints")
    meta_path = os.path.join(ckdir, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    cfg = meta.get("model")
    if cfg is None:
        raise ValueError(
            f"{meta_path} has no 'model' record; rebuild the model and "
            "pass its state dict directly"
        )
    if cfg.get("frontend") == "device":
        raise NotImplementedError(
            "a --frontend device experiment serves raw waveforms through "
            "the device fbank frontend, ROADMAP queue 1 item 5"
        )
    model = build_model_from_config(cfg, use_readout_layer=True)
    return model, load_state_tree(ckdir, device)["model"]


class Predictor:
    """Wraps a model and its ``state_dict`` for batched inference.

        predictor = Predictor(model, state_dict)
        labels, probs = predictor(x)          # x: (n, T, F), any n

    ``device=None`` is the CUDA card and raises without one;
    ``device="cpu"`` runs on the CPU.
    """

    @classmethod
    def from_experiment(cls, exp_folder: str, batch_size: int = 128,
                        seed: int = 0, device=None) -> "Predictor":
        """Load the best checkpoint of a ``run_exp_torch.py`` experiment
        for inference:

            predictor = Predictor.from_experiment("exp/test_exps/...")
            labels, probs = predictor(x)

        (see :func:`load_experiment`; use it directly with
        ``streaming_init`` for frame-by-frame serving)."""
        model, state_dict = load_experiment(exp_folder, device)
        return cls(model, state_dict, batch_size=batch_size, seed=seed,
                   device=device)

    def __init__(self, model, state_dict, batch_size: int = 128,
                 seed: int = 0, pad_multiple: int = 100, device=None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "sequence-sharded serving is ROADMAP queue 1 item 8 "
                "(parallel/seqpipe.py)"
            )
        if pad_multiple != 100:
            raise NotImplementedError(
                "pad_multiple buckets waveform frame counts, which need the "
                "device fbank frontend, ROADMAP queue 1 item 5"
            )
        self.device = resolve_device(device)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.seed = seed
        self._generator = (
            torch.Generator(device=self.device)
            if getattr(model, "state_init", None) == "uniform" else None
        )

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._generator is not None:
            self._generator.manual_seed(self.seed)
        out, _ = self.model(x, self._generator)
        if out.dtype == torch.bfloat16:
            # probabilities are float32 whatever the model computes in
            out = out.float()
        if getattr(self.model, "is_snn", False):
            # the SNN readout already sums per-step softmax posteriors:
            # normalising by its mass is the class probability
            return out / out.sum(dim=-1, keepdim=True)
        return torch.softmax(out, dim=-1)

    def __call__(self, x, lengths=None) -> Tuple[np.ndarray, np.ndarray]:
        """Predict labels for ``x: (n, T, F)``; returns (labels, probs)."""
        if lengths is not None:
            raise NotImplementedError(
                "waveform inputs (lengths=) need the device fbank frontend, "
                "ROADMAP queue 1 item 5"
            )
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if n == 0:
            c = self.model.num_outputs
            return np.zeros((0,), np.int64), np.zeros((0, c), np.float32)
        bs = self.batch_size
        probs_out = []
        for i in range(0, n, bs):
            chunk = x[i:i + bs]
            pad = bs - chunk.shape[0]
            if pad:  # one shape for every forward
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)]
                )
            probs = self._forward(torch.from_numpy(chunk).to(self.device))
            probs = probs.cpu().numpy()
            probs_out.append(probs[:bs - pad] if pad else probs)
        probs = np.concatenate(probs_out, axis=0)
        return probs.argmax(axis=-1), probs
