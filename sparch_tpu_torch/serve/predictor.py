"""Offline batch inference (counterpart of sparch_tpu/serve/predictor.py).

Every chunk of the input is padded to ``batch_size``, so each forward sees
one shape; an SNN's summed softmax is normalised by its own mass and an
ANN's logits go through a softmax; models with ``state_init='uniform'``
draw their states from a generator re-seeded
with ``seed`` before every forward, so calls are deterministic. The input
goes in as float32 and the probabilities come back float32 whatever the
model's ``compute_dtype``.

A model wrapped in the audio frontend (``FbankFrontend``, a ``--frontend
device`` experiment) serves raw 16 kHz waveforms: they are padded by the
training collate's own policy (``data.audio.pad_waveform_batch``, frame
counts rounded up to ``pad_multiple``), so serving gives the training eval
path's probabilities.

With ``mesh=`` (``parallel.make_seq_mesh``) a feature model serves through
the time-pipelined forward of ``parallel/seqpipe.py`` instead, its stages
on the mesh's devices (one card, or one a card with the model on the first):
long sequences over S stages and ``n_micro`` microbatches, the same
probabilities.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from sparch_tpu_torch.data.audio import pad_waveform_batch
from sparch_tpu_torch.models.frontend import FbankFrontend
from sparch_tpu_torch.utils.device import resolve_device

__all__ = ["Predictor", "load_experiment"]


def load_experiment(exp_folder: str, device=None):
    """Rebuild the trained model and its ``state_dict`` from an experiment
    folder of ``run_exp_torch.py``: the training loop records the
    architecture in the checkpoint's ``meta.json``. Returns
    ``(model, state_dict)``, the state dict on ``device`` (None: the CUDA
    card, which raises without one); feed them to :class:`Predictor` or
    to ``streaming_init``."""
    model, state_dict, _ = _read_experiment(exp_folder, device)
    return model, state_dict


def _read_experiment(exp_folder: str, device):
    """``load_experiment``'s (model, state_dict) and the meta's ``model``
    record."""
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
    model = build_model_from_config(cfg, use_readout_layer=True)
    if cfg.get("frontend") == "device":
        # the run trained on (waveforms, frame counts) through the wrapper
        # the training loop put around the model (train/loop.py init_model)
        model = FbankFrontend(inner=model)
    return model, load_state_tree(ckdir, device)["model"], cfg


class Predictor:
    """Wraps a model and its ``state_dict`` for batched inference.

        predictor = Predictor(model, state_dict)
        labels, probs = predictor(x)          # x: (n, T, F), any n
        labels, probs = predictor(waves)      # FbankFrontend: 1-D waveforms

    ``device=None`` is the CUDA card and raises without one;
    ``device="cpu"`` runs on the CPU.

    ``mesh``: a ``parallel.SeqMesh`` (``make_seq_mesh``) whose home is the
    same device serves through the time-pipelined forward over its ``seq`` stages
    with ``n_micro`` microbatches (``parallel/seqpipe.py``). Checked
    loudly: feature models only, ``batch_size`` divisible by ``n_micro``,
    and each call's T divisible by the ``seq`` axis.
    """

    @classmethod
    def from_experiment(cls, exp_folder: str, batch_size: int = 128,
                        seed: int = 0, pad_multiple=None,
                        device=None) -> "Predictor":
        """Load the best checkpoint of a ``run_exp_torch.py`` experiment
        for inference:

            predictor = Predictor.from_experiment("exp/test_exps/...")
            labels, probs = predictor(x)

        A ``--frontend device`` experiment serves raw waveforms (see
        ``__call__``); ``pad_multiple`` buckets their frame counts, and
        left as None it is the training run's ``--pad_multiple`` from the
        experiment's meta record, so serving pads as the eval path did.
        (See :func:`load_experiment`; use it directly with
        ``streaming_init`` for frame-by-frame serving.)"""
        model, state_dict, cfg = _read_experiment(exp_folder, device)
        if pad_multiple is None:
            pad_multiple = cfg.get("pad_multiple", 100)
        return cls(model, state_dict, batch_size=batch_size, seed=seed,
                   pad_multiple=pad_multiple, device=device)

    def __init__(self, model, state_dict, batch_size: int = 128,
                 seed: int = 0, pad_multiple: int = 100, device=None,
                 mesh=None, n_micro: int = 4):
        self.device = resolve_device(device)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.seed = seed
        # a frontend model takes (waveforms, frame counts), bucketed to
        # pad_multiple frames as the training loader buckets them
        self._waveform = isinstance(model, FbankFrontend)
        self.pad_multiple = pad_multiple
        self._generator = (
            torch.Generator(device=self.device)
            if getattr(model, "state_init", None) == "uniform" else None
        )
        self._predict = None
        if mesh is not None:
            self._predict = self._seq_predict(mesh, n_micro)

    def _seq_predict(self, mesh, n_micro):
        """The time-pipelined forward over ``mesh``, ``predict(x,
        generator)``, with the JAX Predictor's checks and messages."""
        from sparch_tpu_torch.parallel.seqpipe import make_seqpipe_predict

        if self._waveform:
            raise ValueError(
                "seq-sharded serving takes feature inputs; run the "
                "fbank frontend on host (ops.fbank.fbank_np) or use "
                "the single-chip waveform path"
            )
        if "seq" not in getattr(mesh, "axis_names", ()):
            raise ValueError(
                f"mesh axes {getattr(mesh, 'axis_names', None)} have no "
                "'seq' axis; build one with parallel.seqpipe.make_seq_mesh"
            )
        if mesh.home.type != self.device.type:
            raise ValueError(f"the mesh's home {mesh.home} is not on the "
                             f"Predictor's device {self.device}")
        if self.batch_size % n_micro:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by n_micro "
                f"({n_micro})"
            )
        # a call's T not divisible by the seq axis raises in the forward
        return make_seqpipe_predict(self.model, mesh, n_micro)

    @torch.no_grad()
    def _forward(self, x) -> torch.Tensor:
        if self._generator is not None:
            self._generator.manual_seed(self.seed)
        if self._predict is not None:
            out = self._predict(x, self._generator)
        else:
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
        """Predict labels; returns (labels, probs).

        Feature models take ``x: (n, T, F)``. Frontend models take raw
        16 kHz waveforms: a list of 1-D float arrays (ragged, each taken
        whole) or a padded ``(n, samples)`` array, which needs the true
        sample count of each item in ``lengths`` (zero padding taken for
        signal would part from the training pipeline's masked features).
        """
        if lengths is not None and not self._waveform:
            raise ValueError(
                "lengths= applies only to device-frontend (waveform) "
                "models; feature inputs carry no padding information"
            )
        if len(x) == 0:
            c = self.model.num_outputs
            return np.zeros((0,), np.int64), np.zeros((0, c), np.float32)
        if self._waveform:
            x, lengths = self._pad_waveforms(x, lengths)
        else:
            x = np.asarray(x, np.float32)
        n = x.shape[0]
        bs = self.batch_size
        probs_out = []
        for i in range(0, n, bs):
            chunk = x[i:i + bs]
            pad = bs - chunk.shape[0]
            if pad:  # one shape for every forward
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)]
                )
            arg = torch.from_numpy(chunk).to(self.device)
            if self._waveform:
                lens = np.concatenate(
                    [lengths[i:i + bs], np.zeros((pad,), lengths.dtype)])
                arg = (arg, torch.from_numpy(lens).to(self.device))
            probs = self._forward(arg).cpu().numpy()
            probs_out.append(probs[:bs - pad] if pad else probs)
        probs = np.concatenate(probs_out, axis=0)
        return probs.argmax(axis=-1), probs

    def _pad_waveforms(self, x, lengths):
        """Ragged waveforms -> a padded ``(n, samples)`` array and the frame
        count of each item (what ``FbankFrontend`` masks the padded frames
        with), by the training collate's policy."""
        if isinstance(x, np.ndarray) and x.ndim == 2 and lengths is None:
            raise ValueError(
                "pre-padded (n, samples) waveform batches need lengths= "
                "(true per-item sample counts); pass a list of 1-D "
                "arrays instead for full-length semantics"
            )
        waves = [np.asarray(w, np.float32) for w in x]
        if lengths is not None:
            if len(lengths) != len(waves):
                raise ValueError(
                    f"{len(lengths)} lengths for {len(waves)} waveforms"
                )
            waves = [w[:int(m)] for w, m in zip(waves, lengths)]
        return pad_waveform_batch(waves, self.pad_multiple)
