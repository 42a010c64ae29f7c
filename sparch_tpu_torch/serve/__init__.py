"""Serving: batch prediction and frame-by-frame streaming."""
from sparch_tpu_torch.serve.predictor import Predictor, load_experiment
from sparch_tpu_torch.serve.streaming import streaming_init, streaming_step

__all__ = ["Predictor", "load_experiment", "streaming_init", "streaming_step"]
