"""Model registry (counterpart of sparch_tpu/models/__init__.py): the
spiking {LIF, adLIF, RLIF, RadLIF} family, selected by a model-type
string. The non-spiking {MLP, RNN, LiGRU, GRU} family is not ported yet."""
from __future__ import annotations

import torch

from sparch_tpu_torch.models.snn import (
    SNN,
    SNN_NEURON_TYPES,
    LIFLayer,
    RadLIFLayer,
    ReadoutLayer,
    RLIFLayer,
    adLIFLayer,
)

ANN_TYPES = ("MLP", "RNN", "LiGRU", "GRU")
MODEL_TYPES = SNN_NEURON_TYPES + ANN_TYPES

__all__ = [
    "SNN",
    "MODEL_TYPES",
    "ANN_TYPES",
    "SNN_NEURON_TYPES",
    "build_model",
    "build_model_from_config",
    "LIFLayer",
    "adLIFLayer",
    "RLIFLayer",
    "RadLIFLayer",
    "ReadoutLayer",
]


def build_model(
    model_type: str,
    input_shape,
    layer_sizes,
    dropout: float = 0.0,
    normalization: str = "batchnorm",
    use_bias: bool = False,
    bidirectional: bool = False,
    use_readout_layer: bool = True,
    **kwargs,
):
    """Build a model from a model-type string."""
    if model_type in SNN_NEURON_TYPES:
        return SNN(
            input_shape=tuple(input_shape),
            layer_sizes=tuple(layer_sizes),
            neuron_type=model_type,
            dropout=dropout,
            normalization=normalization,
            use_bias=use_bias,
            bidirectional=bidirectional,
            use_readout_layer=use_readout_layer,
            **kwargs,
        )
    if model_type in ANN_TYPES:
        raise NotImplementedError(
            f"{model_type} is a non-spiking model: the ANN slice of the port "
            "(ROADMAP queue 1 item 4, queue 2 items 6-7) is not done yet"
        )
    raise ValueError(f"Invalid model type {model_type}")


def build_model_from_config(config, **overrides):
    """Build a model from an architecture record, the dict the JAX training
    loop writes to ``checkpoints/meta.json``."""
    cfg = {**config, **overrides}
    dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None
    cell_impl = cfg.get("cell_impl", "auto")
    if cell_impl == "pallas_tp":
        # the tensor-parallel mesh is not part of the saved architecture;
        # 'auto' serves the same weights on one device
        cell_impl = "auto"
    return build_model(
        cfg["model_type"],
        tuple(cfg["input_shape"]),
        cfg["layer_sizes"],
        threshold=cfg.get("threshold", 1.0),
        dropout=cfg.get("dropout", 0.0),
        normalization=cfg["normalization"],
        use_bias=cfg["use_bias"],
        bidirectional=cfg["bidirectional"],
        use_readout_layer=cfg.get("use_readout_layer", True),
        state_init=cfg.get("state_init", "uniform"),
        cell_impl=cell_impl,
        compute_dtype=dtype,
        remat=cfg.get("remat", False),
    )
