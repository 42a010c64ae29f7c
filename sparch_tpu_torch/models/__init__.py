"""Model registry (counterpart of sparch_tpu/models/__init__.py): the
spiking {LIF, adLIF, RLIF, RadLIF} and the non-spiking {MLP, RNN, LiGRU,
GRU} family, selected by one model-type string."""
from __future__ import annotations

import torch

from sparch_tpu_torch.models.ann import (
    ANN,
    ANN_TYPES,
    GRULayer,
    LiGRULayer,
    MLPLayer,
    ReadoutLayerANN,
    RNNLayer,
)
from sparch_tpu_torch.models.snn import (
    SNN,
    SNN_NEURON_TYPES,
    LIFLayer,
    RadLIFLayer,
    ReadoutLayer,
    RLIFLayer,
    adLIFLayer,
)

MODEL_TYPES = SNN_NEURON_TYPES + ANN_TYPES

__all__ = [
    "ANN",
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
    "MLPLayer",
    "RNNLayer",
    "LiGRULayer",
    "GRULayer",
    "ReadoutLayerANN",
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
    """Build an SNN or an ANN from a model-type string."""
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
        # an ANN has no state init (always zeros) and no threshold
        for key in ("state_init", "threshold"):
            kwargs.pop(key, None)
        return ANN(
            input_shape=tuple(input_shape),
            layer_sizes=tuple(layer_sizes),
            ann_type=model_type,
            dropout=dropout,
            normalization=normalization,
            use_bias=use_bias,
            bidirectional=bidirectional,
            use_readout_layer=use_readout_layer,
            **kwargs,
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
