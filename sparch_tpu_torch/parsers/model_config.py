"""Model configuration flags (counterpart of
sparch_tpu/parsers/model_config.py): the same names, types, choices and
defaults. ``strtobool`` is re-implemented locally (distutils is removed
from Python >= 3.12)."""
from __future__ import annotations

import logging

__all__ = ["add_model_options", "print_model_options", "strtobool"]

_MODEL_OPTION_KEYS = [
    "model_type",
    "nb_layers",
    "nb_hiddens",
    "pdrop",
    "normalization",
    "use_bias",
    "bidirectional",
    # extensions of the original CLI
    "threshold",
    "remat",
]


def strtobool(val) -> bool:
    v = str(val).lower()
    if v in ("y", "yes", "t", "true", "on", "1"):
        return True
    if v in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {val!r}")


def add_model_options(parser):
    parser.add_argument(
        "--model_type",
        type=str,
        choices=["LIF", "adLIF", "RLIF", "RadLIF", "MLP", "RNN", "LiGRU", "GRU"],
        default="LIF",
        help="Network architecture: one of the spiking neuron variants "
        "(LIF/adLIF/RLIF/RadLIF) or a non-spiking baseline "
        "(MLP/RNN/LiGRU/GRU).",
    )
    parser.add_argument(
        "--nb_layers",
        type=int,
        default=3,
        help="Total layer count; the final layer is the readout.",
    )
    parser.add_argument(
        "--nb_hiddens",
        type=int,
        default=128,
        help="Width (neuron count) of every hidden layer.",
    )
    parser.add_argument(
        "--pdrop",
        type=float,
        default=0.1,
        help="Dropout probability on hidden-layer outputs, in [0, 1].",
    )
    parser.add_argument(
        "--normalization",
        type=str,
        default="batchnorm",
        help="Feature normalization applied after the input projection: "
        "'batchnorm' or 'layernorm'; anything else disables it.",
    )
    parser.add_argument(
        "--use_bias",
        type=strtobool,
        default=False,
        help="Add a learnable bias term to the feedforward projections.",
    )
    parser.add_argument(
        "--bidirectional",
        type=strtobool,
        default=False,
        help="Run each layer over the sequence in both directions and "
        "concatenate the two passes, doubling the layer's output width.",
    )
    parser.add_argument(
        "--threshold",
        type=float,
        default=1.0,
        help="Fixed spiking threshold for the membrane potential.",
    )
    # --- extensions of the original CLI (defaults keep its behaviour) ---
    parser.add_argument(
        "--state_init",
        type=str,
        choices=["uniform", "zeros"],
        default="uniform",
        help="Hidden-state initialisation per forward: 'uniform' matches the "
        "reference's U[0,1) random states; 'zeros' is deterministic.",
    )
    parser.add_argument(
        "--cell_impl",
        type=str,
        choices=["auto", "scan", "pallas", "pallas_tp"],
        default="auto",
        help="Neuron recurrence implementation: the fused CUDA kernels or "
        "a plain PyTorch loop over time ('scan'). 'auto' takes the "
        "kernels on the card and their plain versions on the CPU; "
        "'pallas' takes them always. 'pallas_tp' (tensor-parallel "
        "kernels over --mesh_model ranks) is refused by run_exp_torch.py "
        "until the port has multi-card runs.",
    )
    parser.add_argument(
        "--compute_dtype",
        type=str,
        choices=["float32", "bfloat16"],
        default="float32",
        help="Matmul compute dtype (params stay float32).",
    )
    parser.add_argument(
        "--input_dtype",
        type=str,
        choices=["float32", "bfloat16"],
        default="float32",
        help="Storage dtype of the input batches shipped to the device. "
        "'bfloat16' halves the host-to-device copy of each batch. For "
        "spiking rasters this is lossless: bin counts are small "
        "integers, exactly representable in bfloat16; a float32 model "
        "promotes the batch back to float32.",
    )
    parser.add_argument(
        "--remat",
        type=strtobool,
        default=False,
        help="Rematerialise hidden layers in the backward pass: "
        "activations and residual streams are recomputed from each "
        "layer's input instead of stored, at the cost of one extra "
        "forward. Random streams replay, so the gradients match the "
        "stored-activation run. Try it when long sequences or wide "
        "stacks run out of device memory.",
    )
    return parser


def print_model_options(args):
    """Log the resolved model options, one key=value line each."""
    opts = vars(args)
    lines = ["", "model options:"]
    lines += [f"  {k}={opts[k]}" for k in _MODEL_OPTION_KEYS if k in opts]
    logging.info("\n".join(lines))
