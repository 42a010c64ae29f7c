"""Import trained PyTorch reference checkpoints (idiap/sparch) into the port
(counterpart of sparch_tpu/migrate.py).

The reference saves its best model by pickling the whole ``nn.Module``
(``torch.save(self.net, ...)`` -> ``best_model.pth``, reference
exp.py:462). This module turns such a checkpoint, or a bare
``state_dict``, into an experiment folder of the port:

* :func:`variables_from_state_dict`: the flax layout ``{"params",
  "batch_stats"}`` (nested dicts of numpy arrays) from a reference
  ``state_dict`` and an architecture record; the JAX package's function,
  kept here as a copy (the port imports nothing of that package).
* :func:`state_dict_from_reference`: the port's ``state_dict`` of the same
  weights, ``convert.variables_from_flax`` of the above.
* :func:`config_from_module` / :func:`infer_config_from_state_dict`: the
  architecture record (the ``model`` record of ``checkpoints/meta.json``)
  from a pickled module's attributes, or from the ``state_dict``'s keys
  and shapes alone.
* :func:`import_torch_checkpoint`: one call, a ``.pth`` in, a folder out
  (``train/checkpoint.py``'s format) that ``Predictor.from_experiment``
  serves and ``run_exp_torch.py --use_pretrained_model 1
  --load_exp_folder <out>`` fine-tunes.

Weight layout (the JAX module's contract, held there against the
reference's own forward):

* Feedforward ``W``: ``nn.Linear`` computes ``x @ weight.T``, flax ``Dense``
  ``x @ kernel``, so kernel = ``weight.T`` (and the port's ``W.weight`` is
  the reference's again).
* SNN recurrent ``V``: the reference multiplies ``st @ V.weight``
  (snns.py:446), so it is copied untransposed.
* ANN recurrent gates (``V``/``Vz``/``Vr``): applied as modules
  (``self.V(y)`` = ``y @ weight.T``, anns.py), so they are transposed.
* Norms: ``weight``/``bias`` become ``scale``/``bias``; batchnorm's
  ``running_mean``/``running_var`` land in ``batch_stats``;
  ``num_batches_tracked`` is dropped.

Only the model's weights and statistics carry over: the optimizer (Adam at
``lr``), the generator and the step count start fresh, as after the JAX
import (docs/MIGRATION.md). SECURITY: unpickling a module checkpoint runs
arbitrary code by design of the pickle format; only import checkpoints you
trust, as with ``torch.load`` itself.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "variables_from_state_dict",
    "state_dict_from_reference",
    "config_from_module",
    "infer_config_from_state_dict",
    "load_torch_checkpoint",
    "import_torch_checkpoint",
    "write_experiment",
]

_SNN_TYPES = ("LIF", "adLIF", "RLIF", "RadLIF")
_ANN_TYPES = ("MLP", "RNN", "LiGRU", "GRU")
# recurrent-gate matrices per ANN type, reference anns.py layer classes
_ANN_GATES = {"MLP": (), "RNN": ("V",), "LiGRU": ("V", "Vz"),
              "GRU": ("V", "Vz", "Vr")}
# gate-projection linears (beyond W) per ANN type
_ANN_WGATES = {"MLP": (), "RNN": (), "LiGRU": ("Wz",), "GRU": ("Wz", "Wr")}
# reference norm attribute per projection: W->norm, Wz->normz, Wr->normr
_NORM_OF = {"W": "norm", "Wz": "normz", "Wr": "normr"}

_BOOL_CONFIG_KEYS = ("use_bias", "bidirectional", "use_readout_layer",
                     "remat")
# the keys of the model record the port's training loop writes
# (train/loop.py ``_model_config``); an imported record gets the same
MODEL_RECORD_KEYS = (
    "model_type", "input_shape", "layer_sizes", "threshold", "dropout",
    "normalization", "use_bias", "bidirectional", "state_init", "cell_impl",
    "compute_dtype", "input_dtype", "frontend", "remat", "prng_impl",
    "pad_multiple")


def _as_bool(v) -> bool:
    """Tolerate string booleans ('false', '0', 'no') from CLI --set
    overrides: bool('false') is True, which would silently corrupt the
    conversion (a dropped readout remaps every layer)."""
    if isinstance(v, str):
        low = v.strip().lower()
        if low in ("true", "t", "yes", "y", "on", "1"):
            return True
        if low in ("false", "f", "no", "n", "off", "0"):
            return False
        raise ValueError(f"not a boolean: {v!r}")
    return bool(v)


def _apply_overrides(config: Dict[str, Any], overrides: Dict[str, Any]):
    """Merge user overrides into an architecture record, alike for both
    checkpoint formats: ``batch_size`` targets ``input_shape[0]``,
    booleans accept string forms."""
    overrides = dict(overrides)
    if "batch_size" in overrides:
        config["input_shape"][0] = int(overrides.pop("batch_size"))
    for key, val in overrides.items():
        config[key] = _as_bool(val) if key in _BOOL_CONFIG_KEYS else val
    return config


def _np(t) -> np.ndarray:
    """An owned float copy of a tensor (never a view of torch storage: a
    live optimizer could change it in place)."""
    return np.array(t.detach().cpu().numpy(), copy=True)


def _norm_params(sd: Dict[str, Any], prefix: str, normalization: str):
    """(flax norm params, batch stats or None) of one torch norm."""
    scale = _np(sd[f"{prefix}.weight"])
    bias = _np(sd[f"{prefix}.bias"])
    if normalization == "batchnorm":
        params = {"BatchNorm_0": {"scale": scale, "bias": bias}}
        stats = {"BatchNorm_0": {
            "mean": _np(sd[f"{prefix}.running_mean"]),
            "var": _np(sd[f"{prefix}.running_var"]),
        }}
        return params, stats
    if normalization == "layernorm":
        return {"LayerNorm_0": {"scale": scale, "bias": bias}}, None
    raise ValueError(f"no norm params for normalization={normalization!r}")


def _linear(sd: Dict[str, Any], prefix: str, use_bias: bool):
    p = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if use_bias:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def variables_from_state_dict(
    state_dict: Dict[str, Any], config: Dict[str, Any]
) -> Dict[str, Any]:
    """A reference ``state_dict`` as the flax variable tree (nested dicts
    of numpy arrays).

    ``config`` is an architecture record with at least ``model_type``,
    ``normalization``, ``use_bias`` and ``use_readout_layer`` (see
    :func:`config_from_module`). Returns ``{"params": ...}`` and
    ``"batch_stats"`` where the model has batchnorm running statistics.
    """
    model_type = config["model_type"]
    normalization = config["normalization"]
    use_bias = bool(config["use_bias"])
    use_readout = bool(config.get("use_readout_layer", True))
    is_snn = model_type in _SNN_TYPES
    container = "snn" if is_snn else "ann"

    indices = sorted({
        int(k.split(".")[1]) for k in state_dict if k.startswith(container + ".")
    })
    if not indices:
        raise ValueError(
            f"state_dict has no '{container}.*' keys: not a reference "
            f"{'SNN' if is_snn else 'ANN'} checkpoint (model_type="
            f"{model_type!r})"
        )

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in indices:
        is_readout = use_readout and i == indices[-1]
        name = "readout" if is_readout else f"layer_{i}"
        lp = f"{container}.{i}"
        p: Dict[str, Any] = {"W": _linear(state_dict, f"{lp}.W", use_bias)}
        layer_stats: Dict[str, Any] = {}

        if is_snn:
            # every reference SNN layer (the readout too) carries alpha
            p["alpha"] = _np(state_dict[f"{lp}.alpha"])
            if not is_readout and model_type in ("adLIF", "RadLIF"):
                for k in ("beta", "a", "b"):
                    p[k] = _np(state_dict[f"{lp}.{k}"])
            if not is_readout and model_type in ("RLIF", "RadLIF"):
                # the reference computes st @ V.weight (snns.py:446): as is
                p["V"] = _np(state_dict[f"{lp}.V.weight"])
            if normalization in ("batchnorm", "layernorm"):
                p["norm"], s = _norm_params(state_dict, f"{lp}.norm",
                                            normalization)
                if s is not None:
                    layer_stats["norm"] = s
        else:
            if not is_readout:
                for g in _ANN_GATES[model_type]:
                    # gate modules apply y @ weight.T (anns.py): transposed
                    p[g] = _np(state_dict[f"{lp}.{g}.weight"]).T
                for w in _ANN_WGATES[model_type]:
                    p[w] = _linear(state_dict, f"{lp}.{w}", use_bias)
            if normalization in ("batchnorm", "layernorm"):
                wnames = ("W",) + (() if is_readout
                                   else _ANN_WGATES[model_type])
                for w in wnames:
                    key = "norm" if is_readout else f"norm_{w}"
                    p[key], s = _norm_params(
                        state_dict, f"{lp}.{_NORM_OF[w]}", normalization
                    )
                    if s is not None:
                        layer_stats[key] = s

        params[name] = p
        if layer_stats:
            stats[name] = layer_stats

    variables: Dict[str, Any] = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return variables


def state_dict_from_reference(
    state_dict: Dict[str, Any], config: Dict[str, Any]
) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` as the port's ``state_dict`` (CPU
    tensors): :func:`variables_from_state_dict`, then
    ``convert.variables_from_flax``."""
    from sparch_tpu_torch.convert import variables_from_flax

    return variables_from_flax(variables_from_state_dict(state_dict, config))


def config_from_module(net) -> Dict[str, Any]:
    """Architecture record from a pickled reference module's attributes
    (reference snns.py:94-107 / anns.py:71-83)."""
    is_snn = bool(getattr(net, "is_snn", hasattr(net, "snn")))
    model_type = net.neuron_type if is_snn else net.ann_type
    return {
        "model_type": str(model_type),
        "input_shape": [int(net.batch_size), None, int(net.input_size)],
        "layer_sizes": [int(h) for h in net.layer_sizes],
        "threshold": float(getattr(net, "threshold", 1.0)),
        "dropout": float(net.dropout),
        "normalization": str(net.normalization),
        "use_bias": bool(net.use_bias),
        "bidirectional": bool(net.bidirectional),
        "use_readout_layer": bool(net.use_readout_layer),
        # the reference draws uniform hidden states each forward
        # (snns.py:286-287): the 'uniform' state init
        "state_init": "uniform",
        "cell_impl": "auto",
        "compute_dtype": "float32",
        "input_dtype": "float32",
        "frontend": "host",
        "remat": False,
    }


def infer_config_from_state_dict(
    state_dict: Dict[str, Any], **overrides
) -> Dict[str, Any]:
    """Recover the architecture from the ``state_dict``'s structure alone,
    for checkpoints saved as ``torch.save(net.state_dict(), ...)``, where
    no module attribute survives.

    Inferable: model family and type (key prefixes, each layer's
    parameters), layer sizes (weight shapes), ``use_bias``,
    ``normalization`` (running statistics: batchnorm), ``bidirectional``
    (the in-dims downstream are doubled). Not in a state_dict, so given by
    ``overrides`` where they differ from the reference defaults:
    ``threshold`` (1.0), ``dropout`` (0.0 here; the weights are the same
    either way), ``batch_size`` (128), ``use_readout_layer`` (True).
    """
    keys = set(state_dict)
    container = ("snn" if any(k.startswith("snn.") for k in keys)
                 else "ann" if any(k.startswith("ann.") for k in keys)
                 else None)
    if container is None:
        raise ValueError(
            "state_dict has neither 'snn.*' nor 'ann.*' keys: not a "
            "reference sparch checkpoint"
        )
    is_snn = container == "snn"
    indices = sorted({int(k.split(".")[1])
                      for k in keys if k.startswith(container + ".")})
    use_readout = _as_bool(overrides.pop("use_readout_layer", True))
    hidden = indices[:-1] if use_readout else indices
    first_hidden = hidden[0] if hidden else indices[0]

    def has(i, suffix):
        return f"{container}.{i}.{suffix}" in keys

    if is_snn:
        ad = has(first_hidden, "beta")
        rec = has(first_hidden, "V.weight")
        model_type = {(False, False): "LIF", (True, False): "adLIF",
                      (False, True): "RLIF", (True, True): "RadLIF"}[(ad, rec)]
    else:
        if has(first_hidden, "Vr.weight"):
            model_type = "GRU"
        elif has(first_hidden, "Vz.weight"):
            model_type = "LiGRU"
        elif has(first_hidden, "V.weight"):
            model_type = "RNN"
        else:
            model_type = "MLP"

    w0 = state_dict[f"{container}.{indices[0]}.W.weight"]
    layer_sizes = [int(state_dict[f"{container}.{i}.W.weight"].shape[0])
                   for i in indices]
    # a layer downstream reads H_prev * (1 + bidirectional) features
    # (reference snns.py:140 / anns.py:119); MLP stacks are never
    # bidirectional (the reference refuses the combination)
    bidirectional = False
    if len(indices) > 1 and model_type != "MLP":
        in1 = int(state_dict[f"{container}.{indices[1]}.W.weight"].shape[1])
        bidirectional = in1 == 2 * layer_sizes[0]
        if in1 not in (layer_sizes[0], 2 * layer_sizes[0]):
            raise ValueError(
                f"layer-1 in-dim {in1} matches neither H0={layer_sizes[0]} "
                f"nor 2*H0: not a reference layer stack"
            )

    normalization = "none"
    if has(indices[0], "norm.running_mean"):
        normalization = "batchnorm"
    elif has(indices[0], "norm.weight"):
        normalization = "layernorm"

    cfg = {
        "model_type": model_type,
        "input_shape": [int(overrides.pop("batch_size", 128)), None,
                        int(w0.shape[1])],
        "layer_sizes": layer_sizes,
        "threshold": float(overrides.pop("threshold", 1.0)),
        "dropout": float(overrides.pop("dropout", 0.0)),
        "normalization": normalization,
        "use_bias": has(indices[0], "W.bias"),
        "bidirectional": bidirectional,
        "use_readout_layer": use_readout,
        "state_init": "uniform",
        "cell_impl": "auto",
        "compute_dtype": "float32",
        "input_dtype": "float32",
        "frontend": "host",
        "remat": False,
    }
    return _apply_overrides(cfg, overrides)


def load_torch_checkpoint(pth_path: str, sparch_path: Optional[str] = None):
    """``torch.load`` a reference checkpoint (module or state_dict), with
    an actionable error where the pickled module's package is missing.
    Unpickling a module runs its code: only load checkpoints you trust."""
    import sys

    if sparch_path and sparch_path not in sys.path:
        sys.path.insert(0, sparch_path)
    try:
        # a pickled module needs full unpickling (torch >= 2.6 defaults to
        # weights_only=True, which refuses it)
        return torch.load(pth_path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            f"unpickling {pth_path} needs the reference package "
            f"({e.name!r}) importable: pass sparch_path=<its repo root>"
        ) from e


def _model_of(config: Dict[str, Any]):
    """The port's model of an architecture record, wrapped in the audio
    frontend where the record says ``frontend: device`` (as
    ``serve.load_experiment`` rebuilds it)."""
    from sparch_tpu_torch.models import build_model_from_config
    from sparch_tpu_torch.models.frontend import FbankFrontend

    model = build_model_from_config(config, use_readout_layer=True)
    if config.get("frontend") == "device":
        model = FbankFrontend(inner=model)
    return model


def write_experiment(out_exp_folder: str, config: Dict[str, Any],
                     state_dict: Dict[str, torch.Tensor], lr: float = 0.01,
                     device=None, provenance: Optional[Dict[str, Any]] = None):
    """Write ``state_dict`` (the port's names) as the best checkpoint of a
    new experiment folder, with a fresh training state: Adam at ``lr``
    (the configuration of ``create_train_state``, so that
    ``--use_pretrained_model`` restores it), the generator of ``device``
    seeded 0 (its state's format is the device's: pass the device that
    will fine-tune the folder; None is the CUDA card) and step 0.
    ``meta.json`` gets epoch 0, best accuracy 0, the ``model`` record with
    the keys of the port's training loop, and ``provenance``. Raises
    ``ValueError`` where the port cannot build the model or the state dict
    does not fit it. Returns the model (on ``device``, eval mode)."""
    from sparch_tpu_torch.train.checkpoint import save_checkpoint
    from sparch_tpu_torch.train.state import create_train_state

    unknown = set(config) - set(MODEL_RECORD_KEYS) - {"use_readout_layer"}
    if unknown:
        raise ValueError(f"the port cannot build a model with "
                         f"{sorted(unknown)} in its record")
    if not config.get("use_readout_layer", True):
        raise ValueError(
            "experiment-folder export requires use_readout_layer=True "
            "(the only mode the CLI trains); use state_dict_from_reference() "
            "directly for headless stacks"
        )
    record = {k: v for k, v in config.items() if k != "use_readout_layer"}
    record.setdefault("prng_impl", "rbg")
    record.setdefault("pad_multiple", 100)
    try:
        model = _model_of(record)
        model.load_state_dict(state_dict, strict=True)
    except (KeyError, RuntimeError, ValueError) as e:
        raise ValueError(f"the port cannot build this model: {e}") from e
    state = create_train_state(model, lr, device=device)
    ckdir = os.path.join(out_exp_folder, "checkpoints")
    os.makedirs(ckdir, exist_ok=True)
    meta = {"epoch": 0, "best_acc": 0.0,
            "model": {k: record[k] for k in MODEL_RECORD_KEYS},
            **(provenance or {})}
    save_checkpoint(ckdir, state, meta)
    return model.eval()


def import_torch_checkpoint(
    pth_path: str,
    out_exp_folder: str,
    sparch_path: Optional[str] = None,
    lr: float = 0.01,
    prng_impl: str = "rbg",
    config_overrides: Optional[Dict[str, Any]] = None,
    loaded: Any = None,
    device=None,
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Convert a reference ``.pth`` checkpoint into an experiment folder of
    the port.

    Takes both formats: a pickled module (what the reference's trainer
    writes, exp.py:462; the ``sparch`` package must be importable to
    unpickle it, ``sparch_path`` adds its repo to ``sys.path``) or a bare
    ``state_dict`` (architecture inferred from its keys and shapes, see
    :func:`infer_config_from_state_dict`; ``config_overrides`` gives what
    it cannot carry).

    Writes ``<out>/checkpoints/best_model`` (the imported weights and
    statistics, a fresh optimizer at ``lr`` and generator, see
    :func:`write_experiment`; ``device``: the device that will fine-tune
    it, None the CUDA card) and ``<out>/checkpoints/meta.json`` (the
    ``model`` record, ``prng_impl`` in it as the JAX import records it, and
    the source), so that the folder serves with
    ``Predictor.from_experiment(out)`` and fine-tunes with
    ``run_exp_torch.py --use_pretrained_model 1 --load_exp_folder <out>``.

    Returns ``(model, state_dict)``, the model on ``device`` in eval mode
    with the imported weights. ``loaded`` skips the ``torch.load`` where
    the caller holds the module or state_dict already (``pth_path`` is
    still recorded as the source).
    """
    obj = loaded if loaded is not None else load_torch_checkpoint(
        pth_path, sparch_path
    )
    overrides = dict(config_overrides or {})
    if isinstance(obj, dict):
        state_dict = obj
        config = infer_config_from_state_dict(state_dict, **overrides)
    else:
        state_dict = obj.state_dict()
        config = _apply_overrides(config_from_module(obj), overrides)
    config["prng_impl"] = prng_impl
    port_sd = state_dict_from_reference(state_dict, config)
    model = write_experiment(
        out_exp_folder, config, port_sd, lr=lr, device=device,
        provenance={"imported_from": os.path.abspath(pth_path)})
    return model, port_sd
