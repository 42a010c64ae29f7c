#!/usr/bin/env python
"""Convert an experiment folder of the JAX package (``run_exp.py``: an
Orbax ``checkpoints/best_model`` and ``checkpoints/meta.json``) into an
experiment folder of the PyTorch/CUDA port.

    python tools/jax_exp_to_torch.py JAX_EXP OUT_FOLDER [--lr 0.01] \
        [--device cuda|cpu]

The parameters and batch statistics carry over through
``sparch_tpu_torch.convert.variables_from_flax`` (a ``--frontend device``
model keeps its ``inner.`` level); the optimizer (Adam at ``--lr``), the
generator (of ``--device``, the one that will fine-tune the folder;
default the CUDA card) and the step start fresh, as after an import of a
reference checkpoint (docs/MIGRATION.md). The model record is the JAX
run's, so the folder serves with ``Predictor.from_experiment(OUT_FOLDER)``
and fine-tunes with ``run_exp_torch.py --use_pretrained_model 1
--load_exp_folder OUT_FOLDER``. A folder whose model the port cannot build
is refused before anything is written.

This tool imports both packages (the JAX one on the CPU, to read the
Orbax checkpoint); the port never imports JAX.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(jax_folder: str, out_folder: str, lr: float = 0.01,
            device=None):
    """Write the port's folder of ``jax_folder`` into ``out_folder``;
    returns (the port's model, its state dict)."""
    import jax

    # reading a checkpoint is host work: never wake an accelerator for it
    jax.config.update("jax_platforms", "cpu")

    from sparch_tpu.serve import load_experiment
    from sparch_tpu_torch.convert import variables_from_flax
    from sparch_tpu_torch.migrate import write_experiment

    with open(os.path.join(jax_folder, "checkpoints", "meta.json")) as f:
        meta = json.load(f)
    config = meta.get("model")
    if config is None:
        raise ValueError(f"{jax_folder} has no 'model' record in its "
                         "meta.json: the port cannot rebuild its model")
    _, variables = load_experiment(jax_folder)
    state_dict = variables_from_flax(variables)
    model = write_experiment(
        out_folder, dict(config), state_dict, lr=lr, device=device,
        provenance={
            "converted_from": os.path.abspath(jax_folder),
            "source_epoch": meta.get("epoch"),
            "source_best_acc": meta.get("best_acc")})
    return model, state_dict


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("jax_exp", help="experiment folder of run_exp.py")
    ap.add_argument("out", help="experiment folder of the port to create")
    ap.add_argument("--lr", type=float, default=0.01,
                    help="learning rate of the fresh optimizer state")
    ap.add_argument("--device", default=None,
                    help="device of the fresh generator state (default: "
                    "the CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)
    convert(args.jax_exp, args.out, lr=args.lr, device=args.device)
    with open(os.path.join(args.out, "checkpoints", "meta.json")) as f:
        cfg = json.load(f)["model"]
    print(f"converted {args.jax_exp} -> {args.out}")
    print(f"  {cfg['model_type']} layers={cfg['layer_sizes']} "
          f"norm={cfg['normalization']} frontend={cfg['frontend']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
