#!/usr/bin/env python
"""Convert a trained PyTorch reference checkpoint (idiap/sparch
``best_model.pth``) into an experiment folder of the PyTorch/CUDA port
(``sparch_tpu_torch``).

    python tools/import_torch_checkpoint_torch.py REF.pth OUT_FOLDER \
        [--sparch_path /path/to/sparch/repo] [--lr 0.01] \
        [--set KEY=VALUE ...] [--verify] [--device cuda|cpu]

The arguments of ``tools/import_torch_checkpoint.py`` (the JAX package's
importer), and ``--device``: the device whose generator state the folder
carries, the one that will fine-tune it (default: the CUDA card). Both
checkpoint formats: the pickled whole module the reference's trainer
writes (exp.py:462; ``--sparch_path`` makes the ``sparch`` package
importable for unpickling) and bare ``state_dict`` saves (architecture
inferred from the keys and shapes; ``--set`` fills the fields a state_dict
cannot carry, e.g. ``--set threshold=1.4 dropout=0.25``).

The output folder serves and fine-tunes like one the port trained:

    Predictor.from_experiment(OUT_FOLDER)
    python run_exp_torch.py --use_pretrained_model 1 --load_exp_folder OUT ...

``--verify`` (module checkpoints only) runs the pickled module's eval
forward beside the port's on random input, zero state init on both sides,
on the CPU, and asserts they agree to 2e-4, the JAX importer's bound.

SECURITY: unpickling runs code; only convert checkpoints you trust.

This tool imports the port and PyTorch only.
"""
import argparse
import ast
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VERIFY_ATOL = 2e-4


def _parse_sets(pairs):
    out = {}
    for pair in pairs or ():
        key, _, val = pair.partition("=")
        if not _:
            raise SystemExit(f"--set expects KEY=VALUE, got {pair!r}")
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val  # bare strings: --set normalization=layernorm
    return out


def verify(net, config, state_dict) -> float:
    """The largest difference between the reference module's eval forward
    and the port's on the converted weights (CPU, zero state init on both
    sides: the reference draws its states with ``torch.rand``); raises
    past VERIFY_ATOL."""
    import numpy as np
    import torch

    from sparch_tpu_torch.models import build_model_from_config

    model = build_model_from_config(config, state_init="zeros",
                                    cell_impl="scan", use_readout_layer=True)
    model.load_state_dict(state_dict, strict=True)
    model.eval()
    net.eval()
    x = (np.random.default_rng(0)
         .random((4, 20, config["input_shape"][-1])).astype(np.float32) * 4.0)
    x = torch.from_numpy(x)
    rand = torch.rand
    torch.rand = lambda *s, **k: torch.zeros(*s, **k)  # zero state init
    try:
        with torch.no_grad():
            want, _ = net(x)
    finally:
        torch.rand = rand
    with torch.no_grad():
        got, _ = model(x)
    err = float((got - want).abs().max())
    if err > VERIFY_ATOL:
        raise SystemExit(f"VERIFY FAILED: max |port - reference| = "
                         f"{err:.3e} (bound {VERIFY_ATOL})")
    print(f"verify OK: max |port - reference| = {err:.3e} "
          f"(bound {VERIFY_ATOL})")
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pth", help="reference checkpoint (.pth)")
    ap.add_argument("out", help="experiment folder to create")
    ap.add_argument("--sparch_path", default=None,
                    help="reference repo root, for unpickling module "
                    "checkpoints (adds it to sys.path)")
    ap.add_argument("--lr", type=float, default=0.01,
                    help="learning rate of the fresh optimizer state")
    ap.add_argument("--prng_impl", default="rbg",
                    help="recorded in the model record, as the port's "
                    "trainer records it (the port draws from one "
                    "torch.Generator whatever it says)")
    ap.add_argument("--set", nargs="*", metavar="KEY=VALUE", dest="sets",
                    help="architecture overrides for state_dict "
                    "checkpoints (threshold, dropout, batch_size, ...)")
    ap.add_argument("--verify", action="store_true",
                    help="compare the port's forward with the reference "
                    "module's (module checkpoints only)")
    ap.add_argument("--device", default=None,
                    help="device of the fresh generator state: the one "
                    "that will fine-tune the folder (default: the CUDA "
                    "card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)

    from sparch_tpu_torch.migrate import (
        import_torch_checkpoint,
        load_torch_checkpoint,
    )

    # load once; with --verify, refuse a state_dict BEFORE anything is
    # written (a state_dict has no forward to compare against)
    obj = load_torch_checkpoint(args.pth, args.sparch_path)
    if args.verify and isinstance(obj, dict):
        raise SystemExit("--verify needs a pickled-module checkpoint "
                         "(a state_dict has no forward to compare against)")
    _, state_dict = import_torch_checkpoint(
        args.pth, args.out, lr=args.lr, prng_impl=args.prng_impl,
        config_overrides=_parse_sets(args.sets), loaded=obj,
        device=args.device)
    with open(os.path.join(args.out, "checkpoints", "meta.json")) as f:
        cfg = json.load(f)["model"]
    print(f"imported {args.pth} -> {args.out}")
    print(f"  {cfg['model_type']} layers={cfg['layer_sizes']} "
          f"norm={cfg['normalization']} bias={cfg['use_bias']} "
          f"bidir={cfg['bidirectional']}")
    if args.verify:
        verify(obj, cfg, state_dict)
    return 0


if __name__ == "__main__":
    sys.exit(main())
