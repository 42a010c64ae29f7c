#!/usr/bin/env python
"""Experiment runner CLI of the PyTorch/CUDA port (counterpart of
run_exp.py): the same flags, driving ``sparch_tpu_torch.train.loop``'s
``Experiment`` on the CUDA card.

    python run_exp_torch.py --dataset_name ssc --data_folder DIR ...

Run ``python run_exp_torch.py -h`` for the flags. The four datasets
(``--dataset_name shd|ssc|hd|sc``) and both audio frontends (``--frontend
host|device``) run; ``--compile_cache DIR`` builds and loads the CUDA
kernels in DIR, ``--profile_dir DIR`` writes a profiler trace of the first
epoch there. The flags whose paths the port does not have yet raise
``NotImplementedError`` naming their ROADMAP item: ``--cell_impl
pallas_tp``, ``--mesh_model`` other than 1 and ``--seq_parallel`` other
than 1. From Python, ``main(argv, device="cpu")`` runs on the CPU.
"""
import argparse

from sparch_tpu_torch.parsers.model_config import add_model_options
from sparch_tpu_torch.parsers.training_config import add_training_options
from sparch_tpu_torch.train.loop import Experiment


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train or evaluate spiking/non-spiking speech-command "
        "models (SHD/SSC/HD/SC) with the PyTorch/CUDA port."
    )
    parser = add_model_options(parser)
    parser = add_training_options(parser)
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """Build an Experiment from the CLI flags and drive it to completion;
    ``device=None`` is the CUDA card."""
    args = parse_args(argv)
    experiment = Experiment(args, device=device)
    experiment.forward()
    return experiment


if __name__ == "__main__":
    main()
