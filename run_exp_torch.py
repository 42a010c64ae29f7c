#!/usr/bin/env python
"""Experiment runner CLI of the PyTorch/CUDA port (counterpart of
run_exp.py): the same flags, driving ``sparch_tpu_torch.train.loop``'s
``Experiment`` on the CUDA card.

    python run_exp_torch.py --dataset_name ssc --data_folder DIR ...

Data parallelism over R processes (``--batch_size`` is the global batch,
a multiple of R; each rank trains on its slice and every rank takes the
global batch's step):

    python -m torch.distributed.run --nproc_per_node R run_exp_torch.py ...

The ranks take a card each (``nccl``) where there are as many cards, else
share them (``gloo``, as several ranks on one card or on the CPU do).

Run ``python run_exp_torch.py -h`` for the flags. The four datasets
(``--dataset_name shd|ssc|hd|sc``) and both audio frontends (``--frontend
host|device``) run; ``--cell_impl pallas_tp --mesh_model P`` runs the
spiking layers through the tensor-parallel kernels on each process's one
card, and ``--mesh_model P`` with ``auto``/``scan`` the same function whole;
``--compile_cache DIR`` builds and loads the CUDA kernels in DIR,
``--profile_dir DIR`` writes a profiler trace of the first epoch there;
``--seq_parallel S --seq_microbatches M`` trains through the time-pipelined
steps, the S stages in each process on its card. From Python,
``main(argv, device="cpu")`` runs on the CPU.
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
