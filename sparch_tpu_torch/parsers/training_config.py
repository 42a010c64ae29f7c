"""Training configuration flags (counterpart of
sparch_tpu/parsers/training_config.py): the same names, types, choices and
defaults. ``run_exp_torch.py`` refuses the flags whose paths the port does
not have yet (``train/loop.py``), so that ``-h`` still shows the whole
surface."""
from __future__ import annotations

import logging

from sparch_tpu_torch.parsers.model_config import strtobool

__all__ = ["add_training_options", "print_training_options"]

_TRAINING_OPTION_KEYS = [
    "use_pretrained_model",
    "only_do_testing",
    "load_exp_folder",
    "new_exp_folder",
    "dataset_name",
    "data_folder",
    "log_tofile",
    "save_best",
    "batch_size",
    "nb_epochs",
    "start_epoch",
    "lr",
    "scheduler_patience",
    "scheduler_factor",
    "use_regularizers",
    "reg_factor",
    "reg_fmin",
    "reg_fmax",
    "use_augm",
    # extensions of the original CLI, logged too, so that a run can be
    # reconstructed from <exp>/log/exp.log alone
    "nb_steps",
    "seed",
    "state_init",
    "cell_impl",
    "compute_dtype",
    "input_dtype",
    "mxu_precision",
    "mesh_model",
    "pad_multiple",
    "workers",
    "frontend",
    "prng_impl",
    "compile_cache",
    "profile_dir",
    "auto_resume",
]


def add_training_options(parser):
    parser.add_argument(
        "--use_pretrained_model",
        type=strtobool,
        default=False,
        help="Start from a previously saved checkpoint instead of "
        "initialising fresh parameters.",
    )
    parser.add_argument(
        "--only_do_testing",
        type=strtobool,
        default=False,
        help="Skip all training and just evaluate the loaded model on the "
        "test split.",
    )
    parser.add_argument(
        "--load_exp_folder",
        type=str,
        default=None,
        help="Existing experiment directory whose checkpoint should be "
        "loaded; the run's new outputs are written to this same directory.",
    )
    parser.add_argument(
        "--new_exp_folder",
        type=str,
        default=None,
        help="Directory to create for this experiment's logs and "
        "checkpoints (a config-derived name is generated when omitted).",
    )
    parser.add_argument(
        "--dataset_name",
        type=str,
        choices=["shd", "ssc", "hd", "sc"],
        default="shd",
        help="Benchmark to run: spiking events (shd, ssc) or raw audio "
        "(hd, sc).",
    )
    parser.add_argument(
        "--data_folder",
        type=str,
        default="data/shd_dataset/",
        help="Directory holding the dataset files.",
    )
    parser.add_argument(
        "--log_tofile",
        type=strtobool,
        default=False,
        help="Write the run log to <exp>/log/exp.log instead of the "
        "terminal.",
    )
    parser.add_argument(
        "--save_best",
        type=strtobool,
        default=True,
        help="Keep a checkpoint of the epoch with the best validation "
        "accuracy; disable to train without writing any checkpoint.",
    )
    parser.add_argument(
        "--batch_size",
        type=int,
        default=128,
        help="Examples per gradient step.",
    )
    parser.add_argument(
        "--nb_epochs",
        type=int,
        default=5,
        help="How many passes over the training set to run.",
    )
    parser.add_argument(
        "--start_epoch",
        type=int,
        default=0,
        help="Epoch-counter offset when resuming a checkpoint; keep 0 for "
        "fresh runs. Training covers epochs start_epoch+1 .. "
        "start_epoch+nb_epochs.",
    )
    parser.add_argument(
        "--lr",
        type=float,
        default=1e-2,
        help="Adam step size at the start of training. 1e-2 suits the "
        "spiking datasets; 1e-3 tends to work better on raw audio.",
    )
    parser.add_argument(
        "--scheduler_patience",
        type=int,
        default=1,
        help="Epochs the plateau scheduler tolerates without a validation "
        "improvement before cutting the learning rate.",
    )
    parser.add_argument(
        "--scheduler_factor",
        type=float,
        default=0.7,
        help="Multiplier in (0, 1) applied to the learning rate each time "
        "the plateau patience runs out.",
    )
    parser.add_argument(
        "--use_regularizers",
        type=strtobool,
        default=False,
        help="Add the firing-rate hinge penalty to the loss, pushing "
        "per-neuron spike rates into the [reg_fmin, reg_fmax] band.",
    )
    parser.add_argument(
        "--reg_factor",
        type=float,
        default=0.5,
        help="Weight of the firing-rate penalty relative to the "
        "cross-entropy term.",
    )
    parser.add_argument(
        "--reg_fmin",
        type=float,
        default=0.01,
        help="Rate floor: neurons firing below this contribute to the "
        "penalty.",
    )
    parser.add_argument(
        "--reg_fmax",
        type=float,
        default=0.5,
        help="Rate ceiling: neurons firing above this contribute to the "
        "penalty.",
    )
    parser.add_argument(
        "--use_augm",
        type=strtobool,
        default=False,
        help="Apply the waveform augmentation chain during training "
        "(hd/sc only; has no effect on the spiking datasets).",
    )
    parser.add_argument(
        "--nb_steps",
        type=int,
        default=100,
        help="Number of time bins for the spiking (shd/ssc) datasets.",
    )
    # --- extensions of the original CLI ---
    parser.add_argument(
        "--auto_resume",
        type=strtobool,
        default=False,
        help="If the experiment folder already exists with a checkpoint, "
        "resume from it instead of failing (crash recovery; the reference "
        "requires a manual --use_pretrained_model relaunch).",
    )
    parser.add_argument(
        "--prng_impl",
        type=str,
        choices=["rbg", "threefry2x32"],
        default="rbg",
        help="Random-generator implementation of the JAX package's runs. "
        "The port records it in the experiment's meta and selects "
        "nothing with it: its runs draw from one torch.Generator.",
    )
    parser.add_argument(
        "--seed",
        type=int,
        default=0,
        help="Global PRNG seed (params init, dropout, state init, shuffling).",
    )
    parser.add_argument(
        "--mesh_model",
        type=int,
        default=1,
        help="Tensor-parallel ('model' mesh axis) size. The P ranks run "
        "one a card on cuda:0..P-1 where the process sees at least P cards, "
        "in the one-card form where it sees one (each data-parallel process "
        "sees its own), and are refused in between; across cards only the "
        "spiking pallas_tp cells split (the ANN ones wait for "
        "ROADMAP item 7c).",
    )
    parser.add_argument(
        "--seq_parallel",
        type=int,
        default=1,
        help="Sequence-parallel ('seq' mesh axis) size: shard the time "
        "axis and run the recurrences as a state-passing pipeline "
        "(parallel/seqpipe.py), its S stages one a card on cuda:0..S-1 "
        "where the process sees at least S x P (the model axis) cards, else "
        "on its one card. Composes with --mesh_model (tensor parallel, on "
        "one card; across cards ROADMAP item 7c) and with data parallelism "
        "(each process pipelines its rows on its card). Supports "
        "bidirectional models (the batch trick runs across the sharded "
        "time axis). Requires a readout layer and --frontend host; "
        "batches whose shapes do not divide the mesh fall back to the "
        "plain step.",
    )
    parser.add_argument(
        "--seq_microbatches",
        type=int,
        default=4,
        help="Microbatches per sequence-parallel pipeline tick (fill/"
        "drain bubble is (S-1)/(M+S-1)); the per-data-shard batch must "
        "divide it, else the batch falls back to the plain step.",
    )
    parser.add_argument(
        "--profile_dir",
        type=str,
        default=None,
        help="If set, capture a profiler trace (torch.profiler, a Chrome "
        "trace) of the first training epoch into this directory.",
    )
    parser.add_argument(
        "--workers",
        type=int,
        default=0,
        help="Data-loading worker processes per host (0 = load in the "
        "main process with a prefetch thread).",
    )
    parser.add_argument(
        "--pad_multiple",
        type=int,
        default=100,
        help="Round variable-length (hd/sc) batch time dims up to this "
        "multiple so that a bounded number of shapes is compiled.",
    )
    parser.add_argument(
        "--compile_cache",
        type=str,
        default=None,
        help="Directory in which the CUDA kernels are built and loaded. "
        "'true' takes a per-user directory under the temporary "
        "directory; 'false' or unset, build/kernels in the checkout.",
    )
    parser.add_argument(
        "--frontend",
        type=str,
        choices=["host", "device"],
        default="host",
        help="Where the hd/sc log-mel filterbank runs. 'host' computes "
        "features in the data loader (reference behaviour); 'device' "
        "ships raw waveforms and runs the fbank on the device. "
        "run_exp_torch.py refuses 'device' until the port has the "
        "device filterbank.",
    )
    return parser


def print_training_options(args):
    """Log the resolved training options, one key=value line each."""
    opts = vars(args)
    lines = ["", "training options:"]
    lines += [f"  {k}={opts[k]}" for k in _TRAINING_OPTION_KEYS if k in opts]
    logging.info("\n".join(lines))
