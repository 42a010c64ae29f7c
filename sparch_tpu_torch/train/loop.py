"""Experiment orchestration: the end-to-end train/valid/test run
(counterpart of sparch_tpu/train/loop.py).

The same CLI semantics, experiment-folder conventions, log lines, plateau
schedule, best-only checkpoints and test-split choice as the JAX loop, on
the four datasets (SHD/SSC spike rasters, HD/SC audio), on one device (the
CUDA card unless the caller asks for another) or on R data-parallel
processes (``python -m torch.distributed.run --nproc_per_node R
run_exp_torch.py ...``; ``parallel/multihost.py``):

- the loader's producer thread makes torch tensors of each batch and, for
  the card, pins them, so the host-to-device copy is asynchronous
  (``non_blocking=True``);
- a step's metrics stay on the device until the end of the epoch, which
  fetches them in one copy;
- checkpoints carry the optimizer, the generator and the scheduler, so a
  resumed run continues bit for bit;
- with ``--frontend device`` (HD/SC) the loader ships padded waveforms and
  their frame counts, and the model, wrapped in ``FbankFrontend``, computes
  the fbank on the card;
- ``--compile_cache`` sets where the CUDA kernels are built and loaded
  (``utils/cache.py``) before the model is built, and ``--profile_dir``
  captures a ``torch.profiler`` trace of the first training epoch
  (``utils/profiling.py``);
- under R ranks each rank's loader yields its contiguous slice of every
  global batch (a ragged last batch is dropped), the model and the train
  step, inside ``multihost.sharded()``, compute the global batch's step
  (``parallel/multihost.py``), the
  epoch's metrics are averaged over the ranks in one all-reduce, so that
  the scheduler, the best epoch and the logs see the same numbers on every
  rank, and rank 0 alone creates the folders and writes the log and the
  checkpoints;
- ``--cell_impl pallas_tp --mesh_model P`` runs the spiking layers through
  the tensor-parallel kernels in their one-card form (``parallel/mesh.py``),
  every batch of any number of rows; ``--mesh_model P`` with
  ``auto``/``scan`` runs the same function whole on the one card;
- ``--seq_parallel S --seq_microbatches M`` trains and evaluates through
  the time-pipelined steps (``parallel/seqpipe.py``), its S stages in this
  process on its one device; a batch whose shape does not divide them (T
  by S, the process's rows by M) takes the ordinary step, as in the JAX
  loop, and is logged and counted (``history``'s ``steps_by_path``).
"""
from __future__ import annotations

import logging
import os
import time
from collections import Counter
from datetime import timedelta

import numpy as np
import torch

from sparch_tpu_torch.data.audio import load_hd_or_sc
from sparch_tpu_torch.data.spiking import load_shd_or_ssc
from sparch_tpu_torch.models import SNN_NEURON_TYPES, build_model
from sparch_tpu_torch.models.frontend import FbankFrontend
from sparch_tpu_torch.parallel import (
    make_mesh,
    placement,
    visible_cards,
    make_seq_mesh,
    make_seqpipe_eval_step,
    make_seqpipe_train_step,
    multihost,
)
from sparch_tpu_torch.parsers.model_config import print_model_options
from sparch_tpu_torch.parsers.training_config import print_training_options
from sparch_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    restore_checkpoint,
    save_checkpoint,
)
from sparch_tpu_torch.train.schedule import ReduceLROnPlateau
from sparch_tpu_torch.train.state import create_train_state
from sparch_tpu_torch.train.steps import make_eval_step, make_train_step
from sparch_tpu_torch.utils.cache import use_compile_cache
from sparch_tpu_torch.utils.device import resolve_device
from sparch_tpu_torch.utils.profiling import trace

__all__ = ["Experiment"]


class Experiment:
    """Training and testing of SNN/ANN models on the four speech command
    recognition datasets (shd, ssc, hd, sc).

    ``device=None`` is the CUDA card (a data-parallel rank's,
    ``cuda:LOCAL_RANK % device_count``) and raises without one;
    ``device="cpu"`` runs on the CPU.

    Besides the log, a run keeps ``history`` (a dict an epoch of each
    split: its loss, accuracy and mean firing rate; a training epoch also
    its wall seconds with the host fetch, its utterances, the seconds the
    loop waited on the loader for its next batch and whether the batches
    were pinned; under ``--seq_parallel`` every epoch also its batches by
    step, ``steps_by_path``) and ``host_fetches`` (the metric fetches by
    split: one an epoch)."""

    def __init__(self, args, device=None):
        # the process group first (nothing on one process), then the card
        if multihost.maybe_initialize() and device is None:
            device = multihost.local_device()
        self.device = resolve_device(device)
        self.mesh_model = getattr(args, "mesh_model", 1)
        self.seq_parallel = getattr(args, "seq_parallel", 1)
        self.seq_microbatches = getattr(args, "seq_microbatches", 4)

        # model config
        self.model_type = args.model_type
        self.nb_layers = args.nb_layers
        self.nb_hiddens = args.nb_hiddens
        self.pdrop = args.pdrop
        self.normalization = args.normalization
        self.use_bias = args.use_bias
        self.bidirectional = args.bidirectional

        # training config
        self.use_pretrained_model = args.use_pretrained_model
        self.only_do_testing = args.only_do_testing
        self.load_exp_folder = args.load_exp_folder
        self.new_exp_folder = args.new_exp_folder
        self.dataset_name = args.dataset_name
        self.data_folder = args.data_folder
        self.log_tofile = args.log_tofile
        self.save_best = args.save_best
        self.batch_size = args.batch_size
        self.nb_epochs = args.nb_epochs
        self.start_epoch = args.start_epoch
        self.lr = args.lr
        self.scheduler_patience = args.scheduler_patience
        self.scheduler_factor = args.scheduler_factor
        self.use_regularizers = args.use_regularizers
        self.reg_factor = args.reg_factor
        self.reg_fmin = args.reg_fmin
        self.reg_fmax = args.reg_fmax
        self.use_augm = args.use_augm
        self.threshold = getattr(args, "threshold", 1.0)
        self.nb_steps = getattr(args, "nb_steps", 100)
        self.auto_resume = getattr(args, "auto_resume", False)

        # extensions of the original CLI
        self.seed = getattr(args, "seed", 0)
        self.state_init = getattr(args, "state_init", "uniform")
        self.cell_impl = getattr(args, "cell_impl", "auto")
        self.pad_multiple = getattr(args, "pad_multiple", 100)
        self.workers = getattr(args, "workers", 0)
        self.compute_dtype = getattr(args, "compute_dtype", "float32")
        self.remat = getattr(args, "remat", False)
        self.input_dtype = getattr(args, "input_dtype", "float32")
        # recorded in the model record; the port draws from one
        # torch.Generator whatever it says
        self.prng_impl = getattr(args, "prng_impl", "rbg")
        self.profile_dir = getattr(args, "profile_dir", None)
        # where the kernels are built and loaded: the directory the flag
        # names, or build/kernels where it is unset or false
        self.kernel_dir = use_compile_cache(
            getattr(args, "compile_cache", None))
        self.frontend = getattr(args, "frontend", "host")
        if self.frontend == "device" and self.dataset_name not in ("hd", "sc"):
            logging.warning(
                "\n--frontend device only applies to hd/sc (waveform "
                "datasets); using the standard pipeline.\n"
            )
            self.frontend = "host"
        if self.input_dtype == "bfloat16" and self.frontend == "device":
            # bf16 would round the audio samples themselves
            logging.warning(
                "\n--input_dtype bfloat16 is ignored with --frontend "
                "device (waveform batches stay float32).\n"
            )
            self.input_dtype = "float32"
        self.pinned = self.device.type == "cuda"
        self._check_seq_parallel()

        self.init_exp_folders()
        self.init_logging()
        print_model_options(args)
        print_training_options(args)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else self.device.type)
        logging.info(f"\nDevice: {self.device} ({name})\n")
        self.init_mesh()

        self.init_dataset()
        self.init_model()

        # plateau schedule; on resume the saved one continues
        if self._restored_meta.get("scheduler"):
            self.scheduler = ReduceLROnPlateau.from_state_dict(
                self._restored_meta["scheduler"]
            )
        else:
            self.scheduler = ReduceLROnPlateau(
                lr=self.lr,
                mode="max",
                factor=self.scheduler_factor,
                patience=self.scheduler_patience,
                min_lr=1e-6,
            )

        self._train_step = make_train_step(
            self.net,
            use_regularizers=self.use_regularizers,
            reg_factor=self.reg_factor,
            reg_fmin=self.reg_fmin,
            reg_fmax=self.reg_fmax,
        )
        self._eval_step = make_eval_step(self.net)
        self._pipe_train_step = self._pipe_eval_step = None
        if self.seq_mesh is not None:
            self._pipe_train_step = make_seqpipe_train_step(
                self.net, self.seq_mesh, n_micro=self.seq_microbatches,
                use_regularizers=self.use_regularizers,
                reg_factor=self.reg_factor, reg_fmin=self.reg_fmin,
                reg_fmax=self.reg_fmax)
            self._pipe_eval_step = make_seqpipe_eval_step(
                self.net, self.seq_mesh, n_micro=self.seq_microbatches)
        # The JAX loop splits one state-init key a batch from seed + 1;
        # here one generator seeded seed + 1 gives every eval batch its
        # draws in batch order (another stream, the same role)
        self._eval_generator = torch.Generator(
            device=self.device).manual_seed(self.seed + 1)
        self.history = []
        self.host_fetches = Counter()

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------

    def init_exp_folders(self):
        """Experiment folder conventions. Every rank checks the folder
        before rank 0 creates it."""
        if self.use_pretrained_model:
            exp_folder = self.load_exp_folder
            self.load_path = os.path.join(exp_folder, "checkpoints")
            if not checkpoint_exists(self.load_path):
                raise FileNotFoundError(
                    f"No checkpoint found at {self.load_path}/best_model"
                )
        elif self.new_exp_folder is not None:
            exp_folder = self.new_exp_folder
        else:
            outname = self.dataset_name + "_" + self.model_type + "_"
            outname += str(self.nb_layers) + "lay" + str(self.nb_hiddens)
            outname += "_drop" + str(self.pdrop) + "_" + str(self.normalization)
            outname += "_bias" if self.use_bias else "_nobias"
            outname += "_bdir" if self.bidirectional else "_udir"
            outname += "_reg" if self.use_regularizers else "_noreg"
            outname += "_lr" + str(self.lr)
            exp_folder = "exp/test_exps/" + outname.replace(".", "_")

        self._auto_resumed = False
        if not self.use_pretrained_model and os.path.exists(exp_folder):
            ckdir = os.path.join(exp_folder, "checkpoints")
            if self.auto_resume and checkpoint_exists(ckdir):
                self._auto_resumed = True
                self.load_path = ckdir
            else:
                raise FileExistsError(
                    f"Experiment folder already exists: {exp_folder}"
                )

        self.log_dir = os.path.join(exp_folder, "log")
        self.checkpoint_dir = os.path.join(exp_folder, "checkpoints")
        multihost.barrier()
        if multihost.is_main():
            os.makedirs(self.log_dir, exist_ok=True)
            os.makedirs(self.checkpoint_dir, exist_ok=True)
        multihost.barrier()
        self.exp_folder = exp_folder

    def init_logging(self):
        """Log to a dedicated file or the terminal; the ranks other than
        0 log only warnings, to the terminal."""
        if not multihost.is_main():
            logging.basicConfig(level=logging.WARNING,
                                format=f"[rank {multihost.rank()}] "
                                "%(message)s", force=True)
        elif self.log_tofile:
            logging.basicConfig(
                filename=os.path.join(self.log_dir, "exp.log"),
                level=logging.INFO,
                format="%(message)s",
                force=True,
            )
        else:
            logging.basicConfig(
                level=logging.INFO, format="%(message)s", force=True
            )

    def init_mesh(self):
        """The ('data', 'model') mesh and the optional ('data', 'seq',
        'model') pipeline mesh: the data axis is the processes; the S x P
        stages and ranks go by ``parallel.mesh.placement`` over the cards
        this process sees (JAX loop.py:143-186 spreads them over every
        device): one card, or S x P = 1, the one-card form; at least S x
        P, one card each; between the two, refused."""
        P = self.mesh_model
        S = max(self.seq_parallel, 1)
        cards, note = placement(S, P, visible_cards(self.device))
        if cards is not None and self.device.index not in (None, 0):
            raise ValueError(f"the form across cards starts at {cards[0]}, "
                             f"the run's device is {self.device}")
        if cards is None:
            self.mesh = make_mesh([self.device] * P, model=P)
        elif S == 1:
            self.mesh = make_mesh(cards, model=P)
        else:  # the pipeline runs the layers (make_seq_mesh checks P)
            self.mesh = make_mesh([cards[0]] * P, model=P)
        shape = self.mesh.shape
        logging.info(
            f"\nDevice mesh: {shape['data'] * P} ranks on "
            f"{multihost.world_size()} process(es) x {self.device.type} "
            f"(data={shape['data']}, model={shape['model']}); {note}\n"
        )
        if multihost.data_parallel():
            logging.info(
                f"Data parallel: {multihost.world_size()} processes, backend "
                f"{multihost.backend()}, global batch {self.batch_size} "
                f"({self.batch_size // multihost.world_size()} a rank)\n"
            )
        if P > 1 and self.cell_impl != "pallas_tp":
            logging.info(
                f"--mesh_model {P} with --cell_impl {self.cell_impl}: each "
                "process computes the same function whole on its one "
                "device (only --cell_impl pallas_tp splits the neurons over "
                "the model axis)\n"
            )
        # the optional time-pipelined mesh: its S x P stages and ranks in
        # this process (dp x sp x tp)
        self.seq_mesh = None
        if S > 1:
            self.seq_mesh = make_seq_mesh(
                [self.device] * (S * P) if cards is None else cards, seq=S,
                model=P)
            logging.info(f"Sequence-parallel mesh: {self.seq_mesh.shape}, "
                         f"{self.seq_microbatches} microbatches\n")

    def _check_seq_parallel(self):
        """The JAX loop's conditions on ``--seq_parallel``, before anything
        is written."""
        if self.seq_parallel <= 1:
            return
        if self.remat:
            raise ValueError(
                "--remat has no effect under --seq_parallel: the "
                "time-pipelined step stores only per-microbatch "
                "activations already (its own memory bound). Drop "
                "one of the two flags."
            )
        if self.frontend == "device":
            raise ValueError(
                "--seq_parallel requires --frontend host (waveform "
                "pytree batches cannot shard the time axis)"
            )
        if self.cell_impl == "pallas_tp":
            raise ValueError(
                "--cell_impl pallas_tp does not compose with "
                "--seq_parallel (the time-pipelined step shards the "
                "recurrence itself)"
            )

    def _step_for(self, x, ordinary, pipelined, paths):
        """Under ``--seq_parallel``, the pipelined step for a batch whose
        shape divides the pipeline (the JAX ``_seq_ok``: T by the stages,
        the process's rows by the microbatches), counted in ``paths``;
        otherwise the ordinary step."""
        if pipelined is None:
            return ordinary
        piped = (x.shape[0] % self.seq_microbatches == 0
                 and x.shape[1] % self.seq_parallel == 0)
        paths["seqpipe" if piped else "ordinary"] += 1
        return pipelined if piped else ordinary

    def _shard_kw(self):
        """Each rank's slice of every global batch (the JAX
        ``_shard_kw``)."""
        if not multihost.data_parallel():
            return {}
        return dict(num_shards=multihost.world_size(),
                    shard_index=multihost.rank())

    def init_dataset(self):
        """Loaders of the dataset's splits: SHD/SSC rasters of 700 units,
        or HD/SC 40-bin fbanks (or their waveforms, ``--frontend
        device``)."""
        if self.dataset_name in ["shd", "ssc"]:
            self.nb_inputs = 700
            self.nb_outputs = 20 if self.dataset_name == "shd" else 35
            load = load_shd_or_ssc
            kw = dict(nb_steps=self.nb_steps)
        elif self.dataset_name in ["hd", "sc"]:
            self.nb_inputs = 40
            self.nb_outputs = 20 if self.dataset_name == "hd" else 35
            load = load_hd_or_sc
            kw = dict(use_augm=self.use_augm, pad_multiple=self.pad_multiple,
                      frontend=self.frontend)
        else:
            raise ValueError(f"Invalid dataset name {self.dataset_name}")
        kw.update(
            dataset_name=self.dataset_name,
            data_folder=self.data_folder,
            batch_size=self.batch_size,
            seed=self.seed,
            workers=self.workers,
            batch_transform=self._to_tensors,
            **self._shard_kw(),
        )
        self.train_loader = load(split="train", shuffle=True, **kw)
        self.valid_loader = load(split="valid", shuffle=False, **kw)
        if self.dataset_name in ["sc", "ssc"]:
            self.test_loader = load(split="test", shuffle=False, **kw)
        if self.dataset_name in ["hd", "sc"]:
            if self.use_augm:
                logging.info("\nData augmentation is used\n")
        elif self.use_augm:
            logging.warning(
                "\nWarning: Data augmentation not implemented for SHD and SSC.\n"
            )

    def init_model(self):
        """Build (or restore) the model and its training state."""
        input_shape = (self.batch_size, None, self.nb_inputs)
        layer_sizes = [self.nb_hiddens] * (self.nb_layers - 1) + [self.nb_outputs]

        # the architecture record saved into the checkpoint's meta, key for
        # key the JAX loop's, so that serving rebuilds the model from the
        # experiment folder alone (serve.load_experiment)
        self._model_config = {
            "model_type": self.model_type,
            "input_shape": list(input_shape),
            "layer_sizes": list(layer_sizes),
            "threshold": self.threshold,
            "dropout": self.pdrop,
            "normalization": self.normalization,
            "use_bias": self.use_bias,
            "bidirectional": self.bidirectional,
            "state_init": self.state_init,
            "cell_impl": self.cell_impl,
            "compute_dtype": self.compute_dtype,
            "input_dtype": self.input_dtype,
            "frontend": self.frontend,
            "remat": self.remat,
            "prng_impl": self.prng_impl,
            "pad_multiple": self.pad_multiple,
        }
        tp = {}
        if self.cell_impl == "pallas_tp":
            self._check_pallas_tp()
            tp = dict(tp_mesh=self.mesh, tp_axis="model",
                      tp_batch_axis="data")
        self.net = build_model(
            self.model_type, input_shape, layer_sizes,
            threshold=self.threshold,
            dropout=self.pdrop,
            normalization=self.normalization,
            use_bias=self.use_bias,
            bidirectional=self.bidirectional,
            use_readout_layer=True,
            state_init=self.state_init,
            cell_impl=self.cell_impl,
            compute_dtype=(None if self.compute_dtype == "float32"
                           else torch.bfloat16),
            remat=self.remat,
            generator=torch.Generator().manual_seed(self.seed),
            **tp,
        )
        if self.frontend == "device":
            self.net = FbankFrontend(inner=self.net)
        self.state = create_train_state(self.net, self.lr, device=self.device,
                                        seed=self.seed)

        self._restored_meta = {}
        if self.use_pretrained_model or self._auto_resumed:
            self.state, self._restored_meta = restore_checkpoint(
                self.load_path, self.state
            )
            logging.info(f"\nLoaded model at: {self.load_path}\n")
        # every rank starts from rank 0's weights and statistics: a CPU
        # initialisation (the orthogonal V's QR) need not give the same
        # bits in processes of other thread counts or on other hosts
        multihost.broadcast_([t for t in self.net.state_dict().values()
                              if t.is_floating_point()])

        self.nb_params = sum(p.numel() for p in self.net.parameters())
        kind = "spiking" if self.model_type in SNN_NEURON_TYPES else "non-spiking"
        logging.info(f"\nCreated new {kind} model: {self.net}\n")
        logging.info(f"Total number of trainable parameters is {self.nb_params}")

    def _check_pallas_tp(self):
        """The JAX loop's conditions on ``--cell_impl pallas_tp``."""
        if self.model_type not in SNN_NEURON_TYPES:
            raise ValueError(
                "--cell_impl pallas_tp covers the spiking models "
                "(LIF/adLIF/RLIF/RadLIF); the ANN cells run --cell_impl auto"
            )
        if self.mesh_model < 2:
            raise ValueError(
                "--cell_impl pallas_tp needs --mesh_model >= 2 (the kernels "
                "split the neurons over the 'model' mesh axis)"
            )
        if self.nb_hiddens % (self.mesh_model * 128):
            raise ValueError(
                f"--cell_impl pallas_tp needs --nb_hiddens divisible by "
                f"mesh_model*128 = {self.mesh_model * 128}, got "
                f"{self.nb_hiddens}"
            )

    # ------------------------------------------------------------------
    # Host and device
    # ------------------------------------------------------------------

    def _to_tensors(self, batch):
        """The loader's ``batch_transform``, run in its producer thread:
        torch tensors of the batch (the raster in bf16 under
        ``--input_dtype bfloat16``: lossless for spike counts), pinned when
        they go to the card. With ``--frontend device`` the model's input
        is the pair (waveforms, frame counts)."""
        x, xlens, y = batch
        x = torch.from_numpy(x)
        if self.input_dtype == "bfloat16":
            x = x.to(torch.bfloat16)
        y = torch.from_numpy(y)
        if self.pinned:
            x, y = x.pin_memory(), y.pin_memory()
        if self.frontend == "device":
            lens = torch.from_numpy(xlens)
            x = (x, lens.pin_memory() if self.pinned else lens)
        return x, xlens, y

    def _put_batch(self, x, y):
        if multihost.data_parallel() and self.dataset_name in ("hd", "sc"):
            x = self._pad_to_global_length(x)
        if isinstance(x, tuple):
            x = tuple(t.to(self.device, non_blocking=True) for t in x)
        else:
            x = x.to(self.device, non_blocking=True)
        return x, y.to(self.device, non_blocking=True)

    def _pad_to_global_length(self, x):
        """HD/SC batches are padded to their longest utterance: a rank's
        slice is padded further, with zeros, to the longest of the global
        batch, the length the one-process batch has (one scalar all-reduce
        a step)."""
        lead = x[0] if isinstance(x, tuple) else x
        n = multihost.max_over_ranks(lead.shape[1], self.device)
        if n == lead.shape[1]:
            return x
        pad = [0, 0] * (lead.ndim - 2) + [0, n - lead.shape[1]]
        lead = torch.nn.functional.pad(lead, pad)
        return (lead, x[1]) if isinstance(x, tuple) else lead

    def _fetch(self, kind: str, losses, accs, rates) -> np.ndarray:
        """The epoch's one host fetch: the metrics' device scalars stacked
        and copied at once, averaged over the ranks in one all-reduce (the
        global batch's, since the ranks hold as many rows); returns (3,
        batches)."""
        self.host_fetches[kind] += 1
        stacked = torch.stack(
            [torch.stack(losses), torch.stack(accs), torch.stack(rates)])
        multihost.all_reduce_mean_([stacked], "metrics")
        return stacked.cpu().numpy()

    # ------------------------------------------------------------------
    # Train / valid / test epochs
    # ------------------------------------------------------------------

    def train_one_epoch(self, e: int):
        start = time.time()
        losses, accs, rates = [], [], []
        waited, utterances = 0.0, 0
        paths = Counter()

        batches = iter(self.train_loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            waited += time.perf_counter() - t0
            if batch is None:
                break
            x, _, y = batch
            x, y = self._put_batch(x, y)
            step = self._step_for(x, self._train_step,
                                  self._pipe_train_step, paths)
            with multihost.sharded():
                self.state, metrics = step(self.state, x, y)
            losses.append(metrics["loss"])
            accs.append(metrics["acc"])
            rates.append(metrics["spike_rate"])
            # the global batch's utterances
            utterances += y.shape[0] * multihost.world_size()

        # one host fetch for the whole epoch
        losses, accs, rates = self._fetch("train", losses, accs, rates)
        seconds = time.time() - start

        current_lr = self.scheduler.lr
        logging.info(f"Epoch {e}: lr={current_lr}")
        train_loss = float(np.mean(losses))
        logging.info(f"Epoch {e}: train loss={train_loss}")
        train_acc = float(np.mean(accs))
        logging.info(f"Epoch {e}: train acc={train_acc}")
        rate = float(np.mean(rates))
        if self.net.is_snn:
            logging.info(f"Epoch {e}: train mean act rate={rate}")
        self.history.append(dict(
            split="train", epoch=e, loss=train_loss, acc=train_acc,
            rate=rate, seconds=seconds, utterances=utterances,
            loader_wait_s=waited, pinned=self.pinned,
            **self._log_paths(f"Epoch {e}: train", paths)))
        elapsed = str(timedelta(seconds=time.time() - start))
        logging.info(f"Epoch {e}: train elapsed time={elapsed}")

    def _log_paths(self, what: str, paths) -> dict:
        """Under ``--seq_parallel``: log the batches that took the ordinary
        step, and return ``{"steps_by_path": ...}`` for the history."""
        if self.seq_mesh is None:
            return {}
        if paths["ordinary"]:
            logging.info(
                f"{what}: {paths['ordinary']} of {sum(paths.values())} "
                "batches took the ordinary step (T not divisible by "
                f"--seq_parallel {self.seq_parallel} or the rows by "
                f"--seq_microbatches {self.seq_microbatches})")
        return {"steps_by_path": {"seqpipe": paths["seqpipe"],
                                  "ordinary": paths["ordinary"]}}

    def _eval_epoch(self, loader, kind: str):
        losses, accs, rates = [], [], []
        paths = Counter()
        for x, _, y in loader:
            x, y = self._put_batch(x, y)
            step = self._step_for(x, self._eval_step,
                                  self._pipe_eval_step, paths)
            with multihost.sharded():
                metrics = step(self.state, x, y, self._eval_generator)
            losses.append(metrics["loss"])
            accs.append(metrics["acc"])
            rates.append(metrics["spike_rate"])
        losses, accs, rates = self._fetch(kind, losses, accs, rates)
        return (float(np.mean(losses)), float(np.mean(accs)),
                float(np.mean(rates)), self._log_paths(kind, paths))

    def _record(self, split, epoch, loss, acc, rate, paths):
        self.history.append(dict(split=split, epoch=epoch, loss=loss,
                                 acc=acc, rate=rate, **paths))

    def valid_one_epoch(self, e: int, best_epoch: int, best_acc: float):
        valid_loss, valid_acc, rate, paths = self._eval_epoch(
            self.valid_loader, "valid")
        logging.info(f"Epoch {e}: valid loss={valid_loss}")
        logging.info(f"Epoch {e}: valid acc={valid_acc}")
        if self.net.is_snn:
            logging.info(f"Epoch {e}: valid mean act rate={rate}")
        self._record("valid", e, valid_loss, valid_acc, rate, paths)

        # plateau on the valid accuracy
        new_lr = self.scheduler.step(valid_acc)
        self.state = self.state.set_lr(new_lr)

        if valid_acc > best_acc:
            best_acc = valid_acc
            best_epoch = e
            if self.save_best:
                save_checkpoint(
                    self.checkpoint_dir,
                    self.state,
                    meta={
                        "epoch": e,
                        "best_acc": best_acc,
                        "scheduler": self.scheduler.state_dict(),
                        "model": self._model_config,
                    },
                )
                logging.info(f"\nBest model saved with valid acc={valid_acc}")

        logging.info("\n-----------------------------\n")
        return best_epoch, best_acc

    def test_one_epoch(self, test_loader):
        logging.info("\n------ Begin Testing ------\n")
        test_loss, test_acc, rate, paths = self._eval_epoch(test_loader,
                                                            "test")
        logging.info(f"Test loss={test_loss}")
        logging.info(f"Test acc={test_acc}")
        if self.net.is_snn:
            logging.info(f"Test mean act rate={rate}")
        self._record("test", None, test_loss, test_acc, rate, paths)
        logging.info("\n-----------------------------\n")
        self.test_acc = test_acc
        return test_acc

    # ------------------------------------------------------------------
    # The whole run
    # ------------------------------------------------------------------

    def forward(self):
        if not self.only_do_testing:
            if self._auto_resumed:
                best_epoch = int(self._restored_meta.get("epoch", 0))
                best_acc = float(self._restored_meta.get("best_acc", 0.0))
                logging.info(
                    f"\n------ Auto-resumed from epoch {best_epoch} "
                    f"(best valid acc {best_acc}) ------\n"
                )
            elif self.use_pretrained_model:
                logging.info("\n------ Using pretrained model ------\n")
                best_epoch, best_acc = self.valid_one_epoch(self.start_epoch, 0, 0)
            else:
                best_epoch, best_acc = 0, 0

            logging.info("\n------ Begin training ------\n")

            first_epoch = best_epoch + 1  # best_epoch changes in the loop
            for e in range(best_epoch + 1, best_epoch + self.nb_epochs + 1):
                # a profiler trace of the first epoch, if asked for
                # (rank 0's, under data parallelism)
                with trace(self.profile_dir if e == first_epoch and
                           multihost.is_main() else None, self.device):
                    self.train_one_epoch(e)
                best_epoch, best_acc = self.valid_one_epoch(e, best_epoch, best_acc)

            logging.info(f"\nBest valid acc at epoch {best_epoch}: {best_acc}\n")
            logging.info("\n------ Training finished ------\n")

            # the best checkpoint back for the final test
            if self.save_best and checkpoint_exists(self.checkpoint_dir):
                self.state, _ = restore_checkpoint(self.checkpoint_dir, self.state)
                logging.info(
                    f"Loading best model, epoch={best_epoch}, valid acc={best_acc}"
                )
            else:
                logging.info(
                    "Cannot load best model because save_best option is "
                    "disabled. Model from last epoch is used for testing."
                )

        # shd and hd reuse the valid split for the test
        if self.dataset_name in ["sc", "ssc"]:
            self.test_one_epoch(self.test_loader)
        else:
            self.test_one_epoch(self.valid_loader)
            logging.info(
                "\nThis dataset uses the same split for validation and testing.\n"
            )
