#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sparch_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Builds every CUDA kernel of the serving and the training paths (the spiking
family's, the non-spiking family's and the tensor-parallel ones) from
``sparch_tpu_torch/csrc`` into ``build/kernels/`` (one ``nvcc`` per source,
all at once), then prints one JSON line per phase:

1. ``device``: the card's name and power limit (``nvidia-smi``), the TF32
   switches (both off) and the build time.
2. ``kernel_vs_plain`` for the fused cell: LIF, adLIF, RLIF and RadLIF at
   the serving shape (B=128, T=100, H=512) with the batchnorm affine, and
   a ragged case (B=5, T=13, H=40). With V on a dyadic grid the kernel's
   spikes must equal the plain version's bit for bit; with an orthogonal V
   the mismatch is bounded as ``orthogonal_check`` says. Kernel and plain
   times, CUDA events; the recurrent forms at the serving shape add their
   ``plan`` (column slices, ``fused_cells._fwd_plan``) and ``split_ms``
   (the first product and the time loop, CUDA events around each launch).
3. ``kernel_vs_plain`` for the readout at (128, 100, 35), rtol 1e-5, the
   membrane series bit for bit; ``ms`` the kernel's device time from a
   CUDA graph of launches (``graph_ms``), ``eager_ms`` a wrapper call
   timed as the other kernels are, its ``plan``, and ``auto_route_ms``:
   ``cells.readout_sum`` (the route ``auto`` took before it took the
   kernels) beside ``readout_fused``, eager, with kernels a call.
4. ``serving``: a RadLIF [512, 512, 35] Predictor (F=700, batch 128,
   seeded random weights, zero state init, running statistics from one
   train-mode pass) on 300 synthetic spike rasters of 2 % density, so the
   last batch is padded; variants ``scan`` (plain PyTorch), ``auto`` and
   ``pallas`` (the fused cell and readout kernels). On both models (see
   ``serving_state``) auto and pallas must reproduce the spikes of
   ``plain_fused_forward``, their function with each kernel replaced by
   its plain version. On the "zero_means" model they must also give
   scan's labels on >= 99 % and its probabilities within 1e-3; the
   "calibrated" model is timed and held to scan within bounds set by the
   scan path's own card-vs-CPU divergence (see ``phase_serving``). Launch
   counters are set to 0 just before each variant's first call and read
   just after; every kernel of the variant, and no other, must have
   launched.
5. ``kernel_vs_plain`` for the dropout hash and the training form of the
   fused cell (``fused_cell_fwd_train``): dropped spikes and the membrane
   series at (128, 100, 512), p = 0.1, and at the ragged shape, the four
   forms, dyadic V, bit for bit against the plain version; the dropped
   share within 0.1 +- 0.005. RadLIF adds its ``plan``, ``split_ms`` and
   ``at_256x1024``: the training form at the shape of the bidirectional
   RadLIF 1024 ``auto`` trainer (s0 drawn from U[0, 1) as its state init
   draws it), bit for bit against the plain version, timed and split, with
   its bound.
6. ``kernel_vs_plain`` for the backward (``fused_cell_bwd``): both sides get
   the same forward residuals; every gradient against the plain version,
   the error relative to that gradient's largest magnitude, bound 1e-4, or
   else no more than 4 times the float32 plain version's own error against
   the plain version in float64 (both errors are printed); two launches
   give the same bits. The recurrent forms run thread-block clusters: the
   lines give their plan; RadLIF adds ``split_ms`` (the time loop, the dV
   product, the second passes), ``dv_library_ms`` (``torch.matmul`` of the
   dV product's float32 operands, TF32 off: a yardstick) and
   ``at_256x1024``: the kernel at the shape of the bidirectional RadLIF
   1024 ``auto`` trainer, checked alike, timed and split.
7. ``kernel_vs_plain`` for the readout backward at (128, 100, 35), alike
   (one kernel a call, counted in a CUDA graph of the call;
   ``auto_route_ms`` of a forward and a backward).
7b. ``readout_wide``: the readout pair's wide forms (past the lane
   layout's 256 classes) at (128, 100, 300) and (8, 1100, 1500), more
   classes than a block has threads over two chunks of statistics: the
   forward within rtol 1e-5 of its plain version with the membrane series
   bit for bit, the backward within GRAD_REL_MAX, two launches bit-equal,
   each through ``readout_fused`` once (``auto``'s route at that width);
   ``ms`` of each kernel (``graph_ms``).
8. ``training``: a RadLIF [512, 512, 35] trainer (batchnorm, dropout 0.1,
   uniform state init, Adam at lr 1e-2; ``create_train_state``,
   ``make_train_step``) on one device-resident batch of 128 rasters of 2 %
   density, for ``scan``, ``auto`` and ``pallas`` from one seed and one
   state dict (V on a 2^-8 grid). Checks: step 1 of ``auto`` and ``pallas``
   against the same step with each kernel swapped for its plain version
   (loss within 1e-3 relative, every gradient within the backward bound);
   the loss is finite and lower after 10 steps than at step 1; every kernel
   of the variant launched, the stated number of times per step, and no
   other; two runs of three steps from one seed give bit-equal parameters.
   Against ``scan`` only the step-1 loss is held (loosely). Times:
   ``train_step_ms`` (CUDA events over 20 steps after 3 warm-up steps,
   median of 3; ``scan``: 5 steps after 1), ``utterances_per_s`` and the
   forward / backward / optimizer split (median of 10 steps; ``scan``: 3).
8b. ``experiment``: the CLI's main path. ``run_exp_torch.parse_args`` and
   ``train.loop.Experiment`` train RadLIF [512, 512, 35] (B=128, defaults
   otherwise: ``auto``, dropout 0.1, uniform state init, float32) on an
   SSC-shaped synthetic set made from a fixed seed (700 units, 35
   classes, 1.4 s, 100 bins, 800-3000 events an utterance; 1280 train, 256
   valid and 256 test utterances). The card's machine has no h5py
   (``EXP_DATA``): the Experiment's ``init_dataset`` alone is overridden,
   to build ``load_shd_or_ssc``'s loaders over datasets that serve the
   events from memory. Runs: 2 fresh epochs; ``--auto_resume`` for 1 more;
   ``--use_pretrained_model --only_do_testing``; then
   ``Predictor.from_experiment`` serves the test split. Checks: the
   parameters on the card; every run's kernels by name, the counters set
   to 0 just before ``forward()`` and read just after, 2
   ``fused_cell_fwd_train``, 2 ``fused_cell_bwd``, 1 ``readout_fwd`` and 1
   ``readout_bwd`` a step, 2 ``fused_cell_fwd`` and 1 ``readout_fwd`` an
   eval batch, and no other, ``cells.readout_sum`` called 0 times; one
   host fetch an epoch; finite losses; a
   state saved, restored into a fresh state and stepped equals the
   uninterrupted step bit for bit (loss, parameters, Adam's moments, the
   CUDA generator); ``from_experiment``'s probabilities equal
   ``Predictor(model, state_dict)``'s bit for bit. Prints epoch wall
   times, utterances/s with the loader in them beside phase 8's
   device-resident ``auto`` step and beside an epoch of the same steps on
   batches made beforehand (``loader_free_utterances_per_s``), the loader
   wait, the pinned copy, the binning branch, losses and accuracies by epoch, the served test
   accuracy and each hidden layer's mean firing rate after training.
8c. ``audio``: the HD/SC path. It writes an SC-shaped tree of WAVs with the
   stdlib ``wave`` module into a temporary folder (35 label folders of
   one-second 16 kHz utterances made from a seed, two harmonics of each
   label's pitch over noise; ``validation_list.txt`` and
   ``testing_list.txt`` of 128 each; a ``_background_noise_`` folder the
   dataset must leave out) and an HD-shaped one (20 classes, training
   utterances of 0.6-1.6 s, so that their frame counts fall in two
   ``pad_multiple`` buckets). Checks: ``fbank_torch`` on the card against
   ``fbank_np`` on the host on a ragged batch, atol 2e-3 (the JAX twins'
   bound), and its device time for a batch of 128 one-second utterances;
   the native Freeverb built by the card machine's ``g++`` against the
   SciPy formulation. Then ``run_exp_torch.main`` trains README.md's SC
   flagship, RadLIF [1024, 1024, 1024, 35] bidirectional, ``--use_augm
   true --pdrop 0.1 --frontend device``, B = 128, 2 epochs: the launch
   counters set to 0 just before and read just after, 3
   ``fused_cell_fwd_train``, 3 ``fused_cell_bwd``, 1 ``readout_fwd`` and
   1 ``readout_bwd`` a step, 3 ``fused_cell_fwd`` and 1 ``readout_fwd`` an
   eval batch, and no other, ``cells.readout_sum`` called 0 times, the
   Freeverb called; ``Predictor.from_experiment`` on the test split's
   waveforms equal bit for bit to the test loader's batch through the
   restored model (its state draws seeded as the Predictor seeds them);
   the step's time on a resident batch; then, V of the trained model put
   back on the 2^-8 grid, one eval forward of a test batch (the serving
   form at (256, 100, 1024)) with the kernels and again with their plain
   versions: every hidden layer's spikes bit for bit, the probabilities
   within 1e-5. One ``--frontend host`` epoch of the same model on the
   same tree, and one epoch of RadLIF [512, 512, 20] on the HD tree
   (``--frontend host``), checked alike; on the HD run's T = 200 batch
   (V on the grid) an eval forward held so against the plain versions,
   and a training step by phase 8's rule (loss within 1e-3, gradients
   within 1e-4 of their largest or by the float64 witness). Prints the
   loader-fed utterances/s of every epoch, its loader wait, losses,
   accuracies and firing rates.
8d. ``streaming``: ``serve/streaming.py`` on the card. RadLIF and GRU
   [512, 512, 35] (``scan``, zero state init, F = 40, B = 128, T = 100):
   T frames through ``streaming_step`` against one ``(B, T, F)`` forward
   of the same model. RadLIF, every weight on a 2^-8 grid, inputs on a
   2^-2 grid and norm gains 4 (so both paths' sums are exact): each hidden
   layer's spikes bit for bit at every step, the readout within 1e-5
   relative to its largest value; the GRU's output within 1e-5 relative.
   Then the waveform form: the GRU in ``FbankFrontend``, one 400-sample
   window a step advanced by 160 samples, against the frontend's batch
   forward on the same audio, within 1e-5 relative (each window's fbank
   within 2e-3 of the batch fbank's frame).
8e. ``migrate``: reference checkpoints on the card. README.md's SC flagship,
   RadLIF [1024, 1024, 1024, 35] bidirectional (F = 40; V on the 2^-8 grid,
   running statistics of one train-mode pass, from a fixed seed), and a
   GRU [512, 512, 35], each written as a reference ``state_dict``
   (``snn.<i>`` / ``ann.<i>`` keys, the ANN gates transposed,
   ``num_batches_tracked``) and imported as a bare state_dict by
   ``sparch_tpu_torch.migrate.import_torch_checkpoint`` (the weights back
   bit for bit). (a) ``Predictor.from_experiment`` serves 300 utterances
   of normal features (3 batches of 128, ``auto``) through
   ``fused_cell_fwd``'s serving form at (256, 100, 1024) and
   ``readout_fwd`` (3 and 1 a batch, and no other), held against the same
   Predictor inside ``plain_versions()``: every hidden layer's spikes bit
   for bit, probabilities within 1e-6; (b) the GRU alike through
   ``fused_ann_fwd_gru`` (2 a batch), labels on >= 99 % and probabilities
   within 1e-3 of the plain versions (the ``serving_ann`` bound); both
   timed (host clock, median of 3). (c) ``run_exp_torch`` on the
   flagship's folder (``--use_pretrained_model``, ``--frontend host``, the
   SC tree of phase 8c, zero state init): an ``--only_do_testing`` run
   whose test labels must be ``from_experiment``'s, then one epoch with
   dropout 0.1, ``--compile_cache build/kernels`` (no library may be
   written) and ``--profile_dir`` (a trace must be written; the port's
   kernels found in it by name are printed, not bounded): 3
   ``fused_cell_fwd_train``, 3 ``fused_cell_bwd``, 1 ``readout_fwd`` and 1
   ``readout_bwd`` a step, 3 ``fused_cell_fwd`` and 1 ``readout_fwd`` an
   eval batch, and no other.
8f. ``fuzz``: ``tools/fuzz_kernels_torch.py`` for up to FUZZ_SECONDS (every
   kernel family; drawn shapes, affine, dropout and stream type; the
   kernel against its plain version at the card tests' standard, the plans
   the launches took); 0 failures.
9. ``kernel_vs_plain`` for the fused non-spiking cell, forward
   (``fused_ann_fwd``): RNN, LiGRU and GRU at (128, 100, 512) with the
   batchnorm affine and at the ragged shape, in the serving form (the
   output alone) and the training form (dropout 0.1, the raw y series and
   the gate series). Nothing here is bit-equal to the plain version (the
   products sum in another order, exp and tanh come from the card's
   library): the output and every residual series within atol 2e-5, or
   else no further from the float64 plain version than 4 times the float32
   plain version is (both printed); the dropped positions identical, the
   dropped share within 0.1 +- 0.005, two launches bit-equal. At the main
   shape the line gives the launch plan (``plan``: blocks a cluster, rows a
   cluster, the column slice resident in shared memory or streamed, and how
   many clusters the card holds at once).
10. ``kernel_vs_plain`` for its backward (``fused_ann_bwd``): both sides get
   the plain forward's residuals; every gradient (per gate dWx, dscale,
   dshift, dV; dy0) as in phase 6; two launches bit-equal. At the main
   shape: the plan, ``split_ms``, the time loop, the dV product and the
   second passes (the sums over partials), CUDA events around each launch
   in a timing pass of its own, and ``dv_library_ms`` (``torch.matmul`` of
   the dV products' float32 operands, the gates side by side, TF32 off: a
   yardstick).
11. ``serving_ann``: a GRU [512, 512, 35] Predictor (F=40 features drawn
   normal(0, 1), batch 128, seeded random weights, running statistics from
   one train-mode pass) on 300 utterances, variants ``scan`` and ``auto``:
   labels equal on >= 99 %, probabilities within 1e-3 of scan, two forward
   launches per batch and no other kernel; timed. LiGRU and RNN at the same
   width: checked alike, their forward timed.
12. ``training_ann``: a GRU [512, 512, 35] trainer (batchnorm, dropout 0.1,
   Adam at lr 1e-2) on one device-resident batch of 128, variants ``scan``
   and ``auto``, checked and timed as phase 8 (two forward and two backward
   launches per step). LiGRU and RNN: three steps, checked alike, but
   for the LiGRU's step-1 gradients, which the relu's kink separates (see
   ``KINK_GRAD_REL_MAX``).
13. The bf16-stream mode (``mxu_bf16=True``, ``compute_dtype=bfloat16``):
   ``kernel_vs_plain`` for ``fused_cell_fwd_bf16`` (serving and training
   form, the four cells, affine on and off, a float32 and a bf16 drive) with
   the exact checks: (a) with V on the 2^-8 grid and a float32 drive the
   spikes and the membrane series equal the float32 kernel's, (b) so do LIF's
   and adLIF's, which have no product, (c) with either drive the kernel
   equals its plain version bit for bit, (d) the dropped positions are the
   float32 form's and a kept value is bf16(1/(1-p)), (e) the output types;
   then ``fused_cell_bwd_bf16``, ``fused_ann_fwd_bf16`` and
   ``fused_ann_bwd_bf16`` at (128, 100, 512) and the ragged shape, held by
   the bounds of ``BF16_ULP`` and ``BF16_SUM_REL_MAX`` or else the float64
   witness rule of phases 6 and 9.
14. ``serving_bf16``: RadLIF [512, 512, 35] and GRU [512, 512, 35] with
   ``compute_dtype=bfloat16`` through ``Predictor``, ``auto`` and ``scan``,
   with the metrics of phases 4 and 11. ``auto`` is held against the same
   Predictor with each kernel swapped for its plain version (RadLIF: the
   spikes bit for bit, labels on >= 99 % and probabilities within 1e-5 as
   in phase 4, the readout kernel adding its classes in another order;
   GRU: labels on >= 99 %, probabilities within
   ``BF16_PROB_MAX``, or else by the float64 witness rule of phase 4's
   calibrated model); its distance from the float32 ``auto`` run is
   printed, not bounded (an untrained RadLIF amplifies any rounding).
   LiGRU and RNN: one batch, checked alike.
15. ``training_bf16``: both models through ``create_train_state`` and
   ``make_train_step`` as in phases 8 and 12 (parameters, gradients and
   Adam's moments float32), with the float32 ``auto`` losses side by side;
   LiGRU and RNN for three steps; and ``training_remat``: three steps of the
   RadLIF bf16 ``auto`` trainer with ``remat=True`` against the same without
   it, losses and step-1 gradients bit-equal, peak memory of both.
16. The tensor-parallel path (``cell_impl="pallas_tp"``) in its one-card
   form: all P ranks of a mesh that repeats the card P times run in one
   cooperative launch, exchanging through buffers in the card's memory.
   ``tp_collectives``: the all-gather and reduce-scatter harnesses at
   B=128, Hl=256, 3 rounds, P = 1, 2, 4, bit for bit against their plain
   versions, twice; ``library_ms``: one round of each function as one
   PyTorch call (``torch.cat`` of the P shards; ``torch.sum`` of the P
   partials over ranks) timed from a CUDA graph as ``graph_ms`` times.
17. ``kernel_vs_plain`` for ``tp_cell_fwd``: RLIF and RadLIF at P = 1, 2, 4
   on the main path's shape (B_eff=256, T=100, H=1024) and a small one
   (8, 13, P*128), V on the 2^-8 grid: spikes and membrane series bit for
   bit against ``tp_cell_plain``, against P = 1 and against the
   single-card fused cell without the affine.
18. ``kernel_vs_plain`` for ``tp_cell_bwd``: the same shapes with a
   uniform s0; every gradient against ``tp_cell_bwd_plain`` by the rule of
   phase 6, two launches bit-equal, the gradients that sum over no rows
   bit-equal to P = 1's; the plan of thread-block clusters per rank each P
   ran, and at the main shape ``split_ms`` and ``dv_library_ms``.
19. ``training_tp``: a RadLIF [1024, 1024, 35] bidirectional trainer
   (batchnorm, dropout 0.1, uniform state init, Adam at lr 1e-2) on one
   batch of 128 SC-shaped utterances (F=40 normal features), ``scan``,
   ``auto`` and ``pallas_tp`` at P = 1, 2, 4, checked and timed as phase 8 (two TP
   forward and two TP backward launches per step, no other kernel), P = 2
   and 4 against P = 1; then one ``make_eval_step`` pass per variant over
   the trained weights (V back on the 2^-8 grid, zero state init): the
   probabilities bit for bit against the plain versions' and P = 1's, and
   against scan by the witness rule of phase 4. No multi-card run is made.
20. ``kernel_vs_plain`` for ``tp_ann_fwd``: the TP RNN, LiGRU and GRU at
   P = 1, 2, 4 on the main path's shape (B=128, T=100, H=1024), recurrent
   matrices orthogonal * 0.5: the output and the gate series against
   ``tp_ann_cell_plain`` by the rule of phase 9, the serving form alike;
   bit for bit across P, against the single-card ``fused_ann_fwd`` without
   the affine and the dropout, and between two launches; the plan of
   thread-block clusters each P ran (``fused_tp_ann.last_plan``).
21. ``kernel_vs_plain`` for ``tp_ann_bwd``: the same on the plain forward's
   residuals; every gradient against ``tp_ann_cell_bwd_plain`` by the rule
   of phase 6, bit for bit across P, against the single-card
   ``fused_ann_bwd`` and between two launches; the plan, ``split_ms``
   (the time loop, the dV product, its second pass) and ``dv_library_ms``.
22. ``training_tp_ann``: a GRU [1024, 1024, 35] trainer (batchnorm, dropout
   0.1, Adam at lr 1e-2) on one batch of 128 SC-shaped utterances, ``scan``,
   ``auto`` and ``pallas_tp`` at P = 1, 2, 4, checked and timed as phase 8
   (two TP forward and two TP backward launches per step, no other
   kernel), P = 2 and 4 against P = 1; then one ``make_eval_step`` pass per
   variant over the trained weights: the probabilities of every P bit for
   bit against P = 1's, and against the plain versions' and scan's by the
   witness rule of phase 4. LiGRU and RNN at the same width: ``auto`` and
   ``pallas_tp`` at P = 2 for three steps at lr 1e-3 (at 1e-2 the LiGRU
   diverges on every path), checked alike.
23. The TP path's bf16-stream form (``compute_dtype=bfloat16``): phases
   17-22 again with ``mxu_bf16`` (``tp_forward_bf16``,
   ``tp_backward_bf16``, ``training_tp_bf16``, ``tp_ann_forward_bf16``,
   ``tp_ann_backward_bf16``, ``training_tp_ann_bf16``). The spiking forward
   takes a uniform s0 (the first product rounds it) and is still bit for
   bit against its plain version, P = 1 and the single-card bf16 kernel;
   the backward and the ANN kernels are held by ``bf16_grad_bounds`` and
   BF16_ULP or else the float64 witness rule, bit for bit across P and
   between launches, the ANN kernels and the spiking backward's gradients
   that sum over no rows bit for bit against the single-card bf16 kernels.
   The trainers run beside a bf16 ``scan`` twin (5 steps) and the bf16
   ``auto`` twin, print ``vs_float32_tp`` (the float32 P = 1 trainer's
   losses and step-1 gradient distance, not bounded), and the GRU's eval
   is held against its plain versions as ``serving_bf16`` holds the served
   bf16 GRU.
24. ``kernels``: each kernel with its launches on its main path (spiking
   serving: the "calibrated" model's ``pallas`` run; spiking training: the
   ``pallas`` trainer's 10 steps; non-spiking: the ``auto`` Predictor's and
   the ``auto`` trainer's runs of its model; the bf16 forms: the bf16
   ``auto`` runs; the TP collectives: phase 16's calls; the TP cells: the
   P = 4 trainer's 10 steps; the TP ANN cells: the P = 4 GRU trainer's 10
   steps, and by mode the P = 2 runs; their bf16 forms alike, from the
   bf16 trainers), its error, its time beside
   its plain version's, and its bound: the larger of its bytes over the
   card's memory rate and its operations over the card's float32 rate, from
   this run's shapes and firing rates. The fused ANN kernels add their plan,
   the backward its split, and ``at_h1024``: the kernel at (128, 100, 1024)
   without the affine, as phases 20-21 time it, beside its bound and plan.
   The TP ANN kernels add the plan each P ran and ``exchange_us`` per P >
   1 (the kernel at P less at P = 1, over the exchanges on a cluster's
   chain), the backward its split per P. Every backward adds the dV
   product's yardstick (``dv_library_ms``), and the spiking ones their
   plan (per P) and split. No library call computes any of the cell
   functions whole (cuDNN's GRU applies the reset gate after the recurrent
   product, this one before it; no PyTorch call exchanges inside a
   recurrence), so their ``library_ms`` is null; the dV product that each
   backward runs after its time loop is one ``torch.matmul``, timed as
   ``dv_library_ms``. The TP collectives' ``library_ms`` is one round of
   their function in one call (phase 16). Rows 1-5 add
   ``launches_experiment``, their launches in the fresh run of phase 8b,
   ``launches_audio``, their launches in the SC flagship's run of phase
   8c, and, with the GRU's forward, ``launches_migrate``: the served
   models and the fine-tune of phase 8e.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
if any phase fails, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
B, T, F, H, C = 128, 100, 700, 512, 35
N_UTT = 300
MISMATCH_MAX = 1e-3
P_DROP = 0.1
LR = 1e-2
GRAD_REL_MAX = 1e-4  # kernel vs plain, relative to the gradient's largest
WITNESS_GRAD_FACTOR = 4.0  # else: kernel error <= 4x the f32 plain's, vs f64
# A whole LiGRU training step, kernels vs plain versions: the backward masks
# on the forward's saved c > 0, and the two forwards differ by ~1e-6 in the
# candidate's pre-activation, so of the 6.5 M candidates of a layer a handful
# fall on the other side of the relu's kink and each moves the gradients by
# a whole term (measured: 2.5e-3 of the largest magnitude). On shared
# residuals (phase 10) the LiGRU is held to GRAD_REL_MAX like the others.
KINK_GRAD_REL_MAX = 2e-2
TRAIN_STEPS = 10
# published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12  # dense bf16 products with a float32 sum
F_ANN = 40  # filterbank features of the non-spiking models' input
ANN_ATOL = 2e-5  # fused ANN forward, kernel vs plain
WITNESS_FWD_FACTOR = 4.0  # else: kernel error <= 4x the f32 plain's, vs f64
ANN_TYPES = {"rnn": "RNN", "ligru": "LiGRU", "gru": "GRU"}
ANN_GATES = {"rnn": ("",), "ligru": ("", "z"), "gru": ("", "z", "r")}
# The bf16-stream mode, kernel vs plain version. Both round the same values
# at the same places, but sum in float32 in another order, and a sum that
# differs in its last bit can tip a rounding to bf16 (one ulp, 2^-8
# relative) of an output or of the next product's operand; a tipped operand
# moves the next step's sums by about |V| * ulp, which tips more. Two right
# implementations therefore land on neighbouring bf16 values now and then.
# A bf16 stream is held to one bf16 ulp at the top of its range, 2^-7:
# relative to max(1, |value|) for the forward's series, to the gradient's
# largest magnitude for a dWx stream. A gradient reduced in float32 over
# B*T terms averages the tipped terms out and is held to 1e-3 of its largest
# magnitude. Past its bound a value is held by the float64 witness rule.
BF16_ULP = 2.0 ** -7
BF16_SUM_REL_MAX = 1e-3
# served probabilities, bf16 GRU kernels vs their plain versions: the
# outputs differ by an ulp (<= 2^-7) on few elements, the readout averages
# 100 steps and 512 units
BF16_PROB_MAX = 1e-2
BF16 = torch.bfloat16
# A plain version takes 10-130 ms a call and its time is only a yardstick:
# it is timed over few calls
PLAIN_ROUNDS = dict(warmup=1, iters=2, repeats=3)
GRAD_NAMES = ("dWx", "dscale", "dshift", "dV", "dalpha", "dbeta", "da", "db",
              "du0", "dw0", "ds0")
# how far the kernel paths' agreement with scan may fall short of the scan
# path's own card-vs-CPU agreement (see phase_serving); 300 utterances at
# ~10 % disagreement carry a binomial spread of ~1.8 points
WITNESS_LABEL_MARGIN = 0.08
WITNESS_PROB_FACTOR = 3.0
FORMS = {  # name: (recurrent, adaptive)
    "lif": (False, False),
    "adlif": (False, True),
    "rlif": (True, False),
    "radlif": (True, True),
}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cell_inputs(shape, dyadic: bool, seed: int, dev):
    """Inputs of one fused-cell call, with the neuron constants inside
    their clamp ranges and V zero-diagonal, so the wrapper's clamp and mask
    change nothing and the plain version can take the same tensors."""
    from sparch_tpu_torch.ops import cells

    b, t, h = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def uni(size, lo, hi):
        return torch.rand(size, generator=g, device=dev) * (hi - lo) + lo

    V = torch.empty(h, h)
    torch.nn.init.orthogonal_(V, generator=torch.Generator().manual_seed(seed))
    V = V.to(dev)
    if dyadic:
        V = torch.round(V * 256.0) / 256.0
    V = cells.zero_diag(V)
    return dict(
        Wx=torch.randn(shape, generator=g, device=dev),
        scale=uni(h, 1.0, 2.0), shift=uni(h, 0.0, 1.0),
        alpha=uni(h, *cells.ALPHA_LIM), beta=uni(h, *cells.BETA_LIM),
        a=uni(h, *cells.A_LIM), b=uni(h, *cells.B_LIM), V=V,
        u0=uni((b, h), 0.0, 1.0), w0=uni((b, h), 0.0, 1.0),
        s0=(uni((b, h), 0.0, 1.0) > 0.8).float(),
    )


def fused_call(name, d, affine):
    """The wrapper a layer calls: on a CUDA tensor, the kernel."""
    from sparch_tpu_torch.ops import fused_cells

    kw = dict(scale=d["scale"], shift=d["shift"]) if affine else {}
    if name == "lif":
        return fused_cells.lif_fused(d["Wx"], d["alpha"], 1.0, d["u0"],
                                     d["s0"], **kw)
    if name == "adlif":
        return fused_cells.adlif_fused(d["Wx"], d["alpha"], d["beta"],
                                       d["a"], d["b"], 1.0, d["u0"],
                                       d["w0"], d["s0"], **kw)
    if name == "rlif":
        return fused_cells.rlif_fused(d["Wx"], d["alpha"], d["V"], 1.0,
                                      d["u0"], d["s0"], **kw)
    return fused_cells.radlif_fused(d["Wx"], d["alpha"], d["beta"], d["a"],
                                    d["b"], d["V"], 1.0, d["u0"], d["w0"],
                                    d["s0"], **kw)


def _prepared(name, d, affine):
    rec, ada = FORMS[name]
    return dict(
        args=(d["Wx"], d["scale"] if affine else None,
              d["shift"] if affine else None, d["alpha"], d["beta"], d["a"],
              d["b"], d["V"], 1.0, d["u0"], d["w0"], d["s0"]),
        kw=dict(recurrent=rec, adaptive=ada),
    )


def plain_call(name, d, affine):
    """The plain PyTorch version on the same (already clamped) inputs."""
    from sparch_tpu_torch.ops import fused_cells

    p = _prepared(name, d, affine)
    return fused_cells.fused_cell_plain(*p["args"], **p["kw"])


def kernel_call(name, d, affine, **kw):
    """The kernel alone, without the wrapper's clamp and mask (``kw``: the
    wrapper's own keywords, as ``split_ms``)."""
    from sparch_tpu_torch.ops import fused_cells

    p = _prepared(name, d, affine)
    return fused_cells._fused_cell_cuda(*p["args"], **p["kw"], **kw)


def fwd_plan_split(run):
    """The plan of a recurrent spiking forward's launch and its
    ``split_ms`` (first product, time loop) over calls of ``run(split)``,
    which passes ``split_ms=split`` on to the wrapper."""
    from sparch_tpu_torch.ops import fused_cells

    split = split_ms_of(run, names=FWD_SPLIT_NAMES)
    return dict(plan=fused_cells.last_plans()["fused_cell_fwd"],
                split_ms=split)


def phase_device():
    from sparch_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_summary(log) for name, log in logs.items()}
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         kernel_build_s=build_s, built=sorted(logs), ptxas=ptxas)
    return smi


def ptxas_summary(log: str):
    """Registers and spills of one source's entry functions, all together
    and, for the kernels that have the two stream modes (their last template
    argument), by mode: the float32 forms must not pay for the bf16 ones."""
    entries = re.findall(
        r"Compiling entry function '(\S+)' for[^\n]*\n(?:[^\n]*\n)*?"
        r"[^\n]*?(\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers",
        log)

    def summary(rows):
        return dict(entries=len(rows), max_registers=max(r for r, _ in rows),
                    entries_that_spill=sum(1 for _, sp in rows if sp),
                    max_spill_store_bytes=max(sp for _, sp in rows))

    rows = [(int(regs), int(spill)) for _, spill, regs in entries]
    out = summary(rows)
    # the column-slice kernels of the spiking forwards (spike_slices.cuh)
    slices = [(int(regs), int(spill)) for name, spill, regs in entries
              if "6slices" in name]
    if slices:
        out["slice_layout"] = summary(slices)
    for flag, mode in (("0", "float32"), ("1", "bf16")):
        of_mode = [(int(regs), int(spill)) for name, spill, regs in entries
                   if re.search(rf"Lb{flag}EEEvNS_\d*ArgsE$", name)]
        if of_mode:
            out[mode] = summary(of_mode)
    return out


def orthogonal_check(name, shape, dev):
    """Kernel vs plain with an orthogonal V, where s@V rounds by summation
    order. An untrained adaptive neuron with a < 0 amplifies any rounding
    difference step by step (its (u, w) loop has a per-step gain above 1),
    so two correct implementations diverge too. The bound is therefore
    MISMATCH_MAX plus twice the divergence between the plain version on
    the card and on the host CPU (cuBLAS and the CPU library sum in other
    orders): a kernel that got s@V wrong diverges from step 1 in every
    row, far above it."""
    o = cell_inputs(shape, dyadic=False, seed=2, dev=dev)
    with torch.no_grad():
        got = fused_call(name, o, True)
        want = plain_call(name, o, True)
        host = plain_call(name, {k: v.cpu() for k, v in o.items()}, True)
    mism = float((got != want).float().mean())
    intrinsic = float((want.cpu() != host).float().mean())
    bound = MISMATCH_MAX + 2.0 * intrinsic
    check(mism <= bound, f"{name} {shape}: orthogonal-V mismatch {mism} "
                         f"> bound {bound}")
    return dict(orthogonal_mismatch_fraction=mism,
                orthogonal_plain_card_vs_cpu_mismatch=intrinsic,
                orthogonal_mismatch_bound=bound)


def phase_fused_cell(dev):
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    main = None
    for shape in ((B, T, H), (5, 13, 40)):
        for name in FORMS:
            rec = FORMS[name][0]
            row = {"cell": name, "shape": list(shape), "affine": True}
            d = cell_inputs(shape, dyadic=True, seed=1, dev=dev)
            with torch.no_grad():
                got = fused_call(name, d, True)
                want = plain_call(name, d, True)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            row.update(dyadic_max_abs_err=err,
                       firing_rate=float(want.mean()))
            check(torch.equal(got, want),
                  f"{name} {shape}: spikes differ with dyadic V")
            if rec:
                row.update(orthogonal_check(name, shape, dev))
            if shape == (B, T, H):
                with torch.no_grad():
                    row["ms"] = cuda_time_ms(kernel_call, name, d, True)
                    row["plain_ms"] = cuda_time_ms(plain_call, name, d, True,
                                                   **PLAIN_ROUNDS)
                    if rec:
                        row.update(fwd_plan_split(
                            lambda sp: kernel_call(name, d, True, split_ms=sp)))
                if name == "radlif":
                    main = dict(max_abs_err=err, ms=row["ms"],
                                plain_ms=row["plain_ms"],
                                firing_rate=row["firing_rate"],
                                plan=row["plan"], split_ms=row["split_ms"])
            emit("kernel_vs_plain", kernel="fused_cell_fwd", **row)
    return main


def graph_ms(fn, *args, iters=20, repeats=5):
    """Median ms per call of ``fn(*args)`` replayed from a CUDA graph of
    ``iters`` calls: the device time of a kernel that runs shorter than
    its launch costs the host (``cuda_time_ms`` of such a call times the
    host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ops(fn, *args):
    """Kernels that one call of ``fn(*args)`` launches on the card: the
    kernel nodes of a CUDA graph that captures the call (the profiler's
    trace of a few short kernels can drop some)."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn(*args)
    # torch's CUDA runtime, loaded with torch
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(rt.cudaGraphGetNodes(raw, None, ctypes.byref(n)) == 0,
          "cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0,
          "cudaGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0,
              "cudaGraphNodeGetType failed")
        kernels += kind.value == 0  # cudaGraphNodeTypeKernel
    graph.reset()
    return kernels


def readout_inputs(dev):
    from sparch_tpu_torch.ops import cells

    g = torch.Generator(device=dev).manual_seed(3)
    Wx = 3.0 * torch.randn((B, T, C), generator=g, device=dev)
    lo, hi = cells.ALPHA_LIM
    alpha = torch.rand(C, generator=g, device=dev) * (hi - lo) + lo
    u0 = torch.rand((B, C), generator=g, device=dev)
    gout = torch.randn((B, C), generator=g, device=dev)
    return Wx, alpha, u0, gout


def readout_routes(Wx, alpha, u0, gout, backward: bool):
    """The readout as ``cell_impl='auto'`` ran it before it took the
    kernels (``cells.readout_sum``, a chain of small ops) and as it runs
    now (``fused_cells.readout_fused``), each a forward (``backward``: a
    forward and a backward) on the card: eager ms a call (CUDA events) and
    kernels a call (``device_ops``)."""
    from sparch_tpu_torch.ops import cells, fused_cells
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    out = {}
    for name, fn in (("readout_sum", cells.readout_sum),
                     ("readout_fused", fused_cells.readout_fused)):
        if backward:
            w, a = Wx.clone().requires_grad_(), alpha.clone().requires_grad_()

            def call(fn=fn, w=w, a=a):
                fn(w, a, u0).backward(gout)
        else:
            def call(fn=fn):
                with torch.no_grad():
                    fn(Wx, alpha, u0)
        out[name] = dict(ms=cuda_time_ms(call, iters=20),
                         kernels=device_ops(call))
    return out


def phase_readout(dev):
    """The readout forward against its plain version at (128, 100, 35)
    (rtol 1e-5; the membrane series bit for bit; two launches bit-equal);
    ``ms`` the kernel's device time (``graph_ms``), ``eager_ms`` a call of
    the wrapper timed as the other kernels are; its plan; and
    ``auto_route_ms``: ``cells.readout_sum``'s forward, the route the
    kernel replaces under ``cell_impl='auto'``, beside the fused
    readout's, each eager with its kernels a call."""
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    Wx, alpha, u0, gout = readout_inputs(dev)
    got = fused_cells.readout_fused(Wx, alpha, u0)
    want = fused_cells.readout_plain(Wx, alpha, u0)
    out, u_seq = fused_cells._readout_cuda(Wx, alpha, u0, save_residuals=True)
    again = fused_cells._readout_cuda(Wx, alpha, u0, save_residuals=True)
    want_u = fused_cells.readout_plain(Wx, alpha, u0, save_residuals=True)[1]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
          f"readout: max abs err {err}, max rel err {rel}")
    check(torch.equal(u_seq, want_u), "readout: membrane series differs")
    check(torch.equal(out, again[0]) and torch.equal(u_seq, again[1]),
          "readout: two launches differ")
    ms = graph_ms(fused_cells._readout_cuda, Wx, alpha, u0)
    eager_ms = cuda_time_ms(fused_cells._readout_cuda, Wx, alpha, u0)
    plain_ms = cuda_time_ms(fused_cells.readout_plain, Wx, alpha, u0)
    plan = fused_cells._card_readout_plan(B, T, C, dev, False)._asdict()
    routes = readout_routes(Wx, alpha, u0, gout, backward=False)
    emit("kernel_vs_plain", kernel="readout_fwd", shape=[B, T, C],
         max_abs_err=err, max_rel_err=rel, ms=ms, eager_ms=eager_ms,
         train_form_ms=graph_ms(fused_cells._readout_cuda, Wx, alpha, u0,
                                True),
         plain_ms=plain_ms, plan=plan, auto_route_ms=routes)
    return dict(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                plan=plan, auto_route_ms=routes)


def serving_state(dev, zero_means: bool):
    """State dict of a RadLIF [512, 512, 35] with seeded random weights,
    V rounded onto a 2^-8 grid (s@V is then exact in any summation order),
    and running statistics from one train-mode pass over a calibration
    batch.

    ``zero_means`` also sets the running means to 0: BatchNorm folded into
    scale*x + shift then rounds exactly as BatchNorm applied, so the kernel
    paths compute the scan path's function to the last bit, up to the
    readout's exp and class sum."""
    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.models.common import BN_MOMENTUM

    model = build_model(
        "RadLIF", (B, T, F), [H, H, C], state_init="zeros",
        cell_impl="scan", generator=torch.Generator().manual_seed(0),
    ).to(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    calib = (torch.rand((B, T, F), generator=g, device=dev) < 0.02).float()
    with torch.no_grad():
        for layer in model.hidden_layers():
            layer.V.copy_(torch.round(layer.V * 256.0) / 256.0)
        model.train()
        model(calib)
        # one pass moves the running average 5 % of the way from its
        # init (mean 0, var 1) to the batch statistics: undo that, so the
        # running statistics ARE the batch's
        w = 1.0 - BN_MOMENTUM
        for layer in model.hidden_layers() + [model.readout]:
            n = layer.norm
            n.running_mean.copy_(0.0 if zero_means else n.running_mean / w)
            n.running_var.copy_((n.running_var - BN_MOMENTUM) / w)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@torch.no_grad()
def plain_fused_forward(model, x):
    """The kernel path's function on the card with each kernel replaced by
    its plain version: the same projections and clamps, BatchNorm folded
    as JAX ``_BNAffine`` folds it (scale = gamma*rsqrt(var + eps),
    shift = beta - mean*scale, from the running statistics), zero initial
    state. With V on a dyadic grid the kernels must reproduce its spikes
    bit for bit. Returns (probs, firing_rates)."""
    from sparch_tpu_torch.models.common import NORM_EPS
    from sparch_tpu_torch.ops import cells, fused_cells

    rates = []
    for layer in model.hidden_layers():
        Wx = layer.W(x)
        n = layer.norm
        scale = n.weight * torch.rsqrt(n.running_var + NORM_EPS)
        shift = n.bias - n.running_mean * scale
        alpha, beta, a, b, V = fused_cells.clip_and_mask(
            layer.alpha, layer.beta, layer.a, layer.b, layer.V)
        z = torch.zeros(Wx.shape[0], Wx.shape[2], device=Wx.device)
        x = fused_cells.fused_cell_plain(
            Wx, scale, shift, alpha, beta, a, b, V, layer.threshold, z, z, z,
            recurrent=True, adaptive=True)
        rates.append(x.mean(dim=(0, 1)))
    ro = model.readout
    Wx = ro.norm(ro.W(x))
    z = torch.zeros(Wx.shape[0], Wx.shape[2], device=Wx.device)
    if model.cell_impl in ("pallas", "auto"):
        alpha = fused_cells.clip_and_mask(ro.alpha)[0]
        out = fused_cells.readout_plain(Wx, alpha, z)
    else:
        out = cells.readout_sum(Wx, ro.alpha, z)
    return out / out.sum(dim=-1, keepdim=True), torch.cat(rates)


def reference_check(impl, pred, x, probs):
    """Hold a kernel variant's served probabilities against
    ``plain_fused_forward`` on the same padded batches: firing rates equal
    (the spike trains are the same), labels equal on >= 99 %, probs within
    1e-5 (the readout kernel agrees with its plain version to rtol 1e-5)."""
    ref, rates_equal = [], True
    for i in range(0, len(x), B):
        chunk = x[i:i + B]
        pad = B - len(chunk)
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        xb = torch.from_numpy(chunk).to(pred.device)
        p, rates = plain_fused_forward(pred.model, xb)
        with torch.no_grad():
            _, got_rates = pred.model(xb)
        rates_equal &= bool(torch.equal(got_rates, rates))
        ref.append(p.cpu().numpy()[:B - pad])
    ref = np.concatenate(ref)
    agree = _agreement((probs.argmax(-1), probs), (ref.argmax(-1), ref))
    check(rates_equal, f"{impl}: spikes differ from plain_fused_forward")
    check(agree["label_agreement"] >= 0.99 and
          agree["max_abs_prob_diff"] <= 1e-5,
          f"{impl}: vs plain_fused_forward {agree}")
    return dict(vs_plain_fused=dict(firing_rates_equal=rates_equal,
                                    **agree))


def _agreement(a, b):
    return dict(label_agreement=float((a[0] == b[0]).mean()),
                max_abs_prob_diff=float(np.abs(a[1] - b[1]).max()))


def serve_variants(dev, state, x, timed: bool):
    """Serve ``x`` with cell_impl scan, auto and pallas; launch counters
    are set to 0 just before each variant's first call and read just
    after it. The kernel variants are held against
    ``plain_fused_forward``."""
    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.serve import Predictor
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    out, rows = {}, {}
    for impl in ("scan", "auto", "pallas"):
        model = build_model("RadLIF", (B, T, F), [H, H, C],
                            state_init="zeros", cell_impl=impl)
        pred = Predictor(model, state, batch_size=B, device=dev)
        fused_cells.reset_launch_counts()
        labels, probs = pred(x)
        counts = fused_cells.launch_counts()
        check(probs.shape == (len(x), C) and bool(np.isfinite(probs).all()),
              f"{impl}: probs not finite or of the wrong shape")
        check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)),
              f"{impl}: probs do not sum to 1")
        want = {"scan": (0, 0), "auto": (1, 1), "pallas": (1, 1)}[impl]
        got = (counts["fused_cell_fwd"] > 0, counts["readout_fwd"] > 0)
        others = sum(n for k, n in counts.items()
                     if k not in ("fused_cell_fwd", "readout_fwd"))
        check(got == tuple(map(bool, want)) and others == 0,
              f"{impl}: kernel launches {counts}")
        out[impl] = (labels, probs)
        row = dict(launches=counts)
        if impl != "scan":
            row.update(reference_check(impl, pred, x, probs))
            row["vs_scan"] = _agreement(out[impl], out["scan"])
        if timed:
            n_batches = -(-len(x) // B)
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                pred(x)
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            xb = torch.from_numpy(x[:B]).to(dev)
            with torch.no_grad():
                _, rates = pred.model(xb)
                fwd_ms = cuda_time_ms(pred.model, xb, warmup=2, iters=5,
                                      repeats=3)
            row.update(
                predict_ms_per_batch=1e3 * wall / n_batches,
                utterances_per_s=len(x) / wall, forward_ms=fwd_ms,
                firing_rate_layer0=float(rates[:H].mean()),
                firing_rate_layer1=float(rates[H:].mean()),
            )
        rows[impl] = row
    return out, rows


def phase_serving(dev):
    """The serving main path, on two models, each kernel variant held
    against ``plain_fused_forward`` (spikes bit for bit) and against scan:

    - ``zero_means``: auto and pallas must give the scan path's labels on
      >= 99 % and its probabilities within 1e-3;
    - ``calibrated`` (running means as calibrated, the one timed): an
      untrained RadLIF amplifies rounding (see orthogonal_check), so the
      BatchNorm fold alone moves its outputs away from scan's. The witness
      is the scan path on the host CPU, which differs from the card's only
      in rounding: the kernel paths must agree with scan on the card on at
      least the witness's label share minus WITNESS_LABEL_MARGIN, with
      probabilities no further than WITNESS_PROB_FACTOR times the
      witness's (and never held tighter than 1e-3). A wrong fold (its mean
      term, say) moves every utterance, far past either bound.
    """
    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.serve import Predictor

    g = torch.Generator(device=dev).manual_seed(12)
    x = (torch.rand((N_UTT, T, F), generator=g, device=dev) < 0.02)
    x = x.float().cpu().numpy()

    out, rows = serve_variants(dev, serving_state(dev, zero_means=True), x,
                               timed=False)
    emit("serving", model="zero_means", **rows)
    for impl in ("auto", "pallas"):
        agree = rows[impl]["vs_scan"]
        check(agree["label_agreement"] >= 0.99,
              f"zero_means {impl}: labels agree on "
              f"{agree['label_agreement']}")
        check(agree["max_abs_prob_diff"] <= 1e-3,
              f"zero_means {impl}: probs differ by "
              f"{agree['max_abs_prob_diff']}")

    state = serving_state(dev, zero_means=False)
    out, rows = serve_variants(dev, state, x, timed=True)
    host = Predictor(
        build_model("RadLIF", (B, T, F), [H, H, C], state_init="zeros",
                    cell_impl="scan"),
        {k: v.cpu() for k, v in state.items()}, batch_size=B, device="cpu",
    )(x)
    witness = _agreement(out["scan"], host)
    label_min = witness["label_agreement"] - WITNESS_LABEL_MARGIN
    prob_max = max(WITNESS_PROB_FACTOR * witness["max_abs_prob_diff"], 1e-3)
    emit("serving", model="calibrated", n_utterances=N_UTT, batch_size=B,
         scan_card_vs_cpu=witness, vs_scan_label_min=label_min,
         vs_scan_prob_max=prob_max, **rows)
    for impl in ("auto", "pallas"):
        agree = rows[impl]["vs_scan"]
        check(agree["label_agreement"] >= label_min,
              f"calibrated {impl}: labels agree with scan on "
              f"{agree['label_agreement']} < {label_min}")
        check(agree["max_abs_prob_diff"] <= prob_max,
              f"calibrated {impl}: probs differ from scan by "
              f"{agree['max_abs_prob_diff']} > {prob_max}")
    return rows["pallas"]["launches"]


def bound(n_bytes: float, n_ops: float, n_ops_bf16: float = 0.0):
    """The least time the card could take: the larger of the bytes over
    its memory rate and the operations over its rate for their type
    (float32 outside the tensor cores; ``n_ops_bf16``: the products of
    bf16 operands with a float32 sum)."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    by_ops = 1e3 * (n_ops / PEAK_F32_S + n_ops_bf16 / PEAK_BF16_S)
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def cell_bounds(rate: float, bf16=False, shape=(B, T, H)):
    """Bounds of the fused-cell kernels at ``shape`` (the serving shape
    unless named), RadLIF with the affine, from the shape and this run's
    firing rate. Each stream is
    counted once: Wx, spikes, the membrane series, g and dWx are B*T*H
    elements, V and dV H*H, the states B*H. The forward's s @ V adds one row
    of V per spike; the backward has two dense products of 2*B*T*H*H. In
    the bf16-stream mode Wx, the spikes, g, dWx and V are two bytes an
    element (the membrane series, dV and the states stay four) and the
    dense products are of bf16 operands."""
    B, T, H = shape
    e = 2.0 if bf16 else 4.0
    stream, mat, state = e * B * T * H, e * H * H, 4.0 * B * H
    u_series, dv = 4.0 * B * T * H, 4.0 * H * H
    elementwise = 16.0 * B * T * H
    gather = rate * B * T * H * H
    products = 4.0 * B * T * H * H
    return dict(
        fwd=bound(2 * stream + mat + 3 * state, elementwise + gather),
        fwd_train=bound(2 * stream + u_series + mat + 3 * state,
                        elementwise + gather + 12.0 * B * T * H),
        bwd=bound(3 * stream + u_series + mat + dv + 6 * state,
                  40.0 * B * T * H + (0.0 if bf16 else products),
                  products if bf16 else 0.0),
        hash=bound(0.0, 2 * 12.0 * B * T * H),
    )


def train_forward_call(name, d, kernel: bool, drop_rate=P_DROP, seed=None,
                       save_residuals=True, bf16=False, **kw):
    """The training form of the forward, the kernel or its plain version,
    on already clamped inputs with the affine (``kw``: the kernel wrapper's
    own keywords, as ``split_ms``)."""
    from sparch_tpu_torch.ops import fused_cells

    p = _prepared(name, d, True)
    fn = fused_cells._fused_cell_cuda if kernel else \
        fused_cells.fused_cell_plain
    return fn(*p["args"], **p["kw"], drop_rate=drop_rate, seed=seed,
              save_residuals=save_residuals, mxu_bf16=bf16, **kw)


def forward_at_1024(dev, bf16=False):
    """``fused_cell_fwd_train`` RadLIF (affine, dropout, u series) at (256,
    100, 1024), the shape the bidirectional RadLIF [1024, 1024, 35] trainer
    gives it through ``cell_impl="auto"``, s0 drawn from U[0, 1) as that
    trainer's state init draws it (bf16: a bf16 drive): the spikes and the
    membrane series bit for bit against the plain version (dyadic V), ms,
    ``split_ms``, the plan and the bound at this run's firing rate."""
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    shape = (2 * B, T, TP_H)
    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
    d = cell_inputs(shape, dyadic=True, seed=1, dev=dev)
    d["s0"] = torch.rand(d["s0"].shape, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    if bf16:
        d["Wx"] = d["Wx"].to(BF16)
    kw = dict(seed=seed, bf16=bf16)
    with torch.no_grad():
        out, u_seq = train_forward_call("radlif", d, True, **kw)
        want, want_u = train_forward_call("radlif", d, False, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, want) and torch.equal(u_seq, want_u),
              f"fused_cell_fwd_train {shape} bf16={bf16}: differs from plain")
        ms = cuda_time_ms(train_forward_call, "radlif", d, True, P_DROP, seed,
                          True, bf16)
        plain_ms = cuda_time_ms(train_forward_call, "radlif", d, False,
                                P_DROP, seed, True, bf16, **PLAIN_ROUNDS)
        row = fwd_plan_split(lambda sp: train_forward_call(
            "radlif", d, True, **kw, split_ms=sp))
    rate = float((u_seq > 1.0).float().mean())  # the raw spikes
    return dict(shape=list(shape), max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                **row, firing_rate=rate,
                **cell_bounds(rate, bf16, shape)["fwd_train"])


def phase_train_forward(dev):
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
    main, hashed = None, None
    for shape in ((B, T, H), (5, 13, 40)):
        for name in FORMS:
            d = cell_inputs(shape, dyadic=True, seed=1, dev=dev)
            with torch.no_grad():
                out, u_seq = train_forward_call(name, d, True, seed=seed)
                want, want_u = train_forward_call(name, d, False, seed=seed)
                raw = kernel_call(name, d, True)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            u_err = float((u_seq - want_u).abs().max())
            dropped = 1.0 - float((out > 0).sum() / raw.sum())
            check(torch.equal(out, want),
                  f"{name} {shape}: dropped spikes differ from plain")
            check(torch.equal(u_seq, want_u),
                  f"{name} {shape}: membrane series differs from plain")
            row = dict(cell=name, shape=list(shape), affine=True,
                       drop_rate=P_DROP, max_abs_err=err,
                       u_series_max_abs_err=u_err, dropped_share=dropped,
                       firing_rate=float(raw.mean()))
            if shape == (B, T, H):
                check(abs(dropped - P_DROP) <= 0.005,
                      f"{name}: dropped share {dropped}")
                with torch.no_grad():
                    row["ms"] = cuda_time_ms(train_forward_call, name, d,
                                             True, P_DROP, seed)
                    row["plain_ms"] = cuda_time_ms(
                        train_forward_call, name, d, False, P_DROP, seed,
                        **PLAIN_ROUNDS)
                    row["ms_without_dropout"] = cuda_time_ms(
                        train_forward_call, name, d, True, 0.0, None)
                if name == "radlif":
                    with torch.no_grad():
                        row.update(fwd_plan_split(
                            lambda sp: train_forward_call(
                                name, d, True, P_DROP, seed, split_ms=sp)))
                        row["at_256x1024"] = forward_at_1024(dev)
                    main = dict(max_abs_err=max(err, u_err), ms=row["ms"],
                                plain_ms=row["plain_ms"], plan=row["plan"],
                                split_ms=row["split_ms"],
                                at_256x1024=row["at_256x1024"])
                    hashed = dict(
                        max_abs_err=err, ms=row["ms"],
                        plain_ms=row["plain_ms"],
                        ms_over_no_dropout=row["ms"]
                        - row["ms_without_dropout"],
                        dropped_share=dropped)
            emit("kernel_vs_plain", kernel="fused_cell_fwd_train", **row)
    emit("kernel_vs_plain", kernel="dropout_hash", shape=[B, T, H],
         measured_in="fused_cell_fwd_train", **hashed)
    return main, hashed


def rel_err(got, want) -> float:
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def grads_within_bound(what, got, want32, want64, names=GRAD_NAMES,
                       rel_max=None):
    """Hold each gradient of ``got`` (the kernel's) against the plain
    version's: within GRAD_REL_MAX of its largest magnitude (``rel_max``
    gives another bound by name), or else, with
    the plain version in float64 as the truth, no further from it than
    WITNESS_GRAD_FACTOR times the float32 plain version is. ``want64``
    is a function that computes the float64 gradients when they are
    needed. Returns the errors by gradient."""
    errs, truth = {}, None
    for name, x, y in zip(names, got, want32):
        check((x is None) == (y is None), f"{what}: {name} missing")
        if x is None:
            continue
        check(bool(torch.isfinite(x).all()), f"{what}: {name} not finite")
        check(x.dtype == y.dtype, f"{what}: {name} is {x.dtype}, the plain "
                                  f"version's {y.dtype}")
        x, y = x.float(), y.float()
        e = dict(vs_plain=rel_err(x, y))
        if e["vs_plain"] > (rel_max or {}).get(name, GRAD_REL_MAX):
            if truth is None:
                truth = dict(zip(names, want64()))
            e["kernel_vs_f64"] = rel_err(x.double(), truth[name])
            e["plain_vs_f64"] = rel_err(y.double(), truth[name])
            check(e["kernel_vs_f64"]
                  <= WITNESS_GRAD_FACTOR * e["plain_vs_f64"],
                  f"{what}: {name} {e}")
        errs[name] = e
    return errs


def bf16_grad_bounds(names):
    """The bf16 mode's bounds by gradient: the dWx streams are bf16, all
    else is reduced in float32."""
    return {n: BF16_ULP if n.startswith("dWx") else BF16_SUM_REL_MAX
            for n in names}


def phase_backward(dev, bf16=False):
    """Phase 6, or with ``bf16`` the bf16-stream form: g and the drive are
    then bf16, and the bounds those of ``bf16_grad_bounds``."""
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
    main = None
    for shape in ((B, T, H), (5, 13, 40)):
        for name in FORMS:
            rec, ada = FORMS[name]
            d = cell_inputs(shape, dyadic=True, seed=1, dev=dev)
            # s0 need not be 0/1: a uniform state init draws it from U[0,1)
            d["s0"] = torch.rand(
                d["s0"].shape, device=dev,
                generator=torch.Generator(device=dev).manual_seed(5))
            gen = torch.Generator(device=dev).manual_seed(6)
            g = torch.randn(shape, generator=gen, device=dev)
            if bf16:
                g, d["Wx"] = g.to(BF16), d["Wx"].to(BF16)
            with torch.no_grad():
                # one set of residuals for both sides: no spike can flip
                # between them
                _, u_seq = train_forward_call(name, d, False, seed=seed,
                                              bf16=bf16)

            def args(f):
                return (f(g), f(d["Wx"]), f(u_seq), f(d["scale"]),
                        f(d["alpha"]), f(d["beta"]), f(d["a"]), f(d["b"]),
                        f(d["V"]), 1.0, f(d["u0"]), f(d["w0"]), f(d["s0"]))

            kw = dict(recurrent=rec, adaptive=ada, drop_rate=P_DROP,
                      seed=seed, mxu_bf16=bf16)
            same = lambda t: t  # noqa: E731
            with torch.no_grad():
                got = fused_cells._fused_cell_bwd_cuda(*args(same), **kw)
                again = fused_cells._fused_cell_bwd_cuda(*args(same), **kw)
                want = fused_cells.fused_cell_bwd_plain(*args(same), **kw)
                torch.cuda.synchronize()
                errs = grads_within_bound(
                    f"{name} {shape}", got, want,
                    lambda: fused_cells.fused_cell_bwd_plain(
                        *args(torch.Tensor.double), **kw),
                    rel_max=bf16_grad_bounds(GRAD_NAMES) if bf16 else None)
            for n, x, z in zip(GRAD_NAMES, got, again):
                check(x is None or torch.equal(x, z),
                      f"{name} {shape}: {n} differs between two launches")
            row = dict(cell=name, shape=list(shape), affine=True,
                       drop_rate=P_DROP, rel_err=errs,
                       two_launches_bit_equal=True,
                       max_abs_err=float(
                           (got[0].float() - want[0].float()).abs().max()))
            if shape == (B, T, H):
                with torch.no_grad():
                    row["ms"] = cuda_time_ms(
                        lambda: fused_cells._fused_cell_bwd_cuda(
                            *args(same), **kw))
                    row["plain_ms"] = cuda_time_ms(
                        lambda: fused_cells.fused_cell_bwd_plain(
                            *args(same), **kw), **PLAIN_ROUNDS)
                if rec:
                    row["plan"] = fused_cells.last_plans()["fused_cell_bwd"]
                if name == "radlif":
                    with torch.no_grad():
                        row["split_ms"] = split_ms_of(
                            lambda split: fused_cells._fused_cell_bwd_cuda(
                                *args(same), **kw, split_ms=split))
                    main = dict(max_abs_err=row["max_abs_err"], ms=row["ms"],
                                plain_ms=row["plain_ms"], plan=row["plan"],
                                split_ms=row["split_ms"],
                                dv_library_ms=dv_library_ms(B, T, H, dev),
                                at_256x1024=backward_at_1024(dev, bf16))
            emit("kernel_vs_plain",
                 kernel="fused_cell_bwd_bf16" if bf16 else "fused_cell_bwd",
                 **row)
    return main


def backward_at_1024(dev, bf16=False):
    """``fused_cell_bwd`` RadLIF (affine, dropout) at (256, 100, 1024), the
    shape the bidirectional RadLIF [1024, 1024, 35] trainer gives it through
    ``cell_impl="auto"``: ms, ``split_ms``, the dV yardstick and the plan;
    every gradient against the plain version by the rule of phase 6."""
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    shape = (2 * B, T, TP_H)
    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
    d = cell_inputs(shape, dyadic=True, seed=1, dev=dev)
    g = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev)
    if bf16:
        g, d["Wx"] = g.to(BF16), d["Wx"].to(BF16)
    kw = dict(recurrent=True, adaptive=True, drop_rate=P_DROP, seed=seed,
              mxu_bf16=bf16)
    with torch.no_grad():
        _, u_seq = train_forward_call("radlif", d, True, seed=seed,
                                      bf16=bf16)
        args = (g, d["Wx"], u_seq, d["scale"], d["alpha"], d["beta"], d["a"],
                d["b"], d["V"], 1.0, d["u0"], d["w0"], d["s0"])
        got = fused_cells._fused_cell_bwd_cuda(*args, **kw)
        plan = fused_cells.last_plans()["fused_cell_bwd"]
        want = fused_cells.fused_cell_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        errs = grads_within_bound(
            f"radlif {shape}", got, want,
            lambda: fused_cells.fused_cell_bwd_plain(
                *[a.double() if torch.is_tensor(a) else a for a in args],
                **kw),
            rel_max=bf16_grad_bounds(GRAD_NAMES) if bf16 else None)
        ms = cuda_time_ms(lambda: fused_cells._fused_cell_bwd_cuda(*args,
                                                                   **kw))
        split = split_ms_of(lambda sp: fused_cells._fused_cell_bwd_cuda(
            *args, **kw, split_ms=sp))
    return dict(shape=list(shape), ms=ms, split_ms=split,
                dv_library_ms=dv_library_ms(*shape, dev), plan=plan,
                rel_err=errs)


def phase_readout_backward(dev):
    """The readout backward against its plain version on the kernel's
    residuals (every gradient within GRAD_REL_MAX; two launches
    bit-equal; one kernel a call), timed as ``phase_readout``, with its
    plan and ``auto_route_ms`` of a forward and a backward."""
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    Wx, alpha, u0, gout = readout_inputs(dev)
    out, u_seq = fused_cells._readout_cuda(Wx, alpha, u0, save_residuals=True)
    want_out, want_u = fused_cells.readout_plain(Wx, alpha, u0,
                                                 save_residuals=True)
    check(torch.equal(u_seq, want_u), "readout: membrane series differs")
    check(torch.allclose(out, want_out, rtol=1e-5, atol=1e-6),
          "readout: output with residuals differs")
    got = fused_cells._readout_bwd_cuda(gout, u_seq, alpha, u0)
    again = fused_cells._readout_bwd_cuda(gout, u_seq, alpha, u0)
    want = fused_cells.readout_bwd_plain(gout, u_seq, alpha, u0)
    torch.cuda.synchronize()
    errs = {}
    for n, x, y, z in zip(("dWx", "dalpha", "du0"), got, want, again):
        errs[n] = rel_err(x, y)
        check(errs[n] <= GRAD_REL_MAX, f"readout backward: {n} {errs[n]}")
        check(torch.equal(x, z),
              f"readout backward: {n} differs between two launches")
    kernels = device_ops(fused_cells._readout_bwd_cuda, gout, u_seq, alpha,
                         u0)
    check(kernels == 1, f"readout backward: {kernels} kernels a call")
    err = float((got[0] - want[0]).abs().max())
    ms = graph_ms(fused_cells._readout_bwd_cuda, gout, u_seq, alpha, u0)
    eager_ms = cuda_time_ms(fused_cells._readout_bwd_cuda, gout, u_seq,
                            alpha, u0)
    plain_ms = cuda_time_ms(fused_cells.readout_bwd_plain, gout, u_seq,
                            alpha, u0, **PLAIN_ROUNDS)
    plan = fused_cells._card_readout_plan(B, T, C, dev, True)._asdict()
    routes = readout_routes(Wx, alpha, u0, gout, backward=True)
    emit("kernel_vs_plain", kernel="readout_bwd", shape=[B, T, C],
         rel_err=errs, two_launches_bit_equal=True, kernels_a_call=kernels,
         max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
         plan=plan, auto_route_ms=routes)
    return dict(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                plan=plan, auto_route_ms=routes)


WIDE_READOUT_SHAPES = ((128, 100, 300), (8, 1100, 1500))


def phase_readout_wide(dev):
    """The readout pair past 256 classes (see the module docstring, 7b)."""
    from sparch_tpu_torch.ops import cells, fused_cells

    out = {}
    for b, t, c in WIDE_READOUT_SHAPES:
        what = f"readout ({b}, {t}, {c})"
        g = torch.Generator(device=dev).manual_seed(5)
        Wx = 3.0 * torch.randn((b, t, c), generator=g, device=dev)
        lo, hi = cells.ALPHA_LIM
        alpha = torch.rand(c, generator=g, device=dev) * (hi - lo) + lo
        u0 = torch.rand((b, c), generator=g, device=dev)
        gout = torch.randn((b, c), generator=g, device=dev)
        fused_cells.reset_launch_counts()
        w = Wx.clone().requires_grad_()
        fused_cells.readout_fused(w, alpha, u0).backward(gout)
        torch.cuda.synchronize()
        counts = fused_cells.launch_counts()
        check(counts["readout_fwd"] == 1 and counts["readout_bwd"] == 1,
              f"{what}: readout_fused launched {counts}")
        got, u_seq = fused_cells._readout_cuda(Wx, alpha, u0,
                                               save_residuals=True)
        again = fused_cells._readout_cuda(Wx, alpha, u0, save_residuals=True)
        want, want_u = fused_cells.readout_plain(Wx, alpha, u0,
                                                 save_residuals=True)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f"{what}: max abs err {err}")
        check(torch.equal(u_seq, want_u), f"{what}: membrane series differs")
        check(torch.equal(got, again[0]) and torch.equal(u_seq, again[1]),
              f"{what}: two launches differ")
        check(torch.equal(got, fused_cells._readout_cuda(Wx, alpha, u0)),
              f"{what}: the serving form differs")
        grads = fused_cells._readout_bwd_cuda(gout, u_seq, alpha, u0)
        grads2 = fused_cells._readout_bwd_cuda(gout, u_seq, alpha, u0)
        want_g = fused_cells.readout_bwd_plain(gout, u_seq, alpha, u0)
        torch.cuda.synchronize()
        errs = {}
        for n, x, y, z in zip(("dWx", "dalpha", "du0"), grads, want_g,
                              grads2):
            errs[n] = rel_err(x, y)
            check(errs[n] <= GRAD_REL_MAX, f"{what} backward: {n} {errs[n]}")
            check(torch.equal(x, z), f"{what} backward: {n} differs between "
                  "two launches")
        out[f"{b}x{t}x{c}"] = dict(
            max_abs_err=err, bwd_rel_err=errs,
            plan=fused_cells._card_readout_plan(b, t, c, dev, False)._asdict(),
            ms=graph_ms(fused_cells._readout_cuda, Wx, alpha, u0),
            bwd_ms=graph_ms(fused_cells._readout_bwd_cuda, gout, u_seq, alpha,
                            u0))
    emit("readout_wide", rtol=1e-5, grad_rel_max=GRAD_REL_MAX, **out)
    return out


@contextlib.contextmanager
def plain_versions():
    """Inside, every fused entry point runs its plain version on the card
    instead of its kernel: the reference the training step is held to."""
    from sparch_tpu_torch.ops import fused_cells

    saved = fused_cells._by_device
    fused_cells._by_device = lambda t, plain, kernel, what: plain
    try:
        yield
    finally:
        fused_cells._by_device = saved


def training_state(dev):
    """State dict of the trained model: RadLIF [512, 512, 35] from seed 0,
    V rounded onto a 2^-8 grid so that the kernels' and the plain versions'
    spike trains are the same."""
    from sparch_tpu_torch.models import build_model

    model = build_model("RadLIF", (B, T, F), [H, H, C], dropout=P_DROP,
                        cell_impl="scan",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.hidden_layers():
            layer.V.copy_(torch.round(layer.V * 256.0) / 256.0)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_run(dev, impl, state_dict, x, y, steps, seed=0,
              model_type="RadLIF", sizes=(H, H, C), lr=LR, **model_kw):
    """``steps`` training steps of a new trainer, in the type of ``x``
    (``model_kw``: ``compute_dtype``, ``remat``, ``bidirectional``,
    ``tp_mesh``); returns (model, state, losses, first-step gradients,
    launch counts of the run)."""
    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.train import create_train_state, make_train_step

    model = build_model(model_type, tuple(x.shape), list(sizes),
                        dropout=P_DROP, normalization="batchnorm",
                        state_init="uniform", cell_impl=impl, **model_kw)
    model.load_state_dict(state_dict)
    state = create_train_state(model.to(x.dtype), lr, device=dev, seed=seed)
    step = make_train_step(model)
    losses, grads = [], None
    fused_cells.reset_launch_counts()
    for i in range(steps):
        state, met = step(state, x, y)
        losses.append(met["loss"])
        if i == 0:
            grads = {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()}
    counts = fused_cells.launch_counts()
    return model, state, [float(v) for v in losses], grads, counts


def step_split_ms(model, state, x, y, n=10):
    """Median ms of the forward (with the loss), the backward and the
    optimizer update of one training step, from CUDA events."""
    import torch.nn.functional as F_

    rows = []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        out, _ = model(x, state.generator)
        loss = F_.cross_entropy(out, y)
        ev[1].record()
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        rows.append(ev)
    torch.cuda.synchronize()
    return {k: statistics.median(ev[i].elapsed_time(ev[i + 1]) for ev in rows)
            for i, k in enumerate(("forward_ms", "backward_ms",
                                   "optimizer_ms"))}


def step1_vs_plain_versions(what, dev, impl, state_dict, x, y, loss, grads,
                            run, grad_rel_max=GRAD_REL_MAX):
    """Step 1 of a kernel variant (its ``loss`` and gradients ``grads``)
    against the same step with each kernel swapped for its plain version:
    the loss within 1e-3 relative, every gradient finite and within
    ``grad_rel_max`` of its largest magnitude or else by the float64
    witness rule of the backward phases. ``run``: ``train_run``'s model
    keywords."""
    with plain_versions():
        _, _, plain_losses, plain_grads, plain_counts = train_run(
            dev, impl, state_dict, x, y, 1, **run)
    check(not any(plain_counts.values()),
          f"{what}: the plain run launched {plain_counts}")
    loss_rel = abs(loss - plain_losses[0]) / abs(plain_losses[0])
    errs = {k: rel_err(grads[k], plain_grads[k]) for k in grads}
    row = dict(step1_loss=plain_losses[0], step1_loss_rel_diff=loss_rel,
               max_grad_rel_err=max(errs.values()),
               grad_rel_bound=grad_rel_max, grad_rel_err=errs)
    check(loss_rel <= 1e-3,
          f"{what}: step-1 loss {loss} vs plain versions' {plain_losses[0]}")
    truth = None
    for k, e in errs.items():
        check(bool(torch.isfinite(grads[k]).all()),
              f"{what}: step-1 gradient of {k} is not finite")
        if e <= grad_rel_max:
            continue
        # as for the backward kernels: the same step in float64 is the
        # truth, and the kernels' step may be no further from it than
        # WITNESS_GRAD_FACTOR times the float32 plain versions' step
        if truth is None:
            with plain_versions():
                truth = train_run(dev, impl, state_dict, x.double(), y, 1,
                                  **run)[3]
        w = dict(vs_plain=e,
                 kernel_vs_f64=rel_err(grads[k].double(), truth[k]),
                 plain_vs_f64=rel_err(plain_grads[k].double(), truth[k]))
        row.setdefault("f64_witness", {})[k] = w
        check(w["kernel_vs_f64"] <= WITNESS_GRAD_FACTOR * w["plain_vs_f64"],
              f"{what}: step-1 gradient of {k} {w}")
    return row


def train_variant(dev, impl, state_dict, x, y, per_step, scan_row,
                  model_type="RadLIF", steps=TRAIN_STEPS, timed=True,
                  grad_rel_max=GRAD_REL_MAX, sizes=(H, H, C), keep=None,
                  lr=LR, **model_kw):
    """One ``cell_impl`` of a training phase: ``steps`` steps of a new
    trainer with the launch counters set to 0 just before and read just
    after; every kernel of the variant launched ``per_step`` times per step
    and no other; the loss finite and (over TRAIN_STEPS steps) lower at the
    end; two 3-step runs
    from one seed bit-equal; for a kernel variant, step 1 against the same
    step with each kernel swapped for its plain version (loss within 1e-3
    relative, every gradient within ``grad_rel_max`` of its largest
    magnitude or else by the float64 witness rule of the backward
    phases), and (loosely, where ``scan_row`` is given) against scan's.
    ``model_kw`` (``compute_dtype``, ``bidirectional``, ``tp_mesh``) and
    ``lr`` go to every trainer of the variant. ``keep`` (a dict) receives the
    step-1 gradients and the state dict after the steps. Returns (row,
    launch counts)."""
    from sparch_tpu_torch.train import make_train_step
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    what = f"{model_type} {impl}" + (f" {model_kw}" if model_kw else "")
    run = dict(model_type=model_type, sizes=sizes, lr=lr, **model_kw)
    model, state, losses, grads, counts = train_run(
        dev, impl, state_dict, x, y, steps, **run)
    want = {k: steps * per_step.get(k, 0) for k in counts}
    check(counts == want, f"{what}: kernel launches {counts} != {want}")
    check(bool(np.isfinite(losses).all()), f"{what}: losses {losses}")
    check(all(p.dtype == p.grad.dtype == torch.float32
              for p in model.parameters()) and
          all(v.dtype == torch.float32
              for st in state.optimizer.state.values()
              for v in st.values() if torch.is_tensor(v)),
          f"{what}: parameters, gradients and Adam's moments are float32")
    # a run of a few steps is only held to finite losses
    check(steps < TRAIN_STEPS or losses[-1] < losses[0],
          f"{what}: loss did not fall in {steps} steps: {losses}")
    row = dict(launches={k: n for k, n in counts.items() if n},
               losses=losses)
    if keep is not None:
        keep.update(grads=grads, state_dict={
            k: v.detach().clone() for k, v in model.state_dict().items()})
    # one seed, bit-equal parameters
    a = train_run(dev, impl, state_dict, x, y, 3, **run)[0].state_dict()
    b = train_run(dev, impl, state_dict, x, y, 3, **run)[0].state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    check(not differ, f"{what}: two runs from one seed differ in {differ}")
    row["two_runs_bit_equal"] = True
    if impl != "scan":
        row["vs_plain_versions"] = step1_vs_plain_versions(
            what, dev, impl, state_dict, x, y, losses[0], grads, run,
            grad_rel_max)
    if impl != "scan" and scan_row is not None:
        scan_loss = scan_row["losses"][0]
        row["vs_scan_step1_loss_rel_diff"] = \
            abs(losses[0] - scan_loss) / scan_loss
        check(row["vs_scan_step1_loss_rel_diff"] <= 0.1,
              f"{what}: step-1 loss {losses[0]} vs scan's {scan_loss}")
    if timed:
        step = make_train_step(model)
        # a scan step is ~20 kernel steps long: fewer of them time it
        slow = impl == "scan"
        row["train_step_ms"] = cuda_time_ms(
            step, state, x, y, warmup=1 if slow else 3,
            iters=5 if slow else 20, repeats=3)
        row["utterances_per_s"] = 1e3 * B / row["train_step_ms"]
        row.update(step_split_ms(model, state, x, y, n=3 if slow else 10))
    with torch.no_grad():
        model.eval()
        _, rates = model(x, state.generator)
    if rates is not None:  # two hidden layers of one width
        half = rates.shape[0] // 2
        row["firing_rate_layer0"] = float(rates[:half].mean())
        row["firing_rate_layer1"] = float(rates[half:].mean())
    return row, counts


def phase_training(dev):
    """The spiking training main path (see the module docstring, phase
    8)."""
    state_dict = training_state(dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    x = (torch.rand((B, T, F), generator=gen, device=dev) < 0.02).float()
    y = torch.randint(0, C, (B,), generator=gen, device=dev)
    per_step = {
        "scan": {},
        "auto": {"fused_cell_fwd_train": 2, "fused_cell_bwd": 2,
                 "readout_fwd": 1, "readout_bwd": 1},
        "pallas": {"fused_cell_fwd_train": 2, "fused_cell_bwd": 2,
                   "readout_fwd": 1, "readout_bwd": 1},
    }
    rows, launches = {}, None
    for impl in ("scan", "auto", "pallas"):
        rows[impl], launches = train_variant(
            dev, impl, state_dict, x, y, per_step[impl], rows.get("scan"))
    emit("training", model="RadLIF [512, 512, 35]", batch_size=B, T=T, F=F,
         dropout=P_DROP, lr=LR, steps=TRAIN_STEPS, **rows)
    return launches, rows["auto"]


# ---------------------------------------------------------------------------
# The CLI's main path: run_exp_torch / Experiment on SSC-shaped data
# ---------------------------------------------------------------------------

# Where the experiment phase reads its events. The card's machine has no
# h5py, so the events are served from memory by a SpikingDataset whose
# spikes group is a dict; everything after the read (binning, collate,
# loader, epochs, checkpoints, serving) is the port's own code. The HDF5
# read itself is held against the JAX package on the CPU only
# (tests/test_torch_data.py).
EXP_DATA = "memory"
EXP_SPLITS = {"train": 1280, "valid": 256, "test": 256}
EXP_EVENTS = (800, 3000)  # events an utterance, tools/gen_synthetic_ssc.py
EXP_NOISE = 0.5  # share of events on random units, the same tool's default
EXP_EPOCHS = 2


def ssc_events(n, seed):
    """SSC-shaped utterances as gen_synthetic_ssc.py makes them (the
    Heidelberg layout's fields): class c fires units of its block of 20,
    EXP_NOISE of the events land on any of the 700 units, times sorted in
    [0, 0.99 * 1.4) s. Returns (times, units, labels)."""
    from sparch_tpu_torch.data.spiking import MAX_TIME, NB_UNITS

    rng = np.random.default_rng(seed)
    labels = np.arange(n) % C
    block = NB_UNITS // C
    times, units = [], []
    for c in labels:
        k = rng.integers(*EXP_EVENTS)
        times.append(np.sort(rng.uniform(0, MAX_TIME * 0.99, k)))
        u = rng.integers(c * block, (c + 1) * block, k)
        noisy = rng.random(k) < EXP_NOISE
        units.append(np.where(noisy, rng.integers(0, NB_UNITS, k), u))
    return times, units, labels.astype(np.int64)


def memory_experiment_class(data):
    """``Experiment`` with only ``init_dataset`` overridden: the SSC
    loaders, built as ``load_shd_or_ssc`` builds them, over datasets that
    serve ``data``'s events from memory."""
    from sparch_tpu_torch.data import DataLoader
    from sparch_tpu_torch.data.spiking import (
        MAX_TIME, NB_UNITS, SpikingDataset)
    from sparch_tpu_torch.train.loop import Experiment

    class MemorySpikes(SpikingDataset):
        def __init__(self, times, units, labels, nb_steps):
            self.nb_steps, self.nb_units, self.max_time = \
                nb_steps, NB_UNITS, MAX_TIME
            self.time_bins = np.linspace(0, MAX_TIME, num=nb_steps)
            self.labels = labels
            self._events = {"times": times, "units": units}
            self._h5 = None

        def _spikes(self):
            return self._events

    class MemoryExperiment(Experiment):
        def init_dataset(self):
            self.nb_inputs, self.nb_outputs = NB_UNITS, C
            for split in EXP_SPLITS:
                ds = MemorySpikes(*data[split], self.nb_steps)
                setattr(self, f"{split}_loader", DataLoader(
                    ds, batch_size=self.batch_size,
                    collate_fn=ds.generate_batch, shuffle=split == "train",
                    seed=self.seed, prefetch=2 if self.workers >= 0 else 0,
                    workers=max(self.workers, 0),
                    batch_transform=self._to_tensors))

    return MemoryExperiment


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` set to ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def counting(module, name, calls):
    """``patched`` with a wrapper of ``module.name`` that counts its calls
    into ``calls[name]``."""
    fn = getattr(module, name)
    calls[name] = 0

    def wrapper(*args, **kw):
        calls[name] += 1
        return fn(*args, **kw)

    return patched(module, name, wrapper)


def experiment_run(argv, dev, cls=None):
    """One run of ``argv``: ``run_exp_torch.main``, or ``forward()`` of
    ``cls`` (an ``Experiment`` subclass) built from it. The launch counters
    are set to 0 just before and read just after (building the experiment
    launches no kernel); the calls of ``cells.readout_sum`` (the plain
    readout chain) and of the native Freeverb are counted. Returns
    (experiment, launch counts, calls)."""
    import run_exp_torch
    from sparch_tpu_torch.data import native
    from sparch_tpu_torch.ops import cells, fused_cells

    calls = {}
    with counting(cells, "readout_sum", calls), \
            counting(native, "freeverb_channel", calls):
        fused_cells.reset_launch_counts()
        if cls is None:
            exp = run_exp_torch.main(argv, device=dev)
        else:
            exp = cls(run_exp_torch.parse_args(argv), device=dev)
            exp.forward()
        torch.cuda.synchronize()
        counts = fused_cells.launch_counts()
    return exp, counts, calls


def per_batch(exp):
    """Kernel launches of an ``auto`` RadLIF run's training step and of its
    eval batch: a step launches the training cell and its backward once a
    hidden layer (a bidirectional layer's two directions in one launch)
    and the readout pair once; an eval batch the serving cell once a
    hidden layer and the readout once."""
    hidden = exp.nb_layers - 1
    return ({"fused_cell_fwd_train": hidden, "fused_cell_bwd": hidden,
             "readout_fwd": 1, "readout_bwd": 1},
            {"fused_cell_fwd": hidden, "readout_fwd": 1})


def expected_launches(exp):
    """Kernel launches of a run: ``per_batch`` a step and an eval batch
    (HD and SHD test on their valid split)."""
    step, batch = per_batch(exp)
    test = getattr(exp, "test_loader", exp.valid_loader)
    steps = sum(len(exp.train_loader) for h in exp.history
                if h["split"] == "train")
    evals = sum(len(test if h["split"] == "test" else exp.valid_loader)
                for h in exp.history if h["split"] != "train")
    return steps, evals, {
        k: steps * step.get(k, 0) + evals * batch.get(k, 0)
        for k in step.keys() | batch.keys()}


def check_launches(what, exp, counts, calls):
    """A run's kernels by name, ``cells.readout_sum`` never called, the
    parameters on the card and the losses finite; returns the launches."""
    steps, evals, want = expected_launches(exp)
    want = {k: want.get(k, 0) for k in counts}
    check(counts == want, f"{what}: launches {counts} != {want} "
          f"({steps} steps, {evals} eval batches)")
    check(calls["readout_sum"] == 0,
          f"{what}: readout_sum ran {calls['readout_sum']} times")
    check(all(p.is_cuda for p in exp.net.parameters()),
          f"{what}: parameters not on the card")
    losses = [h["loss"] for h in exp.history]
    check(bool(np.isfinite(losses).all()), f"{what}: losses {losses}")
    return {k: n for k, n in counts.items() if n}


def resume_is_bit_for_bit(exp, dev, folder):
    """Save the run's state, take one step; restore into a fresh state of
    the same configuration (other weights, other seed) and take the same
    step: the loss, every parameter and statistic, Adam's moments and the
    CUDA generator's state must be the same bits."""
    from sparch_tpu_torch.models import build_model_from_config
    from sparch_tpu_torch.train import (
        create_train_state, make_train_step, restore_checkpoint,
        save_checkpoint)

    x, _, y = next(iter(exp.train_loader))
    x, y = exp._put_batch(x, y)
    save_checkpoint(folder, exp.state, meta={})

    def after_step(state):
        state, met = make_train_step(state.model)(state, x, y)
        torch.cuda.synchronize()
        return float(met["loss"]), dict(
            model={k: v.clone() for k, v in state.model.state_dict().items()},
            moments=[v.clone() for st in state.optimizer.state.values()
                     for v in st.values()],
            generator=state.generator.get_state())

    want = after_step(exp.state)
    model = build_model_from_config(exp._model_config)
    fresh = create_train_state(model, LR, device=dev, seed=9)
    fresh, _ = restore_checkpoint(folder, fresh)
    got = after_step(fresh)
    check(got[0] == want[0], f"resumed step loss {got[0]} != {want[0]}")
    differ = [k for k in want[1]["model"]
              if not torch.equal(got[1]["model"][k], want[1]["model"][k])]
    check(not differ, f"resumed step: parameters differ in {differ}")
    check(all(torch.equal(a, b) for a, b in zip(got[1]["moments"],
                                                 want[1]["moments"])),
          "resumed step: Adam's moments differ")
    check(torch.equal(got[1]["generator"], want[1]["generator"]),
          "resumed step: generator states differ")
    return dict(loss=got[0], parameters=len(want[1]["model"]),
                bit_equal=True)


def one_step_launches(exp):
    """The kernels one training step of the run's trainer launches, counted
    as phase 8 counts them."""
    from sparch_tpu_torch.ops import fused_cells

    x, _, y = next(iter(exp.train_loader))
    x, y = exp._put_batch(x, y)
    fused_cells.reset_launch_counts()
    exp._train_step(exp.state, x, y)
    torch.cuda.synchronize()
    counts = fused_cells.launch_counts()
    want = {k: per_batch(exp)[0].get(k, 0) for k in counts}
    check(counts == want, f"experiment: a step launched {counts}")
    return {k: n for k, n in counts.items() if n}


def loader_free_epoch(exp):
    """One epoch of the run's steps on its own batches, all made and pinned
    beforehand: the epoch loop's copies and steps without the loader's
    thread beside them. Returns utterances/s (host clock, to the sync)."""
    batches = list(exp.train_loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for x, _, y in batches:
        x, y = exp._put_batch(x, y)
        exp.state, _ = exp._train_step(exp.state, x, y)
        n += x.shape[0]
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def epochs_of(exp, resident_ups=None):
    """The run's training epochs: loader-fed utterances/s beside the
    device-resident step's (``resident_ups``), the loader wait, the
    losses."""
    return [dict(epoch=h["epoch"], seconds=h["seconds"],
                 utterances=h["utterances"],
                 utterances_per_s=h["utterances"] / h["seconds"],
                 device_resident_auto_utterances_per_s=resident_ups,
                 loader_wait_s=h["loader_wait_s"], pinned=h["pinned"],
                 train_loss=h["loss"], train_acc=h["acc"],
                 train_rate=h["rate"])
            for h in exp.history if h["split"] == "train"]


def phase_experiment(dev, resident):
    """The CLI's main path (see the module docstring, phase 8b)."""
    import shutil
    import tempfile

    from sparch_tpu_torch.data import native
    from sparch_tpu_torch.serve import Predictor, load_experiment

    data = {split: ssc_events(n, seed)
            for seed, (split, n) in enumerate(EXP_SPLITS.items())}
    cls = memory_experiment_class(data)
    root = tempfile.mkdtemp(prefix="chip_smoke_exp_")
    folder = str(Path(root) / "exp")
    argv = ["--model_type", "RadLIF", "--nb_layers", "3", "--nb_hiddens",
            str(H), "--batch_size", str(B), "--dataset_name", "ssc",
            "--data_folder", EXP_DATA, "--new_exp_folder", folder,
            "--log_tofile", "true"]
    try:
        runs = {}
        exp, counts, calls = experiment_run(
            argv + ["--nb_epochs", str(EXP_EPOCHS)], dev, cls)
        check(exp.host_fetches == {"train": EXP_EPOCHS, "valid": EXP_EPOCHS,
                                   "test": 1},
              f"experiment: host fetches {dict(exp.host_fetches)}")
        runs["fresh"] = dict(
            launches=check_launches("experiment fresh", exp, counts, calls),
            epochs=epochs_of(exp, resident["utterances_per_s"]),
            valid_acc=[h["acc"] for h in exp.history
                       if h["split"] == "valid"],
            test_acc=exp.test_acc,
            host_fetches=dict(exp.host_fetches))
        step_launches = one_step_launches(exp)
        runs["fresh"]["loader_free_utterances_per_s"] = loader_free_epoch(exp)
        resumed_step = resume_is_bit_for_bit(exp, dev, str(Path(root) /
                                                           "resume"))

        exp, counts, calls = experiment_run(
            argv + ["--nb_epochs", "1", "--auto_resume", "true"], dev, cls)
        train = [h for h in exp.history if h["split"] == "train"]
        check(len(train) == 1, "experiment: the resumed run's epochs")
        runs["auto_resume"] = dict(
            launches=check_launches("experiment auto_resume", exp, counts,
                                    calls),
            epochs=epochs_of(exp, resident["utterances_per_s"]),
            valid_acc=[h["acc"] for h in exp.history
                       if h["split"] == "valid"],
            test_acc=exp.test_acc)
        with torch.no_grad():
            exp.net.eval()
            x, _, _ = next(iter(exp.test_loader))
            _, rates = exp.net(x.to(dev), exp._eval_generator)
        firing = [float(r.mean()) for r in rates.split(H)]

        exp, counts, calls = experiment_run(
            argv + ["--use_pretrained_model", "true",
                    "--only_do_testing", "true",
                    "--load_exp_folder", folder], dev, cls)
        runs["only_do_testing"] = dict(
            launches=check_launches("experiment only_do_testing", exp,
                                    counts, calls),
            test_acc=exp.test_acc)

        labels = data["test"][2]
        ds = exp.test_loader.dataset
        x = np.stack([ds[i][0] for i in range(len(ds))])
        served = Predictor.from_experiment(folder, batch_size=B, device=dev)
        model, state_dict = load_experiment(folder, device=dev)
        direct = Predictor(model, state_dict, batch_size=B, device=dev)
        pred, probs = served(x)
        want_pred, want_probs = direct(x)
        check(np.array_equal(probs, want_probs) and
              np.array_equal(pred, want_pred),
              "from_experiment differs from Predictor(model, state_dict)")
        check(probs.shape == (len(ds), C) and
              bool(np.isfinite(probs).all()) and
              bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)),
              "served probabilities")
        served_acc = float((pred == labels).mean())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("experiment", model="RadLIF [512, 512, 35]", batch_size=B, T=T,
         F=F, dataset="ssc-shaped synthetic", data=EXP_DATA,
         utterances=EXP_SPLITS, events_per_utterance=list(EXP_EVENTS),
         noise=EXP_NOISE, entry="run_exp_torch.parse_args + Experiment "
         "(init_dataset from memory)", device=str(dev),
         binning="native" if native.native_available() else "numpy",
         launches_a_step=step_launches, resumed_step=resumed_step,
         runs=runs, firing_rate_by_layer=firing,
         served=dict(from_experiment_bit_equal=True,
                     test_acc=served_acc, utterances=len(ds)),
         device_resident_auto=dict(
             train_step_ms=resident["train_step_ms"],
             utterances_per_s=resident["utterances_per_s"]))
    return runs["fresh"]["launches"]


# ---------------------------------------------------------------------------
# The HD/SC audio path: WAV trees, augmentation, the fbank, the frontend
# ---------------------------------------------------------------------------

SR = 16000
AUDIO_TRAIN, AUDIO_EVAL = 16, 8  # utterances a label: train, eval candidates
AUDIO_SPLIT = 128  # utterances in SC's valid and in its test list
AUDIO_EPOCHS = 2
HD_CLASSES, HD_TRAIN, HD_TEST = 20, 8, 2  # utterances a class
HD_HIDDEN = 512
HD_SECONDS = (0.6, 1.6)  # train; the test utterances stay under 1 s
FBANK_ATOL = 2e-3  # fbank_torch vs fbank_np (the JAX twins' bound)
SC_ARGV = ["--model_type", "RadLIF", "--nb_layers", "4", "--nb_hiddens",
           "1024", "--bidirectional", "true", "--dataset_name", "sc",
           "--use_augm", "true", "--pdrop", "0.1", "--batch_size", str(B),
           "--log_tofile", "true"]  # README.md's SC flagship


def write_wav(path, x):
    """Float [-1, 1] mono audio as 16-bit PCM at 16 kHz (stdlib wave)."""
    import wave

    pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(pcm.tobytes())


def utterance(rng, label, seconds):
    """A synthetic utterance of class ``label``: two harmonics of the
    class's pitch under a random envelope, over noise."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = 150.0 * 2.0 ** (label / 8.0) * rng.uniform(0.97, 1.03)
    env = np.exp(-((t - rng.uniform(0.3, 0.7) * seconds) /
                   (0.25 * seconds)) ** 2)
    x = rng.uniform(0.2, 0.5) * env * (np.sin(2 * np.pi * f0 * t) +
                                      0.5 * np.sin(4 * np.pi * f0 * t))
    return (x + rng.normal(0.0, 0.01, n)).astype(np.float32)


def write_sc_tree(root, seed):
    """Speech Commands' layout: 35 label folders of one-second utterances,
    ``validation_list.txt`` and ``testing_list.txt`` (AUDIO_SPLIT each,
    taken round the labels), the rest for training, and a
    ``_background_noise_`` folder the dataset must leave out."""
    rng = np.random.default_rng(seed)
    labels = [f"word{c:02d}" for c in range(C)]
    names = {}
    for c, label in enumerate(labels):
        (root / label).mkdir(parents=True)
        for k in range(AUDIO_TRAIN + AUDIO_EVAL):
            name = f"{label}/utt{k:02d}.wav"
            write_wav(root / name, utterance(rng, c, 1.0))
            names[(k, c)] = name
    # the eval candidates k-major, so that each list goes round the labels
    evals = [names[(k, c)] for k in range(AUDIO_TRAIN, AUDIO_TRAIN +
                                          AUDIO_EVAL) for c in range(C)]
    for split, part in (("testing", evals[:AUDIO_SPLIT]),
                        ("validation", evals[AUDIO_SPLIT:2 * AUDIO_SPLIT])):
        (root / f"{split}_list.txt").write_text("\n".join(part) + "\n")
    (root / "_background_noise_").mkdir()
    write_wav(root / "_background_noise_" / "noise.wav",
              rng.normal(0.0, 0.1, SR).astype(np.float32))
    return len(names) - 2 * AUDIO_SPLIT


def write_hd_tree(root, seed):
    """Heidelberg Digits' layout: ``audio/`` and the two filename lists;
    the label rule is the filename's (digit at index -6, 'g' at index 5
    for German, which adds 10). Training utterances last HD_SECONDS, so
    that their frame counts fall in two pad_multiple buckets; the test
    ones stay under a second (one bucket)."""
    rng = np.random.default_rng(seed)
    (root / "audio").mkdir(parents=True)
    lists = {"train": [], "test": []}
    for c in range(HD_CLASSES):
        lang, digit = ("g" if c >= 10 else "e"), c % 10
        for k in range(HD_TRAIN + HD_TEST):
            split = "train" if k < HD_TRAIN else "test"
            name = f"s{k:03d}_{lang}_{digit}0.wav"
            seconds = (rng.uniform(*HD_SECONDS) if split == "train"
                       else rng.uniform(HD_SECONDS[0], 0.95))
            write_wav(root / "audio" / name, utterance(rng, c, seconds))
            lists[split].append(name)
    for split, part in lists.items():
        (root / f"{split}_filenames.txt").write_text("\n".join(part) + "\n")


def fbank_check(dev, folder):
    """``fbank_torch`` on the card against ``fbank_np`` on the host, on a
    ragged batch (0.3-1.0 s, padded to 100-frame buckets): every true frame
    within FBANK_ATOL, the padded ones the waveform tail's. Then the
    fbank's device time for one training batch (B one-second utterances)."""
    from sparch_tpu_torch.data.audio import pad_waveform_batch, read_wav
    from sparch_tpu_torch.ops.fbank import fbank_np, fbank_torch, num_frames
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    files = sorted(folder.glob("word*/utt00.wav"))[:16]
    rng = np.random.default_rng(5)
    waves = [read_wav(str(f))[:int(rng.uniform(0.3, 1.0) * SR)]
             for f in files]
    wav, xlens = pad_waveform_batch(waves, 100)
    got = fbank_torch(torch.from_numpy(wav).to(dev))
    check(got.is_cuda and got.shape == (len(waves), 100, 40),
          f"fbank_torch: {got.device} {tuple(got.shape)}")
    got = got.cpu().numpy()
    err = max(float(np.abs(g[:n] - fbank_np(w)).max())
              for g, n, w in zip(got, xlens, waves))
    check(err <= FBANK_ATOL, f"fbank_torch vs fbank_np: {err}")
    full, _ = pad_waveform_batch([read_wav(str(f)) for f in files] * 8, 100)
    full = torch.from_numpy(full).to(dev)
    ms = cuda_time_ms(fbank_torch, full, warmup=3, iters=20, repeats=5)
    return dict(max_abs_err=err, atol=FBANK_ATOL,
                frames=[int(n) for n in xlens], batch_ms=ms,
                batch_shape=list(full.shape), batch_frames=num_frames(
                    full.shape[1]))


def freeverb_check():
    """The native Freeverb, built by the card machine's g++ into
    build/native/, against the SciPy formulation on 0.125 s."""
    from sparch_tpu_torch.data import augment, native

    check(native.freeverb_available(), "native freeverb did not build")
    x = np.random.default_rng(5).normal(size=2000)
    combs, aps = augment._filter_delays(SR, 0.7, 1.0)
    got = native.freeverb_channel(x, np.asarray(combs), np.asarray(aps),
                                  0.93, 0.41)
    with patched(native, "freeverb_channel", lambda *a: None):
        want = augment._freeverb_channel(x, SR, 0.7, 1.0, 0.93, 0.41)
    err = float(np.abs(got - want).max())
    check(err <= 1e-9, f"native freeverb vs scipy: {err}")
    return dict(library=native._FV_LIB, vs_scipy_max_abs_err=err)


def served_equals_test_path(exp, folder, dev):
    """``Predictor.from_experiment`` on the test split's waveforms, whole
    and ragged, against the test loader's batches through the restored
    model, its state draws seeded as the Predictor seeds them: bit for
    bit, batch for batch."""
    from sparch_tpu_torch.serve import Predictor

    ds = exp.test_loader.dataset
    waves = [ds[i][0] for i in range(len(ds))]
    labels = np.asarray([ds[i][1] for i in range(len(ds))])
    pred = Predictor.from_experiment(folder, batch_size=B, device=dev)
    check(pred.pad_multiple == exp.pad_multiple and pred._waveform,
          "from_experiment: not a waveform predictor")
    got_labels, got = pred(waves)
    want = []
    gen = torch.Generator(device=dev)
    exp.net.eval()
    with torch.no_grad():
        for x, _, _ in exp.test_loader:
            x, _ = exp._put_batch(x, torch.zeros(1))
            gen.manual_seed(0)
            out, _ = exp.net(x, gen)
            want.append((out / out.sum(dim=-1, keepdim=True)).cpu().numpy())
    want = np.concatenate(want)
    check(np.array_equal(got, want),
          f"from_experiment vs the test path: {np.abs(got - want).max()}")
    check(got.shape == (len(ds), C) and bool(np.isfinite(got).all()),
          "served probabilities")
    return dict(utterances=len(ds), bit_equal=True,
                batches=len(exp.test_loader),
                test_acc=float((got_labels == labels).mean()))


def eval_vs_plain_versions(what, model, x, dev):
    """One eval forward of ``model`` on the batch ``x``, with its kernels
    and again inside ``plain_versions()``, the state draws seeded alike;
    the launch counters set to 0 just before each and read just after.
    Every hidden layer's spikes bit for bit (V on the 2^-8 grid), the
    probabilities within 1e-5 (the readout kernel's rtol against its plain
    version, phase 2)."""
    from sparch_tpu_torch.ops import fused_cells

    layers = getattr(model, "inner", model).hidden_layers()
    gen = torch.Generator(device=dev)
    model.eval()

    def forward():
        spikes = []
        hooks = [layer.register_forward_hook(
            lambda mod, args, res: spikes.append(res)) for layer in layers]
        gen.manual_seed(0)
        fused_cells.reset_launch_counts()
        try:
            with torch.no_grad():
                out, _ = model(x, gen)
        finally:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        counts = fused_cells.launch_counts()
        return out / out.sum(dim=-1, keepdim=True), spikes, counts

    probs, spikes, counts = forward()
    with plain_versions():
        plain, plain_spikes, plain_counts = forward()
    want = {k: 0 for k in counts}
    want.update(fused_cell_fwd=len(layers), readout_fwd=1)
    check(counts == want and not any(plain_counts.values()),
          f"{what}: launches {counts}, plain {plain_counts}")
    differ = sum(int((a != b).sum()) for a, b in zip(spikes, plain_spikes))
    check(differ == 0, f"{what}: {differ} spikes differ from the plain "
          "versions")
    err = float((probs - plain).abs().max())
    check(err <= 1e-5, f"{what}: probabilities vs the plain versions {err}")
    return dict(shape=[int(n) for n in spikes[0].shape],
                spikes_bit_equal=True, max_abs_prob_diff=err,
                launches={k: n for k, n in counts.items() if n},
                firing_rate_by_layer=[float(s.float().mean())
                                      for s in spikes])


def on_grid(model):
    """The trained model's V put back on the 2^-8 grid (in place)."""
    with torch.no_grad():
        for layer in getattr(model, "inner", model).hidden_layers():
            layer.V.copy_(dyadic(layer.V))


def hd_vs_plain_versions(exp, dev):
    """The HD run's kernels at T = 200 against their plain versions, on
    its trained weights with V on the 2^-8 grid and its largest T = 200
    training batch: an eval forward (``eval_vs_plain_versions``) and
    a training step of the same configuration (``train_run``, counters set
    to 0 just before and read just after; ``step1_vs_plain_versions``)."""
    x, _, y = max(exp.train_loader, key=lambda b: (b[0].shape[1],
                                                   b[0].shape[0]))
    check(x.shape[1] == 200, f"hd: no T = 200 batch ({tuple(x.shape)})")
    x, y = exp._put_batch(x, y)
    on_grid(exp.net)
    row = dict(eval=eval_vs_plain_versions("hd eval T=200", exp.net, x, dev))
    sd = {k: v.detach().clone() for k, v in exp.net.state_dict().items()}
    run = dict(model_type="RadLIF", sizes=(HD_HIDDEN, HD_HIDDEN, HD_CLASSES))
    _, _, losses, grads, counts = train_run(dev, "auto", sd, x, y, 1, **run)
    want = {k: per_batch(exp)[0].get(k, 0) for k in counts}
    check(counts == want, f"hd step T=200: launches {counts} != {want}")
    row["train_step"] = dict(
        shape=list(x.shape), loss=losses[0],
        launches={k: n for k, n in counts.items() if n},
        vs_plain_versions=step1_vs_plain_versions(
            "hd step T=200", dev, "auto", sd, x, y, losses[0], grads, run))
    return row


def phase_audio(dev, smi, root):
    """The HD/SC audio path (see the module docstring, phase 8c); the WAV
    trees go into ``root``, which the caller removes."""
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    t0 = time.perf_counter()
    n_train = write_sc_tree(root / "sc", seed=11)
    write_hd_tree(root / "hd", seed=12)
    trees_s = time.perf_counter() - t0
    fbank = fbank_check(dev, root / "sc")
    freeverb = freeverb_check()

    sc = SC_ARGV + ["--data_folder", str(root / "sc")]
    folder = str(root / "sc_device")
    exp, counts, calls = experiment_run(
        sc + ["--frontend", "device", "--nb_epochs", str(AUDIO_EPOCHS),
              "--new_exp_folder", folder], dev)
    check(len(exp.train_loader.dataset) == n_train and
          len(exp.test_loader.dataset) == AUDIO_SPLIT,
          "sc: the splits' sizes")
    check(exp.host_fetches == {"train": AUDIO_EPOCHS,
                               "valid": AUDIO_EPOCHS, "test": 1},
          f"sc: host fetches {dict(exp.host_fetches)}")
    check(calls["freeverb_channel"] > 0, "sc: the reverb never ran")
    launches = check_launches("sc device", exp, counts, calls)
    served = served_equals_test_path(exp, folder, dev)
    test_x, _, _ = next(iter(exp.test_loader))
    test_x, _ = exp._put_batch(test_x, torch.zeros(1))
    with torch.no_grad():
        _, rates = exp.net(test_x, exp._eval_generator)
    firing = [float(r.mean()) for r in rates.split(2 * 1024)]
    x, _, y = next(iter(exp.train_loader))
    x, y = exp._put_batch(x, y)
    step_ms = cuda_time_ms(exp._train_step, exp.state, x, y, warmup=2,
                           iters=10, repeats=3)
    device_run = dict(
        epochs=epochs_of(exp, B / step_ms * 1e3), launches=launches,
        freeverb_calls=calls["freeverb_channel"],
        valid_acc=[h["acc"] for h in exp.history
                   if h["split"] == "valid"],
        test_acc=exp.test_acc, resident_step_ms=step_ms,
        resident_utterances_per_s=B / step_ms * 1e3)
    on_grid(exp.net)
    served_vs_plain = eval_vs_plain_versions(
        "sc eval", exp.net, test_x, dev)
    del exp
    torch.cuda.empty_cache()

    exp, counts, calls = experiment_run(
        sc + ["--frontend", "host", "--nb_epochs", "1",
              "--new_exp_folder", str(root / "sc_host")], dev)
    host_run = dict(
        launches=check_launches("sc host", exp, counts, calls),
        epochs=epochs_of(exp))
    del exp
    torch.cuda.empty_cache()

    exp, counts, calls = experiment_run(
        ["--model_type", "RadLIF", "--nb_layers", "3", "--nb_hiddens",
         str(HD_HIDDEN), "--dataset_name", "hd", "--data_folder",
         str(root / "hd"), "--frontend", "host", "--batch_size", str(B),
         "--nb_epochs", "1", "--log_tofile", "true",
         "--new_exp_folder", str(root / "hd_exp")], dev)
    check(exp.nb_outputs == HD_CLASSES, "hd: classes")
    frames = sorted({int(x.shape[1]) for loader in
                     (exp.train_loader, exp.valid_loader)
                     for x, _, _ in loader})
    check(len(frames) >= 2 and all(t % 100 == 0 for t in frames),
          f"hd: batch frame counts {frames}")
    hd_run = dict(
        model=f"RadLIF [{HD_HIDDEN}, {HD_HIDDEN}, {HD_CLASSES}]",
        launches=check_launches("hd", exp, counts, calls),
        epochs=epochs_of(exp), batch_frames=frames,
        test_acc=exp.test_acc, vs_plain_versions=hd_vs_plain_versions(
            exp, dev))
    del exp
    torch.cuda.empty_cache()
    emit("audio", card=smi,
         model="RadLIF [1024, 1024, 1024, 35] bidirectional",
         argv=" ".join(SC_ARGV), batch_size=B, F=40, pad_multiple=100,
         dataset="sc-shaped synthetic WAVs (35 labels, 1 s, 16 kHz)",
         utterances=dict(train=n_train, valid=AUDIO_SPLIT,
                         test=AUDIO_SPLIT), write_trees_s=trees_s,
         entry="run_exp_torch.main", device=str(dev), fbank=fbank,
         freeverb=freeverb, sc_device=device_run, served=served,
         served_vs_plain_versions=served_vs_plain,
         firing_rate_by_layer=firing, sc_host=host_run, hd=hd_run)
    return launches


def dyadic(t, step=2.0 ** -8):
    return torch.round(t / step) * step


def streaming_model(kind, dev):
    """A ``scan`` [512, 512, 35] model, zero state init, on the card: for
    RadLIF every weight on a 2^-8 grid and the norm gains 4 (so the batch
    and the per-frame projections and affines are exact), for the GRU as
    built; running statistics from one train-mode pass."""
    from sparch_tpu_torch.models import build_model

    model = build_model(kind, (B, T, F_ANN), [H, H, C], state_init="zeros",
                        cell_impl="scan", dropout=0.0,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    x = torch.randn(B, T, F_ANN, generator=torch.Generator().manual_seed(4))
    if kind == "RadLIF":
        x = torch.round(x.abs().clamp(max=1.0) * 4.0) / 4.0
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("W.weight", ".V")):
                    p.copy_(dyadic(p))
                elif name.endswith("norm.weight"):
                    p.fill_(4.0)
                elif name.endswith("norm.bias"):
                    p.copy_(dyadic(p + 0.5, 2.0 ** -4))
    x = x.to(dev)
    model.train()
    with torch.no_grad():
        model(x)
    return model.eval(), x


def phase_streaming(dev, smi):
    """``serve/streaming.py`` on the card (see the module docstring, phase
    8d)."""
    from sparch_tpu_torch.models.frontend import FbankFrontend
    from sparch_tpu_torch.ops.fbank import fbank_torch
    from sparch_tpu_torch.serve import streaming_init, streaming_step

    out = {}
    for kind in ("RadLIF", "GRU"):
        model, x = streaming_model(kind, dev)
        sd = model.state_dict()
        spikes = []
        hooks = [layer.register_forward_hook(
            lambda mod, args, res: spikes.append(res))
            for layer in model.hidden_layers()]
        with torch.no_grad():
            want, _ = model(x)
        for h in hooks:
            h.remove()
        state = streaming_init(model, sd, B)
        flips = 0
        for t in range(T):
            state, got = streaming_step(model, sd, state, x[:, t])
            if kind == "RadLIF":
                flips += sum(int((st["s"] != s[:, t]).sum()) for st, s in
                             zip(state["layers"], spikes))
        rel = float((got - want).abs().max() / want.abs().max())
        if kind == "RadLIF":
            check(flips == 0, f"streaming RadLIF: {flips} spikes differ")
            check(rel <= 1e-5, f"streaming RadLIF readout: {rel}")
            rate = [float(s.float().mean()) for s in spikes]
            out[kind] = dict(spikes_bit_equal=True, readout_rel_err=rel,
                             firing_rate_by_layer=rate)
        else:
            check(rel <= 1e-5, f"streaming GRU: {rel}")
            out[kind] = dict(output_rel_err=rel)
    # the waveform form: the GRU in the frontend, a 400-sample window a
    # step, advanced by 160
    model, _ = streaming_model("GRU", dev)
    wrapped = FbankFrontend(model).eval()
    n = 400 + (T - 1) * 160
    wav = 0.3 * torch.randn(B, n, generator=torch.Generator().manual_seed(6))
    wav = wav.to(dev)
    with torch.no_grad():
        want, _ = wrapped(wav)
        feats = fbank_torch(wav)
    sd = wrapped.state_dict()
    state = streaming_init(wrapped, sd, B)
    feat_err = 0.0
    for t in range(T):
        window = wav[:, t * 160:t * 160 + 400]
        feat_err = max(feat_err, float(
            (fbank_torch(window)[:, 0] - feats[:, t]).abs().max()))
        state, got = streaming_step(wrapped, sd, state, window)
    rel = float((got - want).abs().max() / want.abs().max())
    check(rel <= 1e-5, f"waveform streaming GRU: {rel}")
    check(feat_err <= FBANK_ATOL, f"window fbank vs batch: {feat_err}")
    out["GRU_waveform"] = dict(output_rel_err=rel,
                               window_vs_batch_fbank_max_abs=feat_err)
    emit("streaming", card=smi, shape=[B, T, F_ANN], sizes=[H, H, C],
         frames=T,
         device=str(dev), **out)


# ---------------------------------------------------------------------------
# Migration: reference checkpoints served and fine-tuned through the kernels
# ---------------------------------------------------------------------------

MIGRATE_PROB_ATOL = 1e-6  # the flagship's probabilities vs the plain versions
FUZZ_CASES, FUZZ_SECONDS = 600, 50.0  # at most; stop past the seconds
SC_SIZES = [1024, 1024, 1024, C]  # README.md's SC flagship, bidirectional
F_SC = 40
# the __global__ functions of csrc/, found by name in a profiler trace
PORT_KERNELS = re.compile(
    r"\b(cell_bwd_cluster|dv|first_product|fused_ann_bwd|fused_ann_fwd|"
    r"fused_cell_bwd|fused_cell_fwd|readout_bwd(?:_wide)?|"
    r"readout_fwd(?:_wide)?|slice_fwd|sum_parts|tp_all_gather|tp_ann_bwd|"
    r"tp_ann_fwd|tp_cell_bwd|tp_cell_fwd|tp_reduce_scatter|tp_vec_reduce|"
    r"vec_reduce)_kernel\b")


def calibrated_model(dev, model_type, sizes, n_in, seed, calib_seed,
                     bidirectional=False):
    """A ``scan`` model of weights drawn from ``seed`` (V of a spiking model
    on the 2^-8 grid, zero state init) whose running statistics are the
    batch statistics of one train-mode pass over normal features drawn
    from ``calib_seed``."""
    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.models.common import BN_MOMENTUM, SeqNorm

    model = build_model(
        model_type, (B, T, n_in), sizes, bidirectional=bidirectional,
        cell_impl="scan", state_init="zeros",
        generator=torch.Generator().manual_seed(seed)).to(dev)
    calib = torch.randn((B, T, n_in), device=dev,
                        generator=torch.Generator(dev).manual_seed(calib_seed))
    with torch.no_grad():
        if model.is_snn:
            for layer in model.hidden_layers():
                layer.V.copy_(dyadic(layer.V))
        model.train()
        model(calib)
        # undo the running average's first step (see serving_state)
        w = 1.0 - BN_MOMENTUM
        for n in model.modules():
            if isinstance(n, SeqNorm):
                n.running_mean.copy_(n.running_mean / w)
                n.running_var.copy_((n.running_var - BN_MOMENTUM) / w)
    return model.eval()


def reference_layout(state_dict, is_snn):
    """A port ``state_dict`` in the reference's layout (snns.py /
    anns.py): ``layer_<i>`` and ``readout`` become ``snn.<i>`` / ``ann.<i>``,
    a spiking V ``V.weight`` as it is, an ANN gate ``V``/``Vz``/``Vr``
    ``<g>.weight`` transposed (the reference applies it as a module), the
    ANN norms ``norm_W``/``norm_Wz``/``norm_Wr`` ``norm``/``normz``/
    ``normr``, every batchnorm with a ``num_batches_tracked``. CPU tensors."""
    container = "snn" if is_snn else "ann"
    n_hidden = len({k.split(".")[0] for k in state_dict
                    if k.startswith("layer_")})
    norms = {"norm": "norm", "norm_W": "norm", "norm_Wz": "normz",
             "norm_Wr": "normr"}
    out = {}
    for key, t in state_dict.items():
        module, *rest = key.split(".")
        i = n_hidden if module == "readout" else int(module.split("_")[1])
        t = t.detach().cpu().clone()
        if rest[0] in ("V", "Vz", "Vr"):
            rest = [rest[0], "weight"]
            t = t if is_snn else t.t().contiguous()
        elif rest[0] in norms:
            rest = [norms[rest[0]], *rest[1:]]
            if rest[1] == "running_mean":
                out[f"{container}.{i}.{rest[0]}.num_batches_tracked"] = \
                    torch.tensor(1)
        out[".".join([container, str(i), *rest])] = t
    return out


def import_reference(dev, root, name, model, **overrides):
    """``model``'s weights as a reference ``state_dict`` saved to
    ``<root>/<name>.pth`` and imported by ``migrate.import_torch_checkpoint``
    into ``<root>/<name>``; the imported weights must be the model's bit
    for bit. Returns the folder."""
    from sparch_tpu_torch import migrate

    pth, folder = str(root / f"{name}.pth"), str(root / name)
    torch.save(reference_layout(model.state_dict(), model.is_snn), pth)
    _, imported = migrate.import_torch_checkpoint(
        pth, folder, config_overrides=dict(batch_size=B, **overrides),
        device=dev)
    want = model.state_dict()
    check(imported.keys() == want.keys() and
          all(torch.equal(imported[k], want[k].cpu()) for k in want),
          f"{name}: the imported weights differ from the model's")
    with open(Path(folder) / "checkpoints" / "meta.json") as f:
        record = json.load(f)["model"]
    check(tuple(record) == migrate.MODEL_RECORD_KEYS,
          f"{name}: model record {list(record)}")
    return folder


def served(pred, x):
    """``pred(x)`` with the launch counters set to 0 just before and read
    just after, each hidden layer's output of every batch kept (batch by
    batch, layer by layer). Returns (probs, outputs, counts)."""
    from sparch_tpu_torch.ops import fused_cells

    outs = []
    hooks = [layer.register_forward_hook(
        lambda mod, args, res: outs.append(res.detach().clone()))
        for layer in pred.model.hidden_layers()]
    try:
        fused_cells.reset_launch_counts()
        _, probs = pred(x)
        torch.cuda.synchronize()
        counts = fused_cells.launch_counts()
    finally:
        for h in hooks:
            h.remove()
    return probs, outs, counts


def serve_imported(dev, folder, x, kernels, what):
    """Serve ``x`` from an imported folder with ``Predictor.from_experiment``
    (``auto``, batches of B, the last padded): its launches by name
    (``kernels``: each a batch, and no other), again inside
    ``plain_versions()`` (no launch), and timed (host clock, median of 3).
    Returns (probs, plain probs, hidden outputs of both, the row)."""
    from sparch_tpu_torch.serve import Predictor

    pred = Predictor.from_experiment(folder, batch_size=B, device=dev)
    probs, outs, counts = served(pred, x)
    n_batches = -(-len(x) // B)
    want = {k: 0 for k in counts}
    want.update({k: n * n_batches for k, n in kernels.items()})
    check(counts == want, f"{what}: launches {counts} != {want}")
    check(probs.shape == (len(x), C) and bool(np.isfinite(probs).all()) and
          bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)),
          f"{what}: served probabilities")
    with plain_versions():
        plain, plain_outs, plain_counts = served(pred, x)
    check(not any(plain_counts.values()), f"{what}: plain run launched "
          f"{plain_counts}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred(x)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    row = dict(launches={k: n for k, n in counts.items() if n},
               predict_ms_per_batch=1e3 * wall / n_batches,
               utterances_per_s=len(x) / wall)
    return probs, plain, outs, plain_outs, row


def only_testing_labels(argv, dev):
    """``--only_do_testing`` run of ``argv``, the launch counters set to 0
    just before ``forward()`` and read just after (the serving form once a
    hidden layer and the readout once a test batch, and no other): the
    test split's labels, from a hook on the model's output, and the test
    batches' features."""
    import run_exp_torch
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.train.loop import Experiment

    exp = Experiment(run_exp_torch.parse_args(argv), device=dev)
    labels = []
    hook = exp.net.register_forward_hook(
        lambda mod, args, res: labels.append(res[0].argmax(-1).cpu()))
    try:
        fused_cells.reset_launch_counts()
        exp.forward()
        torch.cuda.synchronize()
        counts = fused_cells.launch_counts()
    finally:
        hook.remove()
    n = len(exp.test_loader)
    want = {k: 0 for k in counts}
    want.update(fused_cell_fwd=(exp.nb_layers - 1) * n, readout_fwd=n)
    check(counts == want, f"only_do_testing: launches {counts} != {want}")
    x = np.concatenate([xb.numpy() for xb, _, _ in exp.test_loader])
    return exp, torch.cat(labels).numpy(), x


def trace_kernels(folder):
    """The port's kernels found by name in the profiler trace(s) of
    ``folder``: {name: events}."""
    found = {}
    for path in Path(folder).glob("trace_*.json"):
        for event in json.loads(path.read_text()).get("traceEvents", []):
            if event.get("cat") != "kernel":
                continue
            m = PORT_KERNELS.search(str(event.get("name", "")))
            if m:
                found[m.group(0)] = found.get(m.group(0), 0) + 1
    return found


def listing(folder):
    """(name, size, mtime) of every file in ``folder``."""
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in Path(folder).iterdir() if p.is_file())


def phase_migrate(dev, smi, audio_root):
    """Reference checkpoints imported into port folders, served and
    fine-tuned through the kernels (see the module docstring, phase 8e)."""
    import shutil
    import tempfile

    from sparch_tpu_torch import _build
    from sparch_tpu_torch.serve import Predictor

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_migrate_"))
    x = np.random.default_rng(31).normal(0.0, 1.0, (N_UTT, T, F_SC)) \
        .astype(np.float32)
    try:
        # (a) the SC flagship from a bare reference state_dict
        flagship = calibrated_model(dev, "RadLIF", SC_SIZES, F_SC, 41, 42,
                                    bidirectional=True)
        folder = import_reference(dev, root, "flagship", flagship,
                                  state_init="zeros", dropout=P_DROP)
        del flagship
        probs, plain, outs, plain_outs, sc_row = serve_imported(
            dev, folder, x, {"fused_cell_fwd": 3, "readout_fwd": 1},
            "flagship")
        differ = sum(int((a != b).sum()) for a, b in zip(outs, plain_outs))
        check(differ == 0, f"flagship: {differ} spikes differ from the "
              "plain versions")
        err = float(np.abs(probs - plain).max())
        check(err <= MIGRATE_PROB_ATOL,
              f"flagship: probabilities vs the plain versions {err}")
        sc_row.update(spikes_bit_equal=True, max_abs_prob_diff=err,
                      atol=MIGRATE_PROB_ATOL,
                      layer_output_shape=list(outs[0].shape),
                      firing_rate_by_layer=[
                          float(torch.stack(outs[i::3]).float().mean())
                          for i in range(3)])

        # (b) the GRU [512, 512, 35] of serving_ann
        gru = calibrated_model(dev, "GRU", [H, H, C], F_SC, 0, 11)
        gru_folder = import_reference(dev, root, "gru", gru)
        del gru
        probs, plain, _, _, gru_row = serve_imported(
            dev, gru_folder, x, {"fused_ann_fwd_gru": 2}, "gru")
        agree = _agreement((probs.argmax(-1), probs),
                           (plain.argmax(-1), plain))
        check(agree["label_agreement"] >= 0.99 and
              agree["max_abs_prob_diff"] <= 1e-3,
              f"gru: vs the plain versions {agree}")
        gru_row["vs_plain_versions"] = agree
        torch.cuda.empty_cache()

        # (c) the flagship fine-tuned by the CLI from its folder, after an
        # --only_do_testing run that must label the test split as
        # from_experiment does
        sc = SC_ARGV + ["--data_folder", str(audio_root / "sc"),
                        "--frontend", "host", "--state_init", "zeros",
                        "--use_pretrained_model", "true",
                        "--load_exp_folder", folder]
        exp, labels, test_x = only_testing_labels(
            sc + ["--only_do_testing", "true"], dev)
        want, _ = Predictor.from_experiment(folder, batch_size=B,
                                            device=dev)(test_x)
        check(np.array_equal(labels, want),
              f"only_do_testing labels differ from from_experiment on "
              f"{int((labels != want).sum())} of {len(want)}")
        imported_test_acc = exp.test_acc
        del exp
        kernel_dir = _build.BUILD_DIR
        before = listing(kernel_dir)
        trace_dir = root / "trace"
        exp, counts, calls = experiment_run(
            sc + ["--nb_epochs", "1", "--compile_cache", str(kernel_dir),
                  "--profile_dir", str(trace_dir)], dev)
        check(exp.kernel_dir == kernel_dir and listing(kernel_dir) == before,
              "fine-tune: a kernel was built again under --compile_cache")
        check([h["split"] for h in exp.history] ==
              ["valid", "train", "valid", "test"],
              f"fine-tune: epochs {[h['split'] for h in exp.history]}")
        launches = check_launches("fine-tune", exp, counts, calls)
        traced = trace_kernels(trace_dir)
        check(bool(list(trace_dir.glob("trace_*.json"))),
              "fine-tune: no profiler trace")
        tune_row = dict(
            argv=" ".join(sc[:-1] + ["<imported>", "--nb_epochs", "1",
                                     "--compile_cache", "build/kernels",
                                     "--profile_dir", "<tmp>"]),
            launches=launches, epochs=epochs_of(exp),
            valid_acc=[h["acc"] for h in exp.history
                       if h["split"] == "valid"],
            test_acc=exp.test_acc, imported_test_acc=imported_test_acc,
            only_do_testing_labels_equal_from_experiment=True,
            kernels_rebuilt=0, kernel_dir=str(kernel_dir),
            trace_kernels=traced)
        del exp
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("migrate", card=smi, model="RadLIF [1024, 1024, 1024, 35] "
         "bidirectional (SC flagship) and GRU [512, 512, 35]",
         source="reference-layout state_dict from a seed, imported by "
         "sparch_tpu_torch.migrate.import_torch_checkpoint",
         n_utterances=N_UTT, batch_size=B, T=T, F=F_SC, flagship=sc_row,
         gru=gru_row, fine_tune=tune_row, device=str(dev))
    # the path's launches by kernel: the two served models and the
    # fine-tune
    path = dict(launches)
    for row in (sc_row, gru_row):
        for k, n in row["launches"].items():
            path[k] = path.get(k, 0) + n
    return path


def phase_fuzz(dev, smi):
    """``tools/fuzz_kernels_torch.py`` for FUZZ_SECONDS: every kernel
    family against its plain version at drawn shapes, with the plans the
    launches took."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fuzz_kernels_torch", REPO / "tools" / "fuzz_kernels_torch.py")
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    summary = fuzz.run(FUZZ_CASES, seed=0, seconds=FUZZ_SECONDS, dev=dev)
    check(summary["failures"] == 0, f"fuzz: {summary['failures']} of "
          f"{summary['cases']} cases failed: "
          f"{list(zip(summary['failed'], summary['errors']))[:3]}")
    check(set(summary["families"]) == set(fuzz.FAMILIES),
          f"fuzz: families {summary['families']}")
    slowest = max(summary["records"], key=lambda r: r["seconds"])
    emit("fuzz", card=smi, **{k: v for k, v in summary.items()
                              if k != "records"},
         slowest_case=[slowest["case"], slowest["seconds"]])


# ---------------------------------------------------------------------------
# The non-spiking family: RNN, LiGRU, GRU
# ---------------------------------------------------------------------------


def ann_inputs(mode, shape, seed, dev):
    """Operands of one fused ANN cell call, lists by gate: normal input
    streams, full orthogonal recurrent matrices, a batchnorm-like affine
    and a nonzero y0."""
    from sparch_tpu_torch.ops import fused_ann

    b, t, h = shape
    n = fused_ann.MODES[mode]
    g = torch.Generator(device=dev).manual_seed(seed)
    vs = []
    for i in range(n):
        V = torch.empty(h, h)
        torch.nn.init.orthogonal_(
            V, generator=torch.Generator().manual_seed(seed + i))
        vs.append(V.to(dev))
    return dict(
        wxs=[torch.randn(shape, generator=g, device=dev) for _ in range(n)],
        scales=[torch.rand(h, generator=g, device=dev) * 0.7 + 0.8
                for _ in range(n)],
        shifts=[0.2 * torch.randn(h, generator=g, device=dev)
                for _ in range(n)],
        vs=vs, y0=torch.rand((b, h), generator=g, device=dev),
    )


def _same(t):
    return t


def ann_forward(mode, d, kernel: bool, drop_rate=0.0, seed=None,
                save_residuals=False, cast=_same, bf16=False):
    """The fused ANN forward with the affine, the kernel or its plain
    version; with ``save_residuals`` the flat tuple (y, y_raw, *gates)."""
    from sparch_tpu_torch.ops import fused_ann

    fn = fused_ann._ann_cell_cuda if kernel else fused_ann.ann_cell_plain
    r = fn(mode, *([cast(t) for t in d[k]] for k in
                   ("wxs", "scales", "shifts", "vs")), cast(d["y0"]),
           drop_rate=drop_rate, seed=seed, save_residuals=save_residuals,
           mxu_bf16=bf16)
    return (r[0], r[1], *r[2]) if save_residuals else r


def ann_backward(mode, d, g, residuals, seed, kernel: bool, cast=_same,
                 bf16=False, **kernel_kw):
    """The fused ANN backward on the residuals (y_raw, *gates) of the
    training form, the kernel or its plain version; the flat tuple of
    gradients named by ``ann_grad_names``. ``kernel_kw`` (``split_ms``) goes
    to the kernel's wrapper."""
    from sparch_tpu_torch.ops import fused_ann

    fn = fused_ann._ann_cell_bwd_cuda if kernel else \
        fused_ann.ann_cell_bwd_plain
    y_raw, *gates = residuals
    dwxs, dscales, dshifts, dvs, dy0 = fn(
        mode, cast(g), [cast(t) for t in d["wxs"]], cast(y_raw),
        [cast(t) for t in gates], [cast(t) for t in d["scales"]],
        [cast(t) for t in d["vs"]], cast(d["y0"]), drop_rate=P_DROP,
        seed=seed, mxu_bf16=bf16, **kernel_kw)
    return (*dwxs, *dscales, *dshifts, *dvs, dy0)


def ann_plan(mode, shape, bf16=False, backward=False):
    """The launch plan of the fused ANN forward (``backward``: of the
    backward's time loop) at ``shape``, and how many of its clusters the
    card holds at once."""
    from sparch_tpu_torch.ops import fused_ann

    b, t, h = shape
    n = fused_ann.MODES[mode]
    p = fused_ann._bwd_plan(b, t, h, n, bf16)[0] if backward else \
        fused_ann._fwd_plan(b, h, n, bf16)
    return dict(cluster=p.cluster, rows_per_cluster=p.rows,
                resident=p.resident, cols=p.cols, clusters=p.clusters,
                threads=p.threads, stage_bytes=p.stage_bytes,
                max_active_clusters=fused_ann.max_active_clusters(
                    mode, b, h, bf16, backward=backward))


SPLIT_NAMES = ("time_loop", "dv_product", "second_passes")
FWD_SPLIT_NAMES = ("first_product", "time_loop")


def split_ms_of(fn, n=5, names=SPLIT_NAMES):
    """Median milliseconds of a wrapper's launches (a backward's: the time
    loop, the dV product, the second passes; a spiking forward's, with
    ``FWD_SPLIT_NAMES``: the first product, the time loop) over ``n`` calls
    of ``fn(split)``, which passes ``split_ms=split`` on: CUDA events around
    each launch."""
    splits = []
    for _ in range(n):
        split = []
        fn(split)
        splits.append(split)
    return {k: statistics.median(s[i] for s in splits)
            for i, k in enumerate(names)}


def dv_library_ms(b, t, h, dev, gates=1):
    """One ``torch.matmul`` of the dV product's (h, b*t) x (b*t, gates*h)
    float32 operands (the gates' products side by side), TF32 off: the
    yardstick of a backward's dV part (a library call the port never
    makes)."""
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(3)
    left = torch.randn((h, b * t), generator=gen, device=dev)
    right = torch.randn((b * t, gates * h), generator=gen, device=dev)
    return cuda_time_ms(torch.matmul, left, right)


def ann_grad_names(mode):
    from sparch_tpu_torch.ops import fused_ann

    gates = ("", "z", "r")[:fused_ann.MODES[mode]]
    return tuple(f"d{k}{g}" for k in ("Wx", "scale", "shift", "V")
                 for g in gates) + ("dy0",)


def series_within_bound(what, names, atols, got, want32, want64,
                        relative=False):
    """Hold each series of ``got`` (the kernel's) against the plain
    version's: within its atol (``relative``: times max(1, |value|)), or
    else, with the plain version in float64
    as the truth, no further from it than WITNESS_FWD_FACTOR times the
    float32 plain version is. ``want64`` computes the float64 series when
    they are needed. Returns the errors by series."""
    errs, truth = {}, None
    for name, atol, x, y in zip(names, atols, got, want32):
        check(bool(torch.isfinite(x).all()), f"{what}: {name} not finite")
        check(x.dtype == y.dtype, f"{what}: {name} is {x.dtype}, the plain "
                                  f"version's {y.dtype}")
        x, y = x.float(), y.float()
        diff = (x - y).abs()
        if relative:
            diff = diff / y.abs().clamp_min(1.0)
        e = dict(vs_plain=float(diff.max()))
        if e["vs_plain"] > atol:
            if truth is None:
                truth = dict(zip(names, want64()))
            e["kernel_vs_f64"] = float((x.double() - truth[name]).abs().max())
            e["plain_vs_f64"] = float((y.double() - truth[name]).abs().max())
            check(e["kernel_vs_f64"]
                  <= WITNESS_FWD_FACTOR * e["plain_vs_f64"],
                  f"{what}: {name} {e}")
        errs[name] = e
    return errs


def phase_ann_forward(dev, bf16=False):
    """Phase 9, or with ``bf16`` the bf16-stream form: the input streams
    are then bf16, the series are bf16 and held to one ulp (BF16_ULP)."""
    from sparch_tpu_torch.ops import fused_ann
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
    double = torch.Tensor.double
    main = {}
    atol = BF16_ULP if bf16 else ANN_ATOL
    mode_kw = dict(bf16=bf16)
    for shape in ((B, T, H), (5, 13, 40)):
        for mode in fused_ann.MODES:
            what = f"{mode} {shape}" + (" bf16" if bf16 else "")
            d = ann_inputs(mode, shape, 4, dev)
            if bf16:
                d["wxs"] = [w.to(BF16) for w in d["wxs"]]
            names = ("y", "y_raw") + fused_ann._GATE_SERIES[mode]
            # a kept output is y / (1 - p)
            atols = (atol / (1.0 - P_DROP),) + (atol,) * (len(names) - 1)
            train = (P_DROP, seed, True)
            with torch.no_grad():
                served = ann_forward(mode, d, True, **mode_kw)
                got = ann_forward(mode, d, True, *train, **mode_kw)
                again = ann_forward(mode, d, True, *train, **mode_kw)
                want_served = ann_forward(mode, d, False, **mode_kw)
                want = ann_forward(mode, d, False, *train, **mode_kw)
                torch.cuda.synchronize()
                errs = series_within_bound(
                    what, ("y_served",), (atol,), (served,),
                    (want_served,),
                    lambda: (ann_forward(mode, d, False, cast=double,
                                         **mode_kw),), relative=bf16)
                errs.update(series_within_bound(
                    what, names, atols, got, want,
                    lambda: ann_forward(mode, d, False, *train,
                                        cast=double, **mode_kw),
                    relative=bf16))
            for n, x, z in zip(names, got, again):
                check(torch.equal(x, z),
                      f"{what}: {n} differs between two launches")
            check(torch.equal(got[0] == 0, want[0] == 0),
                  f"{what}: dropped positions differ from plain")
            dropped = float((got[0] == 0).float().mean())
            row = dict(cell=mode, shape=list(shape), affine=True,
                       drop_rate=P_DROP, abs_err=errs, dropped_share=dropped,
                       dropped_positions_equal=True,
                       two_launches_bit_equal=True,
                       max_abs_err=max(e["vs_plain"] for e in errs.values()))
            if shape == (B, T, H):
                check(abs(dropped - P_DROP) <= 0.005,
                      f"{what}: dropped share {dropped}")
                def timed(kernel, *form, **kw):
                    return cuda_time_ms(
                        lambda: ann_forward(mode, d, kernel, *form,
                                            **mode_kw), **kw)

                with torch.no_grad():
                    row["ms"] = timed(True)
                    row["plain_ms"] = timed(False, **PLAIN_ROUNDS)
                    row["ms_train"] = timed(True, *train)
                    row["plain_ms_train"] = timed(False, *train,
                                                  **PLAIN_ROUNDS)
                row["plan"] = ann_plan(mode, shape, bf16)
                main[mode] = {k: row[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "ms_train",
                    "plain_ms_train", "plan")}
            emit("kernel_vs_plain",
                 kernel="fused_ann_fwd_bf16" if bf16 else "fused_ann_fwd",
                 **row)
    return main


def phase_ann_backward(dev, bf16=False):
    """Phase 10, or with ``bf16`` the bf16-stream form: g, the input
    streams and the residual series are then bf16, and the bounds those of
    ``bf16_grad_bounds``."""
    from sparch_tpu_torch.ops import fused_ann
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
    main = {}
    mode_kw = dict(bf16=bf16)
    for shape in ((B, T, H), (5, 13, 40)):
        for mode in fused_ann.MODES:
            what = f"{mode} {shape}" + (" bf16" if bf16 else "")
            d = ann_inputs(mode, shape, 4, dev)
            gen = torch.Generator(device=dev).manual_seed(6)
            g = torch.randn(shape, generator=gen, device=dev)
            if bf16:
                g, d["wxs"] = g.to(BF16), [w.to(BF16) for w in d["wxs"]]
            names = ann_grad_names(mode)
            with torch.no_grad():
                # one set of residuals for both sides: the LiGRU's c > 0
                # cannot flip between them
                res = ann_forward(mode, d, False, P_DROP, seed, True,
                                  **mode_kw)[1:]
                got = ann_backward(mode, d, g, res, seed, True, **mode_kw)
                again = ann_backward(mode, d, g, res, seed, True, **mode_kw)
                want = ann_backward(mode, d, g, res, seed, False, **mode_kw)
                torch.cuda.synchronize()
                errs = grads_within_bound(
                    what, got, want,
                    lambda: ann_backward(mode, d, g, res, seed, False,
                                         cast=torch.Tensor.double,
                                         **mode_kw), names,
                    rel_max=bf16_grad_bounds(names) if bf16 else None)
            check(len(got) == len(names) == len(want),
                  f"{what}: {len(got)} gradients for {names}")
            for n, x, z in zip(names, got, again):
                check(torch.equal(x, z),
                      f"{what}: {n} differs between two launches")
            row = dict(cell=mode, shape=list(shape), affine=True,
                       drop_rate=P_DROP, rel_err=errs,
                       two_launches_bit_equal=True,
                       max_abs_err=float(
                           (got[0].float() - want[0].float()).abs().max()))
            if shape == (B, T, H):
                with torch.no_grad():
                    row["ms"] = cuda_time_ms(
                        lambda: ann_backward(mode, d, g, res, seed, True,
                                             **mode_kw))
                    row["plain_ms"] = cuda_time_ms(
                        lambda: ann_backward(mode, d, g, res, seed, False,
                                             **mode_kw), **PLAIN_ROUNDS)
                    row["split_ms"] = split_ms_of(
                        lambda split: ann_backward(mode, d, g, res, seed,
                                                   True, bf16=bf16,
                                                   split_ms=split))
                    row["dv_library_ms"] = dv_library_ms(
                        *shape, dev, fused_ann.MODES[mode])
                row["plan"] = ann_plan(mode, shape, bf16, backward=True)
                main[mode] = {k: row[k] for k in ("max_abs_err", "ms",
                                                  "plain_ms", "split_ms",
                                                  "dv_library_ms", "plan")}
            emit("kernel_vs_plain",
                 kernel="fused_ann_bwd_bf16" if bf16 else "fused_ann_bwd",
                 **row)
    return main


def ann_state(dev, ann_type):
    """State dict of a [512, 512, 35] model of the non-spiking family with
    seeded random weights and, as running statistics, the batch statistics
    of one train-mode pass over a calibration batch."""
    model = calibrated_model(dev, ann_type, [H, H, C], F_ANN, 0, 11)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def serve_ann(dev, mode, x, timed_predictor: bool):
    """Serve ``x`` with one model of the non-spiking family, cell_impl scan
    and auto; the launch counters are set to 0 just before each variant's
    call and read just after it: auto launches the forward kernel of its
    mode twice per batch (two hidden layers) and no other kernel, scan
    none. auto must give scan's labels on >= 99 % and its probabilities
    within 1e-3."""
    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.serve import Predictor
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    ann_type = ANN_TYPES[mode]
    state = ann_state(dev, ann_type)
    n_batches = -(-len(x) // B)
    out, rows = {}, {}
    for impl in ("scan", "auto"):
        what = f"{ann_type} {impl}"
        model = build_model(ann_type, (B, T, F_ANN), [H, H, C],
                            cell_impl=impl)
        pred = Predictor(model, state, batch_size=B, device=dev)
        fused_cells.reset_launch_counts()
        labels, probs = pred(x)
        counts = fused_cells.launch_counts()
        check(probs.shape == (len(x), C) and bool(np.isfinite(probs).all()),
              f"{what}: probs not finite or of the wrong shape")
        check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)),
              f"{what}: probs do not sum to 1")
        want = {k: 0 for k in counts}
        if impl == "auto":
            want[f"fused_ann_fwd_{mode}"] = 2 * n_batches
        check(counts == want, f"{what}: kernel launches {counts} != {want}")
        out[impl] = (labels, probs)
        row = dict(launches={k: n for k, n in counts.items() if n})
        if impl == "auto":
            row["vs_scan"] = agree = _agreement(out["auto"], out["scan"])
            check(agree["label_agreement"] >= 0.99,
                  f"{what}: labels agree with scan on "
                  f"{agree['label_agreement']}")
            check(agree["max_abs_prob_diff"] <= 1e-3,
                  f"{what}: probs differ from scan by "
                  f"{agree['max_abs_prob_diff']}")
        if timed_predictor:
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                pred(x)
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            row.update(predict_ms_per_batch=1e3 * wall / n_batches,
                       utterances_per_s=len(x) / wall)
        xb = torch.from_numpy(x[:B]).to(dev)
        with torch.no_grad():
            row["forward_ms"] = cuda_time_ms(pred.model, xb, warmup=2,
                                             iters=5, repeats=3)
        rows[impl] = row
    return rows, counts


def phase_serving_ann(dev):
    """The non-spiking serving main path: the GRU, timed; the LiGRU and the
    RNN checked alike with their forward timed. Returns the ``auto``
    Predictor's launch counts by mode."""
    x = np.random.default_rng(12).normal(0.0, 1.0, (N_UTT, T, F_ANN)) \
        .astype(np.float32)
    launches = {}
    for mode in ("gru", "ligru", "rnn"):
        rows, launches[mode] = serve_ann(dev, mode, x, mode == "gru")
        emit("serving_ann", model=f"{ANN_TYPES[mode]} [512, 512, 35]",
             n_utterances=N_UTT, batch_size=B, T=T, F=F_ANN, **rows)
    return launches


def phase_training_ann(dev):
    """The non-spiking training main path: the GRU for TRAIN_STEPS steps,
    scan and auto, timed; the LiGRU and the RNN for three steps, checked
    alike. Returns the ``auto`` trainer's launch counts by mode."""
    from sparch_tpu_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((B, T, F_ANN), generator=gen, device=dev)
    y = torch.randint(0, C, (B,), generator=gen, device=dev)
    launches = {}
    for mode in ("gru", "ligru", "rnn"):
        ann_type = ANN_TYPES[mode]
        state_dict = build_model(
            ann_type, (B, T, F_ANN), [H, H, C], dropout=P_DROP,
            generator=torch.Generator().manual_seed(0)).state_dict()
        steps = TRAIN_STEPS if mode == "gru" else 3
        per_step = {"scan": {}, "auto": {f"fused_ann_fwd_{mode}": 2,
                                         f"fused_ann_bwd_{mode}": 2}}
        rows = {}
        for impl in ("scan", "auto"):
            rows[impl], launches[mode] = train_variant(
                dev, impl, state_dict, x, y, per_step[impl],
                rows.get("scan"), model_type=ann_type, steps=steps,
                timed=mode == "gru",
                grad_rel_max=KINK_GRAD_REL_MAX if mode == "ligru"
                else GRAD_REL_MAX)
        emit("training_ann", model=f"{ann_type} [512, 512, 35]",
             batch_size=B, T=T, F=F_ANN, dropout=P_DROP, lr=LR, steps=steps,
             **rows)
    return launches


def ann_bounds(mode, bf16=False):
    """Bounds of the fused ANN kernels at (B, T, H) with the affine, from
    the shape: each (B, T, H) stream, each (H, H) matrix and each state
    counted once; every gate has one dense product of 2*B*T*H*H in the
    forward and two in the backward (the adjoint and the dV outer
    product). In the bf16-stream mode every stream and matrix read is two
    bytes an element (dV and the states stay four) and the products are of
    bf16 operands."""
    from sparch_tpu_torch.ops import fused_ann

    n = fused_ann.MODES[mode]
    series = len(fused_ann._GATE_SERIES[mode])
    e = 2.0 if bf16 else 4.0
    stream, mat, state, vec = e * B * T * H, e * H * H, 4.0 * B * H, \
        4.0 * H
    dv = 4.0 * H * H
    product = 2.0 * B * T * H * H

    def ops(products, elementwise):
        return (elementwise, products) if bf16 else \
            (elementwise + products, 0.0)

    fwd_bytes = (n + 1) * stream + n * mat + state + 2 * n * vec
    fwd_elem = 12.0 * n * B * T * H
    # reads g, the raw y, the gate series and the raw input streams; writes
    # the input streams' gradients
    bwd_bytes = (2 + series + 2 * n) * stream + n * (mat + dv) + 2 * state \
        + 3 * n * vec
    return dict(
        fwd=bound(fwd_bytes, *ops(n * product, fwd_elem)),
        fwd_train=bound(fwd_bytes + (series + 1) * stream,
                        *ops(n * product, fwd_elem + 12.0 * B * T * H)),
        bwd=bound(bwd_bytes, *ops(2 * n * product, 30.0 * n * B * T * H)),
    )


def at_h1024(mode, tp_res, direction, bf16=False):
    """The single-card kernel at the TP ANN path's shape (B, T, 1024),
    without the affine and the dropout (the training form of the forward),
    as the TP phases time it: its time beside its bound and its plan."""
    return dict(shape=[B, T, TP_H], affine=False,
                ms=tp_res[mode]["single_card_kernel_ms"],
                **tp_ann_bounds(mode, B, T, TP_H, bf16=bf16)[direction],
                plan=ann_plan(mode, (B, T, TP_H), bf16,
                              backward=direction == "bwd"))


def ann_kernel_rows(fwd, bwd, served, trained, tp_fwd, tp_bwd, migrated):
    """The ``kernels`` entries of the fused ANN cells, one per direction
    and mode, with their plan and their time at H = 1024 (``at_h1024``);
    the forwards' launches on the ``migrate`` path (the imported GRU)."""
    src = "sparch_tpu_torch/csrc/"
    tpu = "sparch_tpu/ops/pallas_ann.py:"
    rows = []
    for mode in ANN_TYPES:
        b = ann_bounds(mode)
        f, name = dict(fwd[mode]), f"fused_ann_fwd_{mode}"
        rows.append(dict(
            name=name, route="cuda", source=src + "fused_ann_fwd.cu",
            replaces=tpu + "174", launches=served[mode][name],
            launches_training=trained[mode][name],
            launches_migrate=migrated.get(name, 0),
            max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
            **b["fwd"], library_ms=None, ms_train=f["ms_train"],
            plain_ms_train=f["plain_ms_train"],
            bound_ms_train=b["fwd_train"]["bound_ms"], plan=f["plan"],
            at_h1024=at_h1024(mode, tp_fwd, "fwd")))
        name = f"fused_ann_bwd_{mode}"
        rows.append(dict(
            name=name, route="cuda", source=src + "fused_ann_bwd.cu",
            replaces=tpu + "392", launches=trained[mode][name], **bwd[mode],
            **b["bwd"], library_ms=None,
            at_h1024=at_h1024(mode, tp_bwd, "bwd")))
    return rows


# ---------------------------------------------------------------------------
# The bf16-stream mode: mxu_bf16=True, compute_dtype=bfloat16
# ---------------------------------------------------------------------------


def phase_bf16_cell_forward(dev):
    """``fused_cell_fwd_bf16`` and ``fused_cell_fwd_train_bf16`` with the
    exact checks (a)-(e) of the module docstring, phase 13; with a uniform
    s0 (rounded for the first product only) the recurrent forms still equal
    their plain version bit for bit. Times: RadLIF with the affine and a
    bf16 drive, as ``compute_dtype=bfloat16`` gives it."""
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    kernel, plain = fused_cells._fused_cell_cuda, fused_cells.fused_cell_plain
    seed = torch.tensor([1234, 99], dtype=torch.int32, device=dev)
    train = dict(drop_rate=P_DROP, seed=seed, save_residuals=True)
    kept = torch.tensor(1.0 / (1.0 - P_DROP), device=dev).to(BF16)
    main = {}
    for shape in ((B, T, H), (5, 13, 40)):
        for name in FORMS:
            for affine in (True, False):
                what = f"{name} {shape} affine={affine} bf16"
                d = cell_inputs(shape, dyadic=True, seed=1, dev=dev)
                check(torch.equal(d["V"].to(BF16).float(), d["V"]),
                      f"{what}: V is not exact in bf16")
                p = _prepared(name, d, affine)
                with torch.no_grad():
                    f32_served = kernel(*p["args"], **p["kw"])
                    f32_out, f32_u = kernel(*p["args"], **p["kw"], **train)
                for wx_bf16 in (False, True):
                    dd = dict(d, Wx=d["Wx"].to(BF16)) if wx_bf16 else d
                    p = _prepared(name, dd, affine)
                    call = dict(p["kw"], mxu_bf16=True)
                    with torch.no_grad():
                        served = kernel(*p["args"], **call)
                        out, u_seq = kernel(*p["args"], **call, **train)
                        want_served = plain(*p["args"], **call)
                        want, want_u = plain(*p["args"], **call, **train)
                    torch.cuda.synchronize()
                    check(served.dtype == out.dtype == BF16 and
                          u_seq.dtype == torch.float32,
                          f"{what}: (e) output types")
                    check(torch.equal(served, want_served) and
                          torch.equal(out, want) and
                          torch.equal(u_seq, want_u),
                          f"{what} wx_bf16={wx_bf16}: (c) differs from plain")
                    check(bool(((out == 0) | (out == kept)).all()),
                          f"{what}: (d) a kept value is not bf16(1/(1-p))")
                    if not wx_bf16:
                        check(torch.equal(served.float(), f32_served) and
                              torch.equal(u_seq, f32_u),
                              f"{what}: (a, b) differs from the float32 "
                              f"kernel")
                        check(torch.equal(out == 0, f32_out == 0),
                              f"{what}: (d) dropped positions differ from "
                              f"the float32 form's")
                row = dict(cell=name, shape=list(shape), affine=affine,
                           drop_rate=P_DROP, max_abs_err=0.0,
                           equals_plain_bit_for_bit=True,
                           float32_drive_equals_float32_kernel=True,
                           firing_rate=float(f32_served.mean()))
                if FORMS[name][0]:
                    dd["s0"] = torch.rand(
                        dd["s0"].shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
                    p = _prepared(name, dd, affine)
                    with torch.no_grad():
                        out, u_seq = kernel(*p["args"], **call, **train)
                        want, want_u = plain(*p["args"], **call, **train)
                    check(torch.equal(out, want) and
                          torch.equal(u_seq, want_u),
                          f"{what}: uniform s0 differs from plain")
                    row["uniform_s0_equals_plain"] = True
                if shape == (B, T, H) and name == "radlif" and affine:
                    dd = dict(d, Wx=d["Wx"].to(BF16))
                    p = _prepared(name, dd, True)

                    def timed(fn, *form, **kw):
                        return cuda_time_ms(
                            lambda: fn(*p["args"], **call,
                                       **(form[0] if form else {})), **kw)

                    with torch.no_grad():
                        row.update(
                            ms=timed(kernel),
                            plain_ms=timed(plain, **PLAIN_ROUNDS),
                            ms_train=timed(kernel, train),
                            plain_ms_train=timed(plain, train,
                                                 **PLAIN_ROUNDS))
                        row.update(fwd_plan_split(lambda sp: kernel(
                            *p["args"], **call, split_ms=sp)))
                        split = fwd_plan_split(lambda sp: kernel(
                            *p["args"], **call, **train, split_ms=sp))
                        row.update(plan_train=split["plan"],
                                   split_ms_train=split["split_ms"])
                        row["at_256x1024"] = forward_at_1024(dev, True)
                    main = {k: row[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "ms_train",
                        "plain_ms_train", "firing_rate", "plan", "split_ms",
                        "plan_train", "split_ms_train", "at_256x1024")}
                emit("kernel_vs_plain", kernel="fused_cell_fwd_bf16", **row)
    return main


def serve_bf16(dev, model_type, state, x, timed: bool):
    """Serve ``x`` with one model under ``compute_dtype=bfloat16``,
    cell_impl scan and auto. ``auto`` launches the bf16 forward kernel of
    its cell twice per batch (RadLIF: and the readout kernel once) and no
    other kernel, and is held against the
    same Predictor with the kernels swapped for their plain versions; its
    distance from the float32 ``auto`` run and from scan is printed."""
    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.serve import Predictor
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    spiking = model_type == "RadLIF"
    kernel = "fused_cell_fwd_bf16" if spiking else \
        f"fused_ann_fwd_{model_type.lower()}_bf16"
    n_batches = -(-len(x) // B)

    def predictor(impl, dtype=torch.float32, **kw):
        model = build_model(model_type, (B, T, x.shape[-1]), [H, H, C],
                            state_init="zeros", cell_impl=impl, **kw)
        return Predictor(model.to(dtype), state, batch_size=B, device=dev)

    out, rows = {}, {}
    for impl in ("scan", "auto"):
        what = f"{model_type} bf16 {impl}"
        pred = predictor(impl, compute_dtype=BF16)
        fused_cells.reset_launch_counts()
        labels, probs = pred(x)
        counts = fused_cells.launch_counts()
        check(probs.dtype == np.float32 and probs.shape == (len(x), C) and
              bool(np.isfinite(probs).all()),
              f"{what}: probs not finite float32 of the right shape")
        check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)),
              f"{what}: probs do not sum to 1")
        want = {k: 0 for k in counts}
        if impl == "auto":
            want[kernel] = 2 * n_batches
            if spiking:
                want["readout_fwd"] = n_batches
        check(counts == want, f"{what}: kernel launches {counts} != {want}")
        out[impl] = (labels, probs)
        row = dict(launches={k: n for k, n in counts.items() if n})
        if impl == "auto":
            with plain_versions():
                plain = pred(x)
            row["vs_plain_versions"] = agree = _agreement(out["auto"], plain)
            if spiking:
                # V on the 2^-8 grid: the same spikes; the readout kernel
                # adds the classes in another order than its plain version
                # (rtol 1e-5), so the rule of reference_check
                xb = torch.from_numpy(x[:B]).to(dev)
                with torch.no_grad():
                    rates = pred.model(xb)[1]
                    with plain_versions():
                        plain_rates = pred.model(xb)[1]
                check(torch.equal(rates, plain_rates) and
                      agree["label_agreement"] >= 0.99 and
                      agree["max_abs_prob_diff"] <= 1e-5,
                      f"{what}: differs from the plain versions: {agree}")
            elif not (agree["label_agreement"] >= 0.99 and
                      agree["max_abs_prob_diff"] <= BF16_PROB_MAX):
                # the rule of phase 4's calibrated model, with the plain
                # versions on float64 parameters (same bf16 streams, same
                # rounding points) as the truth: the kernels may be no
                # further from it than the float32 plain versions are
                with plain_versions():
                    truth = predictor("auto", torch.float64,
                                      compute_dtype=BF16)(x)
                w = dict(kernel_vs_f64=_agreement(out["auto"], truth),
                         plain_vs_f64=_agreement(plain, truth))
                row["f64_witness"] = w
                check(w["kernel_vs_f64"]["label_agreement"]
                      >= w["plain_vs_f64"]["label_agreement"]
                      - WITNESS_LABEL_MARGIN and
                      w["kernel_vs_f64"]["max_abs_prob_diff"]
                      <= WITNESS_PROB_FACTOR
                      * w["plain_vs_f64"]["max_abs_prob_diff"],
                      f"{what}: vs the plain versions {agree}, {w}")
            row["vs_scan"] = _agreement(out["auto"], out["scan"])
            row["vs_float32_auto"] = _agreement(out["auto"],
                                                predictor("auto")(x))
        if timed:
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                pred(x)
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            xb = torch.from_numpy(x[:B]).to(dev)
            with torch.no_grad():
                row.update(
                    predict_ms_per_batch=1e3 * wall / n_batches,
                    utterances_per_s=len(x) / wall,
                    forward_ms=cuda_time_ms(pred.model, xb, warmup=2,
                                            iters=5, repeats=3))
        rows[impl] = row
    return rows, counts


def phase_serving_bf16(dev):
    """The bf16 serving main paths (module docstring, phase 14). Returns
    the ``auto`` Predictors' launch counts by model."""
    g = torch.Generator(device=dev).manual_seed(12)
    rasters = (torch.rand((N_UTT, T, F), generator=g, device=dev) < 0.02)
    rasters = rasters.float().cpu().numpy()
    feats = np.random.default_rng(12).normal(
        0.0, 1.0, (N_UTT, T, F_ANN)).astype(np.float32)
    launches = {}
    for model_type in ("RadLIF", "GRU", "LiGRU", "RNN"):
        main = model_type in ("RadLIF", "GRU")
        if model_type == "RadLIF":
            state, x = serving_state(dev, zero_means=False), rasters
        else:
            state, x = ann_state(dev, model_type), feats
        if not main:
            x = x[:B]
        rows, launches[model_type] = serve_bf16(dev, model_type, state, x,
                                                timed=main)
        emit("serving_bf16", model=f"{model_type} [512, 512, 35]",
             compute_dtype="bfloat16", n_utterances=len(x), batch_size=B,
             T=T, F=x.shape[-1], **rows)
    return launches


def phase_training_bf16(dev):
    """The bf16 training main paths (module docstring, phase 15). Returns
    the ``auto`` trainers' launch counts by model."""
    from sparch_tpu_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(21)
    rasters = (torch.rand((B, T, F), generator=gen, device=dev) < 0.02)
    y = torch.randint(0, C, (B,), generator=gen, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    feats = torch.randn((B, T, F_ANN), generator=gen, device=dev)
    bf16 = dict(compute_dtype=BF16)
    launches = {}
    for model_type in ("RadLIF", "GRU", "LiGRU", "RNN"):
        main = model_type in ("RadLIF", "GRU")
        if model_type == "RadLIF":
            state_dict, x = training_state(dev), rasters.float()
            per_step = {"fused_cell_fwd_train_bf16": 2,
                        "fused_cell_bwd_bf16": 2, "readout_fwd": 1,
                        "readout_bwd": 1}
        else:
            state_dict = build_model(
                model_type, (B, T, F_ANN), [H, H, C], dropout=P_DROP,
                generator=torch.Generator().manual_seed(0)).state_dict()
            x, mode = feats, model_type.lower()
            per_step = {f"fused_ann_fwd_{mode}_bf16": 2,
                        f"fused_ann_bwd_{mode}_bf16": 2}
        steps = TRAIN_STEPS if main else 3
        rows = {}
        for impl in ("scan", "auto") if main else ("auto",):
            rows[impl], counts = train_variant(
                dev, impl, state_dict, x, y,
                per_step if impl == "auto" else {}, rows.get("scan"),
                model_type=model_type, steps=steps, timed=main,
                grad_rel_max=KINK_GRAD_REL_MAX if model_type == "LiGRU"
                else BF16_ULP, **bf16)
        launches[model_type] = counts
        if main:
            rows["float32_auto_losses"] = train_run(
                dev, "auto", state_dict, x, y, steps,
                model_type=model_type)[2]
        emit("training_bf16", model=f"{model_type} [512, 512, 35]",
             compute_dtype="bfloat16", batch_size=B, T=T, F=x.shape[-1],
             dropout=P_DROP, lr=LR, steps=steps, **rows)
        if model_type == "RadLIF":
            training_remat(dev, state_dict, x, y)
    return launches


def training_remat(dev, state_dict, x, y):
    """Three steps of the RadLIF bf16 ``auto`` trainer with ``remat=True``
    against the same without it: the recomputation replays the dropout
    seeds and the uniform states, so losses, step-1 gradients and the
    parameters after the steps are bit-equal; each forward kernel launches
    once more per layer and step. Peak device memory of both."""
    runs = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model, _, losses, grads, counts = train_run(
            dev, "auto", state_dict, x, y, 3, compute_dtype=BF16,
            remat=remat)
        torch.cuda.synchronize()
        runs[remat] = dict(
            losses=losses, grads=grads, params=model.state_dict(),
            row=dict(losses=losses,
                     launches={k: n for k, n in counts.items() if n},
                     max_memory_allocated=torch.cuda.max_memory_allocated()))
    plain, remat = runs[False], runs[True]
    check(plain["losses"] == remat["losses"],
          f"remat: losses {remat['losses']} != {plain['losses']}")
    for what in ("grads", "params"):
        differ = [k for k, v in plain[what].items()
                  if not torch.equal(v, remat[what][k])]
        check(not differ, f"remat: {what} differ in {differ}")
    check(remat["row"]["launches"] ==
          {"fused_cell_fwd_train_bf16": 12, "fused_cell_bwd_bf16": 6,
           "readout_fwd": 3, "readout_bwd": 3},
          f"remat: kernel launches {remat['row']['launches']}")
    emit("training_remat", model="RadLIF [512, 512, 35]",
         compute_dtype="bfloat16", cell_impl="auto", steps=3,
         losses_and_step1_gradients_bit_equal=True,
         without_remat=plain["row"], with_remat=remat["row"])


def bf16_kernel_rows(cell_fwd, cell_bwd, ann_fwd, ann_bwd, served, trained,
                     tp_ann_fwd, tp_ann_bwd, trained_tp_auto):
    """The ``kernels`` entries of the bf16-stream forms; their launches are
    those of the bf16 ``auto`` Predictors and trainers (``trained_tp_auto``:
    the bf16 RadLIF 1024 ``auto`` trainer's, for the forward at (256, 100,
    1024))."""
    src = "sparch_tpu_torch/csrc/"
    cb = cell_bounds(cell_fwd["firing_rate"], bf16=True)
    tpu = "sparch_tpu/ops/pallas_cells.py:"
    rows = [
        dict(name="fused_cell_fwd_bf16", route="cuda",
             source=src + "fused_cell_fwd.cu", replaces=tpu + "305",
             launches=served["RadLIF"]["fused_cell_fwd_bf16"],
             max_abs_err=cell_fwd["max_abs_err"], ms=cell_fwd["ms"],
             plain_ms=cell_fwd["plain_ms"], **cb["fwd"], library_ms=None,
             plan=cell_fwd["plan"], split_ms=cell_fwd["split_ms"]),
        dict(name="fused_cell_fwd_train_bf16", route="cuda",
             source=src + "fused_cell_fwd.cu", replaces=tpu + "305",
             launches=trained["RadLIF"]["fused_cell_fwd_train_bf16"],
             max_abs_err=cell_fwd["max_abs_err"], ms=cell_fwd["ms_train"],
             plain_ms=cell_fwd["plain_ms_train"], **cb["fwd_train"],
             library_ms=None, plan=cell_fwd["plan_train"],
             split_ms=cell_fwd["split_ms_train"],
             at_256x1024=dict(cell_fwd["at_256x1024"],
                              launches=trained_tp_auto.get(
                                  "fused_cell_fwd_train_bf16"))),
        dict(name="fused_cell_bwd_bf16", route="cuda",
             source=src + "fused_cell_bwd.cu", replaces=tpu + "631",
             launches=trained["RadLIF"]["fused_cell_bwd_bf16"], **cell_bwd,
             **cb["bwd"], library_ms=None),
    ]
    tpu = "sparch_tpu/ops/pallas_ann.py:"
    for mode, ann_type in ANN_TYPES.items():
        b = ann_bounds(mode, bf16=True)
        f, name = ann_fwd[mode], f"fused_ann_fwd_{mode}_bf16"
        rows.append(dict(
            name=name, route="cuda", source=src + "fused_ann_fwd.cu",
            replaces=tpu + "174", launches=served[ann_type][name],
            launches_training=trained[ann_type][name],
            max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
            **b["fwd"], library_ms=None, ms_train=f["ms_train"],
            plain_ms_train=f["plain_ms_train"],
            bound_ms_train=b["fwd_train"]["bound_ms"], plan=f["plan"],
            at_h1024=at_h1024(mode, tp_ann_fwd, "fwd", bf16=True)))
        name = f"fused_ann_bwd_{mode}_bf16"
        rows.append(dict(
            name=name, route="cuda", source=src + "fused_ann_bwd.cu",
            replaces=tpu + "392", launches=trained[ann_type][name],
            **ann_bwd[mode], **b["bwd"], library_ms=None,
            at_h1024=at_h1024(mode, tp_ann_bwd, "bwd", bf16=True)))
    return rows


# ---------------------------------------------------------------------------
# The tensor-parallel spiking path: cell_impl='pallas_tp', one-card form
# ---------------------------------------------------------------------------

TP_PS = (1, 2, 4)  # ranks of the TP axis, all on the one card
TP_H, TP_F = 1024, 40  # RadLIF [1024, 1024, 35] bidirectional, SC-shaped
TP_SIZES = (TP_H, TP_H, C)
TP_HL, TP_ROUNDS = 256, 3  # the collectives' block per rank and rounds
TP_GRAD_NAMES = ("dWx", "dV", "dalpha", "dbeta", "da", "db", "du0", "dw0",
                 "ds0")
TP_UNREDUCED = ("dWx", "dV", "du0", "dw0", "ds0")  # no sum over rows


def tp_mesh(dev, P):
    from sparch_tpu_torch.parallel import make_mesh

    return make_mesh([dev] * P, model=P)


def phase_tp_collectives(dev):
    """Both exchange harnesses at B=128, Hl=256, 3 rounds, P = 1, 2, 4.
    Their path: one call of each entry point per P, with the counters set
    to 0 just before and read just after. Each result bit for bit against
    its plain version, and a second launch alike. Returns (launches, rows
    by P)."""
    from sparch_tpu_torch.ops import fused_cells, fused_tp
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    g = torch.Generator(device=dev).manual_seed(31)
    inputs = {P: (torch.randn((B, P * TP_HL), generator=g, device=dev),
                  torch.randn((P, B, P * TP_HL), generator=g, device=dev))
              for P in TP_PS}
    names = ("tp_all_gather", "tp_reduce_scatter")
    fused_cells.reset_launch_counts()
    got = {P: (fused_tp.tp_all_gather(x, num_devices=P, rounds=TP_ROUNDS),
               fused_tp.tp_reduce_scatter(parts, num_devices=P,
                                          rounds=TP_ROUNDS))
           for P, (x, parts) in inputs.items()}
    torch.cuda.synchronize()
    counts = fused_cells.launch_counts()
    want = {k: len(TP_PS) if k in names else 0 for k in counts}
    check(counts == want, f"tp_collectives: kernel launches {counts}")
    kernels = (fused_tp._tp_all_gather_cuda, fused_tp._tp_reduce_scatter_cuda)
    plains = (fused_tp.tp_all_gather_plain, fused_tp.tp_reduce_scatter_plain)
    rows = {}
    for P, args in inputs.items():
        kw = dict(num_devices=P, rounds=TP_ROUNDS)
        rows[P] = {}
        # the library call of each function's one round: the P shards
        # gathered by one torch.cat, the P partials reduced by one sum
        x, parts = args
        shards = [x[:, c] for c in fused_tp._shards(x.shape[1], P)]
        library = (lambda: torch.cat(shards, dim=1),
                   lambda: torch.sum(parts, dim=0))
        for name, arg, out, kernel, plain, lib in zip(
                names, args, got[P], kernels, plains, library):
            want_out = plain(arg, **kw)
            again = kernel(arg, **kw)
            torch.cuda.synchronize()
            check(torch.equal(out, want_out),
                  f"{name} P={P}: differs from its plain version")
            check(torch.equal(again, out),
                  f"{name} P={P}: two launches differ")
            rows[P][name] = dict(
                max_abs_err=float((out - want_out).abs().max()),
                plan=fused_tp.last_plans()[name],
                ms=cuda_time_ms(lambda: kernel(arg, **kw)),
                plain_ms=cuda_time_ms(lambda: plain(arg, **kw),
                                      **PLAIN_ROUNDS),
                library_ms=graph_ms(lib))
    emit("tp_collectives", batch_size=B, block_per_rank=TP_HL,
         rounds=TP_ROUNDS, one_card_form=True, bit_equal_to_plain=True,
         two_launches_bit_equal=True,
         launches={k: n for k, n in counts.items() if n},
         **{f"P{P}": r for P, r in rows.items()})
    return counts, rows


def tp_cell_inputs(shape, seed, dev, uniform_s0=False):
    """``cell_inputs`` (V on the 2^-8 grid, zero-diagonal) with the affine
    applied to the drive, as a TP layer applies its norm before the cell.
    ``uniform_s0``: s0 drawn from U[0, 1), as the uniform state init draws
    it, in place of 0/1 spikes."""
    d = cell_inputs(shape, dyadic=True, seed=seed, dev=dev)
    d["Wx"] = d["Wx"] * d["scale"] + d["shift"]
    if uniform_s0:
        d["s0"] = torch.rand(
            d["s0"].shape, device=dev,
            generator=torch.Generator(device=dev).manual_seed(seed + 4))
    return d


def _tp_args(name, d):
    ada = FORMS[name][1]
    return ((d["Wx"], d["alpha"], d["beta"] if ada else None,
             d["a"] if ada else None, d["b"] if ada else None, d["V"], 1.0,
             d["u0"], d["w0"] if ada else None, d["s0"]), ada)


def tp_shapes(P):
    """The main path's shape (B_eff = 2 * 128 bidirectional rows, T=100,
    H=1024) and a small one."""
    return ((2 * B, T, TP_H), (8, 13, P * 128))


def tp_cell_bounds(rate, b, t, h, bf16=False):
    """Bounds of the TP cell kernels over all ranks at (b, t, h): the
    training forward reads Wx and writes the spikes and the membrane series,
    reads V and the states; its s_full @ V[:, shard] adds one row of V's
    columns per spike. The backward reads g and the u series and writes
    dWx, reads V, writes dV, reads three states and writes three; it has
    two dense products of 2*b*t*h*h (the per-step adjoint and dV). In the
    bf16-stream mode the spikes, g, dWx and V are two bytes an element (Wx
    stays float32, as the model's norm emits it; the membrane series, dV
    and the states stay four) and the dense products are of bf16
    operands."""
    e = 2.0 if bf16 else 4.0
    f32 = 4.0 * b * t * h
    stream, mat, state = e * b * t * h, e * h * h, 4.0 * b * h
    products = 4.0 * b * t * h * h
    return dict(
        fwd=bound(2 * f32 + stream + mat + 3 * state,
                  16.0 * b * t * h + rate * b * t * h * h),
        bwd=bound(2 * stream + f32 + mat + 4.0 * h * h + 6 * state,
                  40.0 * b * t * h + (0.0 if bf16 else products),
                  products if bf16 else 0.0),
    )


def phase_tp_cell_forward(dev, bf16=False):
    """``tp_cell_fwd`` (RLIF, RadLIF) at P = 1, 2, 4 on the main path's
    shape and a small one: the spikes and the membrane series bit for bit
    against ``tp_cell_plain``, against the kernel at P = 1 (the split
    changes no sum) and against the single-card fused cell without the
    affine; the serving form (no residuals) alike. Times of the training
    form (the one the trainer launches) at the main shape beside the
    plain version's and the single-card kernel's. With ``bf16`` the
    bf16-stream form (``tp_cell_fwd_bf16``): s0 uniform, as the uniform
    state init draws it (the first product rounds it), a float32 drive at
    the main shape (the model's norm emits float32) and a bf16 one at the
    small shape, the same checks against the single-card bf16 kernel.
    Returns the RadLIF rows by P."""
    from sparch_tpu_torch.ops import fused_cells, fused_tp
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    ref, main = {}, {}
    for P in TP_PS:
        for shape in tp_shapes(P):
            for name in ("rlif", "radlif"):
                what = f"tp_cell_fwd {name} {shape} P={P}" + (
                    " bf16" if bf16 else "")
                d = tp_cell_inputs(shape, seed=1, dev=dev, uniform_s0=bf16)
                if bf16 and shape != tp_shapes(P)[0]:
                    d["Wx"] = d["Wx"].to(BF16)
                args, ada = _tp_args(name, d)
                kw = dict(num_devices=P, adaptive=ada, mxu_bf16=bf16)
                with torch.no_grad():
                    s, u = fused_tp._tp_cell_cuda(*args, **kw,
                                                  save_residuals=True)
                    plan = fused_tp.last_plans()["tp_cell_fwd"]
                    served = fused_tp._tp_cell_cuda(*args, **kw)
                    want, want_u = fused_tp.tp_cell_plain(
                        *args, **kw, save_residuals=True)
                    one, one_u = fused_cells._fused_cell_cuda(
                        args[0], None, None, *args[1:], recurrent=True,
                        adaptive=ada, save_residuals=True, mxu_bf16=bf16)
                torch.cuda.synchronize()
                check(s.dtype == (BF16 if bf16 else torch.float32) and
                      u.dtype == torch.float32, f"{what}: output types")
                check(torch.equal(s, want) and torch.equal(u, want_u),
                      f"{what}: differs from tp_cell_plain")
                check(torch.equal(served, want),
                      f"{what}: the serving form differs")
                check(torch.equal(s, one) and torch.equal(u, one_u),
                      f"{what}: differs from the single-card fused cell")
                row = dict(cell=name, shape=list(shape), P=P,
                           one_card_form=P > 1, plan=plan,
                           wx_dtype=str(args[0].dtype),
                           firing_rate=float(want.float().mean()),
                           max_abs_err=0.0, equals_plain_bit_for_bit=True,
                           equals_single_card_kernel=True)
                main_shape = shape == tp_shapes(P)[0]
                if main_shape:
                    if P == 1:
                        ref[name] = (s, u)
                    check(torch.equal(s, ref[name][0]) and
                          torch.equal(u, ref[name][1]),
                          f"{what}: differs from P=1")
                    row["equals_p1"] = True
                    with torch.no_grad():
                        row["ms"] = cuda_time_ms(
                            lambda: fused_tp._tp_cell_cuda(
                                *args, **kw, save_residuals=True))
                        row["plain_ms"] = cuda_time_ms(
                            lambda: fused_tp.tp_cell_plain(
                                *args, **kw, save_residuals=True),
                            **PLAIN_ROUNDS)
                        row["single_card_kernel_ms"] = cuda_time_ms(
                            lambda: fused_cells._fused_cell_cuda(
                                args[0], None, None, *args[1:],
                                recurrent=True, adaptive=ada,
                                save_residuals=True, mxu_bf16=bf16))
                        row["split_ms"] = split_ms_of(
                            lambda sp: fused_tp._tp_cell_cuda(
                                *args, **kw, save_residuals=True,
                                split_ms=sp), names=FWD_SPLIT_NAMES)
                    if name == "radlif":
                        main[P] = row
                emit("kernel_vs_plain",
                     kernel="tp_cell_fwd_bf16" if bf16 else "tp_cell_fwd",
                     **row)
    return main


def phase_tp_cell_backward(dev, bf16=False):
    """``tp_cell_bwd`` (RLIF, RadLIF) at P = 1, 2, 4 on the main path's
    shape and a small one, s0 uniform: both sides get the plain forward's
    residuals; every gradient against ``tp_cell_bwd_plain`` by the rule of
    phase 6 (``grads_within_bound``); two launches give the same bits; at
    P > 1 the gradients that sum over no rows equal P = 1's bit for bit,
    the others' gap is printed. Times at the main shape beside the plain
    version's and the single-card backward's (no affine, no dropout).
    With ``bf16`` the bf16-stream form (``tp_cell_bwd_bf16``): g bf16, the
    bounds of ``bf16_grad_bounds``, and every gradient also held against
    the single-card bf16 backward by those bounds, the ones that sum over no
    rows bit for bit. Returns the RadLIF rows by P."""
    from sparch_tpu_torch.ops import fused_cells, fused_tp
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    ref, main = {}, {}
    for P in TP_PS:
        for shape in tp_shapes(P):
            for name in ("rlif", "radlif"):
                what = f"tp_cell_bwd {name} {shape} P={P}" + (
                    " bf16" if bf16 else "")
                d = tp_cell_inputs(shape, seed=1, dev=dev, uniform_s0=True)
                args, ada = _tp_args(name, d)
                kw = dict(num_devices=P, adaptive=ada, mxu_bf16=bf16)
                g = torch.randn(shape, device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(6))
                if bf16:
                    g = g.to(BF16)
                with torch.no_grad():
                    _, u_seq = fused_tp.tp_cell_plain(*args, **kw,
                                                      save_residuals=True)
                bargs = (g, u_seq, *args[1:])

                def bwd(fn, f=lambda t: t):
                    return fn(*[f(a) if torch.is_tensor(a) else a
                                for a in bargs], **kw)

                with torch.no_grad():
                    got = bwd(fused_tp._tp_cell_bwd_cuda)
                    plan = fused_tp.last_bwd_plan()
                    again = bwd(fused_tp._tp_cell_bwd_cuda)
                    want = bwd(fused_tp.tp_cell_bwd_plain)
                    torch.cuda.synchronize()
                    def f64():
                        return bwd(fused_tp.tp_cell_bwd_plain,
                                   torch.Tensor.double)

                    bounds = bf16_grad_bounds(TP_GRAD_NAMES) if bf16 \
                        else None
                    errs = grads_within_bound(what, got, want, f64,
                                              names=TP_GRAD_NAMES,
                                              rel_max=bounds)
                    if bf16:
                        single = fused_cells._fused_cell_bwd_cuda(
                            g, args[0], u_seq, None, *args[1:],
                            recurrent=True, adaptive=ada, mxu_bf16=True)
                        single = [single[i] for i in (0, 3, 4, 5, 6, 7, 8, 9,
                                                      10)]
                        torch.cuda.synchronize()
                        single_errs = grads_within_bound(
                            f"{what} vs the single-card kernel", got, single,
                            f64, names=TP_GRAD_NAMES, rel_max=bounds)
                        # the gradients that sum over no rows: the same
                        # arithmetic in the same order
                        for n, x, z in zip(TP_GRAD_NAMES, got, single):
                            check(n not in TP_UNREDUCED or x is None or
                                  torch.equal(x, z),
                                  f"{what}: {n} differs from the "
                                  f"single-card kernel")
                for n, x, z in zip(TP_GRAD_NAMES, got, again):
                    check(x is None or torch.equal(x, z),
                          f"{what}: {n} differs between two launches")
                row = dict(cell=name, shape=list(shape), P=P,
                           one_card_form=P > 1, plan=plan, rel_err=errs,
                           two_launches_bit_equal=True,
                           max_abs_err=float((got[0].float()
                                              - want[0].float()).abs().max()))
                if bf16:
                    row["vs_single_card_kernel"] = single_errs
                if shape == tp_shapes(P)[0]:
                    if P == 1:
                        ref[name] = got
                    gap = {}
                    for n, x, r in zip(TP_GRAD_NAMES, got, ref[name]):
                        if x is None:
                            continue
                        gap[n] = rel_err(x, r)
                        check(n not in TP_UNREDUCED or torch.equal(x, r),
                              f"{what}: {n} differs from P=1")
                    row["vs_p1_rel_err"] = gap
                    with torch.no_grad():
                        row["ms"] = cuda_time_ms(
                            lambda: bwd(fused_tp._tp_cell_bwd_cuda))
                        row["plain_ms"] = cuda_time_ms(
                            lambda: bwd(fused_tp.tp_cell_bwd_plain),
                            **PLAIN_ROUNDS)
                        row["single_card_kernel_ms"] = cuda_time_ms(
                            lambda: fused_cells._fused_cell_bwd_cuda(
                                g, args[0], u_seq, None, *args[1:],
                                recurrent=True, adaptive=ada,
                                mxu_bf16=bf16))
                        if name == "radlif":
                            row["split_ms"] = split_ms_of(
                                lambda split: fused_tp._tp_cell_bwd_cuda(
                                    g, u_seq, *args[1:], **kw,
                                    split_ms=split))
                            row["dv_library_ms"] = dv_library_ms(*shape,
                                                                 dev)
                    if name == "radlif":
                        main[P] = row
                emit("kernel_vs_plain",
                     kernel="tp_cell_bwd_bf16" if bf16 else "tp_cell_bwd",
                     **row)
    return main


def tp_training_state():
    """State dict of the TP trainers: RadLIF [1024, 1024, 35]
    bidirectional from seed 0, V rounded onto a 2^-8 grid."""
    from sparch_tpu_torch.models import build_model

    model = build_model("RadLIF", (B, T, TP_F), list(TP_SIZES),
                        dropout=P_DROP, bidirectional=True, cell_impl="scan",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.hidden_layers():
            layer.V.copy_(torch.round(layer.V * 256.0) / 256.0)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def eval_tp(dev, state_dict, x, y, bf16=False):
    """One ``make_eval_step`` pass (zero state init) over the trained
    weights with V put back on the 2^-8 grid, for scan and for pallas_tp
    at P = 1, 2, 4, counters set to 0 just before each and read just
    after (one forward launch per layer). The probabilities (out / sum,
    as ``Predictor`` serves an SNN) of every P equal P = 1's and the
    plain versions' bit for bit, and the eval metrics alike; against
    scan by the rule of phase 4, with the scan model on the host CPU as
    the witness. ``bf16``: every model under ``compute_dtype=bfloat16``."""
    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.train import create_train_state, make_eval_step

    sd = {k: (torch.round(v * 256.0) / 256.0 if k.endswith(".V") else v)
          for k, v in state_dict.items()}

    def run(impl, P=None, device=dev, data=(x, y)):
        model = build_model("RadLIF", (B, T, TP_F), list(TP_SIZES),
                            bidirectional=True, state_init="zeros",
                            cell_impl=impl,
                            tp_mesh=tp_mesh(device, P) if P else None,
                            compute_dtype=BF16 if bf16 else None)
        model.load_state_dict(sd)
        state = create_train_state(model, LR, device=device)
        step = make_eval_step(model)
        fused_cells.reset_launch_counts()
        met = step(state, *data)
        counts = fused_cells.launch_counts()
        with torch.no_grad():
            out, _ = model(data[0])
        probs = (out / out.sum(dim=-1, keepdim=True)).cpu().numpy()
        met = {k: float(v) for k, v in met.items()}
        return (probs.argmax(-1), probs), met, counts

    rows = {}
    scan, scan_met, _ = run("scan")
    host, _, _ = run("scan", device=torch.device("cpu"),
                     data=(x.cpu(), y.cpu()))
    witness = _agreement(scan, host)
    label_min = witness["label_agreement"] - WITNESS_LABEL_MARGIN
    prob_max = max(WITNESS_PROB_FACTOR * witness["max_abs_prob_diff"], 1e-3)
    first = None
    fwd_name = "tp_cell_fwd_bf16" if bf16 else "tp_cell_fwd"
    for P in TP_PS:
        what = f"eval pallas_tp P={P}" + (" bf16" if bf16 else "")
        got, met, counts = run("pallas_tp", P)
        want = {k: 2 if k == fwd_name else 0 for k in counts}
        check(counts == want, f"{what}: kernel launches {counts}")
        with plain_versions():
            plain, plain_met, _ = run("pallas_tp", P)
        check(np.array_equal(got[1], plain[1]) and met == plain_met,
              f"{what}: differs from the plain versions")
        first = first or got
        check(np.array_equal(got[1], first[1]), f"{what}: differs from P=1")
        agree = _agreement(got, scan)
        check(agree["label_agreement"] >= label_min and
              agree["max_abs_prob_diff"] <= prob_max,
              f"{what}: vs scan {agree}, witness {witness}")
        rows[f"pallas_tp_p{P}"] = dict(
            metrics=met, launches={k: n for k, n in counts.items() if n},
            equals_plain_versions=True, equals_p1=True, vs_scan=agree)
    rows["scan"] = dict(metrics=scan_met, scan_card_vs_cpu=witness,
                        vs_scan_label_min=label_min,
                        vs_scan_prob_max=prob_max)
    return rows


def phase_training_tp(dev, bf16=False):
    """The TP training main path: RadLIF [1024, 1024, 35] bidirectional
    (batchnorm, dropout 0.1, uniform state init, Adam lr 1e-2) on one
    device-resident batch of 128 SC-shaped utterances (F=40 features drawn
    normal(0, 1)), ``scan`` and ``pallas_tp`` at P = 1, 2, 4 from one state
    dict and seed, each checked and timed as phase 8 (two forward and two
    backward TP launches per step, no other kernel), beside an ``auto``
    twin (the single-card kernels at (256, 100, 1024), two launches of each
    a step); P = 2 and 4 against P = 1 (step-1 gradients within
    GRAD_REL_MAX, the largest gap printed); then ``eval_tp``. With ``bf16``
    every trainer under ``compute_dtype=bfloat16`` (the TP kernels'
    bf16-stream form), the ``scan`` twin for 5 steps, step-1 gradients
    against the plain versions within BF16_ULP (else the float64 witness
    rule), and ``vs_float32_tp``: the float32 P = 1 trainer's losses and its
    step-1 gradients' distance, printed, not bounded. Returns the launch
    counts of each P's run, and of the ``auto`` twin's under "auto"."""
    state_dict = tp_training_state()
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((B, T, TP_F), generator=gen, device=dev)
    y = torch.randint(0, C, (B,), generator=gen, device=dev)
    sfx = "_bf16" if bf16 else ""
    per_step = {f"tp_cell_fwd{sfx}": 2, f"tp_cell_bwd{sfx}": 2}
    rows, launches, kept = {}, {}, {}
    common = dict(sizes=TP_SIZES, bidirectional=True)
    if bf16:
        common.update(compute_dtype=BF16, grad_rel_max=BF16_ULP)
    rows["scan"], _ = train_variant(dev, "scan", state_dict, x, y, {}, None,
                                    steps=5 if bf16 else TRAIN_STEPS,
                                    **common)
    rows["auto"], launches["auto"] = train_variant(
        dev, "auto", state_dict, x, y,
        {f"fused_cell_fwd_train{sfx}": 2, f"fused_cell_bwd{sfx}": 2,
         "readout_fwd": 1, "readout_bwd": 1},
        rows["scan"], **common)
    for P in TP_PS:
        kept[P] = {}
        rows[f"pallas_tp_p{P}"], launches[P] = train_variant(
            dev, "pallas_tp", state_dict, x, y, per_step, rows["scan"],
            keep=kept[P], tp_mesh=tp_mesh(dev, P), **common)
        if P > 1:
            gaps = {k: rel_err(v, kept[1]["grads"][k])
                    for k, v in kept[P]["grads"].items()}
            worst = max(gaps, key=gaps.get)
            rows[f"pallas_tp_p{P}"]["vs_p1_step1_grads"] = dict(
                max_rel_err=gaps[worst], at=worst, bound=GRAD_REL_MAX)
            check(gaps[worst] <= GRAD_REL_MAX,
                  f"pallas_tp P={P}: step-1 gradient of {worst} is "
                  f"{gaps[worst]} from P=1's")
    if bf16:
        rows["vs_float32_tp"] = vs_float32_tp(
            dev, state_dict, x, y, kept[1], model_type="RadLIF",
            sizes=TP_SIZES, bidirectional=True)
    rows["eval"] = eval_tp(dev, kept[1]["state_dict"], x, y, bf16=bf16)
    emit("training_tp" + sfx, model="RadLIF [1024, 1024, 35] bidirectional",
         compute_dtype="bfloat16" if bf16 else "float32", batch_size=B, T=T,
         F=TP_F, dropout=P_DROP, lr=LR, steps=TRAIN_STEPS,
         one_card_form="P > 1", **rows)
    return launches


def vs_float32_tp(dev, state_dict, x, y, kept, **run):
    """The float32 ``pallas_tp`` P = 1 trainer beside a bf16 one (``kept``:
    its step-1 gradients): the float32 losses over TRAIN_STEPS steps and the
    largest step-1 gradient distance, relative to the float32 gradient's
    largest magnitude. Printed, not bounded: the mode moves the answers."""
    _, _, losses, grads, _ = train_run(dev, "pallas_tp", state_dict, x, y,
                                       TRAIN_STEPS, tp_mesh=tp_mesh(dev, 1),
                                       **run)
    gaps = {k: rel_err(kept["grads"][k], v) for k, v in grads.items()}
    worst = max(gaps, key=gaps.get)
    return dict(float32_losses=losses, step1_grad_max_rel_diff=gaps[worst],
                at=worst)


def tp_kernel_rows(coll_launches, coll, fwd, bwd, trained):
    """The ``kernels`` entries of the TP path. Times at P = 4 (all four
    ranks in one launch on the one card), each P's beside it; launches:
    the collectives' path (one call per P) and the P = 4 trainer's run."""
    src = "sparch_tpu_torch/csrc/"
    tpu = "sparch_tpu/ops/pallas_tp.py:"
    P = TP_PS[-1]
    h = P * TP_HL
    coll_bounds = {
        "tp_all_gather": bound(4.0 * B * h * (1 + P * TP_ROUNDS),
                               TP_ROUNDS * B * h),
        "tp_reduce_scatter": bound(4.0 * B * h * (P + TP_ROUNDS),
                                   TP_ROUNDS * P * B * h),
    }
    rows = []
    for name, line in (("tp_all_gather", "180"),
                       ("tp_reduce_scatter", "241")):
        r = coll[P][name]
        rows.append(dict(
            name=name, route="cuda", source=src + "tp_collectives.cu",
            replaces=tpu + line, launches=coll_launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            **coll_bounds[name], library_ms=r["library_ms"],
            library_rounds=1, one_card_form=True, P=P, shape=[B, h],
            rounds=TP_ROUNDS,
            ms_by_p={q: coll[q][name]["ms"] for q in TP_PS},
            plain_ms_by_p={q: coll[q][name]["plain_ms"] for q in TP_PS}))
    return rows + tp_cell_rows(fwd, bwd, trained)


def tp_cell_rows(fwd, bwd, trained, bf16=False):
    """The ``kernels`` entries of the TP cells in one stream mode: times at
    P = 4, each P's beside them; launches: the P = 4 trainer's run."""
    src = "sparch_tpu_torch/csrc/"
    tpu = "sparch_tpu/ops/pallas_tp.py:"
    P = TP_PS[-1]
    sfx = "_bf16" if bf16 else ""
    tb = tp_cell_bounds(fwd[P]["firing_rate"], 2 * B, T, TP_H, bf16=bf16)
    rows = []
    for name, line, main, b in (("tp_cell_fwd", "350", fwd, tb["fwd"]),
                                ("tp_cell_bwd", "448", bwd, tb["bwd"])):
        rows.append(dict(
            name=name + sfx, route="cuda", source=src + name + ".cu",
            replaces=tpu + line, launches=trained[P][name + sfx],
            max_abs_err=main[P]["max_abs_err"], ms=main[P]["ms"],
            plain_ms=main[P]["plain_ms"], **b, library_ms=None,
            one_card_form=True, P=P, shape=[2 * B, T, TP_H],
            ms_by_p={q: main[q]["ms"] for q in TP_PS},
            plain_ms_by_p={q: main[q]["plain_ms"] for q in TP_PS},
            single_card_kernel_ms=main[1]["single_card_kernel_ms"],
            launches_by_p={q: trained[q][name + sfx] for q in TP_PS},
            split_ms=main[P]["split_ms"],
            split_ms_by_p={q: main[q]["split_ms"] for q in TP_PS},
            plan_by_p={q: main[q]["plan"] for q in TP_PS},
            **({} if name == "tp_cell_fwd" else dict(
                dv_library_ms=main[P]["dv_library_ms"]))))
    return rows


# ---------------------------------------------------------------------------
# The tensor-parallel non-spiking path: cell_impl='pallas_tp' for RNN, LiGRU
# and GRU, one-card form
# ---------------------------------------------------------------------------

TP_ANN_PER_STEP = {"tp_ann_fwd": 2, "tp_ann_bwd": 2}  # two hidden layers


def tp_ann_inputs(mode, shape, seed, dev):
    """``ann_inputs`` without the affine (a TP layer applies its norm before
    the cell), the recurrent matrices orthogonal * 0.5: the conditioning
    tests/test_pallas_tp_ann.py keeps for the LiGRU's relu candidate."""
    d = ann_inputs(mode, shape, seed, dev)
    return dict(wxs=d["wxs"], vs=[0.5 * v for v in d["vs"]], y0=d["y0"])


def tp_ann_grad_names(mode):
    from sparch_tpu_torch.ops import fused_ann

    gates = ("", "z", "r")[:fused_ann.MODES[mode]]
    return tuple(f"d{k}{g}" for k in ("Wx", "V") for g in gates) + ("dy0",)


def _double(ts):
    return [t.double() for t in ts]


def phase_tp_ann_forward(dev, bf16=False):
    """``tp_ann_fwd`` (RNN, LiGRU, GRU) at P = 1, 2, 4 on the main path's
    shape (128, 100, 1024): the output and the gate series against
    ``tp_ann_cell_plain`` by the rule of phase 9 (``series_within_bound``),
    the serving form alike; the kernel's output and series bit for bit
    across P, equal to the single-card ``fused_ann_fwd`` without the affine
    and the dropout (every product sums its Hg terms in one ascending
    order), and two launches alike. Times of the training form (the one the
    trainer launches) and the serving form beside the plain version's and
    the single-card kernel's. With ``bf16`` the bf16-stream form
    (``tp_ann_fwd_bf16``, float32 input streams as the model's norm emits
    them): every series within one bf16 ulp (BF16_ULP relative to
    max(1, |value|)) of the plain version's, else the float64 witness rule,
    and the same bit-for-bit checks against the single-card bf16 kernel.
    Returns the rows by mode and P."""
    from sparch_tpu_torch.ops import fused_ann, fused_tp_ann
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    shape = (B, T, TP_H)
    main = {}
    mkw = dict(mxu_bf16=bf16)
    atol = BF16_ULP if bf16 else ANN_ATOL
    for mode in ANN_TYPES:
        d = tp_ann_inputs(mode, shape, 4, dev)
        args = (mode, d["wxs"], d["vs"], d["y0"])
        args64 = (mode, _double(d["wxs"]), _double(d["vs"]), d["y0"].double())
        names = ("y",) + fused_tp_ann._MODES[mode]["gates"]

        def flat(r):
            return (r[0], *r[1])

        def single_card():
            out, _, gates = fused_ann._ann_cell_cuda(
                mode, d["wxs"], None, None, d["vs"], d["y0"],
                save_residuals=True, **mkw)
            return (out, *gates)

        with torch.no_grad():
            single = single_card()
        main[mode] = dict(single_card_kernel_ms=cuda_time_ms(
            single_card, warmup=1, iters=5, repeats=3))
        ref = None
        for P in TP_PS:
            what = f"tp_ann_fwd {mode} {shape} P={P}" + (
                " bf16" if bf16 else "")
            kw = dict(num_devices=P, **mkw)
            with torch.no_grad():
                got = flat(fused_tp_ann._tp_ann_cell_cuda(
                    *args, **kw, save_residuals=True))
                plan = fused_tp_ann.last_plan("tp_ann_fwd")
                again = flat(fused_tp_ann._tp_ann_cell_cuda(
                    *args, **kw, save_residuals=True))
                served = fused_tp_ann._tp_ann_cell_cuda(*args, **kw)
                want = flat(fused_tp_ann.tp_ann_cell_plain(
                    *args, **kw, save_residuals=True))
                torch.cuda.synchronize()
                errs = series_within_bound(
                    what, names, (atol,) * len(names), got, want,
                    lambda: flat(fused_tp_ann.tp_ann_cell_plain(
                        *args64, **kw, save_residuals=True)), relative=bf16)
            ref = ref or got
            for n, x, z, r, s1 in zip(names, got, again, ref, single):
                check(torch.equal(x, z), f"{what}: {n} differs between two "
                                         f"launches")
                check(torch.equal(x, r), f"{what}: {n} differs from P=1")
                check(torch.equal(x, s1), f"{what}: {n} differs from the "
                                          f"single-card kernel")
            check(torch.equal(served, got[0]),
                  f"{what}: the serving form differs")
            row = dict(cell=mode, shape=list(shape), P=P,
                       one_card_form=P > 1, plan=plan, abs_err=errs,
                       max_abs_err=max(e["vs_plain"] for e in errs.values()),
                       two_launches_bit_equal=True, equals_p1=True,
                       equals_single_card_kernel=True)
            with torch.no_grad():
                row["ms"] = cuda_time_ms(
                    lambda: fused_tp_ann._tp_ann_cell_cuda(
                        *args, **kw, save_residuals=True),
                    warmup=1, iters=5, repeats=3)
                row["ms_serving"] = cuda_time_ms(
                    lambda: fused_tp_ann._tp_ann_cell_cuda(*args, **kw),
                    warmup=1, iters=5, repeats=3)
                row["plain_ms"] = cuda_time_ms(
                    lambda: fused_tp_ann.tp_ann_cell_plain(
                        *args, **kw, save_residuals=True), **PLAIN_ROUNDS)
            row["single_card_kernel_ms"] = main[mode]["single_card_kernel_ms"]
            main[mode][P] = row
            emit("kernel_vs_plain",
                 kernel="tp_ann_fwd_bf16" if bf16 else "tp_ann_fwd", **row)
    return main


def phase_tp_ann_backward(dev, bf16=False):
    """``tp_ann_bwd`` (RNN, LiGRU, GRU) at P = 1, 2, 4 on the main path's
    shape: both sides get the plain forward's residuals; every gradient
    (per gate dWx and dV; dy0) against ``tp_ann_cell_bwd_plain`` by the rule
    of phase 6 (``grads_within_bound``); two launches bit-equal; every
    gradient bit for bit across P and equal to the single-card
    ``fused_ann_bwd`` without the affine and the dropout. Times beside the
    plain version's and the single-card kernel's. With ``bf16`` the
    bf16-stream form (``tp_ann_bwd_bf16``: g and the series bf16) by the
    bounds of ``bf16_grad_bounds``. Returns the rows by mode and P."""
    from sparch_tpu_torch.ops import fused_ann, fused_tp_ann
    from sparch_tpu_torch.utils.timing import cuda_time_ms

    shape = (B, T, TP_H)
    main = {}
    mkw = dict(mxu_bf16=bf16)
    for mode in ANN_TYPES:
        d = tp_ann_inputs(mode, shape, 4, dev)
        g = torch.randn(shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
        if bf16:
            g = g.to(BF16)
        names = tp_ann_grad_names(mode)
        with torch.no_grad():
            out, gates = fused_tp_ann.tp_ann_cell_plain(
                mode, d["wxs"], d["vs"], d["y0"], num_devices=1,
                save_residuals=True, **mkw)
        bargs = (mode, g, out, gates, d["vs"], d["y0"])
        bargs64 = (mode, g.double(), out.double(), _double(gates),
                   _double(d["vs"]), d["y0"].double())

        def flat(r):
            return (*r[0], *r[1], r[2])

        def single_card():
            dwxs, _, _, dvs, dy0 = fused_ann._ann_cell_bwd_cuda(
                mode, g, None, out, list(gates), None, d["vs"], d["y0"],
                **mkw)
            return (*dwxs, *dvs, dy0)

        with torch.no_grad():
            single = single_card()
        main[mode] = dict(single_card_kernel_ms=cuda_time_ms(
            single_card, warmup=1, iters=5, repeats=3))
        ref = None
        for P in TP_PS:
            what = f"tp_ann_bwd {mode} {shape} P={P}" + (
                " bf16" if bf16 else "")
            kw = dict(num_devices=P, **mkw)
            with torch.no_grad():
                got = flat(fused_tp_ann._tp_ann_cell_bwd_cuda(*bargs, **kw))
                plan = fused_tp_ann.last_plan("tp_ann_bwd")
                again = flat(fused_tp_ann._tp_ann_cell_bwd_cuda(*bargs, **kw))
                want = flat(fused_tp_ann.tp_ann_cell_bwd_plain(*bargs, **kw))
                torch.cuda.synchronize()
                errs = grads_within_bound(
                    what, got, want,
                    lambda: flat(fused_tp_ann.tp_ann_cell_bwd_plain(
                        *bargs64, **kw)), names=names,
                    rel_max=bf16_grad_bounds(names) if bf16 else None)
            ref = ref or got
            for n, x, z, r, s1 in zip(names, got, again, ref, single):
                check(torch.equal(x, z), f"{what}: {n} differs between two "
                                         f"launches")
                check(torch.equal(x, r), f"{what}: {n} differs from P=1")
                check(torch.equal(x, s1), f"{what}: {n} differs from the "
                                          f"single-card kernel")
            row = dict(cell=mode, shape=list(shape), P=P,
                       one_card_form=P > 1, plan=plan, rel_err=errs,
                       max_abs_err=float((got[0].float()
                                          - want[0].float()).abs().max()),
                       two_launches_bit_equal=True, equals_p1=True,
                       equals_single_card_kernel=True)
            with torch.no_grad():
                row["ms"] = cuda_time_ms(
                    lambda: fused_tp_ann._tp_ann_cell_bwd_cuda(*bargs, **kw),
                    warmup=1, iters=5, repeats=3)
                row["split_ms"] = split_ms_of(
                    lambda split: fused_tp_ann._tp_ann_cell_bwd_cuda(
                        *bargs, **kw, split_ms=split))
                row["dv_library_ms"] = dv_library_ms(
                    *shape, dev, len(ANN_GATES[mode]))
                row["plain_ms"] = cuda_time_ms(
                    lambda: fused_tp_ann.tp_ann_cell_bwd_plain(*bargs, **kw),
                    **PLAIN_ROUNDS)
            row["single_card_kernel_ms"] = main[mode]["single_card_kernel_ms"]
            main[mode][P] = row
            emit("kernel_vs_plain",
                 kernel="tp_ann_bwd_bf16" if bf16 else "tp_ann_bwd", **row)
    return main


def tp_ann_state(ann_type):
    """State dict of a TP ANN trainer: [1024, 1024, 35] from seed 0."""
    from sparch_tpu_torch.models import build_model

    return build_model(ann_type, (B, T, TP_F), list(TP_SIZES),
                       dropout=P_DROP,
                       generator=torch.Generator().manual_seed(0)).state_dict()


def eval_tp_ann(dev, state_dict, x, y, bf16=False):
    """One ``make_eval_step`` pass of the GRU over the trained weights, for
    scan and for pallas_tp at P = 1, 2, 4, counters set to 0 just before
    each and read just after (one forward launch per layer). The
    probabilities (the softmax of the logits, as ``Predictor`` serves an
    ANN) of every P equal P = 1's bit for bit; against the plain versions
    and against scan by the rule of phase 4, with the scan model on the host
    CPU as the witness. ``bf16``: every model under
    ``compute_dtype=bfloat16``, held against the plain versions as
    ``serve_bf16`` holds the served bf16 GRU (labels on >= 99 %,
    probabilities within BF16_PROB_MAX, else the float64 witness rule: a
    summing order tips bf16 roundings that the readout's average does not
    undo), its distance from scan printed, not bounded."""
    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.ops import fused_cells
    from sparch_tpu_torch.train import create_train_state, make_eval_step

    def run(impl, P=None, device=dev, data=(x, y), dtype=torch.float32):
        model = build_model("GRU", (B, T, TP_F), list(TP_SIZES),
                            cell_impl=impl,
                            tp_mesh=tp_mesh(device, P) if P else None,
                            compute_dtype=BF16 if bf16 else None)
        model.load_state_dict(state_dict)
        model.to(dtype)
        data = (data[0].to(dtype), data[1])
        state = create_train_state(model, LR, device=device)
        step = make_eval_step(model)
        fused_cells.reset_launch_counts()
        met = step(state, *data)
        counts = fused_cells.launch_counts()
        with torch.no_grad():
            out, _ = model(data[0])
        probs = torch.softmax(out, dim=-1).cpu().numpy()
        met = {k: float(v) for k, v in met.items()}
        return (probs.argmax(-1), probs), met, counts

    rows = {}
    scan, scan_met, _ = run("scan")
    host, _, _ = run("scan", device=torch.device("cpu"),
                     data=(x.cpu(), y.cpu()))
    witness = _agreement(scan, host)
    label_min = witness["label_agreement"] - WITNESS_LABEL_MARGIN
    prob_max = max(WITNESS_PROB_FACTOR * witness["max_abs_prob_diff"], 1e-3)
    first = None
    fwd_name = "tp_ann_fwd_bf16" if bf16 else "tp_ann_fwd"
    for P in TP_PS:
        what = f"eval GRU pallas_tp P={P}" + (" bf16" if bf16 else "")
        got, met, counts = run("pallas_tp", P)
        want = {k: 2 if k == fwd_name else 0 for k in counts}
        check(counts == want, f"{what}: kernel launches {counts}")
        with plain_versions():
            plain, _, _ = run("pallas_tp", P)
        first = first or got
        check(np.array_equal(got[1], first[1]), f"{what}: differs from P=1")
        agree = {"plain_versions": _agreement(got, plain),
                 "scan": _agreement(got, scan)}
        row = dict(metrics=met,
                   launches={k: n for k, n in counts.items() if n},
                   equals_p1=True, vs_plain_versions=agree["plain_versions"],
                   vs_scan=agree["scan"])
        for k, a in agree.items():
            if not bf16:
                check(a["label_agreement"] >= label_min and
                      a["max_abs_prob_diff"] <= prob_max,
                      f"{what}: vs {k} {a}, witness {witness}")
            elif k == "plain_versions" and not (
                    a["label_agreement"] >= 0.99 and
                    a["max_abs_prob_diff"] <= BF16_PROB_MAX):
                with plain_versions():
                    truth = run("pallas_tp", P, dtype=torch.float64)[0]
                w = row["f64_witness"] = dict(
                    kernel_vs_f64=_agreement(got, truth),
                    plain_vs_f64=_agreement(plain, truth))
                check(w["kernel_vs_f64"]["label_agreement"]
                      >= w["plain_vs_f64"]["label_agreement"]
                      - WITNESS_LABEL_MARGIN and
                      w["kernel_vs_f64"]["max_abs_prob_diff"]
                      <= WITNESS_PROB_FACTOR
                      * w["plain_vs_f64"]["max_abs_prob_diff"],
                      f"{what}: vs the plain versions {a}, {w}")
        rows[f"pallas_tp_p{P}"] = row
    rows["scan"] = dict(metrics=scan_met, scan_card_vs_cpu=witness,
                        vs_label_min=label_min, vs_prob_max=prob_max)
    return rows


def phase_training_tp_ann(dev, bf16=False):
    """The TP non-spiking training main path: GRU [1024, 1024, 35]
    (batchnorm, dropout 0.1, Adam lr 1e-2) on one device-resident batch of
    128 SC-shaped utterances (F=40 features drawn normal(0, 1)), ``scan``,
    ``auto`` and ``pallas_tp`` at P = 1, 2, 4 from one state dict and seed,
    each checked and timed as phase 8 (two TP forward and two TP backward
    launches per step, no other kernel); P = 2 and 4 against P = 1 (step-1
    gradients within GRAD_REL_MAX); then ``eval_tp_ann``. LiGRU and RNN at
    the same width: ``auto`` and ``pallas_tp`` at P = 2 for three steps at
    lr 1e-3, checked alike, the step-1 loss within 10 % of the ``auto``
    twin's (the two draw other dropout masks). At lr 1e-2 the LiGRU [1024,
    1024, 35] diverges on every path, the plain scan on the host CPU
    included: Adam's first steps move each entry of V by about lr, so the
    unbounded relu candidate explodes by the third step; at 1e-3 its loss
    falls 4.11 -> 0.59 in three steps. With ``bf16`` every trainer under
    ``compute_dtype=bfloat16`` (the TP kernels' bf16-stream form), the GRU's
    ``scan`` twin for 5 steps, step-1 gradients against the plain versions
    within BF16_ULP (else the float64 witness rule), and
    ``vs_float32_tp`` as in ``phase_training_tp``. Returns the launch
    counts of each run."""
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((B, T, TP_F), generator=gen, device=dev)
    y = torch.randint(0, C, (B,), generator=gen, device=dev)
    sfx = "_bf16" if bf16 else ""
    per_step = {f"{k}{sfx}": n for k, n in TP_ANN_PER_STEP.items()}
    launches = {}
    for mode in ("gru", "ligru", "rnn"):
        ann_type = ANN_TYPES[mode]
        state_dict = tp_ann_state(ann_type)
        main = mode == "gru"
        ps = TP_PS if main else (2,)
        common = dict(model_type=ann_type, sizes=TP_SIZES,
                      steps=TRAIN_STEPS if main else 3, timed=main,
                      lr=LR if main else 1e-3,
                      grad_rel_max=KINK_GRAD_REL_MAX if mode == "ligru"
                      else BF16_ULP if bf16 else GRAD_REL_MAX)
        if bf16:
            common.update(compute_dtype=BF16)
        rows, kept = {}, {}
        if main:
            rows["scan"], _ = train_variant(
                dev, "scan", state_dict, x, y, {}, None,
                **dict(common, steps=5) if bf16 else common)
        rows["auto"], _ = train_variant(
            dev, "auto", state_dict, x, y,
            {f"fused_ann_fwd_{mode}{sfx}": 2,
             f"fused_ann_bwd_{mode}{sfx}": 2}, rows.get("scan"), **common)
        for P in ps:
            kept[P] = {}
            key = f"pallas_tp_p{P}"
            rows[key], launches[(mode, P)] = train_variant(
                dev, "pallas_tp", state_dict, x, y, per_step,
                rows.get("scan"), keep=kept[P], tp_mesh=tp_mesh(dev, P),
                **common)
            auto_loss = rows["auto"]["losses"][0]
            rows[key]["vs_auto_step1_loss_rel_diff"] = rel = \
                abs(rows[key]["losses"][0] - auto_loss) / auto_loss
            check(rel <= 0.1, f"{ann_type} pallas_tp P={P}: step-1 loss "
                              f"{rows[key]['losses'][0]} vs auto's "
                              f"{auto_loss}")
            if P > 1 and main:
                gaps = {k: rel_err(v, kept[1]["grads"][k])
                        for k, v in kept[P]["grads"].items()}
                worst = max(gaps, key=gaps.get)
                rows[key]["vs_p1_step1_grads"] = dict(
                    max_rel_err=gaps[worst], at=worst, bound=GRAD_REL_MAX)
                check(gaps[worst] <= GRAD_REL_MAX,
                      f"{ann_type} pallas_tp P={P}: step-1 gradient of "
                      f"{worst} is {gaps[worst]} from P=1's")
        if main and bf16:
            rows["vs_float32_tp"] = vs_float32_tp(
                dev, state_dict, x, y, kept[1], model_type=ann_type,
                sizes=TP_SIZES)
        if main:
            rows["eval"] = eval_tp_ann(dev, kept[1]["state_dict"], x, y,
                                       bf16=bf16)
        emit("training_tp_ann" + sfx, model=f"{ann_type} [1024, 1024, 35]",
             compute_dtype="bfloat16" if bf16 else "float32", batch_size=B,
             T=T, F=TP_F, dropout=P_DROP, lr=common["lr"],
             steps=common["steps"], one_card_form="P > 1", **rows)
    return launches


def tp_ann_bounds(mode, b, t, h, bf16=False):
    """Bounds of the TP ANN kernels over all ranks at (b, t, h): the
    training forward reads the input streams and writes the output and the
    gate series, reads the matrices and y0; one dense product of 2*b*t*h*h
    per gate. The backward reads g, the y and gate series, y0 and the
    matrices, writes dWx per gate, dV and dy0; two dense products per gate
    (the per-step adjoint and dV). In the bf16-stream mode the output, the
    series, g, dWx and the matrices are two bytes an element (the input
    streams stay float32, as the model's norm emits them; dV and the states
    stay four) and the dense products are of bf16 operands."""
    from sparch_tpu_torch.ops import fused_ann

    n = fused_ann.MODES[mode]
    series = len(fused_ann._GATE_SERIES[mode])
    e = 2.0 if bf16 else 4.0
    f32 = 4.0 * b * t * h
    stream, mat, state = e * b * t * h, e * h * h, 4.0 * b * h
    products = n * 2.0 * b * t * h * h

    def ops(count, elementwise):
        return (elementwise + (0.0 if bf16 else count * products),
                count * products if bf16 else 0.0)

    return dict(
        fwd=bound(n * f32 + (1 + series) * stream + n * mat + state,
                  *ops(1, 12.0 * n * b * t * h)),
        bwd=bound((2 + series + n) * stream + n * mat + n * 4.0 * h * h
                  + 2 * state, *ops(2, 30.0 * n * b * t * h)),
    )


def tp_ann_exchanges(mode, direction, plan):
    """The exchanges on one cluster's chain: T - 1 a walk in the RNN's and
    the LiGRU's forward (the last y gather feeds nothing), 2T - 1 in the
    GRU's; T and 2T in the backward; times the row groups it walks."""
    per_walk = (2 * T if mode == "gru" else T) - (direction == "fwd")
    return plan["walks"] * per_walk


def exchange_us(mode, direction, rows):
    """Per P > 1: the kernel's time at P less its time at P = 1, over the
    exchanges on a cluster's chain at P. The plans differ across P (the
    cluster size, the rows a cluster), so this bounds what an exchange
    costs beside what the plan moves."""
    return {q: (rows[q]["ms"] - rows[1]["ms"]) * 1e3
            / tp_ann_exchanges(mode, direction, rows[q]["plan"])
            for q in TP_PS if q > 1}


def tp_ann_kernel_rows(fwd, bwd, trained, bf16=False):
    """The ``kernels`` entries of the TP ANN path in one stream mode: the
    GRU at P = 4 (all four ranks in one launch on the one card), each P's
    and each mode's beside it, with the plan each P ran, ``exchange_us``
    per P and (backward) ``split_ms``; launches: the P = 4 GRU trainer's
    run, and the P = 2 runs of the LiGRU and the RNN by mode."""
    src = "sparch_tpu_torch/csrc/"
    tpu = "sparch_tpu/ops/pallas_tp_ann.py:"
    P = TP_PS[-1]
    sfx = "_bf16" if bf16 else ""
    rows = []
    for name, line, res in (("tp_ann_fwd", "126", fwd),
                            ("tp_ann_bwd", "326", bwd)):
        direction = name[-3:]
        by_mode = {}
        for mode in ANN_TYPES:
            ps = TP_PS if mode == "gru" else (2,)
            by_mode[mode] = dict(
                ms_by_p={q: res[mode][q]["ms"] for q in TP_PS},
                plain_ms_by_p={q: res[mode][q]["plain_ms"] for q in TP_PS},
                max_abs_err=max(res[mode][q]["max_abs_err"] for q in TP_PS),
                single_card_kernel_ms=res[mode]["single_card_kernel_ms"],
                launches_by_p={q: trained[(mode, q)][name + sfx]
                               for q in ps},
                plan_by_p={q: res[mode][q]["plan"] for q in TP_PS},
                exchange_us_by_p=exchange_us(mode, direction, res[mode]),
                **tp_ann_bounds(mode, B, T, TP_H, bf16=bf16)[direction])
            if direction == "bwd":
                by_mode[mode]["split_ms_by_p"] = {
                    q: res[mode][q]["split_ms"] for q in TP_PS}
                by_mode[mode]["dv_library_ms"] = res[mode][P][
                    "dv_library_ms"]
            if direction == "fwd":
                by_mode[mode]["ms_serving_by_p"] = {
                    q: res[mode][q]["ms_serving"] for q in TP_PS}
        main = res["gru"][P]
        rows.append(dict(
            name=name + sfx, route="cuda", source=src + name + ".cu",
            replaces=tpu + line, launches=trained[("gru", P)][name + sfx],
            max_abs_err=main["max_abs_err"], ms=main["ms"],
            plain_ms=main["plain_ms"],
            **tp_ann_bounds("gru", B, T, TP_H, bf16=bf16)[direction],
            library_ms=None,
            one_card_form=True, P=P, mode="gru", shape=[B, T, TP_H],
            ms_by_p=by_mode["gru"]["ms_by_p"], plan=main["plan"],
            plan_by_p=by_mode["gru"]["plan_by_p"],
            exchange_us_by_p=by_mode["gru"]["exchange_us_by_p"],
            **({"split_ms": main["split_ms"],
                "dv_library_ms": main["dv_library_ms"]}
               if direction == "bwd" else {}),
            single_card_kernel_ms=main["single_card_kernel_ms"],
            by_mode=by_mode))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    seconds = {}

    def run(name, phase, *args, **kw):
        t0 = time.perf_counter()
        result = phase(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return result

    smi = run("device", phase_device)
    cell = run("fused_cell", phase_fused_cell, dev)
    readout = run("readout", phase_readout, dev)
    fwd_train, hashed = run("train_forward", phase_train_forward, dev)
    bwd = run("backward", phase_backward, dev)
    readout_bwd = run("readout_backward", phase_readout_backward, dev)
    run("readout_wide", phase_readout_wide, dev)
    launches = run("serving", phase_serving, dev)
    trained, trained_auto = run("training", phase_training, dev)
    experiment = run("experiment", phase_experiment, dev, trained_auto)
    audio_root = Path(tempfile.mkdtemp(prefix="chip_smoke_audio_"))
    try:
        audio = run("audio", phase_audio, dev, smi, audio_root)
        run("streaming", phase_streaming, dev, smi)
        migrated = run("migrate", phase_migrate, dev, smi, audio_root)
    finally:
        shutil.rmtree(audio_root, ignore_errors=True)
    run("fuzz", phase_fuzz, dev, smi)
    ann_fwd = run("ann_forward", phase_ann_forward, dev)
    ann_bwd = run("ann_backward", phase_ann_backward, dev)
    ann_served = run("serving_ann", phase_serving_ann, dev)
    ann_trained = run("training_ann", phase_training_ann, dev)
    bf16_cell = run("bf16_cell_forward", phase_bf16_cell_forward, dev)
    bf16_bwd = run("bf16_backward", phase_backward, dev, bf16=True)
    bf16_ann_fwd = run("bf16_ann_forward", phase_ann_forward, dev, bf16=True)
    bf16_ann_bwd = run("bf16_ann_backward", phase_ann_backward, dev,
                       bf16=True)
    bf16_served = run("serving_bf16", phase_serving_bf16, dev)
    bf16_trained = run("training_bf16", phase_training_bf16, dev)
    tp_coll_launches, tp_coll = run("tp_collectives", phase_tp_collectives,
                                    dev)
    tp_fwd = run("tp_cell_forward", phase_tp_cell_forward, dev)
    tp_bwd = run("tp_cell_backward", phase_tp_cell_backward, dev)
    tp_trained = run("training_tp", phase_training_tp, dev)
    tp_ann_fwd = run("tp_ann_forward", phase_tp_ann_forward, dev)
    tp_ann_bwd = run("tp_ann_backward", phase_tp_ann_backward, dev)
    tp_ann_trained = run("training_tp_ann", phase_training_tp_ann, dev)
    tp_fwd16 = run("tp_forward_bf16", phase_tp_cell_forward, dev, bf16=True)
    tp_bwd16 = run("tp_backward_bf16", phase_tp_cell_backward, dev,
                   bf16=True)
    tp_trained16 = run("training_tp_bf16", phase_training_tp, dev, bf16=True)
    tp_ann_fwd16 = run("tp_ann_forward_bf16", phase_tp_ann_forward, dev,
                       bf16=True)
    tp_ann_bwd16 = run("tp_ann_backward_bf16", phase_tp_ann_backward, dev,
                       bf16=True)
    tp_ann_trained16 = run("training_tp_ann_bf16", phase_training_tp_ann,
                           dev, bf16=True)
    emit("seconds", **seconds)
    cb = cell_bounds(cell.pop("firing_rate"))
    readout_bytes = 4.0 * (B * T * C + 2 * B * C + C)
    readout_ops = 12.0 * B * T * C
    src = "sparch_tpu_torch/csrc/"
    tpu = "sparch_tpu/ops/pallas_cells.py:"
    kernels = [
        dict(name="fused_cell_fwd", route="cuda",
             source=src + "fused_cell_fwd.cu", replaces=tpu + "305",
             launches=launches["fused_cell_fwd"],
             launches_experiment=experiment.get("fused_cell_fwd", 0),
             launches_audio=audio.get("fused_cell_fwd", 0),
             launches_migrate=migrated.get("fused_cell_fwd", 0), **cell,
             **cb["fwd"], library_ms=None),
        dict(name="fused_cell_fwd_train", route="cuda",
             source=src + "fused_cell_fwd.cu", replaces=tpu + "305",
             launches=trained["fused_cell_fwd_train"],
             launches_experiment=experiment.get("fused_cell_fwd_train", 0),
             launches_audio=audio.get("fused_cell_fwd_train", 0),
             launches_migrate=migrated.get("fused_cell_fwd_train", 0),
             **dict(fwd_train, at_256x1024=dict(
                 fwd_train["at_256x1024"],
                 launches=tp_trained["auto"]["fused_cell_fwd_train"])),
             **cb["fwd_train"], library_ms=None),
        dict(name="dropout_hash", route="cuda",
             source=src + "dropout_hash.cuh", replaces=tpu + "265",
             launches=trained["fused_cell_fwd_train"]
             + trained["fused_cell_bwd"],
             launches_experiment=experiment.get("fused_cell_fwd_train", 0)
             + experiment.get("fused_cell_bwd", 0),
             launches_audio=audio.get("fused_cell_fwd_train", 0)
             + audio.get("fused_cell_bwd", 0),
             launches_migrate=migrated.get("fused_cell_fwd_train", 0)
             + migrated.get("fused_cell_bwd", 0), **hashed, **cb["hash"],
             library_ms=None),
        dict(name="fused_cell_bwd", route="cuda",
             source=src + "fused_cell_bwd.cu", replaces=tpu + "631",
             launches=trained["fused_cell_bwd"],
             launches_experiment=experiment.get("fused_cell_bwd", 0),
             launches_audio=audio.get("fused_cell_bwd", 0),
             launches_migrate=migrated.get("fused_cell_bwd", 0), **bwd,
             **cb["bwd"], library_ms=None),
        dict(name="readout_fwd", route="cuda",
             source=src + "readout_fwd.cu", replaces=tpu + "1235",
             launches=launches["readout_fwd"],
             launches_training=trained["readout_fwd"],
             launches_experiment=experiment.get("readout_fwd", 0),
             launches_audio=audio.get("readout_fwd", 0),
             launches_migrate=migrated.get("readout_fwd", 0), **readout,
             **bound(readout_bytes, readout_ops), library_ms=None),
        dict(name="readout_bwd", route="cuda",
             source=src + "readout_bwd.cu", replaces=tpu + "1274",
             launches=trained["readout_bwd"],
             launches_experiment=experiment.get("readout_bwd", 0),
             launches_audio=audio.get("readout_bwd", 0),
             launches_migrate=migrated.get("readout_bwd", 0), **readout_bwd,
             **bound(2 * readout_bytes, 2 * readout_ops), library_ms=None),
    ] + ann_kernel_rows(ann_fwd, ann_bwd, ann_served, ann_trained,
                        tp_ann_fwd, tp_ann_bwd, migrated) \
        + bf16_kernel_rows(bf16_cell, bf16_bwd, bf16_ann_fwd, bf16_ann_bwd,
                           bf16_served, bf16_trained, tp_ann_fwd16,
                           tp_ann_bwd16, tp_trained16["auto"]) \
        + tp_kernel_rows(tp_coll_launches, tp_coll, tp_fwd, tp_bwd,
                         tp_trained) \
        + tp_ann_kernel_rows(tp_ann_fwd, tp_ann_bwd, tp_ann_trained) \
        + tp_cell_rows(tp_fwd16, tp_bwd16, tp_trained16, bf16=True) \
        + tp_ann_kernel_rows(tp_ann_fwd16, tp_ann_bwd16, tp_ann_trained16,
                             bf16=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
