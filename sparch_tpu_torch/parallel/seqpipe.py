"""Sequence (time-axis) parallelism: the time-pipelined train step, eval step
and inference forward (counterpart of sparch_tpu/parallel/seqpipe.py).

The time axis is cut into S chunks over a ``seq`` mesh axis, and the
sequential neuron recurrences run as a **state-passing pipeline**: stage
``s`` owns time chunk ``s``; the neuron state at each chunk boundary hops
to the next stage, and the batch is split into M microbatches, stage ``s``
running microbatch ``m`` at tick ``s + m`` (the fill and drain bubble is
``(S-1)/(M+S-1)`` of the ticks). What is not sequential in time runs per
chunk: the input projections, the batch statistics (summed over the
stages), the firing rates, dropout, and the leaky readout, whose linear
recurrence crosses the chunk boundaries in closed form (each chunk's
boundary drive, then an S-step chain seeded with the readout's initial
membrane).

**The stages in one process.** The JAX pipeline's mesh is the devices of
one process and its exchanges are collectives inside one ``shard_map``.
Here the S stages are held in one process as a list of devices
(:class:`SeqMesh`), and every exchange is a tensor operation that autograd
differentiates by itself:

- ``ppermute`` to the next stage: ``.to(next stage's device)``;
- ``psum`` over ``seq``: a sum over the stages' partials, brought to stage
  0's device in stage order (so the bits do not depend on placement);
- ``all_gather`` of the readout's boundary drives: a list;
- the ``i -> S-1-i`` time reversal of the bidirectional batch trick:
  reversing the list of chunks (and flipping each).

On one card every stage lies on that card and the hops are the identity.
The stages may also lie on S distinct cards, one a card (``make_seq_mesh
([cuda:0, .., cuda:S-1])``, as the JAX mesh puts them on S chips): a stage
then computes its chunks on its card with copies of the layer's parameters
moved there (autograd brings their gradients home), and a tick issues its
chunks with no host synchronisation, so the cards overlap. The model and
the batch live on stage 0's card (``mesh.home``). Every move to a stage's
device goes through ``_to_stage``. The ``model`` axis runs in its one-card
form: each stage computes its layer whole, the concatenation of its P
column shards, so the axis only checks that P divides every hidden size;
``model > 1`` with the stages on distinct cards is refused (ROADMAP queue 1
item 7c). The ``data`` axis is the processes of a data-parallel run
(``parallel/multihost.py``): inside ``multihost.sharded()`` each rank
pipelines its own rows, the batch statistics and firing rates are the
global batch's and the noise is drawn at the global batch's shape.

**Scope.** The eight model types with a readout layer, uni- and
bidirectional, float32 or ``compute_dtype=bfloat16``. The chunk
recurrences are plain PyTorch, as the JAX chunks are plain JAX: the fused
kernels take their initial states but hand back no final ``u``/``w`` and
take no gradient for them, and a stage hands exactly those on. Each
chunk's step runs the operations of the port's scan cells
(``ops/cells.py``) in their order, so that on a dyadic grid a chunk's
spikes equal the same steps of the single-device scan bit for bit.

**Noise.** Dropout masks and uniform initial states are drawn before the
pipeline runs, at the global shape (:func:`draw_noise`), so that the
result is independent of S and M. They are drawn in the order and types
the model's own scan path draws them, so from one generator state the
pipelined step and the single-device ``scan`` step take the same noise.
The steps also take an explicit ``noise=``.

The steps take the global ``(B, T, F)`` batch and cut T into S chunks
themselves: the JAX ``seq_batch_sharding`` has no counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

import sparch_tpu_torch.models.common as common
import sparch_tpu_torch.train.steps as steps
from sparch_tpu_torch.ops import cells
from sparch_tpu_torch.ops.surrogate import spike_boxcar
from sparch_tpu_torch.parallel import multihost
from sparch_tpu_torch.parallel.mesh import check_cards

__all__ = [
    "SeqMesh",
    "make_seq_mesh",
    "draw_noise",
    "make_seqpipe_train_step",
    "make_seqpipe_eval_step",
    "make_seqpipe_predict",
]


class SeqMesh:
    """Devices on the axes ``('data', 'seq', 'model')``: this process's
    ``seq`` x ``model`` devices, stage ``s`` holding ``devices[s*P :
    (s+1)*P]``; ``processes`` data-parallel processes hold one such block
    each."""

    axis_names = ("data", "seq", "model")

    def __init__(self, devices: Sequence[torch.device], seq: int,
                 model: int = 1, processes: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        if seq < 1 or model < 1 or len(self.devices) != seq * model:
            raise ValueError(f"{len(self.devices)} devices != seq={seq} x "
                             f"model={model}")
        self.seq, self.model, self.processes = seq, model, processes

    @property
    def shape(self):
        return {"data": self.processes, "seq": self.seq, "model": self.model}

    @property
    def stage_devices(self):
        """Each stage's device (its first of the ``model`` axis)."""
        return [self.devices[s * self.model] for s in range(self.seq)]

    @property
    def one_card(self) -> bool:
        return len(set(self.devices)) == 1

    @property
    def device(self) -> torch.device:
        """The one device of a one-card mesh."""
        if not self.one_card:
            raise ValueError("a mesh over several devices has no one device")
        return self.devices[0]

    @property
    def home(self) -> torch.device:
        """Stage 0's device, where the model and the batch live."""
        return self.devices[0]

    def __repr__(self) -> str:
        devices = [str(d) for d in self.devices]
        return (f"SeqMesh(data={self.processes}, seq={self.seq}, "
                f"model={self.model}, devices={devices})")


def make_seq_mesh(devices: Optional[Sequence] = None,
                  data: Optional[int] = None, seq: Optional[int] = None,
                  model: int = 1) -> SeqMesh:
    """A ``('data', 'seq', 'model')`` mesh over this process's ``devices``
    (default: its card, ``multihost.local_device()``, repeated ``seq *
    model`` times; ``seq`` is then required). Given ``devices``, ``seq``
    is ``len(devices) // model``. ``data`` is the processes of a
    data-parallel run (``parallel/multihost.py``), one block each.

        make_seq_mesh(seq=4)                               # the card
        make_seq_mesh(devices=[torch.device("cpu")] * 2)   # the CPU
        make_seq_mesh(devices=[torch.device("cuda", i) for i in range(4)])
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices= (e.g. [torch.device('cpu')] "
                "* S for the stages on the CPU)")
        if seq is None:
            raise ValueError("make_seq_mesh() needs seq= or devices=")
        devices = [multihost.local_device()] * (seq * model)
    devices = [torch.device(d) for d in devices]
    if len(devices) % model:
        raise ValueError(f"{len(devices)} devices not divisible by "
                         f"model={model}")
    if seq is None:
        seq = len(devices) // model
    procs = multihost.world_size()
    if data is not None and data != procs:
        raise NotImplementedError(
            f"a 'data' axis of {data} over {procs} process(es): the data "
            "axis is the processes, one block of the mesh each; start the "
            f"ranks with python -m torch.distributed.run --nproc_per_node "
            f"{data} (parallel/multihost.py)")
    mesh = SeqMesh(devices, seq, model, processes=procs)
    if not mesh.one_card:
        check_cards(devices, "pipeline stages")
        if model > 1:
            raise NotImplementedError(
                "the 'model' axis inside the pipeline across cards: ROADMAP "
                "queue 1 item 7c; give one card a stage (model=1), or "
                "repeat one device (make_seq_mesh([dev] * (S * P), "
                "model=P))")
        if procs > 1:
            raise NotImplementedError(
                "pipeline stages across cards under data-parallel processes "
                "(each process holds one card): ROADMAP queue 1 item 7c")
    return mesh


def _to_stage(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on a stage's device: a hop between stages and a stage's copy
    of a parameter (differentiable; a no-op where it lies there already).
    The one place the pipeline moves a tensor to a mesh device."""
    return t.to(dev)


class _Fanout(torch.autograd.Function):
    """One use of ``t`` for each of ``devices`` (a view where it lies there
    already, else a copy); its gradient is the uses' gradients added on
    ``t``'s device in list order. Autograd would add them as they arrive,
    and from several cards' threads that order varies: this way a stage's
    or a microbatch's share of a parameter's gradient is added in one
    order, wherever the stages lie."""

    @staticmethod
    def forward(ctx, t, *devices):
        ctx.home = t.device
        return tuple(t.view_as(t) if torch.device(d) == t.device
                     else _to_stage(t, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is None:
                continue
            g = _to_stage(g, ctx.home)
            total = g if total is None else total + g
        return (total,) + (None,) * len(grads)


def _fanout(t: torch.Tensor, devices):
    """``_Fanout``: ``t``'s use on each of ``devices``, in order."""
    return list(_Fanout.apply(t, *devices))


def _per_stage(module, chunks, devices):
    """``module`` on each stage's chunk, with its parameters fanned out to
    the stages (``_Fanout``) and its buffers moved there
    (``torch.func.functional_call``)."""
    params = {n: _fanout(p, devices) for n, p in module.named_parameters()}
    bufs = {n: [_to_stage(b, d) for d in devices]
            for n, b in module.named_buffers()}
    return [torch.func.functional_call(
        module, {**{n: v[s] for n, v in params.items()},
                 **{n: v[s] for n, v in bufs.items()}}, (c,))
        for s, c in enumerate(chunks)]


def _stream_dtypes(model):
    """(state, mask) dtypes of the model's scan path: the states take the
    type of the normalised drive (bf16 only where a bf16 projection meets
    no norm), a mask is drawn in float32 at least."""
    param = next(model.parameters()).dtype
    narrow = (model.compute_dtype == torch.bfloat16
              and model.normalization not in ("batchnorm", "layernorm"))
    return (torch.bfloat16, torch.float32) if narrow else (param, param)


def draw_noise(model, generator: torch.Generator, batch_shape,
               train: bool = True):
    """The per-forward noise of the pipelined steps, drawn at the global
    batch's shape from ``generator`` (on its device): each hidden layer's
    scaled keep mask (train-mode dropout) and, for an SNN with
    ``state_init='uniform'``, its U[0, 1) initial states (drawn in eval
    too) and the readout's initial membrane.

    Returns a (possibly empty) dict ``{"layer_i": {"mask": (B, T, H),
    "states": (u, w, s)}, "readout": {"u0": (B, C)}}`` with the entries the
    model needs. Each state slot is ``(B, H)``; ``w`` is zeros for LIF and
    RLIF. A bidirectional model's mask covers the merged ``(B, T, 2H)``
    output and each state slot is ``(2, B, H)``, a direction's rows of the
    doubled batch.

    Independent of S and M by construction. The draws are those of the
    model's scan path, in its order (a layer's states, then its mask;
    the readout last) and types, so the same generator state gives the
    single-device ``scan`` step the same noise. Inside
    ``multihost.sharded()`` they are drawn for the global batch and cut to
    this rank's rows (``multihost.draw_rows``)."""
    B, T = batch_shape[0], batch_shape[1]
    uniform = model.is_snn and model.state_init == "uniform"
    adaptive = model.is_snn and model.neuron_type in ("adLIF", "RadLIF")
    bidir = bool(model.bidirectional)
    rows = multihost.batch_rows(B)
    state_dt, mask_dt = _stream_dtypes(model)
    dev = generator.device

    def rand(shape, dtype):
        return multihost.draw_rows(
            lambda s: torch.rand(s, generator=generator, dtype=dtype,
                                 device=dev), shape, rows)

    noise = {}
    for i, layer in enumerate(model.hidden_layers()):
        h = layer.hidden_size
        entry = {}
        if uniform:
            # the layer draws its states for the doubled batch at once
            n = 2 * B if bidir else B
            drawn = [rand((n, h), state_dt) for _ in range(3 if adaptive
                                                           else 2)]
            if not adaptive:
                drawn.insert(1, torch.zeros_like(drawn[0]))
            entry["states"] = tuple(s.reshape(2, B, h) if bidir else s
                                    for s in drawn)
        p = float(layer.dropout) if train else 0.0
        if p > 0:
            keep = rand((B, T, 2 * h if bidir else h), mask_dt) >= p
            entry["mask"] = keep.to(mask_dt) * (1.0 / (1.0 - p))
        if entry:
            noise[f"layer_{i}"] = entry
    if uniform:
        noise["readout"] = {"u0": rand((B, model.layer_sizes[-1]),
                                       next(model.parameters()).dtype)}
    return noise


def _stage_chunks(x, devices):
    """The S time chunks of ``x`` (dim 1), each on its stage's device."""
    S, T = len(devices), x.shape[1]
    if T % S:
        raise ValueError(f"sequence length {T} not divisible by the mesh's "
                         f"seq axis ({S})")
    Tl = T // S
    return [_to_stage(x[:, s * Tl:(s + 1) * Tl], d)
            for s, d in enumerate(devices)]


def _time_reverse(chunks, devices):
    """The global time flip of a chunked sequence: each chunk flipped and
    the stage order reversed (the JAX ``ppermute`` ``i -> S-1-i``)."""
    S = len(chunks)
    return [_to_stage(torch.flip(chunks[S - 1 - s], dims=[1]), d)
            for s, d in enumerate(devices)]


def _norm(norm, chunks, train: bool, devices):
    """The layer's norm of each stage's ``(B, Tl, H)`` chunk. Training
    BatchNorm takes the statistics of the whole sequence: the stages'
    sums (float32 at least) added on stage 0's device in stage order, then,
    inside ``multihost.sharded()``, the mean over the ranks; the running
    statistics move once. Everything else acts per chunk through the
    module, in its mode: eval BatchNorm reads the running statistics,
    LayerNorm is per sample."""
    if norm.kind != "batchnorm" or not train:
        return _per_stage(norm, chunks, devices)
    flats = [c.reshape(-1, c.shape[-1]) for c in chunks]
    flats = [f.float() if f.dtype == torch.bfloat16 else f for f in flats]
    dev = devices[0]
    n = sum(f.shape[0] for f in flats)
    s1 = sum(_to_stage(f.sum(dim=0), dev) for f in flats)
    s2 = sum(_to_stage((f * f).sum(dim=0), dev) for f in flats)
    mean, mean2 = s1 / n, s2 / n
    if multihost.is_sharded():
        mean, mean2 = multihost.mean_over_ranks(
            torch.stack([mean, mean2]), "stats").unbind(0)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    norm._update_running(mean, var)
    mul = torch.rsqrt(var + common.NORM_EPS) * norm.weight
    return [((f - m) * k + b).reshape(c.shape) for f, c, m, k, b in zip(
        flats, chunks, _fanout(mean, devices), _fanout(mul, devices),
        _fanout(norm.bias, devices))]


def _snn_chunk_scan(cp, threshold, wxs, state):
    """One SNN ``(mb, Tl, H)`` chunk from ``state`` (``(u, w, s)``, or
    ``(u, s)`` without adaptation); returns ``(state, spikes)``. The
    operations of ``cells.{lif,adlif,rlif,radlif}_scan`` in their order;
    the float32 constants are cast to the stream's type where they are
    used and ``V`` goes through ``rec_dot``, so that under a bf16 stream
    their gradients sum in float32 (the JAX chunk's casts)."""
    (wx,) = wxs
    dt = wx.dtype
    adaptive, recurrent = "beta" in cp, "V" in cp
    if adaptive:
        u, w, s = state
    else:
        u, s = state
    out = []
    for t in range(wx.shape[1]):
        alpha = cp["alpha"].to(dt)
        drive = wx[:, t]
        if adaptive:
            # w uses the previous step's u and s
            w = (cp["beta"].to(dt) * w + cp["a"].to(dt) * u
                 + cp["b"].to(dt) * s)
        if recurrent:
            drive = drive + common.rec_dot(s, cp["V"])
        if adaptive:
            drive = drive - w
        u = alpha * (u - s) + (1.0 - alpha) * drive
        s = spike_boxcar(u - threshold)
        out.append(s)
    return ((u, w, s) if adaptive else (u, s)), torch.stack(out, dim=1)


def _ann_chunk_scan(ann_type, mats, wxs, state):
    """One ANN chunk from ``state = (y,)``: the operations of
    ``cells.{rnn,ligru,gru}_scan``; ``wxs`` and ``mats`` in the gate
    order (W, Wz, Wr) and (V, Vz, Vr)."""
    (y,) = state
    dot = common.rec_dot
    out = []
    for t in range(wxs[0].shape[1]):
        if ann_type == "RNN":
            y = torch.sigmoid(wxs[0][:, t] + dot(y, mats[0]))
        else:
            z = torch.sigmoid(wxs[1][:, t] + dot(y, mats[1]))
            if ann_type == "LiGRU":
                c = torch.relu(wxs[0][:, t] + dot(y, mats[0]))
            else:  # GRU: the reset gate before the recurrent product
                r = torch.sigmoid(wxs[2][:, t] + dot(y, mats[2]))
                c = torch.tanh(wxs[0][:, t] + dot(r * y, mats[0]))
            y = z * y + (1.0 - z) * c
        out.append(y)
    return (y,), torch.stack(out, dim=1)


def _pipelined_recurrence(chunk_fn, consts, wxs, n_micro: int, devices,
                          init_state=None, n_slots: int = 1):
    """The state-passing pipeline. ``wxs``: per stage, the tuple of
    per-gate ``(B, Tl, H)`` drive chunks; ``chunk_fn(consts, wxs_chunk,
    state) -> (state, outputs)``, where ``consts`` (a dict of the layer's
    constants) is fanned out to every (stage, microbatch) chunk
    (``_Fanout``: their gradients add in that order). Each (stage,
    microbatch) chunk runs once, in tick order ``t = s + m`` (the JAX
    pipeline also computes throwaway chunks on its inactive ticks; skipping
    them gives the same result). A stage's final state hops to the next
    stage (``_to_stage``); stage 0 starts each microbatch from its rows of
    ``init_state`` (per-slot ``(B, H)`` tensors) or from zeros. Returns
    each stage's ``(B, Tl, H)`` outputs."""
    S, M = len(wxs), n_micro
    B, _, H = wxs[0][0].shape
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    mb = B // M
    outs = [[None] * M for _ in range(S)]
    # the constants of chunk (s, m) at index s * M + m
    fanned = {k: _fanout(v, [d for d in devices for _ in range(M)])
              for k, v in consts.items()}
    inbox = {}
    for t in range(M + S - 1):
        for s in range(max(0, t - M + 1), min(t, S - 1) + 1):
            m = t - s
            rows = slice(m * mb, (m + 1) * mb)
            if s > 0:
                state = inbox.pop((s, m))
            elif init_state is not None:
                state = tuple(v[rows] for v in init_state)
            else:
                zero = wxs[0][0].new_zeros((mb, H))
                state = (zero,) * n_slots
            state, outs[s][m] = chunk_fn(
                {k: v[s * M + m] for k, v in fanned.items()},
                tuple(w[rows] for w in wxs[s]), state)
            if s + 1 < S:
                inbox[(s + 1, m)] = tuple(_to_stage(v, devices[s + 1])
                                          for v in state)
    return [torch.cat(o, dim=0) for o in outs]


def _clamped(layer, neuron):
    """The layer's neuron constants clamped to their ranges, V with its
    diagonal masked (float32; the chunks cast them where they are used)."""
    cp = {"alpha": torch.clamp(layer.alpha, *cells.ALPHA_LIM)}
    if neuron in ("adLIF", "RadLIF"):
        cp["beta"] = torch.clamp(layer.beta, *cells.BETA_LIM)
        cp["a"] = torch.clamp(layer.a, *cells.A_LIM)
        cp["b"] = torch.clamp(layer.b, *cells.B_LIM)
    if neuron in ("RLIF", "RadLIF"):
        cp["V"] = cells.zero_diag(layer.V)
    return cp


def _snn_layer(model, layer, chunks, states, train, n_micro, devices):
    wx = _norm(layer.norm, _per_stage(layer.W, chunks, devices), train,
               devices)
    cp = _clamped(layer, model.neuron_type)
    adaptive = "beta" in cp
    if states is not None:
        # the drawn noise holds three slots (w zeros without adaptation);
        # the pipeline carries the ones the cell reads
        states = [s.reshape(-1, s.shape[-1]).to(wx[0].dtype) for s in states]
        states = states if adaptive else [states[0], states[2]]
    return _pipelined_recurrence(
        lambda c, wxs, state: _snn_chunk_scan(c, layer.threshold, wxs,
                                              state),
        cp, [(w,) for w in wx], n_micro, devices, init_state=states,
        n_slots=3 if adaptive else 2)


def _ann_layer(model, layer, chunks, states, train, n_micro, devices):
    wxs = [_norm(getattr(layer, f"norm_{g}"),
                 _per_stage(getattr(layer, g), chunks, devices), train,
                 devices)
           for g in layer.gates]
    per_stage = list(zip(*wxs))
    if model.ann_type == "MLP":
        return [torch.sigmoid(w[0]) for w in per_stage]
    mats = dict(enumerate(layer._matrices()))
    return _pipelined_recurrence(
        lambda c, wxs, state: _ann_chunk_scan(
            model.ann_type, [c[i] for i in range(len(c))], wxs, state),
        mats, per_stage, n_micro, devices)


def _snn_readout(readout, chunks, train, u0, devices):
    """The leaky readout across the chunks in closed form: each chunk's
    membrane from a zero start, its boundary drive, the chain of chunk
    starts seeded with ``u0`` (or zeros), then each chunk's series
    shifted by its start; the softmaxes summed over t and the stages."""
    wx = _norm(readout.norm, _per_stage(readout.W, chunks, devices), train,
               devices)
    # the membrane recurrence runs in float32 (models/snn.py ReadoutLayer)
    wx = [w.float() if w.dtype == torch.bfloat16 else w for w in wx]
    B, Tl, C = wx[0].shape
    alpha = torch.clamp(readout.alpha, *cells.ALPHA_LIM).to(wx[0].dtype)
    intra = [cells.leaky_cumsum(w, a, w.new_zeros((B, C)))
             for w, a in zip(wx, _fanout(alpha, devices))]
    a_pow_T = alpha ** Tl
    j = torch.arange(Tl, dtype=wx[0].dtype, device=wx[0].device)
    decay = torch.exp((j[None, :, None] + 1.0) * torch.log(alpha))
    u = wx[0].new_zeros((B, C)) if u0 is None else u0.to(wx[0].dtype)
    out = None
    for it, d, dec, apt in zip(intra, devices, _fanout(decay, devices),
                               _fanout(a_pow_T, devices)):
        u = _to_stage(u, d)
        part = _to_stage(torch.softmax(dec * u[:, None, :] + it,
                                       dim=-1).sum(dim=1), devices[0])
        out = part if out is None else out + part
        u = apt * u + it[:, -1, :]
    return out


def _ann_readout(readout, chunks):
    """The ANN readout: each chunk's sum of per-step softmaxes (float32),
    added over the stages, then the linear layer and the 2-D norm (its
    statistics over the batch, the global one inside ``sharded()``)."""
    acc = sum(cells.cumulative_softmax(c).to(chunks[0].device)
              for c in chunks)
    return readout.norm(readout.W(acc))


def _build_seqpipe(model, mesh: SeqMesh, n_micro: int = 4,
                   use_regularizers: bool = False, reg_factor: float = 0.5,
                   reg_fmin: float = 0.01, reg_fmax: float = 0.5):
    """The (train, eval, predict) triple whose forwards run over ``mesh``'s
    ``seq`` stages with pipelined recurrences (see the module docstring).
    Needs the readout layer; the eight model types, uni- and
    bidirectional."""
    if not model.use_readout_layer:
        raise ValueError("seq-pipeline step requires the readout layer")
    P = mesh.shape["model"]
    if P > 1 and any(h % P for h in model.layer_sizes[:-1]):
        raise ValueError(
            f"hidden sizes {model.layer_sizes[:-1]} not divisible by the "
            f"'model' axis ({P})")
    devices = mesh.stage_devices
    is_snn, bidir = model.is_snn, bool(model.bidirectional)
    layer_fn = _snn_layer if is_snn else _ann_layer
    uniform = is_snn and model.state_init == "uniform"
    reg = dict(use_regularizers=use_regularizers, reg_factor=reg_factor,
               reg_fmin=reg_fmin, reg_fmax=reg_fmax)

    def forward(x, noise, train):
        """The model's ``(out, rates)`` of the batch ``x``; one process
        computes the readout once, so nothing needs the JAX ``_dedup``
        (its readout runs replicated over the ``model`` axis)."""
        B, T = x.shape[0], x.shape[1]
        h = _stage_chunks(x, devices)
        rate_sums = []
        for i, layer in enumerate(model.hidden_layers()):
            nz = noise.get(f"layer_{i}", {})
            if bidir:
                # the batch trick: the backward half's data time-flipped,
                # so both halves run time-forward through the pipeline
                h = [torch.cat([c, r], dim=0)
                     for c, r in zip(h, _time_reverse(h, devices))]
            h = layer_fn(model, layer, h, nz.get("states"), train, n_micro,
                         devices)
            if bidir:
                # un-flip the backward half, concatenate on features
                b = h[0].shape[0] // 2
                h = [torch.cat([c[:b], r], dim=-1) for c, r in
                     zip(h, _time_reverse([c[b:] for c in h], devices))]
            if "mask" in nz:
                # dropout of the merged output, in the stream's type
                h = [(c * m).to(c.dtype) for c, m in
                     zip(h, _stage_chunks(nz["mask"], devices))]
            if is_snn:
                rate_sums.append(sum(_to_stage(c.float().sum(dim=(0, 1)),
                                               devices[0])
                                     for c in h) / (B * T))
        if is_snn:
            out = _snn_readout(model.readout, h, train,
                               noise.get("readout", {}).get("u0"), devices)
            rates = multihost.mean_over_ranks(torch.cat(rate_sums), "rates")
            return out, rates
        return _ann_readout(model.readout, h), None

    def eval_noise(generator, x):
        # 'uniform' state init draws even in eval
        if not uniform:
            return {}
        if generator is None:
            raise ValueError(
                "state_init='uniform' eval needs a generator argument")
        return draw_noise(model, generator, x.shape, train=False)

    def train_step(state, x, y, noise=None):
        steps._check_state(state, model)
        model.train()
        if noise is None:
            noise = draw_noise(model, state.generator, x.shape, train=True)
        return steps.take_step(state, model,
                               lambda: forward(x, noise, True), y, **reg)

    @torch.no_grad()
    def eval_step(state, x, y, generator=None, noise=None):
        steps._check_state(state, model)
        model.eval()
        if noise is None:
            noise = eval_noise(generator, x)
        return steps.eval_metrics(model, *forward(x, noise, False), y)

    @torch.no_grad()
    def predict(x, generator=None, noise=None):
        model.eval()
        if noise is None:
            noise = eval_noise(generator, x)
        return forward(x, noise, False)[0]

    return train_step, eval_step, predict


def make_seqpipe_train_step(model, mesh: SeqMesh, n_micro: int = 4, **kw):
    """The time-pipelined train step: ``train_step(state, x, y,
    noise=None) -> (state, metrics)``, the contract of
    ``train.steps.make_train_step``, the noise drawn from
    ``state.generator`` (:func:`draw_noise`) unless given. ``kw``: the
    regularizer's ``use_regularizers``, ``reg_factor``, ``reg_fmin``,
    ``reg_fmax``."""
    return _build_seqpipe(model, mesh, n_micro, **kw)[0]


def make_seqpipe_eval_step(model, mesh: SeqMesh, n_micro: int = 4):
    """The time-pipelined eval step: ``eval_step(state, x, y,
    generator=None, noise=None) -> metrics`` with the running
    statistics; ``state_init='uniform'`` draws its states from
    ``generator`` (needed there) unless ``noise`` is given."""
    return _build_seqpipe(model, mesh, n_micro)[1]


def make_seqpipe_predict(model, mesh: SeqMesh, n_micro: int = 4):
    """The time-pipelined inference forward: ``predict(x, generator=None,
    noise=None) -> readout output`` (the summed per-step softmaxes of an
    SNN, an ANN's logits), with the model's own parameters and running
    statistics. ``serve.Predictor`` wraps it when given a mesh."""
    return _build_seqpipe(model, mesh, n_micro)[2]
