"""Rank worker of the port's data-parallel tests (no JAX: a rank imports
only ``sparch_tpu_torch``).

    python -m tests.torch_dp_worker JOB RANK WORLD STORE IN OUT

initialises a gloo group of WORLD ranks over the ``file://`` store STORE
(a fresh path in a test's temporary directory, so that tests running side
by side never share a port), runs JOB on the payload ``torch.load(IN)``
and ``torch.save``s what it returns to OUT. The same job functions run in
the test's own process for one rank, with no group. ``Ranks`` starts
the ranks and collects their results.
"""
from __future__ import annotations

import os
import subprocess
import sys
from datetime import timedelta

import torch

from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.parallel import (
    make_seq_mesh,
    make_seqpipe_train_step,
    multihost,
)
from sparch_tpu_torch.train import create_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(cfg, state_dict):
    model = build_model(cfg["type"], cfg["shape"], cfg["sizes"],
                        **cfg.get("kw", {}))
    model.load_state_dict(state_dict, strict=True)
    return model


def shard_batch(x, y):
    """This rank's contiguous rows of a global batch, as the sharded
    loader (``DataLoader(num_shards=R, shard_index=r)``) gives them."""
    per = y.shape[0] // multihost.world_size()
    lo = multihost.rank() * per
    return x[lo:lo + per], y[lo:lo + per]


def train_steps(p):
    """``p["steps"]`` train steps of the global batches ``p["batches"]``
    on this rank's slices: the metrics of each step, the parameters and
    buffers after the last, the first step's gradients and, with
    ``p["spikes"]``, the first step's hidden spikes and logits. With
    ``p["seq"]`` the steps are the time-pipelined ones over that many
    stages and ``p["n_micro"]`` microbatches."""
    model = _model(p["cfg"], p["state_dict"])
    state = create_train_state(model, p["lr"], device="cpu", seed=p["seed"])
    if p.get("seq"):
        mesh = make_seq_mesh([torch.device("cpu")] * p["seq"])
        step = make_seqpipe_train_step(model, mesh, n_micro=p["n_micro"],
                                       **p.get("step_kw", {}))
    else:
        step = make_train_step(model, **p.get("step_kw", {}))
    spikes = []
    if p.get("spikes"):
        for layer in model.hidden_layers():
            layer.register_forward_hook(
                lambda m, i, o: spikes.append(o.detach().clone()))
        model.readout.register_forward_hook(
            lambda m, i, o: spikes.append(o.detach().clone()))
    out = {"loss": [], "acc": [], "rate": [], "counts": None}
    multihost.reset_collective_counts()
    for i, (x, y) in enumerate(p["batches"][:p["steps"]]):
        x, y = shard_batch(torch.as_tensor(x), torch.as_tensor(y))
        with multihost.sharded():
            state, met = step(state, x, y)
        for k, name in (("loss", "loss"), ("acc", "acc"),
                        ("rate", "spike_rate")):
            out[k].append(float(met[name]))
        if i == 0:
            out["counts"] = multihost.collective_counts()["calls"]
            out["grads"] = {k: v.grad.clone() for k, v in
                            model.named_parameters() if v.grad is not None}
            out["spikes"] = spikes[:]
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def local_forward(p):
    """A train-mode forward of this rank's own batch ``p["x"][rank]``
    outside ``multihost.sharded()``, as a server or an eval that one rank
    runs makes it: its logits and firing rates and the all-reduces it
    made."""
    model = _model(p["cfg"], p["state_dict"]).train()
    multihost.reset_collective_counts()
    with torch.no_grad():
        out, rates = model(torch.as_tensor(p["x"][multihost.rank()]),
                           torch.Generator().manual_seed(p["seed"]))
    return dict(out=out, rates=rates,
                calls=multihost.collective_counts()["calls"])


def cli(p):
    """A run of ``run_exp_torch.main(p["argv"], device="cpu")`` (every
    rank the same argv, so one folder): its history, final state and the
    train loader's sharding."""
    import run_exp_torch

    exp = run_exp_torch.main(p["argv"], device="cpu")
    tl = exp.train_loader
    return {
        "history": exp.history,
        "state": {k: v.clone() for k, v in exp.net.state_dict().items()},
        "loader": dict(num_shards=tl.num_shards, shard_index=tl.shard_index,
                       batches=len(tl), drop_last=tl._drop_last(),
                       rows=[len(b) for b in tl._batches()]),
        "mesh": exp.mesh.shape,
    }


def pad(p):
    """``Experiment._pad_to_global_length`` on this rank's HD/SC-like
    batches of 3 + rank frames: features, and waveforms with their frame
    counts."""
    from types import SimpleNamespace

    from sparch_tpu_torch.train.loop import Experiment

    exp = SimpleNamespace(device=torch.device("cpu"))
    n = 3 + multihost.rank()
    feats = torch.ones(2, n, 4)
    waves = (torch.ones(2, 160 * n), torch.tensor([n, n - 1]))
    return (Experiment._pad_to_global_length(exp, feats),
            Experiment._pad_to_global_length(exp, waves))


def many(p):
    """Several jobs in one start of the ranks: ``p`` is a list of (job,
    payload); their results in order."""
    return [JOBS[job](payload) for job, payload in p]


JOBS = {"train_steps": train_steps, "local_forward": local_forward,
        "cli": cli, "pad": pad, "many": many}


class Ranks:
    """``world`` rank processes running ``job`` on ``payload``, started at
    once; ``results()`` waits for them (a rank that fails or outlasts
    ``timeout`` fails the call) and returns their results by rank."""

    def __init__(self, job: str, world: int, payload, tmp,
                 timeout: float = 150.0):
        tmp = str(tmp)
        inp = os.path.join(tmp, f"{job}_{world}_in.pt")
        torch.save(payload, inp)
        store = os.path.join(tmp, f"{job}_{world}_store")
        self.job, self.timeout = job, timeout
        self.outs = [os.path.join(tmp, f"{job}_{world}_out{r}.pt")
                     for r in range(world)]
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dp_worker", job, str(r),
             str(world), store, inp, self.outs[r]], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self._results = None

    def results(self):
        if self._results is not None:
            return self._results
        logs = []
        try:
            for pr in self.procs:
                logs.append(pr.communicate(timeout=self.timeout)[0])
        finally:
            for pr in self.procs:
                if pr.poll() is None:
                    pr.kill()
        bad = [r for r, pr in enumerate(self.procs) if pr.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} of {self.job} failed:\n" +
                               "\n".join(logs[r][-3000:] for r in bad))
        self._results = [torch.load(o, weights_only=False)
                         for o in self.outs]
        return self._results


def main(argv):
    job, rank, world, store, inp, out = argv
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=int(rank),
        world_size=int(world), timeout=timedelta(seconds=120))
    try:
        assert multihost.maybe_initialize() == (int(world) > 1)
        result = JOBS[job](torch.load(inp, weights_only=False))
        torch.save(result, out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
