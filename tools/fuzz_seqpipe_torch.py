#!/usr/bin/env python
"""Random-config fuzz of the port's sequence pipeline
(``sparch_tpu_torch/parallel/seqpipe.py``) against the port's own
single-device ``scan`` step, on the CPU: the counterpart of
``tools/fuzz_seqpipe.py``.

The configuration space is that file's ``draw_config`` (copied: model
type x normalization x bidirectional x dropout x state init x bf16
``compute_dtype`` x (seq, model) factorization x microbatches x bias x
(B, T, H, C, depth) x regularizers), with the ``data`` axis 1: the stages
run in one process. The pipeline draws its noise as the scan path draws it
(``draw_noise``), so every case, noisy or not, is held against the
single-device step from one generator seed: the loss, the gradients
(Adam's first moment after step 1) and the running statistics.

The tolerances are that file's, self-calibrated: a second factorization of
the same case (``_alt_factorization``) measures its noise ball (chaotic
configurations amplify reassociation noise), and a gradient may differ by
25x that scatter; a real seam bug moves both pipelined runs together and
keeps the scatter at float noise.

    python tools/fuzz_seqpipe_torch.py --cases 40 --seed 0 [--json out]
"""
import argparse
import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

MODEL_TYPES = ("LIF", "adLIF", "RLIF", "RadLIF", "MLP", "RNN", "LiGRU", "GRU")
NORMS = ("batchnorm", "layernorm", "none")
# (data, seq, model) factorizations of tools/fuzz_seqpipe.py
MESHES = ((1, 2, 1), (1, 4, 1), (1, 8, 1), (2, 2, 1), (2, 4, 1),
          (2, 2, 2), (1, 2, 2), (1, 4, 2))


def draw_config(rng):
    """``tools/fuzz_seqpipe.py``'s draw, then the ``data`` axis folded
    away (B is its ``data`` x per-shard rows; here one process holds
    the per-shard rows)."""
    mt = MODEL_TYPES[int(rng.integers(len(MODEL_TYPES)))]
    data, seq, tp = MESHES[int(rng.integers(len(MESHES)))]
    bidir = bool(rng.random() < 0.3) and mt != "MLP"
    cfg = dict(
        model_type=mt,
        normalization=NORMS[int(rng.integers(len(NORMS)))],
        bidirectional=bidir,
        dropout=0.0 if rng.random() < 0.45 else float(rng.uniform(0.05, 0.5)),
        state_init="zeros" if rng.random() < 0.5 else "uniform",
        data=data, seq=seq, tp=tp,
    )
    if mt in ("MLP", "RNN", "LiGRU", "GRU"):
        cfg["state_init"] = "zeros"
    cfg["n_micro"] = int(rng.choice((1, 2, 4)))
    cfg["amp"] = bool(rng.random() < 0.3)
    cfg["use_bias"] = bool(rng.random() < 0.3)
    local_mult = int(rng.integers(1, 4))
    cfg["B"] = data * cfg["n_micro"] * local_mult
    cfg["T"] = seq * int(rng.integers(2, 7))
    cfg["H"] = tp * 2 * int(rng.integers(3, 13))
    cfg["C"] = int(rng.choice((3, 5, 7)))
    cfg["F"] = int(rng.integers(6, 20))
    cfg["depth"] = int(rng.choice((1, 2, 3)))
    cfg["regs"] = bool(rng.random() < 0.5)
    cfg["B"] //= cfg["data"]
    cfg["data"] = 1
    return cfg


def _name(cfg):
    return (f"{cfg['model_type']}/{cfg['normalization'][:5]}"
            f"{'/bidir' if cfg['bidirectional'] else ''}"
            f"{'/amp' if cfg['amp'] else ''}"
            f"{'/bias' if cfg['use_bias'] else ''}"
            f"/p{cfg['dropout']:.2f}/{cfg['state_init'][:4]}"
            f"@s{cfg['seq']}m{cfg['tp']}u{cfg['n_micro']}"
            f"/B{cfg['B']}T{cfg['T']}H{cfg['H']}C{cfg['C']}L{cfg['depth']}")


def _alt_factorization(cfg):
    """A second (seq, n_micro) of the same case, to measure its noise
    ball; None if the shape admits none."""
    seq, u = cfg["seq"], cfg["n_micro"]
    if seq >= 4:
        return seq // 2, u
    if cfg["T"] % 4 == 0:
        return 4, u
    if u > 1:
        return seq, 1
    if cfg["B"] % 2 == 0:
        return seq, 2
    return None


def run_case(cfg, seed):
    import torch

    from sparch_tpu_torch.models import build_model
    from sparch_tpu_torch.parallel import (
        make_seq_mesh,
        make_seqpipe_train_step,
    )
    from sparch_tpu_torch.train import create_train_state, make_train_step

    cpu = torch.device("cpu")
    B, T, F, H, C = cfg["B"], cfg["T"], cfg["F"], cfg["H"], cfg["C"]
    amp = cfg["amp"]
    model = build_model(
        cfg["model_type"], (B, T, F), [H] * cfg["depth"] + [C],
        dropout=cfg["dropout"], normalization=cfg["normalization"],
        bidirectional=cfg["bidirectional"], state_init=cfg["state_init"],
        cell_impl="scan", use_bias=cfg["use_bias"],
        compute_dtype=torch.bfloat16 if amp else None,
        generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.random((B, T, F)) < 0.3).astype(np.float32))
    y = torch.arange(B) % C

    def step(seq=None, n_micro=None):
        m = copy.deepcopy(model)
        state = create_train_state(m, 1e-2, device="cpu", seed=seed)
        if seq is None:
            fn = make_train_step(m, use_regularizers=cfg["regs"])
        else:
            mesh = make_seq_mesh([cpu] * (seq * cfg["tp"]), model=cfg["tp"])
            fn = make_seqpipe_train_step(m, mesh, n_micro=n_micro,
                                         use_regularizers=cfg["regs"])
        state, met = fn(state, x, y)
        mu = [state.optimizer.state[p]["exp_avg"].double().numpy()
              for p in m.parameters()]
        stats = [b.double().numpy() for b in m.buffers()]
        return {k: float(v) for k, v in met.items()}, mu, stats

    got, mu, stats = step(cfg["seq"], cfg["n_micro"])
    ref, ref_mu, ref_stats = step()
    fails = []
    m = {"loss": got["loss"], "ref_loss": ref["loss"]}
    if not np.isfinite(got["loss"]):
        fails.append(f"non-finite loss {got['loss']}")
    noise_scale = 0.0
    alt = _alt_factorization(cfg)
    if alt is not None:
        _, alt_mu, _ = step(*alt)
        noise_scale = max(float(np.max(np.abs(a - b)))
                          for a, b in zip(mu, alt_mu))
        m["noise_scale"] = noise_scale
    loss_tol = 4e-3 if amp else 1e-4
    if abs(got["loss"] - ref["loss"]) > loss_tol * max(1.0, abs(ref["loss"])):
        fails.append(f"loss {got['loss']:.6f} vs {ref['loss']:.6f}")
    deterministic = cfg["dropout"] == 0.0 and cfg["state_init"] == "zeros"
    for k in ("acc", "spike_rate") if deterministic else ():
        # amp: bf16 logit noise may flip one argmax
        tol = (1.5 / B if k == "acc" else 1e-2) if amp else 1e-5
        if abs(got[k] - ref[k]) > tol:
            fails.append(f"{k} delta {abs(got[k] - ref[k]):.2e}")
    if amp:
        flipped = abs(got["loss"] - ref["loss"]) > \
            1e-5 * max(1.0, abs(ref["loss"]))
        factor = 0.15 if flipped else 0.025
    else:
        factor = 2e-3
    worst = 0.0
    names = [n for n, _ in model.named_parameters()]
    for name, a, b in zip(names, ref_mu, mu):
        leafmax = float(np.max(np.abs(a)))
        proj_bias = name.endswith(".bias") and ".norm" not in name
        if amp:
            floor = 1e-3
        elif proj_bias and cfg["normalization"] == "batchnorm":
            floor = 1e-4
        else:
            floor = 1e-5
        tol = max(factor * leafmax, floor, 25.0 * noise_scale)
        d = float(np.max(np.abs(b - a)))
        if d > tol:
            fails.append(f"grads(mu) {name} delta {d:.2e} > {tol:.2e}")
        worst = max(worst, d)
    m["worst_grad_delta"] = worst
    for a, b in zip(ref_stats, stats):
        d = float(np.max(np.abs(b - a)))
        tol = 5e-3 * max(1.0, float(np.max(np.abs(a)))) if amp else 1e-4
        if d > tol:
            fails.append(f"batch_stats delta {d:.2e}")
            break
    return m, fails


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="", help="substring filter on name")
    ap.add_argument("--json", default="", help="write results to this file")
    args = ap.parse_args()

    import torch

    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    results, n_fail, k, ran = [], 0, 0, 0
    while ran < args.cases:
        rng = np.random.default_rng((args.seed << 20) ^ k)
        cfg = draw_config(rng)
        name = _name(cfg)
        k += 1
        if args.only and args.only not in name:
            continue
        try:
            m, fails = run_case(cfg, int(rng.integers(2**31)))
        except Exception as e:  # noqa: BLE001 - report, keep fuzzing
            m, fails = {}, [f"EXCEPTION: {type(e).__name__}: {e}"]
        ran += 1
        status = "PASS" if not fails else "FAIL"
        n_fail += bool(fails)
        print(f"{status}  #{k - 1:<4d} {name:<52}"
              + (f"  [{'; '.join(fails)}]" if fails else ""), flush=True)
        results.append({"k": k - 1, "case": name, "status": status, **m,
                        "fails": fails})
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"seed": args.seed, "results": results}, f, indent=1)
    print(f"{ran} cases, {n_fail} failed", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
