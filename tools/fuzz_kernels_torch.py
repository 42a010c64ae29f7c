#!/usr/bin/env python
"""Random-shape fuzz of the port's CUDA kernels against their plain
versions, on the card (the GPU counterpart of tools/fuzz_kernels.py).

The card tests (``tests/test_torch_kernels.py``,
``tests/test_torch_tp_kernels.py``, ``-m cuda``) hold each kernel at
hand-picked shapes. Each launch picks a plan from the card
(``fused_cells._fwd_plan`` / ``_bwd_plan`` / ``_readout_plan``,
``fused_ann._fwd_plan`` / ``_bwd_plan`` / ``_dv_tile``, ``fused_tp._bwd_plan``,
``fused_tp_ann._tp_plan``), so partial clusters, walks, partial slices and
odd shapes are reached only where a case was written for them. This tool
samples the shape space instead: case ``k`` takes the kernel family
``FAMILIES[k % len(FAMILIES)]`` (spiking forward in its serving and its
training form, spiking backward, readout forward and backward, ANN forward
and backward, TP spiking and TP ANN forward and backward at P <= 4, the TP
all-gather and reduce-scatter at P <= 8, B <= 300, H/P a multiple of 128
up to 1024, 1-6 rounds) and
draws B, T, H (or C) from ranges that include 1, odd numbers, primes and
widths no multiple of 32, one spiking forward past H = 1600 (the layout of
a block a row) and one readout past 256 classes (the wide forms) in the
first round, then the affine fold, the dropout and the stream type, all
from ``(seed, k)`` alone: a failure line is its own repro.

Each case runs the kernel and its plain version on the card and holds them
to the card tests' standard: the spiking forwards (both modes), the TP
spiking forward (V on the 2^-8 grid) and the TP collectives bit for bit;
the readout within rtol
1e-5 with its membrane series bit for bit; the ANN forwards within atol
2e-5 (the dropped positions the same wherever the raw output is nonzero on
both sides, see ``_dropped_positions``); every float32 gradient within 1e-4
of its largest magnitude; the bf16 forms within one bf16 ulp (2^-7,
relative to max(1, |v|) for a forward, to the largest magnitude for a
gradient), or else no further from the float64 plain version than 4 times
the float32 plain version is; two launches of a backward bit for bit. It
records the plan each launch took, and checks the plan the port's plan
functions give for the card (``plans_of``) against invariants
(``plan_faults``) and against the launched one.

    python tools/fuzz_kernels_torch.py --cases 60 --seed 0 \
        [--json fuzz.json] [--seconds 60] [--only ann_fwd]

Exit status 1 if any case fails or no card is present. Sizes are capped so
that a case takes about a second. This tool imports the port and PyTorch
only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FAMILIES = ("cell_fwd", "cell_fwd_train", "cell_bwd", "readout_fwd",
            "readout_bwd", "ann_fwd", "ann_bwd", "tp_fwd", "tp_bwd",
            "tp_ann_fwd", "tp_ann_bwd", "tp_all_gather", "tp_reduce_scatter")
COLLECTIVES = ("tp_all_gather", "tp_reduce_scatter")
SPIKING_FORMS = ("lif", "adlif", "rlif", "radlif")
ANN_MODES = ("rnn", "ligru", "gru")
FORM_FLAGS = {"lif": (False, False), "adlif": (False, True),
              "rlif": (True, False), "radlif": (True, True)}  # rec, adaptive

# values that hide edge bugs get extra probability
_EDGE_B = (1, 2, 3, 5, 7, 8, 9, 12, 17, 31, 33, 130)
_EDGE_T = (1, 2, 3, 5, 13, 29, 37)
_EDGE_H = (1, 7, 31, 33, 40, 100, 127, 200, 257, 513, 1001, 1024)
_EDGE_C = (1, 2, 20, 32, 33, 35, 255, 256)
WIDE_H = (1601, 2100)  # past the widest resident slice: a block a row
WIDE_C = (257, 1500)   # the readout's wide forms

FWD_ATOL = 2e-5        # the ANN forwards (float32)
GRAD_REL = 1e-4        # every float32 gradient
READOUT_RTOL = 1e-5
BF16_ULP = 2.0 ** -7
WITNESS_FACTOR = 4.0


# ---------------------------------------------------------------------------
# Drawing a case
# ---------------------------------------------------------------------------


def _pick(rng, edges, lo, hi):
    if rng.random() < 0.5:
        return int(rng.choice(edges))
    return int(rng.integers(lo, hi + 1))


def draw_case(seed: int, k: int) -> dict:
    """Case ``k`` of ``seed``: a dict of its family and draws, from
    ``(seed, k)`` alone."""
    rng = np.random.default_rng([seed, k])
    fam = FAMILIES[k % len(FAMILIES)]
    first_round = k < len(FAMILIES)
    case = dict(k=k, seed=seed, family=fam, bf16=False, affine=False,
                drop=0.0, P=1)
    if fam in COLLECTIVES:
        P = int(rng.integers(1, 9))
        case.update(P=P, B=_pick(rng, _EDGE_B + (128, 300), 1, 300),
                    rounds=int(rng.integers(1, 7)),
                    H=P * 128 * int(rng.integers(1, 9)))
        return case
    B = _pick(rng, _EDGE_B, 1, 64)
    T = _pick(rng, _EDGE_T, 1, 40)
    if fam.startswith("readout"):
        wide = first_round or rng.random() < 0.1
        C = (int(rng.integers(WIDE_C[0], WIDE_C[1] + 1)) if wide
             else _pick(rng, _EDGE_C, 1, 300))
        if wide:
            B, T = min(B, 4), min(T, 13)
        case.update(B=B, T=T, C=C)
        return case
    if fam.startswith("cell"):
        case["form"] = str(rng.choice(SPIKING_FORMS))
        wide = fam == "cell_fwd" and (first_round or rng.random() < 0.1)
        if wide:
            case["form"] = "radlif" if rng.random() < 0.5 else "rlif"
            H = int(rng.integers(WIDE_H[0], WIDE_H[1] + 1))
            B, T = min(B, 5), min(T, 7)
        else:
            H = _pick(rng, _EDGE_H, 1, 1100)
        case.update(affine=bool(rng.random() < 0.5),
                    bf16=bool(rng.random() < 0.3))
        if fam != "cell_fwd" and rng.random() < 0.6:
            case["drop"] = round(float(rng.uniform(0.1, 0.5)), 3)
    elif fam.startswith("ann"):
        case["mode"] = str(rng.choice(ANN_MODES))
        H = _pick(rng, _EDGE_H, 1, 1100)
        case.update(affine=bool(rng.random() < 0.5),
                    bf16=bool(rng.random() < 0.3))
        if rng.random() < 0.5:
            case["drop"] = round(float(rng.uniform(0.1, 0.5)), 3)
    elif fam.startswith("tp_ann"):
        case["mode"] = str(rng.choice(ANN_MODES))
        P = int(rng.choice((1, 2, 4)))
        H = P * 8 * _pick(rng, (1, 3, 4, 16, 25, 32, 64), 1, 96)
        case.update(P=P, bf16=bool(rng.random() < 0.3))
    else:  # the TP spiking cell: B % 8 == 0, H % (P * 128) == 0
        case["form"] = "radlif" if rng.random() < 0.5 else "rlif"
        P = int(rng.choice((1, 2, 4)))
        H = P * 128 * int(rng.integers(1, max(2, 8 // P) + 1))
        B = 8 * max(1, -(-B // 8))
        case.update(P=P, bf16=bool(rng.random() < 0.3))
    if case["bf16"]:
        case["wx_bf16"] = bool(rng.random() < 0.5)
    case.update(B=B, T=T, H=H)
    return case


def case_name(case: dict) -> str:
    kind = case.get("form") or case.get("mode") or ""
    steps = f"R{case['rounds']}" if "rounds" in case else f"T{case['T']}"
    shape = f"B{case['B']}{steps}" + (
        f"C{case['C']}" if "C" in case else f"H{case['H']}")
    flags = "".join([
        f"P{case['P']}" if case["family"].startswith("tp") else "",
        "+aff" if case["affine"] else "",
        f"+p{case['drop']}" if case["drop"] else "",
        "+bf16" if case["bf16"] else "",
        "+wxbf16" if case.get("wx_bf16") else ""])
    return f"{case['k']}:{case['family']}/{kind}@{shape}{flags}"


# ---------------------------------------------------------------------------
# Plans: what the port's plan functions give, and their invariants
# ---------------------------------------------------------------------------


def _spiking_fwd_form(case):
    """``slice_blocks``' leading arguments of the case's forward."""
    ada = FORM_FLAGS[case["form"]][1]
    if case["family"].startswith("tp"):  # run with its residuals
        return "tp_cell_fwd", (int(ada), 1, int(case["bf16"]))
    train = case["family"] == "cell_fwd_train"
    return "fused_cell_fwd", (int(ada), int(case["affine"]), int(train),
                              int(train and case["drop"] > 0),
                              int(case["bf16"]))


def collective_blocks_model(reduce: bool, smem: int) -> int:
    """Blocks of a TP collective an H100 SM holds at ``smem`` bytes of
    shared memory: by threads (2048 an SM) and by shared memory (233472
    bytes, 1 KB of it reserved a block)."""
    from sparch_tpu_torch.ops import fused_tp

    return max(0, min(2048 // fused_tp._COLL_THREADS,
                      233472 // (smem + 1024)))


def plans_of(case: dict, sms: int, per_sm, max_active,
             coll_per_sm=collective_blocks_model) -> dict:
    """The plans the port's plan functions give for the case on a card of
    ``sms`` SMs. ``per_sm(source, form, H, cols, rows, threads)``: blocks
    of a slice forward an SM holds; ``max_active(kernel, cluster)``:
    clusters of that size the card holds, ``kernel`` one of
    ``tp_cell_bwd``, ``tp_ann_fwd``, ``tp_ann_bwd``;
    ``coll_per_sm(reduce, smem)``: blocks of a TP collective an SM holds."""
    from sparch_tpu_torch.ops import fused_ann, fused_cells, fused_tp, \
        fused_tp_ann

    fam = case["family"]
    out = {}
    if fam in COLLECTIVES:
        reduce = fam == "tp_reduce_scatter"
        out["coll"] = fused_tp._collective_plan(
            case["B"], case["H"], case["P"], reduce, sms,
            lambda smem: coll_per_sm(reduce, smem))
        return out
    B, T, bf16 = case["B"], case["T"], case["bf16"]
    if fam.startswith("readout"):
        out["readout"] = fused_cells._readout_plan(
            B, T, case["C"], sms, fam == "readout_bwd")
        return out
    H, P = case["H"], case["P"]
    if fam in ("cell_fwd", "cell_fwd_train", "tp_fwd") and \
            FORM_FLAGS[case["form"]][0]:
        source, form = _spiking_fwd_form(case)
        out["fwd"] = fused_cells._fwd_plan(
            B, H, P, bf16, sms,
            lambda c, r, t: per_sm(source, form, H, c, r, t))
    elif fam == "cell_bwd":
        rec = FORM_FLAGS[case["form"]][0]
        plan, parts, ksplit = fused_cells._bwd_plan(B, T, H, rec, bf16)
        out.update(bwd=plan, parts=parts, ksplit=ksplit)
        if rec:
            out["dv_tile"] = fused_ann._dv_tile(H, 1, ksplit, sms)
    elif fam in ("ann_fwd", "ann_bwd"):
        n = fused_ann.MODES[case["mode"]]
        if fam == "ann_fwd":
            out["fwd"] = fused_ann._fwd_plan(B, H, n, bf16)
        else:
            plan, parts, ksplit = fused_ann._bwd_plan(B, T, H, n, bf16)
            out.update(bwd=plan, parts=parts, ksplit=ksplit,
                       dv_tile=fused_ann._dv_tile(H, n, ksplit, sms))
    elif fam == "tp_bwd":
        out["tp"] = fused_tp._bwd_plan(
            B, H, P, bf16, lambda c: max_active("tp_cell_bwd", c))
        out["part_rows"] = fused_tp._bwd_part_rows(B, H, P, sms)
    elif fam in ("tp_ann_fwd", "tp_ann_bwd"):
        mode = fused_tp_ann._MODES[case["mode"]]
        bwd = fam == "tp_ann_bwd"
        out["tp"] = fused_tp_ann._tp_plan(
            B, H, P, mode["n_wx"], bf16, mode["bwd_stack"] if bwd else 1,
            lambda c: max_active(fam, c),
            mode["bwd_operands"] if bwd else None)
    return out


def _cluster_faults(q, B, width, what):
    from sparch_tpu_torch.ops import fused_ann

    faults = []
    if q.cluster * q.cols < width or q.cols % fused_ann._COL_ALIGN:
        faults.append(f"{what}: {q.cluster} x {q.cols} columns for {width}")
    if q.clusters * q.rows < B or (q.clusters - 1) * q.rows >= B:
        faults.append(f"{what}: {q.clusters} clusters of {q.rows} rows "
                      f"for B = {B}")
    if q.threads % 32 or q.threads > 1024:
        faults.append(f"{what}: {q.threads} threads")
    if not q.resident and q.stage_bytes <= 0:
        faults.append(f"{what}: streamed with no stage")
    return faults


def plan_faults(case: dict, plans: dict, sms: int) -> list:
    """What is wrong with ``plans`` (``plans_of``'s) for the case: every
    row and neuron owned, the blocks within what the card holds, the
    chunks covering T, the tiles and splits in range."""
    from sparch_tpu_torch.ops import fused_ann, fused_cells

    faults = []
    c = plans.get("coll")
    if c is not None:
        from sparch_tpu_torch.ops import fused_tp

        B, H, P = case["B"], case["H"], case["P"]
        if c.rows < 1 or c.groups != -(-B // c.rows):
            faults.append(f"coll: {c.groups} groups of {c.rows} rows, "
                          f"B = {B}")
        if c.per_rank < 1 or c.walks * c.per_rank < c.groups or \
                (c.walks - 1) * c.per_rank >= c.groups:
            faults.append(f"coll: {c.walks} walks of {c.per_rank} for "
                          f"{c.groups} groups")
        if P * c.per_rank > c.per_sm * sms:
            faults.append(f"coll: {P * c.per_rank} blocks, the card holds "
                          f"{c.per_sm} x {sms}")
        if c.smem > fused_tp._COLL_SMEM or c.smem != fused_tp._collective_smem(
                c.rows, H, P, case["family"] == "tp_reduce_scatter"):
            faults.append(f"coll: {c.smem} bytes of shared memory")
        return faults
    B, T = case["B"], case["T"]
    p = plans.get("readout")
    if p is not None:
        C = case["C"]
        if -(-B // p.rows) * p.rows < B or p.rows < 1:
            faults.append(f"readout: rows {p.rows} for B = {B}")
        if C > fused_cells._LANE_C and p.rows != 1:
            faults.append("readout: a wide form with more than a row")
        if C <= fused_cells._LANE_C and not \
                p.rows * C <= 32 * p.warps <= fused_cells._READOUT_THREADS:
            faults.append(f"readout: {p.warps} warps for {p.rows} x {C}")
        if -(-T // p.t_chunk) * p.t_chunk < T or p.t_chunk < 1:
            faults.append(f"readout: chunks of {p.t_chunk} for T = {T}")
        if p.smem > fused_cells._READOUT_SMEM:
            faults.append(f"readout: {p.smem} bytes of shared memory")
        return faults
    H, P = case["H"], case["P"]
    f = plans.get("fwd")
    if isinstance(f, fused_cells.FwdPlan):
        hl = H // P
        if f.slices * f.cols < hl or (f.slices - 1) * f.cols >= hl:
            faults.append(f"fwd: {f.slices} slices of {f.cols} for {hl}")
        if f.n_groups != -(-B // f.rows) or f.walks * f.n_res < f.n_groups:
            faults.append(f"fwd: {f.n_groups} groups of {f.rows} rows, "
                          f"{f.n_res} at once, {f.walks} walks, B = {B}")
        if P * f.slices * f.n_res > f.per_sm * sms or f.per_sm < 1:
            faults.append(f"fwd: {P * f.slices * f.n_res} blocks, the card "
                          f"holds {f.per_sm} x {sms}")
        if f.threads > fused_cells._SLICE_THREADS or \
                fused_cells._slice_smem(H, f.cols, f.rows, f.threads,
                                        case["bf16"]) > \
                fused_cells._SLICE_SMEM:
            faults.append(f"fwd: {f.threads} threads or its shared memory")
    elif f is not None:  # a fused ANN forward's cluster plan
        faults += _cluster_faults(f, B, H, "fwd")
    if plans.get("bwd") is not None:
        faults += _cluster_faults(plans["bwd"], B, H, "bwd")
    if "ksplit" in plans:
        if not 1 <= plans["ksplit"] <= max(1, B * T):
            faults.append(f"ksplit {plans['ksplit']}")
        if plans["parts"] < 1:
            faults.append(f"parts {plans['parts']}")
    if "dv_tile" in plans and not \
            0 <= plans["dv_tile"] < len(fused_ann._DV_TILES):
        faults.append(f"dv tile {plans['dv_tile']}")
    tp = plans.get("tp")
    if tp is not None:
        faults += _cluster_faults(tp.rank, B, H // P, "tp rank")
        if P * tp.per_rank > tp.max_active or tp.per_rank < 1:
            faults.append(f"tp: {P} x {tp.per_rank} clusters, the card "
                          f"holds {tp.max_active}")
        if tp.walks * tp.per_rank < tp.rank.clusters:
            faults.append(f"tp: {tp.walks} walks of {tp.per_rank} for "
                          f"{tp.rank.clusters} groups")
    return faults


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def spiking_inputs(case, dev):
    """Clamped constants, V on the 2^-8 grid (within +-255/256, which bf16
    holds exactly; zero diagonal for the TP cell), s0 uniform in [0, 1)
    (TP: on sixteenths), the affine, a cotangent."""
    from sparch_tpu_torch.ops import fused_cells

    rng = np.random.default_rng([case["seed"], case["k"], 1])
    B, T, H = case["B"], case["T"], case["H"]
    V = np.clip(np.round(rng.normal(0, 0.3, (H, H)) * 256) / 256,
                -255 / 256, 255 / 256)
    s0 = rng.uniform(0, 1, (B, H))
    if case["family"].startswith("tp"):
        np.fill_diagonal(V, 0.0)
        s0 = np.round(s0 * 16) / 16
    d = {k: _t(v, dev) for k, v in dict(
        Wx=rng.uniform(-2.0, 4.0, (B, T, H)),
        alpha=rng.uniform(0.75, 0.99, H), beta=rng.uniform(0.95, 1.0, H),
        a=rng.uniform(-1.2, 1.2, H), b=rng.uniform(-0.2, 2.2, H), V=V,
        u0=rng.uniform(0, 1, (B, H)), w0=rng.uniform(0, 1, (B, H)), s0=s0,
        scale=rng.uniform(0.5, 2.0, H), shift=rng.uniform(-0.5, 0.5, H),
        g=rng.normal(0, 1, (B, T, H))).items()}
    d["alpha"], d["beta"], d["a"], d["b"], d["V"] = fused_cells.clip_and_mask(
        d["alpha"], d["beta"], d["a"], d["b"], d["V"])
    return d


def ann_inputs(case, dev):
    """Input streams, recurrent matrices of spectral norm about 0.5 (the
    TP tests' conditioning), the affine pairs, y0, a cotangent."""
    from sparch_tpu_torch.ops import fused_ann

    rng = np.random.default_rng([case["seed"], case["k"], 2])
    B, T, H = case["B"], case["T"], case["H"]
    n = fused_ann.MODES[case["mode"]]
    return dict(
        wxs=[_t(rng.normal(0, 1, (B, T, H)), dev) for _ in range(n)],
        vs=[_t(rng.normal(0, 0.25 / np.sqrt(H), (H, H)), dev)
            for _ in range(n)],
        scales=[_t(1.0 + 0.2 * rng.normal(size=H), dev) for _ in range(n)],
        shifts=[_t(0.1 * rng.normal(size=H), dev) for _ in range(n)],
        y0=_t(rng.uniform(0, 1, (B, H)), dev),
        g=_t(rng.normal(0, 1, (B, T, H)), dev))


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _double(x):
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, (list, tuple)):
        return [_double(v) for v in x]
    return x


def _rel(x, y) -> float:
    return float((x.double() - y.double()).abs().max()
                 / y.double().abs().max().clamp_min(1e-30))


def _equal(what, x, y):
    if not torch.equal(x, y):
        raise AssertionError(
            f"{what}: not bit-equal (max diff "
            f"{float((x.double() - y.double()).abs().max())})")


def _held(what, x, y, truth, scale):
    """``x`` within BF16_ULP * ``scale`` of ``y`` elementwise, or else no
    further from ``truth()`` (the float64 plain version) than
    WITNESS_FACTOR times ``y`` is."""
    x, y = x.double(), y.double()
    if bool(((x - y).abs() <= BF16_ULP * scale).all()):
        return
    t = truth().double()
    far, base = float((x - t).abs().max()), float((y - t).abs().max())
    if far > WITNESS_FACTOR * base:
        raise AssertionError(f"{what}: {far} from the float64 plain "
                             f"version, the float32 one {base}")


def _dropped_positions(out, y_raw, want, want_raw) -> int:
    """The dropped positions of two training forms are the same wherever
    they can be seen: where the raw output (before the dropout) is nonzero
    on both sides. A raw output of exactly 0 hides the mask, and one within
    rounding of 0 (a GRU blend whose terms cancel, a LiGRU relu) can be 0
    on one side only; there both raw values must lie within FWD_ATOL of 0.
    Returns the positions where the mask is hidden so and the two outputs'
    zeros differ."""
    differ = (out == 0) != (want == 0)
    seen = (y_raw != 0) & (want_raw != 0)
    if bool((differ & seen).any()):
        raise AssertionError(f"dropped positions differ at "
                             f"{int((differ & seen).sum())} positions")
    hidden = differ & ~seen
    if bool(hidden.any()):
        near = torch.maximum(y_raw.float().abs(), want_raw.float().abs())
        if float(near[hidden].max()) > FWD_ATOL:
            raise AssertionError(
                f"dropped positions differ where a raw output is "
                f"{float(near[hidden].max())} from 0")
    return int(hidden.sum())


def _grads(what, names, got, want, again, bf16, truth):
    """Every gradient: two launches bit for bit; within GRAD_REL of its
    largest magnitude (float32), or held by ``_held`` (bf16)."""
    cache = []

    def witness(i):
        if not cache:
            cache.extend(truth())
        return cache[i]

    for i, (n, x, y, z) in enumerate(zip(names, got, want, again)):
        if (x is None) != (y is None):
            raise AssertionError(f"{what} {n}: None on one side only")
        if x is None:
            continue
        _equal(f"{what} {n} between two launches", x, z)
        if bf16:
            _held(f"{what} {n}", x, y, lambda i=i: witness(i),
                  y.double().abs().max())
        elif _rel(x, y) > GRAD_REL:
            raise AssertionError(f"{what} {n}: {_rel(x, y)} > {GRAD_REL}")


def _flat(grads):
    """Gradients with lists by gate flattened, and their names."""
    names, flat = [], []
    for n, g in grads:
        if isinstance(g, (list, tuple)):
            for i, v in enumerate(g):
                names.append(f"{n}[{i}]")
                flat.append(v)
        else:
            names.append(n)
            flat.append(g)
    return names, flat


CELL_GRADS = ("dWx", "dscale", "dshift", "dV", "dalpha", "dbeta", "da", "db",
              "du0", "dw0", "ds0")
TP_GRADS = ("dWx", "dV", "dalpha", "dbeta", "da", "db", "du0", "dw0", "ds0")
ANN_GRADS = ("dwxs", "dscales", "dshifts", "dvs", "dy0")
TP_ANN_GRADS = ("dwxs", "dvs", "dy0")


def _seed(dev):
    return torch.tensor([42, 7], dtype=torch.int32, device=dev)


def run_spiking(case, dev):
    """The single-card spiking cell: forward (serving or training form)
    or backward."""
    from sparch_tpu_torch.ops import fused_cells

    d = spiking_inputs(case, dev)
    rec, ada = FORM_FLAGS[case["form"]]
    bf16, aff = case["bf16"], case["affine"]
    Wx = d["Wx"].bfloat16() if case.get("wx_bf16") else d["Wx"]
    args = (Wx, d["scale"] if aff else None, d["shift"] if aff else None,
            d["alpha"], d["beta"] if ada else None, d["a"] if ada else None,
            d["b"] if ada else None, d["V"] if rec else None, 1.0, d["u0"],
            d["w0"] if ada else None, d["s0"])
    kw = dict(recurrent=rec, adaptive=ada, mxu_bf16=bf16)
    fam = case["family"]
    if fam == "cell_fwd":
        got = fused_cells._fused_cell_cuda(*args, **kw)
        plan = fused_cells.last_plans().get("fused_cell_fwd")
        _equal("spikes", got, fused_cells.fused_cell_plain(*args, **kw))
        return {"fused_cell_fwd": plan}
    kw.update(drop_rate=case["drop"], seed=_seed(dev))
    if fam == "cell_fwd_train":
        out, u_seq = fused_cells._fused_cell_cuda(*args, save_residuals=True,
                                                  **kw)
        plan = fused_cells.last_plans().get("fused_cell_fwd")
        want, want_u = fused_cells.fused_cell_plain(
            *args, save_residuals=True, **kw)
        _equal("spikes", out, want)
        _equal("membrane series", u_seq, want_u)
        return {"fused_cell_fwd": plan}
    _, u_seq = fused_cells.fused_cell_plain(*args, save_residuals=True, **kw)
    g = d["g"].bfloat16() if bf16 else d["g"]
    Wx, scale, _, alpha, beta, a, b, V, thr, u0, w0, s0 = args
    bargs = (g, Wx, u_seq, scale, alpha, beta, a, b, V, thr, u0, w0, s0)
    got = fused_cells._fused_cell_bwd_cuda(*bargs, **kw)
    plan = fused_cells.last_plans().get("fused_cell_bwd")
    again = fused_cells._fused_cell_bwd_cuda(*bargs, **kw)
    want = fused_cells.fused_cell_bwd_plain(*bargs, **kw)
    _grads("fused_cell_bwd", CELL_GRADS, got, want, again, bf16,
           lambda: fused_cells.fused_cell_bwd_plain(*_double(list(bargs)),
                                                    **kw))
    return {"fused_cell_bwd": plan}


def run_readout(case, dev):
    from sparch_tpu_torch.ops import fused_cells

    rng = np.random.default_rng([case["seed"], case["k"], 3])
    B, T, C = case["B"], case["T"], case["C"]
    Wx = _t(rng.uniform(-2.0, 4.0, (B, T, C)), dev)
    alpha = fused_cells.clip_and_mask(_t(rng.uniform(0.75, 0.99, C), dev))[0]
    u0 = _t(rng.uniform(0, 1, (B, C)), dev)
    backward = case["family"] == "readout_bwd"
    plan = fused_cells._card_readout_plan(B, T, C, dev, backward)
    out, u_seq = fused_cells._readout_cuda(Wx, alpha, u0, save_residuals=True)
    want, want_u = fused_cells.readout_plain(Wx, alpha, u0,
                                             save_residuals=True)
    torch.testing.assert_close(out, want, rtol=READOUT_RTOL, atol=1e-6)
    _equal("membrane series", u_seq, want_u)
    name = "readout_fwd"
    if backward:
        name = "readout_bwd"
        gout = _t(rng.normal(0, 1, (B, C)), dev)
        got = fused_cells._readout_bwd_cuda(gout, u_seq, alpha, u0)
        again = fused_cells._readout_bwd_cuda(gout, u_seq, alpha, u0)
        _grads("readout_bwd", ("dWx", "dalpha", "du0"), got,
               fused_cells.readout_bwd_plain(gout, u_seq, alpha, u0), again,
               False, None)
    else:
        _equal("two launches", out, fused_cells._readout_cuda(Wx, alpha, u0))
    return {name: plan._asdict()}


def run_ann(case, dev):
    from sparch_tpu_torch.ops import fused_ann

    d = ann_inputs(case, dev)
    mode, bf16, aff, p = case["mode"], case["bf16"], case["affine"], \
        case["drop"]
    n = fused_ann.MODES[mode]
    wxs = [w.bfloat16() for w in d["wxs"]] if case.get("wx_bf16") \
        else d["wxs"]
    ops = (wxs, d["scales"] if aff else None, d["shifts"] if aff else None,
           d["vs"], d["y0"])
    kw = dict(drop_rate=p, seed=_seed(dev), mxu_bf16=bf16)
    B, T, H = case["B"], case["T"], case["H"]
    if case["family"] == "ann_fwd":
        plan = fused_ann._fwd_plan(B, H, n, bf16)
        out, y_raw, gates = fused_ann._ann_cell_cuda(
            mode, *ops, save_residuals=True, **kw)
        served = fused_ann._ann_cell_cuda(mode, *ops, **kw)
        want, want_raw, want_gates = fused_ann.ann_cell_plain(
            mode, *ops, save_residuals=True, **kw)
        _equal("served vs training form", served, out)
        notes = {}
        if p:
            notes["mask_hidden_by_zero"] = _dropped_positions(
                out, y_raw, want, want_raw)
        series = [(out, want), (y_raw, want_raw), *zip(gates, want_gates)]
        cache = []

        def witness(i):
            if not cache:
                t_out, t_raw, t_gates = fused_ann.ann_cell_plain(
                    mode, *_double(list(ops)), save_residuals=True, **kw)
                cache.extend([t_out, t_raw, *t_gates])
            return cache[i]

        for i, (x, y) in enumerate(series):
            if (x is None) != (y is None):
                raise AssertionError(f"series {i}: None on one side only")
            if x is None:
                continue
            if bf16:
                _held(f"series {i}", x, y, lambda i=i: witness(i),
                      y.double().abs().clamp_min(1.0))
            else:
                atol = FWD_ATOL / (1.0 - p) if i == 0 else FWD_ATOL
                torch.testing.assert_close(x, y, rtol=0, atol=atol)
        return {f"fused_ann_fwd_{mode}": plan._asdict(), "notes": notes}
    plan, parts, ksplit = fused_ann._bwd_plan(B, T, H, n, bf16)
    out, y_raw, gates = fused_ann.ann_cell_plain(
        mode, *ops, save_residuals=True, **kw)
    y_seq = out if y_raw is None else y_raw
    g = d["g"].bfloat16() if bf16 else d["g"]
    bargs = (mode, g, wxs if aff else None, y_seq, gates, ops[1], d["vs"],
             d["y0"])
    got = fused_ann._ann_cell_bwd_cuda(*bargs, **kw)
    again = fused_ann._ann_cell_bwd_cuda(*bargs, **kw)
    want = fused_ann.ann_cell_bwd_plain(*bargs, **kw)
    names, got = _flat(zip(ANN_GRADS, got))
    _, again = _flat(zip(ANN_GRADS, again))
    _, want = _flat(zip(ANN_GRADS, want))
    _grads(f"fused_ann_bwd_{mode}", names, got, want, again, bf16,
           lambda: _flat(zip(ANN_GRADS, fused_ann.ann_cell_bwd_plain(
               *_double(list(bargs)), **kw)))[1])
    return {f"fused_ann_bwd_{mode}": dict(
        plan._asdict(), parts=parts, ksplit=ksplit,
        dv_tile=fused_ann._DV_TILES[fused_ann._card_dv_tile(H, n, ksplit,
                                                            dev)])}


def run_tp(case, dev):
    """The TP spiking cell in the one-card form: forward or backward."""
    from sparch_tpu_torch.ops import fused_tp

    d = spiking_inputs(case, dev)
    ada = FORM_FLAGS[case["form"]][1]
    bf16, P = case["bf16"], case["P"]
    Wx = d["Wx"].bfloat16() if case.get("wx_bf16") else d["Wx"]
    args = (Wx, d["alpha"], d["beta"] if ada else None,
            d["a"] if ada else None, d["b"] if ada else None, d["V"], 1.0,
            d["u0"], d["w0"] if ada else None, d["s0"])
    kw = dict(num_devices=P, adaptive=ada, mxu_bf16=bf16)
    if case["family"] == "tp_fwd":
        got, got_u = fused_tp._tp_cell_cuda(*args, save_residuals=True, **kw)
        plan = fused_tp.last_plans()["tp_cell_fwd"]
        want, want_u = fused_tp.tp_cell_plain(*args, save_residuals=True,
                                              **kw)
        _equal("spikes", got, want)
        _equal("membrane series", got_u, want_u)
        return {"tp_cell_fwd": plan}
    _, u_seq = fused_tp.tp_cell_plain(*args, save_residuals=True, **kw)
    g = d["g"].bfloat16() if bf16 else d["g"]
    bargs = (g, u_seq, *args[1:])
    got = fused_tp._tp_cell_bwd_cuda(*bargs, **kw)
    plan = fused_tp.last_bwd_plan()
    again = fused_tp._tp_cell_bwd_cuda(*bargs, **kw)
    want = fused_tp.tp_cell_bwd_plain(*bargs, **kw)
    _grads("tp_cell_bwd", TP_GRADS, got, want, again, bf16,
           lambda: fused_tp.tp_cell_bwd_plain(*_double(list(bargs)), **kw))
    return {"tp_cell_bwd": plan}


def run_tp_ann(case, dev):
    from sparch_tpu_torch.ops import fused_tp_ann

    d = ann_inputs(case, dev)
    mode, bf16, P = case["mode"], case["bf16"], case["P"]
    wxs = [w.bfloat16() for w in d["wxs"]] if case.get("wx_bf16") \
        else d["wxs"]
    args = (mode, wxs, d["vs"], d["y0"])
    kw = dict(num_devices=P, mxu_bf16=bf16)
    if case["family"] == "tp_ann_fwd":
        got, got_g = fused_tp_ann._tp_ann_cell_cuda(*args, save_residuals=True,
                                                    **kw)
        plan = fused_tp_ann.last_plan("tp_ann_fwd")
        served = fused_tp_ann._tp_ann_cell_cuda(*args, **kw)
        want, want_g = fused_tp_ann.tp_ann_cell_plain(
            *args, save_residuals=True, **kw)
        _equal("served vs training form", served, got)
        cache = []

        def witness(i):
            if not cache:
                t_out, t_g = fused_tp_ann.tp_ann_cell_plain(
                    mode, *_double(list(args[1:])), save_residuals=True,
                    **kw)
                cache.extend([t_out, *t_g])
            return cache[i]

        for i, (x, y) in enumerate(zip((got, *got_g), (want, *want_g))):
            if bf16:
                _held(f"series {i}", x, y, lambda i=i: witness(i),
                      y.double().abs().clamp_min(1.0))
            else:
                torch.testing.assert_close(x, y, rtol=0, atol=FWD_ATOL)
        return {"tp_ann_fwd": plan}
    out, gates = fused_tp_ann.tp_ann_cell_plain(*args, save_residuals=True,
                                                **kw)
    g = d["g"].bfloat16() if bf16 else d["g"]
    bargs = (mode, g, out, gates, d["vs"], d["y0"])
    got = fused_tp_ann._tp_ann_cell_bwd_cuda(*bargs, **kw)
    plan = fused_tp_ann.last_plan("tp_ann_bwd")
    again = fused_tp_ann._tp_ann_cell_bwd_cuda(*bargs, **kw)
    want = fused_tp_ann.tp_ann_cell_bwd_plain(*bargs, **kw)
    names, got = _flat(zip(TP_ANN_GRADS, got))
    _, again = _flat(zip(TP_ANN_GRADS, again))
    _, want = _flat(zip(TP_ANN_GRADS, want))
    _grads("tp_ann_bwd", names, got, want, again, bf16,
           lambda: _flat(zip(TP_ANN_GRADS, fused_tp_ann.tp_ann_cell_bwd_plain(
               *_double(list(bargs)), **kw)))[1])
    return {"tp_ann_bwd": plan}


def run_collective(case, dev):
    """A TP collective in the one-card form, bit for bit against its
    plain version."""
    from sparch_tpu_torch.ops import fused_tp

    rng = np.random.default_rng([case["seed"], case["k"], 3])
    fam, P, B, H = case["family"], case["P"], case["B"], case["H"]
    kw = dict(num_devices=P, rounds=case["rounds"])
    if fam == "tp_all_gather":
        x = _t(rng.normal(0, 1, (B, H)), dev)
        got = fused_tp._tp_all_gather_cuda(x, **kw)
        want = fused_tp.tp_all_gather_plain(x, **kw)
    else:
        x = _t(rng.normal(0, 1, (P, B, H)), dev)
        got = fused_tp._tp_reduce_scatter_cuda(x, **kw)
        want = fused_tp.tp_reduce_scatter_plain(x, **kw)
    _equal("output", got, want)
    return {fam: fused_tp.last_plans()[fam]}


RUNNERS = {"cell": run_spiking, "readout": run_readout, "ann": run_ann,
           "tp": run_tp, "tp_ann": run_tp_ann, "coll": run_collective}


def _runner(family):
    if family in COLLECTIVES:
        return RUNNERS["coll"]
    for prefix in ("tp_ann", "tp", "readout", "ann", "cell"):
        if family.startswith(prefix):
            return RUNNERS[prefix]
    raise KeyError(family)


def _jsonable(plan):
    if plan is None or isinstance(plan, (int, float, str, bool)):
        return plan
    if hasattr(plan, "_asdict"):
        return {k: _jsonable(v) for k, v in plan._asdict().items()}
    if isinstance(plan, dict):
        return {k: _jsonable(v) for k, v in plan.items()}
    if isinstance(plan, (list, tuple)):
        return [_jsonable(v) for v in plan]
    return str(plan)


def card_plans(case, dev) -> dict:
    """``plans_of`` with the card's SMs and occupancy queries."""
    from sparch_tpu_torch.ops import fused_cells, fused_tp, fused_tp_ann

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mode = case.get("mode")

    def per_sm(source, form, H, c, r, t):
        return fused_cells.slice_blocks(source, *form, H, c, r, t)

    def max_active(kernel, c):
        B, H, P, bf16 = case["B"], case["H"], case["P"], case["bf16"]
        if kernel == "tp_cell_bwd":
            return fused_tp._bwd_max_active(
                B, H, P, FORM_FLAGS[case["form"]][1], bf16, c,
                fused_tp._bwd_part_rows(B, H, P, sms))
        return fused_tp_ann.max_active_clusters(
            mode, B, H, P, c, bf16, kernel == "tp_ann_bwd")

    with torch.cuda.device(dev):
        index = torch.cuda.current_device()
        return plans_of(case, sms, per_sm, max_active,
                        lambda reduce, smem: fused_tp.collective_blocks(
                            reduce, smem, index))


def run_case(case: dict, dev) -> dict:
    """Run one case on the card; returns its record (``ok``, ``error``,
    the launched plans, the plans' faults, seconds)."""
    t0 = time.perf_counter()
    rec = dict(case=case_name(case), family=case["family"], ok=True)
    try:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        expected = card_plans(case, dev)
        faults = plan_faults(case, expected, sms)
        launched = _runner(case["family"])(case, dev)
        torch.cuda.synchronize(dev)
        notes = launched.pop("notes", None)
        if notes:
            rec["notes"] = notes
        rec["plans"] = _jsonable(launched)
        fwd = expected.get("fwd")
        got = next(iter(launched.values()))
        coll = expected.get("coll")
        if coll is not None and got != coll._asdict():
            faults.append(f"launched {got}, planned {coll._asdict()}")
        if fwd is not None and hasattr(fwd, "layout") and \
                isinstance(got, dict) and got.get("layout") == "slices" \
                and got != fwd._asdict():
            faults.append(f"launched {got}, planned {fwd._asdict()}")
        if faults:
            raise AssertionError("; ".join(faults))
    except Exception as e:  # a failure is a record, not an exit
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc(limit=4))
    rec["seconds"] = time.perf_counter() - t0
    return rec


def run(cases: int, seed: int = 0, seconds=None, only=None, dev=None,
        log=None) -> dict:
    """Cases 0 .. ``cases`` - 1 of ``seed`` (only the family ``only``, if
    given), stopping early past ``seconds`` once every family ran; returns
    the summary and the records."""
    from sparch_tpu_torch.ops import fused_cells

    dev = torch.device("cuda") if dev is None else dev
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    records, seen = [], set()
    counts_before = fused_cells.launch_counts()
    for k in range(cases):
        case = draw_case(seed, k)
        if only and case["family"] != only:
            continue
        rec = run_case(case, dev)
        records.append(rec)
        seen.add(case["family"])
        if log is not None:
            log(("ok   " if rec["ok"] else "FAIL ") + rec["case"] +
                f" {rec['seconds']:.2f} s" +
                ("" if rec["ok"] else f"\n     {rec['error']}"))
        if seconds is not None and time.perf_counter() - t0 > seconds and \
                (only or seen == set(FAMILIES)):
            break
    after = fused_cells.launch_counts()
    failed = [r for r in records if not r["ok"]]
    by_family = {}
    for r in records:
        by_family[r["family"]] = by_family.get(r["family"], 0) + 1
    plans = sorted({json.dumps(v, sort_keys=True) for r in records
                    for v in (r.get("plans") or {}).values()
                    if isinstance(v, (dict, list))})
    hidden = [(r["case"], r["notes"]["mask_hidden_by_zero"])
              for r in records if r.get("notes", {}).get(
                  "mask_hidden_by_zero")]
    return dict(
        seed=seed, cases=len(records), families=by_family,
        mask_hidden_by_zero=hidden,
        failures=len(failed), failed=[r["case"] for r in failed],
        errors=[r["error"] for r in failed],
        plans_seen=len(plans),
        launches={k: after[k] - counts_before.get(k, 0) for k in after
                  if after[k] != counts_before.get(k, 0)},
        seconds=time.perf_counter() - t0, records=records)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cases", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=None,
                    help="stop drawing cases past this time, once every "
                    "family ran")
    ap.add_argument("--only", choices=FAMILIES, default=None)
    ap.add_argument("--json", default=None,
                    help="write the summary and every case's record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fuzz_kernels_torch: no CUDA device", file=sys.stderr)
        return 1
    summary = run(args.cases, args.seed, args.seconds, args.only,
                  log=lambda s: print(s, flush=True))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    brief = {k: v for k, v in summary.items() if k != "records"}
    print(json.dumps(brief), flush=True)
    return 1 if summary["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
