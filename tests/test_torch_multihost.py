"""Data parallelism of the port (``parallel/multihost.py``, the ``data``
axis, global batch statistics) and ``--cell_impl pallas_tp --mesh_model
P`` through the CLI, on the CPU.

The ranks are processes of a gloo group over a ``file://`` store in the
test's temporary directory (``tests/torch_dp_worker.py``, which imports no
JAX); one start of two ranks runs every two-rank case of this file and one
start of four the four-rank one, both started together while the JAX run
compiles.

- LIF [16, 16, 20] with batchnorm (zero states, no dropout), 3 train steps
  of a global batch of 16 at R = 2 and 4 against the JAX ``make_train_step``
  on its 8-device CPU mesh with the batch sharded on ``data``: the loss
  (the ranks' mean), the weights and the running statistics within rtol
  1e-5, every rank's state equal bit for bit.
- RadLIF bidirectional with dropout 0.1 and uniform states, no
  normalization, weights on a 2^-8 grid, at R = 2 against R = 1 on the scan
  path (generator masks) and the fused plain path (the hash with the
  global-row map): the first step's spikes bit for bit, each of its
  gradients within 1e-6 of its largest magnitude; and the fused plain path
  with batchnorm and the regularizers (the global statistics and firing
  rates with their all-reduced gradients): the spikes bit for bit at this
  size, the gradients within 1e-5.
- The global-row map of the hash dropout: the plain masks, forwards and
  backwards of two half batches equal the rows of the whole batch's, the
  bidirectional stacking included.
- The sequence pipeline under data parallelism: LIF [16, 16, 20] with
  batchnorm and the default recipe (dropout 0.1, uniform states), 3
  time-pipelined steps (S = 2, M = 2) at R = 2 against one process at S =
  2 on the global batch: the loss, the weights and the running statistics
  within rtol 1e-5, every rank's state equal bit for bit.
- A 2-rank CLI run on SHD-schema files against the 1-rank run of the same
  argv (the loaders' shards and forced ``drop_last`` included), and
  ``--cell_impl pallas_tp --mesh_model 2`` at H = 256 against ``--cell_impl
  scan`` of the same argv, its ragged last batch of 4 rows included.
- A rank's forward outside ``multihost.sharded()`` is its own batch's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run_exp_torch
from sparch_tpu.parallel import mesh as jax_mesh
from sparch_tpu.train import make_train_step as jax_make_train_step
from sparch_tpu.train.state import TrainState as JaxTrainState
from sparch_tpu.train.state import adam_with_injectable_lr
from sparch_tpu_torch.convert import variables_from_flax, variables_to_flax
from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.ops import fused_ann, fused_cells

from . import torch_dp_worker as worker
from .fixtures import make_shd_h5
from .test_torch_models import _leaves, jax_snn

B, T, F, H, C = 16, 12, 12, 16, 20
LR = 1e-3
STEPS = 3
LIF_CFG = dict(type="LIF", shape=(B, T, F), sizes=[H, H, C],
               kw=dict(state_init="zeros", normalization="batchnorm"))
SEQ_CFG = dict(LIF_CFG, kw=dict(state_init="uniform", dropout=0.1,
                                normalization="batchnorm"))
RAD_B, RAD_H, RAD_C = 8, 16, 5
N_TRAIN, N_TEST = 24, 16


@pytest.fixture(scope="module")
def lif_case():
    """The JAX LIF model, its variables and the global batches."""
    jmodel, variables, _ = jax_snn("LIF", "scan", shape=(B, T, F),
                                   sizes=(H, H, C))
    rng = np.random.default_rng(3)
    batches = [((rng.integers(0, 5, (B, T, F)) / 4.0).astype(np.float32),
                rng.integers(0, C, B)) for _ in range(STEPS)]
    payload = dict(cfg=LIF_CFG, state_dict=variables_from_flax(variables),
                   batches=batches, steps=STEPS, lr=LR, seed=0)
    return jmodel, variables, batches, payload


@pytest.fixture(scope="module")
def lif(lif_case, ranks):
    """The JAX run on the 8-device mesh (while the ranks run): its losses
    and final variables, and the port's payload."""
    jmodel, variables, batches, payload = lif_case
    mesh = jax_mesh.make_mesh(model=1)
    assert mesh.devices.shape == (8, 1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = adam_with_injectable_lr(LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(0), tx=tx)
    jstate = jax_mesh.shard_state(jstate, mesh)
    jstep = jax_make_train_step(jmodel, donate=False)
    sharding = jax_mesh.batch_sharding(mesh)
    losses = []
    for x, y in batches:
        jstate, met = jstep(jstate, jax.device_put(x, sharding),
                            jax.device_put(y, sharding))
        losses.append(float(met["loss"]))
    want = jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats})
    return payload, losses, want


def _dyadic_radlif(cell_impl, bidirectional, norm):
    model = build_model(
        "RadLIF", (RAD_B, T, F), [RAD_H, RAD_H, RAD_C], dropout=0.1,
        normalization=norm, bidirectional=bidirectional,
        state_init="uniform", cell_impl=cell_impl,
        generator=torch.Generator().manual_seed(5))
    # the input weights scaled up (no norm lifts the drive) so that the
    # layers spike, everything on a 2^-8 grid
    sd = {k: torch.round(v * (16384 if k.endswith("W.weight") else 256))
          / 256 for k, v in model.state_dict().items()}
    for k in sd:  # the normalised drive lifted too: gain 4, bias 1/2
        if k.endswith("norm.weight") or k.endswith("norm.bias"):
            sd[k] = torch.full_like(sd[k], 4.0 if "weight" in k else 0.5)
    rng = np.random.default_rng(4)
    batches = [((rng.integers(0, 5, (RAD_B, T, F)) / 4.0)
                .astype(np.float32), rng.integers(0, RAD_C, RAD_B))]
    cfg = dict(type="RadLIF", shape=(RAD_B, T, F),
               sizes=[RAD_H, RAD_H, RAD_C],
               kw=dict(dropout=0.1, normalization=norm,
                       bidirectional=bidirectional, state_init="uniform",
                       cell_impl=cell_impl))
    # batchnorm with the regularizers: the global statistics and firing
    # rates, and their all-reduced gradients
    step_kw = dict(use_regularizers=True, reg_fmin=0.05, reg_fmax=0.2) \
        if norm == "batchnorm" else {}
    return dict(cfg=cfg, state_dict=sd, batches=batches, steps=1, lr=LR,
                seed=7, spikes=True, step_kw=step_kw)


# (cell_impl, bidirectional, normalization)
RADLIF_FORMS = [("scan", True, "none"), ("pallas", True, "none"),
                ("pallas", False, "batchnorm")]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shd"))
    make_shd_h5(f"{d}/shd_train.h5", n=N_TRAIN, nb_classes=4, seed=0,
                noise_frac=0.3)
    make_shd_h5(f"{d}/shd_test.h5", n=N_TEST, nb_classes=4, seed=1,
                noise_frac=0.3)
    return d


def cli_argv(data, *extra):
    return ["--dataset_name", "shd", "--data_folder", data,
            "--batch_size", "8", "--nb_hiddens", "16", "--nb_layers", "2",
            "--nb_epochs", "2", "--nb_steps", "20", "--state_init", "zeros",
            "--pdrop", "0", *extra]


def _jobs2(lif_payload, data, tmp):
    """Every two-rank case of this file, for one start of the ranks."""
    jobs = [("train_steps", lif_payload)]
    jobs += [("train_steps", _dyadic_radlif(*form))
             for form in RADLIF_FORMS]
    fwd = _dyadic_radlif("pallas", True, "batchnorm")
    x = fwd["batches"][0][0]
    jobs += [("local_forward", dict(cfg=fwd["cfg"],
                                    state_dict=fwd["state_dict"], seed=9,
                                    x=[x[:RAD_B // 2], x[RAD_B // 2:]]))]
    jobs += [("train_steps", dict(lif_payload, cfg=SEQ_CFG, seq=2,
                                  n_micro=2))]
    jobs += [("cli", dict(argv=cli_argv(data, "--new_exp_folder",
                                        str(tmp / "exp")))), ("pad", {})]
    return jobs


@pytest.fixture(scope="module")
def ranks(lif_case, data, tmp_path_factory):
    """The two-rank and the four-rank processes, started together."""
    tmp = tmp_path_factory.mktemp("ranks")
    jobs = _jobs2(lif_case[3], data, tmp)
    return jobs, worker.Ranks("many", 2, jobs, tmp), \
        worker.Ranks("train_steps", 4, lif_case[3], tmp)


@pytest.fixture(scope="module")
def two_ranks(ranks):
    return ranks[0], ranks[1].results()


def _check_lif(results, losses, want):
    for r, res in enumerate(results[1:], 1):
        for k, v in res["state"].items():
            assert torch.equal(v, results[0]["state"][k]), (r, k)
    got_losses = np.mean([res["loss"] for res in results], axis=0)
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    got = variables_to_flax(results[0]["state"])
    for coll in ("params", "batch_stats"):
        got_leaves = dict(_leaves(got[coll]))
        for path, w in _leaves(want[coll]):
            np.testing.assert_allclose(
                np.asarray(got_leaves[path]), w, rtol=1e-5, atol=1e-7,
                err_msg=coll + "/" + "/".join(path))


def test_lif_batchnorm_steps_match_jax_mesh_r2(lif, two_ranks):
    _, results = two_ranks
    _check_lif([res[0] for res in results], lif[1], lif[2])
    # the all-reduces of a step: a norm's statistics and their gradient,
    # the firing rates, the gradients (one of them all)
    counts = results[0][0]["counts"]
    assert counts["grads"] == 1
    assert counts["stats"] == counts["stats_grad"] == 3  # 2 layers + readout
    assert counts["rates"] == 1


def test_lif_batchnorm_steps_match_jax_mesh_r4(lif, ranks):
    _check_lif(ranks[2].results(), lif[1], lif[2])


@pytest.mark.parametrize("form", range(len(RADLIF_FORMS)),
                         ids=[f"{i}-{'bidir' if bd else 'udir'}-{n}"
                              for i, bd, n in RADLIF_FORMS])
def test_radlif_dropout_two_ranks_take_the_one_rank_step(two_ranks, form):
    jobs, results = two_ranks
    payload = jobs[1 + form][1]
    one = worker.train_steps(payload)
    two = [res[1 + form] for res in results]
    assert len(one["spikes"]) == 3
    for i, whole in enumerate(one["spikes"][:2]):
        halves = torch.cat([r["spikes"][i] for r in two])
        assert torch.equal(halves, whole), f"layer {i}"
        assert 0.02 < float((whole != 0).float().mean()) < 0.9
    np.testing.assert_allclose(torch.cat([r["spikes"][2] for r in two]),
                               one["spikes"][2], rtol=1e-6, atol=1e-6)
    # each gradient within 1e-6 of its largest magnitude (1e-5 with the
    # global statistics, summed over the ranks, and the regularizers): the
    # ranks' mean sums in another order
    tol = 1e-5 if RADLIF_FORMS[form][2] == "batchnorm" else 1e-6
    for k, g in one["grads"].items():
        for r in two:
            np.testing.assert_allclose(
                r["grads"][k], g, rtol=0,
                atol=tol * max(float(g.abs().max()), 1e-30), err_msg=k)
    assert max(float(g.abs().max()) for g in one["grads"].values()) > 1e-3


def test_a_forward_outside_sharded_is_its_own_batch(two_ranks):
    """A rank's forward outside ``multihost.sharded()`` (a server, an eval
    that one rank runs) is its own batch's alone, process group or not:
    no all-reduce, and the one-process forward of that batch (its own
    states, masks and BatchNorm statistics)."""
    jobs, results = two_ranks
    payload = jobs[1 + len(RADLIF_FORMS)][1]
    for r, res in enumerate(results):
        got = res[1 + len(RADLIF_FORMS)]
        one = worker.local_forward(dict(payload, x=[payload["x"][r]]))
        assert got["calls"] == {}
        assert torch.equal(got["rates"], one["rates"])
        torch.testing.assert_close(got["out"], one["out"], rtol=1e-6,
                                   atol=1e-6)


def test_seq_pipeline_two_ranks_take_the_one_process_steps(two_ranks):
    """Each rank pipelines its rows of the global batch (the noise drawn
    for the global batch, the global statistics and firing rates); the
    ranks' mean loss and their state are the one process's."""
    jobs, results = two_ranks
    index = 2 + len(RADLIF_FORMS)
    payload = jobs[index][1]
    one = worker.train_steps(payload)
    two = [res[index] for res in results]
    for k, v in two[0]["state"].items():
        assert torch.equal(two[1]["state"][k], v), k
    np.testing.assert_allclose(np.mean([r["loss"] for r in two], axis=0),
                               one["loss"], rtol=1e-5)
    np.testing.assert_allclose(np.mean([r["rate"] for r in two], axis=0),
                               one["rate"], rtol=1e-5)
    assert min(one["rate"]) > 0.0
    for k, v in one["state"].items():
        np.testing.assert_allclose(two[0]["state"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # the step's all-reduces: the three norms' statistics and their
    # gradients, the firing rates, the gradients
    counts = two[0]["counts"]
    assert counts["grads"] == 1 and counts["rates"] == 1
    assert counts["stats"] == counts["stats_grad"] == 3


def _halves(B, bidir):
    """The two ranks' row maps of a batch of B (2B rows stacked where
    bidirectional), and each rank's rows of the whole batch."""
    Bl = B // 2
    maps = [(Bl, B, r * Bl) for r in (0, 1)]
    segs = 2 if bidir else 1
    rows = [torch.cat([torch.arange(s * B + r * Bl, s * B + (r + 1) * Bl)
                       for s in range(segs)]) for r in (0, 1)]
    return maps, rows


@pytest.mark.parametrize("bidir", [False, True], ids=["udir", "bdir"])
def test_dropout_row_map_halves_equal_the_whole(bidir):
    Bw, Hh, keep = 24, 40, fused_cells.keep_u32(0.3)
    seed = torch.tensor([123, -77], dtype=torch.int32)
    n = 2 * Bw if bidir else Bw
    maps, rows = _halves(Bw, bidir)
    whole = fused_cells._keep_rows(n, Hh, seed, 3, keep)
    for m, idx in zip(maps, rows):
        half = fused_cells._keep_rows(n // 2, Hh, seed, 3, keep, m)
        assert torch.equal(half, whole[idx])
    # and through the plain versions of the spiking and GRU kernels,
    # forward and backward
    g = torch.Generator().manual_seed(0)
    Tn = 5
    wx = torch.randn(n, Tn, Hh, generator=g)
    V = torch.randn(Hh, Hh, generator=g) * 0.1
    vec = torch.rand(Hh, generator=g) * 0.5 + 0.3
    st = [torch.rand(n, Hh, generator=g) for _ in range(3)]
    cell = dict(recurrent=True, adaptive=True, drop_rate=0.3, seed=seed)
    out, u = fused_cells.fused_cell_plain(
        wx, None, None, vec, vec, vec, vec, V, 1.0, *st, **cell,
        save_residuals=True)
    gout = torch.randn(n, Tn, Hh, generator=g)
    dwx = fused_cells.fused_cell_bwd_plain(
        gout, wx, u, None, vec, vec, vec, vec, V, 1.0, *st, **cell)[0]
    y0 = torch.zeros(n, Hh)
    ann = fused_ann.ann_cell_plain("gru", [wx] * 3, None, None, [V] * 3, y0,
                                   drop_rate=0.3, seed=seed)
    for m, idx in zip(maps, rows):
        sl = [s[idx] for s in st]
        o, uh = fused_cells.fused_cell_plain(
            wx[idx], None, None, vec, vec, vec, vec, V, 1.0, *sl, **cell,
            save_residuals=True, drop_rows=m)
        assert torch.equal(o, out[idx])
        d = fused_cells.fused_cell_bwd_plain(
            gout[idx], wx[idx], uh, None, vec, vec, vec, vec, V, 1.0, *sl,
            **cell, drop_rows=m)[0]
        assert torch.equal(d, dwx[idx])
        a = fused_ann.ann_cell_plain("gru", [wx[idx]] * 3, None, None,
                                     [V] * 3, y0[idx], drop_rate=0.3,
                                     seed=seed, drop_rows=m)
        assert torch.equal(a, ann[idx])
    with pytest.raises(ValueError, match="does not map"):
        fused_cells._drop_map(10, (4, 8, 0))


def _numbers(history):
    keys = ("split", "epoch", "loss", "acc", "rate", "utterances")
    return [{k: h[k] for k in keys if k in h} for h in history]


def _close_weights(got, want, lr):
    """Every weight within rtol 1e-4 / atol 1e-5, but for at most one in
    10^4 whose gradient was small enough for rounding to tip Adam's step
    (|g| near its epsilon): those within the steps' sum of lr."""
    for k, v in want.items():
        g, w = np.asarray(got[k]), np.asarray(v)
        off = ~np.isclose(g, w, rtol=1e-4, atol=1e-5)
        assert off.sum() <= w.size // 10000, (k, int(off.sum()))
        np.testing.assert_allclose(g, w, rtol=0, atol=lr, err_msg=k)


def test_two_rank_cli_run_equals_the_one_rank_run(two_ranks, data,
                                                  tmp_path):
    _, results = two_ranks
    two = [res[-2] for res in results]
    one = worker.cli(dict(argv=cli_argv(data, "--new_exp_folder",
                                        str(tmp_path / "exp"))))
    # the loaders: each rank a contiguous half of every global batch, the
    # ragged last batch dropped (24 utterances: 3 batches of 8)
    assert one["loader"]["drop_last"] is False
    for r, res in enumerate(two):
        assert res["loader"] == dict(num_shards=2, shard_index=r, batches=3,
                                     drop_last=True, rows=[4, 4, 4])
        assert res["mesh"] == {"data": 2, "model": 1}
        assert _numbers(res["history"]) == _numbers(two[0]["history"])
    for a, b in zip(one["history"], two[0]["history"]):
        assert a["split"] == b["split"] and a["epoch"] == b["epoch"]
        for k in ("loss", "acc", "rate"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{a['split']} {k}")
    _close_weights(two[0]["state"], one["state"], 1e-2)


def test_hd_sc_batches_pad_to_the_global_length(two_ranks):
    """HD/SC batches are as long as their longest utterance: each rank's
    (3 and 4 frames) is padded with zeros to the global batch's."""
    _, results = two_ranks
    for r, res in enumerate(results):
        feats, (waves, lens) = res[-1]
        n = 3 + r
        assert feats.shape == (2, 4, 4) and waves.shape == (2, 640)
        assert feats[:, :n].eq(1).all() and feats[:, n:].eq(0).all()
        assert waves[:, :160 * n].eq(1).all()
        assert waves[:, 160 * n:].eq(0).all()
        assert lens.tolist() == [n, n - 1]


def test_pallas_tp_mesh_model_2_through_the_cli(tmp_path):
    data = str(tmp_path)
    make_shd_h5(f"{data}/shd_train.h5", n=20, nb_classes=4, seed=2)
    make_shd_h5(f"{data}/shd_test.h5", n=16, nb_classes=4, seed=3)
    argv = cli_argv(data, "--model_type", "RadLIF", "--nb_epochs", "1",
                    "--nb_hiddens", "256", "--nb_steps", "8",
                    "--batch_size", "16")
    scan = run_exp_torch.main(
        argv + ["--cell_impl", "scan", "--new_exp_folder",
                str(tmp_path / "scan")], device="cpu")
    tp = run_exp_torch.main(
        argv + ["--cell_impl", "pallas_tp", "--mesh_model", "2",
                "--new_exp_folder", str(tmp_path / "tp")], device="cpu")
    assert tp.mesh.shape == {"data": 1, "model": 2}
    assert tp.net.layer_0.tp_mesh is tp.mesh
    # batches of 16 and 4 (train), 16 (valid and test): the ragged train
    # batch of 4 takes the TP path too
    for a, b in zip(scan.history, tp.history):
        for k in ("loss", "acc", "rate"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{a['split']} {k}")
    _close_weights(tp.net.state_dict(), scan.net.state_dict(), 1e-2)
