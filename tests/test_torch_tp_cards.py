"""The form across cards of the tensor-parallel path and of the sequence
pipeline (one TP rank or pipeline stage a card), on the CPU, without JAX.

- The mesh and the placement rule on ``torch.device("cuda", i)`` objects,
  which touch no card (peer access stubbed where a test builds a mesh):
  distinct, repeated and mixed device lists, ``home`` and ``cards``, the
  C / S*P rule with a patched ``torch.cuda.device_count``, a pair without
  peer access, plans that disagree, and the refusals that name ROADMAP item
  7c (the TP ANN cells, the ``model`` axis inside the pipeline).
- The rank-by-rank mirrors of the form across cards
  (``fused_tp.*_cards_plain``: each rank sees only its column blocks and
  what it receives) against the one-card plain versions, bit for bit: the
  collectives at P = 2 and 4, the RLIF/RadLIF forward and backward in both
  stream modes, and the backward's dV from the gathered u series at a
  firing rate of 0 %, a trained layer's and 100 %.
- The pipeline with its stages named on distinct devices, through the one
  move it makes to a stage's device (``seqpipe._to_stage``, kept on the CPU
  here): where each tensor goes, and the step equal to the one-card
  pipeline's bit for bit.
"""
import numpy as np
import pytest
import torch

from sparch_tpu_torch.models import build_model
from sparch_tpu_torch.ops import fused_tp, fused_tp_ann, tp_cards
from sparch_tpu_torch.parallel import (
    make_mesh,
    make_seq_mesh,
    make_seqpipe_train_step,
    placement,
    seqpipe,
    visible_cards,
)
from sparch_tpu_torch.train import create_train_state

CPU = torch.device("cpu")
THR = 1.0
GRADS = ("dWx", "dV", "dalpha", "dbeta", "da", "db", "du0", "dw0", "ds0")


def cuda(i):
    return torch.device("cuda", i)


@pytest.fixture
def peers(monkeypatch):
    """Peer access between every pair, and its enabling stubbed: the
    enabled pairs, in order."""
    enabled = []
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    monkeypatch.setattr(tp_cards, "_enable_peer",
                        lambda a, b: enabled.append((a, b)))
    monkeypatch.setattr(tp_cards, "_ENABLED", set())
    return enabled


# ---------------------------------------------------------------------------
# Mesh, placement, refusals
# ---------------------------------------------------------------------------


def test_mesh_across_cards(peers):
    mesh = make_mesh([cuda(i) for i in range(4)], model=4)
    assert mesh.shape == {"data": 1, "model": 4} and not mesh.one_card
    assert mesh.cards == tuple(cuda(i) for i in range(4))
    assert mesh.home == cuda(0)
    assert sorted(peers) == [(a, b) for a in range(4) for b in range(4)
                             if a != b]
    make_mesh([cuda(1), cuda(0)], model=2)  # pairs enabled once
    assert len(peers) == 12
    one = make_mesh([cuda(0)] * 4, model=4)
    assert one.one_card and one.home == one.device == cuda(0)
    assert one.cards == (cuda(0),) * 4


@pytest.mark.parametrize("devices,error,match", [
    ([cuda(0), cuda(0), cuda(1), cuda(2)], ValueError, "mixes repeated"),
    ([CPU, cuda(1)], NotImplementedError, "item 7b"),
    ([cuda(0), torch.device("cuda")], NotImplementedError, "CUDA cards"),
], ids=["mixed", "cpu-beside-cuda", "no-index"])
def test_mesh_refuses_mixed_lists(peers, devices, error, match):
    with pytest.raises(error, match=match):
        make_mesh(devices, model=len(devices))
    with pytest.raises(error, match=match):
        make_seq_mesh(devices)


def test_a_pair_without_peer_access_raises(monkeypatch):
    monkeypatch.setattr(tp_cards, "_ENABLED", set())
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: (a, b) != (2, 1))
    monkeypatch.setattr(tp_cards, "_enable_peer", lambda a, b: None)
    with pytest.raises(tp_cards.PeerAccessError, match="cuda:2 cannot"):
        make_mesh([cuda(i) for i in range(3)], model=3)


def test_plans_that_disagree_raise():
    plans = {0: ("rows", 8, 2), 1: ("rows", 8, 2), 2: ("rows", 4, 1)}
    assert tp_cards.agreed_plan([cuda(0), cuda(1)],
                                lambda c: plans[c.index]) == ("rows", 8, 2)
    with pytest.raises(tp_cards.PlanDisagreement, match="cuda:2"):
        tp_cards.agreed_plan([cuda(i) for i in range(3)],
                             lambda c: plans[c.index])


@pytest.mark.parametrize("S,P,C,want", [
    (1, 1, 1, None), (1, 4, 1, None), (2, 2, 1, None), (1, 1, 4, None),
    (1, 1, 8, None),
    (1, 2, 4, [0, 1]), (4, 1, 4, [0, 1, 2, 3]), (1, 4, 8, [0, 1, 2, 3]),
    (2, 1, 2, [0, 1]),
])
def test_placement_rule(S, P, C, want):
    cards, note = placement(S, P, C)
    if want is None:
        assert cards is None and "one-card form" in note
        return
    assert cards == [cuda(i) for i in want]
    idle = [f"cuda:{i}" for i in range(S * P, C)]
    assert ("idle" in note) == bool(idle) and all(i in note for i in idle)


@pytest.mark.parametrize("S,P,C", [(1, 4, 2), (2, 2, 3), (4, 1, 3)])
def test_placement_refuses_too_few_cards(S, P, C):
    with pytest.raises(ValueError, match=f"this process sees {C}"):
        placement(S, P, C)


def test_visible_cards_follow_device_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert visible_cards(cuda(0)) == 4
    assert visible_cards(CPU) == 1
    cards, note = placement(1, 2, visible_cards(cuda(0)))
    assert cards == [cuda(0), cuda(1)] and "cuda:2" in note


def _init_mesh(monkeypatch, device, P, S=1):
    """``Experiment.init_mesh`` alone, on a host of four cards (patched
    ``device_count``): the experiment and its Device-mesh line."""
    import types

    from sparch_tpu_torch.train import loop

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    exp = loop.Experiment.__new__(loop.Experiment)
    exp.__dict__.update(device=device, mesh_model=P, seq_parallel=S,
                        seq_microbatches=4, cell_impl="pallas_tp",
                        batch_size=8)
    notes = []
    monkeypatch.setattr(loop, "logging", types.SimpleNamespace(
        info=notes.append, warning=notes.append))
    exp.init_mesh()
    return exp, notes[0]


@pytest.mark.parametrize("index", [1, 3])
def test_one_rank_and_stage_keeps_the_run_s_card(monkeypatch, index):
    """S = P = 1 on a host of four cards: the one-card form on the card the
    run was given, and the log names no idle card."""
    exp, line = _init_mesh(monkeypatch, cuda(index), 1)
    assert exp.mesh.one_card and exp.mesh.devices == ((cuda(index),),)
    assert exp.seq_mesh is None
    assert "one-card form" in line and "idle" not in line


def test_the_loop_places_ranks_and_stages_on_cards(monkeypatch, peers):
    """--mesh_model 4, or --seq_parallel 2, on a host of four cards: the
    placement rule's cards, the idle ones named; a run given another card
    than cuda:0 is refused."""
    exp, line = _init_mesh(monkeypatch, cuda(0), 4)
    assert exp.mesh.cards == tuple(cuda(i) for i in range(4))
    assert "across cards" in line and "idle" not in line
    exp, line = _init_mesh(monkeypatch, cuda(0), 1, S=2)
    assert exp.seq_mesh.devices == (cuda(0), cuda(1))
    assert exp.mesh.one_card
    assert "idle: ['cuda:2', 'cuda:3']" in line
    with pytest.raises(ValueError, match="starts at cuda:0"):
        _init_mesh(monkeypatch, cuda(1), 2)


def test_one_exchange_a_kind_at_its_largest_size(monkeypatch):
    """Ragged shapes share one set of slots and counters a kind, cards and
    type, kept at the largest size asked for; a set outgrown is retired
    (its allocation streams wait on the last launches) before it is
    dropped; a set too small is not grown inside a graph capture."""
    made, retired = [], []

    class Fake:
        def __init__(self, cards, slot_words, dtype, flag_words):
            self.slot_words, self.flag_words = slot_words, flag_words
            made.append((slot_words, flag_words))

        holds = tp_cards.Exchange.holds

        def retire(self):
            retired.append((self.slot_words, self.flag_words))

    monkeypatch.setattr(tp_cards, "Exchange", Fake)
    monkeypatch.setattr(tp_cards, "_EXCHANGES", {})
    capturing = [False]
    monkeypatch.setattr(tp_cards, "_capturing", lambda cards: capturing[0])
    cards = [cuda(0), cuda(1)]
    f32 = torch.float32
    first = tp_cards.exchange("k", cards, (2, 128, 32), f32, 16)
    assert tp_cards.exchange("k", cards, (2, 13, 32), f32, 8) is first
    grown = tp_cards.exchange("k", cards, (2, 200, 32), f32, 4)
    assert grown is not first and retired == [(8192, 16)]
    assert made == [(8192, 16), (12800, 16)]
    assert tp_cards.exchange("k", cards, (2, 128, 32), f32, 16) is grown
    # another kind, type or card list has its own set
    tp_cards.exchange("k", cards, (2, 13, 32), torch.bfloat16, 8)
    tp_cards.exchange("k", cards[::-1], (2, 13, 32), f32, 8)
    tp_cards.exchange("j", cards, (2, 13, 32), f32, 8)
    assert len(made) == 5 and len(tp_cards._EXCHANGES) == 4
    capturing[0] = True
    assert tp_cards.exchange("k", cards, (2, 13, 32), f32, 8) is grown
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        tp_cards.exchange("k", cards, (2, 400, 32), f32, 8)


def test_item_7c_refusals(peers):
    mesh = make_mesh([cuda(0), cuda(1)], model=2)
    B, T, H = 8, 3, 256
    x = torch.zeros(B, T, H)
    with pytest.raises(NotImplementedError, match="item 7c"):
        fused_tp_ann.gru_tp(x, x, x, *[torch.zeros(H, H)] * 3,
                            torch.zeros(B, H), mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 7c"):
        fused_tp_ann.rnn_tp(x, torch.zeros(H, H), torch.zeros(B, H),
                            mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 7c"):
        make_seq_mesh([cuda(i) for i in range(4)], model=2)
    assert not make_seq_mesh([cuda(i) for i in range(4)]).one_card


# ---------------------------------------------------------------------------
# The mirrors against the one-card plain versions
# ---------------------------------------------------------------------------


def _cell_inputs(B, T, H, seed, bf16=False):
    """V on a 1/64 grid with a zero diagonal, a uniform s0 (the first
    product's sums are then not exact: its order shows)."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(x, dtype=torch.float32)

    V = t(np.clip(np.round(rng.normal(0, 0.3, (H, H)) * 64) / 64, -1, 1))
    d = dict(Wx=t(rng.normal(0, 1.5, (B, T, H))),
             alpha=t(rng.uniform(0.6, 0.96, H)),
             beta=t(rng.uniform(0.6, 0.96, H)),
             a=t(rng.uniform(-1, 1, H)), b=t(rng.uniform(0, 2, H)),
             V=V * (1 - torch.eye(H)), u0=t(rng.uniform(0, 1, (B, H))),
             w0=t(rng.uniform(0, 1, (B, H))), s0=t(rng.uniform(0, 1, (B, H))),
             g=t(rng.normal(0, 1, (B, T, H))))
    if bf16:
        d["g"] = d["g"].bfloat16()
    return d


def _args(d, adaptive):
    return (d["Wx"], d["alpha"], d["beta"] if adaptive else None,
            d["a"] if adaptive else None, d["b"] if adaptive else None,
            d["V"], THR, d["u0"], d["w0"] if adaptive else None, d["s0"])


@pytest.mark.parametrize("P", [2, 4])
def test_collective_mirrors_equal_the_plain_versions(P):
    g = torch.Generator().manual_seed(P)
    for B in (8, 13):
        x = torch.randn(B, P * 128, generator=g)
        parts = torch.randn(P, B, P * 128, generator=g)
        for rounds in (1, 3):
            assert torch.equal(
                fused_tp.tp_all_gather_cards_plain(x, num_devices=P,
                                                   rounds=rounds),
                fused_tp.tp_all_gather_plain(x, num_devices=P, rounds=rounds))
            assert torch.equal(
                fused_tp.tp_reduce_scatter_cards_plain(parts, num_devices=P,
                                                       rounds=rounds),
                fused_tp.tp_reduce_scatter_plain(parts, num_devices=P,
                                                 rounds=rounds))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("cell", ["rlif", "radlif"])
def test_cell_mirrors_equal_the_plain_versions(cell, P, bf16):
    adaptive = cell == "radlif"
    B, T, H = 8, 12, 128 * P
    d = _cell_inputs(B, T, H, seed=P + 10 * adaptive, bf16=bf16)
    args = _args(d, adaptive)
    kw = dict(num_devices=P, adaptive=adaptive, mxu_bf16=bf16)
    s, u = fused_tp.tp_cell_plain(*args, save_residuals=True, **kw)
    ms, mu = fused_tp.tp_cell_cards_plain(*args, save_residuals=True, **kw)
    assert 0.0 < float(s.float().mean()) < 1.0
    assert torch.equal(ms, s) and torch.equal(mu, u)
    assert torch.equal(fused_tp.tp_cell_cards_plain(*args, **kw), s)
    bargs = (d["g"], u, *args[1:])
    want = fused_tp.tp_cell_bwd_plain(*bargs, **kw)
    got = fused_tp.tp_cell_bwd_cards_plain(*bargs, **kw)
    for name, x, y in zip(GRADS, got, want):
        assert (x is None) == (y is None), name
        assert x is None or torch.equal(x, y), name


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.2, 1.0], ids=["0", "20", "100"])
def test_dv_from_the_gathered_series(rate, bf16):
    """The backward on a u series whose spikes (u > thr) fire at ``rate``
    (0 %, a trained layer's 20 %, 100 %): dV of the mirror, each rank's
    block from the full series gathered onto it, equals the one-card
    plain version's, and so do the other gradients."""
    P, B, T, H = 4, 8, 6, 512
    d = _cell_inputs(B, T, H, seed=7, bf16=bf16)
    rng = np.random.default_rng(8)
    fire = rng.random((B, T, H)) < rate
    # spikes where u > thr, and u in the surrogate's window for many
    u = np.where(fire, THR + rng.uniform(0.01, 0.5, (B, T, H)),
                 THR - rng.uniform(0.0, 0.7, (B, T, H)))
    u = torch.tensor(u, dtype=torch.float32)
    assert float((u > THR).float().mean()) == pytest.approx(rate, abs=0.01)
    args = _args(d, True)
    kw = dict(num_devices=P, adaptive=True, mxu_bf16=bf16)
    bargs = (d["g"], u, *args[1:])
    want = fused_tp.tp_cell_bwd_plain(*bargs, **kw)
    got = fused_tp.tp_cell_bwd_cards_plain(*bargs, **kw)
    assert rate == 0.0 or float(want[1].abs().max()) > 0
    for name, x, y in zip(GRADS, got, want):
        assert torch.equal(x, y), name


def test_the_entry_point_through_the_mirrors(monkeypatch):
    """``radlif_tp`` with autograd, its cell through the mirrors (as the
    form across cards runs it) against the one-card plain versions: the
    spikes and every input's gradient bit for bit."""
    P, B, T, H = 2, 8, 10, 256
    d = _cell_inputs(B, T, H, seed=3)
    names = ("Wx", "alpha", "beta", "a", "b", "V", "u0", "w0", "s0")
    mesh = make_mesh([CPU] * P, model=P)

    def run():
        t = {k: d[k].clone().requires_grad_() for k in names}
        out = fused_tp.radlif_tp(t["Wx"], t["alpha"], t["beta"], t["a"],
                                 t["b"], t["V"], THR, t["u0"], t["w0"],
                                 t["s0"], mesh=mesh)
        (out * d["g"]).sum().backward()
        return out.detach(), {k: t[k].grad for k in names}

    want = run()
    monkeypatch.setattr(fused_tp, "tp_cell_plain",
                        fused_tp.tp_cell_cards_plain)
    monkeypatch.setattr(fused_tp, "tp_cell_bwd_plain",
                        fused_tp.tp_cell_bwd_cards_plain)
    got = run()
    assert torch.equal(got[0], want[0])
    for k in names:
        assert torch.equal(got[1][k], want[1][k]), k


# ---------------------------------------------------------------------------
# The pipeline with its stages named on distinct devices
# ---------------------------------------------------------------------------


def _grid_model(S):
    Bp, Tp, F, Hs, C = 8, 24, 12, 16, 5
    model = build_model("RadLIF", (Bp, Tp, F), [Hs, Hs, C],
                        normalization="batchnorm", bidirectional=True,
                        cell_impl="scan",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.round(p * 256.0) / 256.0)
        for layer in model.hidden_layers():
            layer.norm.weight.fill_(4.0)
            layer.norm.bias.fill_(0.5)
    rng = np.random.default_rng(S)
    x = torch.from_numpy((rng.random((Bp, Tp, F)) < 0.3).astype(np.float32))
    return model, x, torch.arange(Bp) % C


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_stages_on_distinct_devices(monkeypatch, S):
    """Stages named ``cuda:0 .. S-1`` with every move to a stage through
    ``_to_stage``, which keeps the tensors on the CPU and records where
    they were sent: each stage gets its chunks and its copies of the
    parameters, the states hop stage to stage, the partial sums come to
    stage 0 and the parameters' gradients to their own device; the step
    equals the one-card pipeline's bit for bit."""
    import copy

    model, x, y = _grid_model(S)
    twin = copy.deepcopy(model)
    one = make_seqpipe_train_step(model, make_seq_mesh([CPU] * S), n_micro=2)
    st1 = create_train_state(model, 1e-2, device="cpu", seed=3)
    _, want = one(st1, x, y)

    sent = []
    monkeypatch.setattr(seqpipe, "_to_stage",
                        lambda t, dev: sent.append(dev) or t)
    mesh = make_seq_mesh([cuda(s) for s in range(S)])
    assert mesh.home == cuda(0) and not mesh.one_card
    cards = make_seqpipe_train_step(twin, mesh, n_micro=2)
    st2 = create_train_state(twin, 1e-2, device="cpu", seed=3)
    _, got = cards(st2, x, y)
    # the stages' devices, and the parameters' own for their gradients
    assert {d.index for d in sent if d.type == "cuda"} == set(range(S))
    assert {d.type for d in sent} == {"cuda", "cpu"}
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]),
                           torch.as_tensor(want[k])), k
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n
