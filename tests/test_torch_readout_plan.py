"""The launch plan of the readout pair (``csrc/readout_fwd.cu``,
``csrc/readout_bwd.cu``; ``ops.fused_cells._readout_plan``, which
``csrc/readout.cuh`` checks) and the rule that routes a model's readout to
the fused readout or to ``cells.readout_sum``
(``models.snn.readout_fused_route``).

On the CPU, over batches, lengths, class counts and SM counts: every batch
row is owned by one block and every step by one chunk; a block's threads
hold its (row, class) pairs; its staged rows fit in the shared memory the
plan gives it, inside the budget, and T is cut into chunks exactly where
a row's series does not fit whole; the main shapes get the plans
``PERF.md`` states; past the lane layout's 256 classes the wide forms get
a block a row and every step's statistics in shared memory. The route:
'pallas' takes the fused readout, 'auto' takes it for a CUDA tensor at any
class count and ``readout_sum`` for a CPU one, 'scan' and 'pallas_tp'
take ``readout_sum``."""
import pytest
import torch

from sparch_tpu_torch.models import snn
from sparch_tpu_torch.ops import cells, fused_cells

BS = (1, 5, 128, 256, 300)
TS = (1, 7, 100, 1000)
SMEM = fused_cells._READOUT_SMEM


def floats_a_row(C, T, backward):
    """Shared floats a row needs for a chunk of T steps: u a step (and p
    and <p, gout> in the backward), beside u before the chunk and gout."""
    return (2 * C + T * (2 * C + 1)) if backward else T * C


@pytest.mark.parametrize("sms", (132, 114, 66))
@pytest.mark.parametrize("C", (1, 20, 35, 256))
def test_plan_invariants(C, sms):
    for backward in (False, True):
        for B in BS:
            for T in TS:
                p = fused_cells._readout_plan(B, T, C, sms, backward)
                case = (B, T, C, sms, backward, p)
                # every row in one block, blocks of `rows` from row 0
                blocks = -(-B // p.rows)
                owned = [b * p.rows + i for b in range(blocks)
                         for i in range(min(p.rows, B - b * p.rows))]
                assert owned == list(range(B)), case
                # one block an SM at most, unless the threads cap the rows
                if -(-B // sms) <= fused_cells._READOUT_THREADS // C:
                    assert blocks <= sms, case
                # a thread a (row, class), warps for the softmaxes
                assert p.rows * C <= 32 * p.warps <= \
                    fused_cells._READOUT_THREADS, case
                assert p.warps >= min(fused_cells._READOUT_SOFTMAX_WARPS,
                                      p.rows * p.t_chunk), case
                # the chunk's rows in the plan's shared memory, within
                # the budget; the backward's last block adds whole rows
                assert p.smem == 4 * p.rows * floats_a_row(
                    C, p.t_chunk, backward), case
                assert p.smem <= SMEM, case
                assert p.smem // 4 // C >= 1, case
                # every step in one chunk, the chunks even; a chunk only
                # where the whole series does not fit
                chunks = -(-T // p.t_chunk)
                steps = [t for k in range(chunks)
                         for t in range(k * p.t_chunk,
                                        min(T, (k + 1) * p.t_chunk))]
                assert steps == list(range(T)), case
                assert chunks * p.t_chunk - T < chunks, case
                whole = 4 * p.rows * floats_a_row(C, T, backward) <= SMEM
                assert (p.t_chunk == T) == whole, case


@pytest.mark.parametrize("sms", (132, 66))
@pytest.mark.parametrize("C", (257, 300, 1024, 1500, 5000))
def test_wide_plan_invariants(C, sms):
    for backward in (False, True):
        for B in BS:
            for T in TS + (1024, 1025, 3000):
                p = fused_cells._readout_plan(B, T, C, sms, backward)
                case = (B, T, C, sms, backward, p)
                # a block a row, a warp per 32 classes up to the block
                assert p.rows == 1, case
                assert 32 * p.warps == min(-(-C // 32) * 32,
                                           fused_cells._READOUT_THREADS), case
                # each step's statistics (forward 2, backward 3 floats)
                # in shared memory, the chunks covering T
                assert p.t_chunk == min(T, fused_cells._READOUT_WIDE_CHUNK)
                assert p.smem == 4 * p.t_chunk * (3 if backward else 2)
                assert p.smem <= 48 * 1024, case


def test_plan_at_the_main_shapes():
    plan = fused_cells._readout_plan
    R = fused_cells.ReadoutPlan
    assert plan(128, 100, 35, 132, False) == R(1, 16, 100, 14000)
    assert plan(128, 100, 35, 132, True) == R(1, 16, 100, 28680)
    assert plan(256, 100, 35, 132, False) == R(2, 16, 100, 28000)
    assert plan(256, 100, 35, 132, True) == R(2, 16, 100, 57360)
    assert plan(128, 100, 20, 132, True) == R(1, 16, 100, 16560)
    # a series past the budget is cut into even chunks
    assert plan(1, 1000, 35, 132, False).t_chunk == 500
    assert plan(1, 1000, 35, 132, True).t_chunk == 334


@pytest.mark.parametrize("cell_impl,on_cuda,fused", [
    ("pallas", False, True), ("pallas", True, True),
    ("auto", False, False), ("auto", True, True),
    ("scan", False, False), ("scan", True, False),
    ("pallas_tp", False, False), ("pallas_tp", True, False),
])
def test_route_rule(cell_impl, on_cuda, fused):
    assert snn.readout_fused_route(cell_impl, on_cuda) is fused


@pytest.mark.parametrize("C", [fused_cells._LANE_C, fused_cells._LANE_C + 1,
                               1500])
def test_route_past_the_kernels_class_limit(C, monkeypatch):
    """Past the lane layout's 256 classes the kernels run their wide forms,
    so 'auto', its route asked as for a CUDA tensor, still takes the fused
    readout: the layer calls ``readout_fused`` at every class count and
    never ``readout_sum``."""
    monkeypatch.setattr(snn, "readout_fused_route",
                        lambda impl, on_cuda, r=snn.readout_fused_route:
                        r(impl, True))
    calls = []
    fused = fused_cells.readout_fused
    monkeypatch.setattr(snn.fused_cells, "readout_fused",
                        lambda *a: calls.append(a) or fused(*a))
    monkeypatch.setattr(snn.cells, "readout_sum", lambda *a: 1 / 0)
    torch.manual_seed(0)
    layer = snn.ReadoutLayer(12, C, normalization="none", state_init="zeros",
                             cell_impl="auto")
    out = layer(torch.randn(2, 5, 12))
    assert len(calls) == 1 and out.shape == (2, C)


def test_auto_readout_past_the_limit_runs_readout_sum(monkeypatch):
    """On a CPU tensor a readout of 257 classes under 'auto' runs
    ``readout_sum`` (its bits; the fused readout is never called), as the
    JAX 'auto' does at any class count; on the card it takes the kernels
    (``test_route_past_the_kernels_class_limit``)."""
    calls = []
    monkeypatch.setattr(snn.fused_cells, "readout_fused",
                        lambda *a: calls.append(a))
    C = fused_cells._LANE_C + 1
    torch.manual_seed(0)
    layer = snn.ReadoutLayer(12, C, normalization="none", state_init="zeros",
                             cell_impl="auto")
    x = torch.randn(2, 5, 12)
    out = layer(x)
    assert not calls
    Wx = layer.norm(layer.W(x))
    assert torch.equal(out, cells.readout_sum(Wx, layer.alpha,
                                              torch.zeros(2, C)))


@pytest.mark.parametrize("cell_impl", ["pallas", "auto", "scan",
                                       "pallas_tp"])
def test_readout_layer_takes_the_route_on_cpu(cell_impl, monkeypatch):
    """On a CPU tensor only 'pallas' reaches the fused readout; 'auto'
    gives ``readout_sum``'s bits, as the JAX 'auto' model computes."""
    calls = []
    fused = fused_cells.readout_fused

    def spy(*args):
        calls.append(args)
        return fused(*args)

    monkeypatch.setattr(snn.fused_cells, "readout_fused", spy)
    torch.manual_seed(0)
    layer = snn.ReadoutLayer(12, 5, normalization="none", state_init="zeros",
                             cell_impl=cell_impl)
    x = torch.randn(3, 9, 12)
    out = layer(x)
    assert len(calls) == (cell_impl == "pallas")
    if cell_impl != "pallas":
        Wx = layer.norm(layer.W(x))
        want = cells.readout_sum(Wx, layer.alpha, torch.zeros(3, 5))
        assert torch.equal(out, want)
