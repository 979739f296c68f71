"""The CUDA-graph replay of the banded interface's AD calls
(``parapint_tpu_torch/interfaces/ad_graph.py``) on the card, on the
benchmark cell ``burgers_256blocks.banded_cr``'s configuration and fixed
set (``benchmark/``): graphed fused solves against eager ones (the replay
switched off by taking CUDA out of ``ad_graph.CAPTURE``).

A replay runs the eager call's kernels on the same inputs, so the graphed
solves give the eager ones' iterations and final iterates bit for bit,
whichever order the members are solved in; each interface captures its
three methods once and then only replays, the ``ad.*`` spans running on the
capture calls alone; and the graphs add no more memory than their shared
buffers.  Needs a CUDA card; skips elsewhere.  On the card:

    PT_TEST_TPU=1 python -m pytest tests/test_torch_ad_graph_cuda.py -m cuda -q
"""

import pytest
import torch

from parapint_tpu_torch.interfaces import ad_graph
from parapint_tpu_torch.utils import profile as P

pytestmark = pytest.mark.cuda

CELL = "burgers_256blocks.banded_cr"
METHODS = ("eval_ad", "convergence_from_ad", "kkt_from_ad")


def _solve(inst):
    res = inst.solve(inst.interface.init_state())
    torch.cuda.synchronize()
    return res


def _assert_same(a, b):
    assert (a.status, a.iterations) == (b.status, b.iterations)
    for x, y in zip(P._leaves(a), P._leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), float((x.double() - y.double()).abs().max())


@pytest.fixture(scope="module")
def cell():
    """(instances of the cell's fixed set, their eager solves, peak bytes
    of the eager solves, peak bytes of the graphed solves, the traced first
    and second graphed solve of each member)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import harness

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    spec = harness.load_cell(CELL)
    insts = harness.build_instances(spec, device)
    with pytest.MonkeyPatch.context() as mp:
        mp.delitem(ad_graph.CAPTURE, "cuda")
        _solve(insts[0])  # kernel builds and first-use work
        torch.cuda.reset_peak_memory_stats()
        eager = [_solve(inst) for inst in insts]
        eager_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    traced = []
    for inst in insts:
        recs = []
        for _ in range(2):
            with P.tracing() as rec:
                res = _solve(inst)
            recs.append((res, rec))
        traced.append(recs)
    return insts, eager, eager_peak, torch.cuda.max_memory_allocated(), traced


def test_graphed_solves_equal_the_eager_ones(cell):
    _, eager, _, _, traced = cell
    assert [r.iterations for r in eager] == [7, 7, 7, 7]
    for e, recs in zip(eager, traced):
        assert e.status == 0
        for res, _ in recs:
            _assert_same(res, e)


def test_each_interface_captures_once_then_replays(cell):
    _, eager, _, _, traced = cell
    for e, ((_, first), (_, second)) in zip(eager, traced):
        calls = {"eval_ad": e.iterations, "convergence_from_ad": e.iterations,
                 "kkt_from_ad": e.iterations - 1}
        assert first.counters["ad_graph.capture"] == 3
        assert first.counters["ad_graph.eager"] == second.counters["ad_graph.eager"] == 0
        assert second.counters["ad_graph.capture"] == 0
        for m, n in calls.items():
            assert first.counters[f"ad_graph.replay.{m}"] == n - 1
            assert second.counters[f"ad_graph.replay.{m}"] == n
        # the AD closures run on the capture calls (warm-up and capture) only
        assert first.calls("ad.hvp_lag") == 2 and second.calls("ad.hvp_lag") == 0


def test_members_solved_in_turn_equal_their_solves_alone(cell):
    insts, eager, _, _, _ = cell
    for k in (0, 1, 0, 2, 1, 3, 0):
        _assert_same(_solve(insts[k]), eager[k])
    graphs = [inst.interface._ad_graphs._graphs for inst in insts]
    for m in METHODS:
        for g in graphs[1:]:
            assert all(x is y for x, y in zip(g[m].store, graphs[0][m].store))


def test_graphs_add_no_more_memory_than_their_buffers(cell):
    _, _, eager_peak, graph_peak, _ = cell
    buffers = sum(t.numel() * t.element_size() for t in ad_graph._buffers.values())
    print(f"peak eager {eager_peak} B, graphed {graph_peak} B, shared buffers {buffers} B, "
          f"reserved {torch.cuda.memory_reserved()} B")
    assert graph_peak <= eager_peak + buffers
