"""The CUDA-graph replay of the structured interfaces' AD calls
(``parapint_tpu_torch/interfaces/ad_graph.py``) on the CPU, on a small
Burgers instance.

Where the replay does not engage (the CPU, the dense form, a mesh, calls
outside a fused solve) the three methods run their eager code and the
``ad_graph.*`` counters stay 0.  A stand-in for the CUDA capture engages
the replay on the CPU: it traces the captured call once into a graph of
aten operations (``make_fx``), which, like a CUDA graph, bakes in every host
value and reads every tensor by reference, and a replay runs that graph and
copies its outputs into the store.  So the static inputs, the shared stores
and the graph's key are held here: its solves equal the eager ones bit for
bit, alone, with two interfaces of one signature in turn, and after a setter
changes what a capture baked in.  The card's own capture is held
in ``test_torch_ad_graph_cuda.py``.
"""

import dataclasses

import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import parapint_tpu_torch as ptt
from parapint_tpu_torch.examples import burgers
from parapint_tpu_torch.interfaces import ad_graph
from parapint_tpu_torch.parallel import distributed
from parapint_tpu_torch.parallel.mesh import block_mesh
from parapint_tpu_torch.utils import profile as P

torch.set_num_threads(1)

SHAPE = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)
METHODS = ("eval_ad", "convergence_from_ad", "kkt_from_ad")


def _stand_in(call, make_store):
    """The CUDA capture's stand-in: ``call`` traced once, with no inputs, so
    every tensor it reads is a constant of the trace held by reference; a
    replay runs the trace and copies its outputs into the store."""
    store = make_store(call())
    graph = make_fx(call)()

    def replay():
        for buf, out in zip(store, graph()):
            buf.copy_(out)

    return store, replay


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setitem(ad_graph.CAPTURE, "cpu", _stand_in)


def _iface(form="banded", x0_scale=1.0, mesh=None):
    """The instance with every variable bounded (the Burgers example has no
    bounds of its own), so that the bounds enter every AD call."""
    spec = burgers.build_spec(**SHAPE, device="cpu")
    spec = dataclasses.replace(
        spec, x0=spec.x0 * x0_scale, xl=torch.full_like(spec.x0, -100.0), xu=torch.full_like(spec.x0, 100.0)
    )
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=torch.float32, block_form=form, mesh=mesh
    )
    iface.set_bounds_relaxation_factor(ptt.IPOptions().bounds_relaxation_factor)
    return iface


def _options(iface):
    coupling = ptt.BlockTridiagSolver(ns=iface.ns)
    options = ptt.IPOptions()
    options.linalg.solver = (
        ptt.BandedSchurComplementSolver(schur_complement_solver=coupling, device="cpu")
        if iface.block_form == "banded" else ptt.SchurComplementSolver(schur_complement_solver=coupling)
    )
    return options


def _solver(iface):
    options = _options(iface)
    iface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    return ptt.make_fused_ip_solve(iface, options)


def _traced_solve(iface, solve):
    with P.tracing() as rec:
        res = solve(iface.init_state())
    return res, rec


def _graph_counts(rec) -> dict:
    return {k: v for k, v in rec.counters.items() if k.startswith("ad_graph.")}


def _assert_equal(a, b):
    la, lb = list(P._leaves(a)), list(P._leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _assert_same_result(a, b):
    assert (a.status, a.iterations) == (b.status, b.iterations)
    _assert_equal(a, b)


def _ad_calls(iface, state, mu):
    """(ad, convergence info, KKT data and rhs) of the three methods, each
    leaf cloned (a graph's outputs alias its store)."""
    ad = iface.eval_ad(state)
    info = iface.convergence_from_ad(state, ad, mu, 100.0)
    data = iface.kkt_from_ad(state, ad, mu)
    clone = lambda t: t.clone() if isinstance(t, torch.Tensor) else t
    return [{k: clone(v) for k, v in ad.items()},
            dataclasses.replace(info, **{f.name: clone(getattr(info, f.name))
                                         for f in dataclasses.fields(info)}),
            (clone(data[0]), dataclasses.replace(data[1], blocks=clone(data[1].blocks),
                                                 coupling=clone(data[1].coupling)))]


@pytest.fixture(scope="module")
def eager_banded():
    """The eager fused solve of the banded instance."""
    iface = _iface()
    return _solver(iface)(iface.init_state())


@pytest.fixture
def one_rank_mesh(tmp_path):
    distributed.initialize(f"file://{tmp_path}/pg", 1, 0, device_type="cpu")
    try:
        yield block_mesh()
    finally:
        distributed.shutdown()


def test_the_cpu_runs_eagerly(eager_banded):
    """No capture for the CPU: a fused solve counts no graph call and gives
    the eager solve (the module's), and the three methods inside a fused
    solve's scope give what they give outside it."""
    eager = eager_banded
    iface = _iface()
    res, rec = _traced_solve(iface, _solver(iface))
    assert _graph_counts(rec) == {}
    _assert_same_result(res, eager)
    state = iface.init_state()
    mu = torch.tensor(0.1, dtype=torch.float64)
    outside = _ad_calls(iface, state, mu)
    with ad_graph.fused_solve_scope(), P.tracing() as rec:
        inside = _ad_calls(iface, state, mu)
    assert _graph_counts(rec) == {}
    _assert_equal(inside, outside)


@pytest.mark.parametrize("case", ["dense", "mesh", "outside"])
def test_eager_where_the_graph_does_not_engage(stand_in, request, case):
    """With a capture for the CPU, the dense form, a mesh interface and calls
    outside a fused solve (direct calls, the Python-loop ``ip_solve``) run
    the eager code: no graph call counted, the same results."""
    mu = torch.tensor(0.1, dtype=torch.float64)
    if case == "dense":
        iface = _iface("dense")
        _, rec = _traced_solve(iface, _solver(iface))
        assert _graph_counts(rec) == {}
    plain = _iface("dense" if case == "dense" else "banded")
    expected = _ad_calls(plain, plain.init_state(), mu)
    if case == "mesh":
        iface = _iface(mesh=request.getfixturevalue("one_rank_mesh"))
    elif case == "outside":
        iface = _iface()
        with P.tracing() as rec:
            _assert_equal(_ad_calls(iface, iface.init_state(), mu), expected)
            options = _options(iface)
            options.max_iter = 3
            ptt.ip_solve(iface, options)
        assert rec.calls("iface.eval_ad") > 1
        assert _graph_counts(rec) == {}
    with ad_graph.fused_solve_scope(), P.tracing() as rec:
        got = _ad_calls(iface, iface.init_state(), mu)
    engaged = case == "outside"  # the same calls, inside a fused solve's scope
    assert bool(_graph_counts(rec)) == engaged
    _assert_equal(got, expected)


def test_stand_in_replays_the_eager_solve(stand_in, eager_banded):
    """Through the stand-in the first solve captures each method once and
    replays it, the second replays only; both equal the eager solve."""
    eager = eager_banded
    iface = _iface()
    solve = _solver(iface)
    first, rec1 = _traced_solve(iface, solve)
    second, rec2 = _traced_solve(iface, solve)
    _assert_same_result(first, eager)
    _assert_same_result(second, eager)
    it = eager.iterations
    calls = {"eval_ad": it, "convergence_from_ad": it, "kkt_from_ad": it - 1}
    assert eager.status == 0
    c1, c2 = _graph_counts(rec1), _graph_counts(rec2)
    assert c1["ad_graph.capture"] == 3 and "ad_graph.eager" not in c1
    for m, n in calls.items():
        assert c1[f"ad_graph.capture.{m}"] == 1
        assert c1.get(f"ad_graph.replay.{m}", 0) == n - 1
        assert c2[f"ad_graph.replay.{m}"] == n
    assert c2["ad_graph.replay"] == sum(calls.values()) and len(c2) == 4


def test_interfaces_of_one_signature_share_the_stores(stand_in, eager_banded):
    """Two interfaces of one signature, solved in turn, share their stores
    and static inputs and each still gives its own eager solve; a result
    keeps its convergence numbers after the other interface's solve."""
    eager_a = eager_banded
    eager_iface_b = _iface(x0_scale=0.5)
    eager_b = _solver(eager_iface_b)(eager_iface_b.init_state())
    assert eager_b.iterations != eager_a.iterations or not torch.equal(
        eager_b.primal_inf, eager_a.primal_inf)
    a, b = _iface(), _iface(x0_scale=0.5)
    solve_a, solve_b = _solver(a), _solver(b)
    results = []
    for iface, solve, eager in ((a, solve_a, eager_a), (b, solve_b, eager_b)) * 2:
        results.append(solve(iface.init_state()))
        _assert_same_result(results[-1], eager)
    _assert_same_result(results[0], eager_a)  # after three solves since
    graphs_a, graphs_b = a._ad_graphs._graphs, b._ad_graphs._graphs
    for m in METHODS:
        assert all(x is y for x, y in zip(graphs_a[m].store, graphs_b[m].store))
        assert all(x is y for x, y in zip(graphs_a[m].inputs, graphs_b[m].inputs))
    # convergence_from_ad and kkt_from_ad read eval_ad's store in place
    ad_store = {id(t) for t in graphs_a["eval_ad"].store}
    assert ad_store <= {id(t) for t in graphs_a["kkt_from_ad"].inputs}
    with ad_graph.fused_solve_scope():
        ad = a.eval_ad(a.init_state())
    assert {id(t) for t in P._leaves(ad)} == ad_store


@pytest.mark.parametrize("setter", ["bounds_relaxation", "obj_factor"])
def test_no_stale_replay_after_a_setter(stand_in, setter):
    """After ``set_bounds_relaxation_factor`` (the bounds are static inputs:
    the graphs replay them) or ``set_obj_factor`` (baked into the capture: a
    call off the key runs eagerly, the next captures anew) a solve equals
    the eager solve under the same setting."""
    def change(iface):
        if setter == "bounds_relaxation":
            iface.set_bounds_relaxation_factor(1e-4)
        else:
            iface.set_obj_factor(2.0)

    eager_iface = _iface()
    eager_solve = _solver(eager_iface)
    change(eager_iface)
    eager = eager_solve(eager_iface.init_state())
    iface = _iface()
    solve = _solver(iface)
    solve(iface.init_state())
    change(iface)
    res, rec = _traced_solve(iface, solve)
    _assert_same_result(res, eager)
    counts = _graph_counts(rec)
    if setter == "bounds_relaxation":
        assert counts["ad_graph.replay"] == sum(rec.calls(f"iface.{m}") for m in METHODS)
        assert "ad_graph.capture" not in counts and "ad_graph.eager" not in counts
    else:
        for m in METHODS:
            assert counts[f"ad_graph.eager.{m}"] == 1
            assert counts[f"ad_graph.capture.{m}"] == 1
