"""The port's tracing (``parapint_tpu_torch/utils/profile.py``: ``span``,
``host_read``, ``tracing``, ``trace``) over fused solves of a small Burgers
instance on the CPU, on the banded and the dense path.

A traced solve gives the untraced one's result bit for bit; the spans nest
by layer (``ip.*`` > ``iface.*`` > ``ad.*``, the solver phases inside their
``numeric``); the counts match what the solve reports; and a Chrome trace
written by ``trace`` carries the program's spans.
"""

import json
import os

import pytest
import torch

import parapint_tpu_torch as ptt
from parapint_tpu_torch.examples import burgers
from parapint_tpu_torch.utils import profile as P

torch.set_num_threads(1)

SHAPE = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)
NUMERIC = {"banded": "banded_sc.numeric", "dense": "sc_solver.numeric"}
SOLVER_PHASES = ("factor_blocks", "form_sc", "factor_sc")


def _solver(form, iface):
    coupling = ptt.BlockTridiagSolver(ns=iface.ns)
    if form == "banded":
        return ptt.BandedSchurComplementSolver(schur_complement_solver=coupling, device="cpu")
    return ptt.SchurComplementSolver(schur_complement_solver=coupling)


@pytest.fixture(scope="module", params=["banded", "dense"])
def case(request):
    """(block form, interface, solver, solve) of the small instance."""
    form = request.param
    spec = burgers.build_spec(**SHAPE, device="cpu")
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=torch.float32, block_form=form
    )
    options = ptt.IPOptions()
    options.linalg.solver = solver = _solver(form, iface)
    iface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    return form, iface, solver, ptt.make_fused_ip_solve(iface, options)


@pytest.fixture(scope="module")
def traced(case):
    """(case, result, record, numeric calls) of one traced cold solve."""
    _, iface, solver, solve = case
    before = solver.n_numeric
    with P.tracing() as rec:
        res = solve(iface.init_state())
    return case, res, rec, solver.n_numeric - before


def _assert_same_result(a, b):
    assert (a.status, a.iterations) == (b.status, b.iterations)
    for name in ("barrier", "primal_inf", "dual_inf", "compl_inf"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for la, lb in zip(P._leaves(a.state), P._leaves(b.state)):
        assert torch.equal(la, lb)


def _ancestors(rec, span):
    p = span.parent
    while p >= 0:
        yield rec.spans[p]
        p = rec.spans[p].parent


def test_tracing_leaves_the_result_bitwise_equal(traced):
    (_, iface, _, solve), res, rec, _ = traced
    plain = solve(iface.init_state())
    _assert_same_result(plain, res)
    assert plain.status == 0
    n = len(rec.spans)
    solve(iface.init_state())  # tracing is off again: nothing more recorded
    assert len(rec.spans) == n and P._record is None


def test_spans_close_and_nest_by_layer(traced):
    (form, *_), _, rec, _ = traced
    assert not rec._stack
    (root,) = [i for i, s in enumerate(rec.spans) if s.name == P.SOLVE]
    for s in rec.spans:
        assert 0 < s.start_ns <= s.end_ns, s.name
        up = {a.name for a in _ancestors(rec, s)}
        if s.name == "iface.init_state" or "iface.init_state" in up:
            assert s.solve == -1, s.name  # the caller's, before the solve
            continue
        assert s.solve == root, s.name
        if s.name == "ip.iteration":
            assert rec.spans[s.parent].name == P.SOLVE
        elif s.name.startswith("iface."):
            assert "ip.iteration" in up, s.name
        elif s.name.startswith("ad."):
            assert any(a.startswith("iface.") for a in up), s.name
        elif s.name.startswith("tridiag.") or s.name.split(".")[-1] in SOLVER_PHASES:
            assert NUMERIC[form] in up, s.name
        elif s.name in ("banded_sc.solve_once", "banded_sc.refine_probe"):
            assert "banded_sc.solve" in up, s.name


def test_span_counts_match_the_solve(traced):
    (form, *_), res, rec, numerics = traced
    names = {s.name for s in rec.spans}
    assert rec.calls("ip.iteration") == res.iterations
    assert rec.calls(NUMERIC[form]) == numerics > 0
    assert rec.counters[P.SYNCS] == rec.calls(P.SYNC)
    # every iteration reads the convergence flag; every one that steps also
    # reads the inertia, the solve's refinement and its status
    assert rec.counters[P.SYNCS] >= 4 * (res.iterations - 1) + 1
    assert {"iface.eval_ad", "iface.kkt_from_ad", "iface.assemble_kkt", "iface.barrier_diag",
            "iface.rhs", "ad.grad_f", "ad.jtprod", "tridiag.numeric", "tridiag.cr_level"} <= names
    if form == "banded":
        assert {"iface.band_extract", "ad.hvp_lag", "ad.jvp_eq", "ad.vjp_eq",
                "banded_sc.solve", "banded_sc.solve_once", "banded_sc.refine_probe"} <= names
    else:
        assert {"ad.hess_lag", "ad.jac_eq"} <= names and "iface.band_extract" not in names


def test_summary_and_host_seconds(traced):
    _, _, rec, _ = traced
    summary = rec.summary()
    assert sum(calls for calls, _, _ in summary.values()) == len(rec.spans)
    for name, (calls, total, own) in summary.items():
        assert 0.0 <= own <= total + 1e-12, name
    waits = sum(s.end_ns - s.start_ns for s in rec.spans if s.name == P.SYNC and s.solve >= 0)
    host = rec.host_seconds([P.SOLVE])
    assert host == pytest.approx(summary[P.SOLVE][1] - waits * 1e-9, abs=1e-6)
    assert rec.host_seconds(["no.such.span"]) == 0.0


def test_self_seconds_leave_out_the_children():
    with P.tracing() as rec:
        with P.span("a"):
            with P.span("b"):
                sum(range(20000))
            sum(range(20000))
        with P.host_sync():
            pass
    s = rec.summary()
    a, b = rec.spans[0], rec.spans[1]
    assert (b.parent, a.parent, rec.spans[2].parent) == (0, -1, -1)
    assert s["a"][2] * 1e9 == pytest.approx((a.end_ns - a.start_ns) - (b.end_ns - b.start_ns))
    assert s["b"][1] == s["b"][2] and rec.counters[P.SYNCS] == 1


def test_spans_are_a_shared_no_op_when_off():
    assert P._record is None
    assert P.span("x") is P.span("y") is P.host_sync()
    assert P.host_read(torch.tensor(2.5)) == 2.5


def test_trace_carries_the_program_spans(case, tmp_path):
    _, iface, _, solve = case
    with P.trace(str(tmp_path)) as rec:
        solve(iface.init_state())
    assert rec.calls(P.SOLVE) == 1
    with open(os.path.join(tmp_path, P.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ip.solve", "ip.iteration", "iface.eval_ad", "iface.kkt_from_ad", "ad.grad_f",
            "ip.host_sync"} <= names
