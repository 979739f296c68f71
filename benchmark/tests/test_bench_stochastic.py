"""The harness on a second interface of the port: the stochastic fixture
(``fixture/``: the farmer at 4 scenarios on the stochastic interface, tol
1e-8, ``SchurComplementSolver(block_size=64, explicit_inverse=True)``) runs
a whole cell on the CPU through ``harness.run``, untraced and traced, and
reads ``correct: true``; with its answer broken where the solve produces
it, ``correct: false``."""

import dataclasses
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import fixture

CPU = torch.device("cpu")


def test_member_zero_is_the_ports_farmer_family():
    from parapint_tpu_torch.examples import stochastic

    cfg = fixture.config()
    model = fixture.model_module(cfg)
    ours = model.build_interface(cfg, model.instances(cfg)[0], fixture.traffic(), "cpu").spec
    theirs = stochastic.farmer_family(num_scenarios=cfg["num_scenarios"], device="cpu")
    for k in theirs.params:
        assert torch.equal(ours.params[k], theirs.params[k]), k


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_run_is_correct(tiny_cell, traced):
    r = harness.run(tiny_cell(fixture.CELL), 2**31 + 21, 0.0, traced, CPU, time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    # untraced: one cycle of the 2 members and the drawn one; traced: A, B, D
    # (C needs CUDA) and the drawn one
    assert r["attempted"] == (7 if traced else 3)
    assert list(r["drawn"]) == ["noise_seed", "iterations", "status"]
    assert r["drawn"]["noise_seed"] == 2**31 + 21 and r["drawn"]["status"] == 0
    assert r["checks"]["kkt_error_max"]["value"] <= r["checks"]["kkt_error_max"]["limit"] == 1e-8
    assert list(r)[-1] == "checks"


# -- faults planted where the solve produces its answer -------------------------------


def _altered(alter):
    """A stand-in for ``make_fused_ip_solve`` whose solves return
    ``alter(result)``."""
    import parapint_tpu_torch as ptt

    orig = ptt.make_fused_ip_solve

    def make(interface, options=None):
        solve = orig(interface, options)
        return lambda state0: alter(solve(state0))

    return make


def _with(res, field, value):
    return dataclasses.replace(res, state=dataclasses.replace(res.state, **{field: value}))


def _first_stage_perturbed(res):
    p = res.state.primals
    c = p["coupling"].clone()
    c[0] *= 1.0 + 1e-6
    return _with(res, "primals", {**p, "coupling": c})


def _bound_dual_sign_flipped(res):
    d = res.state.duals_primals_lb
    z = d["blocks"].clone()
    k = z.abs().argmax()  # the largest: an active bound
    z.view(-1)[k] = -z.view(-1)[k]
    return _with(res, "duals_primals_lb", {**d, "blocks": z})


def _status_not_optimal(res):
    return dataclasses.replace(res, status=1)


@pytest.mark.parametrize("fault", [_first_stage_perturbed, _bound_dual_sign_flipped, _status_not_optimal])
def test_fault_is_not_correct(tiny_cell, monkeypatch, fault):
    import parapint_tpu_torch as ptt

    cell = tiny_cell(fixture.CELL)
    monkeypatch.setattr(ptt, "make_fused_ip_solve", _altered(fault))
    r = harness.run(cell, 3, 0.0, False, CPU, time.perf_counter())
    assert r["correct"] is False and r["failed"] == r["attempted"] == 3
