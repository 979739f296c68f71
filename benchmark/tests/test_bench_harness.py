"""The harness finds a cell's files by name and drives a whole run on the
CPU at a tiny size; with the timed path broken underneath, ``correct``
comes out false."""

import dataclasses
import json
import time

import pytest
import torch

from benchmark import harness, trace

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.config["name"] == SPEC["workloads"][CELLS.index(workload)]["config"]
    assert callable(harness.model_module(cell.config).build_interface)
    assert callable(harness.reference_module(cell.config).NLP)
    readers = trace.load_readers(cell.per_layer)
    assert readers and all(callable(r.read) for r in readers.values())
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert "workloads" not in moved or cell in moved["workloads"]


def test_config_files_are_the_ones_benchmark_json_names():
    for c in SPEC["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run(tiny_cell, workload):
    r = harness.run(tiny_cell(workload), 2**31 + 11, 0.0, False, CPU, time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 5  # a cycle and the drawn member
    assert set(r["metrics"]) == {m["name"] for m in SPEC["end_to_end"]}
    assert list(r)[-1] == "checks"
    assert r["checks"]["kkt_error_max"]["value"] <= r["checks"]["kkt_error_max"]["limit"]


def test_burgers_tiny_run_reads_as_before(tiny_cell):
    """The Burgers cell at TINY: its iterations per member, the drawn
    member's keys and the result line's keys, as the harness read them
    before the model's code left it."""
    r = harness.run(tiny_cell(), 2**31 + 11, 0.0, False, CPU, time.perf_counter())
    assert r["iterations"]["per_member"] == {"0": [6], "1": [6], "2": [5], "3": [6]}
    assert list(r["drawn"]) == ["height", "edge", "iterations", "status"]
    assert (r["drawn"]["iterations"], r["drawn"]["status"]) == (5, 0)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "power_limit", "window_s",
                       "iterations", "solve_seconds", "drawn", "setup_first_in_checkout", "checks"]


def test_traced_run(tiny_cell):
    r = harness.run(tiny_cell(mix="dense_cr"), 5, 0.0, True, CPU, time.perf_counter())
    assert r["correct"] and r["attempted"] == 13  # A, B, D (C needs CUDA), the drawn member
    # host-side readers read on the CPU; the device ones find nothing
    assert {"solve_s_p50", "ad_kkt_ms_per_iter", "numeric_ms"} <= set(r["metrics"])
    assert "device_idle_pct" not in r["metrics"]
    assert r["breakdown"]["idle_gaps"]


def test_seed_orders_the_same_set():
    import numpy as np

    a = [np.random.default_rng(2**33 + 1).permutation(4) for _ in range(3)]
    b = [np.random.default_rng(2**33 + 1).permutation(4) for _ in range(3)]
    assert all((x == y).all() for x, y in zip(a, b))


# -- faults planted under the timed path -----------------------------------------------


def _state_unchanged(monkeypatch):
    import parapint_tpu_torch as ptt

    monkeypatch.setattr(ptt.DynamicSchurComplementInteriorPointInterface, "apply_step",
                        lambda self, state, *a, **k: state)


def _half_the_blocks_left_out(monkeypatch):
    import parapint_tpu_torch as ptt

    cls = ptt.DynamicSchurComplementInteriorPointInterface
    orig = cls.apply_step

    def half(self, state, *a, **k):
        new = orig(self, state, *a, **k)
        blocks = new.primals["blocks"].clone()
        h = blocks.shape[0] // 2
        blocks[h:] = state.primals["blocks"][h:]
        return dataclasses.replace(new, primals={**new.primals, "blocks": blocks})

    monkeypatch.setattr(cls, "apply_step", half)


def _answer_altered(monkeypatch):
    import parapint_tpu_torch as ptt

    orig = ptt.make_fused_ip_solve

    def make(interface, options=None):
        solve = orig(interface, options)

        def altered(state0):
            res = solve(state0)
            blocks = res.state.primals["blocks"].clone()
            blocks[0, 0] += 1e-6
            state = dataclasses.replace(res.state, primals={**res.state.primals, "blocks": blocks})
            return dataclasses.replace(res, state=state)

        return altered

    monkeypatch.setattr(ptt, "make_fused_ip_solve", make)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_blocks_left_out, _answer_altered])
def test_fault_is_not_correct(tiny_cell, monkeypatch, fault):
    fault(monkeypatch)
    r = harness.run(tiny_cell(max_iter=15), 3, 0.0, False, CPU, time.perf_counter())
    assert r["correct"] is False and r["failed"] > 0


# -- the trace's arithmetic -------------------------------------------------------------


def _ev(s, t, name="k"):
    import types

    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=s, end=t))


def test_busy_is_the_union_of_device_intervals():
    busy, gaps = trace._busy([_ev(10, 20), _ev(15, 30), _ev(40, 45), _ev(90, 120)], 0, 100)
    assert busy == 10 + 10 + 5 + 10
    assert gaps == [(0, 10), (30, 40), (45, 90)]


def test_device_idle_reads_against_the_plain_cycle():
    from benchmark.metrics import device_idle_pct

    data = trace.TraceData(
        plain_seconds=[0.5] * 8, plain_cycle_s=2.0, span_seconds={}, span_calls={}, span_iterations=0,
        window_s=2.4, busy_s=0.3, launches=100, iterations=28,
        kernel_device_s={}, kernel_bound_s={}, kernel_calls={},
    )
    assert device_idle_pct.read(data) == pytest.approx(85.0)
    assert device_idle_pct.read(dataclasses.replace(data, busy_s=0.0)) is None
