"""Fixtures of the benchmark's tests: tiny cells on the CPU."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny_cell(monkeypatch):
    """``tiny_cell(workload, mix=None, **traffic)``: the cell of
    BENCHMARK.json, or the stochastic fixture's cell (``fixture.CELL``,
    with the harness pointed at its modules), at the sizes of its model's
    ``TINY``; ``mix`` swaps in another mix of ``traffic/`` (the dense one
    waits for its cell), ``traffic`` overrides its keys."""
    from benchmark import harness
    from benchmark.tests import fixture

    def make(workload="burgers_256blocks.banded_cr", mix=None, **traffic):
        if workload == fixture.CELL:
            monkeypatch.setattr(harness, "model_module", fixture.model_module)
            monkeypatch.setattr(harness, "reference_module", fixture.reference_module)
            spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
            cell = harness.Cell(name=workload, chips=1, config=fixture.config(), traffic=fixture.traffic(),
                                end_to_end=spec["end_to_end"], per_layer=spec["per_layer"])
        else:
            cell = harness.load_cell(workload)
        cell.config.update(harness.model_module(cell.config).TINY)
        if mix is not None:
            cell.traffic = json.loads((harness.BENCH_DIR / "traffic" / f"{mix}.json").read_text())
        cell.traffic.update(traffic)
        return cell

    return make
