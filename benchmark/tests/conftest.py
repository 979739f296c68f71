"""Fixtures of the benchmark's tests: tiny cells on the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the configuration's sizes cut to what a test process holds on the CPU
TINY = dict(nfe_x=8, nfe_t=16, num_time_blocks=4)


@pytest.fixture
def tiny_cell():
    """``tiny_cell(workload, mix=None, **traffic)``: the cell of
    BENCHMARK.json at TINY sizes; ``mix`` swaps in another mix of
    ``traffic/`` (the dense one waits for its cell), ``traffic`` overrides
    its keys."""
    import json

    from benchmark import harness

    def make(workload="burgers_256blocks.banded_cr", mix=None, **traffic):
        cell = harness.load_cell(workload)
        cell.config.update(TINY)
        if mix is not None:
            cell.traffic = json.loads((harness.BENCH_DIR / "traffic" / f"{mix}.json").read_text())
        cell.traffic.update(traffic)
        return cell

    return make
