"""The port's bench tools (``parapint_tpu_torch/tools/bench.py`` and
``bench_all.py``) against the JAX package's root ``bench.py`` and
``bench_all.py`` on the CPU, at the ``entry()`` shape (nfe_x=8, nfe_t=8,
4 blocks):

- every ``PT_BENCH_*`` setting builds the same solver class with the same
  knobs as JAX's ``bench._make_solver`` (no solve);
- ``bench.main`` and ``bench_all.fused_iters_per_s`` reach the iteration
  count of ONE JAX ``bench_all.fused_iters_per_s`` of the bench's default
  (banded) solver, shared by the module; the bench's line has its keys,
  and its baseline child saw no card;
- the baseline's float64 block KKT, border, row map and block rhs equal the
  JAX bench's (``build_problem(..., kkt_dtype=None)``, ``eval_kkt_data``,
  ``assemble_kkt``) within 1e-12 relative, and its SuperLU Schur complement
  equals one formed densely from the JAX KKT within 1e-12 relative;
- the row names equal the JAX tool's twelve, in order (read from its AST);
- ``farmer_family(32)``'s yields equal the JAX ``bench_all.stochastic_32``'s;
- a row under ``--timeout 1`` prints an error line naming the timeout, its
  process group is gone, and the tool exits non-zero.
"""

import ast
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
import bench_all as jbench_all
import parapint_tpu_torch as ptt
from parapint_tpu_torch.examples import stochastic
from parapint_tpu_torch.tools import bench, bench_all

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ENTRY = dict(nfe_x=8, nfe_t=8, n_blocks=4)
KKT_RTOL = 1e-12
KNOBS = {
    "default": {},
    "tile_64": {"PT_BENCH_TS": "64"},
    "dense": {"PT_BENCH_BLOCK": "dense"},
    "dense_sc": {"PT_BENCH_BLOCK": "dense", "PT_BENCH_SC": "dense"},
    "bf16_w": {"PT_BENCH_BLOCK": "dense", "PT_BENCH_W": "bf16"},
    "adaptive": {"PT_BENCH_BLOCK": "dense", "PT_BENCH_REFINE": "adaptive"},
}
ENV = ("PT_BENCH_BLOCK", "PT_BENCH_TS", "PT_BENCH_SC", "PT_BENCH_W", "PT_BENCH_REFINE")


def _knobs(solver):
    """The solver's class and the knobs both packages' solvers carry, with
    dtypes by name."""
    out = {"class": type(solver).__name__}
    for k in ("tile_size", "block_size", "explicit_inverse", "factor_dtype", "refine_steps",
              "adaptive_refine", "w_store_dtype", "apply_dtype"):
        v = getattr(solver, k, "absent")
        if not (v is None or isinstance(v, (bool, int, str))):  # a JAX or torch dtype
            v = getattr(v, "__name__", None) or str(v).split(".")[-1]
        out[k] = v
    sc = solver.sc_solver
    out["sc"] = (type(sc).__name__, getattr(sc, "ns", None))
    return out


@pytest.mark.parametrize("setting", list(KNOBS))
def test_solver_knobs_match_jax(setting, monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in KNOBS[setting].items():
        monkeypatch.setenv(k, v)
    iface = types.SimpleNamespace(ns=5)
    want, got = _knobs(jbench._make_solver(iface)), _knobs(bench.make_solver(iface))
    assert got == want


@pytest.fixture(scope="module")
def jax_iterations():
    """n_iter of the JAX tool's ``fused_iters_per_s`` on the bench's default
    (banded) interface and solver at the entry shape."""
    saved = {k: os.environ.pop(k) for k in ENV if k in os.environ}
    try:
        iface = jbench.build_problem(*ENTRY.values(), block_form="banded")
        _, n_iter, _, _ = jbench_all.fused_iters_per_s(iface, jbench._make_solver(iface))
    finally:
        os.environ.update(saved)
    return n_iter


def test_bench_main_matches_jax(jax_iterations, monkeypatch, capsys):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the baseline child's threads
    line = bench.main(["--device", "cpu", "--nfe_x", "8", "--nfe_t", "8", "--blocks", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu" and json.loads(out[-1]) == line
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["metric"] == "ip_iterations_per_s_burgers_4blocks" and line["unit"] == "iter/s"
    d = line["detail"]
    print(f"bench at the entry shape: n_iter port {d['n_iter']} JAX {jax_iterations}")
    assert d["n_iter"] == jax_iterations
    assert line["value"] > 0 and line["vs_baseline"] > 0 and d["baseline_time_per_iter_s"] > 0
    assert d["backend"] == "cpu" and d["device"] == "cpu" and d["block_form"] == "banded"
    assert d["baseline_saw_cuda"] is False


def test_fused_iters_per_s_matches_jax(jax_iterations):
    iface = bench.build_problem(*ENTRY.values(), block_form="banded", device="cpu")
    solver = ptt.BandedSchurComplementSolver(
        schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns), tile_size=128
    )
    ips, n_iter, wall, band = bench_all.fused_iters_per_s(iface, solver)
    assert n_iter == jax_iterations
    assert ips == pytest.approx((n_iter - 1) / wall) and band >= 0.0


def _jax_kkt():
    iface = jbench.build_problem(*ENTRY.values(), kkt_dtype=None)
    state = iface.init_state()
    iface._current_state = state
    data = iface.eval_kkt_data(state, 0.1)
    kkt = iface.assemble_kkt(data, 1e-8, 1e-8)
    return dict(diag=np.asarray(kkt.diag), border=np.asarray(kkt.border_loc),
                row_idx=np.asarray(kkt.row_idx), ncv=int(kkt.q.shape[0]),
                rhs_blocks=np.asarray(iface.kkt_rhs(data).blocks))


def _dense_sc(kkt):
    """-sum_i B_i K_i^{-1} B_i^T over the border rows that map to a coupling
    variable, by dense solves."""
    ncv = kkt["ncv"]
    sc = np.zeros((ncv, ncv))
    for K, B, rows in zip(kkt["diag"], kkt["border"], kkt["row_idx"]):
        local = rows < ncv
        Bl = B[local]
        sc[np.ix_(rows[local], rows[local])] -= Bl @ np.linalg.solve(K, Bl.T)
    return sc


def test_baseline_kkt_and_schur_complement_match_jax():
    want, got = _jax_kkt(), bench.baseline_kkt(*ENTRY.values())
    assert got["ncv"] == want["ncv"]
    np.testing.assert_array_equal(got["row_idx"], want["row_idx"])
    for k in ("diag", "border", "rhs_blocks"):
        assert got[k].dtype == np.float64
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=KKT_RTOL * scale, err_msg=k)
    ips, time_per_iter, sc = bench.measure_reference_baseline(got)
    assert ips == pytest.approx(1.0 / time_per_iter)
    ref = _dense_sc(want)
    np.testing.assert_allclose(sc, ref, rtol=0, atol=KKT_RTOL * np.abs(ref).max())


def _jax_row_names():
    """The config names of the JAX tool's ``main``, in order: each
    ``configs.append((name, ...))``, then the condensed row's "config"."""
    tree = ast.parse((REPO / "bench_all.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = []
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append" and getattr(node.func.value, "id", None) == "configs"):
            names.append(node.args[0].elts[0].value)
    condensed = {
        v.value for node in ast.walk(main) if isinstance(node, ast.Dict)
        for k, v in zip(node.keys, node.values)
        if isinstance(k, ast.Constant) and k.value == "config" and isinstance(v, ast.Constant)
    }
    return names + sorted(condensed)


def test_row_names_match_jax():
    names = _jax_row_names()
    assert len(names) == 12
    assert list(bench_all.ROWS) == names


def test_farmer_family_yields_match_jax():
    want = np.asarray(jbench_all.stochastic_32().spec.params["yield"])
    got = stochastic.farmer_family(32, device="cpu").params["yield"]
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(
        np.asarray(bench_all.stochastic_32("cpu").spec.params["yield"]), want
    )


def test_row_timeout_kills_its_process_group():
    out = subprocess.run(
        [sys.executable, "-m", "parapint_tpu_torch.tools.bench_all", "--device", "cpu",
         "--timeout", "1", "burgers_serial_4blocks"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "cpu" and "dispatch_floor_ms" in json.loads(lines[1])
    record = json.loads(lines[-1])
    assert record["config"] == "burgers_serial_4blocks"
    assert record["error"].startswith("timed out after 1.0 s")
    pgid = int(re.search(r"process group (\d+) killed", record["error"]).group(1))
    with pytest.raises(ProcessLookupError):
        os.killpg(pgid, 0)
