"""Profiling helpers of the port (parapint_tpu_torch/utils/profile.py), the
counterparts of tests/test_profile.py: the solver's phase breakdown, the
phase labels in a profiler trace, and the readback reduction against the
JAX package's ``leafsum`` on the same numpy-built tree."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu_torch as ptt
from parapint_tpu.utils.profile import leafsum as jax_leafsum
from parapint_tpu_torch.linalg.schur import BlockKKT, BlockRhs
from parapint_tpu_torch.utils import profile as P

torch.set_num_threads(1)


def _small_kkt(N=3, nk=6, nc=4, seed=0):
    rng = np.random.default_rng(seed)
    diag = rng.normal(size=(N, nk, nk))
    diag = diag + diag.transpose(0, 2, 1) + 8.0 * np.eye(nk)
    border = rng.normal(size=(N, nc, nk)) * 0.1
    q = np.eye(nc) * 5.0
    t = torch.as_tensor
    return BlockKKT.make(diag=t(diag), border=t(border), q=t(q))


def test_phase_breakdown_reports_both_phases():
    solver = ptt.SchurComplementSolver(block_size=8)
    rhs = BlockRhs(blocks=torch.ones((3, 6), dtype=torch.float64),
                   coupling=torch.ones(4, dtype=torch.float64))
    times = P.solver_phase_breakdown(solver, _small_kkt(), rhs, reps=1)
    assert len(times) == 2
    assert all(t >= 0.0 for t in times.values())


def test_trace_holds_the_solver_phase_labels(tmp_path):
    """The solver phases carry ``record_function`` labels that a trace
    written by :func:`trace` shows."""
    solver = ptt.SchurComplementSolver(block_size=8)
    with P.trace(str(tmp_path)):
        solver.numeric(_small_kkt())
    with open(os.path.join(tmp_path, P.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sc_solver.factor_blocks", "sc_solver.form_sc", "sc_solver.factor_sc"} <= names


def test_profile_call_returns_the_output(tmp_path):
    x = torch.arange(6.0)
    out = P.profile_call(str(tmp_path), torch.mul, x, 2.0)
    assert torch.equal(out, x * 2.0)
    assert os.path.exists(os.path.join(tmp_path, P.TRACE_FILE))


@dataclasses.dataclass(frozen=True)
class _State:
    primals: dict
    step: torch.Tensor
    iterations: int
    barrier: float
    label: str = "x"


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal((3, 4)),                      # float64
        "b": [rng.standard_normal(5).astype(np.float32), np.arange(4)],  # float32, int
        "c": (rng.standard_normal((2, 2)).astype(np.float32) * 1e3, np.zeros((0, 3))),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_leafsum_matches_jax_on_nested_containers(seed):
    tree = _tree(seed)
    ref = float(jax_leafsum({"a": jnp.asarray(tree["a"]),
                             "b": [jnp.asarray(x) for x in tree["b"]],
                             "c": tuple(jnp.asarray(x) for x in tree["c"])}))
    got = P.leafsum({"a": torch.as_tensor(tree["a"]),
                     "b": [torch.as_tensor(x) for x in tree["b"]],
                     "c": tuple(torch.as_tensor(x) for x in tree["c"])})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - ref) <= 1e-6 * abs(ref)


def test_leafsum_walks_dataclasses():
    """The port's IPState-like dataclasses: floating tensors and Python
    floats count (as JAX counts float leaves), ints and strings do not."""
    tree = _tree(2)
    ref = float(jax_leafsum({"primals": {"a": jnp.asarray(tree["a"])},
                             "step": jnp.asarray(tree["c"][0]), "barrier": 0.25, "iterations": 7}))
    state = _State(primals={"a": torch.as_tensor(tree["a"])}, step=torch.as_tensor(tree["c"][0]),
                   iterations=7, barrier=0.25)
    assert abs(float(P.leafsum(state)) - ref) <= 1e-6 * abs(ref)


def test_timed_fused_returns_the_output():
    x = torch.arange(12.0).reshape(3, 4)
    f = lambda a, b: {"y": a @ a.T + b, "n": 3}
    out, t = P.timed_fused(f, x, 1.5, reps=2)
    assert torch.equal(out["y"], f(x, 1.5)["y"]) and out["n"] == 3
    assert t >= 0.0


def test_dispatch_floor_is_cached_per_device():
    first = P.dispatch_floor(device="cpu")
    assert first > 0.0
    assert P.dispatch_floor(device="cpu") == first
    assert P.dispatch_floor(refresh=True, device="cpu") > 0.0


def test_dispatch_floor_on_the_card_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.dispatch_floor(refresh=True)
