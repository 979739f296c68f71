"""PyTorch cyclic-reduction block-tridiagonal solver
(parapint_tpu_torch/linalg/tridiag.py) vs a dense numpy oracle and vs
parapint_tpu.linalg.tridiag on the same float64 inputs.

Tolerances: 1e-8 against the oracle (the reference test's bound,
tests/test_tridiag.py), 1e-10 relative between the two packages (same
float64 algorithm, different summation order); inertia exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parapint_tpu.linalg import BlockTridiag as JBlockTridiag
from parapint_tpu.linalg import BlockTridiagSolver as JBlockTridiagSolver
from parapint_tpu_torch.linalg import LinearSolverStatus
from parapint_tpu_torch.linalg.tridiag import (
    BlockTridiag,
    BlockTridiagSolver,
    extract_tridiag,
)

torch.set_num_threads(1)


def make_tridiag(m, ns, seed=0):
    """Symmetric indefinite block-tridiagonal tiles (as tests/test_tridiag.py)."""
    rng = np.random.default_rng(seed)
    diag = np.zeros((m, ns, ns))
    upper = rng.standard_normal((max(m - 1, 0), ns, ns))
    for i in range(m):
        A = rng.standard_normal((ns, ns))
        diag[i] = A + A.T + (6 + ns) * np.diag(rng.standard_normal(ns))
    return diag, upper


def _solve_port(diag, upper, r):
    tri = BlockTridiag(torch.as_tensor(diag), torch.as_tensor(upper))
    solver = BlockTridiagSolver()
    fact = solver.numeric(tri)
    x = solver.solve(fact, torch.as_tensor(r)).numpy()
    return tri, x, int(solver.status(fact)), tuple(int(v) for v in solver.inertia(fact))


@pytest.mark.parametrize("m,ns", [(1, 3), (2, 4), (5, 4), (7, 3), (8, 6), (15, 7)])
def test_cr_vs_dense_oracle(m, ns):
    diag, upper = make_tridiag(m, ns, seed=m + ns)
    S = BlockTridiag(torch.as_tensor(diag), torch.as_tensor(upper)).todense().numpy()
    x_true = np.random.default_rng(1).standard_normal(m * ns)
    _, x, status, inertia = _solve_port(diag, upper, S @ x_true)
    assert status == 0
    assert np.allclose(x, x_true, rtol=1e-8, atol=1e-8)
    w = np.linalg.eigvalsh(S)
    assert inertia == ((w > 0).sum(), (w < 0).sum(), 0)


def test_cr_matches_reference():
    m, ns = 6, 5
    diag, upper = make_tridiag(m, ns, seed=11)
    r = np.random.default_rng(2).standard_normal(m * ns)
    tri, x, _, inertia = _solve_port(diag, upper, r)
    jtri = JBlockTridiag(jnp.asarray(diag), jnp.asarray(upper))
    np.testing.assert_allclose(np.asarray(jtri.todense()), tri.todense().numpy())
    jsolver = JBlockTridiagSolver()
    jfact = jsolver.numeric(jtri)
    x_ref = np.asarray(jsolver.solve(jfact, jnp.asarray(r)))
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-10 * np.abs(x_ref).max())
    assert inertia == tuple(int(v) for v in jsolver.inertia(jfact))


def test_cr_dense_input_and_roundtrip():
    diag, upper = make_tridiag(6, 5, seed=9)
    tri = BlockTridiag(torch.as_tensor(diag), torch.as_tensor(upper))
    S = tri.todense()
    tri2 = extract_tridiag(S, 5)
    assert torch.equal(tri.diag, tri2.diag) and torch.equal(tri.upper, tri2.upper)
    solver = BlockTridiagSolver(ns=5)
    fact = solver.numeric(S)
    r = torch.arange(30, dtype=S.dtype)
    x = solver.solve(fact, r)
    assert torch.allclose(S @ x, r, atol=1e-8)


def test_cr_singular_tile_reports_singular():
    diag, upper = make_tridiag(3, 4, seed=2)
    diag[1] = 0.0  # exactly singular middle tile
    upper[:] = 0.0  # decoupled, so the zero tile is truly singular
    solver = BlockTridiagSolver()
    fact = solver.numeric(BlockTridiag(torch.as_tensor(diag), torch.as_tensor(upper)))
    assert int(solver.status(fact)) == int(LinearSolverStatus.singular)
    jsolver = JBlockTridiagSolver()
    jfact = jsolver.numeric(JBlockTridiag(jnp.asarray(diag), jnp.asarray(upper)))
    assert int(jsolver.status(jfact)) == int(solver.status(fact))


def test_cr_float32_tiles_through_panel_wrapper():
    """float32 tiles (the flagship's coupling solve) factor through the
    panel wrapper; the inertia stays exact on a well-separated spectrum."""
    diag, upper = make_tridiag(7, 49, seed=4)
    tri = BlockTridiag(torch.as_tensor(diag, dtype=torch.float32),
                       torch.as_tensor(upper, dtype=torch.float32))
    solver = BlockTridiagSolver()
    fact = solver.numeric(tri)
    S = tri.todense().double().numpy()
    w = np.linalg.eigvalsh(S)
    assert tuple(int(v) for v in solver.inertia(fact)) == ((w > 0).sum(), (w < 0).sum(), 0)
    r = np.random.default_rng(3).standard_normal(7 * 49)
    x = solver.solve(fact, torch.as_tensor(r, dtype=torch.float32)).double().numpy()
    x_true = np.linalg.solve(S, r)
    assert np.abs(x - x_true).max() < 1e-3 * np.abs(x_true).max()
