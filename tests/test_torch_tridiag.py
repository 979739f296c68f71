"""PyTorch cyclic-reduction block-tridiagonal solver
(parapint_tpu_torch/linalg/tridiag.py) vs a dense numpy oracle and vs
parapint_tpu.linalg.tridiag on the same float64 inputs.

Tolerances: 1e-8 against the oracle (the reference test's bound,
tests/test_tridiag.py), 1e-10 relative between the two packages (same
float64 algorithm, different summation order); inertia exact.
"""

import jax
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


def test_cr_arguments_match_reference():
    """``BlockTridiagSolver(ns, block_size=32, zero_tol=1e-10,
    factor_dtype=float32)`` on float64 tiles of the flagship's width (49),
    both packages built alike: inertia and status exactly equal, every
    level's tile inverses of the same shape and in the tiles' dtype, the
    solutions within 1e-3 x max|x| (test_cr_float32_tiles_through_panel_wrapper's
    float32 bar)."""
    m, ns = 3, 49
    diag, upper = make_tridiag(m, ns, seed=5)
    r = np.random.default_rng(6).standard_normal(m * ns)
    kw = dict(ns=ns, block_size=32, zero_tol=1e-10)
    jsolver = JBlockTridiagSolver(factor_dtype=jnp.float32, **kw)
    tsolver = BlockTridiagSolver(factor_dtype=torch.float32, **kw)
    for name in kw:
        assert getattr(tsolver, name) == getattr(jsolver, name)
    jtri = JBlockTridiag(jnp.asarray(diag), jnp.asarray(upper))
    jfact = jax.jit(jsolver.numeric)(jtri)
    tfact = tsolver.numeric(BlockTridiag(torch.as_tensor(diag), torch.as_tensor(upper)))
    inertia = tuple(int(v) for v in tsolver.inertia(tfact))
    assert inertia == tuple(int(v) for v in jsolver.inertia(jfact))
    assert int(tsolver.status(tfact)) == int(jsolver.status(jfact)) == 0
    for jt, tt in zip(jfact.tinv, tfact.tinv, strict=True):
        assert tuple(tt.shape) == tuple(jt.shape) and tt.dtype == torch.float64
    x = tsolver.solve(tfact, torch.as_tensor(r)).numpy()
    x_ref = np.asarray(jax.jit(jsolver.solve)(jfact, jnp.asarray(r)))
    assert np.abs(x - x_ref).max() <= 1e-3 * np.abs(x_ref).max()


@pytest.mark.parametrize("ns, block_size, panels", [(49, 128, 1), (49, 32, 2), (199, 128, 2)])
def test_cr_panel_widths_match_reference(monkeypatch, ns, block_size, panels):
    """The float32 level factorizations at a caller's ``block_size``: the
    padded W, pivots and scaling of the JAX package's level factor
    (``jax.eval_shape``, the same widths as its computation), and the
    panels the port hands the slab kernel's entry: 49-wide tiles pad to one
    56-wide panel at 128 (as at the default 64), two 32-wide at 32; 199-wide
    tiles to two 128-wide panels at 128 (four 64-wide at the default)."""
    from parapint_tpu.linalg.schur import _factor_blocks_winv as j_factor
    from parapint_tpu_torch.ops import ldl as tldl

    widths = []
    entry = tldl.ldl_panels_slab_winv

    def spy(panel):
        widths.append(panel.shape[-1])
        return entry(panel)

    monkeypatch.setattr(tldl, "ldl_panels_slab_winv", spy)
    diag, upper = make_tridiag(3, ns, seed=7)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    BlockTridiagSolver(block_size=block_size).numeric(BlockTridiag(f32(diag), f32(upper)))
    level_widths = list(widths)
    js = jax.eval_shape(lambda d, k: j_factor(d, k, block_size, 0.0),
                        jax.ShapeDtypeStruct((2, ns, ns), jnp.float32),
                        jax.ShapeDtypeStruct((2,), jnp.float32))
    from parapint_tpu_torch.linalg.schur import _factor_blocks_winv as t_factor
    ts = t_factor(f32(diag[:2]), torch.ones(2), block_size, 0.0)
    assert [tuple(t.shape) for t in ts[:3]] == [tuple(j.shape) for j in js[:3]]
    npad = js[0].shape[-1]
    # two levels (3 tiles -> E = 2, then 1), each its panels
    assert level_widths == [npad // panels] * (2 * panels)
