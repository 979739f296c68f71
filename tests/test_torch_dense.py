"""Dense solvers (parapint_tpu_torch/linalg/dense.py) vs parapint_tpu's
DenseLDLSolver and DenseLUSolver on the same numpy systems.

Tolerances: inertia exact.  float64 factors: solves to 1e-9 relative (the
reference's explicit-inverse tests hold 1e-9..1e-10 against the dense
oracle).  A float32 factor without refinement: 1e-4 relative (float32
rounding grown by the KKT's conditioning, ~1e3 here).  With two float64
refinement passes: back to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt

torch.set_num_threads(1)


def kkt(n, m, seed):
    """Quasi-definite [H J^T; J -1e-8 I] (tests/test_explicit_inverse.py)."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((n, n))
    H = H @ H.T + n * np.eye(n)
    J = rng.standard_normal((m, n))
    return np.block([[H, J.T], [J, -1e-8 * np.eye(m)]]), rng


def _inertia(solver, fact):
    return tuple(int(v) for v in solver.inertia(fact))


@pytest.mark.parametrize(
    "kw, rtol",
    [
        (dict(block_size=16), 1e-9),
        (dict(block_size=13), 1e-9),
        (dict(block_size=32, explicit_inverse=True), 1e-9),
        (dict(block_size=16, factor_dtype="float32", refine_steps=0), 1e-4),
        (dict(block_size=16, explicit_inverse=True, factor_dtype="float32", refine_steps=0), 1e-4),
        (dict(block_size=16, explicit_inverse=True, factor_dtype="float32", refine_steps=2), 1e-9),
    ],
)
def test_dense_ldl_solver_matches_reference(kw, rtol):
    K, rng = kkt(30, 12, seed=len(kw))
    n = K.shape[0]
    B = rng.standard_normal((n, 3))
    fd = kw.pop("factor_dtype", None)
    js = pt.DenseLDLSolver(**kw, factor_dtype=None if fd is None else getattr(jnp, fd))
    ts = ptt.DenseLDLSolver(**kw, factor_dtype=None if fd is None else getattr(torch, fd))
    jf = js.numeric(jnp.asarray(K))
    tf = ts.numeric(torch.as_tensor(K))
    assert _inertia(ts, tf) == _inertia(js, jf) == (30, 12, 0)
    assert int(ts.status(tf)) == int(js.status(jf)) == 0
    scale = np.abs(np.linalg.solve(K, B)).max()
    for rhs in (B, B[:, 0]):
        x = ts.solve(tf, torch.as_tensor(rhs)).numpy()
        x_r = np.asarray(js.solve(jf, jnp.asarray(rhs)))
        assert x.shape == x_r.shape
        assert np.abs(x - x_r).max() <= rtol * scale
        assert np.abs(x - np.linalg.solve(K, rhs)).max() <= rtol * scale


@pytest.mark.parametrize("explicit_inverse", [False, True])
def test_dense_ldl_solver_singular(explicit_inverse):
    """An exactly singular matrix reports singular with one zero pivot; a
    tiny nonzero pivot still counts as nonzero (exact zeros only)."""
    cases = (([2.0, -1.0, 0.0, 3.0], (2, 1, 1), 2), ([2.0, -1.0, 1e-9, 3.0], (3, 1, 0), 0))
    for diag, inertia, status in cases:
        K = np.diag(diag)
        solver = ptt.DenseLDLSolver(block_size=8, explicit_inverse=explicit_inverse)
        ref = pt.DenseLDLSolver(block_size=8, explicit_inverse=explicit_inverse)
        tf, jf = solver.numeric(torch.as_tensor(K)), ref.numeric(jnp.asarray(K))
        assert int(solver.status(tf)) == int(ref.status(jf)) == status  # 2 = singular
        assert _inertia(solver, tf) == _inertia(ref, jf) == inertia


@pytest.mark.parametrize("compute_inertia", [True, False])
def test_dense_lu_solver_matches_reference(compute_inertia):
    K, rng = kkt(20, 8, seed=9)
    b = rng.standard_normal(K.shape[0])
    js = pt.DenseLUSolver(compute_inertia=compute_inertia)
    ts = ptt.DenseLUSolver(compute_inertia=compute_inertia)
    jf, tf = js.numeric(jnp.asarray(K)), ts.numeric(torch.as_tensor(K))
    assert int(ts.status(tf)) == int(js.status(jf)) == 0
    x = ts.solve(tf, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, np.asarray(js.solve(jf, jnp.asarray(b))), rtol=1e-9, atol=1e-12)
    if compute_inertia:
        assert _inertia(ts, tf) == _inertia(js, jf) == (20, 8, 0)
    else:
        with pytest.raises(RuntimeError):
            ts.inertia(tf)
    sing = ts.numeric(torch.zeros(3, 3, dtype=torch.float64))
    assert int(ts.status(sing)) == int(js.status(js.numeric(jnp.zeros((3, 3))))) == 2


@pytest.mark.parametrize("zero_tol", [1e-14, 1e-6])
def test_dense_lu_zero_tol_matches_reference(zero_tol):
    """``DenseLUSolver(zero_tol)``: a factor whose smallest |U_ii| is ~1e-9
    of the largest reads singular at 1e-6 and successful at the default
    1e-14, as in the JAX solver."""
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    K = Q @ np.diag([3.0, 1e-9, 2.0, -1.0, 5.0, -4.0]) @ Q.T
    js = pt.DenseLUSolver(zero_tol=zero_tol)
    ts = ptt.DenseLUSolver(zero_tol=zero_tol)
    assert ts.zero_tol == js.zero_tol
    t_status = int(ts.status(ts.numeric(torch.as_tensor(K))))
    assert t_status == int(js.status(js.numeric(jnp.asarray(K))))
    assert t_status == (2 if zero_tol > 1e-10 else 0)


def test_results_and_logger_match_reference():
    """``LinearSolver.results`` (status and inertia read to the host) and
    ``getLogger`` (``algorithms.<class>``) of both packages' solvers."""
    K, _ = kkt(12, 5, seed=3)
    for cls in ("DenseLDLSolver", "DenseLUSolver"):
        kw = {} if cls == "DenseLDLSolver" else dict(compute_inertia=True)
        js, ts = getattr(pt, cls)(**kw), getattr(ptt, cls)(**kw)
        jr = js.results(js.numeric(jnp.asarray(K)))
        tr = ts.results(ts.numeric(torch.as_tensor(K)))
        assert (int(tr.status), tr.inertia) == (int(jr.status), jr.inertia) == (0, (12, 5, 0))
        assert ts.getLogger().name == js.getLogger().name == f"algorithms.{cls}"
