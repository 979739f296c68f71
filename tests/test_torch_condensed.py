"""The general band ops (parapint_tpu_torch/ops/banded.py), the
CondensedLSQSolver (linalg/condensed.py) and the performance harness
(examples/performance/schur_complement.py) of the port vs dense numpy and
the JAX package, at small sizes.

Tolerances:
- band ops: 1e-12 absolute against dense numpy (tests/test_condensed.py's
  bound), on single and batched band stores;
- the condensed solver: solution within 1e-8 of the dense numpy solve
  (tests/test_condensed.py) and within 1e-10 x max|x| of the JAX solver on
  the same seeded data; inertia equal to the JAX solver's and the dense
  eigenvalues'; at n_q=32 with tile 16 and n_q=40 with tile 16 (a tile
  that does not divide n_q, so G is padded);
- the harness: ``run()``'s ``max_err`` equal to the JAX package's to rtol
  1e-6 with equal status, for csc, ssc and fs (4 blocks, n_q=32, x2,
  n_theta=5, the size of tests/test_examples.py's harness test), and the
  three methods' ``max_err`` equal to each other to rtol 1e-6.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu_torch as ptt
from parapint_tpu.examples.performance import schur_complement as jperf
from parapint_tpu.linalg import CondensedLSQKKT as JKKT
from parapint_tpu.linalg import CondensedLSQSolver as JSolver
from parapint_tpu.linalg.schur import BlockRhs as JBlockRhs
from parapint_tpu_torch.convert import condensed_kkt_from_numpy
from parapint_tpu_torch.examples.performance import schur_complement as perf
from parapint_tpu_torch.linalg.schur import BlockRhs
from parapint_tpu_torch.ops import banded as B

sys.path.insert(0, "tests")
from test_condensed import _build_harness_system, _random_banded  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("n,p", [(37, 2), (29, 1), (8, 3)])
def test_band_ops_match_dense(n, p):
    rng = np.random.default_rng(n)
    M, bands = _random_banded(n, p, rng)
    x = rng.standard_normal(n)
    X = rng.standard_normal((3, n))
    tb = torch.as_tensor(bands)
    np.testing.assert_allclose(B.banded_matvec(tb, torch.as_tensor(x)).numpy(), M @ x, atol=1e-12)
    np.testing.assert_allclose(B.banded_rmatvec(tb, torch.as_tensor(X)).numpy(), X @ M, atol=1e-12)
    G = M.T @ M
    btb = B.banded_btb(tb).numpy()
    assert btb.shape == (2 * p + 1, n)
    for e in range(2 * p + 1):
        np.testing.assert_allclose(btb[e, : n - e], np.diagonal(G, -e), atol=1e-12)
        assert not btb[e, n - e :].any()


def test_band_ops_batch():
    """Leading dimensions broadcast: (m, 2p+1, n) bands against (k, m, n)
    vectors, and a (m, 2p+1, n) stack through banded_btb."""
    rng = np.random.default_rng(5)
    pairs = [_random_banded(20, 2, rng) for _ in range(3)]
    Ms = np.stack([m for m, _ in pairs])
    tb = torch.as_tensor(np.stack([b for _, b in pairs]))
    X = rng.standard_normal((4, 3, 20))
    Tx = torch.as_tensor(X)
    np.testing.assert_allclose(B.banded_matvec(tb, Tx).numpy(),
                               np.einsum("mij,kmj->kmi", Ms, X), atol=1e-12)
    np.testing.assert_allclose(B.banded_rmatvec(tb, Tx).numpy(),
                               np.einsum("mji,kmj->kmi", Ms, X), atol=1e-12)
    btb = B.banded_btb(tb).numpy()
    for j in range(3):
        G = Ms[j].T @ Ms[j]
        for e in range(5):
            np.testing.assert_allclose(btb[j, e, : 20 - e], np.diagonal(G, -e), atol=1e-12)


def test_cr_solve_cols_and_block_size():
    """The multi-column cyclic-reduction solve equals the one-column solve
    per column, and a 16-wide level panel factors as the default 64-wide
    one does (1e-12 relative: the same system, other panel splits)."""
    from parapint_tpu_torch.linalg.tridiag import BlockTridiag, cr_factor, cr_solve, cr_solve_cols

    rng = np.random.default_rng(11)
    m, ns = 5, 24
    A = rng.standard_normal((m * ns, m * ns))
    S = A @ A.T + m * ns * np.eye(m * ns)
    t = torch.as_tensor(S).reshape(m, ns, m, ns)
    g = torch.arange(m)
    tri = BlockTridiag(diag=t[g, :, g, :], upper=t[g[:-1], :, g[:-1] + 1, :])
    R = torch.as_tensor(rng.standard_normal((m * ns, 3)))
    f64, f16 = cr_factor(tri), cr_factor(tri, block_size=16)
    X = cr_solve_cols(f64, R)
    cols = torch.stack([cr_solve(f64, R[:, j]) for j in range(3)], dim=1)
    assert torch.allclose(X, cols, rtol=1e-12, atol=0)
    assert torch.allclose(cr_solve_cols(f16, R), X, rtol=1e-12, atol=1e-15)
    assert torch.equal(f16.inertia, f64.inertia)
    assert torch.allclose(tri.todense() @ X, R, atol=1e-10)


CASES = [(32, 16), (40, 16)]


@pytest.fixture(scope="module")
def condensed_cases():
    """Per (n_q, tile): the seeded system, the dense solve and eigenvalue
    inertia, and the JAX solver's solution and inertia."""
    out = {}
    for nq, ts in CASES:
        rng = np.random.default_rng(nq)
        nm, nt, N, p = 3, 4, 5, 1
        A_bands, M, nk, _ = _build_harness_system(nq, nm, nt, N, p, rng)
        rhs = rng.standard_normal(M.shape[0])
        w = np.linalg.eigvalsh(M)
        kkt = JKKT(A_bands=jnp.asarray(A_bands), q_c=jnp.zeros((nt, nt)), n_t=nt, n_blocks=N)
        solver = JSolver(tile_size=ts)
        # under jax.jit, as tests/test_condensed.py runs the JAX solver
        fact = jax.jit(solver.numeric)(kkt)
        sol = jax.jit(lambda f, r: solver.solve(f, r, kkt=kkt))(
            fact,
            JBlockRhs(blocks=jnp.asarray(rhs[: N * nk].reshape(N, nk)),
                      coupling=jnp.asarray(rhs[N * nk :])),
        )
        out[(nq, ts)] = dict(
            A_bands=A_bands, nt=nt, N=N, nk=nk, rhs=rhs, dense=np.linalg.solve(M, rhs),
            eig=(int((w > 0).sum()), int((w < 0).sum()), 0),
            jax=np.concatenate([np.asarray(sol.blocks).ravel(), np.asarray(sol.coupling)]),
            jax_inertia=tuple(int(v) for v in solver.inertia(fact)),
        )
    return out


@pytest.mark.parametrize("nq,ts", CASES)
def test_condensed_matches_reference(condensed_cases, nq, ts):
    c = condensed_cases[(nq, ts)]
    N, nk, nt = c["N"], c["nk"], c["nt"]
    kkt = condensed_kkt_from_numpy(c["A_bands"], np.zeros((nt, nt)), nt, N, "cpu")
    solver = ptt.CondensedLSQSolver(tile_size=ts)
    solver.symbolic(kkt)
    fact = solver.numeric(kkt)
    rhs = torch.as_tensor(c["rhs"])
    sol = solver.solve(fact, BlockRhs(blocks=rhs[: N * nk].reshape(N, nk), coupling=rhs[N * nk :]),
                       kkt=kkt)
    x = np.concatenate([sol.blocks.numpy().ravel(), sol.coupling.numpy()])
    inertia = tuple(int(v) for v in solver.inertia(fact))
    print(f"n_q {nq} tile {ts} (n_pad {fact.n_pad}): max|d| to dense "
          f"{np.abs(x - c['dense']).max():.3e}, to JAX {np.abs(x - c['jax']).max():.3e}, "
          f"inertia {inertia}")
    np.testing.assert_allclose(x, c["dense"], atol=1e-8)
    assert np.abs(x - c["jax"]).max() <= 1e-10 * np.abs(c["jax"]).max()
    assert inertia == c["jax_inertia"] == c["eig"]
    assert int(solver.status(fact)) == 0
    assert fact.n_pad == (-nq) % ts
    with pytest.raises(ValueError, match="needs kkt"):
        solver.solve(fact, BlockRhs(blocks=rhs[: N * nk].reshape(N, nk), coupling=rhs[N * nk :]))


def test_bandwidth_exceeds_tile():
    kkt = condensed_kkt_from_numpy(np.zeros((2, 7, 16)), np.zeros((2, 2)), 2, 1, "cpu")
    with pytest.raises(ValueError, match="exceeds tile size"):
        ptt.CondensedLSQSolver(tile_size=4).symbolic(kkt)


HARNESS = dict(n_blocks=4, n_q_per_block=32, n_y_multiplier=2, n_theta=5, verbose=False)
METHODS = ["csc", "ssc", "fs"]


@pytest.fixture(scope="module")
def jax_harness():
    return {m: jperf.run(method=m, **HARNESS) for m in METHODS}


@pytest.mark.parametrize("method", METHODS)
def test_harness_matches_reference(jax_harness, method):
    j = jax_harness[method]
    t = perf.run(method=method, device="cpu", **HARNESS)
    print(f"{method}: max_err JAX {j.max_err!r} port {t.max_err!r}, status {j.status}/{t.status}, "
          f"theta {t.theta.tolist()}")
    assert t.status == j.status == 0
    assert np.isclose(t.max_err, j.max_err, rtol=1e-6)
    assert np.isclose(t.max_err, jax_harness["fs"].max_err, rtol=1e-6)
    assert t.max_err < 5.0 and t.theta.shape == (HARNESS["n_theta"],)


def test_harness_refuses_psc_and_cpu_default():
    with pytest.raises(RuntimeError, match="psc runs on the ranks of a process group"):
        perf.run(method="psc", device="cpu", **HARNESS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            perf.run(method="csc", **HARNESS)


def test_condensed_arguments_match_reference(condensed_cases):
    """``CondensedLSQSolver(zero_tol=1e-10, factor_dtype=float32)`` on the
    n_q=32, tile 16 system, both packages built alike and run under
    ``jax.jit`` as the fixture runs the JAX solver: inertia and status
    equal (and the dense eigenvalues' inertia), G's level inverses in the
    bands' dtype, the solutions within 1e-5 x max|x| of the JAX solver's
    (a float32 factor of G: tests/test_torch_schur.py's float32 bar)."""
    c = condensed_cases[(32, 16)]
    N, nk, nt = c["N"], c["nk"], c["nt"]
    jsolver = JSolver(tile_size=16, zero_tol=1e-10, factor_dtype=jnp.float32)
    tsolver = ptt.CondensedLSQSolver(tile_size=16, zero_tol=1e-10, factor_dtype=torch.float32)
    assert tsolver._dense.zero_tol == jsolver._dense.zero_tol == tsolver.zero_tol
    jkkt = JKKT(A_bands=jnp.asarray(c["A_bands"]), q_c=jnp.zeros((nt, nt)), n_t=nt, n_blocks=N)
    jfact = jax.jit(jsolver.numeric)(jkkt)
    rhs = c["rhs"]
    jsol = jax.jit(lambda f, r: jsolver.solve(f, r, kkt=jkkt))(
        jfact, JBlockRhs(blocks=jnp.asarray(rhs[: N * nk].reshape(N, nk)),
                         coupling=jnp.asarray(rhs[N * nk :])))
    kkt = condensed_kkt_from_numpy(c["A_bands"], np.zeros((nt, nt)), nt, N, "cpu")
    fact = tsolver.numeric(kkt)
    trhs = torch.as_tensor(rhs)
    sol = tsolver.solve(fact, BlockRhs(blocks=trhs[: N * nk].reshape(N, nk), coupling=trhs[N * nk :]),
                        kkt=kkt)
    x = np.concatenate([sol.blocks.numpy().ravel(), sol.coupling.numpy()])
    jx = np.concatenate([np.asarray(jsol.blocks).ravel(), np.asarray(jsol.coupling)])
    inertia = tuple(int(v) for v in tsolver.inertia(fact))
    assert inertia == tuple(int(v) for v in jsolver.inertia(jfact)) == c["eig"]
    assert int(tsolver.status(fact)) == int(jsolver.status(jfact)) == 0
    assert [t.dtype for t in fact.g_fact.tinv] == [torch.float64] * len(jfact.g_fact.tinv)
    print(f"max|d| to JAX {np.abs(x - jx).max():.3e} (max|x| {np.abs(jx).max():.3e})")
    assert np.abs(x - jx).max() <= 1e-5 * np.abs(jx).max()
