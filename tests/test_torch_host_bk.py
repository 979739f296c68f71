"""HostBKSolver of the PyTorch port (its own g++ build of
``parapint_tpu_torch/csrc/bk_ldl.cpp``) against the JAX package's
(``parapint_tpu/native``) on the same numpy inputs, made from a seed: the
six cases of ``tests/test_host_bk.py``.

The two libraries are the same C++ source built with the same flags, so the
factors and pivots must be bitwise equal; inertia and status equal; solves
within the reference test's 1e-9 of the planted solution; the oracle case
within 1e-9 of the port's unpivoted ``ops/ldl.py::ldl_factor``; ``ip_solve``
optimal in the JAX package's iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.linalg import HostBKSolver as JHostBKSolver

torch.set_num_threads(1)
T = torch.as_tensor


def saddle(n, m, rng, zero_block=True):
    """tests/test_host_bk.py's saddle-point KKT."""
    H = rng.standard_normal((n, n))
    H = H @ H.T + 0.1 * np.eye(n)
    J = rng.standard_normal((m, n))
    C = np.zeros((m, m)) if zero_block else -1e-8 * np.eye(m)
    return np.block([[H, J.T], [J, C]])


def both(K, inertia=True):
    """(JAX solver, JAX factor, port solver, port factor) of K: factors and
    pivots bitwise equal, status (and ``inertia``) equal."""
    js, ts = JHostBKSolver(), ptt.HostBKSolver()
    jf, tf = js.numeric(jnp.asarray(K)), ts.numeric(T(K))
    np.testing.assert_array_equal(tf.factors, jf.factors)
    np.testing.assert_array_equal(tf.ipiv, jf.ipiv)
    if inertia:
        assert tuple(int(v) for v in ts.inertia(tf)) == tuple(int(v) for v in js.inertia(jf))
    assert int(ts.status(tf)) == int(js.status(jf))
    return js, jf, ts, tf


def test_factor_solve_inertia():
    rng = np.random.default_rng(0)
    K = saddle(40, 15, rng)  # a hard zero (2,2) block: needs pivoting
    js, jf, ts, tf = both(K)
    assert int(ts.status(tf)) == 0
    x_true = rng.standard_normal(55)
    x = ts.solve(tf, T(K @ x_true))
    assert x.dtype == torch.float64
    np.testing.assert_array_equal(x.numpy(), np.asarray(js.solve(jf, jnp.asarray(K @ x_true))))
    assert np.allclose(x.numpy(), x_true, atol=1e-9)
    w = np.linalg.eigvalsh(K)
    assert tuple(int(v) for v in ts.inertia(tf)) == ((w > 0).sum(), (w < 0).sum(), 0)


def test_multirhs():
    rng = np.random.default_rng(1)
    K = saddle(20, 8, rng)
    js, jf, ts, tf = both(K)
    B = rng.standard_normal((28, 5))
    X = ts.solve(tf, T(B)).numpy()
    np.testing.assert_array_equal(X, np.asarray(js.solve(jf, jnp.asarray(B))))
    assert np.allclose(K @ X, B, atol=1e-9)


def test_batched():
    rng = np.random.default_rng(2)
    Ks = np.stack([saddle(25, 10, rng) for _ in range(8)])
    js, jf, ts, tf = both(Ks)
    assert int(ts.status(tf)) == 0
    rhs = rng.standard_normal((8, 35))
    X = ts.solve(tf, T(rhs)).numpy()
    np.testing.assert_array_equal(X, np.asarray(js.solve(jf, jnp.asarray(rhs))))
    for b in range(8):
        assert np.allclose(Ks[b] @ X[b], rhs[b], atol=1e-9)
    assert tuple(int(v) for v in ts.inertia(tf)) == (8 * 25, 8 * 10, 0)


def test_oracle_for_unpivoted_kernel():
    """The pivoted host factorization against the port's unpivoted
    ``ldl_factor`` on a strongly quasi-definite system, where both must
    agree."""
    from parapint_tpu_torch.ops.ldl import ldl_factor, ldl_solve

    rng = np.random.default_rng(3)
    K = saddle(30, 12, rng, zero_block=False)
    K[30:, 30:] -= np.eye(12)
    js, jf, ts, tf = both(K)
    b = rng.standard_normal(42)
    x_host = ts.solve(tf, T(b)).numpy()
    LD, _ = ldl_factor(T(K), block_size=16)
    x_ldl = ldl_solve(LD, T(b)).numpy()
    assert np.allclose(x_host, x_ldl, atol=1e-9)


def test_singular_detection():
    """A failed factorization: the same factors, pivots and status.  Its
    inertia is not compared: the JAX package's routine reads the columns
    the factorization never reached as 2x2 blocks, past the end of the
    matrix, so its counts are undefined; the port counts those columns as
    zero pivots (ROADMAP C12)."""
    K = np.zeros((5, 5))
    K[0, 0] = 1.0
    _, _, ts, tf = both(K, inertia=False)
    assert int(ts.status(tf)) == 2  # singular
    assert tuple(int(v) for v in ts.inertia(tf)) == (1, 0, 4)


def test_ip_solve_with_host_solver():
    """The single-NLP interior point through ``ip_solve`` with the host
    solver: optimal in the JAX package's iteration count and objective."""
    from parapint_tpu.utils.timer import HierarchicalTimer as JTimer

    from parapint_tpu_torch.utils.timer import HierarchicalTimer

    def run(pkg, timer, exp, stack, solver):
        model = pkg.NLPModel(
            objective=lambda v: v[0] ** 2 + v[1] ** 2,
            eq_constraints=lambda v: stack([v[1] - exp(v[0])]),
            x0=np.array([0.5, 0.5]),
            **({"device": "cpu"} if pkg is ptt else {}),
        )
        iface = pkg.InteriorPointInterface(model)
        opts = pkg.IPOptions()
        opts.linalg.solver = solver
        t = timer()
        status = pkg.ip_solve(iface, opts, timer=t)
        iters = t._root.children["IP solve"].children["convergence check"].count
        x = np.asarray(iface.get_primals())
        return status.value, iters, float(x[0] ** 2 + x[1] ** 2)

    j = run(pt, JTimer, jnp.exp, jnp.stack, JHostBKSolver())
    t = run(ptt, HierarchicalTimer, torch.exp, torch.stack, ptt.HostBKSolver())
    print(f"ip_solve with HostBKSolver: port {t}, JAX {j}")
    assert t[0] == j[0] == ptt.InteriorPointStatus.optimal.value
    assert t[1] == j[1]
    assert abs(t[2] - j[2]) <= 1e-8
