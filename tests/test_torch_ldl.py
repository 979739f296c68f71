"""PyTorch batched LDL^T (parapint_tpu_torch/ops/ldl.py) vs
parapint_tpu.ops.ldl on the same numpy inputs.

float64 runs compare against the reference's float64 path at 1e-10 (its own
fused-vs-separate bound in tests/test_ldl.py); float32 runs go through the
panel wrapper's plain version and compare at 2e-5 relative to the largest
entry (float32 eps times the up-to-128-column elimination chain: 1.2e-7 x
128 = 1.5e-5; observed 3e-7).  Inertia exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parapint_tpu.ops import ldl as jldl
from parapint_tpu_torch.ops import ldl as tldl

torch.set_num_threads(1)

# the JAX package's helpers that it does not jit itself, under jax.jit as
# its callers run them (eagerly, each of their operations compiles anew)
j_ruiz_scale = jax.jit(jldl.ruiz_scale)
j_ldl_winv = jax.jit(jldl.ldl_winv, static_argnums=1)
j_unit_lower_inv_blocked = jax.jit(jldl.unit_lower_inv_blocked, static_argnums=1)
j_winv_apply = jax.jit(jldl.winv_apply)
j_ldl_inverse = jax.jit(jldl.ldl_inverse)
j_unit_lower_inv_b = jax.jit(jldl._unit_lower_inv_b)
j_batch_inertia = jax.jit(lambda d, n: jax.vmap(lambda x: jldl.ldl_inertia(x, n=n))(d),
                          static_argnums=1)


def kkt_like(n, m, rng, c_reg=0.0):
    """Quasi-definite KKT-like matrix [H J^T; J -c I] (as tests/test_ldl.py)."""
    A = rng.standard_normal((n, n))
    H = A @ A.T + n * np.eye(n)
    J = rng.standard_normal((m, n))
    K = np.zeros((n + m, n + m))
    K[:n, :n] = H
    K[:n, n:] = J.T
    K[n:, :n] = J
    K[n:, n:] = -c_reg * np.eye(m)
    return K


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("n,bs", [(6, 8), (20, 8), (40, 16), (130, 64)])
def test_factor_winv_batched_matches_reference_f64(n, bs):
    rng = np.random.default_rng(5)
    A = np.stack([kkt_like(n - 2, 2, rng, c_reg=1e-6) for _ in range(4)])
    LD_r, d_r, W_r = jldl.ldl_factor_winv_batched(jnp.asarray(A), block_size=bs)
    LD, d, W = tldl.ldl_factor_winv_batched(_t(A), block_size=bs)
    assert LD.shape == LD_r.shape and W.shape == W_r.shape
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), rtol=1e-10)
    np.testing.assert_allclose(
        np.tril(LD.numpy()), np.tril(np.asarray(LD_r)), rtol=1e-10, atol=1e-10
    )
    np.testing.assert_allclose(W.numpy(), np.asarray(W_r), rtol=1e-10, atol=1e-10)
    npad = W.shape[-1]
    L = np.tril(LD.numpy(), -1) + np.eye(npad)
    prod = np.einsum("bij,bjk->bik", W.numpy(), L)
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(npad), prod.shape), atol=1e-8)


@pytest.mark.parametrize("n,bs", [(64, 64), (128, 64), (49, 64)])
def test_factor_winv_batched_f32_panel_path(n, bs):
    """float32 goes through the panel wrapper (plain version on the CPU)."""
    rng = np.random.default_rng(n)
    A = np.stack([kkt_like(n - 5, 5, rng, c_reg=1e-3) for _ in range(3)])
    s = np.stack([np.asarray(j_ruiz_scale(jnp.asarray(a))) for a in A])
    A = (A * s[:, :, None] * s[:, None, :]).astype(np.float32)
    LD_r, d_r, W_r = jldl.ldl_factor_winv_batched(jnp.asarray(A), block_size=bs)
    LD, d, W = tldl.ldl_factor_winv_batched(torch.as_tensor(A), block_size=bs)
    scale = np.abs(np.asarray(LD_r)).max()
    assert np.abs(np.tril(LD.numpy()) - np.tril(np.asarray(LD_r))).max() < 2e-5 * scale
    assert np.abs(W.numpy() - np.asarray(W_r)).max() < 2e-5 * np.abs(np.asarray(W_r)).max()
    pos, neg, zero = tldl.ldl_inertia(d, n=n)
    pr, nr, zr = j_batch_inertia(d_r, n)
    assert pos.tolist() == np.asarray(pr).tolist()
    assert neg.tolist() == np.asarray(nr).tolist() == [5, 5, 5]
    assert zero.tolist() == np.asarray(zr).tolist()


def test_panel_width_snaps_to_multiple_of_8():
    """The chain SC's 49-wide tiles factor as 56-wide panels; the extra rows
    are identity padding excluded from the inertia (test_ldl.py:131)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 49, 49))
    A = (A + A.transpose(0, 2, 1)) + 49 * np.eye(49)
    LD, d, W = tldl.ldl_factor_winv_batched(_t(A), block_size=64)
    _, d_r, _ = jldl.ldl_factor_winv_batched(jnp.asarray(A), block_size=64)
    assert LD.shape[-1] == 56 == d_r.shape[-1]
    L = np.tril(LD.numpy(), -1) + np.eye(56)
    rec = np.einsum("bij,bj,bkj->bik", L, d.numpy(), L)[:, :49, :49]
    assert np.max(np.abs(rec - A)) < 1e-9 * np.max(np.abs(A))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_r), rtol=1e-10)
    pos, neg, zero = tldl.ldl_inertia(d, n=49)
    for i in range(3):
        w = np.linalg.eigvalsh(A[i])
        assert (int(pos[i]), int(neg[i]), int(zero[i])) == ((w > 0).sum(), (w < 0).sum(), 0)


def test_ruiz_scale_matches_reference():
    rng = np.random.default_rng(1)
    A = np.stack([kkt_like(30, 6, rng) * 10.0 ** rng.uniform(-8, 8) for _ in range(3)])
    s_r = np.stack([np.asarray(j_ruiz_scale(jnp.asarray(a))) for a in A])
    np.testing.assert_allclose(tldl.ruiz_scale(_t(A)).numpy(), s_r, rtol=1e-13)


@pytest.mark.parametrize("zero_tol", [0.0, 1e-3])
def test_ldl_inertia_matches_reference(zero_tol):
    d = np.array([[3.0, -2.0, 0.0, 1e-5, -1e-4, 1.0, np.nan, 1.0]])
    pos, neg, zero = tldl.ldl_inertia(_t(d), n=7, zero_tol=zero_tol)
    ref = jldl.ldl_inertia(jnp.asarray(d[0]), n=7, zero_tol=zero_tol)
    assert (int(pos[0]), int(neg[0]), int(zero[0])) == tuple(int(v) for v in ref)


@pytest.mark.parametrize("n", [8, 16, 40, 64])
def test_recursive_unit_lower_inverse(n):
    """The block-recursive inverse (not Neumann doubling) on the squared
    1D Laplacian, whose nilpotent powers grow before they vanish."""
    T = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    K = T @ T + 1e-3 * np.eye(n)
    C = np.linalg.cholesky(K)
    L = C / np.diag(C)[None, :]  # unit lower factor of K = L D L^T
    W = tldl._unit_lower_inv_b(_t(L[None]))[0].numpy()
    W_r = np.asarray(j_unit_lower_inv_b(jnp.asarray(L[None])))[0]
    np.testing.assert_allclose(W, W_r, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(W @ L, np.eye(n), atol=1e-9)


# -- the dense single-matrix and batched families (K5 / K2 panels in f32) ----
#
# float64 against the reference at 1e-10 relative (the same column sweep and
# recursive inverse, different summation order); float32 at 2e-5 relative
# to the largest factor entry (see the module docstring).


def _dtype_tol(dtype):
    return (np.float64, torch.float64, 1e-10) if dtype == "f64" else (np.float32, torch.float32, 2e-5)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("n,bs,algorithm", [(40, 16, "fori"), (37, 13, "fori"), (70, 16, "recursive"), (24, 8, "unrolled")])
def test_ldl_factor_and_solve_match_reference(n, bs, algorithm, dtype):
    npd, tdt, tol = _dtype_tol(dtype)
    rng = np.random.default_rng(n)
    K = kkt_like(n - 6, 6, rng, c_reg=1e-3).astype(npd)
    LD_r, d_r = jldl.ldl_factor(jnp.asarray(K), block_size=bs, algorithm=algorithm)
    LD, d = tldl.ldl_factor(torch.as_tensor(K), block_size=bs, algorithm=algorithm)
    assert LD.dtype == tdt and LD.shape == LD_r.shape
    scale = np.abs(np.tril(np.asarray(LD_r))).max()
    assert np.abs(np.tril(LD.numpy()) - np.tril(np.asarray(LD_r))).max() <= tol * scale
    pr = [int(v) for v in jldl.ldl_inertia(d_r, n=n)]
    assert [int(v) for v in tldl.ldl_inertia(d, n=n)] == pr == [n - 6, 6, 0]
    b = rng.standard_normal((n, 3)).astype(npd)
    x = tldl.ldl_solve(LD, torch.as_tensor(b)).numpy()
    x_r = np.asarray(jldl.ldl_solve(LD_r, jnp.asarray(b)))
    assert np.abs(x - x_r).max() <= 10 * tol * max(1.0, np.abs(x_r).max())
    x1 = tldl.ldl_solve(LD, torch.as_tensor(b[:, 0])).numpy()
    np.testing.assert_allclose(x1, x[:, 0], rtol=0, atol=1e-12 if dtype == "f64" else 1e-5)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("n,bs", [(20, 8), (49, 64), (130, 64)])
def test_ldl_factor_batched_and_solve_match_reference(n, bs, dtype):
    npd, tdt, tol = _dtype_tol(dtype)
    rng = np.random.default_rng(n + 1)
    A = np.stack([kkt_like(n - 4, 4, rng, c_reg=1e-3) for _ in range(3)]).astype(npd)
    LD_r, d_r = jldl.ldl_factor_batched(jnp.asarray(A), block_size=bs)
    LD, d = tldl.ldl_factor_batched(torch.as_tensor(A), block_size=bs)
    assert LD.dtype == tdt and LD.shape == LD_r.shape
    scale = np.abs(np.tril(np.asarray(LD_r))).max()
    assert np.abs(np.tril(LD.numpy()) - np.tril(np.asarray(LD_r))).max() <= tol * scale
    pos, neg, zero = tldl.ldl_inertia(d, n=n)
    assert neg.tolist() == [4, 4, 4] and zero.tolist() == [0, 0, 0]
    B = rng.standard_normal((3, n, 2)).astype(npd)
    X = tldl.ldl_solve(LD, torch.as_tensor(B)).numpy()
    X_r = np.stack([np.asarray(jldl.ldl_solve(LD_r[i], jnp.asarray(B[i]))) for i in range(3)])
    assert np.abs(X - X_r).max() <= 10 * tol * max(1.0, np.abs(X_r).max())
    xv = tldl.ldl_solve(LD, torch.as_tensor(B[:, :, 0])).numpy()
    assert np.abs(xv - X[:, :, 0]).max() <= 10 * tol * max(1.0, np.abs(X_r).max())


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_winv_family_matches_reference(dtype):
    """ldl_winv, unit_lower_inv_blocked (incl. the identity padding of a
    non-multiple size), winv_apply and ldl_inverse."""
    npd, _, tol = _dtype_tol(dtype)
    rng = np.random.default_rng(3)
    n = 50
    K = kkt_like(n - 10, 10, rng, c_reg=1e-2)
    s = np.asarray(j_ruiz_scale(jnp.asarray(K)))
    K = (K * s[:, None] * s[None, :]).astype(npd)
    LD_r, d_r = jldl.ldl_factor(jnp.asarray(K), block_size=16)
    LD = torch.as_tensor(np.array(LD_r))
    W_r, dd_r = j_ldl_winv(LD_r, 16)
    W, dd = tldl.ldl_winv(LD, 16)
    scale = np.abs(np.asarray(W_r)).max()
    assert np.abs(W.numpy() - np.asarray(W_r)).max() <= tol * scale
    np.testing.assert_array_equal(dd.numpy(), np.asarray(dd_r))
    L = np.tril(np.asarray(LD_r), -1)[:45, :45] + np.eye(45, dtype=npd)
    Wb = tldl.unit_lower_inv_blocked(torch.as_tensor(L), 16).numpy()
    Wb_r = np.asarray(j_unit_lower_inv_blocked(jnp.asarray(L), 16))
    assert Wb.shape == (45, 45)
    assert np.abs(Wb - Wb_r).max() <= tol * np.abs(Wb_r).max()
    b = rng.standard_normal((n, 2)).astype(npd)
    x = tldl.winv_apply(W, dd, torch.as_tensor(b)).numpy()
    x_r = np.asarray(j_winv_apply(W_r, dd_r, jnp.asarray(b)))
    assert np.abs(x - x_r).max() <= 10 * tol * max(1.0, np.abs(x_r).max())
    assert np.abs(K @ x - b).max() <= 100 * tol * max(1.0, np.abs(b).max())
    Kinv = tldl.ldl_inverse(LD, dd).numpy()
    Kinv_r = np.asarray(j_ldl_inverse(LD_r, d_r))
    assert np.abs(Kinv - Kinv_r).max() <= 10 * tol * np.abs(Kinv_r).max()


@pytest.mark.parametrize("algo", ["slab", "column"])
@pytest.mark.parametrize("n", [130, 49])
def test_factor_winv_batched_f32_width_50(monkeypatch, algo, n):
    """block_size=50: 50-wide panels (not a multiple of 8) go to the
    column-by-column entries (K3's plain version on the CPU), and so does
    every panel under PT_PANEL_ALGO=column; float32 vs the JAX package at
    2e-5 relative (module docstring), inertia exact."""
    monkeypatch.setenv("PT_PANEL_ALGO", algo)
    rng = np.random.default_rng(n + 50)
    A = np.stack([kkt_like(n - 5, 5, rng, c_reg=1e-3) for _ in range(3)])
    s = np.stack([np.asarray(j_ruiz_scale(jnp.asarray(a))) for a in A])
    A = (A * s[:, :, None] * s[:, None, :]).astype(np.float32)
    LD_r, d_r, W_r = jldl.ldl_factor_winv_batched(jnp.asarray(A), block_size=50)
    LD, d, W = tldl.ldl_factor_winv_batched(torch.as_tensor(A), block_size=50)
    assert LD.shape == LD_r.shape and W.shape == W_r.shape
    scale = np.abs(np.asarray(LD_r)).max()
    assert np.abs(np.tril(LD.numpy()) - np.tril(np.asarray(LD_r))).max() < 2e-5 * scale
    assert np.abs(W.numpy() - np.asarray(W_r)).max() < 2e-5 * np.abs(np.asarray(W_r)).max()
    LD2, d2 = tldl.ldl_factor_batched(torch.as_tensor(A), block_size=50)
    LD2_r, _ = jldl.ldl_factor_batched(jnp.asarray(A), block_size=50)
    assert np.abs(np.tril(LD2.numpy()) - np.tril(np.asarray(LD2_r))).max() < 2e-5 * scale
    pos, neg, zero = tldl.ldl_inertia(d, n=n)
    pr, nr, zr = j_batch_inertia(d_r, n)
    assert pos.tolist() == np.asarray(pr).tolist()
    assert neg.tolist() == np.asarray(nr).tolist() == [5, 5, 5]
    assert zero.tolist() == np.asarray(zr).tolist() == [0, 0, 0]
    assert [v.tolist() for v in tldl.ldl_inertia(d2, n=n)] == [pos.tolist(), neg.tolist(), zero.tolist()]
