"""SchurComplementSolver of the port (parapint_tpu_torch/linalg/schur.py) vs
parapint_tpu's on the same numpy systems, and both vs a dense oracle — the
counterparts of tests/test_schur.py and tests/test_explicit_inverse.py.

Covered: packed-LDL^T (LD) and explicit-inverse (W) modes; dense borders
and block-local borders with chain, scatter and shared assembly; dense and
cyclic-reduction coupling; masked padding blocks (pad_block_count); the
hybrid-precision path; bf16 W storage; a singular block.

Tolerances: inertia exact (against the dense eigenvalues and the JAX
solver).  float64 solves: 1e-8 (tests/test_schur.py's bound).  A float32
factor under the default adaptive refinement stops once the float32 probe
residual is below 1e-5 x ||rhs||, so those solves are held to 1e-5 relative
(observed ~1e-7); fixed refinement passes and the hybrid path keep the
reference's own bounds (1e-8, 1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_schur import dense_assemble, make_system

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.linalg.schur import BlockKKT as JBlockKKT
from parapint_tpu.linalg.schur import BlockRhs as JBlockRhs
from parapint_tpu.linalg.schur import LocalBlockKKT as JLocalBlockKKT
from parapint_tpu_torch.convert import block_kkt_from_numpy, block_rhs_from_numpy
from parapint_tpu_torch.linalg.schur import BlockKKT, BlockRhs, pad_block_count

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inertia(solver, fact):
    return tuple(int(v) for v in solver.inertia(fact))


def _eig_inertia(M):
    w = np.linalg.eigvalsh(M)
    return ((w > 0).sum(), (w < 0).sum(), 0)


def _solve_both(jsolver, tsolver, jkkt, rhs_blocks, rhs_coupling):
    """(JAX fact, JAX x, port fact, port x) on the same system; x flattened.
    The JAX solver runs under ``jax.jit``, as the JAX drivers run it."""
    jrhs = JBlockRhs(blocks=jnp.asarray(rhs_blocks), coupling=jnp.asarray(rhs_coupling))
    jf = jax.jit(jsolver.numeric)(jkkt)
    jx = jax.jit(jsolver.solve)(jf, jrhs)
    tf = tsolver.numeric(block_kkt_from_numpy(_np(jkkt), "cpu"))
    tx = tsolver.solve(tf, block_rhs_from_numpy(_np(jrhs), "cpu"))
    flat = lambda b, c: np.concatenate([np.asarray(b).reshape(-1), np.asarray(c)])
    return jf, flat(jx.blocks, jx.coupling), tf, flat(tx.blocks.numpy(), tx.coupling.numpy())


MODES = {
    "LD": dict(),
    "W": dict(explicit_inverse=True),
    "W-f32": dict(explicit_inverse=True, factor="float32"),
    "LD-f32": dict(factor="float32"),
}


def _tol(mode):
    return 1e-5 if mode == "W-f32" else 1e-8


def _solvers(mode, coupling="dense", **extra):
    """(JAX solver, port solver) of one mode; coupling "dense" (the default
    DenseLDLSolver) or "cr" (BlockTridiagSolver)."""
    kw = dict(MODES[mode], **extra)
    fd = kw.pop("factor", None)
    j = pt.SchurComplementSolver(
        factor_dtype=None if fd is None else getattr(jnp, fd),
        schur_complement_solver=pt.BlockTridiagSolver() if coupling == "cr" else None,
        **kw,
    )
    t = ptt.SchurComplementSolver(
        factor_dtype=None if fd is None else getattr(torch, fd),
        schur_complement_solver=ptt.BlockTridiagSolver() if coupling == "cr" else None,
        **kw,
    )
    return j, t


@pytest.mark.parametrize(
    "N,nk,nc,mode",
    [(4, 12, 5, "LD"), (4, 12, 5, "W"), (4, 12, 5, "W-f32"), (3, 30, 1, "LD"), (8, 16, 16, "W-f32")],
)
def test_dense_border_schur_matches_reference(N, nk, nc, mode):
    diag, border, q = make_system(N, nk, nc)
    M = dense_assemble(diag, border, q)
    x_true = np.random.default_rng(1).standard_normal(M.shape[0])
    rhs = M @ x_true
    jsol, tsol = _solvers(mode, block_size=16)
    kkt = JBlockKKT.make(jnp.asarray(diag), jnp.asarray(border), jnp.asarray(q))
    jf, jx, tf, tx = _solve_both(jsol, tsol, kkt, rhs[: N * nk].reshape(N, nk), rhs[N * nk :])
    assert tsol.symbolic(block_kkt_from_numpy(_np(kkt), "cpu")).status == 0
    scale = np.abs(x_true).max()
    assert np.abs(tx - x_true).max() <= _tol(mode) * scale
    assert np.abs(tx - jx).max() <= _tol(mode) * scale
    assert _inertia(tsol, tf) == _inertia(jsol, jf) == _eig_inertia(M)
    assert tsol.n_numeric == 1 and int(tsol.status(tf)) == 0


@pytest.mark.parametrize("mode", ["LD", "W"])
def test_indefinite_blocks(mode):
    rng = np.random.default_rng(5)
    N, n, m, nc = 3, 8, 4, 3
    nk = n + m
    diag = np.zeros((N, nk, nk))
    border = np.zeros((N, nc, nk))
    for i in range(N):
        H = rng.standard_normal((n, n))
        H = H @ H.T + n * np.eye(n)
        J = rng.standard_normal((m, n))
        diag[i] = np.block([[H, J.T], [J, -1e-8 * np.eye(m)]])
        border[i, :, :n] = rng.standard_normal((nc, n))
    q = np.diag(rng.random(nc) + 1.0)
    M = dense_assemble(diag, border, q)
    x_true = rng.standard_normal(M.shape[0])
    rhs = M @ x_true
    jsol, tsol = _solvers(mode, block_size=8)
    kkt = JBlockKKT.make(jnp.asarray(diag), jnp.asarray(border), jnp.asarray(q))
    jf, jx, tf, tx = _solve_both(jsol, tsol, kkt, rhs[: N * nk].reshape(N, nk), rhs[N * nk :])
    assert np.allclose(tx, x_true, rtol=1e-7, atol=1e-7)
    assert np.allclose(tx, jx, rtol=1e-8, atol=1e-8)
    assert _inertia(tsol, tf) == _inertia(jsol, jf) == _eig_inertia(M)


@pytest.mark.parametrize("mode", ["LD", "W"])
def test_masked_padding_blocks(mode):
    """Padding blocks (mask 0, from pad_block_count) change neither the
    solution nor the inertia."""
    diag, border, q = make_system(4, 12, 5)
    M = dense_assemble(diag, border, q)
    x_true = np.random.default_rng(2).standard_normal(M.shape[0])
    rhs = M @ x_true
    t = lambda a: torch.as_tensor(a)
    kkt = pad_block_count(BlockKKT.make(t(diag), t(border), t(q)), 3)
    assert kkt.diag.shape[0] == 6 and kkt.mask.tolist() == [1, 1, 1, 1, 0, 0]
    jkkt = JBlockKKT.make(
        jnp.asarray(kkt.diag.numpy()), jnp.asarray(kkt.border.numpy()), jnp.asarray(q),
        jnp.asarray(kkt.mask.numpy()),
    )
    _, tsol = _solvers(mode, block_size=16)
    jsol, _ = _solvers(mode, block_size=16)
    fact = tsol.numeric(kkt)
    rhs_blocks = np.concatenate([rhs[:48].reshape(4, 12), np.zeros((2, 12))])
    sol = tsol.solve(fact, BlockRhs(t(rhs_blocks), t(rhs[48:])))
    assert np.allclose(sol.blocks[:4].numpy().reshape(-1), x_true[:48])
    assert np.allclose(sol.coupling.numpy(), x_true[48:])
    assert _inertia(tsol, fact) == _inertia(jsol, jsol.numeric(jkkt)) == _eig_inertia(M)


def _local_system(assembly, seed=3):
    """A LocalBlockKKT of the given topology with its dense oracle."""
    rng = np.random.default_rng(seed)
    N, nk, ns = 4, 10, 3
    if assembly == "chain":
        L, nc = 2 * ns, (N - 1) * ns
        row_idx = np.full((N, L), nc)
        for i in range(N):
            if i > 0:
                row_idx[i, :ns] = (i - 1) * ns + np.arange(ns)
            if i < N - 1:
                row_idx[i, ns:] = i * ns + np.arange(ns)
    elif assembly == "shared":
        L = nc = ns
        row_idx = np.tile(np.arange(L), (N, 1))
    else:
        L, nc = 4, 7
        row_idx = rng.integers(0, nc, (N, L))
        row_idx[1, 2] = nc  # a masked row (dump index)
    diag = np.stack([make_system(1, nk, 1, seed=seed + i)[0][0] for i in range(N)])
    border_loc = rng.standard_normal((N, L, nk)) * (row_idx < nc)[:, :, None]
    q = np.eye(nc) * 3.0
    M = np.zeros((N * nk + nc, N * nk + nc))
    for i in range(N):
        M[i * nk : (i + 1) * nk, i * nk : (i + 1) * nk] = diag[i]
        for j in range(L):
            if row_idx[i, j] < nc:
                M[N * nk + row_idx[i, j], i * nk : (i + 1) * nk] += border_loc[i, j]
    M[:N * nk, N * nk :] = M[N * nk :, : N * nk].T
    M[N * nk :, N * nk :] = q
    kkt = JLocalBlockKKT.make(
        jnp.asarray(diag), jnp.asarray(border_loc), row_idx, jnp.asarray(q), assembly=assembly
    )
    return kkt, M, N, nk


@pytest.mark.parametrize(
    "assembly, coupling, mode",
    [
        ("chain", "cr", "LD"), ("chain", "cr", "W"), ("chain", "cr", "W-f32"),
        ("chain", "dense", "W"), ("scatter", "dense", "LD"), ("scatter", "dense", "W-f32"),
        ("shared", "dense", "W"),
    ],
)
def test_local_border_assembly_matches_reference(assembly, coupling, mode):
    kkt, M, N, nk = _local_system(assembly)
    x_true = np.random.default_rng(4).standard_normal(M.shape[0])
    rhs = M @ x_true
    jsol, tsol = _solvers(mode, coupling, block_size=8)
    jf, jx, tf, tx = _solve_both(jsol, tsol, kkt, rhs[: N * nk].reshape(N, nk), rhs[N * nk :])
    scale = np.abs(x_true).max()
    assert np.abs(tx - x_true).max() <= _tol(mode) * scale
    assert np.abs(tx - jx).max() <= _tol(mode) * scale
    assert _inertia(tsol, tf) == _inertia(jsol, jf) == _eig_inertia(M)


def test_ld_mode_adaptive_refinement():
    """LD mode keeps the blocks and Q for the adaptive refinement's residual
    matvec and solves to float64 accuracy (the serial twin of
    test_sharded_ld_mode_adaptive_refinement; the serial LD mode factors the
    blocks in their own dtype, as the reference's does)."""
    diag, border, q = make_system(8, 12, 5, seed=11)
    M = dense_assemble(diag, border, q)
    x_true = np.random.default_rng(7).standard_normal(M.shape[0])
    rhs = M @ x_true
    jsol, tsol = _solvers("LD-f32", block_size=8)
    assert tsol.adaptive_refine
    kkt = JBlockKKT.make(jnp.asarray(diag), jnp.asarray(border), jnp.asarray(q))
    jf, jx, tf, tx = _solve_both(jsol, tsol, kkt, rhs[:96].reshape(8, 12), rhs[96:])
    assert tf.diag is not None and tf.block_LD is not None and tf.block_W is None
    assert np.max(np.abs(tx - x_true)) / np.max(np.abs(x_true)) < 1e-8
    assert np.abs(tx - jx).max() < 1e-8 * np.max(np.abs(x_true))


def test_hybrid_precision_factor():
    """factor_dtype=f64 + apply_dtype=f32: inertia at f64 fidelity, W/d/s
    in f32, refinement restores f64 accuracy."""
    diag, border, q = make_system(4, 12, 5, seed=4)
    for i in range(4):
        diag[i][6:, 6:] *= -1.0
        diag[i] = 0.5 * (diag[i] + diag[i].T)
    M = dense_assemble(diag, border, q)
    x_true = np.random.default_rng(1).standard_normal(M.shape[0])
    rhs = M @ x_true
    kw = dict(block_size=8, explicit_inverse=True)
    jsol = pt.SchurComplementSolver(factor_dtype=jnp.float64, apply_dtype=jnp.float32, **kw)
    tsol = ptt.SchurComplementSolver(factor_dtype=torch.float64, apply_dtype=torch.float32, **kw)
    kkt = JBlockKKT.make(jnp.asarray(diag), jnp.asarray(border), jnp.asarray(q))
    jf, jx, tf, tx = _solve_both(jsol, tsol, kkt, rhs[:48].reshape(4, 12), rhs[48:])
    assert tf.block_W.dtype == torch.float32 and tf.block_d.dtype == torch.float32
    assert _inertia(tsol, tf) == _inertia(jsol, jf) == _eig_inertia(M)
    assert np.allclose(tx, x_true, atol=1e-7)


@pytest.mark.parametrize("refine_steps", [3, None])
def test_w_store_dtype_bf16(refine_steps):
    """bf16 W storage: the SC comes from the full W (inertia exact), the
    applies read bf16; three fixed passes reach f64-level accuracy, the
    adaptive mode (with the auto-gate keeping the f32 W) reaches its probe
    floor."""
    diag, border, q = make_system(4, 24, 5, seed=13)
    M = dense_assemble(diag, border, q)
    x_true = np.random.default_rng(5).standard_normal(M.shape[0])
    rhs = M @ x_true
    kw = dict(block_size=8, explicit_inverse=True, refine_steps=refine_steps)
    jsol = pt.SchurComplementSolver(factor_dtype=jnp.float32, w_store_dtype=jnp.bfloat16, **kw)
    tsol = ptt.SchurComplementSolver(factor_dtype=torch.float32, w_store_dtype=torch.bfloat16, **kw)
    kkt = JBlockKKT.make(jnp.asarray(diag), jnp.asarray(border), jnp.asarray(q))
    jf, jx, tf, tx = _solve_both(jsol, tsol, kkt, rhs[:96].reshape(4, 24), rhs[96:])
    assert tf.block_W.dtype == torch.bfloat16
    assert (tf.block_W_hi is not None) == (refine_steps is None)
    assert _inertia(tsol, tf) == _inertia(jsol, jf) == _eig_inertia(M)
    err = np.max(np.abs(tx - x_true)) / np.max(np.abs(x_true))
    assert err < (1e-8 if refine_steps else 1e-5), err


def test_singular_block_reports_singular():
    diag = np.array([[[0.0, 1.0], [1.0, -1.0]], [[2.0, 1.0], [1.0, -1.0]]])
    border = np.array([[[0.3, 0.1]], [[0.2, -0.4]]])
    q = np.array([[5.0]])
    t = lambda a: torch.as_tensor(a)
    for ei in (False, True):
        solver = ptt.SchurComplementSolver(block_size=8, explicit_inverse=ei)
        fact = solver.numeric(BlockKKT.make(t(diag), t(border), t(q)))
        assert int(solver.status(fact)) == int(ptt.LinearSolverStatus.singular)


def _scatter_inputs(N, L, nc, seed):
    """Seeded float64 local-border data whose rows collide (several blocks
    and several rows of one block on one coupling row) and hit the dump
    index nc."""
    rng = np.random.default_rng(seed)
    row_idx = rng.integers(0, nc + 1, size=(N, L))
    row_idx[:, 0] = nc  # a dump row in every block
    row_idx[:, 1] = row_idx[0, 2]  # one coupling row hit by every block
    S = rng.standard_normal((N, L, L))
    border = rng.standard_normal((N, L, 5))
    v = rng.standard_normal((N, 5))
    return row_idx, S, border, v


@pytest.mark.parametrize("N, L, nc", [(6, 7, 4), (16, 12, 30), (3, 20, 9)])
def test_scatter_sites_match_reference_in_fixed_order(N, L, nc):
    """The "scatter" topology's two sums (the SC assembly and the border
    apply) against the JAX package's .at[].add on the same float64 inputs:
    the same values added in another order, so 1e-12 relative."""
    from parapint_tpu.linalg import schur as jschur
    from parapint_tpu_torch.linalg import schur as tschur

    row_idx, S, border, v = _scatter_inputs(N, L, nc, seed=N + L)
    t_row = torch.as_tensor(row_idx)
    sc = tschur._scatter_sc(torch.as_tensor(S), t_row, nc).numpy()
    sc_ref = np.asarray(jschur._scatter_sc(jnp.asarray(S), jnp.asarray(row_idx), nc))
    assert np.abs(sc - sc_ref).max() <= 1e-12 * np.abs(sc_ref).max()
    av = tschur._border_apply_local(torch.as_tensor(border), t_row, torch.as_tensor(v), nc).numpy()
    av_ref = np.asarray(jschur._border_apply_local(
        jnp.asarray(border), jnp.asarray(row_idx), jnp.asarray(v), nc))
    assert np.abs(av - av_ref).max() <= 1e-12 * np.abs(av_ref).max()
    # the order is block-major: a serial loop over the blocks gives the same bits
    loop = np.zeros((nc + 1, nc + 1))
    for b in range(N):
        for i in range(L):
            for j in range(L):
                loop[row_idx[b, i], row_idx[b, j]] += S[b, i, j]
    assert np.array_equal(sc, loop[:nc, :nc])


def _jax_passes(solver, fact, rhs):
    """(x, status, refinement passes) of the JAX solver's
    ``solve_with_status`` run eagerly (``jax.disable_jit``: its
    ``lax.while_loop`` and ``lax.cond`` run as host loops), the passes
    counted from its ``_solve_once`` calls."""
    calls = [0]
    once = solver._solve_once

    def counted(*a, **k):
        calls[0] += 1
        return once(*a, **k)

    solver._solve_once = counted
    try:
        with jax.disable_jit():
            x, status = solver.solve_with_status(fact, rhs)
    finally:
        del solver._solve_once
    return x, int(status), calls[0] - 1


def _conditioned_system(cond, seed=21):
    """make_system's borders and Q around SPD blocks with eigenvalues
    logspaced from 1 to ``cond`` (4 blocks of 12)."""
    diag, border, q = make_system(4, 12, 5, seed=seed)
    rng = np.random.default_rng(2)
    for i in range(4):
        U, _ = np.linalg.qr(rng.standard_normal((12, 12)))
        diag[i] = U @ np.diag(np.logspace(0, np.log10(cond), 12)) @ U.T
    return diag, border, q


# the JAX factor of each conditioned system, shared by its cases
_REFINE_FACTORS = {}


@pytest.mark.parametrize("cond, trigger, max_passes", [(1e4, 1e-3, 2), (1e4, 1e-5, 8)])
def test_refine_trigger_and_max_passes_match_reference(cond, trigger, max_passes):
    """``refine_trigger`` / ``refine_max_passes`` at user values, on bf16-stored
    W without the auto-gate (where the adaptive refinement runs passes):
    the port's passes (its back solves less one) and status equal to the
    JAX solver's; where both converged the solutions within 1e-5 x max|x|
    of each other (tests/test_explicit_inverse.py's bf16 bound).  On these
    1e4-conditioned blocks two passes do not reach a trigger of 1e-3: both
    stop at the cap with status error; under 1e-5 and the default cap both
    converge after the same passes."""
    diag, border, q = _conditioned_system(cond)
    M = dense_assemble(diag, border, q)
    x_true = np.random.default_rng(1).standard_normal(M.shape[0])
    rhs = M @ x_true
    kw = dict(block_size=8, explicit_inverse=True, w_auto_gate=False, refine_trigger=trigger,
              refine_max_passes=max_passes)
    jsol = pt.SchurComplementSolver(factor_dtype=jnp.float32, w_store_dtype=jnp.bfloat16, **kw)
    tsol = ptt.SchurComplementSolver(factor_dtype=torch.float32, w_store_dtype=torch.bfloat16, **kw)
    kkt = JBlockKKT.make(jnp.asarray(diag), jnp.asarray(border), jnp.asarray(q))
    jrhs = JBlockRhs(blocks=jnp.asarray(rhs[:48].reshape(4, 12)), coupling=jnp.asarray(rhs[48:]))
    if cond not in _REFINE_FACTORS:  # the refinement arguments leave the numeric alone
        _REFINE_FACTORS[cond] = jax.jit(jsol.numeric)(kkt)
    jx, j_status, j_passes = _jax_passes(jsol, _REFINE_FACTORS[cond], jrhs)
    tf = tsol.numeric(block_kkt_from_numpy(_np(kkt), "cpu"))
    tx, t_status = tsol.solve_with_status(tf, block_rhs_from_numpy(_np(jrhs), "cpu"))
    t_passes = tsol.n_solves - 1
    flat = lambda b: np.concatenate([np.asarray(b.blocks).reshape(-1), np.asarray(b.coupling)])
    d = np.abs(flat(jx) - flat(tx)).max()
    print(f"cond {cond:g} trigger {trigger:g} max {max_passes}: passes JAX {j_passes} port "
          f"{t_passes}, status JAX {j_status} port {int(t_status)}, max|dx| {d:.3e}")
    assert (tsol.refine_trigger, tsol.refine_max_passes) == (trigger, max_passes)
    assert t_passes == j_passes and int(t_status) == j_status
    assert 0 < t_passes <= max_passes
    if j_status == 0:
        assert d <= 1e-5 * np.abs(x_true).max()
    else:
        assert t_passes == max_passes


def _planted_pivot_system(tiny=1e-12):
    """make_system with block 0's first two rows and columns replaced by
    the decoupled pair [[1, 1], [1, 1 + tiny]], outside the border: its
    second pivot is ~tiny (equilibration leaves it so: both rows already
    have unit maximum) and the Schur complement does not see it."""
    diag, border, q = make_system(4, 12, 5, seed=6)
    diag[0, :2, :] = 0.0
    diag[0, :, :2] = 0.0
    diag[0, :2, :2] = [[1.0, 1.0], [1.0, 1.0 + tiny]]
    border[0, :, :2] = 0.0
    return diag, border, q


def test_zero_tol_counts_a_planted_pivot_as_reference():
    """``zero_tol=1e-10`` on a KKT whose block 0 has a pivot of ~1e-12 (the
    W form, whose equilibration leaves that pivot as it is):
    inertia and status exactly the JAX solver's (one zero pivot, status
    singular); at the default 0.0 the pivot counts as positive.  The
    default coupling solver carries the same ``zero_tol``."""
    diag, border, q = _planted_pivot_system()
    kkt = JBlockKKT.make(jnp.asarray(diag), jnp.asarray(border), jnp.asarray(q))
    tkkt = block_kkt_from_numpy(_np(kkt), "cpu")
    jsol, tsol = _solvers("W", block_size=8, zero_tol=1e-10)
    assert tsol.zero_tol == tsol.sc_solver.zero_tol == jsol.sc_solver.zero_tol == 1e-10
    jf = jsol.numeric(kkt)
    tf = tsol.numeric(tkkt)
    assert (_inertia(tsol, tf), int(tsol.status(tf))) == (_inertia(jsol, jf), int(jsol.status(jf)))
    assert _inertia(tsol, tf)[2] == 1 and int(tsol.status(tf)) == int(ptt.LinearSolverStatus.singular)
    # the default counts the same pivot as positive
    default = _solvers("W", block_size=8)[1]
    f0 = default.numeric(tkkt)
    assert _inertia(default, f0)[2] == 0 and int(default.status(f0)) == 0
    assert _inertia(default, f0)[0] == _inertia(tsol, tf)[0] + 1
