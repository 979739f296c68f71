"""PCGSchurComplementSolver of the port (parapint_tpu_torch/linalg/pcg_schur.py)
vs the JAX package's and vs the port's explicit SchurComplementSolver, at
the ``entry()`` shape (Burgers nfe_x=8, nfe_t=8, 4 blocks).

Tolerances:
- the first KKT (initial state, barrier 0.1) in float64: the port's PCG
  within 1e-10 x max|x| of the JAX PCG, within 1e-8 x max|x| of the
  explicit solver with cyclic-reduction coupling (tests/test_pcg_schur.py's
  1e-8); with float32 factors (the bench row's ``factor_dtype``) CG
  converges on the float32-applied operator, so both bounds are 1e-5 x
  max|x|.  Block inertia equal, and the SC counted as (nc, 0, 0).  The CG
  iterations of both packages are printed (the JAX package's counted by
  its own loop body on the host, ``jax_cg_iterations``), not held: the two
  sum in different orders.
- ``ip_solve`` and ``ip_solve_fused`` with bench_all's
  ``burgers_pcg_coupling_8blocks`` solver (float32 KKT and factor): the
  JAX package's status, objective within 1e-6 relative, iterations within
  1 (both printed).
- failure paths (tests/test_round2_fixes.py): negative curvature reads
  ``singular`` and ``solve`` NaN-poisons; a starved CG (the JAX test's
  ``cg_maxiter`` and ``cg_tol``, passed to both solvers) reads ``error``,
  the JAX package's statuses agreeing; with no CG iteration at all
  (``cg_maxiter=0``) ``ip_solve`` raises and the fused driver returns
  status error with the incoming state.
- the CG arguments at other values (``cg_tol`` 1e-14, ``cg_maxiter`` 0, 1
  and 200, ``zero_tol``, ``refine_steps``): statuses and CG iterations
  equal to the JAX solver's on the same system (its iterations counted by
  ``jax_cg_iterations``), the arguments stored as the JAX solver stores
  them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.examples import burgers as jburgers
from parapint_tpu.linalg.schur import BlockRhs as JBlockRhs
from parapint_tpu.linalg.schur import LocalBlockKKT as JLocalBlockKKT
from parapint_tpu.linalg.schur import _border_apply_local, _winv_apply_batched
from parapint_tpu_torch.convert import block_kkt_from_numpy, block_rhs_from_numpy
from parapint_tpu_torch.examples import burgers
from parapint_tpu_torch.linalg.schur import BlockRhs
from parapint_tpu_torch.utils.timer import HierarchicalTimer

torch.set_num_threads(1)

SHAPE = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)
DTYPES = {"f64": (None, None, 1e-10, 1e-8), "f32": (jnp.float32, torch.float32, 1e-5, 1e-5)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inertia(solver, fact):
    return tuple(int(v) for v in solver.inertia(fact))


def jax_cg_iterations(solver, fact, rhs):
    """The CG iterations of the JAX PCG's back solve of ``rhs``: its
    ``while_loop`` body and stopping rule (parapint_tpu/linalg/pcg_schur.py)
    run as a host loop that counts."""
    v = _winv_apply_batched(fact.block_W, fact.block_d, fact.block_s, rhs.blocks)
    b = rhs.coupling - _border_apply_local(
        fact.border_loc, fact.row_idx, v.astype(rhs.blocks.dtype), fact.nc
    )
    M = fact.precond.astype(b.dtype)
    thresh = solver.cg_tol * (1.0 + jnp.linalg.norm(b))
    r, p = b, M * b
    rz, it, neg = jnp.dot(b, p), 0, False
    while it < solver.cg_maxiter and bool(jnp.linalg.norm(r) > thresh) and not neg:
        Sp = solver._sc_matvec(fact, p)
        pSp = jnp.dot(p, Sp)
        neg = bool(pSp <= 0.0)
        alpha = rz / jnp.where(pSp != 0.0, pSp, 1.0)
        r = r - alpha * Sp
        z = M * r
        rz_new = jnp.dot(r, z)
        p = z + rz_new / jnp.where(rz != 0.0, rz, 1.0) * p
        rz, it = rz_new, it + 1
    return it


@pytest.fixture(scope="module")
def first_kkt():
    """Per dtype: the JAX first KKT and rhs as numpy, and the JAX PCG's
    solution, status, inertia and CG iterations on them."""
    out = {}
    for key, (jdt, _, _, _) in DTYPES.items():
        iface = pt.DynamicSchurComplementInteriorPointInterface(
            jburgers.build_spec(**SHAPE), kkt_dtype=jdt
        )
        state = iface.init_state()
        data = iface.eval_kkt_data(state, 0.1)
        kkt, rhs = iface.assemble_kkt(data, 0.0, 0.0), iface.kkt_rhs(data)
        solver = pt.PCGSchurComplementSolver(block_size=128, factor_dtype=jdt)
        fact = solver.numeric(kkt)
        x, status = solver.solve_with_status(fact, rhs)
        out[key] = (_np(kkt), _np(rhs), _np(x), int(status), _inertia(solver, fact),
                    jax_cg_iterations(solver, fact, rhs))
    return out


@pytest.mark.parametrize("key", list(DTYPES))
def test_first_kkt_matches_reference(first_kkt, key):
    kkt, rhs, jx, j_status, j_inertia, j_cg = first_kkt[key]
    _, tdt, tol_jax, tol_sc = DTYPES[key]
    tkkt, trhs = block_kkt_from_numpy(kkt, "cpu"), block_rhs_from_numpy(rhs, "cpu")
    pcg = ptt.PCGSchurComplementSolver(block_size=128, factor_dtype=tdt)
    fact = pcg.numeric(tkkt)
    x, status = pcg.solve_with_status(fact, trhs)
    sc = ptt.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=tdt,
        schur_complement_solver=ptt.BlockTridiagSolver(),
    )
    sfact = sc.numeric(tkkt)
    sx = sc.solve(sfact, trhs)
    flat = lambda b, c: np.concatenate([np.asarray(b).reshape(-1), np.asarray(c)])
    tx = flat(x.blocks.numpy(), x.coupling.numpy())
    scale = np.abs(tx).max()
    d_jax = np.abs(tx - flat(jx.blocks, jx.coupling)).max()
    d_sc = np.abs(tx - flat(sx.blocks.numpy(), sx.coupling.numpy())).max()
    print(f"{key}: CG iterations port {pcg.cg_iterations} JAX {j_cg}, max|x| {scale:.3e}, "
          f"max|d| to JAX PCG {d_jax:.3e}, to the explicit solver {d_sc:.3e}")
    assert int(status) == j_status == 0
    assert d_jax <= tol_jax * scale and d_sc <= tol_sc * scale
    nc = tkkt.q.shape[0]
    p, n, z = _inertia(sc, sfact)
    assert _inertia(pcg, fact) == j_inertia
    # block inertia equal; the SC reported as (nc, 0, 0)
    assert _inertia(pcg, fact) == (p, n, z) and p >= nc
    assert pcg.n_numeric == 1 and pcg.n_solves == len(pcg.cg_iterations) == 1


def _pcg(pkg, fdt):
    return pkg.PCGSchurComplementSolver(block_size=128, factor_dtype=fdt)


def _run(pkg, iface, solver, driver, timer_cls):
    opts = pkg.IPOptions()
    opts.tol = 1e-8
    opts.linalg.solver = solver
    if driver == "fused":
        status, res = pkg.ip_solve_fused(iface, opts)
        n_iter = int(res.iterations)
    else:
        timer = timer_cls()
        status = pkg.ip_solve(iface, opts, timer=timer)
        n_iter = timer._root.children["IP solve"].children["convergence check"].count
    return status.name, n_iter, float(iface.evaluate_objective())


DRIVERS = ["fused", "ip_solve"]


@pytest.fixture(scope="module")
def jax_solve():
    """One JAX fused solve, the reference of both port drivers (at this
    shape the JAX package's two drivers take the same iterations to the
    same objective; tests/test_fused.py holds them together)."""
    return _run(pt, pt.DynamicSchurComplementInteriorPointInterface(
        jburgers.build_spec(**SHAPE), kkt_dtype=jnp.float32), _pcg(pt, jnp.float32), "fused", None)


@pytest.mark.parametrize("driver", DRIVERS)
def test_solve_matches_reference(jax_solve, driver):
    j_status, j_iter, j_obj = jax_solve
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**SHAPE, device="cpu"), kkt_dtype=torch.float32
    )
    solver = _pcg(ptt, torch.float32)
    t_status, t_iter, t_obj = _run(ptt, iface, solver, driver, HierarchicalTimer)
    print(f"{driver}: iterations JAX {j_iter} port {t_iter}; objective JAX {j_obj!r} port "
          f"{t_obj!r}; CG iterations per back solve {solver.cg_iterations}")
    assert j_status == t_status == "optimal"
    assert abs(t_obj - j_obj) / max(1.0, abs(j_obj)) <= 1e-6
    assert abs(t_iter - j_iter) <= 1
    assert solver.n_solves == len(solver.cg_iterations) > 0


def _local_system(q_scale, N=4, nk=16, L=3, seed=0):
    """tests/test_round2_fixes.py's SPD blocks with a shared coupling block
    q_scale * I, as numpy."""
    rng = np.random.default_rng(seed)
    diag = np.zeros((N, nk, nk))
    for i in range(N):
        A = rng.standard_normal((nk, nk))
        diag[i] = A @ A.T + nk * np.eye(nk)
    border = rng.standard_normal((N, L, nk))
    row_idx = np.tile(np.arange(L, dtype=np.int64), (N, 1))
    return diag, border, row_idx, q_scale * np.eye(L)


def _both(system, jax_cg=False, **kw):
    """(JAX status, port status, port solver, port fact, port rhs) of one
    solve_with_status on the same system and an all-ones rhs; ``kw`` are
    both solvers' arguments.  With ``jax_cg`` the JAX status is followed by
    its CG iterations (``jax_cg_iterations``)."""
    diag, border, row_idx, q = system
    jkkt = JLocalBlockKKT.make(jnp.asarray(diag), jnp.asarray(border), row_idx.astype(np.int32),
                               jnp.asarray(q), assembly="shared")
    ones = lambda *s: np.ones(s)
    jsolver = pt.PCGSchurComplementSolver(block_size=8, **kw)
    jfact = jsolver.numeric(jkkt)
    jrhs = JBlockRhs(blocks=jnp.asarray(ones(*diag.shape[:2])), coupling=jnp.asarray(ones(q.shape[0])))
    _, j_status = jsolver.solve_with_status(jfact, jrhs)
    t = lambda a: torch.as_tensor(a)
    tkkt = ptt.linalg.LocalBlockKKT.make(t(diag), t(border), row_idx, t(q), assembly="shared")
    tsolver = ptt.PCGSchurComplementSolver(block_size=8, **kw)
    fact = tsolver.numeric(tkkt)
    rhs = BlockRhs(blocks=t(ones(*diag.shape[:2])), coupling=t(ones(q.shape[0])))
    _, t_status = tsolver.solve_with_status(fact, rhs)
    j = (int(j_status), jax_cg_iterations(jsolver, jfact, jrhs)) if jax_cg else int(j_status)
    return j, int(t_status), tsolver, fact, rhs


def test_negative_curvature_sets_singular():
    j_status, t_status, solver, fact, rhs = _both(_local_system(q_scale=-5.0))
    assert int(solver.status(fact)) == int(ptt.LinearSolverStatus.successful)
    assert j_status == t_status == int(ptt.LinearSolverStatus.singular)
    bad = solver.solve(fact, rhs)
    assert bool(torch.isnan(bad.blocks).all()) and bool(torch.isnan(bad.coupling).all())


def test_maxiter_starved_sets_error():
    system = _local_system(q_scale=1000.0, N=3, nk=12, L=6, seed=3)
    j_status, t_status, solver, _, _ = _both(system, cg_maxiter=1, cg_tol=1e-14)
    assert j_status == t_status == int(ptt.LinearSolverStatus.error)
    assert solver.cg_iterations == [1]
    j_ok, t_ok, _, _, _ = _both(system, cg_maxiter=200)
    assert j_ok == t_ok == int(ptt.LinearSolverStatus.successful)


@pytest.mark.parametrize("kw", [
    dict(cg_maxiter=0), dict(cg_maxiter=1, cg_tol=1e-14), dict(cg_maxiter=200),
    dict(cg_maxiter=200, cg_tol=1e-14), dict(zero_tol=1e-10, refine_steps=2),
], ids=["maxiter0", "maxiter1_tol1e-14", "maxiter200", "maxiter200_tol1e-14", "zero_tol_refine"])
def test_cg_arguments_match_reference(kw):
    """The starved and the converging system of tests/test_round2_fixes.py
    through both packages' solvers built with the same arguments: statuses
    equal, the port's CG iterations the JAX solver's, the arguments stored
    as the JAX solver stores them (``refine_steps`` None reads 0)."""
    system = _local_system(q_scale=1000.0, N=3, nk=12, L=6, seed=3)
    (j_status, j_cg), t_status, solver, _, _ = _both(system, jax_cg=True, **kw)
    print(f"{kw}: status JAX {j_status} port {t_status}, CG iterations JAX {j_cg} port "
          f"{solver.cg_iterations}")
    assert j_status == t_status
    assert solver.cg_iterations == [j_cg]
    jsolver = pt.PCGSchurComplementSolver(block_size=8, **kw)
    for name in ("zero_tol", "cg_tol", "cg_maxiter", "refine_steps"):
        assert getattr(solver, name) == getattr(jsolver, name), name


@pytest.mark.parametrize("driver", DRIVERS)
def test_failed_cg_stops_the_drivers(driver):
    """No CG iteration allowed (``cg_maxiter=0``): every back solve fails
    with status error.  ``ip_solve`` raises; the fused driver returns status
    error and the incoming state, not a NaN-poisoned one."""
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(nfe_x=4, nfe_t=4, num_time_blocks=2, device="cpu")
    )
    opts = ptt.IPOptions()
    opts.linalg.solver = ptt.PCGSchurComplementSolver(block_size=16, cg_maxiter=0)
    if driver == "ip_solve":
        with pytest.raises(RuntimeError, match="back solve failed"):
            ptt.ip_solve(iface, opts)
        return
    status, result = ptt.ip_solve_fused(iface, opts)
    assert status == ptt.InteriorPointStatus.error
    state0 = iface.init_state()
    for f in ("primals", "duals_eq"):
        for k, v in getattr(state0, f).items():
            assert torch.equal(getattr(result.state, f)[k], v)
