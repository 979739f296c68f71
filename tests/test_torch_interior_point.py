"""The port's Python-loop driver ``ip_solve`` with the single-NLP interface
(``NLPModel`` + ``InteriorPointInterface``) vs the JAX package, on the cases
of tests/test_interior_point.py and the golden values of
tests/test_examples.py (interior_point and dynamics examples).

Each case runs through both packages from the same inputs on the CPU.
Criteria: the same status; the port's solution within the golden
tolerances the JAX package's tests use (1e-7 on x and the duals of ip1,
1e-6 elsewhere); the two packages' solutions within 1e-8 of each other
(both solve the same float64 systems to tol 1e-8; the drivers differ only
in summation order); the same count of convergence checks (iterations + 1,
read from the ``HierarchicalTimer`` both drivers take).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.utils.timer import HierarchicalTimer as JTimer
from parapint_tpu_torch.utils.timer import HierarchicalTimer

torch.set_num_threads(1)

DEV = "cpu"

# reference golden p(t) values (tests/test_examples.py:10-21)
DYNAMICS_GOLDEN_P = {
    0: 1.6046242850486279,
    1: 2.0,
    2: 1.4792062911745605,
    3: 0.5082444341496647,
    4: -0.009859487375413882,
    5: 0.40043954978583834,
    6: 1.3619861771562247,
    7: 1.99059057528143,
    8: 1.7102013685364827,
}


def _checks(timer) -> int:
    return timer._root.children["IP solve"].children["convergence check"].count


def _solve_both(build, solver="ldl", check_iters=True):
    """build(pkg, xp) -> NLPModel for the given package and array module
    (jnp for JAX, a torch adapter for the port).  Returns the two
    interfaces after ip_solve."""
    out = []
    for pkg, timer, kw in ((pt, JTimer(), {}), (ptt, HierarchicalTimer(), {"device": DEV})):
        model = build(pkg, kw)
        iface = pkg.InteriorPointInterface(model)
        opts = pkg.IPOptions()
        if solver == "ldl":
            opts.linalg.solver = pkg.DenseLDLSolver(block_size=8)
        else:
            opts.linalg.solver = pkg.DenseLUSolver(compute_inertia=True)
        status = pkg.ip_solve(iface, opts, timer=timer)
        assert status == pkg.InteriorPointStatus.optimal
        out.append((iface, _checks(timer)))
    (j, jn), (t, tn) = out
    print(f"convergence checks: JAX {jn}, port {tn}")
    if check_iters:
        assert jn == tn
    np.testing.assert_allclose(t.get_primals().numpy(), np.asarray(j.get_primals()), rtol=0, atol=1e-8)
    return j, t


def _stack(pkg):
    return jnp.array if pkg is pt else torch.stack


def _exp(pkg):
    return jnp.exp if pkg is pt else torch.exp


def test_ip1():
    """Reference golden (test_interior_point.py:21-42): x*=(0,1),
    duals_eq=-4/3, duals_ineq=2/3."""

    def build(pkg, kw):
        vec, exp = _stack(pkg), _exp(pkg)
        return pkg.NLPModel(
            objective=lambda v: v[0] ** 2 + v[1] ** 2,
            eq_constraints=lambda v: vec([v[1] - exp(v[0])]),
            ineq_constraints=lambda v: vec([(v[0] - 1.0) ** 2 - v[1]]),
            gu=[0.0],
            x0=[0.0, 0.0],
            **kw,
        )

    j, t = _solve_both(build)
    x = t.get_primals().numpy()
    assert np.isclose(x[0], 0.0, atol=1e-7) and np.isclose(x[1], 1.0, atol=1e-7)
    assert np.isclose(float(t.get_duals_eq()[0]), -1 - 1.0 / 3.0, atol=1e-7)
    assert np.isclose(float(t.get_duals_ineq()[0]), 2.0 / 3.0, atol=1e-7)
    assert abs(float(t.get_duals_eq()[0]) - float(j.get_duals_eq()[0])) <= 1e-8


def test_ip2_bounds_only():
    """min x^2, 1 <= x <= 4 -> x* = 1 (reference test_interior_point.py:44-54)."""

    def build(pkg, kw):
        return pkg.NLPModel(objective=lambda v: v[0] ** 2, x0=[2.0], xl=[1.0], xu=[4.0], **kw)

    _, t = _solve_both(build)
    assert np.isclose(float(t.get_primals()[0]), 1.0, atol=1e-6)


def test_unconstrained():
    def build(pkg, kw):
        return pkg.NLPModel(
            objective=lambda v: (v[0] - 3.0) ** 2 + (v[1] + 2.0) ** 2, x0=[0.0, 0.0], **kw
        )

    _, t = _solve_both(build)
    assert np.allclose(t.get_primals().numpy(), [3.0, -2.0], atol=1e-7)


def test_lu_solver():
    def build(pkg, kw):
        vec, exp = _stack(pkg), _exp(pkg)
        return pkg.NLPModel(
            objective=lambda v: v[0] ** 2 + v[1] ** 2,
            eq_constraints=lambda v: vec([v[1] - exp(v[0])]),
            x0=[0.0, 0.0],
            **kw,
        )

    _solve_both(build, solver="lu")


def _bilinear(pkg, kw):
    """Reference test_reg.py:17-68: the KKT is singular at the all-zero
    start; vars v = (x1, x2, x3, f3, F)."""
    vec = _stack(pkg)
    return pkg.NLPModel(
        objective=lambda v: v[4] ** 2,
        eq_constraints=lambda v: vec(
            [v[0] + v[1] + v[2] - 1.0, v[4] * v[0] - 1.0, v[4] * v[1] - 2.0, v[4] * v[2] - v[3]]
        ),
        x0=[0.0] * 5,
        **kw,
    )


def test_regularization():
    """numeric_factorization regularizes the singular start to the same
    coefficient and the target inertia in both packages."""
    from parapint_tpu.algorithms.interior_point import numeric_factorization as j_nf
    from parapint_tpu_torch.algorithms.interior_point import numeric_factorization as t_nf

    coefs = []
    for pkg, nf, kw in ((pt, j_nf, {}), (ptt, t_nf, {"device": DEV})):
        iface = pkg.InteriorPointInterface(_bilinear(pkg, kw))
        options = pkg.IPOptions()
        options.linalg.solver = pkg.DenseLDLSolver(block_size=8)
        data = iface.eval_kkt_data(iface.init_state(), 1e-1)
        options.linalg.solver.symbolic(iface.assemble_kkt(data, 0.0, 0.0))
        fact, reg_coef = nf(
            interface=iface, data=data, options=options,
            inertia_coef=options.inertia_correction.init_coef,
        )
        pos, neg, zero = options.linalg.solver.inertia(fact)
        assert int(zero) == 0 and int(neg) == iface.n_eq_constraints() + iface.n_ineq_constraints()
        coefs.append(reg_coef)
    assert coefs[1] >= 1e-8
    assert coefs[0] == coefs[1]


def test_reg_solve_to_optimality():
    """Reference test_reg.py make_model_2: nonconvex, the Hessian needs
    regularization; x* = 1, y* = exp(-1)."""

    def build(pkg, kw):
        vec, exp = _stack(pkg), _exp(pkg)
        return pkg.NLPModel(
            objective=lambda v: -v[0] ** 2 - v[1] ** 2,
            ineq_constraints=lambda v: vec([v[1] - exp(-v[0])]),
            gu=[0.0],
            x0=[0.1, 0.1],
            xl=[0.0, 0.0],
            xu=[1.0, 1.0],
            **kw,
        )

    _, t = _solve_both(build)
    v = t.get_primals().numpy()
    assert np.isclose(v[0], 1.0, atol=1e-6) and np.isclose(v[1], np.exp(-1.0), atol=1e-6)


def test_first_kkt_matches_reference():
    """The bilinear model's first KKT matrix and rhs, entry for entry
    (1e-12 relative: the same float64 AD, other summation order)."""
    j = pt.InteriorPointInterface(_bilinear(pt, {}))
    t = ptt.InteriorPointInterface(_bilinear(ptt, {"device": DEV}))
    jd = j.eval_kkt_data(j.init_state(), 0.1)
    td = t.eval_kkt_data(t.init_state(), 0.1)
    for w, c in ((0.0, 0.0), (1e-4, 1e-8)):
        K_j = np.asarray(j.assemble_kkt(jd, w, c))
        np.testing.assert_allclose(t.assemble_kkt(td, w, c).numpy(), K_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(td.rhs.numpy(), np.asarray(jd.rhs), rtol=1e-12, atol=1e-12)


def test_checkpoint_resume_reaches_the_same_solution(tmp_path):
    """A solve cut at max_iter with a checkpoint, resumed from it, ends
    where an uninterrupted solve ends."""

    def model():
        return ptt.NLPModel(
            objective=lambda v: -v[0] ** 2 - v[1] ** 2,
            ineq_constraints=lambda v: torch.stack([v[1] - torch.exp(-v[0])]),
            gu=[0.0], x0=[0.1, 0.1], xl=[0.0, 0.0], xu=[1.0, 1.0], device=DEV,
        )

    def opts(max_iter=1000):
        o = ptt.IPOptions()
        o.max_iter = max_iter
        o.linalg.solver = ptt.DenseLDLSolver(block_size=8)
        return o

    full = ptt.InteriorPointInterface(model())
    assert ptt.ip_solve(full, opts()) == ptt.InteriorPointStatus.optimal
    path = str(tmp_path / "ckpt.npz")
    cut = ptt.InteriorPointInterface(model())
    status = ptt.ip_solve(cut, opts(max_iter=6), checkpoint_path=path, checkpoint_interval=5)
    assert status == ptt.InteriorPointStatus.error
    resumed = ptt.InteriorPointInterface(model())
    assert ptt.ip_solve(resumed, opts(), resume_from=path) == ptt.InteriorPointStatus.optimal
    np.testing.assert_allclose(resumed.get_primals().numpy(), full.get_primals().numpy(), atol=1e-10)


def test_report_timing_and_unified_step(capsys):
    """The restored options: report_timing prints the timer's phases;
    unified_step takes one step length for primals and duals."""
    o = ptt.IPOptions()
    o.report_timing = True
    o.unified_step = True
    o.linalg.solver = ptt.DenseLDLSolver(block_size=8)
    iface = ptt.InteriorPointInterface(
        ptt.NLPModel(objective=lambda v: v[0] ** 2, x0=[2.0], xl=[1.0], xu=[4.0], device=DEV)
    )
    assert ptt.ip_solve(iface, o) == ptt.InteriorPointStatus.optimal
    assert np.isclose(float(iface.get_primals()[0]), 1.0, atol=1e-6)
    out = capsys.readouterr().out
    assert "HierarchicalTimer" in out and "back solve" in out
    o.linalg.reallocation_factor = 0.0
    with pytest.raises(ValueError):
        o.validate()
    o.linalg.reallocation_factor = 2.0
    o.linalg.max_num_reallocations = 0  # one factorization attempt at least
    with pytest.raises(ValueError, match="max_num_reallocations"):
        o.validate()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptt.NLPModel(objective=lambda v: (v**2).sum(), x0=[1.0])


# -- the shipped examples' golden values (tests/test_examples.py) -------------


def test_interior_point_example():
    from parapint_tpu_torch.examples import interior_point

    x = interior_point.main(device=DEV).get_primals().numpy()
    assert np.isclose(x[0], 0.0, atol=1e-7) and np.isclose(x[1], 1.0, atol=1e-7)


def _jax_fused(iface, solver):
    """The JAX package's fused solve of ``iface``: the reference of the
    examples' ``main`` (``ip_solve``), whose iterate it reaches to the last
    bit on these problems (tests/test_fused.py holds the two JAX drivers
    together)."""
    opts = pt.IPOptions()
    opts.linalg.solver = solver
    status, _ = pt.ip_solve_fused(iface, opts)
    assert status == pt.InteriorPointStatus.optimal
    return iface


def test_dynamics_example_golden():
    """Reference golden p(t) (test_examples.py:10-21) within 1e-6, and the
    JAX package's p(t) within 1e-8 (examples/dynamics.main's problem and
    solver through the JAX fused driver)."""
    from parapint_tpu.examples import dynamics as jdyn
    from parapint_tpu_torch.examples import dynamics

    _, x, p = dynamics.main(device=DEV)
    for k, v in DYNAMICS_GOLDEN_P.items():
        assert np.isclose(p[k], v, atol=1e-6), (k, p[k], v)
    n, nb = 90, 3
    j = _jax_fused(pt.DynamicSchurComplementInteriorPointInterface(
        jdyn.build_spec(num_finite_elements=n, num_time_blocks=nb, constant_control_duration=10)
    ), pt.SchurComplementSolver(block_size=32))
    xs, nfe = np.asarray(j.get_state().primals["blocks"]), n // nb
    xj = np.concatenate([xs[0, : nfe + 1]] + [xs[i, 1 : nfe + 1] for i in range(1, nb)])
    np.testing.assert_allclose(p, xs[:, nfe + 1 :].reshape(-1), rtol=0, atol=1e-8)
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-8)


def test_burgers_main_matches_reference():
    """examples/burgers.main through ip_solve at the test size of
    tests/test_examples.py::test_burgers_small: the JAX package's objective
    (its ``main``'s problem and solver through the JAX fused driver;
    relative gap 1e-6) and exact continuity across the blocks."""
    from parapint_tpu.examples import burgers as jburgers
    from parapint_tpu_torch.examples import burgers

    shape = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)
    t = burgers.main(**shape, device=DEV)
    j = _jax_fused(pt.DynamicSchurComplementInteriorPointInterface(jburgers.build_spec(**shape)),
                   pt.SchurComplementSolver(block_size=128))
    t_obj, j_obj = float(t.evaluate_objective()), float(j.evaluate_objective())
    print(f"burgers.main objective JAX {j_obj!r} port {t_obj!r}")
    assert abs(t_obj - j_obj) <= 1e-6 * max(1.0, abs(j_obj))
    xs = t.get_state().primals["blocks"].numpy()
    npts, nt = 9, 2
    for i in range(3):
        np.testing.assert_allclose(xs[i, nt * npts + 1 : nt * npts + 8], xs[i + 1, 1:8], atol=1e-10)


def test_timer_and_state_accessor_match_reference():
    """``numeric_factorization(..., timer=)`` and
    ``try_factorization_and_reallocation(..., timer=)`` on the bilinear
    model's singular start: the same coefficient, status and retry count in
    both packages, and each package's timer left as the JAX package leaves
    its own (these functions time no phase; ``ip_solve`` times the whole
    call as "numeric").  ``interface_state_or``: the initial iterate before
    a solve, the interface's current one after."""
    from parapint_tpu.algorithms import interior_point as jip
    from parapint_tpu_torch.algorithms import interior_point as tip

    out = []
    for pkg, ip, timer_cls, kw in ((pt, jip, JTimer, {}), (ptt, tip, HierarchicalTimer, {"device": DEV})):
        iface = pkg.InteriorPointInterface(_bilinear(pkg, kw))
        options = pkg.IPOptions()
        options.linalg.solver = pkg.DenseLDLSolver(block_size=8)
        state = ip.interface_state_or(iface)
        init = iface.init_state()
        assert all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(state.primals, init.primals))
        data = iface.eval_kkt_data(state, 1e-1)
        timer = timer_cls()
        _, status, count = ip.try_factorization_and_reallocation(
            iface.assemble_kkt(data, 0.0, 0.0), options.linalg.solver,
            options.linalg.reallocation_factor, options.linalg.max_num_reallocations, timer=timer,
        )
        _, reg_coef = ip.numeric_factorization(
            interface=iface, data=data, options=options,
            inertia_coef=options.inertia_correction.init_coef, timer=timer,
        )
        iface._current_state = iface.apply_step(state, state, 0.5, 0.5)
        assert ip.interface_state_or(iface) is iface._current_state
        out.append((status.name, count, reg_coef, sorted(timer._root.children)))
    assert out[0] == out[1] and out[1][0] == "singular"
