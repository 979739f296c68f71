"""The port's reference-name layer (``parapint_tpu_torch.compat``) on the
five cases of ``tests/test_compat.py``, the reference-style call site held
to the JAX package's ``compat`` run (status and objective within 1e-8)."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt

torch.set_num_threads(1)


def _call_site(pkg, compat, exp, stack):
    model = pkg.NLPModel(
        objective=lambda v: v[0] ** 2 + v[1] ** 2,
        eq_constraints=lambda v: stack([v[1] - exp(v[0])]),
        x0=np.array([0.5, 0.5]),
        **({"device": "cpu"} if pkg is ptt else {}),
    )
    interface = compat.interfaces.InteriorPointInterface(model)
    options = compat.algorithms.IPOptions()
    options.linalg.solver = compat.linalg.ScipyInterface(compute_inertia=True)
    status = compat.algorithms.ip_solve(interface=interface, options=options)
    x = np.asarray(interface.get_primals())
    return status, float(x[0] ** 2 + x[1] ** 2)


def test_reference_style_call_sites():
    import parapint_tpu.compat as jparapint
    import parapint_tpu_torch.compat as parapint

    status, obj = _call_site(ptt, parapint, torch.exp, torch.stack)
    j_status, j_obj = _call_site(pt, jparapint, jnp.exp, jnp.stack)
    print(f"compat call site: objective {obj!r} (JAX {j_obj!r})")
    assert status == parapint.algorithms.InteriorPointStatus.optimal
    assert j_status.value == status.value
    assert abs(obj - j_obj) <= 1e-8


def test_ma27_alias_maps_pivot_threshold():
    import parapint_tpu_torch.compat as parapint

    # cntl(1) (pivot threshold) is a mapped knob: accepted without warning,
    # recorded, keeps a refinement pass enabled
    solver = parapint.linalg.InteriorPointMA27Interface(cntl_options={1: 1e-6})
    assert solver.get_cntl(1) == 1e-6
    assert solver.refine_steps >= 1
    fact = solver.numeric(torch.as_tensor(np.diag([2.0, -1.0, 3.0])))
    assert tuple(int(v) for v in solver.inertia(fact)) == (2, 1, 0)
    with pytest.warns(UserWarning, match="ignored"):
        parapint.linalg.InteriorPointMA27Interface(cntl_options={7: 3})


def test_mumps_alias_option_mapping():
    import parapint_tpu_torch.compat as parapint

    solver = parapint.linalg.MumpsInterface(icntl_options={10: 3, 13: 1, 24: 0},
                                            cntl_options={3: 1e-10})
    assert solver.refine_steps == 3
    assert solver.zero_tol == 1e-10
    assert solver.get_icntl(10) == 3
    with pytest.raises(ValueError, match="ICNTL\\(13\\)"):
        parapint.linalg.MumpsInterface(icntl_options={13: 0})
    with pytest.raises(ValueError, match="ICNTL\\(24\\)"):
        parapint.linalg.MumpsInterface(icntl_options={24: 1})


def test_mumps_alias_per_solve_logging(caplog):
    import parapint_tpu_torch.compat as parapint

    solver = parapint.linalg.MumpsInterface(icntl_options={11: 1}, explicit_inverse=True)
    assert solver.log_error
    with caplog.at_level(logging.INFO, logger=solver.logger.name):
        fact = solver.numeric(torch.as_tensor(np.diag([2.0, -1.0, 3.0])))
        x = solver.solve(fact, torch.ones(3, dtype=torch.float64))
    # one diagnostics row per solve: Status, n_null, n_neg, norms, residual
    rows = [r.message for r in caplog.records]
    assert any("0" in r and "e" in r.lower() for r in rows), rows
    assert np.allclose(x.numpy(), [0.5, -1.0, 1.0 / 3.0])


def test_sc_solver_alias_signature():
    """The dynamic problem of tests/test_dynamic.py (3 blocks) through the
    MPI interface alias and SchurComplementLinearSolver."""
    import parapint_tpu_torch.compat as parapint

    T, DT = 4, 0.1

    def block_objective(x, p):
        s, u = x[: T + 1], x[T + 1:]
        t_local = p["t0"] + DT * torch.arange(T, dtype=x.dtype)
        return DT * torch.sum((s[:T] - torch.sin(t_local)) ** 2 + 0.1 * u**2)

    def block_eq(x, p):
        s, u = x[: T + 1], x[T + 1:]
        return torch.cat([s[1:] - s[:T] - DT * (u - s[:T]), (s[0] - 0.5)[None]])

    n_blocks = 3
    eq_mask = np.ones((n_blocks, T + 1), dtype=bool)
    eq_mask[1:, T] = False
    spec = ptt.DynamicModelSpec(
        num_blocks=n_blocks, objective=block_objective, eq_constraints=block_eq,
        params={"t0": torch.as_tensor(DT * T * np.arange(n_blocks))},
        x0=np.zeros((n_blocks, 2 * T + 1)), eq_mask=eq_mask, start_state_idx=[0],
        end_state_idx=[T], device="cpu",
    )
    interface = parapint.interfaces.MPIDynamicSchurComplementInteriorPointInterface(spec)
    solver = parapint.linalg.SchurComplementLinearSolver(
        subproblem_solvers={i: None for i in range(n_blocks)}, schur_complement_solver=None,
        block_size=8,
    )
    options = parapint.algorithms.IPOptions()
    options.linalg.solver = solver
    status = parapint.algorithms.ip_solve(interface=interface, options=options)
    assert status == parapint.algorithms.InteriorPointStatus.optimal
    with pytest.raises(ValueError, match="mesh="):
        parapint.linalg.MPISchurComplementLinearSolver()
