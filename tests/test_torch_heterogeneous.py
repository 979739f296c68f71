"""HeterogeneousDynamicInterface of the port
(parapint_tpu_torch/interfaces/heterogeneous.py) vs the JAX package's on
the problems of tests/test_heterogeneous.py, and the two-kind Burgers at the
``entry()`` shape vs the port's uniform interface.

- The two-kind sin-tracking problem (block 0 has the initial condition as
  one more equality row) and the ragged three-kind problem (the last block
  has one more variable): through ``ip_solve`` and ``ip_solve_fused``, the
  same status, objective within 1e-6 relative of the JAX package's,
  iteration counts within 1 (both printed), and the final primals within
  1e-6 of the JAX package's.
- The two-kind Burgers (nfe_x=8, nfe_t=8, 4 blocks, float32 KKT, the dense
  flagship's solver): the uniform masked interface solves the same NLP, so
  status, objective (1e-6 relative) and iterations (within 1) agree.

Each JAX reference runs once per module (module-scoped fixtures): one JAX
fused solve per problem serves both port drivers.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.interfaces.heterogeneous import HeterogeneousDynamicInterface as JHet
from parapint_tpu.interfaces.heterogeneous import KindSpec as JKind
from parapint_tpu.utils.timer import HierarchicalTimer as JTimer
from parapint_tpu_torch.convert import kind_params_from_numpy
from parapint_tpu_torch.examples import burgers
from parapint_tpu_torch.utils.timer import HierarchicalTimer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

T = 4
DT = 0.1
N_X = 2 * T + 1
OBJ_RTOL = 1e-6
X_ATOL = 1e-6


def _objective(xp):
    def objective(x, p):
        s, u = x[: T + 1], x[T + 1 :]
        t_local = p["t0"] + DT * xp.arange(T, dtype=xp.float64)
        return DT * ((s[:T] - xp.sin(t_local)) ** 2 + 0.1 * u**2).sum()

    return objective


def _eq_interior(x, p):
    s, u = x[: T + 1], x[T + 1 :]
    return s[1:] - s[:T] - DT * (u - s[:T])


def _kinds(pkg, xp, cat, ragged):
    """The kinds of tests/test_heterogeneous.py in package ``pkg`` with
    array module ``xp``: kind 0 with the initial condition, kind 1 without,
    and (ragged) kind 2 with one more regularized variable."""
    objective = _objective(xp)

    def eq_first(x, p):
        return cat([_eq_interior(x, p), (x[:1] - 0.5)])

    def obj_extra(x, p):
        return objective(x[:N_X], p) + 0.5 * x[N_X] ** 2

    def eq_extra(x, p):
        return _eq_interior(x[:N_X], p)

    ex = {"t0": np.float64(0.0)}
    kw = dict(start_state_idx=[0], end_state_idx=[T], example_params=ex)
    kinds = [
        pkg(objective=objective, n_x=N_X, eq_constraints=eq_first, **kw),
        pkg(objective=objective, n_x=N_X, eq_constraints=_eq_interior, **kw),
    ]
    if ragged:
        kinds.append(pkg(objective=obj_extra, n_x=N_X + 1, eq_constraints=eq_extra, **kw))
    return kinds


def _problem(ragged):
    n_blocks = 3
    kind_of_block = [0, 1, 2] if ragged else [0, 1, 1]
    params = [{"t0": np.float64(DT * T * b)} for b in range(n_blocks)]
    x0 = [np.zeros(N_X), np.zeros(N_X), np.zeros(N_X + 1 if ragged else N_X)]
    return kind_of_block, params, x0


def _jax_iface(ragged):
    kob, params, x0 = _problem(ragged)
    jparams = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    return JHet(_kinds(JKind, jnp, jnp.concatenate, ragged), kob, jparams, x0)


def _port_iface(ragged):
    kob, params, x0 = _problem(ragged)
    return ptt.HeterogeneousDynamicInterface(
        _kinds(ptt.KindSpec, torch, torch.cat, ragged), kob,
        kind_params_from_numpy(params, "cpu"), x0, device="cpu",
    )


def _run(pkg, iface, driver, timer_cls):
    """(status name, iterations, objective, final primals)."""
    opts = pkg.IPOptions()
    opts.linalg.solver = pkg.SchurComplementSolver(block_size=8)
    if driver == "fused":
        status, res = pkg.ip_solve_fused(iface, opts)
        n_iter = int(res.iterations)
    else:
        timer = timer_cls()
        status = pkg.ip_solve(iface, opts, timer=timer)
        n_iter = timer._root.children["IP solve"].children["convergence check"].count
    x = np.asarray(iface.get_state().primals["blocks"])
    return status.name, n_iter, float(iface.evaluate_objective()), x


CASES = [(ragged, driver) for ragged in (False, True) for driver in ("ip_solve", "fused")]


@pytest.fixture(scope="module")
def jax_results():
    """One JAX fused solve per problem, the reference of both port drivers
    (the JAX package holds its fused driver to its Python-loop driver in
    tests/test_fused.py)."""
    return {ragged: _run(pt, _jax_iface(ragged), "fused", JTimer) for ragged in (False, True)}


@pytest.mark.parametrize("ragged,driver", CASES, ids=[f"{'ragged' if r else 'two_kind'}-{d}"
                                                      for r, d in CASES])
def test_matches_reference(jax_results, ragged, driver):
    j_status, j_iter, j_obj, j_x = jax_results[ragged]
    iface = _port_iface(ragged)
    t_status, t_iter, t_obj, t_x = _run(ptt, iface, driver, HierarchicalTimer)
    print(f"{driver}: iterations JAX {j_iter} port {t_iter}; objective JAX {j_obj!r} port {t_obj!r}")
    assert j_status == t_status == "optimal"
    assert abs(t_obj - j_obj) / max(1.0, abs(j_obj)) <= OBJ_RTOL
    assert abs(t_iter - j_iter) <= 1
    np.testing.assert_allclose(t_x, j_x, atol=X_ATOL)
    if ragged:
        # the extra variable is pulled to 0; continuity holds across blocks
        c = iface.get_coupling_values().numpy()
        assert abs(t_x[2, N_X]) < 1e-6
        assert np.isclose(t_x[0, T], c[0], atol=1e-7) and np.isclose(t_x[1, 0], c[0], atol=1e-7)


def test_kinds_are_padded_and_masked():
    """Kind 1 lacks the initial-condition row: its eq rows are padded at the
    end and masked out; the link rows select each kind's state indices."""
    iface = _port_iface(ragged=True)
    assert (iface.n, iface.me, iface.mi, iface.ns, iface.ncv) == (N_X + 1, T + 1, 0, 1, 2)
    assert iface.eq_mask.sum(1).tolist() == [T + 1, T, T]
    assert iface.x_mask.sum(1).tolist() == [N_X, N_X, N_X + 1]
    assert iface.link_rows[1, 0, 0] == 1.0 and iface.link_rows[1, 1, T] == 1.0
    assert iface.link_rows[0, 0].abs().sum() == 0.0  # block 0 has no backward link
    with pytest.raises(ValueError, match="dense"):
        ptt.HeterogeneousDynamicInterface(
            _kinds(ptt.KindSpec, torch, torch.cat, False), [0, 1],
            kind_params_from_numpy(_problem(False)[1][:2], "cpu"), _problem(False)[2][:2],
            block_form="banded", device="cpu",
        )


BURGERS = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)


@pytest.mark.parametrize("driver", ["fused", "ip_solve"])
def test_two_kind_burgers_matches_uniform(driver):
    """The Burgers family as two kinds (block 0 with the initial-condition
    rows, blocks 1-3 without) against the uniform masked interface."""
    spec = burgers.build_spec(**BURGERS, device="cpu")
    results = []
    for iface in (
        ptt.DynamicSchurComplementInteriorPointInterface(spec, kkt_dtype=torch.float32),
        chip_smoke.burgers_two_kinds(spec, kkt_dtype=torch.float32),
    ):
        opts = ptt.IPOptions()
        opts.tol = 1e-8
        opts.linalg.solver = chip_smoke._dense_solver("cr")
        if driver == "fused":
            status, res = ptt.ip_solve_fused(iface, opts)
            n_iter = res.iterations
        else:
            timer = HierarchicalTimer()
            status = ptt.ip_solve(iface, opts, timer=timer)
            n_iter = timer._root.children["IP solve"].children["convergence check"].count
        results.append((status, n_iter, float(iface.evaluate_objective())))
    (u_status, u_iter, u_obj), (h_status, h_iter, h_obj) = results
    print(f"{driver}: iterations uniform {u_iter} two kinds {h_iter}; "
          f"objective uniform {u_obj!r} two kinds {h_obj!r}")
    assert u_status == h_status == ptt.InteriorPointStatus.optimal
    assert abs(h_obj - u_obj) / max(1.0, abs(u_obj)) <= OBJ_RTOL
    assert abs(h_iter - u_iter) <= 1
