"""The PyTorch port's main path vs the JAX package at the ``entry()`` shape:
Burgers nfe_x=8, nfe_t=8, 4 blocks, banded KKT in float32, cyclic-reduction
coupling solve.

- one interior-point step (the ``__graft_entry__._make_step`` sequence) from
  the same IPState, carried across with ``parapint_tpu_torch.convert``;
- the full fused solve: same status, objective relative gap <= 1e-6 (the
  criterion of ``__graft_entry__.dryrun_multichip``), iteration counts
  within 1 of each other.

Step tolerance: 1e-5 x max(1, max|field|) per IPState field.  Both steps
solve a float32 KKT refined to a relative residual of 1e-5 (the solvers'
refinement trigger), so the two directions agree to refinement accuracy,
not to float64 rounding (observed: 6e-7 relative on the primals).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.examples import burgers as jburgers
from parapint_tpu_torch.convert import (
    ipstate_from_numpy,
    ipstate_to_numpy,
    spec_arrays_from_numpy,
)
from parapint_tpu_torch.examples import burgers
from parapint_tpu_torch.interfaces.base import STATE_FIELDS

torch.set_num_threads(1)

SHAPE = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)
JAX_OBJECTIVE = 0.057210750397300184  # parapint_tpu fused solve, this shape
STEP_RTOL = 1e-5  # the solver's refinement trigger


def _make_step(interface, solver):
    """The ``__graft_entry__._make_step`` sequence."""

    def step(state, mu):
        data = interface.eval_kkt_data(state, mu)
        kkt = interface.assemble_kkt(data, 0.0, 0.0)
        fact = solver.numeric(kkt)
        sol = solver.solve(fact, interface.kkt_rhs(data))
        deltas = interface.extract_deltas(state, sol, mu)
        a_p, a_d = interface.fraction_to_the_boundary(state, deltas, 1.0 - mu)
        return interface.apply_step(state, deltas, a_p, a_d)

    return step


@pytest.fixture(scope="module")
def jax_side():
    spec = jburgers.build_spec(**SHAPE)
    iface = pt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=jnp.float32, block_form="banded"
    )
    solver = pt.BandedSchurComplementSolver(
        schur_complement_solver=pt.BlockTridiagSolver(ns=iface.ns)
    )
    return spec, iface, solver


def _port(spec=None):
    spec = spec or burgers.build_spec(**SHAPE, device="cpu")
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        spec, kkt_dtype=torch.float32, block_form="banded"
    )
    solver = ptt.BandedSchurComplementSolver(
        schur_complement_solver=ptt.BlockTridiagSolver(ns=iface.ns), device="cpu"
    )
    return iface, solver


def _leaves(tree):
    """Flatten a numpy IPState layout into {name: array}."""
    out = {}
    for f in STATE_FIELDS:
        v = tree[f]
        if isinstance(v, dict):
            out.update({f"{f}.{k}": a for k, a in v.items()})
        else:
            out[f] = v
    return out


def _jax_numpy(state):
    return {
        f: jax.tree_util.tree_map(np.asarray, getattr(state, f)) for f in STATE_FIELDS
    }


def test_init_state_and_convert_roundtrip(jax_side):
    _, j_iface, _ = jax_side
    j_state = _jax_numpy(j_iface.init_state())
    t_iface, _ = _port()
    t_state = ipstate_to_numpy(t_iface.init_state())
    jl, tl = _leaves(j_state), _leaves(t_state)
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    back = _leaves(ipstate_to_numpy(ipstate_from_numpy(j_state, "cpu")))
    for k in jl:
        np.testing.assert_array_equal(back[k], jl[k], err_msg=k)


def test_spec_arrays_carry_across(jax_side):
    j_spec, _, _ = jax_side
    arrays = spec_arrays_from_numpy(j_spec, "cpu")
    t_spec = burgers.build_spec(**SHAPE, device="cpu")
    rebuilt = ptt.DynamicModelSpec(
        num_blocks=t_spec.num_blocks,
        objective=t_spec.objective,
        eq_constraints=t_spec.eq_constraints,
        start_state_idx=t_spec.start_state_idx,
        end_state_idx=t_spec.end_state_idx,
        device="cpu",
        **arrays,
    )
    for name in ("x0", "xl", "xu", "gl", "gu", "eq_mask", "ineq_mask", "x_mask"):
        a, b = getattr(rebuilt, name), getattr(t_spec, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(rebuilt.params["t0"].numpy(), t_spec.params["t0"].numpy())


def test_one_ip_step_matches_reference(jax_side):
    _, j_iface, j_solver = jax_side
    j_state0 = j_iface.init_state()
    j_new = _jax_numpy(jax.jit(_make_step(j_iface, j_solver))(j_state0, 0.1))
    t_iface, t_solver = _port()
    t_state0 = ipstate_from_numpy(_jax_numpy(j_state0), "cpu")
    mu = torch.tensor(0.1, dtype=torch.float64)
    t_new = ipstate_to_numpy(_make_step(t_iface, t_solver)(t_state0, mu))
    jl, tl = _leaves(j_new), _leaves(t_new)
    for k in jl:
        scale = max(1.0, np.abs(jl[k]).max(initial=0.0))
        err = np.abs(tl[k] - jl[k]).max(initial=0.0)
        print(f"{k}: max|port - JAX| {err:.3e} (scale {scale:.3e})")
        assert err <= STEP_RTOL * scale, (k, err, scale)


def test_fused_solve_matches_reference(jax_side):
    _, j_iface, j_solver = jax_side
    j_opts = pt.IPOptions()
    j_opts.tol = 1e-8
    j_opts.linalg.solver = j_solver
    j_status, j_res = pt.ip_solve_fused(j_iface, j_opts)
    j_obj = float(j_iface.evaluate_objective())

    t_iface, t_solver = _port()
    t_opts = ptt.IPOptions()
    t_opts.tol = 1e-8
    t_opts.linalg.solver = t_solver
    t_status, t_res = ptt.ip_solve_fused(t_iface, t_opts)
    t_obj = float(t_iface.evaluate_objective())
    print(f"iterations: JAX {int(j_res.iterations)} port {t_res.iterations}; "
          f"objective: JAX {j_obj!r} port {t_obj!r}")
    assert j_status == pt.InteriorPointStatus.optimal
    assert t_status == ptt.InteriorPointStatus.optimal
    assert abs(t_obj - j_obj) / max(1.0, abs(j_obj)) <= 1e-6
    assert abs(j_obj - JAX_OBJECTIVE) <= 1e-12
    assert abs(t_res.iterations - int(j_res.iterations)) <= 1
    assert float(t_res.primal_inf) <= 1e-8 and float(t_res.dual_inf) <= 1e-8
    # every numeric factorization ran the panel path 2 x (Thomas tile + CR levels)
    assert t_solver.n_numeric >= t_res.iterations - 1


def test_fused_solve_with_line_search_and_adaptive_barrier(jax_side):
    """The option paths off the flagship: the filter line search and the
    adaptive barrier rule, against the JAX package with the same options."""

    def configure(opts, solver):
        opts.tol = 1e-8
        opts.barrier_strategy = "adaptive"
        opts.line_search.disable = False
        opts.linalg.solver = solver
        return opts

    _, j_iface, j_solver = jax_side
    j_status, j_res = pt.ip_solve_fused(j_iface, configure(pt.IPOptions(), j_solver))
    j_obj = float(j_iface.evaluate_objective())
    t_iface, t_solver = _port()
    t_status, t_res = ptt.ip_solve_fused(t_iface, configure(ptt.IPOptions(), t_solver))
    t_obj = float(t_iface.evaluate_objective())
    print(f"iterations: JAX {int(j_res.iterations)} port {t_res.iterations}; "
          f"objective: JAX {j_obj!r} port {t_obj!r}")
    assert j_status == pt.InteriorPointStatus.optimal
    assert t_status == ptt.InteriorPointStatus.optimal
    assert abs(t_obj - j_obj) / max(1.0, abs(j_obj)) <= 1e-6
    assert abs(t_res.iterations - int(j_res.iterations)) <= 1
