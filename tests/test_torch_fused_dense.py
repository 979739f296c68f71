"""The dense block path of the port end to end vs the JAX package at the
``entry()`` shape (Burgers nfe_x=8, nfe_t=8, 4 blocks, float32 KKT, dense
block form): ``ip_solve_fused`` with the solver of the JAX package's
``burgers_64blocks_cr`` bench row (W form, float32 factor, no refinement,
cyclic-reduction coupling) and with its dense-coupling variant
(``PT_BENCH_SC=dense``).

Criteria (the criterion of ``__graft_entry__.dryrun_multichip``): the same
status, objective relative gap <= 1e-6, iteration counts within 1 of each
other (both printed).
"""

import jax.numpy as jnp
import pytest
import torch

import parapint_tpu as pt
import parapint_tpu_torch as ptt
from parapint_tpu.examples import burgers as jburgers
from parapint_tpu_torch.examples import burgers

torch.set_num_threads(1)

SHAPE = dict(nfe_x=8, nfe_t=8, num_time_blocks=4)


def _solver(pkg, fdt, coupling):
    return pkg.SchurComplementSolver(
        block_size=128, explicit_inverse=True, factor_dtype=fdt, refine_steps=0,
        schur_complement_solver=pkg.BlockTridiagSolver() if coupling == "cr" else None,
    )


@pytest.mark.parametrize("coupling", ["cr", "dense"])
def test_fused_dense_solve_matches_reference(coupling):
    j_iface = pt.DynamicSchurComplementInteriorPointInterface(
        jburgers.build_spec(**SHAPE), kkt_dtype=jnp.float32
    )
    j_opts = pt.IPOptions()
    j_opts.tol = 1e-8
    j_opts.linalg.solver = _solver(pt, jnp.float32, coupling)
    j_status, j_res = pt.ip_solve_fused(j_iface, j_opts)
    j_obj = float(j_iface.evaluate_objective())

    t_iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(**SHAPE, device="cpu"), kkt_dtype=torch.float32
    )
    t_opts = ptt.IPOptions()
    t_opts.tol = 1e-8
    t_solver = _solver(ptt, torch.float32, coupling)
    t_opts.linalg.solver = t_solver
    t_status, t_res = ptt.ip_solve_fused(t_iface, t_opts)
    t_obj = float(t_iface.evaluate_objective())
    print(f"{coupling}: iterations JAX {int(j_res.iterations)} port {t_res.iterations}; "
          f"objective JAX {j_obj!r} port {t_obj!r}")
    assert j_status == pt.InteriorPointStatus.optimal
    assert t_status == ptt.InteriorPointStatus.optimal
    assert abs(t_obj - j_obj) / max(1.0, abs(j_obj)) <= 1e-6
    assert abs(t_res.iterations - int(j_res.iterations)) <= 1
    assert float(t_res.primal_inf) <= 1e-8 and float(t_res.dual_inf) <= 1e-8
    # one back solve (two block applies) per factorization that was solved
    assert t_solver.n_solves == t_res.iterations - 1 <= t_solver.n_numeric


def test_precision_check_warns_on_wider_factor():
    """check_precision_compat: a float32 KKT fed to a float64 factor warns
    (make_fused_ip_solve calls it, as the reference's does)."""
    iface = ptt.DynamicSchurComplementInteriorPointInterface(
        burgers.build_spec(nfe_x=4, nfe_t=4, num_time_blocks=2, device="cpu"),
        kkt_dtype=torch.float32,
    )
    opts = ptt.IPOptions()
    opts.linalg.solver = ptt.SchurComplementSolver(factor_dtype=torch.float64)
    with pytest.warns(UserWarning, match="kkt_dtype"):
        ptt.make_fused_ip_solve(iface, opts)
