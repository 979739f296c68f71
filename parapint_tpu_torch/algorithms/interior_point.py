"""Primal-dual interior-point driver with a Python loop (counterpart of
``parapint_tpu.algorithms.interior_point``).

The reference algorithm (parapint/algorithms/interior_point.py:405-631)
against the interface and solver protocols of this package:

- convergence check with IPOPT-style error scaling (:174-317),
- monotone barrier decrease mu <- max(mu_min, min(0.5 mu, mu^1.5)) gated on
  the mu-convergence test (:520-528), or the adaptive rule of
  :class:`IPOptions`,
- fraction-to-the-boundary with tau = 1 - mu (:571, 655-758),
- inertia correction: grow delta by factor_increase until the factorization
  reports (neg, zero) == (n_constraints, 0); the constraint diagonal is *set*
  to -delta and the Hessian diagonal *accumulates* +delta (:363-400 with
  interface.py:590-619),
- the memory-reallocation retry protocol (:634-652).

Every tensor stays on the interface's device; the loop reads a handful of
scalars per iteration to the host with ``float(...)`` (convergence numbers,
factorization status and inertia, step sizes), one read per host decision,
as the reference does.  ``ip_solve_fused`` (``algorithms/fused.py``) runs
the same method without the log table and without raising on a failed
factorization.
"""

import enum
import logging
import time
import warnings
from typing import Optional, Tuple

from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.results import LinearSolverStatus
from parapint_tpu_torch.options import IPOptions
from parapint_tpu_torch.utils.timer import HierarchicalTimer

logger = logging.getLogger(__name__)


class InteriorPointStatus(enum.Enum):
    optimal = 0
    error = 1


def check_precision_compat(interface, solver) -> None:
    """Warn when a reduced-precision interface feeds a higher-precision
    factorization: ``kkt_dtype`` rounds the KKT at assembly, so a solver
    factoring in a wider ``factor_dtype`` (the hybrid path exists for exact
    pivot signs) computes its pivots from already-rounded data and cannot
    keep its inertia promise.  f32 matrix with f32 factor is unaffected."""
    kd = getattr(interface, "kkt_dtype", None)
    fd = getattr(solver, "factor_dtype", None)
    if kd is None or fd is None:
        return
    if fd.itemsize > kd.itemsize:
        warnings.warn(
            f"interface kkt_dtype={kd} assembles the KKT in reduced precision, "
            f"but the solver factors in {fd}: pivot signs/inertia are computed "
            "from already-rounded data, defeating the hybrid-precision "
            "factorization's guarantee. Use kkt_dtype=None with "
            "factor_dtype=torch.float64 (hybrid), or factor_dtype=torch.float32.",
            stacklevel=3,
        )


def interface_state_or(interface):
    """The interface's current iterate, or its initial one before a solve."""
    state = getattr(interface, "_current_state", None)
    return interface.init_state() if state is None else state


def check_convergence(interface, barrier, error_scaling: float = 100.0):
    """Standalone convergence check (reference :174-317) at the interface's
    current iterate: (primal_inf, dual_inf, complementarity_inf) as floats,
    evaluated at ``barrier``."""
    info = interface.convergence_info(interface_state_or(interface), barrier, error_scaling)
    return float(info.primal_inf), float(info.dual_inf), float(info.compl_inf_mu)


def line_search(
    interface,
    state,
    deltas,
    alpha_primal_max: float,
    alpha_dual_max: float,
    barrier: float,
    options: IPOptions,
) -> Optional[float]:
    """Backtracking line search on the barrier-KKT-residual merit (the
    reference's line search is a disabled placeholder, interior_point.py:
    320-334): up to ``max_iter`` halvings, accepting the first trial whose
    merit (the max of the scaled infeasibilities at the current barrier)
    improves on the incumbent; ``step_anyway`` takes the full step when no
    trial improves, else the search fails (None)."""
    ls = options.line_search

    def merit(s) -> float:
        info = interface.convergence_info(s, barrier, options.error_scaling)
        return max(float(info.primal_inf), float(info.dual_inf), float(info.compl_inf_mu))

    merit0 = merit(state)
    alpha = 1.0
    for _ in range(max(1, ls.max_iter)):
        trial = interface.apply_step(state, deltas, alpha_primal_max, alpha_dual_max, alpha)
        if merit(trial) < merit0:
            return alpha
        alpha *= 0.5
    return 1.0 if ls.step_anyway else None


def try_factorization_and_reallocation(
    kkt, linear_solver: LinearSolver, reallocation_factor, max_iter, timer=None
):
    """Reference :634-652: retry a numeric factorization that reports
    ``not_enough_memory`` after growing the solver's allocation.  ``timer``
    is accepted as in the JAX package, which times no phase here either."""
    if max_iter < 1:
        raise ValueError("max_iter must be at least 1")
    for count in range(max_iter):
        fact = linear_solver.numeric(kkt)
        status = LinearSolverStatus(int(linear_solver.status(fact)))
        if status == LinearSolverStatus.not_enough_memory:
            linear_solver.increase_memory_allocation(reallocation_factor)
        else:
            break
    return fact, status, count


def numeric_factorization(
    interface,
    data,
    options: IPOptions,
    inertia_coef: float,
    timer: Optional[HierarchicalTimer] = None,
) -> Tuple[object, float]:
    """Factorize the KKT system, applying inertia correction as needed.
    Returns (factorization, final_inertia_coef); reference :337-402.
    ``timer`` goes to :func:`try_factorization_and_reallocation`, as in the
    JAX package (``ip_solve`` passes its own and times the whole call as
    "numeric")."""
    solver: LinearSolver = options.linalg.solver
    logger.debug(f"{'reg_iter':<10}{'reg_coef':<10}{'pos_eig':<10}{'neg_eig':<10}{'zero_eig':<10}{'status':<10}")

    def factor(w_reg, c_reg):
        return try_factorization_and_reallocation(
            interface.assemble_kkt(data, w_reg, c_reg),
            solver,
            options.linalg.reallocation_factor,
            options.linalg.max_num_reallocations,
            timer=timer,
        )[:2]

    fact, status = factor(0.0, 0.0)
    final_inertia_coef = 0.0
    if not options.use_inertia_correction:
        if status != LinearSolverStatus.successful:
            raise RuntimeError("Could not factorize KKT system; linear solver status: " + str(status))
        return fact, final_inertia_coef
    if status not in {LinearSolverStatus.successful, LinearSolverStatus.singular}:
        raise RuntimeError("Could not factorize KKT system; linear solver status: " + str(status))

    expected_neg = interface.expected_neg_eig
    neg = zero = None
    w_reg_cumulative = 0.0
    _iter = 0
    while final_inertia_coef <= options.inertia_correction.max_coef:
        if status == LinearSolverStatus.successful:
            pos, neg, zero = (int(v) for v in solver.inertia(fact))
        else:
            pos = neg = zero = None
        logger.debug(
            f"{_iter:<10}{final_inertia_coef:<10.2e}{str(pos):<10}"
            f"{str(neg):<10}{str(zero):<10}{str(status):<10}"
        )
        if neg == expected_neg and zero == 0 and status == LinearSolverStatus.successful:
            break
        # the Hessian regularization accumulates, the constraint
        # regularization is set (reference :385-386)
        w_reg_cumulative += inertia_coef
        fact, status = factor(w_reg_cumulative, inertia_coef)
        final_inertia_coef = inertia_coef
        inertia_coef *= options.inertia_correction.factor_increase
        _iter += 1

    if neg != expected_neg or zero != 0 or status != LinearSolverStatus.successful:
        raise RuntimeError("Exceeded maximum inertia correction")
    return fact, final_inertia_coef


_LOG_HEADER = (
    f"{'Iter':<6}{'Objective':<11}{'Prim Inf':<11}{'Dual Inf':<11}"
    f"{'Comp Inf':<11}{'Barrier':<11}{'Prim Step':<11}{'Dual Step':<11}"
    f"{'LS Step':<11}{'Reg':<11}{'Time':<7}"
)


def ip_solve(
    interface,
    options: Optional[IPOptions] = None,
    timer: Optional[HierarchicalTimer] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_interval: int = 10,
    resume_from: Optional[str] = None,
) -> InteriorPointStatus:
    """Solve an NLP with the primal-dual interior-point method.

    ``interface``: e.g. :class:`parapint_tpu_torch.interfaces.InteriorPointInterface`
    or a dynamic/stochastic Schur-complement interface; ``options.linalg.solver``
    must be set.  ``timer``: optional :class:`HierarchicalTimer`.
    ``checkpoint_path`` / ``checkpoint_interval``: write the full solver state
    every k iterations (``utils/checkpoint.py``); ``resume_from``: continue
    from such a checkpoint.

    The final iterate is ``interface.get_state()`` after the solve.  A failed
    factorization or back solve raises RuntimeError.
    """
    if options is None:
        options = IPOptions()
    options.validate()
    if options.linalg.solver is None:
        raise ValueError("options.linalg.solver must be set")
    solver: LinearSolver = options.linalg.solver
    check_precision_compat(interface, solver)
    if timer is None:
        timer = HierarchicalTimer()

    timer.start("IP solve")
    timer.start("init")
    interface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)

    barrier_parameter = options.init_barrier_parameter
    inertia_coef = options.inertia_correction.init_coef
    used_inertia_coef = 0.0

    t0 = time.time()
    state = interface.init_state()
    start_iter = 0
    if resume_from is not None:
        from parapint_tpu_torch.utils.checkpoint import load_checkpoint

        state, barrier_parameter, inertia_coef, start_iter = load_checkpoint(resume_from, like=state)
        logger.info(f"resumed from {resume_from} at iteration {start_iter}")
    interface._current_state = state

    alpha_primal_max = alpha_dual_max = alpha = 1.0
    logger.info(_LOG_HEADER)
    timer.stop("init")
    status = InteriorPointStatus.error

    for _iter in range(start_iter, options.max_iter):
        interface._current_state = state
        if (
            checkpoint_path is not None
            and checkpoint_interval > 0
            and _iter > start_iter
            and (_iter - start_iter) % checkpoint_interval == 0
        ):
            from parapint_tpu_torch.utils.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_path, state, barrier_parameter, inertia_coef, _iter)

        timer.start("convergence check")
        info = interface.convergence_info(state, barrier_parameter, options.error_scaling)
        objective = float(info.objective)
        primal_inf = float(info.primal_inf)
        dual_inf = float(info.dual_inf)
        compl_inf_0 = float(info.compl_inf_0)
        compl_inf_mu = float(info.compl_inf_mu)
        timer.stop("convergence check")

        logger.info(
            f"{_iter:<6}{objective:<11.2e}{primal_inf:<11.2e}{dual_inf:<11.2e}"
            f"{compl_inf_0:<11.2e}{barrier_parameter:<11.2e}"
            f"{alpha_primal_max:<11.2e}{alpha_dual_max:<11.2e}{alpha:<11.2e}"
            f"{used_inertia_coef:<11.2e}{time.time() - t0:<7.3f}"
        )

        if max(primal_inf, dual_inf, compl_inf_0) <= options.tol:
            status = InteriorPointStatus.optimal
            break
        if options.barrier_strategy == "adaptive" and int(info.compl_count) > 0:
            # LOQO/Vanderbei-Shanno centrality rule (see IPOptions)
            avg = float(info.compl_avg)
            if avg > 0.0:
                xi = float(info.compl_min) / avg
                sigma = 0.1 * min(0.05 * (1.0 - xi) / max(xi, 1e-12), 2.0) ** 3
                barrier_parameter = min(
                    options.init_barrier_parameter,
                    max(options.minimum_barrier_parameter, sigma * avg),
                )
        elif max(primal_inf, dual_inf, compl_inf_mu) <= options.barrier_decrease * barrier_parameter:
            barrier_parameter = max(
                options.minimum_barrier_parameter,
                min(0.5 * barrier_parameter, barrier_parameter**1.5),
            )

        timer.start("eval")
        data = interface.eval_kkt_data(state, barrier_parameter)
        timer.stop("eval")

        timer.start("factorize")
        if _iter == start_iter:
            timer.start("symbolic")
            sym_res = solver.symbolic(interface.assemble_kkt(data, 0.0, 0.0))
            timer.stop("symbolic")
            if sym_res.status != LinearSolverStatus.successful:
                raise RuntimeError(
                    "Could not factorize KKT system; linear solver status: " + str(sym_res.status)
                )
        timer.start("numeric")
        fact, used_inertia_coef = numeric_factorization(
            interface=interface, data=data, options=options, inertia_coef=inertia_coef,
            timer=timer,
        )
        inertia_coef = max(
            options.inertia_correction.init_coef,
            used_inertia_coef * options.inertia_correction.factor_decrease,
        )
        timer.stop("numeric")
        timer.stop("factorize")

        timer.start("back solve")
        delta_sol, solve_status = solver.solve_with_status(fact, interface.kkt_rhs(data))
        solve_status = LinearSolverStatus(int(solve_status))
        timer.stop("back solve")
        if solve_status not in {LinearSolverStatus.successful, LinearSolverStatus.warning}:
            # never step on a failed solve (an adaptive refinement that
            # stalled, an iterative coupling solver that did not converge)
            raise RuntimeError("Linear solver back solve failed; status: " + solve_status.name)

        deltas = interface.extract_deltas(state, delta_sol, barrier_parameter)

        timer.start("frac boundary")
        a_p, a_d = interface.fraction_to_the_boundary(state, deltas, 1.0 - barrier_parameter)
        alpha_primal_max = float(a_p)
        alpha_dual_max = float(a_d)
        if options.unified_step:
            alpha_primal_max = alpha_dual_max = min(alpha_primal_max, alpha_dual_max)
        timer.stop("frac boundary")

        if options.line_search.disable:
            alpha = 1.0
        else:
            timer.start("line search")
            alpha = line_search(
                interface, state, deltas, alpha_primal_max, alpha_dual_max, barrier_parameter, options
            )
            timer.stop("line search")
            if alpha is None:
                logger.warning("line search failed")
                status = InteriorPointStatus.error
                break

        state = interface.apply_step(state, deltas, alpha_primal_max, alpha_dual_max, alpha)

    interface._current_state = state
    timer.stop("IP solve")
    if options.report_timing:
        print(timer)
    return status
