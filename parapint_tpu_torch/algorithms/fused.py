"""Interior-point solve with every number on the device and the control
flow on the host (counterpart of ``parapint_tpu.algorithms.fused``).

Same algorithm and semantics as the JAX package's fused solve (reference
parapint/algorithms/interior_point.py:405-631): barrier update, inertia
correction, convergence tests.  Torch has no ``lax.while_loop``/``lax.cond``,
so the outer loop, the inertia-correction retry loop and the converged
branch run in Python; each decision reads one device flag
(``utils/profile.py::host_read``) and every iterate, residual and step stays
on the device.  The loop's spans are ``ip.solve``, ``ip.iteration``,
``ip.inertia_correction`` and ``ip.line_search``; each interface call carries
its own ``iface.*`` span.

Differences from the Python-loop ``ip_solve`` of the JAX package (as in its
fused solve): no per-iteration log table, and a failure to factorize or to
correct the inertia ends the solve with status error and the last valid
iterate instead of raising.
"""

import dataclasses
from typing import Optional

import torch

from parapint_tpu_torch.algorithms.interior_point import (
    InteriorPointStatus,
    check_precision_compat,
)
from parapint_tpu_torch.linalg.results import LinearSolverStatus
from parapint_tpu_torch.options import IPOptions
from parapint_tpu_torch.utils.profile import host_read, host_sync, span


@dataclasses.dataclass(frozen=True)
class FusedResult:
    state: object  # final IPState
    status: int  # 0 optimal, 1 error/max_iter
    iterations: int
    barrier: torch.Tensor
    primal_inf: torch.Tensor
    dual_inf: torch.Tensor
    compl_inf: torch.Tensor


def make_fused_ip_solve(interface, options: Optional[IPOptions] = None):
    """Build ``solve(state0) -> FusedResult``.  ``options.linalg.solver``
    must be set; options are read once here (rebuild for new options)."""
    if options is None:
        options = IPOptions()
    options.validate()
    solver = options.linalg.solver
    if solver is None:
        raise ValueError("options.linalg.solver must be set")
    check_precision_compat(interface, solver)
    do_ls = not options.line_search.disable

    tol = options.tol
    mu_min = options.minimum_barrier_parameter
    mu_decrease_gate = options.barrier_decrease
    ic = options.inertia_correction
    expected_neg = interface.expected_neg_eig
    error_scaling = options.error_scaling
    use_ic = options.use_inertia_correction
    SUCCESS = int(LinearSolverStatus.successful)

    def is_ok(fact):
        ok = solver.status(fact) == SUCCESS
        if use_ic:
            _, neg, zero = solver.inertia(fact)
            ok = ok & (neg == expected_neg) & (zero == 0)
        return ok

    def factor_with_inertia_correction(data, inertia_coef: float):
        """Returns (fact, ok, used_coef); reference :337-402.  The Hessian
        regularization accumulates, the constraint regularization is set."""
        fact = solver.numeric(interface.assemble_kkt(data, 0.0, 0.0))
        ok = is_ok(fact)
        if not use_ic:
            return fact, ok, 0.0
        w_cum, coef, used = 0.0, inertia_coef, 0.0
        while used <= ic.max_coef and not bool(host_read(ok)):
            with span("ip.inertia_correction"):
                w_cum += coef
                fact = solver.numeric(interface.assemble_kkt(data, w_cum, coef))
                ok = is_ok(fact)
                used = coef
                coef *= ic.factor_increase
        return fact, ok, used

    # IPOPT-style filter line search (Waechter & Biegler): the filter is a
    # fixed-capacity pair of device vectors; each trial costs one values-only
    # merit evaluation (interface.merit_components), no AD.  Up to
    # ``max_iter`` halvings; ``step_anyway`` takes the full step when no
    # trial is acceptable, else the iteration fails.
    FCAP = min(options.max_iter, 256)
    GAMMA = 1e-5  # filter margins gamma_theta = gamma_phi
    FAR = 1e300  # empty-slot sentinel: accepts everything

    def filter_line_search(state, deltas, a_p, a_d, mu, filt):
        """Returns (alpha, ls_ok, filt) with filt = [theta_f, phi_f, count]."""
        ls = options.line_search
        theta_f, phi_f, fcount = filt
        theta0, phi0 = interface.merit_components(state, mu)

        def acceptable(th, ph):
            ok_entries = ((th <= (1.0 - GAMMA) * theta_f) | (ph <= phi_f - GAMMA * theta_f)).all()
            ok_current = (th <= (1.0 - GAMMA) * theta0) | (ph <= phi0 - GAMMA * theta0)
            return ok_entries & ok_current & torch.isfinite(th) & torch.isfinite(ph)

        alpha, found = 1.0, False
        for _ in range(max(1, ls.max_iter)):
            trial = interface.apply_step(state, deltas, a_p, a_d, alpha)
            if bool(host_read(acceptable(*interface.merit_components(trial, mu)))):
                found = True
                break
            alpha *= 0.5
        ls_ok = found or ls.step_anyway
        if not found:
            alpha = 1.0 if ls.step_anyway else alpha
        # augment the filter with the (margin-shrunk) incumbent
        idx = min(fcount, FCAP - 1)
        theta_f[idx] = (1.0 - GAMMA) * theta0
        phi_f[idx] = phi0 - GAMMA * theta0
        return alpha, ls_ok, [theta_f, phi_f, min(fcount + 1, FCAP)]

    def next_barrier(info, mu):
        err_mu = torch.maximum(info.primal_inf, torch.maximum(info.dual_inf, info.compl_inf_mu))
        mu_monotone = torch.where(
            err_mu <= mu_decrease_gate * mu,
            torch.clamp(torch.minimum(0.5 * mu, mu**1.5), min=mu_min),
            mu,
        )
        if options.barrier_strategy != "adaptive":
            return mu_monotone
        # LOQO/Vanderbei-Shanno centrality rule, monotone fallback when the
        # problem has no finite bounds or the products degenerate
        avg = info.compl_avg
        xi = info.compl_min / torch.clamp(avg, min=1e-300)
        sigma = 0.1 * torch.clamp(0.05 * (1.0 - xi) / torch.clamp(xi, min=1e-12), max=2.0) ** 3
        mu_adaptive = torch.clamp(sigma * avg, mu_min, options.init_barrier_parameter)
        return torch.where((info.compl_count > 0) & (avg > 0.0), mu_adaptive, mu_monotone)

    def solve(state0) -> FusedResult:
        with span("ip.solve"):
            return _solve(state0)

    def _solve(state0) -> FusedResult:
        device = interface.device
        state = state0
        with host_sync():  # a copy from pageable host memory
            mu = torch.tensor(options.init_barrier_parameter, dtype=torch.float64, device=device)
        inertia_coef = ic.init_coef
        status = InteriorPointStatus.error
        zero = torch.zeros((), dtype=torch.float64, device=device)
        diags = (zero, zero, zero)
        filt = None
        if do_ls:
            far = torch.full((FCAP,), FAR, dtype=torch.float64, device=device)
            filt = [far, far.clone(), 0]
        it = 0
        while it < options.max_iter:
            with span("ip.iteration"):
                ad = interface.eval_ad(state)
                info = interface.convergence_from_ad(state, ad, mu, error_scaling)
                diags = (info.primal_inf, info.dual_inf, info.compl_inf_0)
                err0 = torch.maximum(
                    info.primal_inf, torch.maximum(info.dual_inf, info.compl_inf_0)
                )
                mu = next_barrier(info, mu)
                it += 1
                if bool(host_read(err0 <= tol)):
                    status = InteriorPointStatus.optimal
                    break
                data = interface.kkt_from_ad(state, ad, mu)
                fact, ok, used = factor_with_inertia_correction(data, inertia_coef)
                sol, solve_status = solver.solve_with_status(fact, interface.kkt_rhs(data))
                ok = ok & (solve_status <= int(LinearSolverStatus.warning))
                deltas = interface.extract_deltas(state, sol, mu)
                a_p, a_d = interface.fraction_to_the_boundary(state, deltas, 1.0 - mu)
                if not bool(host_read(ok)):
                    # keep the incoming iterate: the error result carries the
                    # last valid point
                    break
                alpha = 1.0
                if do_ls:
                    with span("ip.line_search"):
                        alpha, ls_ok, filt = filter_line_search(state, deltas, a_p, a_d, mu, filt)
                    if not ls_ok:
                        break
                state = interface.apply_step(state, deltas, a_p, a_d, alpha)
                inertia_coef = max(ic.init_coef, used * ic.factor_decrease)
        return FusedResult(
            state=state,
            status=status.value,
            iterations=it,
            barrier=mu,
            primal_inf=diags[0],
            dual_inf=diags[1],
            compl_inf=diags[2],
        )

    return solve


def ip_solve_fused(interface, options: Optional[IPOptions] = None):
    """One-call solve: sets the bounds relaxation factor, builds the solve,
    runs it from ``interface.init_state()``, stores the final state on the
    interface, and returns (InteriorPointStatus, FusedResult)."""
    if options is None:
        options = IPOptions()
    interface.set_bounds_relaxation_factor(options.bounds_relaxation_factor)
    solve = make_fused_ip_solve(interface, options)
    result = solve(interface.init_state())
    interface._current_state = result.state
    return InteriorPointStatus(result.status), result
