"""Shared state containers and elementwise interior-point math.

PyTorch counterpart of ``parapint_tpu.interfaces.base``: the barrier/bound
semantics of the reference (parapint/interfaces/interface.py and the helper
functions of parapint/algorithms/interior_point.py) as vectorized tensor
functions shared by all interfaces.  Padded entries follow the invariant:
padded bounds are +-inf, padded duals are exactly 0, padded
residuals/gradients are exactly 0 — so every formula below is
padding-oblivious.
"""

import abc
import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

from parapint_tpu_torch.utils.profile import host_sync


@dataclasses.dataclass(frozen=True)
class IPState:
    """The eight iterate families of the primal-dual IP method (reference
    interior_point.py:433-440).  Each field is a tensor, or a dict of
    tensors for structured interfaces (same keys as the JAX package)."""

    primals: Any
    slacks: Any
    duals_eq: Any
    duals_ineq: Any
    duals_primals_lb: Any
    duals_primals_ub: Any
    duals_slacks_lb: Any
    duals_slacks_ub: Any


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(IPState))


def map_leaf(fn: Callable, *vals):
    """Apply ``fn`` to one field of one or more states: a tensor, or a dict
    of tensors with the same keys."""
    if isinstance(vals[0], dict):
        return {k: fn(*(v[k] for v in vals)) for k in vals[0]}
    return fn(*vals)


class BaseInteriorPointInterface(abc.ABC):
    """The interface contract the interior-point algorithms program against
    (see ``parapint_tpu.interfaces.base.BaseInteriorPointInterface``)."""

    @abc.abstractmethod
    def init_state(self) -> IPState:
        """Initial iterate with bounds/dual processing applied."""

    @abc.abstractmethod
    def set_bounds_relaxation_factor(self, val: float) -> None: ...

    @abc.abstractmethod
    def get_bounds_relaxation_factor(self) -> float: ...

    @abc.abstractmethod
    def convergence_info(self, state, barrier, error_scaling=100.0):
        """Scaled infeasibilities + objective (a :class:`ConvergenceInfo`)."""

    @abc.abstractmethod
    def eval_kkt_data(self, state, barrier):
        """Evaluate AD quantities + rhs once per iteration."""

    @abc.abstractmethod
    def assemble_kkt(self, data, w_reg, c_reg):
        """Solver-ready KKT with regularization applied."""

    @abc.abstractmethod
    def kkt_rhs(self, data):
        """The rhs evaluated by eval_kkt_data."""

    @abc.abstractmethod
    def extract_deltas(self, state, sol, barrier) -> IPState:
        """Demultiplex the KKT solution into the 8 delta families."""

    @abc.abstractmethod
    def fraction_to_the_boundary(self, state, deltas, tau) -> Tuple:
        """(alpha_primal_max, alpha_dual_max)."""

    @abc.abstractmethod
    def apply_step(self, state, deltas, alpha_primal, alpha_dual, alpha=1.0):
        """state + alpha * deltas (per-family step sizes)."""

    @property
    @abc.abstractmethod
    def expected_neg_eig(self) -> int:
        """Target number of negative KKT eigenvalues."""

    obj_factor: float = 1.0

    def set_obj_factor(self, obj_factor: float) -> None:
        self.obj_factor = obj_factor

    def get_obj_factor(self) -> float:
        return self.obj_factor


@dataclasses.dataclass(frozen=True)
class Bounds:
    """(Relaxed) bounds: xl/xu on primals, gl/gu on inequality bodies."""

    xl: Any
    xu: Any
    gl: Any
    gu: Any


# -- bounds relaxation (reference interface.py:394-424) ----------------------


def relax_bounds_lower(lb: torch.Tensor, factor: float) -> torch.Tensor:
    """lb - factor*max(1, |lb|), left untouched at -inf."""
    return torch.where(
        torch.isfinite(lb), lb - factor * torch.clamp(lb.abs(), min=1.0), lb
    )


def relax_bounds_upper(ub: torch.Tensor, factor: float) -> torch.Tensor:
    return torch.where(
        torch.isfinite(ub), ub + factor * torch.clamp(ub.abs(), min=1.0), ub
    )


# -- initial point processing (reference interior_point.py:761-799) ----------


def process_init(x: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    """Push initial values strictly inside their bounds."""
    lb_fin = torch.isfinite(lb)
    ub_fin = torch.isfinite(ub)
    lb_only = lb_fin & ~ub_fin
    ub_only = ub_fin & ~lb_fin
    both = lb_fin & ub_fin
    oob = (x >= ub) | (x <= lb)
    x = torch.where(oob & lb_only, lb + 1.0, x)
    x = torch.where(oob & ub_only, ub - 1.0, x)
    x = torch.where(oob & both, 0.5 * (lb + ub), x)
    return x


def process_init_duals_lb(z: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    z = torch.where(z <= 0.0, 1.0, z)
    return torch.where(torch.isneginf(lb), 0.0, z)


def process_init_duals_ub(z: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    z = torch.where(z <= 0.0, 1.0, z)
    return torch.where(torch.isposinf(ub), 0.0, z)


def _on_host(a) -> np.ndarray:
    """``a`` as a numpy array; reading a device tensor that holds data waits
    for the device."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    if not a.numel():
        return a.cpu().numpy()
    with host_sync():
        return a.cpu().numpy()


def validate_bounds(lb, ub) -> None:
    """Host-side check (reference interior_point.py:762-767)."""
    lb, ub = _on_host(lb), _on_host(ub)
    if np.any((ub - lb) < 0):
        raise ValueError(
            "Lower bounds for variables/inequalities should not be larger "
            "than upper bounds."
        )
    if np.any((ub - lb) == 0):
        raise ValueError(
            "Variables and inequalities should not have equal lower and "
            "upper bounds."
        )


# -- barrier terms (reference interface.py:449-461, 508-519) -----------------


def barrier_hessian_diag(x, lb, ub, zl, zu):
    """Sigma = zl/(x-lb) + zu/(ub-x); 0 contribution from infinite bounds."""
    lo = torch.where(torch.isfinite(lb), zl / (x - lb), 0.0)
    hi = torch.where(torch.isfinite(ub), zu / (ub - x), 0.0)
    return lo + hi


def log_barrier_sum(v, lb, ub):
    """sum over finite bounds of log(v - lb) + log(ub - v), clamped at a
    tiny positive argument so the merit stays finite."""
    tiny = 1e-300
    lo = torch.where(torch.isfinite(lb), torch.log(torch.clamp(v - lb, min=tiny)), 0.0)
    hi = torch.where(torch.isfinite(ub), torch.log(torch.clamp(ub - v, min=tiny)), 0.0)
    return lo.sum() + hi.sum()


def barrier_grad_term(x, lb, ub, mu):
    """-mu/(x-lb) + mu/(ub-x): the barrier part of grad_lag wrt x (or s)."""
    lo = torch.where(torch.isfinite(lb), mu / (x - lb), 0.0)
    hi = torch.where(torch.isfinite(ub), mu / (ub - x), 0.0)
    return -lo + hi


# -- closed-form bound-dual deltas (reference interface.py:548-570) ----------


def delta_duals_lb(mu, z, dx, x, lb):
    return torch.where(torch.isfinite(lb), (mu - z * dx) / (x - lb) - z, 0.0)


def delta_duals_ub(mu, z, dx, x, ub):
    return torch.where(torch.isfinite(ub), (mu + z * dx) / (ub - x) - z, 0.0)


# -- fraction to the boundary (reference interior_point.py:655-674) ----------


def _one(x: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.float64, device=x.device)


def ftb_lb(tau, x, dx, xl) -> torch.Tensor:
    """max alpha in (0, 1] with x + alpha*dx >= xl + (1-tau)(x-xl)."""
    if x.numel() == 0:
        return _one(x)
    dx_mod = torch.where(dx == 0.0, 1.0, dx)
    alpha = -tau * (x - xl) / dx_mod
    alpha = torch.where(dx >= 0.0, torch.inf, alpha)
    return torch.clamp(alpha.min(), max=1.0)


def ftb_ub(tau, x, dx, xu) -> torch.Tensor:
    if x.numel() == 0:
        return _one(x)
    dx_mod = torch.where(dx == 0.0, 1.0, dx)
    alpha = tau * (xu - x) / dx_mod
    alpha = torch.where(dx <= 0.0, torch.inf, alpha)
    return torch.clamp(alpha.min(), max=1.0)


def ftb_duals(tau, z, dz) -> torch.Tensor:
    """Dual families are bounded below by 0 (reference :731-756)."""
    return ftb_lb(tau, z, dz, torch.zeros_like(z))


# -- convergence metrics (reference interior_point.py:174-317) ---------------


def _absmax(a: torch.Tensor) -> torch.Tensor:
    if a.numel() == 0:
        return torch.zeros((), dtype=torch.float64, device=a.device)
    return a.abs().max()


def _min_or_inf(a: torch.Tensor) -> torch.Tensor:
    if a.numel() == 0:
        return torch.full((), torch.inf, dtype=torch.float64, device=a.device)
    return a.min()


@dataclasses.dataclass(frozen=True)
class ConvergenceInfo:
    """Scaled infeasibilities; compl evaluated at both barrier=0 and
    barrier=mu, plus the raw complementarity-product statistics (mean, min,
    count over the finite bounds) that the adaptive barrier rule reads.
    Without statistics they read as no finite bound (count 0), on which
    the rule falls back to the monotone one."""

    objective: torch.Tensor
    primal_inf: torch.Tensor
    dual_inf: torch.Tensor
    compl_inf_0: torch.Tensor
    compl_inf_mu: torch.Tensor
    compl_avg: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(0.0, dtype=torch.float64))
    compl_min: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(float("inf"), dtype=torch.float64))
    compl_count: torch.Tensor = dataclasses.field(default_factory=lambda: torch.tensor(0))


def _compl_residuals(x, lb, ub, z_lb, z_ub, barrier):
    lb_fin = torch.isfinite(lb)
    ub_fin = torch.isfinite(ub)
    lb_mod = torch.where(lb_fin, lb, 0.0)
    ub_mod = torch.where(ub_fin, ub, 0.0)
    lb_resid = torch.where(lb_fin, (x - lb_mod) * z_lb - barrier, 0.0)
    ub_resid = torch.where(ub_fin, (ub_mod - x) * z_ub - barrier, 0.0)
    return torch.maximum(_absmax(lb_resid), _absmax(ub_resid))


def _compl_product_stats(x, lb, ub, z_lb, z_ub):
    """(sum, count, min) of the complementarity products over finite bounds."""
    lb_fin = torch.isfinite(lb)
    ub_fin = torch.isfinite(ub)
    lb_prod = torch.where(lb_fin, (x - torch.where(lb_fin, lb, 0.0)) * z_lb, 0.0)
    ub_prod = torch.where(ub_fin, (torch.where(ub_fin, ub, 0.0) - x) * z_ub, 0.0)
    total = lb_prod.sum() + ub_prod.sum()
    count = lb_fin.sum() + ub_fin.sum()
    mn = torch.minimum(
        _min_or_inf(torch.where(lb_fin, lb_prod, torch.inf)),
        _min_or_inf(torch.where(ub_fin, ub_prod, torch.inf)),
    )
    return total, count, mn


def convergence_metrics(
    objective,
    grad_lag_primals,
    grad_lag_slacks,
    eq_resid,
    ineq_resid,
    primals,
    primals_lb,
    primals_ub,
    duals_primals_lb,
    duals_primals_ub,
    slacks,
    ineq_lb,
    ineq_ub,
    duals_slacks_lb,
    duals_slacks_ub,
    duals_eq,
    duals_ineq,
    n_duals_eq: int,
    n_duals_ineq: int,
    barrier,
    error_scaling: float,
) -> ConvergenceInfo:
    """IPOPT-style scaled infinity norms (reference :251-317); all array
    arguments are flat, ``n_duals_*`` are the logical family sizes."""
    primal_inf = torch.maximum(_absmax(eq_resid), _absmax(ineq_resid))
    dual_inf = torch.maximum(_absmax(grad_lag_primals), _absmax(grad_lag_slacks))

    compl_0 = torch.maximum(
        _compl_residuals(primals, primals_lb, primals_ub, duals_primals_lb, duals_primals_ub, 0.0),
        _compl_residuals(slacks, ineq_lb, ineq_ub, duals_slacks_lb, duals_slacks_ub, 0.0),
    )
    compl_mu = torch.maximum(
        _compl_residuals(primals, primals_lb, primals_ub, duals_primals_lb, duals_primals_ub, barrier),
        _compl_residuals(slacks, ineq_lb, ineq_ub, duals_slacks_lb, duals_slacks_ub, barrier),
    )

    abs_bound_dual_sum = (
        duals_primals_lb.abs().sum()
        + duals_primals_ub.abs().sum()
        + duals_slacks_lb.abs().sum()
        + duals_slacks_ub.abs().sum()
    )
    abs_dual_sum = duals_eq.abs().sum() + duals_ineq.abs().sum() + abs_bound_dual_sum
    n_bound_duals = (
        torch.isfinite(primals_lb).sum()
        + torch.isfinite(primals_ub).sum()
        + torch.isfinite(ineq_lb).sum()
        + torch.isfinite(ineq_ub).sum()
    )
    dual_denom = n_duals_eq + n_duals_ineq + n_bound_duals
    dual_scaling = abs_dual_sum / torch.clamp(dual_denom, min=1)
    dual_scaling = torch.clamp(dual_scaling, min=error_scaling) / error_scaling
    compl_scaling = abs_bound_dual_sum / torch.clamp(n_bound_duals, min=1)
    compl_scaling = torch.clamp(compl_scaling, min=error_scaling) / error_scaling

    p_sum, p_cnt, p_min = _compl_product_stats(
        primals, primals_lb, primals_ub, duals_primals_lb, duals_primals_ub
    )
    s_sum, s_cnt, s_min = _compl_product_stats(
        slacks, ineq_lb, ineq_ub, duals_slacks_lb, duals_slacks_ub
    )
    compl_count = p_cnt + s_cnt
    return ConvergenceInfo(
        objective=objective,
        primal_inf=primal_inf,
        dual_inf=dual_inf / dual_scaling,
        compl_inf_0=compl_0 / compl_scaling,
        compl_inf_mu=compl_mu / compl_scaling,
        compl_avg=(p_sum + s_sum) / torch.clamp(compl_count, min=1),
        compl_min=torch.minimum(p_min, s_min),
        compl_count=compl_count,
    )
