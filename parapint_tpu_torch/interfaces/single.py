"""Single-NLP interior-point interface with a dense KKT (counterpart of
``parapint_tpu.interfaces.single``).

Wraps one :class:`NLPModel`, builds the 4x4 symmetric primal-dual KKT system
and its rhs with barrier terms (reference interface.py:250-679), and
recovers the bound-dual deltas in closed form after the solve.  The iterate
is an :class:`IPState` of float64 tensors on the model's device.

KKT layout (variable order [x, s, y_eq, y_ineq], reference interface.py:474-491)::

    [ W + Sigma_x + dw*I   0              Jeq^T    Jineq^T ]
    [ 0                    Sigma_s        0        -I      ]
    [ Jeq                  0              -dc*I    0       ]
    [ Jineq                -I             0        -dc*I   ]

rhs = -[grad_lag_x (with barrier); grad_lag_s (with barrier); c_eq; c_ineq - s]
(reference interface.py:493-528).
"""

import dataclasses
from typing import Tuple

import torch

from parapint_tpu_torch.interfaces import base
from parapint_tpu_torch.interfaces.base import Bounds, ConvergenceInfo, IPState
from parapint_tpu_torch.models.ad import NLPFunctions
from parapint_tpu_torch.models.model import NLPModel


@dataclasses.dataclass(frozen=True)
class KKTData:
    """Per-iteration evaluation results; the regularization is applied later
    so the inertia-correction retries reuse them without new AD."""

    hess: torch.Tensor  # (n, n) Hessian of the Lagrangian
    jac_eq: torch.Tensor  # (m_eq, n)
    jac_ineq: torch.Tensor  # (m_ineq, n)
    sigma_x: torch.Tensor  # (n,)
    sigma_s: torch.Tensor  # (m_ineq,)
    rhs: torch.Tensor  # (nk,)


class InteriorPointInterface(base.BaseInteriorPointInterface):
    """Interface for a single :class:`NLPModel`."""

    def __init__(self, model: NLPModel, obj_factor: float = 1.0):
        self.model = model
        self.device = model.device
        self.fns = NLPFunctions.from_model(model)
        self.obj_factor = obj_factor
        self.n_x = model.n_x
        self.n_eq = model.n_eq
        self.n_ineq = model.n_ineq
        self.nk = self.n_x + 2 * self.n_ineq + self.n_eq
        self._bounds_relaxation_factor = 0.0
        self._current_state = None  # updated by ip_solve
        self._set_bounds()

    # -- accessors ------------------------------------------------------------

    def get_state(self) -> IPState:
        """The current iterate (after ip_solve: the solution)."""
        return self._current_state

    def get_primals(self) -> torch.Tensor:
        return self._current_state.primals

    def get_slacks(self) -> torch.Tensor:
        return self._current_state.slacks

    def get_duals_eq(self) -> torch.Tensor:
        return self._current_state.duals_eq

    def get_duals_ineq(self) -> torch.Tensor:
        return self._current_state.duals_ineq

    def get_duals_primals_lb(self) -> torch.Tensor:
        return self._current_state.duals_primals_lb

    def get_duals_primals_ub(self) -> torch.Tensor:
        return self._current_state.duals_primals_ub

    def get_duals_slacks_lb(self) -> torch.Tensor:
        return self._current_state.duals_slacks_lb

    def get_duals_slacks_ub(self) -> torch.Tensor:
        return self._current_state.duals_slacks_ub

    def evaluate_objective(self):
        return self.fns.f(self._current_state.primals)

    def n_primals(self) -> int:
        return self.n_x

    def n_eq_constraints(self) -> int:
        return self.n_eq

    def n_ineq_constraints(self) -> int:
        return self.n_ineq

    @property
    def expected_neg_eig(self) -> int:
        """One negative eigenvalue per constraint row (reference
        interior_point.py:379-381)."""
        return self.n_eq + self.n_ineq

    @property
    def n_duals_eq(self) -> int:
        return self.n_eq

    @property
    def n_duals_ineq(self) -> int:
        return self.n_ineq

    # -- bounds -----------------------------------------------------------------

    def get_bounds_relaxation_factor(self) -> float:
        return self._bounds_relaxation_factor

    def set_bounds_relaxation_factor(self, val: float) -> None:
        self._bounds_relaxation_factor = val
        self._set_bounds()

    def _set_bounds(self) -> None:
        f = self._bounds_relaxation_factor
        m = self.model
        self.bounds = Bounds(
            xl=base.relax_bounds_lower(m.xl, f),
            xu=base.relax_bounds_upper(m.xu, f),
            gl=base.relax_bounds_lower(m.gl, f),
            gu=base.relax_bounds_upper(m.gu, f),
        )

    # -- initial state (reference ip_solve init block, :433-447) ----------------

    def init_state(self) -> IPState:
        m = self.model
        b = self.bounds
        base.validate_bounds(b.xl, b.xu)
        base.validate_bounds(b.gl, b.gu)
        x = base.process_init(m.x0, b.xl, b.xu)
        # initial slacks = g(x0) (interface.py:324-326)
        s = base.process_init(self.fns.c_ineq(m.x0), b.gl, b.gu)
        # bound duals: warm values masked at infinite bounds (interface.py:
        # 264-282), then pushed positive (:442-447)
        zl = torch.where(torch.isneginf(m.xl), 0.0, m.zl0)
        zu = torch.where(torch.isposinf(m.xu), 0.0, m.zu0)
        zl = base.process_init_duals_lb(zl, b.xl)
        zu = base.process_init_duals_ub(zu, b.xu)
        # slack duals split from y_ineq0 by sign (interface.py:275-279)
        vl = base.process_init_duals_lb(torch.clamp(m.y_ineq0, min=0.0), b.gl)
        vu = base.process_init_duals_ub(torch.clamp(-m.y_ineq0, min=0.0), b.gu)
        return IPState(
            primals=x,
            slacks=s,
            duals_eq=m.y_eq0,
            duals_ineq=m.y_ineq0,
            duals_primals_lb=zl,
            duals_primals_ub=zu,
            duals_slacks_lb=vl,
            duals_slacks_ub=vu,
        )

    # -- convergence (reference check_convergence, interior_point.py:174-317) --

    def convergence_info(self, state: IPState, barrier, error_scaling=100.0) -> ConvergenceInfo:
        fns = self.fns
        bounds = self.bounds
        x = state.primals
        grad_lag_x = (
            self.obj_factor * fns.grad_f(x)
            + fns.jac_eq(x).T @ state.duals_eq
            + fns.jac_ineq(x).T @ state.duals_ineq
            - state.duals_primals_lb
            + state.duals_primals_ub
        )
        grad_lag_s = -state.duals_ineq - state.duals_slacks_lb + state.duals_slacks_ub
        return base.convergence_metrics(
            objective=fns.f(x),
            grad_lag_primals=grad_lag_x,
            grad_lag_slacks=grad_lag_s,
            eq_resid=fns.c_eq(x),
            ineq_resid=fns.c_ineq(x) - state.slacks,
            primals=x,
            primals_lb=bounds.xl,
            primals_ub=bounds.xu,
            duals_primals_lb=state.duals_primals_lb,
            duals_primals_ub=state.duals_primals_ub,
            slacks=state.slacks,
            ineq_lb=bounds.gl,
            ineq_ub=bounds.gu,
            duals_slacks_lb=state.duals_slacks_lb,
            duals_slacks_ub=state.duals_slacks_ub,
            duals_eq=state.duals_eq,
            duals_ineq=state.duals_ineq,
            n_duals_eq=self.n_eq,
            n_duals_ineq=self.n_ineq,
            barrier=barrier,
            error_scaling=error_scaling,
        )

    def merit_components(self, state, barrier):
        """(theta, phi) for a filter line search: theta = 1-norm of the
        constraint residuals, phi = barrier objective (values only)."""
        fns = self.fns
        x, s = state.primals, state.slacks
        theta = fns.c_eq(x).abs().sum() + (fns.c_ineq(x) - s).abs().sum()
        b = self.bounds
        phi = self.obj_factor * fns.f(x) - barrier * (
            base.log_barrier_sum(x, b.xl, b.xu) + base.log_barrier_sum(s, b.gl, b.gu)
        )
        return theta, phi

    # -- KKT evaluation (reference interface.py:432-528) --------------------------

    def eval_kkt_data(self, state: IPState, barrier) -> KKTData:
        fns = self.fns
        bounds = self.bounds
        x, s = state.primals, state.slacks
        jac_eq = fns.jac_eq(x)
        jac_ineq = fns.jac_ineq(x)
        grad_lag_x = (
            self.obj_factor * fns.grad_f(x)
            + jac_eq.T @ state.duals_eq
            + jac_ineq.T @ state.duals_ineq
            + base.barrier_grad_term(x, bounds.xl, bounds.xu, barrier)
        )
        grad_lag_s = -state.duals_ineq + base.barrier_grad_term(s, bounds.gl, bounds.gu, barrier)
        return KKTData(
            hess=fns.hess_lag(x, state.duals_eq, state.duals_ineq, self.obj_factor),
            jac_eq=jac_eq,
            jac_ineq=jac_ineq,
            sigma_x=base.barrier_hessian_diag(
                x, bounds.xl, bounds.xu, state.duals_primals_lb, state.duals_primals_ub
            ),
            sigma_s=base.barrier_hessian_diag(
                s, bounds.gl, bounds.gu, state.duals_slacks_lb, state.duals_slacks_ub
            ),
            rhs=-torch.cat([grad_lag_x, grad_lag_s, fns.c_eq(x), fns.c_ineq(x) - s]),
        )

    def assemble_kkt(self, data: KKTData, w_reg, c_reg) -> torch.Tensor:
        """Dense KKT with regularization: ``w_reg`` (the accumulated Hessian
        regularization) adds to the x diagonal, ``c_reg`` sets the constraint
        diagonals to -c_reg (reference interface.py:590-619)."""
        n, me, mi = self.n_x, self.n_eq, self.n_ineq
        dt, dev = data.hess.dtype, data.hess.device
        z = lambda r, c: torch.zeros((r, c), dtype=dt, device=dev)
        eye = lambda k: torch.eye(k, dtype=dt, device=dev)
        row_x = [data.hess + torch.diag(data.sigma_x + w_reg), z(n, mi), data.jac_eq.T, data.jac_ineq.T]
        row_s = [z(mi, n), torch.diag(data.sigma_s), z(mi, me), -eye(mi)]
        row_yeq = [data.jac_eq, z(me, mi), -c_reg * eye(me), z(me, mi)]
        row_yineq = [data.jac_ineq, -eye(mi), z(mi, me), -c_reg * eye(mi)]
        return torch.cat([torch.cat(r, dim=1) for r in (row_x, row_s, row_yeq, row_yineq)], dim=0)

    def kkt_rhs(self, data: KKTData) -> torch.Tensor:
        return data.rhs

    # -- delta extraction (reference interface.py:530-570) ------------------------

    def extract_deltas(self, state: IPState, sol: torch.Tensor, barrier) -> IPState:
        bounds = self.bounds
        n, me, mi = self.n_x, self.n_eq, self.n_ineq
        dx = sol[:n]
        ds = sol[n : n + mi]
        return IPState(
            primals=dx,
            slacks=ds,
            duals_eq=sol[n + mi : n + mi + me],
            duals_ineq=sol[n + mi + me : n + 2 * mi + me],
            duals_primals_lb=base.delta_duals_lb(
                barrier, state.duals_primals_lb, dx, state.primals, bounds.xl
            ),
            duals_primals_ub=base.delta_duals_ub(
                barrier, state.duals_primals_ub, dx, state.primals, bounds.xu
            ),
            duals_slacks_lb=base.delta_duals_lb(barrier, state.duals_slacks_lb, ds, state.slacks, bounds.gl),
            duals_slacks_ub=base.delta_duals_ub(barrier, state.duals_slacks_ub, ds, state.slacks, bounds.gu),
        )

    # -- fraction to the boundary (reference interior_point.py:677-758) -----------

    def fraction_to_the_boundary(self, state, deltas, tau) -> Tuple[torch.Tensor, torch.Tensor]:
        b = self.bounds
        a_p = torch.minimum(
            torch.minimum(
                base.ftb_lb(tau, state.primals, deltas.primals, b.xl),
                base.ftb_ub(tau, state.primals, deltas.primals, b.xu),
            ),
            torch.minimum(
                base.ftb_lb(tau, state.slacks, deltas.slacks, b.gl),
                base.ftb_ub(tau, state.slacks, deltas.slacks, b.gu),
            ),
        )
        a_d = torch.stack(
            [
                base.ftb_duals(tau, getattr(state, f), getattr(deltas, f))
                for f in ("duals_primals_lb", "duals_primals_ub", "duals_slacks_lb", "duals_slacks_ub")
            ]
        ).min()
        return a_p, a_d

    # -- step update (reference interior_point.py:587-626) ------------------------

    def apply_step(self, state, deltas, alpha_primal, alpha_dual, alpha=1.0) -> IPState:
        ap = alpha * alpha_primal
        ad = alpha * alpha_dual
        return IPState(
            primals=state.primals + ap * deltas.primals,
            slacks=state.slacks + ap * deltas.slacks,
            duals_eq=state.duals_eq + ad * deltas.duals_eq,
            duals_ineq=state.duals_ineq + ad * deltas.duals_ineq,
            duals_primals_lb=state.duals_primals_lb + ad * deltas.duals_primals_lb,
            duals_primals_ub=state.duals_primals_ub + ad * deltas.duals_primals_ub,
            duals_slacks_lb=state.duals_slacks_lb + ad * deltas.duals_slacks_lb,
            duals_slacks_ub=state.duals_slacks_ub + ad * deltas.duals_slacks_ub,
        )
