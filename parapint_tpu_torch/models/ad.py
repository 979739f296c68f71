"""``torch.func`` derivative closures for an NLPModel (counterpart of
``parapint_tpu.models.ad``).

Every quantity the single-NLP interface needs is a function of (x, duals,
obj_factor): the gradient of the objective, dense constraint Jacobians and
the Hessian of the Lagrangian (forward-over-reverse), the idiom of
``interfaces/blocked.py`` without the batch axis.
"""

from typing import Callable, Optional

from torch.func import grad, jacfwd, jacrev


class NLPFunctions:
    """Derivative closures for one NLP.

    ``objective``, ``eq_constraints``, ``ineq_constraints``: functions of x
    (constraints may be None for empty families); ``n_x``, ``n_eq``,
    ``n_ineq``: dimensions.  Constraint outputs are flattened to vectors.
    Jacobians use forward mode when the inputs are no more than the rows,
    reverse mode otherwise.
    """

    def __init__(
        self,
        objective: Callable,
        eq_constraints: Optional[Callable],
        ineq_constraints: Optional[Callable],
        n_x: int,
        n_eq: int,
        n_ineq: int,
    ):
        self.n_x, self.n_eq, self.n_ineq = n_x, n_eq, n_ineq
        self.f = objective

        def _vec(fn):
            if fn is None:
                return lambda x: x.new_zeros(0)
            return lambda x: fn(x).reshape(-1)

        self.c_eq = _vec(eq_constraints)
        self.c_ineq = _vec(ineq_constraints)
        self.grad_f = grad(objective)

        def _jac(fn, m):
            if m == 0:
                return lambda x: x.new_zeros((0, n_x))
            return jacfwd(fn) if n_x <= m else jacrev(fn)

        self.jac_eq = _jac(self.c_eq, n_eq)
        self.jac_ineq = _jac(self.c_ineq, n_ineq)

        def lagrangian(x, y_eq, y_ineq, obj_factor):
            val = obj_factor * self.f(x)
            if n_eq:
                val = val + (y_eq * self.c_eq(x)).sum()
            if n_ineq:
                val = val + (y_ineq * self.c_ineq(x)).sum()
            return val

        self.hess_lag = jacfwd(grad(lagrangian, argnums=0), argnums=0)

    @classmethod
    def from_model(cls, model) -> "NLPFunctions":
        return cls(
            objective=model.objective,
            eq_constraints=model.eq_constraints,
            ineq_constraints=model.ineq_constraints,
            n_x=model.n_x,
            n_eq=model.n_eq,
            n_ineq=model.n_ineq,
        )
