"""NLP model protocol (counterpart of ``parapint_tpu.models.model``).

An NLP is

    min  f(x)
    s.t. c_eq(x) = 0
         gl <= c_ineq(x) <= gu
         xl <= x <= xu

with ``f``, ``c_eq`` and ``c_ineq`` torch functions of x (n,) that
``torch.func`` can differentiate (build vectors with ``torch.stack`` or
``torch.cat``, not ``torch.tensor``).  Gradients, Jacobians and the Hessian
of the Lagrangian come from ``torch.func`` (:mod:`parapint_tpu_torch.models.ad`).
"""

import dataclasses
from typing import Callable, Optional

import torch

from parapint_tpu_torch.utils.device import require_device

F64 = torch.float64


@dataclasses.dataclass
class NLPModel:
    """A single NLP as functions + data.

    ``objective``: x -> scalar; ``x0`` (n,) initial primals;
    ``eq_constraints``: x -> (n_eq,), residual form c(x) = 0 (may be None);
    ``ineq_constraints``: x -> (n_ineq,) with gl <= g(x) <= gu (may be None;
    at least one of gl/gu is required with it); ``xl``/``xu`` (n,) variable
    bounds, unbounded by default; ``y_eq0``/``y_ineq0`` initial duals
    (zeros by default, PyNumero's defaults); ``zl0``/``zu0`` initial bound
    duals (ones by default, reference interface.py:643-649).  Arrays become
    float64 tensors on ``device``: the card by default (pass ``device="cpu"``
    for a CPU run); without CUDA the default raises.
    """

    objective: Callable
    x0: object
    eq_constraints: Optional[Callable] = None
    ineq_constraints: Optional[Callable] = None
    xl: Optional[object] = None
    xu: Optional[object] = None
    gl: Optional[object] = None
    gu: Optional[object] = None
    y_eq0: Optional[object] = None
    y_ineq0: Optional[object] = None
    zl0: Optional[object] = None
    zu0: Optional[object] = None
    device: object = "cuda"

    def __post_init__(self):
        self.device = require_device(self.device)
        dev = self.device
        f64 = lambda a: torch.as_tensor(a, dtype=F64, device=dev)
        full = lambda k, v: torch.full((k,), v, dtype=F64, device=dev)
        self.x0 = f64(self.x0)
        n = self.x0.shape[0]
        self.xl = f64(self.xl) if self.xl is not None else full(n, -torch.inf)
        self.xu = f64(self.xu) if self.xu is not None else full(n, torch.inf)
        if self.xl.shape != (n,) or self.xu.shape != (n,):
            raise ValueError("xl/xu must have the same shape as x0")

        with torch.no_grad():
            self.n_eq = 0 if self.eq_constraints is None else self.eq_constraints(self.x0).numel()
            self.n_ineq = 0 if self.ineq_constraints is None else self.ineq_constraints(self.x0).numel()
        if self.ineq_constraints is not None:
            if self.gl is None and self.gu is None:
                raise ValueError("gl and/or gu required with ineq_constraints")
            self.gl = f64(self.gl) if self.gl is not None else full(self.n_ineq, -torch.inf)
            self.gu = f64(self.gu) if self.gu is not None else full(self.n_ineq, torch.inf)
        else:
            self.gl = full(0, 0.0)
            self.gu = full(0, 0.0)

        self.n_x = n
        self.y_eq0 = f64(self.y_eq0) if self.y_eq0 is not None else full(self.n_eq, 0.0)
        self.y_ineq0 = f64(self.y_ineq0) if self.y_ineq0 is not None else full(self.n_ineq, 0.0)
        self.zl0 = f64(self.zl0) if self.zl0 is not None else full(n, 1.0)
        self.zu0 = f64(self.zu0) if self.zu0 is not None else full(n, 1.0)
