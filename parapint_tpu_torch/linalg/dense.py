"""Dense direct solvers (counterpart of ``parapint_tpu.linalg.dense``).

- :class:`DenseLDLSolver`: unpivoted blocked LDL^T with the inertia read off
  D (the role of MA27 / MUMPS in the reference).  Its panels go to the
  ``ldl_panels`` entry of the panel kernel (``ops/ldl_panel.py``) for f32
  factors.  Packed-factor mode solves by two triangular solves;
  explicit-inverse mode stores W = L^{-1} of the Ruiz-equilibrated matrix
  and solves by two matmuls, with optional iterative refinement.
- :class:`DenseLUSolver`: LU with optional inertia from a dense symmetric
  eigensolve (the reference's ``ScipyInterface`` role) — a test backend.
"""

import dataclasses
from typing import Optional

import torch

from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu_torch.ops.ldl import (
    ldl_factor,
    ldl_inertia,
    ldl_solve,
    ldl_winv,
    ruiz_scale,
    winv_apply,
)


def _status(bad: torch.Tensor) -> torch.Tensor:
    return torch.where(
        bad, int(LinearSolverStatus.singular), int(LinearSolverStatus.successful)
    ).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class DenseLDLFactor:
    LD: Optional[torch.Tensor]  # packed factor (npad, npad); None in W mode
    W: Optional[torch.Tensor]  # L^{-1} (npad, npad) in W mode
    d: Optional[torch.Tensor]  # pivots (npad,) in W mode
    s: Optional[torch.Tensor]  # Ruiz scaling (n,) in W mode
    kkt: Optional[torch.Tensor]  # original K, kept for refinement
    inertia: torch.Tensor  # (3,) int32: pos, neg, zero
    status: torch.Tensor  # () int32 LinearSolverStatus
    n: int


class DenseLDLSolver(LinearSolver):
    """Unpivoted blocked LDL^T (see :mod:`parapint_tpu_torch.ops.ldl`).

    ``block_size``: panel width (snapped to ``min(block_size, max(8, n))``);
    ``explicit_inverse``: store W = L^{-1} instead of the packed factor;
    ``refine_steps``: refinement passes per solve in explicit-inverse mode;
    ``factor_dtype``: factor in this dtype (None = the input's);
    ``zero_tol``: a pivot with |d| <= zero_tol * max(1, max|d|) counts as
    zero (default 0.0: exact zeros only; ``compat.MumpsInterface`` maps the
    reference's null-pivot threshold onto it).
    """

    def __init__(
        self,
        block_size: int = 128,
        explicit_inverse: bool = False,
        refine_steps: int = 1,
        factor_dtype=None,
        zero_tol: float = 0.0,
    ):
        self.block_size = block_size
        self.explicit_inverse = explicit_inverse
        self.refine_steps = refine_steps
        self.factor_dtype = factor_dtype
        self.zero_tol = zero_tol

    def symbolic(self, kkt: torch.Tensor) -> LinearSolverResults:
        if kkt.shape[-2] != kkt.shape[-1]:
            raise ValueError(f"matrix is not square: {tuple(kkt.shape)}")
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt: torch.Tensor) -> DenseLDLFactor:
        n = kkt.shape[-1]
        s = None
        kf = kkt
        if self.explicit_inverse:
            # Ruiz-equilibrate so a lower-precision factorization keeps its
            # pivot signs (inertia) despite the barrier dynamic range
            s = ruiz_scale(kkt)
            kf = kkt * s[:, None] * s[None, :]
        if self.factor_dtype is not None:
            kf = kf.to(self.factor_dtype)
            s = None if s is None else s.to(self.factor_dtype)
        bs = min(self.block_size, max(8, n))
        LD, d = ldl_factor(kf, block_size=bs)
        pos, neg, zero = ldl_inertia(d, n=n, zero_tol=self.zero_tol)
        # successful iff every logical pivot is cleanly nonzero and finite
        inertia = torch.stack([pos, neg, zero])
        status = _status((pos + neg) != n)
        if self.explicit_inverse:
            W, dd = ldl_winv(LD, bs)
            return DenseLDLFactor(
                LD=None, W=W, d=dd, s=s,
                kkt=kkt if self.refine_steps > 0 else None,
                inertia=inertia, status=status, n=n,
            )
        return DenseLDLFactor(
            LD=LD, W=None, d=None, s=None, kkt=None, inertia=inertia, status=status, n=n
        )

    def solve(self, fact: DenseLDLFactor, rhs: torch.Tensor) -> torch.Tensor:
        if fact.W is None:
            return ldl_solve(fact.LD, rhs)

        def apply(b):
            sc = fact.s if b.dim() == 1 else fact.s[:, None]
            return (winv_apply(fact.W, fact.d, b.to(fact.W.dtype) * sc) * sc).to(rhs.dtype)

        x = apply(rhs)
        for _ in range(self.refine_steps):
            x = x + apply(rhs - fact.kkt.to(rhs.dtype) @ x)
        return x

    def inertia(self, fact: DenseLDLFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: DenseLDLFactor) -> torch.Tensor:
        return fact.status


@dataclasses.dataclass(frozen=True)
class DenseLUFactor:
    lu: torch.Tensor
    piv: torch.Tensor
    inertia: torch.Tensor  # (3,) int32 (zeros when compute_inertia=False)
    status: torch.Tensor  # () int32


class DenseLUSolver(LinearSolver):
    """LU (``torch.linalg.lu_factor_ex``) with optional inertia from
    ``torch.linalg.eigvalsh`` at the reference's +-1e-8 thresholds — an
    O(n^3) eigensolve per factorization, for tests.  A factor with
    |U_ii| <= zero_tol * max(1, max|U_ii|) reads as singular."""

    def __init__(self, compute_inertia: bool = False, zero_tol: float = 1e-14):
        self.compute_inertia = compute_inertia
        self.zero_tol = zero_tol

    def symbolic(self, kkt: torch.Tensor) -> LinearSolverResults:
        if kkt.shape[-2] != kkt.shape[-1]:
            raise ValueError(f"matrix is not square: {tuple(kkt.shape)}")
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt: torch.Tensor) -> DenseLUFactor:
        lu, piv, _ = torch.linalg.lu_factor_ex(kkt)  # singular U reads as status, not an error
        u = torch.diagonal(lu).abs()
        bad = (u <= self.zero_tol * torch.clamp(u.max(), min=1.0)).any() | u.isnan().any()
        if self.compute_inertia:
            w = torch.linalg.eigvalsh(kkt)
            pos = (w > 1e-8).sum()
            neg = (w < -1e-8).sum()
            inertia = torch.stack([pos, neg, w.shape[0] - pos - neg]).to(torch.int32)
        else:
            inertia = torch.zeros(3, dtype=torch.int32, device=kkt.device)
        return DenseLUFactor(lu=lu, piv=piv, inertia=inertia, status=_status(bad))

    def solve(self, fact: DenseLUFactor, rhs: torch.Tensor) -> torch.Tensor:
        vec = rhs.dim() == 1
        x = torch.linalg.lu_solve(fact.lu, fact.piv, rhs[:, None] if vec else rhs)
        return x[:, 0] if vec else x

    def inertia(self, fact: DenseLUFactor):
        if not self.compute_inertia:
            raise RuntimeError("DenseLUSolver was constructed with compute_inertia=False")
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: DenseLUFactor) -> torch.Tensor:
        return fact.status
