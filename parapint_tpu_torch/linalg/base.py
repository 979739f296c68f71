"""Linear solver protocol (the PyTorch counterpart of ``parapint_tpu.linalg.base``).

``numeric`` returns a *factorization* object of device tensors (including a
status code and the inertia) instead of mutating solver state, so a solver
object holds only configuration and can be reused across systems of the
same structure.
"""

import logging
from abc import ABC, abstractmethod
from typing import Any, Tuple

import torch

from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus


class LinearSolver(ABC):
    """Abstract linear solver: symbolic, numeric, solve, inertia, status."""

    @abstractmethod
    def symbolic(self, kkt: Any) -> LinearSolverResults:
        """Validate the structure (shapes / padding)."""

    @abstractmethod
    def numeric(self, kkt: Any) -> Any:
        """Factorize; returns the factorization object."""

    @abstractmethod
    def solve(self, fact: Any, rhs: Any) -> Any:
        """Back solve with a previous factorization."""

    @abstractmethod
    def inertia(self, fact: Any) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(num_pos, num_neg, num_zero) as device scalars."""

    @abstractmethod
    def status(self, fact: Any) -> torch.Tensor:
        """Device int32 scalar holding a :class:`LinearSolverStatus` value."""

    def solve_with_status(self, fact: Any, rhs: Any) -> Tuple[Any, torch.Tensor]:
        """Back solve, returning ``(solution, status)``; direct solvers
        report the factorization status."""
        return self.solve(fact, rhs), self.status(fact)

    def increase_memory_allocation(self, factor: float) -> None:
        """The reference's reallocation hook, called by ``ip_solve`` when a
        numeric factorization reports ``not_enough_memory``.  The port's
        solvers allocate per call and never report it, so this does
        nothing."""

    def results(self, fact: Any) -> LinearSolverResults:
        """The factorization's status and inertia read to the host as a
        :class:`LinearSolverResults`."""
        status = LinearSolverStatus(int(self.status(fact)))
        pos, neg, zero = self.inertia(fact)
        return LinearSolverResults(status=status, inertia=(int(pos), int(neg), int(zero)))

    def getLogger(self) -> logging.Logger:
        """The solver's logger, ``algorithms.<class name>`` (the reference's
        base_linear_solver_interface.py:16-23)."""
        return logging.getLogger("algorithms." + self.__class__.__name__)
