"""Linear-solver status vocabulary (reference parapint/linalg/results.py)."""

import enum
from dataclasses import dataclass
from typing import Optional, Tuple


class LinearSolverStatus(enum.IntEnum):
    """Outcome of a factorization or solve.

    Integer-valued so a status can live on device and be merged across
    shards with a max-reduction (worst status wins), replacing the
    reference's pickle ``allgather`` status merge
    (parapint/linalg/schur_complement/mpi_explicit_schur_complement.py:19-30).
    Severity ordering: successful < warning < singular < not_enough_memory < error.
    """

    successful = 0
    warning = 1
    singular = 2
    not_enough_memory = 3
    error = 4


@dataclass
class LinearSolverResults:
    """Result holder (reference results.py:11-15)."""

    status: LinearSolverStatus = LinearSolverStatus.successful
    inertia: Optional[Tuple[int, int, int]] = None
