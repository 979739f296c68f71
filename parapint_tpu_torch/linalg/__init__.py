"""Linear solver layer: the banded Schur-complement solver and the
cyclic-reduction coupling solver."""

from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.schur import BlockRhs
from parapint_tpu_torch.linalg.tridiag import BlockTridiag, BlockTridiagSolver
from parapint_tpu_torch.linalg.banded_schur import (
    BandedLocalBlockKKT,
    BandedSchurComplementSolver,
)

__all__ = [
    "LinearSolverStatus",
    "LinearSolverResults",
    "LinearSolver",
    "BlockRhs",
    "BlockTridiag",
    "BlockTridiagSolver",
    "BandedLocalBlockKKT",
    "BandedSchurComplementSolver",
]
