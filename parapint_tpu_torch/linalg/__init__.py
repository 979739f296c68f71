"""Linear solver layer: the Schur-complement solvers (dense-block, banded
and matrix-free PCG; serial and sharded over ``torch.distributed`` ranks),
the condensed least-squares solver, the dense LDL^T / LU solvers, the
host Bunch-Kaufman solver and the cyclic-reduction coupling solver."""

from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.dense import DenseLDLSolver, DenseLUSolver
from parapint_tpu_torch.linalg.host_bk import HostBKSolver
from parapint_tpu_torch.linalg.schur import (
    BlockKKT,
    BlockRhs,
    LocalBlockKKT,
    SchurComplementSolver,
    pad_block_count,
)
from parapint_tpu_torch.linalg.sharded_schur import ShardedSchurComplementSolver
from parapint_tpu_torch.linalg.tridiag import BlockTridiag, BlockTridiagSolver
from parapint_tpu_torch.linalg.banded_schur import (
    BandedLocalBlockKKT,
    BandedSchurComplementSolver,
    ShardedBandedSchurComplementSolver,
    pad_banded_block_count,
)
from parapint_tpu_torch.linalg.pcg_schur import PCGSchurComplementSolver
from parapint_tpu_torch.linalg.condensed import CondensedLSQKKT, CondensedLSQSolver

__all__ = [
    "LinearSolverStatus",
    "LinearSolverResults",
    "LinearSolver",
    "DenseLDLSolver",
    "DenseLUSolver",
    "HostBKSolver",
    "BlockKKT",
    "BlockRhs",
    "LocalBlockKKT",
    "SchurComplementSolver",
    "ShardedSchurComplementSolver",
    "pad_block_count",
    "BlockTridiag",
    "BlockTridiagSolver",
    "BandedLocalBlockKKT",
    "BandedSchurComplementSolver",
    "ShardedBandedSchurComplementSolver",
    "pad_banded_block_count",
    "PCGSchurComplementSolver",
    "CondensedLSQKKT",
    "CondensedLSQSolver",
]
