"""parapint_tpu_torch — the PyTorch/CUDA port of parapint_tpu.

A second package beside ``parapint_tpu`` (the JAX reference, unchanged):
the same structured-NLP interior-point framework for PyTorch on NVIDIA
Hopper GPUs.  Module paths mirror the JAX package.  This package never
imports ``jax`` or ``parapint_tpu``.

Precision policy (the reference's rule, ``parapint_tpu/__init__.py``):
working vectors — rhs, residuals, convergence numbers — are explicit
``torch.float64``; float32 is used exactly where the reference uses it (the
interface's ``kkt_dtype``, the solvers' ``factor_dtype``, the kernels).  TF32 is
switched off for every matmul: reduced-precision products destroy pivot
signs (inertia) and make iterative refinement diverge, as bf16 passes did
on the TPU.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from parapint_tpu_torch.options import (  # noqa: E402
    IPOptions,
    InertiaCorrectionOptions,
    LinalgOptions,
    LineSearchOptions,
)
from parapint_tpu_torch.linalg import (  # noqa: E402
    BandedSchurComplementSolver,
    BlockTridiagSolver,
    CondensedLSQKKT,
    CondensedLSQSolver,
    DenseLDLSolver,
    DenseLUSolver,
    HostBKSolver,
    LinearSolver,
    LinearSolverResults,
    LinearSolverStatus,
    PCGSchurComplementSolver,
    SchurComplementSolver,
    ShardedBandedSchurComplementSolver,
    ShardedSchurComplementSolver,
)
from parapint_tpu_torch.models import NLPModel  # noqa: E402
from parapint_tpu_torch.interfaces import (  # noqa: E402
    DynamicModelSpec,
    DynamicSchurComplementInteriorPointInterface,
    HeterogeneousDynamicInterface,
    InteriorPointInterface,
    KindSpec,
    StochasticModelSpec,
    StochasticSchurComplementInteriorPointInterface,
)
from parapint_tpu_torch.algorithms import (  # noqa: E402
    FusedResult,
    InteriorPointStatus,
    ip_solve,
    ip_solve_fused,
    make_fused_ip_solve,
)

__version__ = "0.1.0"

__all__ = [
    "IPOptions",
    "InertiaCorrectionOptions",
    "LinalgOptions",
    "LineSearchOptions",
    "LinearSolverStatus",
    "LinearSolverResults",
    "LinearSolver",
    "BlockTridiagSolver",
    "BandedSchurComplementSolver",
    "DenseLDLSolver",
    "DenseLUSolver",
    "HostBKSolver",
    "SchurComplementSolver",
    "ShardedSchurComplementSolver",
    "ShardedBandedSchurComplementSolver",
    "PCGSchurComplementSolver",
    "CondensedLSQKKT",
    "CondensedLSQSolver",
    "NLPModel",
    "InteriorPointInterface",
    "DynamicModelSpec",
    "DynamicSchurComplementInteriorPointInterface",
    "StochasticModelSpec",
    "StochasticSchurComplementInteriorPointInterface",
    "KindSpec",
    "HeterogeneousDynamicInterface",
    "FusedResult",
    "InteriorPointStatus",
    "ip_solve",
    "ip_solve_fused",
    "make_fused_ip_solve",
]
