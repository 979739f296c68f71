"""Host (C++) Bunch-Kaufman solver behind the LinearSolver protocol
(counterpart of ``parapint_tpu.linalg.host_bk``).

The robust *pivoted* symmetric-indefinite factorization, the role HSL MA27
plays in the reference parapint (``parapint/linalg/ma27_interface.py``):
it factors saddle-point KKT matrices with zero diagonals that the
unpivoted panel kernels cannot factor without regularization, and reads
the inertia off the 1x1/2x2 pivot blocks.

``csrc/bk_ldl.cpp`` is compiled with g++ into ``parapint_tpu_torch/_build/``
at first use (``ops/cuda_build.py``) and called through ctypes; a failed
build raises.  The solver is a host solver by design: it takes tensors on
any device, factors a float64 copy on the host (the batched entry points
factor independent blocks in parallel with OpenMP) and returns float64
tensors on the input's device.  Use it with the Python-loop ``ip_solve``,
as the oracle of the unpivoted kernels, or as the
``schur_complement_solver`` of a Schur solver.
"""

import ctypes
import dataclasses

import numpy as np
import torch

from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "bk_ldl.cpp"


def _lib() -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    c_int = ctypes.c_int
    return cuda_build.load(SOURCE, {
        "bk_factor_batched": [f64p, c_int, c_int, i32p, i32p],
        "bk_solve_batched": [f64p, c_int, c_int, i32p, f64p, c_int],
        "bk_inertia_batched": [f64p, c_int, c_int, i32p, i32p, i32p, i32p],
    }, restype=None)


def bk_factor(A: np.ndarray):
    """Factor a batch of symmetric matrices A (nb, n, n): (factors, ipiv,
    infos), the factors overwriting a copy of A.  The routine reads
    column-major storage, so it factors A^T per block: the same for the
    symmetric input it is given."""
    A = np.ascontiguousarray(A, dtype=np.float64).copy()
    nb, n, _ = A.shape
    ipiv = np.zeros((nb, n), dtype=np.int32)
    infos = np.zeros(nb, dtype=np.int32)
    _lib().bk_factor_batched(A, nb, n, ipiv, infos)
    return A, ipiv, infos


def bk_solve(factors: np.ndarray, ipiv: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Solve for a batch: B (nb, nrhs, n), one right-hand side per row."""
    nb, n, _ = factors.shape
    B = np.ascontiguousarray(B, dtype=np.float64).copy()
    _lib().bk_solve_batched(factors, nb, n, ipiv, B, B.shape[1])
    return B


def bk_inertia(factors: np.ndarray, ipiv: np.ndarray):
    """(pos, neg, zero), each (nb,) int32, from the pivot blocks."""
    nb, n, _ = factors.shape
    pos, neg, zero = (np.zeros(nb, dtype=np.int32) for _ in range(3))
    _lib().bk_inertia_batched(factors, nb, n, ipiv, pos, neg, zero)
    return pos, neg, zero


@dataclasses.dataclass
class HostBKFactor:
    factors: np.ndarray  # (nb, n, n)
    ipiv: np.ndarray  # (nb, n) int32
    inertia_: tuple  # (pos, neg, zero) ints summed over the batch
    status_: int
    batched: bool  # False: one matrix, squeezed
    device: torch.device  # the input's


class HostBKSolver(LinearSolver):
    """Pivoted LDL^T on the host; accepts (n, n) or batched (nb, n, n)
    tensors on any device."""

    def __init__(self):
        _lib()  # build at construction: a failed build raises here

    def symbolic(self, kkt) -> LinearSolverResults:
        if kkt.shape[-1] != kkt.shape[-2]:
            raise ValueError(f"matrix is not square: {tuple(kkt.shape)}")
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt: torch.Tensor) -> HostBKFactor:
        a = kkt.detach().to("cpu", torch.float64).numpy()
        batched = a.ndim == 3
        factors, ipiv, infos = bk_factor(a if batched else a[None])
        pos, neg, zero = bk_inertia(factors, ipiv)
        ok = bool((infos == 0).all())
        return HostBKFactor(
            factors=factors,
            ipiv=ipiv,
            inertia_=(int(pos.sum()), int(neg.sum()), int(zero.sum())),
            status_=int(LinearSolverStatus.successful if ok else LinearSolverStatus.singular),
            batched=batched,
            device=kkt.device,
        )

    def solve(self, fact: HostBKFactor, rhs: torch.Tensor) -> torch.Tensor:
        b = rhs.detach().to("cpu", torch.float64).numpy()
        if fact.batched:  # rhs (nb, n): one right-hand side per block
            x = bk_solve(fact.factors, fact.ipiv, b[:, None, :])[:, 0, :]
        elif b.ndim == 1:
            x = bk_solve(fact.factors, fact.ipiv, b[None, None, :])[0, 0]
        else:  # (n, k): several right-hand sides
            x = bk_solve(fact.factors, fact.ipiv, b.T[None])[0].T
        return torch.as_tensor(np.ascontiguousarray(x), device=rhs.device)

    def inertia(self, fact: HostBKFactor):
        return tuple(torch.tensor(v, dtype=torch.int32, device=fact.device) for v in fact.inertia_)

    def status(self, fact: HostBKFactor) -> torch.Tensor:
        return torch.tensor(fact.status_, dtype=torch.int32, device=fact.device)
