"""Schur-complement performance harness (counterpart of
``parapint_tpu.examples.performance.schur_complement``).

The synthetic structured least-squares benchmark of the reference
(parapint/examples/performance/schur_complement/): each block b solves
min ||y - y_hat_b||^2 s.t. y = A q, P q = theta, with the first n_theta
entries of q shared across blocks through the coupling variables theta.
The per-block KKT, in the quasi-definite [y, nu, q, lam] ordering::

    [2I   I    0    0  ] [y  ]   [2 y_hat]
    [I    0   -A    0  ] [nu ] = [0      ]
    [0   -A^T  0    P^T] [q  ]   [0      ]
    [0    0    P    0  ] [lam]   [0      ]

with border rows -P_d^T linking lam to the global theta block.  The result
is the recovery of the planted q (``max_err``).

Methods: fs = the monolithic KKT by ``DenseLDLSolver``, ssc = the batched
``SchurComplementSolver``, psc = ``ShardedSchurComplementSolver`` over the
ranks of a block mesh, csc = ``CondensedLSQSolver``, which keeps A banded
and runs the reference's default sizes (n_q_per_block=5000,
n_y_multiplier=120: 605,010 variables per block) that the dense methods
cannot hold (with a mesh, its back solve is split over the ranks).

    python -m parapint_tpu_torch.examples.performance.schur_complement \\
        --method csc --n_blocks 3 --n_q_per_block 5000 --n_y_multiplier 120
    python -m torch.distributed.run --nproc_per_node 2 \\
        -m parapint_tpu_torch.examples.performance.schur_complement --method psc --n_blocks 4
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

import parapint_tpu_torch as ptt
from parapint_tpu_torch.linalg.schur import BlockRhs, LocalBlockKKT
from parapint_tpu_torch.utils.device import require_device

F64 = torch.float64


@dataclasses.dataclass
class SyntheticModel:
    """The synthetic block-structured KKT system, built in numpy from
    ``default_rng(0)`` (the JAX package builds the same data)."""

    n_blocks: int
    n_q_per_block: int = 256
    n_y_multiplier: int = 2
    n_theta: int = 10
    A_nnz_per_row: int = 3

    def __post_init__(self):
        rng = np.random.default_rng(0)
        nq = self.n_q_per_block
        ny = nq * self.n_y_multiplier
        nt = self.n_theta
        p = (self.A_nnz_per_row - 1) // 2
        self.half_bw = p
        self.n_y_per_block = ny
        # band-first construction: the condensed method never forms A
        self.A_bands = np.zeros((self.n_y_multiplier, 2 * p + 1, nq))
        ids = np.arange(nq)
        for j in range(self.n_y_multiplier):
            for d in range(-p, p + 1):
                v = rng.normal(loc=0.0, scale=5.0, size=nq)
                self.A_bands[j, d + p] = np.where((ids + d >= 0) & (ids + d < nq), v, 0.0)
        self._A_dense = None
        self.theta = rng.normal(loc=5.0, scale=2.0, size=nt)
        self.q_true = np.zeros((self.n_blocks, nq))
        self.y_hat = np.zeros((self.n_blocks, ny))
        for b in range(self.n_blocks):
            q = rng.normal(loc=5.0, scale=2.0, size=nq)
            q[:nt] = self.theta
            y = self._band_matvec(q)
            y += rng.normal(0.0, 0.01 * np.abs(y).max(), size=ny)
            self.q_true[b] = q
            self.y_hat[b] = y
        # [y, nu, q, lam]: the unpivoted LDL^T meets the pivots 2 (y),
        # -1/2 (nu), 2 A^T A (q), -P G^{-1} P^T (lam), all nonzero
        self.nk = ny + ny + nq + nt
        self.off_nu = ny
        self.off_q = 2 * ny
        self.off_lam = 2 * ny + nq

    def _band_matvec(self, q: np.ndarray) -> np.ndarray:
        """A @ q from the band store (numpy, set-up only)."""
        nm, nb, nq = self.A_bands.shape
        p = (nb - 1) // 2
        out = np.zeros((nm, nq))
        for d in range(-p, p + 1):
            lo, hi = max(0, -d), min(nq, nq - d)
            out[:, lo:hi] += self.A_bands[:, d + p, lo:hi] * q[lo + d : hi + d]
        return out.reshape(-1)

    @property
    def A(self) -> np.ndarray:
        """Dense A (built on first use; only the dense methods need it)."""
        if self._A_dense is None:
            nm, nb, nq = self.A_bands.shape
            p = (nb - 1) // 2
            blocks = []
            for j in range(nm):
                m = np.zeros((nq, nq))
                for d in range(-p, p + 1):
                    lo, hi = max(0, -d), min(nq, nq - d)
                    m[np.arange(lo, hi), np.arange(lo, hi) + d] = self.A_bands[j, d + p, lo:hi]
                blocks.append(m)
            self._A_dense = np.concatenate(blocks, axis=0)
        return self._A_dense

    def build_block_diag(self) -> np.ndarray:
        ny, nq, nt, nk = self.n_y_per_block, self.n_q_per_block, self.n_theta, self.nk
        K = np.zeros((nk, nk))
        K[:ny, :ny] = 2.0 * np.eye(ny)
        K[:ny, self.off_nu : self.off_nu + ny] = np.eye(ny)
        K[self.off_nu : self.off_nu + ny, :ny] = np.eye(ny)
        K[self.off_q : self.off_q + nq, self.off_nu : self.off_nu + ny] = -self.A.T
        K[self.off_nu : self.off_nu + ny, self.off_q : self.off_q + nq] = -self.A
        P = np.zeros((nt, nq))
        P[:, :nt] = np.eye(nt)
        K[self.off_q : self.off_q + nq, self.off_lam :] = P.T
        K[self.off_lam :, self.off_q : self.off_q + nq] = P
        return np.broadcast_to(K, (self.n_blocks, nk, nk)).copy()

    def build_kkt(self, device) -> LocalBlockKKT:
        nt = self.n_theta
        border_loc = np.zeros((self.n_blocks, nt, self.nk))
        for j in range(nt):
            border_loc[:, j, self.off_lam + j] = -1.0
        row_idx = np.broadcast_to(np.arange(nt), (self.n_blocks, nt)).copy()
        t = lambda a: torch.as_tensor(a, dtype=F64, device=device)
        return LocalBlockKKT.make(
            diag=t(self.build_block_diag()), border_loc=t(border_loc), row_idx=row_idx,
            q=torch.zeros((nt, nt), dtype=F64, device=device),
        )

    def _rhs_blocks(self) -> np.ndarray:
        rhs = np.zeros((self.n_blocks, self.nk))
        rhs[:, : self.n_y_per_block] = 2.0 * self.y_hat
        return rhs

    def build_rhs(self, device) -> BlockRhs:
        return BlockRhs(
            blocks=torch.as_tensor(self._rhs_blocks(), dtype=F64, device=device),
            coupling=torch.zeros(self.n_theta, dtype=F64, device=device),
        )

    def build_dense(self, device):
        """Monolithic dense KKT and rhs for the full-space method."""
        N, nk, nt = self.n_blocks, self.nk, self.n_theta
        dim = N * nk + nt
        M = np.zeros((dim, dim))
        diag = self.build_block_diag()
        for b in range(N):
            M[b * nk : (b + 1) * nk, b * nk : (b + 1) * nk] = diag[b]
            for j in range(nt):
                M[N * nk + j, b * nk + self.off_lam + j] = -1.0
                M[b * nk + self.off_lam + j, N * nk + j] = -1.0
        rhs = np.zeros(dim)
        rhs[: N * nk] = self._rhs_blocks().reshape(-1)
        t = lambda a: torch.as_tensor(a, dtype=F64, device=device)
        return t(M), t(rhs)

    def check_result(self, sol_blocks) -> float:
        """max |q_estimate - q_true| over all blocks."""
        q_est = sol_blocks[:, self.off_q : self.off_q + self.n_q_per_block].cpu().numpy()
        return float(np.abs(q_est - self.q_true).max())


@dataclasses.dataclass
class Result:
    max_err: float = 0.0
    symbolic_time: float = 0.0
    numeric_time: float = 0.0
    back_solve_time: float = 0.0
    total_time: float = 0.0
    status: int = 0  # LinearSolverStatus of the numeric factorization
    theta: Optional[np.ndarray] = None  # the coupling solution (n_theta,)


METHODS = {
    "fs": "Full Space",
    "ssc": "Serial Schur-Complement",
    "psc": "Parallel Schur-Complement",
    "csc": "Condensed Structured SC",
}


def run(
    method: str = "ssc",
    n_blocks: int = 4,
    n_q_per_block: int = 256,
    n_y_multiplier: int = 2,
    n_theta: int = 10,
    A_nnz_per_row: int = 3,
    mesh=None,
    block_size: int = 128,
    verbose: bool = True,
    warm: bool = False,
    device="cuda",
) -> Optional[Result]:
    """Run one method at one size and report the phase times.

    ``warm=True`` runs numeric and solve a second time and times that pass
    (the first pays one-time costs such as the kernel build);
    ``symbolic_time`` keeps the first pass's.  Times wait for the card
    (``torch.cuda.synchronize``) before they are read.  ``device``: the card
    by default (pass ``device="cpu"`` for a CPU run); without CUDA the
    default raises.

    psc runs on every rank of an initialized process group
    (``parallel.distributed.initialize``) over ``mesh``, by default the
    mesh over the largest number of leading ranks that divides
    ``n_blocks``; a rank outside the mesh takes no part and returns None.
    csc with a ``mesh`` splits its back solve over the mesh's ranks.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    device = require_device(device)
    if method == "psc":
        import torch.distributed as dist

        from parapint_tpu_torch.parallel.mesh import largest_divisor_mesh

        if not dist.is_initialized():
            raise RuntimeError(
                "psc runs on the ranks of a process group: call "
                "parapint_tpu_torch.parallel.distributed.initialize first"
            )
        if mesh is None:
            mesh = largest_divisor_mesh(n_blocks)
        if mesh.get_coordinate() is None:
            return None
    m = SyntheticModel(
        n_blocks=n_blocks, n_q_per_block=n_q_per_block, n_y_multiplier=n_y_multiplier,
        n_theta=n_theta, A_nnz_per_row=A_nnz_per_row,
    )
    solve_kw = {}
    if method == "fs":
        solver = ptt.DenseLDLSolver(block_size=block_size)
        kkt, rhs = m.build_dense(device)
    elif method == "ssc":
        solver = ptt.SchurComplementSolver(block_size=block_size)
        kkt, rhs = m.build_kkt(device), m.build_rhs(device)
    elif method == "psc":
        solver = ptt.ShardedSchurComplementSolver(mesh, "blocks", block_size=block_size)
        kkt, rhs = m.build_kkt(device), m.build_rhs(device)
    else:
        # A stays banded: y and nu are eliminated analytically and
        # G = 2 A^T A is factored by cyclic reduction
        solver = ptt.CondensedLSQSolver(tile_size=block_size, mesh=mesh)
        kkt = ptt.CondensedLSQKKT(
            A_bands=torch.as_tensor(m.A_bands, dtype=F64, device=device),
            q_c=torch.zeros((n_theta, n_theta), dtype=F64, device=device),
            n_t=n_theta, n_blocks=n_blocks,
        )
        rhs = m.build_rhs(device)
        solve_kw = dict(kkt=kkt)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    res = Result()
    t0 = time.perf_counter()
    solver.symbolic(kkt)
    t1 = time.perf_counter()
    fact = solver.numeric(kkt)
    sync()
    t2 = time.perf_counter()
    x = solver.solve(fact, rhs, **solve_kw)
    sync()
    t3 = time.perf_counter()
    res.symbolic_time = t1 - t0
    if warm:
        t1 = time.perf_counter()
        fact = solver.numeric(kkt)
        sync()
        t2 = time.perf_counter()
        x = solver.solve(fact, rhs, **solve_kw)
        sync()
        t3 = time.perf_counter()
    if method == "fs":
        sol_blocks = x[: n_blocks * m.nk].reshape(n_blocks, m.nk)
        theta = x[n_blocks * m.nk :]
    else:
        sol_blocks, theta = x.blocks, x.coupling

    res.status = int(solver.status(fact))
    res.max_err = m.check_result(sol_blocks)
    res.theta = theta.cpu().numpy()
    res.numeric_time = t2 - t1
    res.back_solve_time = t3 - t2
    res.total_time = res.symbolic_time + res.numeric_time + res.back_solve_time

    if verbose:
        print(
            f"{'method':<30}{'# devices':<12}{'# blocks':<12}{'n_q_per_block':<15}"
            f"{'n_y_multiplier':<15}{'n_theta':<10}{'A NNZ per row':<15}"
            f"{'Est Err':<12}{'Symb Fact (s)':<15}{'Num Fact (s)':<15}"
            f"{'Back Solve (s)':<15}{'Total Time (s)':<15}"
        )
        print(
            f"{METHODS[method]:<30}{1 if mesh is None else mesh.size():<12}{n_blocks:<12}"
            f"{n_q_per_block:<15}{n_y_multiplier:<15}{n_theta:<10}"
            f"{A_nnz_per_row:<15}{res.max_err:<12.3f}{res.symbolic_time:<15.3f}"
            f"{res.numeric_time:<15.3f}{res.back_solve_time:<15.3f}"
            f"{res.total_time:<15.3f}"
        )
    return res


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--method", type=str, required=True, choices=sorted(METHODS))
    parser.add_argument("--n_blocks", type=int, required=True)
    parser.add_argument("--n_q_per_block", type=int, default=256)
    parser.add_argument("--n_y_multiplier", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.method == "psc":
        # one rank per process, started by torch.distributed.run
        from parapint_tpu_torch.parallel import distributed

        distributed.initialize(device_type=torch.device(args.device).type)
    run(
        method=args.method,
        n_blocks=args.n_blocks,
        n_q_per_block=args.n_q_per_block,
        n_y_multiplier=args.n_y_multiplier,
        device=args.device,
    )
    if args.method == "psc":
        distributed.shutdown()


if __name__ == "__main__":
    main()
