"""Condensed structured solver for large banded least-squares blocks
(counterpart of ``parapint_tpu.linalg.condensed``, serial).

Each of the N blocks is the least-squares saddle system of the performance
harness (``examples/performance/schur_complement.py``), in the
quasi-definite [y, nu, q, lam] ordering::

    [2I   I    0    0  ] [y  ]   [b_y  ]      y:  n_y = n_mult * n_q
    [I    0   -A    0  ] [nu ] = [b_nu ]      nu: n_y   (dual of y = A q)
    [0   -A^T  0    P^T] [q  ]   [b_q  ]      q:  n_q
    [0    0    P    0  ] [lam]   [b_lam]      lam: n_t  (dual of P q = theta)

with A a vertical stack of n_mult banded (n_q x n_q) matrices, shared by
every block, and P the selector of the first n_t entries of q.  y and nu
are eliminated analytically (y = A q + b_nu, nu = b_y - 2 y), leaving the
condensed saddle system in (q, lam)::

    [G    P^T] [q  ]   [b_q + A^T b_y - 2 A^T b_nu]        G = 2 A^T A
    [P    0  ] [lam] = [b_lam]

G is symmetric positive definite and banded (half-bandwidth 2p for A-bands
of half-bandwidth p), so tiled into ts x ts tiles it is block-tridiagonal
and factors by cyclic reduction (``linalg/tridiag.py``).  lam goes through
the small dense S_lam = -P G^{-1} P^T, and the global coupling theta through
S_theta = Q - N S_lam^{-1}.  Inertia is exact by Haynsworth additivity:
inertia(K_i) = (n_y, n_y, 0) + inertia(G) + inertia(S_lam).

The factor's dtype is the bands' dtype; the harness hands float64, so the
cyclic-reduction tiles and both dense factors run in float64 (the panel
kernels are float32-only and take no part).  All N blocks are solved at
once: their condensed right-hand sides are the columns of one
cyclic-reduction solve.
"""

import dataclasses

import torch
import torch.nn.functional as F

from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.dense import DenseLDLFactor, DenseLDLSolver
from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu_torch.linalg.schur import BlockRhs
from parapint_tpu_torch.linalg.tridiag import BlockTridiag, CRFactor, cr_factor, cr_solve_cols
from parapint_tpu_torch.ops.banded import (
    banded_btb,
    banded_matvec,
    banded_rmatvec,
    pad_sym_band,
    sym_band_to_tridiag_tiles,
)
from parapint_tpu_torch.parallel.mesh import BlockAxis

# panel width of the dense S_lam / S_theta factors and the largest panel
# width of the cyclic-reduction levels
DENSE_BLOCK_SIZE = 64


@dataclasses.dataclass(frozen=True)
class CondensedLSQKKT:
    """The N-block structured least-squares KKT, never densified.

    A_bands: (n_mult, 2p+1, n_q) row-indexed bands of the stacked banded
             blocks of A, shared by every block.
    q_c:     (n_t, n_t) global coupling block Q.
    n_t:     coupling dimension (P selects the first n_t entries of q).
    n_blocks: number of blocks N.
    """

    A_bands: torch.Tensor
    q_c: torch.Tensor
    n_t: int
    n_blocks: int

    @property
    def n_q(self) -> int:
        return self.A_bands.shape[-1]

    @property
    def n_mult(self) -> int:
        return self.A_bands.shape[0]

    @property
    def n_y(self) -> int:
        return self.n_mult * self.n_q

    @property
    def nk(self) -> int:
        """Per-block dimension in the [y, nu, q, lam] layout."""
        return 2 * self.n_y + self.n_q + self.n_t

    @property
    def off_nu(self) -> int:
        return self.n_y

    @property
    def off_q(self) -> int:
        return 2 * self.n_y

    @property
    def off_lam(self) -> int:
        return 2 * self.n_y + self.n_q


@dataclasses.dataclass(frozen=True)
class CondensedFactor:
    g_fact: CRFactor  # cyclic-reduction factor of the padded G
    pinv_cols: torch.Tensor  # (n_q, n_t) G^{-1} P^T
    s_lam_fact: DenseLDLFactor  # S_lam = -P G^{-1} P^T
    s_theta_fact: DenseLDLFactor  # S_theta = Q - N S_lam^{-1}
    inertia: torch.Tensor  # (3,) int32: all blocks + coupling
    status: torch.Tensor  # () int32
    n_pad: int


class CondensedLSQSolver(LinearSolver):
    """LinearSolver over :class:`CondensedLSQKKT`: the whole
    block-bordered solve (blocks and coupling) in one pipeline.
    ``n_numeric`` counts numeric factorizations, ``n_solves`` back solves.

    With a ``mesh`` (1-D ``DeviceMesh`` holding this rank) the back solve
    splits the blocks over the ranks of ``axis_name``: each rank solves its
    own contiguous blocks (the count padded with zero right-hand sides) and
    one all-reduce of n_t numbers sums the coupling rhs.  The factorization
    does not depend on the block count and runs on every rank.
    ``zero_tol`` goes to every factorization (the cyclic reduction of G and
    the two dense ones), ``factor_dtype`` to G's (None: the bands' dtype)."""

    def __init__(
        self,
        tile_size: int = 128,
        zero_tol: float = 0.0,
        factor_dtype=None,
        mesh=None,
        axis_name: str = "blocks",
    ):
        self.tile_size = tile_size
        self.zero_tol = zero_tol
        self.factor_dtype = factor_dtype
        self.mesh = mesh
        self.axis_name = axis_name
        self._dense = DenseLDLSolver(block_size=DENSE_BLOCK_SIZE, zero_tol=zero_tol)
        self.axis = None if mesh is None else BlockAxis.of(mesh, axis_name)
        self.n_numeric = 0
        self.n_solves = 0

    def symbolic(self, kkt: CondensedLSQKKT) -> LinearSolverResults:
        p = (kkt.A_bands.shape[1] - 1) // 2
        if 2 * p > self.tile_size:
            raise ValueError(f"G half-bandwidth {2 * p} exceeds tile size {self.tile_size}")
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt: CondensedLSQKKT) -> CondensedFactor:
        self.n_numeric += 1
        nq, nt, N = kkt.n_q, kkt.n_t, kkt.n_blocks
        dt, dev = kkt.A_bands.dtype, kkt.A_bands.device
        # G = 2 sum_j B_j^T B_j, half-bandwidth 2p
        g_bands = 2.0 * banded_btb(kkt.A_bands).sum(0)
        g_pad, n_pad = pad_sym_band(g_bands, self.tile_size)
        diag_t, upper_t = sym_band_to_tridiag_tiles(g_pad, self.tile_size)
        g_fact = cr_factor(
            BlockTridiag(diag=diag_t, upper=upper_t),
            block_size=min(DENSE_BLOCK_SIZE, self.tile_size),
            zero_tol=self.zero_tol,
            factor_dtype=self.factor_dtype,
        )
        # G^{-1} P^T: the n_t unit columns in one multi-column solve
        pt_cols = torch.zeros((nq + n_pad, nt), dtype=dt, device=dev)
        ar = torch.arange(nt, device=dev)
        pt_cols[ar, ar] = 1.0
        pinv_cols = cr_solve_cols(g_fact, pt_cols)[:nq]
        s_lam = -pinv_cols[:nt]  # -P G^{-1} P^T
        s_lam = 0.5 * (s_lam + s_lam.T)  # symmetrize roundoff
        s_lam_fact = self._dense.numeric(s_lam)
        s_lam_inv = self._dense.solve(s_lam_fact, torch.eye(nt, dtype=dt, device=dev))
        # S_theta = Q - sum_i (K_i^{-1})_{lam,lam} = Q - N S_lam^{-1}
        s_theta = kkt.q_c.to(dt) - N * s_lam_inv
        s_theta_fact = self._dense.numeric(s_theta)

        # exact inertia: per-block Haynsworth sum + theta
        ny = kkt.n_y
        gp, gn, gz = g_fact.inertia  # includes +1 pivots of the n_pad rows
        sp, sn, sz = self._dense.inertia(s_lam_fact)
        tp, tn, tz = self._dense.inertia(s_theta_fact)
        blk = torch.stack([N * (ny + gp - n_pad + sp), N * (ny + gn + sn), N * (gz + sz)])
        inertia = (blk + torch.stack([tp, tn, tz])).to(torch.int32)
        status = torch.maximum(
            g_fact.status,
            torch.maximum(self._dense.status(s_lam_fact), self._dense.status(s_theta_fact)),
        )
        return CondensedFactor(
            g_fact=g_fact,
            pinv_cols=pinv_cols,
            s_lam_fact=s_lam_fact,
            s_theta_fact=s_theta_fact,
            inertia=inertia,
            status=status,
            n_pad=n_pad,
        )

    def _block_solve(self, kkt: CondensedLSQKKT, fact: CondensedFactor, b, theta):
        """K_i^{-1} (b_i - A_i^T theta) for every block: b (N, nk), theta
        (n_t,).  The border A_i = -I on the lam rows, so theta only shifts
        b_lam by +theta."""
        N = b.shape[0]
        ny, nq, nt, nm = kkt.n_y, kkt.n_q, kkt.n_t, kkt.n_mult
        A = kkt.A_bands.to(b.dtype)
        b_y = b[:, :ny].reshape(N, nm, nq)
        b_nu = b[:, kkt.off_nu : kkt.off_nu + ny].reshape(N, nm, nq)
        b_q = b[:, kkt.off_q : kkt.off_q + nq]
        b_lam = b[:, kkt.off_lam :] + theta
        # condensed rhs g = b_q + A^T b_y - 2 A^T b_nu
        g = b_q + banded_rmatvec(A, b_y).sum(1) - 2.0 * banded_rmatvec(A, b_nu).sum(1)
        g = F.pad(g, (0, fact.n_pad))
        q0 = cr_solve_cols(fact.g_fact, g.T).T[:, :nq]
        lam = self._dense.solve(fact.s_lam_fact, (b_lam - q0[:, :nt]).T).T
        q = q0 - lam @ fact.pinv_cols.T
        y = banded_matvec(A, q[:, None, :]) + b_nu
        nu = b_y - 2.0 * y
        return torch.cat([y.reshape(N, ny), nu.reshape(N, ny), q, lam], dim=1)

    def solve(self, fact: CondensedFactor, rhs: BlockRhs, kkt: CondensedLSQKKT = None) -> BlockRhs:
        """Block-bordered back solve.  rhs: blocks (N, nk) in the
        [y, nu, q, lam] layout and coupling (n_t,); ``kkt`` must be the
        system passed to ``numeric`` (the factor does not keep the bands)."""
        if kkt is None:
            raise ValueError("CondensedLSQSolver.solve needs kkt=")
        self.n_solves += 1
        blocks = rhs.blocks
        N = blocks.shape[0]
        if self.axis is not None:
            nb = -(-N // self.axis.size) * self.axis.size
            blocks = self.axis.local_rows(blocks, nb)
        zero_t = blocks.new_zeros(kkt.n_t)
        v = self._block_solve(kkt, fact, blocks, zero_t)
        # sc_rhs = b_theta - sum_i A_i v_i = b_theta + sum_i v_i[lam]
        sc_local = v[:, kkt.off_lam :].sum(0)
        sc_rhs = rhs.coupling + (sc_local if self.axis is None else self.axis.sum(sc_local))
        theta = self._dense.solve(fact.s_theta_fact, sc_rhs)
        x = self._block_solve(kkt, fact, blocks, theta)
        if self.axis is not None:
            x = self.axis.gather_blocks(x, nb)[:N]
        return BlockRhs(blocks=x, coupling=theta)

    def inertia(self, fact: CondensedFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: CondensedFactor) -> torch.Tensor:
        return fact.status
