"""Matrix-free Schur-complement solver: preconditioned conjugate gradients
on the coupling system (counterpart of ``parapint_tpu.linalg.pcg_schur``).

The solver never forms S; it runs Jacobi-preconditioned CG on

    S y = r,   S = Q - sum_i A_i K_i^{-1} A_i^T

whose matvec is one batched per-block K^{-1} application (the
``winv_apply_fused`` kernel entry for a float32 W) between the block-local
border products.  S is symmetric positive definite whenever the blocks
carry their expected inertia (the coupling variables are primal), so
nonpositive curvature during CG flags the factorization as singular.  The
preconditioner is the exact diag(S), from the same per-block multi-column
product that forms a dense SC, summed onto the coupling rows in a fixed
order.

Inertia: the blocks' inertia is exact; the SC's is reported as (nc, 0, 0),
the value it must have at a usable iterate.  A wrong SC inertia surfaces as
negative curvature, which sets the error status of the solve.

CG is a host loop with one flag read per iteration, the JAX package's
``while_loop`` with its stopping rule: ||r|| <= cg_tol (1 + ||rhs||), at
most cg_maxiter iterations, stopped early by nonpositive curvature.

With a mesh, each rank factors its own contiguous blocks of the KKT padded
to a multiple of the rank count, and the Jacobi diagonal, the inertia, the
status and the coupling part of each S matvec (one per CG iteration) are
all-reduced over the mesh's process group; the CG vectors are the same on
every rank.  The KKT and rhs are then either the full ones, the same on
every rank, or this rank's part from an interface built with the same mesh
(a ``LocalBlockKKT`` with ``global_blocks`` set and the rhs rows of its
blocks); the solve returns the full solution either way.
"""

import dataclasses
from typing import Optional

import torch

from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu_torch.linalg.schur import (
    BlockRhs,
    LocalBlockKKT,
    _border_apply_local,
    _border_T_apply_local,
    _factor_blocks_winv,
    _winv_apply_batched,
    _winv_multi,
    block_range,
    gather_kkt,
    gather_rhs,
    pad_block_count,
    serial_factor,
    shard_kkt,
)
from parapint_tpu_torch.ops.ordered_scatter import scatter_add_rows
from parapint_tpu_torch.parallel.mesh import BlockAxis, all_reduce_max, all_reduce_sum

@dataclasses.dataclass(frozen=True)
class PCGSchurFactor:
    block_W: torch.Tensor  # (N, npad, npad) L^{-1} of the equilibrated blocks
    block_d: torch.Tensor  # (N, npad) pivots
    block_s: torch.Tensor  # (N, nk) Ruiz scaling
    border_loc: torch.Tensor  # (N, L, nk)
    row_idx: torch.Tensor  # (N, L)
    q: torch.Tensor  # (nc, nc)
    precond: torch.Tensor  # (nc,) 1 / diag(S)
    inertia: torch.Tensor  # (3,) int32, blocks + (nc, 0, 0)
    status: torch.Tensor  # () int32
    nk: int
    nc: int
    global_blocks: Optional[int] = None  # the KKT's: set when it was rank-local
    # without a mesh, of a gathered rank-local KKT: the axis over which each
    # rhs is gathered (``schur.gather_rhs``)
    rhs_axis: Optional[BlockAxis] = None


class PCGSchurComplementSolver(LinearSolver):
    """Schur-complement solver with CG on the never-formed coupling system,
    over :class:`LocalBlockKKT` systems.

    ``block_size``: panel width of the block factorization;
    ``factor_dtype``: the blocks' factor dtype (float32 sends the panels to
    the ``ldl_panels_slab_winv`` kernel entry); ``zero_tol`` as for
    ``SchurComplementSolver``; CG stops when ||r|| <= ``cg_tol`` (1 +
    ||rhs||) or after ``cg_maxiter`` iterations; ``refine_steps`` is kept
    (None reads 0) and runs no pass: CG iterates to its tolerance on the
    coupling system, as in the JAX solver.  ``n_numeric`` counts
    numeric factorizations, ``n_solves`` back solves (two block applies
    each, plus one per CG iteration) and ``cg_iterations`` lists the CG
    iterations of each back solve.  ``mesh`` (a 1-D ``DeviceMesh`` holding
    this rank) splits the blocks over the ranks of ``axis_name``; the counts
    are then this rank's.  Without a mesh, a rank-local KKT (an interface
    built with ``mesh=``) and the rhs of its solves are gathered whole on
    every rank (``schur.gather_kkt``), which then solves the whole system.
    """

    def __init__(
        self,
        mesh=None,
        axis_name: str = "blocks",
        block_size: int = 128,
        zero_tol: float = 0.0,
        factor_dtype=None,
        cg_tol: float = 1e-12,
        cg_maxiter: int = 200,
        refine_steps: Optional[int] = None,
    ):
        self.mesh = mesh
        self.axis_name = axis_name
        self.axis = None if mesh is None else BlockAxis.of(mesh, axis_name)
        self.group = None if mesh is None else self.axis.group
        self.block_size = block_size
        self.zero_tol = zero_tol
        self.factor_dtype = factor_dtype
        self.cg_tol = cg_tol
        self.cg_maxiter = cg_maxiter
        self.refine_steps = 0 if refine_steps is None else refine_steps
        self.n_numeric = 0
        self.n_solves = 0
        self.cg_iterations = []

    def symbolic(self, kkt: LocalBlockKKT) -> LinearSolverResults:
        if not isinstance(kkt, LocalBlockKKT):
            raise TypeError("PCGSchurComplementSolver requires a LocalBlockKKT")
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt: LocalBlockKKT) -> PCGSchurFactor:
        self.n_numeric += 1
        if self.axis is None:
            return serial_factor(self._numeric(gather_kkt(kkt)), kkt)
        # any block count: masked identity blocks pad it
        return self._numeric(block_range(*shard_kkt(kkt, self.axis, pad_block_count)))

    def _numeric(self, kkt: LocalBlockKKT) -> PCGSchurFactor:
        """Factor the blocks of ``kkt`` (this rank's with a mesh); the
        Jacobi diagonal, inertia and status are summed over the group."""
        nc = kkt.q.shape[-1]
        W, d, s, inertia, status = _factor_blocks_winv(
            kkt.diag, kkt.mask, self.block_size, self.zero_tol, self.factor_dtype
        )
        # exact diag(S) for the Jacobi preconditioner: the diagonals of the
        # local contributions summed onto their coupling rows
        S_loc = _winv_multi(W, d, s, kkt.border_loc.transpose(1, 2))
        diag_contrib = torch.diagonal(S_loc, dim1=1, dim2=2)
        dS = all_reduce_sum(scatter_add_rows(kkt.row_idx, -diag_contrib, nc), self.group)
        inertia = all_reduce_sum(inertia, self.group)
        status = all_reduce_max(status, self.group)
        dS = dS + torch.diagonal(kkt.q).to(dS.dtype)
        precond = torch.where(dS.abs() > 0, 1.0 / dS, torch.ones_like(dS))
        # the SC is SPD given the blocks' inertia (module docstring)
        inertia = inertia + torch.tensor([nc, 0, 0], dtype=torch.int32, device=inertia.device)
        return PCGSchurFactor(
            block_W=W,
            block_d=d,
            block_s=s,
            border_loc=kkt.border_loc,
            row_idx=kkt.row_idx,
            q=kkt.q,
            precond=precond,
            inertia=inertia,
            status=status,
            nk=kkt.diag.shape[-1],
            nc=nc,
            global_blocks=kkt.global_blocks,
        )

    def _sc_matvec(self, fact: PCGSchurFactor, y):
        """S y = Q y - sum_i A_i K_i^{-1} A_i^T y."""
        ay = _border_T_apply_local(fact.border_loc, fact.row_idx, y)
        v = _winv_apply_batched(fact.block_W, fact.block_d, fact.block_s, ay)
        contrib = _border_apply_local(fact.border_loc, fact.row_idx, v, fact.nc)
        return fact.q.to(y.dtype) @ y - all_reduce_sum(contrib, self.group)

    def _cg(self, fact: PCGSchurFactor, rhs):
        """Jacobi-PCG; returns (y, converged, neg_curvature, iterations) with
        the two flags as device bools."""
        M = fact.precond.to(rhs.dtype)
        thresh = self.cg_tol * (1.0 + torch.linalg.norm(rhs))
        y = torch.zeros_like(rhs)
        r = rhs
        p = M * r
        rz = torch.dot(r, p)
        neg = torch.zeros((), dtype=torch.bool, device=rhs.device)
        it = 0
        while it < self.cg_maxiter and bool(((torch.linalg.norm(r) > thresh) & ~neg).item()):
            Sp = self._sc_matvec(fact, p)
            pSp = torch.dot(p, Sp)
            neg = neg | (pSp <= 0.0)
            alpha = rz / torch.where(pSp != 0.0, pSp, 1.0)
            y = y + alpha * p
            r = r - alpha * Sp
            z = M * r
            rz_new = torch.dot(r, z)
            beta = rz_new / torch.where(rz != 0.0, rz, 1.0)
            p = z + beta * p
            rz = rz_new
            it += 1
        converged = torch.linalg.norm(r) <= thresh
        return y, converged, neg, it

    def solve_with_status(self, fact: PCGSchurFactor, rhs: BlockRhs):
        """Solve, returning the per-solve CG status too: negative curvature
        (S not positive definite) maps to ``singular`` so that inertia
        correction engages; ``cg_maxiter`` iterations without convergence map to
        ``error``."""
        self.n_solves += 1
        rhs = gather_rhs(fact, rhs)
        blocks = rhs.blocks
        if self.axis is not None:
            # this rank's rows of the rhs padded like the factor
            nb = fact.block_W.shape[0] * self.axis.size
            rank_local = fact.global_blocks is not None
            n = fact.global_blocks if rank_local else blocks.shape[0]
            blocks = self.axis.local_rows(blocks, nb, rank_local)
        v = _winv_apply_batched(fact.block_W, fact.block_d, fact.block_s, blocks).to(blocks.dtype)
        contrib = _border_apply_local(fact.border_loc, fact.row_idx, v, fact.nc)
        sc_rhs = rhs.coupling - all_reduce_sum(contrib, self.group)
        y, converged, neg, it = self._cg(fact, sc_rhs)
        self.cg_iterations.append(it)
        rhs2 = blocks - _border_T_apply_local(fact.border_loc, fact.row_idx, y)
        x = _winv_apply_batched(fact.block_W, fact.block_d, fact.block_s, rhs2).to(blocks.dtype)
        if self.axis is not None:
            x = self.axis.gather_blocks(x, nb)[:n]
        solve_status = torch.where(
            neg,
            int(LinearSolverStatus.singular),
            torch.where(converged, int(LinearSolverStatus.successful), int(LinearSolverStatus.error)),
        ).to(torch.int32)
        return BlockRhs(blocks=x, coupling=y), torch.maximum(fact.status, solve_status)

    def solve(self, fact: PCGSchurFactor, rhs: BlockRhs) -> BlockRhs:
        """Back solve.  A failed CG (no convergence or negative curvature)
        NaN-poisons the solution so it is never taken as a step; use
        :meth:`solve_with_status` for an inspectable status."""
        sol, status = self.solve_with_status(fact, rhs)
        poison = torch.where(status <= int(LinearSolverStatus.warning), 0.0, torch.nan)
        return BlockRhs(
            blocks=sol.blocks + poison.to(sol.blocks.dtype),
            coupling=sol.coupling + poison.to(sol.coupling.dtype),
        )

    def inertia(self, fact: PCGSchurFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: PCGSchurFactor) -> torch.Tensor:
        return fact.status
