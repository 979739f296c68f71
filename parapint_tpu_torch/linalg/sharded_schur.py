"""Sharded Schur-complement solver over ``torch.distributed`` (counterpart of
``parapint_tpu.linalg.sharded_schur``).

The JAX package shards the block axis of the KKT over a mesh axis inside
``shard_map``; the port runs the same decomposition as SPMD ranks:

- rank r of P owns the contiguous global blocks of
  ``BlockAxis.local_range`` (ceil(N/P) each) of the KKT padded to a
  multiple of P blocks (``pad_block_count``: masked identity blocks),
  factors only those, and keeps only their factors;
- the Schur-complement contributions, the coupling part of every solve and
  refinement probe, the inertia and the status are all-reduced over the
  mesh's process group (``psum`` / ``pmax`` in the JAX package); in tile
  form (time chain + ``BlockTridiagSolver``) the reduction carries
  O(nc ns) numbers instead of the dense O(nc^2);
- the Schur complement is factored redundantly on every rank, as the
  reference's MPI solver does;
- ``solve`` returns the full, replicated solution: each rank's block rows
  are gathered by an all-reduce of zero-filled tensors, which is exact.

The KKT and rhs may be whole (the same on every rank; the solver takes
its rank's blocks) or rank-local: an interface built with the same mesh
evaluates and assembles only the rank's blocks, and hands a KKT with
``global_blocks`` set and an rhs of the rank's block rows.

Every value a branch of the driver reads (inertia, status, the refinement
probe's flag) is all-reduced, so every rank takes every branch the same way.
"""

from typing import Optional


from parapint_tpu_torch.linalg.schur import (
    BlockRhs,
    SchurComplementSolver,
    SchurFactor,
    pad_block_count,
    shard_kkt,
)
from parapint_tpu_torch.parallel.mesh import BlockAxis
from parapint_tpu_torch.utils.profile import span, spanned


class ShardedSchurComplementSolver(SchurComplementSolver):
    """Schur-complement solver with the block axis sharded over the ranks of
    a mesh axis.

    ``mesh``: a 1-D ``DeviceMesh`` (``parallel.mesh.block_mesh``) holding
    this rank; ``axis_name``: its axis.  The other parameters are those of
    :class:`SchurComplementSolver`, without the bf16 auto-gate (the JAX
    sharded solver has none).  The KKT passed to ``numeric`` and the rhs
    passed to ``solve`` are either the full ones, the same on every rank, or
    this rank's part (from an interface built with the same mesh: a KKT
    with ``global_blocks`` set, its block range that of
    ``BlockAxis.local_range``, and the rhs rows of those blocks); the solve
    returns the full solution either way.  The factor holds this rank's
    blocks and ``n_numeric`` / ``n_solves`` count this rank's work.  The factorization is the serial solver's, run over
    this rank's blocks (``SchurComplementSolver._numeric``); so
    ``apply_dtype`` also casts a packed-LDL^T factor
    (``explicit_inverse=False``), as the serial solvers do (the JAX sharded
    solver keeps that factor in the KKT's dtype).
    """

    def __init__(
        self,
        mesh,
        axis_name: str = "blocks",
        schur_complement_solver=None,
        block_size: int = 128,
        zero_tol: float = 0.0,
        explicit_inverse: bool = False,
        refine_steps: Optional[int] = None,
        factor_dtype=None,
        apply_dtype=None,
        refine_trigger: float = 1e-5,
        refine_max_passes: int = 8,
        w_store_dtype=None,
    ):
        super().__init__(
            schur_complement_solver=schur_complement_solver, block_size=block_size,
            zero_tol=zero_tol, explicit_inverse=explicit_inverse, refine_steps=refine_steps,
            factor_dtype=factor_dtype, apply_dtype=apply_dtype,
            refine_trigger=refine_trigger, refine_max_passes=refine_max_passes,
            w_store_dtype=w_store_dtype, w_auto_gate=False,
        )
        self.mesh = mesh
        self.axis_name = axis_name
        self.axis = BlockAxis.of(mesh, axis_name)
        self.group = self.axis.group
        self.n_shards = self.axis.size

    @spanned("sc_solver.numeric")
    def numeric(self, kkt) -> SchurFactor:
        self.n_numeric += 1
        # any block count: masked identity blocks pad it to a multiple of
        # the rank count
        return self._numeric(*shard_kkt(kkt, self.axis, pad_block_count))

    def _solve_refined(self, fact: SchurFactor, rhs: BlockRhs):
        """(full replicated solution, refined_ok): this rank's rows of the
        (padded) rhs through the serial solve and refinement, whose coupling
        sums and probe norms run over the group, then the block rows
        gathered from every rank."""
        n_local = (fact.block_W if fact.block_W is not None else fact.block_LD).shape[0]
        nb = n_local * self.n_shards
        rank_local = fact.global_blocks is not None
        n = fact.global_blocks if rank_local else rhs.blocks.shape[0]
        local = BlockRhs(self.axis.local_rows(rhs.blocks, nb, rank_local), rhs.coupling)
        x, ok = super()._solve_refined(fact, local)
        with span("sc_solver.communicate"):
            xb = self.axis.gather_blocks(x.blocks, nb)[:n]
        return BlockRhs(blocks=xb, coupling=x.coupling), ok
