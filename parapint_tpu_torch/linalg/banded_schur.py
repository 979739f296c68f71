"""Schur-complement solvers with BANDED per-block factorization (counterpart
of ``parapint_tpu.linalg.banded_schur``: the serial
``BandedSchurComplementSolver`` and, over ``torch.distributed`` ranks,
``ShardedBandedSchurComplementSolver``).

Under the host-computed bandwidth-reducing, constraint-after-its-variables
ordering (``interfaces/banded_symbolic.py``) each per-block KKT is banded with
half-bandwidth p; tiled into ts x ts tiles (ts >= p) it is block-tridiagonal
and factors by a batched block-Thomas LDL^T sweep over the m = nk/ts tiles.
Inertia is exact by Haynsworth additivity over the tile Schur complements.
The coupling system is formed from V = K^{-1} A^T and, for the time-chain
topology, factored by cyclic reduction (``linalg/tridiag.py``).  Solves fold
the second Thomas sweep into one GEMM against V and refine adaptively in the
working precision.  The sharded solver runs the Thomas sweep of each rank's
own blocks and all-reduces what couples them, as the dense sharded solver
(``linalg/sharded_schur.py``) does.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.dense import DenseLDLSolver
from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu_torch.linalg.schur import (
    BlockRhs,
    _assemble_sc,
    _border_apply_chain,
    _border_apply_local,
    _border_T_apply_chain,
    _border_T_apply_local,
    _border_y_loc_chain,
    _chain_border_ok,
    _chain_tiles,
    _factor_blocks_winv,
    _tile_sc,
    gather_kkt,
    gather_rhs,
    serial_factor,
    shard_kkt,
)
from parapint_tpu_torch.linalg.tridiag import BlockTridiagSolver, _winv_to_inverse
from parapint_tpu_torch.ops.banded import pad_sym_band, sym_band_to_tridiag_tiles
from parapint_tpu_torch.parallel.mesh import BlockAxis, all_reduce_max, all_reduce_sum

@dataclasses.dataclass(frozen=True)
class BandedLocalBlockKKT:
    """Block-bordered KKT whose diagonal blocks are symmetric banded
    matrices in a precomputed permutation.

    sym_bands:  (N, p+1, nk) lower bands of the PERMUTED per-block KKTs
    border_loc: (N, L, nk) local border rows with PERMUTED columns
    row_idx:    (N, L) global SC row of each local row (nc = dump)
    q:          (nc, nc) coupling block
    mask:       (N,) 1.0 for logical blocks
    perm/iperm: (nk,) permutation (permuted index i holds original perm[i])
    assembly:   SC topology ("chain" / "scatter" / "shared")
    global_blocks / block_offset / axis: a rank's part, as for ``LocalBlockKKT``
    """

    sym_bands: torch.Tensor
    border_loc: torch.Tensor
    row_idx: torch.Tensor
    q: torch.Tensor
    mask: torch.Tensor
    perm: torch.Tensor
    iperm: torch.Tensor
    assembly: str = "scatter"
    global_blocks: Optional[int] = None
    block_offset: int = 0
    axis: Optional[BlockAxis] = None


@dataclasses.dataclass(frozen=True)
class ThomasFactor:
    """Block-Thomas factorization of N block-tridiagonal matrices: explicit
    inverses of the sequentially Schur-complemented diagonal tiles, plus the
    original superdiagonal tiles."""

    tinv: torch.Tensor  # (N, m, ts, ts)
    upper: torch.Tensor  # (N, m-1, ts, ts)
    inertia: torch.Tensor  # (3,) int32
    status: torch.Tensor  # () int32


def thomas_factor_batched(
    diag_tiles: torch.Tensor,
    upper_tiles: torch.Tensor,
    mask: torch.Tensor,
    zero_tol: float = 0.0,
    factor_dtype=None,
    tile_block_size: int = 64,
) -> ThomasFactor:
    """Factor N block-tridiagonal matrices (diag (N, m, ts, ts), upper
    (N, m-1, ts, ts)) by a sequential tile sweep: each step factors the
    Schur-complemented diagonal tile and carries U^T D'^{-1} U forward.
    Each tile factors in ``factor_dtype`` (None: the tiles' dtype) as
    panels of ``tile_block_size`` columns (a 128-wide tile is two 64-wide
    panels at the default, one at 128); ``zero_tol`` as for
    ``SchurComplementSolver``."""
    N, m, ts, _ = diag_tiles.shape
    dt = diag_tiles.dtype
    C = torch.zeros((N, ts, ts), dtype=dt, device=diag_tiles.device)
    tinvs, inertia, status = [], 0, None
    for i in range(m):
        W, d, s, inert, stat = _factor_blocks_winv(
            diag_tiles[:, i] - C, mask, tile_block_size, zero_tol, factor_dtype
        )
        tinv = _winv_to_inverse(W, d, s, ts).to(dt)
        tinvs.append(tinv)
        inertia = inertia + inert
        status = stat if status is None else torch.maximum(status, stat)
        if i < m - 1:
            U = upper_tiles[:, i]
            C = U.transpose(1, 2) @ (tinv @ U)
    return ThomasFactor(
        tinv=torch.stack(tinvs, dim=1),
        upper=upper_tiles,
        inertia=inertia,
        status=status,
    )


def thomas_solve_batched(fact: ThomasFactor, r: torch.Tensor) -> torch.Tensor:
    """Solve the N block-tridiagonal systems; r (N, m, ts) or (N, m, ts, k).

    Forward sweep  z_i = r_i - U_{i-1}^T Tinv_{i-1} z_{i-1},
    backward sweep x_i = Tinv_i z_i - Tinv_i U_i x_{i+1}.
    """
    vec = r.dim() == 3
    if vec:
        r = r[..., None]
    m = r.shape[1]
    dt = r.dtype
    tinv = fact.tinv.to(dt)
    upper = fact.upper.to(dt)
    tz = []
    for i in range(m):
        z = r[:, i]
        if i:
            z = z - upper[:, i - 1].transpose(1, 2) @ tz[-1]
        tz.append(tinv[:, i] @ z)
    xs = [None] * m
    x = tz[m - 1]
    xs[m - 1] = x
    for i in range(m - 2, -1, -1):
        x = tz[i] - tinv[:, i] @ (upper[:, i] @ x)
        xs[i] = x
    out = torch.stack(xs, dim=1)
    return out[..., 0] if vec else out


@dataclasses.dataclass(frozen=True)
class BandedSchurFactor:
    """Factorization state of :class:`BandedSchurComplementSolver`."""

    thomas: ThomasFactor
    q: torch.Tensor
    border_loc: torch.Tensor  # (N, L, nk) permuted columns
    row_idx: torch.Tensor
    perm: torch.Tensor
    iperm: torch.Tensor
    sc_fact: object
    inertia: torch.Tensor
    status: torch.Tensor
    nk: int
    nc: int
    ts: int
    assembly: str = "scatter"
    diag_t: Optional[torch.Tensor] = None  # (N, m, ts, ts) tile store for the refinement matvec
    upper_t: Optional[torch.Tensor] = None  # (N, m-1, ts, ts)
    v_border: Optional[torch.Tensor] = None  # (N, nk, L) V = K^{-1} A^T
    norm2: Optional[torch.Tensor] = None  # ||K||_F^2 of the full block-bordered system
    # first global block of these blocks (a sharded solver's rank holds its
    # own blocks only; None = 0)
    group_offset: Optional[int] = None
    # the KKT's global_blocks (a rank-local KKT: the rhs is rank-local too)
    global_blocks: Optional[int] = None
    # a serial solver's factor of a gathered rank-local KKT: the axis over
    # which each rhs is gathered (``schur.gather_rhs``)
    rhs_axis: Optional[BlockAxis] = None


def tridiag_tiles_matvec(diag_t, upper_t, x):
    """Batched block-tridiagonal matvec from the Thomas tile store:
    y_g = D_g x_g + U_g x_{g+1} + U_{g-1}^T x_{g-1}; x (N, m, ts) or
    (N, m, ts, k)."""
    vec = x.dim() == 3
    if vec:
        x = x[..., None]
    dt = x.dtype
    y = diag_t.to(dt) @ x
    if upper_t.shape[1]:
        u = upper_t.to(dt)
        y[:, :-1] += u @ x[:, 1:]
        y[:, 1:] += u.transpose(-1, -2) @ x[:, :-1]
    return y[..., 0] if vec else y


def banded_tiles(sym_bands: torch.Tensor, tile_size=None):
    """(diag_tiles, upper_tiles, ts, nk_pad) from a batched band store
    (N, p+1, nk); pads nk to a tile multiple with identity rows."""
    N, pp1, nk = sym_bands.shape
    p = pp1 - 1
    ts = tile_size if tile_size is not None else max(8, p)
    if ts < p:
        raise ValueError(f"tile_size {ts} < half-bandwidth {p}")
    bands, n_extra = pad_sym_band(sym_bands, ts)
    diag_t, upper_t = sym_band_to_tridiag_tiles(bands, ts)
    return diag_t, upper_t, ts, nk + n_extra


class BandedSchurComplementSolver(LinearSolver):
    """Schur-complement solver with banded per-block factorization.

    Consumes a :class:`BandedLocalBlockKKT`; rhs and solutions use the
    ORIGINAL variable ordering (:class:`BlockRhs`), the permutation is
    applied internally by index gathers.  The coupling solver defaults to
    ``DenseLDLSolver(zero_tol=zero_tol, refine_steps=0)``.  ``tile_size``:
    the Thomas tiles' width (None: max(8, p)); ``zero_tol``,
    ``factor_dtype`` and ``tile_block_size``: as for
    :func:`thomas_factor_batched`; ``refine_steps``: None = adaptive
    refinement (``refine_trigger`` and ``refine_max_passes`` as for
    ``SchurComplementSolver``), an int = that many fixed passes;
    ``device``: the device the solver is built for (its KKTs must lie
    there; None: any).  ``n_numeric`` counts numeric factorizations.  A rank-local KKT (an interface built with ``mesh=``)
    and the rhs of its solves are gathered whole on every rank
    (``schur.gather_kkt``), as for ``SchurComplementSolver``.
    """

    # process group over which a sharded solver sums the coupling parts of
    # its solves and refinement probes (None: serial)
    group = None

    def __init__(
        self,
        schur_complement_solver: Optional[LinearSolver] = None,
        tile_size: Optional[int] = None,
        zero_tol: float = 0.0,
        factor_dtype=None,
        refine_steps: Optional[int] = None,
        refine_trigger: float = 1e-5,
        refine_max_passes: int = 8,
        tile_block_size: int = 64,
        device=None,
    ):
        self.sc_solver = (
            schur_complement_solver
            if schur_complement_solver is not None
            else DenseLDLSolver(zero_tol=zero_tol, refine_steps=0)
        )
        self.tile_size = tile_size
        self.zero_tol = zero_tol
        self.factor_dtype = factor_dtype
        self.adaptive_refine = refine_steps is None
        self.refine_steps = 1 if refine_steps is None else refine_steps
        self.refine_trigger = refine_trigger
        self.refine_max_passes = refine_max_passes
        self.tile_block_size = tile_block_size
        self.device = None if device is None else torch.device(device)
        self.n_numeric = 0

    # -- factorization ------------------------------------------------------

    def symbolic(self, kkt: BandedLocalBlockKKT) -> LinearSolverResults:
        N, pp1, nk = kkt.sym_bands.shape
        if kkt.border_loc.shape[0] != N or kkt.border_loc.shape[2] != nk:
            raise ValueError(
                f"border_loc shape {tuple(kkt.border_loc.shape)} inconsistent "
                f"with sym_bands {tuple(kkt.sym_bands.shape)}"
            )
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def _use_tridiag_sc(self, kkt) -> bool:
        if not isinstance(self.sc_solver, BlockTridiagSolver):
            return False
        if kkt.assembly != "chain":
            return False
        ns = kkt.border_loc.shape[1] // 2
        nc = kkt.q.shape[-1]
        return ns > 0 and nc > 0 and nc % ns == 0

    def _check_device(self, kkt: BandedLocalBlockKKT):
        dev = kkt.sym_bands.device
        if self.device is not None and (
            dev.type != self.device.type
            or self.device.index not in (None, dev.index)
        ):
            raise ValueError(f"KKT on {dev}, solver built for {self.device}")

    def numeric(self, kkt: BandedLocalBlockKKT) -> BandedSchurFactor:
        self._check_device(kkt)
        self.n_numeric += 1
        whole = gather_kkt(kkt)
        return serial_factor(self._numeric(whole, 0, whole.sym_bands.shape[0]), kkt)

    def _numeric(self, kkt: BandedLocalBlockKKT, lo: int, hi: int) -> BandedSchurFactor:
        """Factor the global blocks [lo, hi) of ``kkt`` (held from its
        ``block_offset`` on); what couples them to the other blocks is
        summed over the solver's group."""
        nk = kkt.sym_bands.shape[-1]
        nc = kkt.q.shape[-1]
        ns = kkt.border_loc.shape[1] // 2
        rows = slice(lo - kkt.block_offset, hi - kkt.block_offset)
        mask = kkt.mask[rows]
        A = kkt.border_loc[rows]
        row_idx = kkt.row_idx[rows]
        N, L = A.shape[:2]
        with record_function("banded_sc.factor_blocks"):
            diag_t, upper_t, ts, nk_pad = banded_tiles(kkt.sym_bands[rows], self.tile_size)
            thomas = thomas_factor_batched(
                diag_t, upper_t, mask, self.zero_tol, self.factor_dtype, self.tile_block_size
            )
        with record_function("banded_sc.form_sc"):
            # V = K^{-1} A^T over the L border columns (multi-RHS sweep)
            At = A.transpose(1, 2).to(diag_t.dtype)  # (N, nk, L)
            if nk_pad != nk:
                At = torch.nn.functional.pad(At, (0, 0, 0, nk_pad - nk))
            V = thomas_solve_batched(thomas, At.reshape(N, nk_pad // ts, ts, L))
            V = V.reshape(N, nk_pad, L)[:, :nk]
            S_loc = A.to(V.dtype) @ V
            S_loc = S_loc * mask[:, None, None].to(V.dtype)
        f32 = torch.float32
        with record_function("banded_sc.communicate"):
            q = kkt.q.to(V.dtype)
            if self._use_tridiag_sc(kkt):
                dt_c, ut_full = _chain_tiles(S_loc, nc, lo)
                sc = _tile_sc(q, ns, dt_c, ut_full, self.group)
            else:
                sc = q - all_reduce_sum(_assemble_sc(S_loc, row_idx, nc, kkt.assembly, lo), self.group)
            norm2 = all_reduce_sum(
                diag_t.to(f32).square().sum()
                + 2.0 * upper_t.to(f32).square().sum()
                + 2.0 * A.to(f32).square().sum(),
                self.group,
            ) + kkt.q.to(f32).square().sum()
            # the identity rows that pad each block to whole tiles contribute
            # +1 pivots each: taken off per rank, before the sum
            pad_pos = (nk_pad - nk) * mask.sum().to(torch.int32)
            blk_inertia = all_reduce_sum(
                thomas.inertia - torch.stack([pad_pos, 0 * pad_pos, 0 * pad_pos]).to(torch.int32),
                self.group,
            )
            blk_status = all_reduce_max(thomas.status, self.group)
        with record_function("banded_sc.factor_sc"):
            sc_fact = self.sc_solver.numeric(sc)
        sc_pos, sc_neg, sc_zero = self.sc_solver.inertia(sc_fact)
        inertia = blk_inertia + torch.stack([sc_pos, sc_neg, sc_zero]).to(torch.int32)
        status = torch.maximum(blk_status, self.sc_solver.status(sc_fact))
        return BandedSchurFactor(
            thomas=thomas,
            q=kkt.q,
            border_loc=A,
            row_idx=row_idx,
            perm=kkt.perm,
            iperm=kkt.iperm,
            sc_fact=sc_fact,
            inertia=inertia,
            status=status,
            nk=nk,
            nc=nc,
            ts=ts,
            assembly=kkt.assembly,
            diag_t=diag_t,
            upper_t=upper_t,
            v_border=V,
            norm2=norm2,
            group_offset=lo,
            global_blocks=kkt.global_blocks,
        )

    # -- solves -------------------------------------------------------------

    def _apply_blocks(self, fact: BandedSchurFactor, b: torch.Tensor):
        """K_b^{-1} b_b per block; b (N, nk) PERMUTED -> (N, nk) permuted."""
        N, nk = b.shape
        ts = fact.ts
        nk_pad = -(-nk // ts) * ts
        bp = b.to(fact.thomas.tinv.dtype)
        if nk_pad != nk:
            bp = torch.nn.functional.pad(bp, (0, nk_pad - nk))
        x = thomas_solve_batched(fact.thomas, bp.reshape(N, nk_pad // ts, ts))
        return x.reshape(N, nk_pad)[:, :nk]

    def _solve_once(self, fact: BandedSchurFactor, rhs: BlockRhs) -> BlockRhs:
        """One SC solve in PERMUTED block coordinates."""
        chain = _chain_border_ok(fact.assembly, fact.border_loc, fact.nc)
        off = fact.group_offset
        v = self._apply_blocks(fact, rhs.blocks)
        if chain:
            contrib = _border_apply_chain(fact.border_loc, v, fact.nc, off)
        else:
            contrib = _border_apply_local(fact.border_loc, fact.row_idx, v, fact.nc, fact.assembly)
        sc_rhs = rhs.coupling - all_reduce_sum(contrib, self.group)
        # coupling solve at the factor precision; the refinement loop owns
        # the working-precision accuracy
        fdt = fact.thomas.tinv.dtype
        y = self.sc_solver.solve(fact.sc_fact, sc_rhs.to(fdt))
        # x = K^{-1} rhs - V y_loc: the second Thomas sweep is one GEMM
        Nb, L = fact.border_loc.shape[:2]
        yv = y.to(fact.v_border.dtype)
        if chain:
            y_loc = _border_y_loc_chain(yv, Nb, L, off)
        else:
            y_loc = torch.cat([yv, yv.new_zeros(1)])[fact.row_idx.long()]
        x = v - (fact.v_border @ y_loc[:, :, None])[..., 0].to(v.dtype)
        return BlockRhs(blocks=x, coupling=y)

    def _kkt_matvec(self, fact: BandedSchurFactor, x: BlockRhs, dtype=None) -> BlockRhs:
        """K @ x (permuted block coordinates) for iterative refinement; the
        coupling part is summed over the solver's group."""
        q = fact.q
        xb, xc = x.blocks, x.coupling
        border_loc = fact.border_loc
        if dtype is not None:
            q, xb, xc, border_loc = (t.to(dtype) for t in (q, xb, xc, border_loc))
        N, nk = xb.shape
        ts = fact.ts
        nk_pad = fact.diag_t.shape[1] * ts
        xp = torch.nn.functional.pad(xb, (0, nk_pad - nk)) if nk_pad != nk else xb
        bx = tridiag_tiles_matvec(
            fact.diag_t, fact.upper_t, xp.reshape(N, nk_pad // ts, ts)
        ).reshape(N, nk_pad)[:, :nk]
        if _chain_border_ok(fact.assembly, border_loc, fact.nc):
            bx = bx + _border_T_apply_chain(border_loc, xc, fact.group_offset)
            cy = _border_apply_chain(border_loc, xb, fact.nc, fact.group_offset)
        else:
            bx = bx + _border_T_apply_local(border_loc, fact.row_idx, xc)
            cy = _border_apply_local(border_loc, fact.row_idx, xb, fact.nc, fact.assembly)
        cy = all_reduce_sum(cy, self.group)
        cy = cy + (q.to(cy.dtype) @ xc.to(cy.dtype))
        return BlockRhs(blocks=bx, coupling=cy)

    def _refine_probe(self, fact, rhs, x, trigger) -> torch.Tensor:
        """Device bool: does the f32 residual of ``x`` still exceed
        max(trigger * ||rhs||, noise floor)?  The floor is
        (32 eps_f32)^2 ||K||_F^2 ||x||^2 (norm bound of |K||x|).  The block
        norms are summed over the solver's group, the coupling part (the
        same on every rank) added once."""
        f32 = torch.float32
        kx = self._kkt_matvec(fact, x, dtype=f32)
        wd = rhs.blocks.dtype
        rb = rhs.blocks.to(f32).to(wd) - kx.blocks.to(wd)
        rc = rhs.coupling.to(f32).to(wd) - kx.coupling.to(wd)
        rb2, bb2, xb2 = all_reduce_sum(torch.stack([
            (rb * rb).sum(), rhs.blocks.to(wd).square().sum(), x.blocks.to(wd).square().sum(),
        ]), self.group)
        rn2 = rb2 + (rc * rc).sum()
        bn2 = bb2 + rhs.coupling.to(wd).square().sum()
        fn2 = fact.norm2.to(wd) * (xb2 + x.coupling.to(wd).square().sum())
        eps = 32.0 * float(np.finfo(np.float32).eps)
        floor2 = (eps * eps) * fn2
        thresh = torch.maximum((trigger * trigger) * torch.clamp(bn2, min=1.0), floor2)
        return ~torch.isfinite(rn2) | (rn2 > thresh)

    def _solve_refined(self, fact: BandedSchurFactor, rhs: BlockRhs):
        # permute the rhs blocks into the banded ordering once (plain gather)
        rp = BlockRhs(blocks=rhs.blocks[:, fact.perm], coupling=rhs.coupling)
        x, ok = self._refine(fact, rp)
        return BlockRhs(blocks=x.blocks[:, fact.iperm], coupling=x.coupling), ok

    def _refine(self, fact: BandedSchurFactor, rp: BlockRhs):
        """(solution, refined_ok) in PERMUTED block coordinates: one solve,
        then adaptive refinement (a host loop, one flag read per pass) or
        ``refine_steps`` fixed passes."""

        def up(b: BlockRhs) -> BlockRhs:
            return BlockRhs(
                blocks=b.blocks.to(rp.blocks.dtype),
                coupling=b.coupling.to(rp.coupling.dtype),
            )

        def refine_pass(x: BlockRhs) -> BlockRhs:
            kx = self._kkt_matvec(fact, x)
            r = BlockRhs(blocks=rp.blocks - kx.blocks, coupling=rp.coupling - kx.coupling)
            dx = up(self._solve_once(fact, r))
            return BlockRhs(blocks=x.blocks + dx.blocks, coupling=x.coupling + dx.coupling)

        x = up(self._solve_once(fact, rp))
        if not self.adaptive_refine:
            for _ in range(self.refine_steps):
                x = refine_pass(x)
            return x, torch.ones((), dtype=torch.bool, device=x.blocks.device)
        need = self._refine_probe(fact, rp, x, self.refine_trigger)
        passes = 0
        while passes < self.refine_max_passes and bool(need.item()):
            x = refine_pass(x)
            passes += 1
            need = self._refine_probe(fact, rp, x, self.refine_trigger)
        return x, ~need

    def solve(self, fact: BandedSchurFactor, rhs: BlockRhs) -> BlockRhs:
        return self._solve_refined(fact, gather_rhs(fact, rhs))[0]

    def solve_with_status(self, fact: BandedSchurFactor, rhs: BlockRhs):
        x, ok = self._solve_refined(fact, gather_rhs(fact, rhs))
        bad = torch.where(
            ok, int(LinearSolverStatus.successful), int(LinearSolverStatus.error)
        ).to(torch.int32)
        return x, torch.maximum(self.status(fact), bad)

    def inertia(self, fact: BandedSchurFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: BandedSchurFactor) -> torch.Tensor:
        return fact.status


def pad_banded_block_count(kkt: BandedLocalBlockKKT, multiple: int) -> BandedLocalBlockKKT:
    """Pad a BandedLocalBlockKKT to a multiple of ``multiple`` blocks with
    masked identity blocks (band 0 = 1, zero borders, local rows at the dump
    index); a chain assembly falls back to scatter, as in
    :func:`~parapint_tpu_torch.linalg.schur.pad_block_count`."""
    N, pp1, nk = kkt.sym_bands.shape
    rem = (-N) % multiple
    if rem == 0:
        return kkt
    pad = kkt.sym_bands.new_zeros((rem, pp1, nk))
    pad[:, 0, :] = 1.0
    L = kkt.border_loc.shape[1]
    nc = kkt.q.shape[-1]
    return dataclasses.replace(
        kkt,
        sym_bands=torch.cat([kkt.sym_bands, pad]),
        border_loc=torch.cat([kkt.border_loc, kkt.border_loc.new_zeros((rem, L, nk))]),
        row_idx=torch.cat([kkt.row_idx, kkt.row_idx.new_full((rem, L), nc)]),
        mask=torch.cat([kkt.mask, kkt.mask.new_zeros(rem)]),
        assembly="scatter" if kkt.assembly == "chain" else kkt.assembly,
    )


class ShardedBandedSchurComplementSolver(BandedSchurComplementSolver):
    """Banded per-block factorization with the block axis sharded over the
    ranks of a mesh axis: each rank runs the block-Thomas sweep of its own
    contiguous blocks of the KKT padded to a multiple of the rank count
    (:func:`pad_banded_block_count`), the Schur complement is all-reduced
    (in tile form for the time chain with ``BlockTridiagSolver``) and
    factored on every rank, and ``solve`` returns the full solution on
    every rank.  The KKT and rhs are the full ones, the same on every rank,
    or this rank's part from an interface built with the same mesh (as for
    ``ShardedSchurComplementSolver``).  Keywords as for
    :class:`BandedSchurComplementSolver`; the counts are this rank's.
    """

    def __init__(self, mesh, axis_name: str = "blocks", **kw):
        super().__init__(**kw)
        self.mesh = mesh
        self.axis_name = axis_name
        self.axis = BlockAxis.of(mesh, axis_name)
        self.group = self.axis.group
        self.n_shards = self.axis.size

    def numeric(self, kkt: BandedLocalBlockKKT) -> BandedSchurFactor:
        self._check_device(kkt)
        self.n_numeric += 1
        return self._numeric(*shard_kkt(kkt, self.axis, pad_banded_block_count))

    def _solve_refined(self, fact: BandedSchurFactor, rhs: BlockRhs):
        nb = fact.v_border.shape[0] * self.n_shards
        rank_local = fact.global_blocks is not None
        n = fact.global_blocks if rank_local else rhs.blocks.shape[0]
        rp = self.axis.local_rows(rhs.blocks[:, fact.perm], nb, rank_local)
        x, ok = self._refine(fact, BlockRhs(blocks=rp, coupling=rhs.coupling))
        with record_function("banded_sc.communicate"):
            xb = self.axis.gather_blocks(x.blocks, nb)[:n]
        return BlockRhs(blocks=xb[:, fact.iperm], coupling=x.coupling), ok
