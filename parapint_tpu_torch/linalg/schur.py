"""Explicit Schur-complement solver for block-bordered-diagonal KKT systems
(counterpart of ``parapint_tpu.linalg.schur``).

Solves the symmetric system

    [ K_0            A_0^T ] [x_0]   [b_0]
    [      ...        ...  ] [...] = [...]
    [          K_N-1 A_N-1^T] [x_N-1] [b_N-1]
    [ A_0 ... A_N-1    Q   ] [y  ]   [b_c]

via S = Q - sum_i A_i K_i^{-1} A_i^T: all diagonal blocks are factored in one
batched LDL^T, S is formed with batched matmuls and factored by a coupling
solver, and x_i = K_i^{-1}(b_i - A_i^T y) with
y = S^{-1}(b_c - sum_i A_i K_i^{-1} b_i).

Borders are dense (``BlockKKT``: (N, nc, nk)) or block-local
(``LocalBlockKKT``: an (L, nk) strip per block whose rows map to global
coupling rows through ``row_idx``, dump index nc for masked rows, or
positionally for the time-chain topology: rows [0, ns) couple group i-1,
rows [ns, 2ns) group i).  Blocks are uniform; a per-block ``mask`` marks
padding blocks, which factor as identities and are excluded from the
inertia.

Two block factorizations: packed LDL^T (``explicit_inverse=False``, panels on
the ``ldl_panels_slab`` kernel entry) and the W form (K_i^{-1} =
s W^T D^{-1} W s of the Ruiz-equilibrated blocks, panels on
``ldl_panels_slab_winv``, applies on the ``winv_apply_fused`` kernel).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.dense import DenseLDLSolver
from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu_torch.ops.ldl import (
    ldl_factor_batched,
    ldl_factor_winv_batched,
    ldl_inertia,
    ldl_solve,
    ldl_winv,
    ruiz_scale,
)
from parapint_tpu_torch.ops.ordered_scatter import scatter_add_pairs, scatter_add_rows
from parapint_tpu_torch.ops.winv_apply import winv_apply_fused, winv_apply_plain
from parapint_tpu_torch.parallel.mesh import BlockAxis, all_reduce_max, all_reduce_sum

@dataclasses.dataclass(frozen=True)
class BlockRhs:
    """Right-hand side / solution: blocks (N, nk), coupling (nc,)."""

    blocks: torch.Tensor
    coupling: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BlockKKT:
    """Dense borders: diag (N, nk, nk), border (N, nc, nk), q (nc, nc),
    mask (N,) (1.0 for logical blocks, 0.0 for padding)."""

    diag: torch.Tensor
    border: torch.Tensor
    q: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def make(diag, border, q, mask=None) -> "BlockKKT":
        if mask is None:
            mask = torch.ones(diag.shape[0], dtype=diag.dtype, device=diag.device)
        return BlockKKT(diag=diag, border=border, q=q, mask=mask)


@dataclasses.dataclass(frozen=True)
class LocalBlockKKT:
    """Block-local borders: diag (N, nk, nk), border_loc (N, L, nk) (masked
    rows all-zero), row_idx (N, L) global coupling row of each local row
    (nc = dump), q (nc, nc), mask (N,).  ``assembly`` is the SC topology:
    "scatter" (any), "shared" (row_idx == arange(L) for every block) or
    "chain" (L = 2 ns, block i couples groups i-1 and i).

    ``global_blocks`` None: the KKT holds every block.  Else it is one
    rank's part (an interface built with a mesh): the whole problem has
    ``global_blocks`` blocks and this KKT holds its blocks
    [block_offset, block_offset + N), the rank's range of
    ``BlockAxis.local_range`` of ``axis``, the mesh axis it came from.  A
    sharded solver over that axis factors the part as it is; a serial
    solver gathers it whole first (:func:`gather_kkt`)."""

    diag: torch.Tensor
    border_loc: torch.Tensor
    row_idx: torch.Tensor
    q: torch.Tensor
    mask: torch.Tensor
    assembly: str = "scatter"
    global_blocks: Optional[int] = None
    block_offset: int = 0
    axis: Optional[BlockAxis] = None

    @staticmethod
    def make(diag, border_loc, row_idx, q, mask=None, assembly="scatter", global_blocks=None,
             block_offset=0, axis=None) -> "LocalBlockKKT":
        if mask is None:
            mask = torch.ones(diag.shape[0], dtype=diag.dtype, device=diag.device)
        return LocalBlockKKT(
            diag=diag,
            border_loc=border_loc,
            row_idx=torch.as_tensor(row_idx, dtype=torch.int64, device=diag.device),
            q=q,
            mask=mask,
            assembly=assembly,
            global_blocks=global_blocks,
            block_offset=block_offset,
            axis=axis,
        )


@dataclasses.dataclass(frozen=True)
class SchurFactor:
    block_LD: Optional[torch.Tensor]  # (N, npad, npad) packed factors (LD mode)
    block_W: Optional[torch.Tensor]  # (N, npad, npad) L^{-1}, W mode (maybe bf16)
    block_d: Optional[torch.Tensor]  # (N, npad) pivots, W mode
    block_s: Optional[torch.Tensor]  # (N, nk) Ruiz scaling, W mode
    diag: Optional[torch.Tensor]  # original blocks, kept for refinement
    q: Optional[torch.Tensor]  # original coupling block, kept for refinement
    border: Optional[torch.Tensor]  # (N, nc, nk), dense-border path
    border_loc: Optional[torch.Tensor]  # (N, L, nk), local-border path
    row_idx: Optional[torch.Tensor]  # (N, L), local-border path
    sc_fact: object  # factorization of the coupling solver
    inertia: torch.Tensor  # (3,) int32, blocks + SC
    status: torch.Tensor  # () int32
    nk: int
    nc: int
    assembly: str = "scatter"
    # full-precision W kept beside a reduced-storage block_W when the bf16
    # auto-gate is on: a stalled adaptive refinement retries with it
    block_W_hi: Optional[torch.Tensor] = None
    # first global block (= coupling group) of these blocks: nonzero on the
    # ranks of a sharded solver, whose factor holds their own blocks only
    # (None = 0)
    group_offset: Optional[int] = None
    # the KKT's global_blocks: set when it was rank-local, so the rhs of a
    # solve is rank-local too
    global_blocks: Optional[int] = None
    # set when a serial solver gathered a rank-local KKT whole: the axis
    # over which each rank-local rhs is gathered (``gather_rhs``)
    rhs_axis: Optional[BlockAxis] = None


def pad_block_count(kkt, multiple: int):
    """Pad a Block/LocalBlockKKT to a multiple of ``multiple`` blocks with
    masked identity blocks and zero borders (local rows at the dump index).
    A padded chain KKT falls back to ``assembly="scatter"``: the chain path
    places contributions by block position and padding blocks past the last
    group would land on real groups."""
    N = kkt.diag.shape[0]
    rem = (-N) % multiple
    if rem == 0:
        return kkt
    nk = kkt.diag.shape[-1]
    dev, dt = kkt.diag.device, kkt.diag.dtype
    eye = torch.eye(nk, dtype=dt, device=dev).expand(rem, nk, nk)
    diag = torch.cat([kkt.diag, eye], dim=0)
    mask = torch.cat([kkt.mask, kkt.mask.new_zeros(rem)])
    nc = kkt.q.shape[-1]
    if isinstance(kkt, LocalBlockKKT):
        L = kkt.border_loc.shape[1]
        return dataclasses.replace(
            kkt,
            diag=diag,
            border_loc=torch.cat([kkt.border_loc, kkt.border_loc.new_zeros((rem, L, nk))]),
            row_idx=torch.cat([kkt.row_idx, kkt.row_idx.new_full((rem, L), nc)]),
            mask=mask,
            assembly="scatter" if kkt.assembly == "chain" else kkt.assembly,
        )
    border = torch.cat([kkt.border, kkt.border.new_zeros((rem, nc, nk))])
    return BlockKKT(diag=diag, border=border, q=kkt.q, mask=mask)


def block_range(kkt, lo: int, hi: int):
    """The global blocks [lo, hi) of a Block/LocalBlockKKT (q is shared):
    one rank's part of the KKT of a sharded solver.  A rank-local KKT holds
    them from its ``block_offset`` on."""
    if isinstance(kkt, LocalBlockKKT):
        lo, hi = lo - kkt.block_offset, hi - kkt.block_offset
        return dataclasses.replace(
            kkt, diag=kkt.diag[lo:hi], border_loc=kkt.border_loc[lo:hi],
            row_idx=kkt.row_idx[lo:hi], mask=kkt.mask[lo:hi],
        )
    return dataclasses.replace(kkt, diag=kkt.diag[lo:hi], border=kkt.border[lo:hi], mask=kkt.mask[lo:hi])


def shard_kkt(kkt, axis, pad):
    """(kkt, lo, hi) for a sharded numeric over ``axis`` (a
    ``BlockAxis``): [lo, hi) is this rank's range of the block count padded
    to a multiple of the ranks, and ``kkt`` holds those blocks (``pad``:
    ``pad_block_count`` or ``pad_banded_block_count``).  A whole KKT, the
    same on every rank, is padded whole; a rank-local one (``global_blocks``
    set) holds the rank's real blocks and pads its own tail.  Either way a
    chain KKT whose count needs padding assembles by scatter on every rank,
    as ``pad_block_count`` decides.  (A ``BlockKKT`` is always whole.)"""
    N = getattr(kkt, "global_blocks", None)
    if N is None:
        kkt = pad(kkt, axis.size)
        return (kkt, *axis.local_range(kkt.mask.shape[0]))
    lo, hi = axis.local_range(N)
    if kkt.block_offset != lo or kkt.mask.shape[0] != min(hi, N) - lo:
        raise ValueError(
            f"rank-local KKT holds blocks [{kkt.block_offset}, "
            f"{kkt.block_offset + kkt.mask.shape[0]}), this rank's range of {N} is "
            f"[{lo}, {min(hi, N)})"
        )
    kkt = pad(kkt, hi - lo)
    if N % axis.size and kkt.assembly == "chain":
        kkt = dataclasses.replace(kkt, assembly="scatter")
    return kkt, lo, hi


def gather_kkt(kkt):
    """A serial solver's view of a KKT: a rank-local one (``global_blocks``
    set: an interface built with a mesh) gathered whole, the same on every
    rank, in block order over its ``axis`` (``BlockAxis.gather_rows``,
    exact); a whole one as it is.  The float tensors go in one all-reduce
    and the row indices in another, which keeps them integers.  The
    gathered KKT holds exactly ``global_blocks`` blocks, so it keeps the
    interface's ``assembly``.  Works for a ``LocalBlockKKT`` and a
    ``BandedLocalBlockKKT`` (``sym_bands`` in place of ``diag``)."""
    N = getattr(kkt, "global_blocks", None)
    if N is None:
        return kkt
    name = "sym_bands" if hasattr(kkt, "sym_bands") else "diag"
    blocks, border_loc, mask = kkt.axis.gather_rows([getattr(kkt, name), kkt.border_loc, kkt.mask], N)
    (row_idx,) = kkt.axis.gather_rows([kkt.row_idx], N)
    return dataclasses.replace(
        kkt, **{name: blocks}, border_loc=border_loc, row_idx=row_idx, mask=mask,
        global_blocks=None, block_offset=0, axis=None,
    )


def serial_factor(fact, kkt):
    """A serial solver's factor of ``gather_kkt(kkt)``, marked so that its
    solves gather their rank-local rhs when ``kkt`` was rank-local."""
    if getattr(kkt, "global_blocks", None) is None:
        return fact
    return dataclasses.replace(fact, global_blocks=kkt.global_blocks, rhs_axis=kkt.axis)


def gather_rhs(fact, rhs: BlockRhs) -> BlockRhs:
    """The whole rhs for a factor of a gathered KKT (``fact.rhs_axis`` set):
    the rank's block rows gathered over that axis; else ``rhs``.  The
    coupling part is whole on every rank already."""
    if fact.rhs_axis is None:
        return rhs
    return BlockRhs(fact.rhs_axis.gather_blocks(rhs.blocks, fact.global_blocks), rhs.coupling)


def _inertia_status(d: torch.Tensor, nk: int, mask: torch.Tensor, zero_tol: float):
    """Masked batch inertia (3,) int32 + merged status from the per-block
    pivots d (N, npad); a pivot with |d| <= zero_tol * max(1, max|d|) of its
    block counts as zero (``ldl_inertia``)."""
    pos, neg, zero = ldl_inertia(d, n=nk, zero_tol=zero_tol)
    ok = (pos + neg) == nk
    imask = mask.to(torch.int32)
    inertia = torch.stack(
        [(pos * imask).sum(), (neg * imask).sum(), (zero * imask).sum()]
    ).to(torch.int32)
    any_bad = (~ok & (mask > 0)).any()
    status = torch.where(
        any_bad,
        int(LinearSolverStatus.singular),
        int(LinearSolverStatus.successful),
    ).to(torch.int32)
    return inertia, status


def _factor_blocks(diag, mask, block_size: int, zero_tol: float):
    """Batched packed LDL^T of the diagonal blocks + inertia/status."""
    LD, d = ldl_factor_batched(diag, block_size=block_size)
    inertia, status = _inertia_status(d, diag.shape[-1], mask, zero_tol)
    return LD, inertia, status


def _factor_blocks_winv(diag, mask, block_size: int, zero_tol: float, factor_dtype=None,
                        apply_dtype=None):
    """Batched LDL^T of Ruiz-equilibrated blocks: returns (W, d, s, inertia,
    status) with K_i^{-1} = s W^T D^{-1} W s.  Equilibration keeps a
    lower-precision factorization's pivot signs — hence the inertia — intact
    despite the KKT's barrier-term dynamic range.

    ``apply_dtype`` enables the hybrid path: the pivot sweep runs in
    ``factor_dtype`` (inertia at that fidelity), then the factor is cast down
    and W is built and applied in ``apply_dtype``; refinement removes the
    cast's O(eps) solve error."""
    nk = diag.shape[-1]
    if factor_dtype is not None:
        diag = diag.to(factor_dtype)
    s = ruiz_scale(diag)  # (N, nk)
    diag = diag * s[:, :, None] * s[:, None, :]
    if apply_dtype is None or apply_dtype == diag.dtype:
        LD, d, W = ldl_factor_winv_batched(diag, block_size=block_size)
        inertia, status = _inertia_status(d, nk, mask, zero_tol)
        return W, d, s, inertia, status
    LD, inertia, status = _factor_blocks(diag, mask, block_size, zero_tol)
    LD = LD.to(apply_dtype)
    s = s.to(apply_dtype)
    W, d = ldl_winv(LD, min(block_size, LD.shape[-1]))
    return W, d, s, inertia, status


def _winv_apply_batched(W, d, s, b):
    """K_i^{-1} b_i for a batch: b (N, nk) -> (N, nk).  An f32 or bf16 W
    goes to the ``winv_apply_fused`` kernel entry (one pass over W); an f64 W
    takes the two-GEMV form, as the reference's XLA path does."""
    if W.dtype in (torch.float32, torch.bfloat16):
        f32 = torch.float32
        c = lambda t: t.to(f32).contiguous()
        return winv_apply_fused(W.contiguous(), c(d), c(s), c(b))
    return winv_apply_plain(W, d, s, b)


def _winv_multi(W, d, s, A_cols):
    """U = W (s * A_cols) and S = U^T D^{-1} U per block (A K^{-1} A^T in
    scaled symmetric W form); A_cols (N, nk, L) -> S (N, L, L)."""
    nk = A_cols.shape[1]
    npad = W.shape[-1]
    Af = A_cols.to(W.dtype) * s[:, :, None]
    if npad != nk:
        Af = torch.nn.functional.pad(Af, (0, 0, 0, npad - nk))
    U = W @ Af
    d_safe = torch.where(d.abs() > 0, d, torch.ones_like(d))
    return U.transpose(1, 2) @ (U / d_safe[:, :, None])


def _local_solve_products(LD, border_loc):
    """A_i K_i^{-1} A_i^T per block in packed-LDL mode: (N, L, L)."""
    V = ldl_solve(LD, border_loc.transpose(1, 2))  # (N, nk, L)
    return border_loc.to(V.dtype) @ V


def _sc_contribution(LD, border, mask):
    """sum_i A_i K_i^{-1} A_i^T over the batch (dense borders, LD mode)."""
    S = _local_solve_products(LD, border)
    return torch.einsum("bck,b->ck", S, mask.to(S.dtype))


def _sc_contribution_winv(W, d, s, border, mask):
    """W-mode dense-border SC contribution: all matmuls."""
    S = _winv_multi(W, d, s, border.transpose(1, 2))  # (N, nc, nc)
    return torch.einsum("bck,b->ck", S, mask.to(S.dtype))


def _scatter_sc(S_loc, row_idx, nc: int):
    """sum_i P_i S_i P_i^T, each entry's contributions added in block order
    (the dump index nc dropped)."""
    return scatter_add_pairs(row_idx, S_loc, nc)


def _chain_tiles(S_loc, nc: int, group_offset: int = 0):
    """Chain-topology SC contribution in block-tridiagonal tile form:
    ``(diag_tiles (ng, ns, ns), upper_full (ng, ns, ns))`` with
    ``upper_full[g]`` the (c_g, c_{g+1}) tile (index ng-1 is structurally
    unused and dropped by consumers).  Block b's quadrants [bwd | fwd] land
    on groups b-1 and b, b counted from ``group_offset`` (a rank's first
    global block); out-of-range quadrants (block 0 backward, last block
    forward) are dropped — their border rows are zero by the link masks."""
    Nb, L, _ = S_loc.shape
    ns = L // 2
    ng = nc // ns
    bb = S_loc[:, :ns, :ns]
    bf = S_loc[:, :ns, ns:]
    ff = S_loc[:, ns:, ns:]

    def place(tiles, start):
        # tiles for global tile-rows [start, start + Nb), clipped to [0, ng)
        out = torch.zeros((ng, ns, ns), dtype=S_loc.dtype, device=S_loc.device)
        lo, hi = max(start, 0), min(start + Nb, ng)
        if hi > lo:
            out[lo:hi] = tiles[lo - start : hi - start]
        return out

    diag_tiles = place(ff, group_offset) + place(bb, group_offset - 1)
    upper_full = place(bf, group_offset - 1)
    return diag_tiles, upper_full


def _tile_sc(q, ns: int, dt_c, ut_full, group=None):
    """Block-tridiagonal S = Q - sum_i A_i K_i^{-1} A_i^T from the tile-form
    contributions ``_chain_tiles`` gives, summed over ``group`` (a sharded
    solver's ranks) in one reduction of the diagonal and upper tiles."""
    from parapint_tpu_torch.linalg.tridiag import BlockTridiag, extract_tridiag

    ng = dt_c.shape[0]
    both = all_reduce_sum(torch.cat([dt_c, ut_full[:-1]]), group)
    q_tri = extract_tridiag(q, ns)
    return BlockTridiag(diag=q_tri.diag - both[:ng], upper=q_tri.upper - both[ng:])


def _assemble_sc(S_loc, row_idx, nc: int, assembly: str, group_offset: int = 0):
    """Place per-block local SC contributions (N, L, L) into the dense
    global (nc, nc) Schur complement."""
    if assembly == "shared":
        return S_loc.sum(0)
    if assembly == "chain":
        ns = S_loc.shape[1] // 2
        if ns == 0 or nc % ns != 0:
            return _scatter_sc(S_loc, row_idx, nc)
        ng = nc // ns
        diag_tiles, upper_tiles = _chain_tiles(S_loc, nc, group_offset)
        S = torch.zeros((ng, ns, ng, ns), dtype=S_loc.dtype, device=S_loc.device)
        g = torch.arange(ng, device=S_loc.device)
        S[g, :, g, :] = diag_tiles
        S[g[:-1], :, g[:-1] + 1, :] = upper_tiles[:-1]
        S[g[:-1] + 1, :, g[:-1], :] = upper_tiles[:-1].transpose(1, 2)
        return S.reshape(nc, nc)
    return _scatter_sc(S_loc, row_idx, nc)


def _sc_contribution_local(LD, border_loc, row_idx, nc: int, assembly: str = "scatter",
                           group_offset: int = 0):
    """sum_i P_i (A_i K_i^{-1} A_i^T) P_i^T, packed-LDL mode."""
    return _assemble_sc(_local_solve_products(LD, border_loc), row_idx, nc, assembly, group_offset)


def _sc_contribution_local_winv(W, d, s, border_loc, row_idx, nc: int, assembly: str = "scatter",
                                group_offset: int = 0):
    """W-mode local-border SC contribution: all matmuls + assembly."""
    S_loc = _winv_multi(W, d, s, border_loc.transpose(1, 2))
    return _assemble_sc(S_loc, row_idx, nc, assembly, group_offset)


def _sc_tiles_local_winv(W, d, s, border_loc, nc: int, group_offset: int = 0):
    """Chain-topology SC contribution in tile form (W mode)."""
    return _chain_tiles(_winv_multi(W, d, s, border_loc.transpose(1, 2)), nc, group_offset)


def _sc_tiles_local(LD, border_loc, nc: int, group_offset: int = 0):
    """Chain-topology SC contribution in tile form (packed-LDL mode)."""
    return _chain_tiles(_local_solve_products(LD, border_loc), nc, group_offset)


def _tridiag_sc_capable(sc_solver, kkt) -> bool:
    """True when the coupling solve can stay in block-tridiagonal tile form:
    chain topology + a tile-form-capable SC solver."""
    from parapint_tpu_torch.linalg.tridiag import BlockTridiagSolver

    if not isinstance(sc_solver, BlockTridiagSolver):
        return False
    if not isinstance(kkt, LocalBlockKKT) or kkt.assembly != "chain":
        return False
    ns = kkt.border_loc.shape[1] // 2
    nc = kkt.q.shape[-1]
    return ns > 0 and nc > 0 and nc % ns == 0


def _border_apply_local(border_loc, row_idx, v, nc: int, assembly: str = "scatter"):
    """sum_i P_i A_i v_i -> (nc,), summed over the blocks in a fixed order
    (the shared topology has every block on rows 0..L-1)."""
    contrib = (border_loc.to(v.dtype) @ v[:, :, None])[..., 0]
    if assembly == "shared":
        return torch.nn.functional.pad(contrib.sum(0), (0, nc - contrib.shape[1]))
    return scatter_add_rows(row_idx, contrib, nc)


def _border_T_apply_local(border_loc, row_idx, y):
    """A_i^T P_i^T y per block -> (N, nk)"""
    y_pad = torch.cat([y, y.new_zeros(1)])
    y_loc = y_pad[row_idx.long()]  # (N, L)
    return (y_loc[:, None, :] @ border_loc.to(y.dtype))[:, 0, :]


def _chain_border_ok(assembly, border_loc, nc: int) -> bool:
    """True when the scatter-free chain border application applies."""
    if assembly != "chain" or border_loc is None:
        return False
    L = border_loc.shape[1]
    ns = L // 2
    return L % 2 == 0 and ns > 0 and nc > 0 and nc % ns == 0


def _border_apply_chain(border_loc, v, nc: int, group_offset: int = 0):
    """Chain-topology sum_i P_i A_i v_i -> (nc,): rows [0, ns) of block b
    target group b-1, rows [ns, 2ns) group b, b counted from
    ``group_offset`` (None = 0)."""
    Nb, L, _ = border_loc.shape
    ns = L // 2
    ng = nc // ns
    off = group_offset or 0
    contrib = (border_loc.to(v.dtype) @ v[:, :, None])[..., 0]
    out = contrib.new_zeros((ng + 2, ns))
    out[off + 1 : off + Nb + 1] += contrib[:, ns:]  # fwd of block b -> group b
    out[off : off + Nb] += contrib[:, :ns]  # bwd of block b -> group b-1
    return out[1 : ng + 1].reshape(nc)


def _border_y_loc_chain(y, Nb: int, L: int, group_offset: int = 0):
    """(Nb, L) per-block local rows of the coupling vector for the chain
    topology: rows [0, ns) read group b-1, rows [ns, 2ns) read group b, b
    counted from ``group_offset`` (None = 0)."""
    ns = L // 2
    off = group_offset or 0
    yg = y.reshape(-1, ns)
    z = yg.new_zeros((1, ns))
    ext = torch.cat([z, yg, z], dim=0)  # ext[g + 1] = group g
    return torch.cat([ext[off : off + Nb], ext[off + 1 : off + Nb + 1]], dim=1)


def _border_T_apply_chain(border_loc, y, group_offset: int = 0):
    """Chain-topology A_i^T P_i^T y per block -> (N, nk)."""
    Nb, L, _ = border_loc.shape
    y_loc = _border_y_loc_chain(y, Nb, L, group_offset)
    return (y_loc[:, None, :] @ border_loc.to(y.dtype))[:, 0, :]


def _kkt_matvec(fact: SchurFactor, x: BlockRhs, dtype=None, group=None) -> BlockRhs:
    """K @ x for the full block-bordered system (iterative refinement).
    With ``dtype`` every operand is cast first (the cheap residual probe).
    With a process ``group`` the factor holds one rank's blocks and the
    coupling part is summed over the group (``psum_axis`` in the JAX
    package)."""
    diag, q = fact.diag, fact.q
    xb, xc = x.blocks, x.coupling
    border, border_loc = fact.border, fact.border_loc
    if dtype is not None:
        cast = lambda t: None if t is None else t.to(dtype)
        diag, q, xb, xc, border, border_loc = map(cast, (diag, q, xb, xc, border, border_loc))
    bx = (diag.to(xb.dtype) @ xb[:, :, None])[..., 0]
    if _chain_border_ok(fact.assembly, border_loc, fact.nc):
        bx = bx + _border_T_apply_chain(border_loc, xc, fact.group_offset)
        cy = _border_apply_chain(border_loc, xb, fact.nc, fact.group_offset)
    elif border_loc is not None:
        bx = bx + _border_T_apply_local(border_loc, fact.row_idx, xc)
        cy = _border_apply_local(border_loc, fact.row_idx, xb, fact.nc, fact.assembly)
    else:
        bd = border.to(xb.dtype)
        bx = bx + torch.einsum("bci,c->bi", bd, xc.to(xb.dtype))
        cy = torch.einsum("bci,bi->c", bd, xb)
    cy = all_reduce_sum(cy, group)
    cy = cy + q.to(cy.dtype) @ xc.to(cy.dtype)
    return BlockRhs(blocks=bx, coupling=cy)


def _refine_probe(fact: SchurFactor, rhs: BlockRhs, x: BlockRhs, trigger: float,
                  group=None) -> torch.Tensor:
    """Device bool: the f32 residual ||rhs - K x|| exceeds both trigger *
    max(1, ||rhs||) and the probe's own floor, 32 eps_f32 ||(|K| |x|)||.
    The matvecs run in f32, the norms in the rhs dtype (squares of f32
    values overflow); a non-finite residual counts as failure.  With a
    process ``group`` the block norms are summed over it (the coupling part
    is replicated and added once), so every rank reads the same flag."""
    rn2, thresh = _refine_residual(fact, rhs, x, trigger, group)
    return ~torch.isfinite(rn2) | (rn2 > thresh)


def _refine_residual(fact: SchurFactor, rhs: BlockRhs, x: BlockRhs, trigger: float, group=None):
    """(squared residual norm, squared threshold) of :func:`_refine_probe`."""
    f32 = torch.float32
    kx = _kkt_matvec(fact, x, dtype=f32, group=group)
    absf = lambda t: None if t is None else t.abs()
    afact = dataclasses.replace(
        fact, diag=fact.diag.abs(), q=fact.q.abs(),
        border=absf(fact.border), border_loc=absf(fact.border_loc),
    )
    kabs = _kkt_matvec(afact, BlockRhs(x.blocks.abs(), x.coupling.abs()), dtype=f32, group=group)
    wd = rhs.blocks.dtype
    rb = rhs.blocks.to(f32).to(wd) - kx.blocks.to(wd)
    rc = rhs.coupling.to(f32).to(wd) - kx.coupling.to(wd)
    # the three block sums in one reduction over the group
    rb2, bb2, fb2 = all_reduce_sum(torch.stack([
        (rb * rb).sum(), rhs.blocks.to(wd).square().sum(), kabs.blocks.to(wd).square().sum(),
    ]), group)
    rn2 = rb2 + (rc * rc).sum()
    bn2 = bb2 + rhs.coupling.to(wd).square().sum()
    fn2 = fb2 + kabs.coupling.to(wd).square().sum()
    eps = 32.0 * float(np.finfo(np.float32).eps)
    thresh = torch.maximum((trigger * trigger) * torch.clamp(bn2, min=1.0), (eps * eps) * fn2)
    return rn2, thresh


class SchurComplementSolver(LinearSolver):
    """Serial Schur-complement solver over :class:`BlockKKT` /
    :class:`LocalBlockKKT`, composed with any coupling solver (default
    ``DenseLDLSolver``; ``BlockTridiagSolver`` keeps a chain SC in tile
    form).

    ``explicit_inverse``: W form (else packed LDL^T); ``factor_dtype``: the
    blocks' factor dtype; ``apply_dtype``: hybrid precision (see
    :func:`_factor_blocks_winv`); ``refine_steps``: None = adaptive
    refinement (an f32 residual probe decides each f64 pass: passes run
    while the residual exceeds ``refine_trigger`` * ||rhs|| and the probe's
    noise floor, at most ``refine_max_passes`` of them), an int = that many
    fixed passes; ``w_store_dtype`` (e.g. torch.bfloat16): store W for the
    back solves in this dtype (the SC is formed from the full W);
    ``w_auto_gate``: with ``w_store_dtype`` and adaptive refinement, keep
    the full W and retry a stalled solve with it.  ``zero_tol``: a block
    pivot with |d| <= zero_tol * max(1, max|d|) counts as zero (default:
    exact zeros only); it also goes to the default coupling solver.
    ``n_numeric`` counts numeric factorizations,
    ``n_solves`` back solves through the Schur complement (two block
    applies each) and ``n_gate_fallbacks`` the retries on the full W.

    A rank-local KKT (an interface built with ``mesh=``) is gathered whole
    on every rank (:func:`gather_kkt`), and so is the rhs of each solve:
    every rank factors and solves the whole system and returns the whole
    solution, as a sharded solver does.
    """

    # process group over which a sharded solver sums the coupling parts of
    # its solves and refinement probes (None: serial)
    group = None

    def __init__(
        self,
        schur_complement_solver: Optional[LinearSolver] = None,
        block_size: int = 128,
        zero_tol: float = 0.0,
        explicit_inverse: bool = False,
        refine_steps: Optional[int] = None,
        factor_dtype=None,
        apply_dtype=None,
        refine_trigger: float = 1e-5,
        refine_max_passes: int = 8,
        w_store_dtype=None,
        w_auto_gate: bool = True,
    ):
        self.sc_solver = (
            schur_complement_solver
            if schur_complement_solver is not None
            else DenseLDLSolver(
                block_size=block_size,
                zero_tol=zero_tol,
                explicit_inverse=explicit_inverse,
                # the SC is formed in factor_dtype already; the global
                # refinement covers it
                refine_steps=0,
            )
        )
        self.block_size = block_size
        self.zero_tol = zero_tol
        self.explicit_inverse = explicit_inverse
        self.factor_dtype = factor_dtype
        self.apply_dtype = apply_dtype
        self.w_store_dtype = w_store_dtype
        self.w_auto_gate = w_auto_gate
        self.adaptive_refine = refine_steps is None
        self.refine_steps = 1 if refine_steps is None else refine_steps
        self.refine_trigger = refine_trigger
        self.refine_max_passes = refine_max_passes
        self.n_numeric = 0
        self.n_solves = 0
        self.n_gate_fallbacks = 0

    def symbolic(self, kkt) -> LinearSolverResults:
        N, nk, nk2 = kkt.diag.shape
        if nk != nk2:
            raise ValueError(f"diagonal blocks are not square: {tuple(kkt.diag.shape)}")
        nc = kkt.q.shape[-1]
        if isinstance(kkt, LocalBlockKKT):
            if kkt.border_loc.shape[0] != N or kkt.border_loc.shape[2] != nk:
                raise ValueError(
                    f"border_loc shape {tuple(kkt.border_loc.shape)} inconsistent "
                    f"with diag {tuple(kkt.diag.shape)}"
                )
            if tuple(kkt.row_idx.shape) != tuple(kkt.border_loc.shape[:2]):
                raise ValueError("row_idx must be (N, L)")
        elif tuple(kkt.border.shape) != (N, nc, nk):
            raise ValueError(
                f"border shape {tuple(kkt.border.shape)} inconsistent with "
                f"diag {tuple(kkt.diag.shape)} and q {tuple(kkt.q.shape)}"
            )
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, kkt) -> SchurFactor:
        self.n_numeric += 1
        whole = gather_kkt(kkt)
        return serial_factor(self._numeric(whole, 0, whole.diag.shape[0]), kkt)

    def _numeric(self, kkt, lo: int, hi: int) -> SchurFactor:
        """Factor the blocks [lo, hi) of ``kkt``; their Schur-complement
        contributions, inertia and status are summed over the solver's group
        (the identity when serial), and the SC is factored on every rank."""
        nk = kkt.diag.shape[-1]
        nc = kkt.q.shape[-1]
        local = isinstance(kkt, LocalBlockKKT)
        tridiag = _tridiag_sc_capable(self.sc_solver, kkt)
        ns = kkt.border_loc.shape[1] // 2 if local else 0
        lk = block_range(kkt, lo, hi)
        border = lk.border_loc if local else lk.border
        assembly = lk.assembly if local else "scatter"
        # phase labels: the reference solver's named scopes
        if self.explicit_inverse:
            with record_function("sc_solver.factor_blocks"):
                W, d, s, blk_inertia, blk_status = _factor_blocks_winv(
                    lk.diag, lk.mask, self.block_size, self.zero_tol, self.factor_dtype,
                    self.apply_dtype,
                )
            LD = None
            with record_function("sc_solver.form_sc"):
                if tridiag:
                    dt_c, ut_full = _sc_tiles_local_winv(W, d, s, border, nc, lo)
                elif local:
                    contrib = _sc_contribution_local_winv(
                        W, d, s, border, lk.row_idx, nc, assembly, lo
                    )
                else:
                    contrib = _sc_contribution_winv(W, d, s, border, lk.mask)
            q = kkt.q.to(W.dtype)
            W_hi = None
            if self.w_store_dtype is not None:
                # the SC above used the full factor-dtype W
                if self.w_auto_gate and self.adaptive_refine:
                    W_hi = W
                W = W.to(self.w_store_dtype)
        else:
            W = d = s = W_hi = None
            with record_function("sc_solver.factor_blocks"):
                LD, blk_inertia, blk_status = _factor_blocks(
                    lk.diag, lk.mask, self.block_size, self.zero_tol
                )
            if self.apply_dtype is not None and LD.dtype != self.apply_dtype:
                # hybrid precision, LD form: pivots/inertia from the
                # factor-dtype sweep, solves in apply_dtype (no equilibration)
                LD = LD.to(self.apply_dtype)
            with record_function("sc_solver.form_sc"):
                if tridiag:
                    dt_c, ut_full = _sc_tiles_local(LD, border, nc, lo)
                elif local:
                    contrib = _sc_contribution_local(LD, border, lk.row_idx, nc, assembly, lo)
                else:
                    contrib = _sc_contribution(LD, border, lk.mask)
            q = kkt.q
        with record_function("sc_solver.communicate"):
            if tridiag:
                sc = _tile_sc(q, ns, dt_c, ut_full, self.group)
            else:
                sc = q - all_reduce_sum(contrib, self.group)
            blk_inertia = all_reduce_sum(blk_inertia, self.group)
            blk_status = all_reduce_max(blk_status, self.group)
        with record_function("sc_solver.factor_sc"):
            sc_fact = self.sc_solver.numeric(sc)
        sc_pos, sc_neg, sc_zero = self.sc_solver.inertia(sc_fact)
        inertia = blk_inertia + torch.stack([sc_pos, sc_neg, sc_zero]).to(torch.int32)
        status = torch.maximum(blk_status, self.sc_solver.status(sc_fact))
        keep = self.refine_steps > 0
        return SchurFactor(
            block_LD=LD,
            block_W=W,
            block_W_hi=W_hi,
            block_d=d,
            block_s=s,
            diag=lk.diag if keep else None,
            q=kkt.q if keep else None,
            border=None if local else lk.border,
            border_loc=lk.border_loc if local else None,
            row_idx=lk.row_idx if local else None,
            sc_fact=sc_fact,
            inertia=inertia,
            status=status,
            nk=nk,
            nc=nc,
            assembly=assembly,
            group_offset=lo,
            global_blocks=kkt.global_blocks if local else None,
        )

    def _apply_blocks(self, fact: SchurFactor, b, hi: bool = False):
        """K_i^{-1} b_i for every block, in the factor's dtype.  ``hi``: the
        full-precision W (bf16 auto-gate retry)."""
        W = fact.block_W_hi if (hi and fact.block_W_hi is not None) else fact.block_W
        if W is not None:
            return _winv_apply_batched(W, fact.block_d, fact.block_s, b)
        return ldl_solve(fact.block_LD, b)

    def _solve_once(self, fact: SchurFactor, rhs: BlockRhs, hi: bool = False) -> BlockRhs:
        self.n_solves += 1
        local = fact.border is None
        chain = _chain_border_ok(fact.assembly, fact.border_loc, fact.nc)
        with record_function("sc_solver.block_solve"):
            v = self._apply_blocks(fact, rhs.blocks, hi)
            if chain:
                contrib = _border_apply_chain(fact.border_loc, v, fact.nc, fact.group_offset)
            elif local:
                contrib = _border_apply_local(
                    fact.border_loc, fact.row_idx, v, fact.nc, fact.assembly
                )
            else:
                contrib = torch.einsum("bci,bi->c", fact.border.to(v.dtype), v)
        with record_function("sc_solver.communicate"):
            sc_rhs = rhs.coupling - all_reduce_sum(contrib, self.group)
        with record_function("sc_solver.sc_back_solve"):
            y = self.sc_solver.solve(fact.sc_fact, sc_rhs)
        with record_function("sc_solver.back_solve"):
            if chain:
                rhs2 = rhs.blocks - _border_T_apply_chain(fact.border_loc, y, fact.group_offset)
            elif local:
                rhs2 = rhs.blocks - _border_T_apply_local(fact.border_loc, fact.row_idx, y)
            else:
                rhs2 = rhs.blocks - torch.einsum("bci,c->bi", fact.border.to(y.dtype), y)
            x = self._apply_blocks(fact, rhs2, hi)
        return BlockRhs(blocks=x, coupling=y)

    def _solve_refined(self, fact: SchurFactor, rhs: BlockRhs):
        """(solution, refined_ok).  Adaptive mode refines while the f32
        probe fails, at most ``refine_max_passes`` passes, as a host loop
        with one flag read per pass."""

        def up(b: BlockRhs) -> BlockRhs:  # promote to the rhs dtype
            return BlockRhs(b.blocks.to(rhs.blocks.dtype), b.coupling.to(rhs.coupling.dtype))

        def refine_pass(x: BlockRhs, hi=False) -> BlockRhs:
            kx = _kkt_matvec(fact, x, group=self.group)
            r = BlockRhs(rhs.blocks - kx.blocks, rhs.coupling - kx.coupling)
            dx = up(self._solve_once(fact, r, hi))
            return BlockRhs(x.blocks + dx.blocks, x.coupling + dx.coupling)

        def solve_adaptive(hi):
            x = up(self._solve_once(fact, rhs, hi))
            need = _refine_probe(fact, rhs, x, self.refine_trigger, self.group)
            passes = 0
            while passes < self.refine_max_passes and bool(need.item()):
                x = refine_pass(x, hi)
                passes += 1
                need = _refine_probe(fact, rhs, x, self.refine_trigger, self.group)
            return x, need

        if self.adaptive_refine:
            x, need = solve_adaptive(False)
            if fact.block_W_hi is not None and bool(need.item()):
                # bf16 auto-gate: a stall on the reduced-storage W retries
                # the whole solve with the full-precision W
                self.n_gate_fallbacks += 1
                x, need = solve_adaptive(True)
            return x, ~need
        x = up(self._solve_once(fact, rhs))
        for _ in range(self.refine_steps):
            x = refine_pass(x)
        return x, torch.ones((), dtype=torch.bool, device=x.blocks.device)

    def solve(self, fact: SchurFactor, rhs: BlockRhs) -> BlockRhs:
        return self._solve_refined(fact, gather_rhs(fact, rhs))[0]

    def solve_with_status(self, fact: SchurFactor, rhs: BlockRhs):
        x, ok = self._solve_refined(fact, gather_rhs(fact, rhs))
        bad = torch.where(
            ok, int(LinearSolverStatus.successful), int(LinearSolverStatus.error)
        ).to(torch.int32)
        return x, torch.maximum(self.status(fact), bad)

    def inertia(self, fact: SchurFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: SchurFactor) -> torch.Tensor:
        return fact.status
