"""Schur-complement building blocks shared by the block-bordered solvers.

The subset of ``parapint_tpu.linalg.schur`` that the banded Schur solver
runs: the rhs container, the batched block factorization with inertia, the
chain-topology SC tile assembly and the border applications.  The system is

    [ K_0            A_0^T ] [x_0]   [b_0]
    [      ...        ...  ] [...] = [...]
    [          K_N-1 A_N-1^T] [x_N-1] [b_N-1]
    [ A_0 ... A_N-1    Q   ] [y  ]   [b_c]

with each border A_i stored as a block-local (L, nk) strip whose rows map to
global coupling rows through ``row_idx`` (dump index nc for masked rows), or
positionally for the time-chain topology ("chain": rows [0, ns) couple
group i-1, rows [ns, 2ns) group i).
"""

import dataclasses

import torch

from parapint_tpu_torch.linalg.results import LinearSolverStatus
from parapint_tpu_torch.ops.ldl import ldl_factor_winv_batched, ldl_inertia, ruiz_scale


@dataclasses.dataclass(frozen=True)
class BlockRhs:
    """Right-hand side / solution: blocks (N, nk), coupling (nc,)."""

    blocks: torch.Tensor
    coupling: torch.Tensor


def _inertia_status(d: torch.Tensor, nk: int, mask: torch.Tensor):
    """Masked batch inertia (3,) int32 + merged status from the per-block
    pivots d (N, npad); only exact zeros count as zero pivots."""
    pos, neg, zero = ldl_inertia(d, n=nk)
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


def _factor_blocks_winv(diag, mask, block_size: int):
    """Batched LDL^T of Ruiz-equilibrated blocks: returns (W, d, s, inertia,
    status) with K_i^{-1} = s W^T D^{-1} W s.  Equilibration keeps a
    lower-precision factorization's pivot signs — hence the inertia — intact
    despite the KKT's barrier-term dynamic range."""
    nk = diag.shape[-1]
    s = ruiz_scale(diag)  # (N, nk)
    diag = diag * s[:, :, None] * s[:, None, :]
    LD, d, W = ldl_factor_winv_batched(diag, block_size=block_size)
    inertia, status = _inertia_status(d, nk, mask)
    return W, d, s, inertia, status


def _scatter_sc(S_loc, row_idx, nc: int):
    out = torch.zeros((nc + 1, nc + 1), dtype=S_loc.dtype, device=S_loc.device)
    N, L = row_idx.shape
    r = row_idx.long()
    out.index_put_((r[:, :, None].expand(N, L, L), r[:, None, :].expand(N, L, L)), S_loc, accumulate=True)
    return out[:nc, :nc]


def _chain_tiles(S_loc, nc: int):
    """Chain-topology SC contribution in block-tridiagonal tile form:
    ``(diag_tiles (ng, ns, ns), upper_full (ng, ns, ns))`` with
    ``upper_full[g]`` the (c_g, c_{g+1}) tile (index ng-1 is structurally
    unused and dropped by consumers).  Block b's quadrants [bwd | fwd] land
    on groups b-1 and b; out-of-range quadrants (block 0 backward, last block
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

    diag_tiles = place(ff, 0) + place(bb, -1)
    upper_full = place(bf, -1)
    return diag_tiles, upper_full


def _assemble_sc(S_loc, row_idx, nc: int, assembly: str):
    """Place per-block local SC contributions (N, L, L) into the dense
    global (nc, nc) Schur complement."""
    if assembly == "shared":
        return S_loc.sum(0)
    if assembly == "chain":
        ns = S_loc.shape[1] // 2
        if ns == 0 or nc % ns != 0:
            return _scatter_sc(S_loc, row_idx, nc)
        ng = nc // ns
        diag_tiles, upper_tiles = _chain_tiles(S_loc, nc)
        S = torch.zeros((ng, ns, ng, ns), dtype=S_loc.dtype, device=S_loc.device)
        g = torch.arange(ng, device=S_loc.device)
        S[g, :, g, :] = diag_tiles
        S[g[:-1], :, g[:-1] + 1, :] = upper_tiles[:-1]
        S[g[:-1] + 1, :, g[:-1], :] = upper_tiles[:-1].transpose(1, 2)
        return S.reshape(nc, nc)
    return _scatter_sc(S_loc, row_idx, nc)


def _border_apply_local(border_loc, row_idx, v, nc: int):
    """sum_i P_i A_i v_i -> (nc,)"""
    contrib = (border_loc.to(v.dtype) @ v[:, :, None])[..., 0]
    out = torch.zeros(nc + 1, dtype=v.dtype, device=v.device)
    out.index_add_(0, row_idx.reshape(-1).long(), contrib.reshape(-1))
    return out[:nc]


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


def _border_apply_chain(border_loc, v, nc: int):
    """Chain-topology sum_i P_i A_i v_i -> (nc,): rows [0, ns) of block b
    target group b-1, rows [ns, 2ns) group b."""
    Nb, L, _ = border_loc.shape
    ns = L // 2
    ng = nc // ns
    contrib = (border_loc.to(v.dtype) @ v[:, :, None])[..., 0]
    out = contrib.new_zeros((ng + 2, ns))
    out[1 : Nb + 1] += contrib[:, ns:]  # fwd of block b -> group b
    out[0:Nb] += contrib[:, :ns]  # bwd of block b -> group b-1
    return out[1 : ng + 1].reshape(nc)


def _border_y_loc_chain(y, Nb: int, L: int):
    """(Nb, L) per-block local rows of the coupling vector for the chain
    topology: rows [0, ns) read group b-1, rows [ns, 2ns) read group b."""
    ns = L // 2
    yg = y.reshape(-1, ns)
    z = yg.new_zeros((1, ns))
    ext = torch.cat([z, yg, z], dim=0)  # ext[g + 1] = group g
    return torch.cat([ext[:Nb], ext[1 : Nb + 1]], dim=1)


def _border_T_apply_chain(border_loc, y):
    """Chain-topology A_i^T P_i^T y per block -> (N, nk)."""
    Nb, L, _ = border_loc.shape
    y_loc = _border_y_loc_chain(y, Nb, L)
    return (y_loc[:, None, :] @ border_loc.to(y.dtype))[:, 0, :]
