"""Block-tridiagonal solver by cyclic reduction — the chain-topology
Schur-complement coupling solver (counterpart of
``parapint_tpu.linalg.tridiag``).

Eliminating the even-indexed tiles of a block-tridiagonal matrix leaves a
block-tridiagonal matrix on the odd tiles, so log2(m) batched elimination
levels reduce m tiles to one; each level is a batched LDL^T of the
eliminated tiles plus batched ns x ns matmuls.  Inertia is exact by
Haynsworth additivity over the levels.  m is padded to 2^k - 1 with masked
identity tiles, which factor trivially and are excluded from the inertia.
"""

import dataclasses
from typing import Optional

import torch

from parapint_tpu_torch.linalg.base import LinearSolver
from parapint_tpu_torch.linalg.results import LinearSolverResults, LinearSolverStatus
from parapint_tpu_torch.linalg.schur import _factor_blocks_winv


@dataclasses.dataclass(frozen=True)
class BlockTridiag:
    """Symmetric block-tridiagonal matrix in tile form: diag (m, ns, ns),
    upper (m-1, ns, ns) with upper[i] = S[i, i+1] (subdiagonal by symmetry)."""

    diag: torch.Tensor
    upper: torch.Tensor

    @property
    def m(self) -> int:
        return self.diag.shape[0]

    @property
    def ns(self) -> int:
        return self.diag.shape[-1]

    def todense(self) -> torch.Tensor:
        m, ns = self.m, self.ns
        S = self.diag.new_zeros((m, ns, m, ns))
        g = torch.arange(m, device=self.diag.device)
        S[g, :, g, :] = self.diag
        if m > 1:
            S[g[:-1], :, g[:-1] + 1, :] = self.upper
            S[g[:-1] + 1, :, g[:-1], :] = self.upper.transpose(1, 2)
        return S.reshape(m * ns, m * ns)


def extract_tridiag(S: torch.Tensor, ns: int) -> BlockTridiag:
    """Tile view of a dense block-tridiagonal matrix (out-of-band entries
    are ignored)."""
    nc = S.shape[-1]
    if nc % ns != 0:
        raise ValueError(f"matrix dim {nc} not a multiple of tile size {ns}")
    m = nc // ns
    q = S.reshape(m, ns, m, ns)
    idx = torch.arange(m, device=S.device)
    diag = q[idx, :, idx, :]
    upper = q[idx[:-1], :, idx[:-1] + 1, :]
    return BlockTridiag(diag=diag, upper=upper)


@dataclasses.dataclass(frozen=True)
class CRFactor:
    """Per level l: explicit inverses ``tinv[l]`` (E_l, ns, ns) of the
    eliminated tiles and the even/odd superdiagonal tiles ``ue[l]``/``uo[l]``
    (K_l, ns, ns) used by that level's elimination."""

    tinv: tuple
    ue: tuple
    uo: tuple
    inertia: torch.Tensor  # (3,) int32
    status: torch.Tensor  # () int32
    m: int
    ns: int


def _next_pow2m1(m: int) -> int:
    k = 1
    while (1 << k) - 1 < m:
        k += 1
    return (1 << k) - 1


def _winv_to_inverse(W, d, s, ns: int):
    """Explicit K^{-1} = s W^T D^{-1} W s for a batch of tiles (W may carry
    LDL padding beyond ns, sliced off)."""
    d_safe = torch.where(d.abs() > 0, d, torch.ones_like(d))
    Minv = W.transpose(1, 2) @ (W / d_safe[:, :, None])
    Minv = Minv[:, :ns, :ns]
    return Minv * s[:, :, None] * s[:, None, :]


def cr_factor(
    tri: BlockTridiag,
    block_size: int = 64,
    zero_tol: float = 0.0,
    factor_dtype=None,
) -> CRFactor:
    """Factor a symmetric block-tridiagonal matrix by cyclic reduction.
    ``block_size`` is the panel width of the level factorizations (ns-wide
    tiles narrower than it snap up to one panel of a multiple of 8: 49 ->
    56 on the Burgers chain); the tiles factor in ``factor_dtype`` (None:
    the tiles' dtype); ``zero_tol`` as for ``SchurComplementSolver``."""
    m, ns = tri.m, tri.ns
    M = _next_pow2m1(m)
    diag, upper = tri.diag, tri.upper
    dt, dev = diag.dtype, diag.device
    mask = torch.ones(m, dtype=dt, device=dev)
    if M != m:
        eye = torch.eye(ns, dtype=dt, device=dev).expand(M - m, ns, ns)
        diag = torch.cat([diag, eye], dim=0)
        mask = torch.cat([mask, mask.new_zeros(M - m)])
    if upper.shape[0] != M - 1:
        upper = torch.cat(
            [upper, upper.new_zeros((M - 1 - upper.shape[0], ns, ns))], dim=0
        )

    tinvs, ues, uos = [], [], []
    inertia = torch.zeros(3, dtype=torch.int32, device=dev)
    status = torch.zeros((), dtype=torch.int32, device=dev)
    while True:
        K = (M - 1) // 2
        W, d, s, lvl_inertia, lvl_status = _factor_blocks_winv(
            diag[0::2], mask[0::2], block_size, zero_tol, factor_dtype
        )
        tinv = _winv_to_inverse(W, d, s, ns).to(dt)
        inertia = inertia + lvl_inertia
        status = torch.maximum(status, lvl_status)
        tinvs.append(tinv)
        if K == 0:
            empty = diag.new_zeros((0, ns, ns))
            ues.append(empty)
            uos.append(empty)
            break
        Ue = upper[0::2]  # U_{2p}:   couples (2p,   2p+1)
        Uo = upper[1::2]  # U_{2p+1}: couples (2p+1, 2p+2)
        ues.append(Ue)
        uos.append(Uo)
        # kept tile p (global 2p+1) absorbs both eliminated neighbours:
        #   T'_p = T_{2p+1} - Ue_p^T Tinv_{2p} Ue_p - Uo_p Tinv_{2p+2} Uo_p^T
        tl = Ue.transpose(1, 2) @ tinv[:K] @ Ue
        tr = Uo @ tinv[1:] @ Uo.transpose(1, 2)
        diag = diag[1::2] - tl - tr
        # new coupling between kept p and p+1 via eliminated 2p+2:
        #   U'_p = -Uo_p Tinv_{2p+2} Ue_{p+1}
        upper = -(Uo[: K - 1] @ tinv[1:K] @ Ue[1:])
        mask = mask[1::2]
        M = K
    return CRFactor(
        tinv=tuple(tinvs),
        ue=tuple(ues),
        uo=tuple(uos),
        inertia=inertia,
        status=status,
        m=m,
        ns=ns,
    )


def _mv(A, v):  # (k, ns, ns) @ (k, ns[, c]) -> (k, ns[, c])
    if v.dim() == 3:
        return A.to(v.dtype) @ v
    return (A.to(v.dtype) @ v[:, :, None])[..., 0]


def _mtv(A, v):  # (k, ns, ns)^T @ (k, ns[, c]) -> (k, ns[, c])
    if v.dim() == 3:
        return A.to(v.dtype).transpose(1, 2) @ v
    return (v[:, None, :] @ A.to(v.dtype))[:, 0, :]


def cr_solve(fact: CRFactor, r: torch.Tensor) -> torch.Tensor:
    """Solve S x = r given a cyclic-reduction factorization; r (nc,) or
    (m, ns), returns the same shape."""
    ns = fact.ns
    flat = r.dim() == 1
    x = _cr_solve_tiles(fact, r.reshape(-1, ns))
    return x.reshape(-1) if flat else x


def cr_solve_cols(fact: CRFactor, R: torch.Tensor) -> torch.Tensor:
    """Solve S X = R for the columns of R (nc, c) at once."""
    nc, c = R.shape
    return _cr_solve_tiles(fact, R.reshape(-1, fact.ns, c)).reshape(nc, c)


def _cr_solve_tiles(fact: CRFactor, r: torch.Tensor) -> torch.Tensor:
    """The cyclic-reduction solve on tile rows r (m, ns) or (m, ns, c)."""
    ns = fact.ns
    tail = r.shape[1:]
    m = r.shape[0]
    M = _next_pow2m1(m)
    if M != m:
        r = torch.cat([r, r.new_zeros((M - m, *tail))], dim=0)
    # forward sweep: fold eliminated tiles into the kept rhs
    zs = []
    for lvl in range(len(fact.tinv) - 1):
        tinv, Ue, Uo = fact.tinv[lvl], fact.ue[lvl], fact.uo[lvl]
        K = Ue.shape[0]
        z = _mv(tinv, r[0::2])
        zs.append(z)
        r = r[1::2] - _mtv(Ue, z[:K]) - _mv(Uo, z[1:])
    x = _mv(fact.tinv[-1], r)
    # back substitution, level by level
    for lvl in range(len(fact.tinv) - 2, -1, -1):
        tinv, Ue, Uo = fact.tinv[lvl], fact.ue[lvl], fact.uo[lvl]
        K = Ue.shape[0]
        E = K + 1
        zero = x.new_zeros((1, *tail))
        xk_pad = torch.cat([zero, x, zero], dim=0)  # (K+2, ns)
        zt = Uo.new_zeros((1, ns, ns))
        uo_shift = torch.cat([zt, Uo], dim=0)  # U_{2p-1}
        ue_ext = torch.cat([Ue, zt], dim=0)  # U_{2p}
        # x_e[p] = Tinv_{2p} (r_e[p] - U_{2p-1}^T x_kept[p-1] - U_{2p} x_kept[p])
        corr = _mtv(uo_shift, xk_pad[:E]) + _mv(ue_ext, xk_pad[1 : E + 1])
        xe = zs[lvl] - _mv(tinv, corr)
        out = x.new_empty((2 * K + 1, *tail))
        out[0::2] = xe
        out[1::2] = x
        x = out
    return x[:m]


class BlockTridiagSolver(LinearSolver):
    """LinearSolver over block-tridiagonal systems (cyclic reduction);
    ``numeric`` takes a :class:`BlockTridiag` or a dense matrix (with the
    constructor's ``ns``).  ``block_size``, ``zero_tol`` and
    ``factor_dtype``: as for :func:`cr_factor`."""

    def __init__(
        self,
        ns: Optional[int] = None,
        block_size: int = 64,
        zero_tol: float = 0.0,
        factor_dtype=None,
    ):
        self.ns = ns
        self.block_size = block_size
        self.zero_tol = zero_tol
        self.factor_dtype = factor_dtype

    def _as_tridiag(self, sc) -> BlockTridiag:
        if isinstance(sc, BlockTridiag):
            return sc
        if self.ns is None:
            raise ValueError("BlockTridiagSolver needs ns= to interpret a dense matrix")
        return extract_tridiag(sc, self.ns)

    def symbolic(self, sc) -> LinearSolverResults:
        self._as_tridiag(sc)
        return LinearSolverResults(status=LinearSolverStatus.successful)

    def numeric(self, sc) -> CRFactor:
        return cr_factor(
            self._as_tridiag(sc),
            block_size=self.block_size,
            zero_tol=self.zero_tol,
            factor_dtype=self.factor_dtype,
        )

    def solve(self, fact: CRFactor, rhs: torch.Tensor) -> torch.Tensor:
        return cr_solve(fact, rhs)

    def inertia(self, fact: CRFactor):
        return fact.inertia[0], fact.inertia[1], fact.inertia[2]

    def status(self, fact: CRFactor) -> torch.Tensor:
        return fact.status
