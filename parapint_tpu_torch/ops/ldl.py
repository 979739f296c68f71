"""Dense LDL^T with inertia and explicit W = L^{-1} (counterpart of
``parapint_tpu.ops.ldl``).

Unpivoted LDL^T with 1x1 pivots, right-looking over panels.  Each panel is
factored by one of the panel kernel's entries
(:mod:`parapint_tpu_torch.ops.ldl_panel`; the CUDA kernel for f32 CUDA
tensors, its plain version on the CPU): ``ldl_panels`` for the single-matrix
:func:`ldl_factor`, ``ldl_panels_slab`` (or ``ldl_panels_batched``) for
:func:`ldl_factor_batched` and ``ldl_panels_slab_winv`` (or
``ldl_panels_batched_winv``) for :func:`ldl_factor_winv_batched`, as
``PT_PANEL_ALGO`` and the panel width select (:func:`_slab_algo`).  Panel solves
and trailing updates are (batched) matmuls; solves use
``torch.linalg.solve_triangular`` or the explicit-inverse W form.  Inverses
use the block-recursive form, never Neumann doubling
(``parapint_tpu/ops/ldl.py:167-187`` records that doubling lost every digit
on the Burgers chain Schur complements).  Functions take any leading batch
dimensions where the reference ``vmap``s them.
"""

import os

import torch

from parapint_tpu_torch.ops.ldl_panel import (
    MAX_PANEL,
    ldl_panels,
    ldl_panels_batched,
    ldl_panels_batched_winv,
    ldl_panels_slab,
    ldl_panels_slab_winv,
)
from parapint_tpu_torch.utils.profile import host_sync

_SUBST_BASE = 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _ldl_unblocked(A: torch.Tensor) -> torch.Tensor:
    """Unpivoted LDL^T of (..., b, b) blocks by the column sweep over the
    true pivot column.  Returns the packed factor: strict lower = L, diagonal
    = D; the strict upper holds the untouched input (garbage)."""
    A = A.clone()
    b = A.shape[-1]
    for j in range(b):
        piv = A[..., j, j]
        piv_safe = torch.where(piv.abs() > 0, piv, torch.ones_like(piv))
        col = A[..., j + 1 :, j].clone()
        l = col / piv_safe[..., None]
        A[..., j + 1 :, j + 1 :] -= l[..., :, None] * col[..., None, :]
        A[..., j + 1 :, j] = l
    return A


def _unit_lower_inv_subst(L: torch.Tensor) -> torch.Tensor:
    """Exact forward substitution: L^{-1} for a small unit lower-triangular
    (..., r, r); row i solves w_i = e_i - L[i, :i] @ W[:i]."""
    r = L.shape[-1]
    eye = torch.eye(r, dtype=L.dtype, device=L.device)
    rows = []
    for i in range(r):
        w = eye[i].expand(L.shape[:-2] + (r,))
        if i:
            Wprev = torch.stack(rows, dim=-2)  # (..., i, r)
            w = w - (L[..., i : i + 1, :i] @ Wprev)[..., 0, :]
        rows.append(w)
    return torch.stack(rows, dim=-2)


def unit_lower_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of unit lower-triangular (..., n, n): static-halving block
    recursion over an exact-substitution base,

        [L11  0 ]^-1   [ W11           0  ]
        [L21 L22]    = [-W22 L21 W11  W22 ]

    (the reference's ``unit_lower_inv`` and its batched twin
    ``_unit_lower_inv_b`` are one function here)."""
    n = L.shape[-1]
    if n <= _SUBST_BASE:
        return _unit_lower_inv_subst(L)
    h = max(_SUBST_BASE, ((n // 2 + 7) // 8) * 8)
    if h >= n:
        h = n - _SUBST_BASE
    W11 = unit_lower_inv(L[..., :h, :h])
    W22 = unit_lower_inv(L[..., h:, h:])
    out = torch.zeros_like(L)
    out[..., :h, :h] = W11
    out[..., h:, :h] = -(W22 @ (L[..., h:, :h] @ W11))
    out[..., h:, h:] = W22
    return out


_unit_lower_inv_b = unit_lower_inv


def ruiz_scale(A: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Symmetric Ruiz equilibration scaling s for (..., n, n): s*A*s has rows
    with max magnitude ~1 (inertia is invariant under the congruence)."""
    s = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    absA = A.abs()
    for _ in range(iters):
        r = (absA * s[..., :, None] * s[..., None, :]).amax(dim=-1)
        r = torch.where(r > 0, r, torch.ones_like(r))
        s = s / torch.sqrt(r)
    return s


def ldl_inertia(d: torch.Tensor, n=None, zero_tol: float = 0.0):
    """Inertia (num_pos, num_neg, num_zero) of the pivots along the last
    axis of ``d``; entries at index >= ``n`` (factor padding) are excluded.
    Exact zeros only by default; NaN/Inf pivots count in no bucket, so
    pos + neg + zero < n signals a broken-down factorization."""
    npad = d.shape[-1]
    if n is None:
        n = npad
    valid = torch.arange(npad, device=d.device) < n
    dmax = torch.where(valid, d.abs(), torch.zeros_like(d)).amax(dim=-1, keepdim=True)
    tol = zero_tol * torch.clamp(dmax, min=1.0)
    is_zero = valid & (d.abs() <= tol)
    is_pos = valid & (d > tol)
    is_neg = valid & (d < -tol)
    i32 = torch.int32
    return (
        is_pos.sum(-1, dtype=i32),
        is_neg.sum(-1, dtype=i32),
        is_zero.sum(-1, dtype=i32),
    )


def _eye_pad(A: torch.Tensor, npad: int) -> torch.Tensor:
    """Zero-pad (..., n, n) to (..., npad, npad) with identity on the new
    diagonal: decoupled +1 pivots, excluded from the inertia through
    :func:`ldl_inertia`'s ``n``."""
    n = A.shape[-1]
    if npad == n:
        return A
    Ap = A.new_zeros(A.shape[:-2] + (npad, npad))
    Ap[..., :n, :n] = A
    idx = torch.arange(n, npad, device=A.device)
    with host_sync():  # the scalar 1.0 is copied from pageable host memory
        Ap[..., idx, idx] = 1.0
    return Ap


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() > 0, d, torch.ones_like(d))


def _panel_factor(Akk: torch.Tensor) -> torch.Tensor:
    """Packed LDL^T of one (b, b) panel: f32 panels up to 128 wide go to the
    ``ldl_panels`` entry of the panel kernel (any width), everything else to
    the column sweep (the reference's non-Pallas path)."""
    if Akk.dtype == torch.float32 and Akk.shape[-1] <= MAX_PANEL:
        return ldl_panels(Akk[None].contiguous())[0]
    return _ldl_unblocked(Akk)


def _slab_algo() -> bool:
    """Panel-algorithm selection, as the reference's ``_use_slab_kernel``:
    ``PT_PANEL_ALGO`` "slab" (the default) or "slab2" picks the slab entries
    for panel widths that are a multiple of 8; "column", and every other
    width, picks the column-by-column batched entries.  "slab2" is the
    reference's rank-2 form of the slab kernel, bitwise equal to the rank-1
    form, so it maps to the same entries.  Read once per factorization by
    :func:`_batched_sweep`: the port keeps no trace cache, so a change takes
    effect at the next factorization."""
    return os.environ.get("PT_PANEL_ALGO", "slab") in ("slab", "slab2")


def _panel_factor_batch(Akk: torch.Tensor, slab_algo: bool) -> torch.Tensor:
    """Batched packed LDL^T of (N, b, b) panels: f32 panels up to 128 wide go
    to ``ldl_panels_slab`` (``slab_algo`` and b % 8 == 0, see
    :func:`_slab_algo`) or ``ldl_panels_batched``; f64 and wider panels take
    the column sweep, as the reference's XLA path does."""
    b = Akk.shape[-1]
    if Akk.dtype == torch.float32 and b <= MAX_PANEL:
        entry = ldl_panels_slab if slab_algo and b % 8 == 0 else ldl_panels_batched
        return entry(Akk.contiguous())
    return _ldl_unblocked(Akk)


def _panel_factor_batch_winv(Akk: torch.Tensor, slab_algo: bool):
    """Batched panel factorization + panel inverse W = L^{-1}.

    f32 panels up to 128 wide go to ``ldl_panels_slab_winv`` (``slab_algo``
    and b % 8 == 0) or ``ldl_panels_batched_winv`` (kernel on CUDA, plain
    version on the CPU); other dtypes (the f64 reference runs) use the
    column sweep plus the recursive inverse, as the reference's non-Pallas
    path does."""
    b = Akk.shape[-1]
    if Akk.dtype == torch.float32 and b <= MAX_PANEL:
        entry = ldl_panels_slab_winv if slab_algo and b % 8 == 0 else ldl_panels_batched_winv
        return entry(Akk.contiguous())
    F = _ldl_unblocked(Akk)
    eye = torch.eye(b, dtype=Akk.dtype, device=Akk.device)
    return F, unit_lower_inv(torch.tril(F, -1) + eye)


# -- single-matrix dense LDL^T ------------------------------------------------


def _unit_lower_inv_rec(L: torch.Tensor, bs: int) -> torch.Tensor:
    """Recursive unit-lower-triangular inverse with static halving at
    ``bs`` multiples; leaves are :func:`unit_lower_inv`."""
    n = L.shape[-1]
    if n <= bs:
        return unit_lower_inv(L)
    h = ((n // 2 + bs - 1) // bs) * bs
    if h >= n:
        h = n - bs
    W11 = _unit_lower_inv_rec(L[..., :h, :h], bs)
    W22 = _unit_lower_inv_rec(L[..., h:, h:], bs)
    out = torch.zeros_like(L)
    out[..., :h, :h] = W11
    out[..., h:, :h] = -(W22 @ (L[..., h:, :h] @ W11))
    out[..., h:, h:] = W22
    return out


def unit_lower_inv_blocked(L: torch.Tensor, block_size: int = 128) -> torch.Tensor:
    """Inverse of a unit lower-triangular (..., n, n) (recursive halving);
    n is padded to a multiple of the block size with identity if needed."""
    n = L.shape[-1]
    bs = min(block_size, n)
    if n % bs != 0:
        return unit_lower_inv_blocked(_eye_pad(L, _round_up(n, bs)), bs)[..., :n, :n]
    return _unit_lower_inv_rec(L, bs)


def ldl_winv(LD: torch.Tensor, block_size: int = 128):
    """(W, d) with W = L^{-1} from a packed LDL factor (..., npad, npad):
    K^{-1} x = W^T (W x / d), two matmuls per application."""
    eye = torch.eye(LD.shape[-1], dtype=LD.dtype, device=LD.device)
    W = unit_lower_inv_blocked(torch.tril(LD, -1) + eye, block_size)
    return W, torch.diagonal(LD, dim1=-2, dim2=-1)


def winv_apply(W: torch.Tensor, d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K^{-1} b given W = L^{-1} (npad, npad) and pivots d; b is (n,) or
    (n, k) with n <= npad (zero-padded)."""
    npad = W.shape[-1]
    n = b.shape[0]
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    if n != npad:
        b = torch.nn.functional.pad(b, (0, 0, 0, npad - n))
    y = W @ b
    x = W.T @ (y / _safe(d)[:, None])
    x = x[:n]
    return x[:, 0] if vec else x


def ldl_inverse(LD: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Explicit K^{-1} = L^{-T} D^{-1} L^{-1} from a packed LDL factor."""
    W, _ = ldl_winv(LD)
    return W.T @ (W / _safe(d)[:, None])


def _ldl_panel_loop(A: torch.Tensor, bs: int) -> torch.Tensor:
    """Right-looking panel loop (the reference's ``fori`` and ``unrolled``
    forms, which differ only in how XLA sees the loop): per panel, factor
    the diagonal panel, solve the panel below through its explicit inverse,
    and update the trailing submatrix in place.  The strict upper triangle
    of the result is garbage, as in the reference."""
    A = A.clone()
    npad = A.shape[-1]
    eye = torch.eye(bs, dtype=A.dtype, device=A.device)
    for o in range(0, npad, bs):
        e = o + bs
        Fkk = _panel_factor(A[o:e, o:e])
        dk = torch.diagonal(Fkk)
        Winv = unit_lower_inv(torch.tril(Fkk, -1) + eye)
        X = A[e:, o:e] @ Winv.T  # L21 * D
        L21 = X / _safe(dk)[None, :]
        A[o:e, o:e] = Fkk
        A[e:, o:e] = L21
        A[e:, e:] -= L21 @ X.T
    return A


def _ldl_recursive(A: torch.Tensor, bs: int) -> torch.Tensor:
    """Recursive packed LDL^T with static halving at ``bs`` multiples."""
    n = A.shape[-1]
    if n <= bs:
        return _panel_factor(A)
    h = ((n // 2 + bs - 1) // bs) * bs
    if h >= n:
        h = n - bs
    F11 = _ldl_recursive(A[:h, :h], bs)
    L11 = torch.tril(F11, -1) + torch.eye(h, dtype=A.dtype, device=A.device)
    W11 = _unit_lower_inv_rec(L11, bs)
    X = A[h:, :h] @ W11.T  # L21 D1
    L21 = X / _safe(torch.diagonal(F11))[None, :]
    F22 = _ldl_recursive(A[h:, h:] - L21 @ X.T, bs)
    out = torch.zeros_like(A)
    out[:h, :h] = F11
    out[h:, :h] = L21
    out[h:, h:] = F22
    return out


def ldl_factor(A: torch.Tensor, block_size: int = 128, algorithm: str = "fori"):
    """Factor symmetric ``A`` (n, n) as L D L^T (unpivoted, 1x1 pivots).

    Returns ``(LD, d)``: the packed factor (npad, npad), npad = n rounded up
    to a multiple of ``block_size`` (identity padding, excluded from the
    inertia by :func:`ldl_inertia`'s ``n``), and its diagonal.
    ``algorithm``: "fori" / "unrolled" (the panel loop) or "recursive".
    """
    npad = _round_up(max(A.shape[-1], 1), block_size)
    A = _eye_pad(A, npad)
    if algorithm in ("fori", "unrolled"):
        LD = _ldl_panel_loop(A, block_size)
    elif algorithm == "recursive":
        LD = _ldl_recursive(A, block_size)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return LD, torch.diagonal(LD)


def ldl_solve(LD: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L D L^T x = b given packed factor(s) from :func:`ldl_factor` or
    :func:`ldl_factor_batched`.  LD (npad, npad) with b (n,) or (n, k), or
    LD (N, npad, npad) with b (N, n) or (N, n, k); n <= npad (zero-padded,
    the result truncated back).  b is cast to the factor's dtype."""
    npad = LD.shape[-1]
    vec = b.dim() == LD.dim() - 1
    if vec:
        b = b[..., None]
    n = b.shape[-2]
    b = b.to(LD.dtype)
    if n != npad:
        b = torch.nn.functional.pad(b, (0, 0, 0, npad - n))
    d = torch.diagonal(LD, dim1=-2, dim2=-1)
    y = torch.linalg.solve_triangular(LD, b, upper=False, unitriangular=True)
    z = y / _safe(d)[..., None]
    x = torch.linalg.solve_triangular(LD.mT, z, upper=True, unitriangular=True)
    x = x[..., :n, :]
    return x[..., 0] if vec else x


# -- batched LDL^T --------------------------------------------------------------


def _batched_sweep(A: torch.Tensor, block_size: int, panel_factor):
    """Batch-first right-looking LDL^T of (N, n, n): the panel width snaps
    UP to a multiple of 8 (the chain SC's 49-wide tiles factor as 56-wide
    panels) so f32 panels stay on the panel kernel, and the extra rows are
    identity padding.  ``panel_factor`` maps (N, b, b) panels to (packed
    factor, L^{-1}) and is told :func:`_slab_algo`, read once here.  Returns
    (LD padded to npad, block size, panel inverses)."""
    N, n, _ = A.shape
    slab_algo = _slab_algo()
    bs = min(block_size, _round_up(max(8, n), 8))
    npad = _round_up(max(n, 1), bs)
    T = _eye_pad(A, npad)
    LD = torch.zeros_like(T)
    leaves = []
    for o in range(0, npad, bs):
        Fkk, Wkk = panel_factor(T[:, :bs, :bs], slab_algo)
        leaves.append(Wkk)
        dk = torch.diagonal(Fkk, dim1=1, dim2=2)
        X = T[:, bs:, :bs] @ Wkk.transpose(1, 2)  # L21 * D
        L21 = X / _safe(dk)[:, None, :]
        T = T[:, bs:, bs:] - L21 @ X.transpose(1, 2)
        LD[:, o : o + bs, o : o + bs] = Fkk
        LD[:, o + bs :, o : o + bs] = L21
    return LD, bs, leaves


def _panel_factor_batch_inv(Akk: torch.Tensor, slab_algo: bool):
    F = _panel_factor_batch(Akk, slab_algo)
    eye = torch.eye(Akk.shape[-1], dtype=Akk.dtype, device=Akk.device)
    return F, unit_lower_inv(torch.tril(F, -1) + eye)


def ldl_factor_batched(A: torch.Tensor, block_size: int = 128):
    """Batched LDL^T: (N, n, n) -> (LD, d), padded to npad; the panels go to
    :func:`_panel_factor_batch` (see :func:`_batched_sweep`)."""
    LD, _, _ = _batched_sweep(A, block_size, _panel_factor_batch_inv)
    return LD, torch.diagonal(LD, dim1=1, dim2=2)


def _winv_from_leaves(LD: torch.Tensor, leaves, lo: int, hi: int, bs: int):
    """Batched W = L^{-1} of LD[:, lo:hi, lo:hi] by recursive halving, with
    the diagonal-panel inverses supplied (``leaves[k]`` inverts panel k)."""
    n = hi - lo
    if n <= bs:
        return leaves[lo // bs]
    h = ((n // 2 + bs - 1) // bs) * bs
    if h >= n:
        h = n - bs
    W11 = _winv_from_leaves(LD, leaves, lo, lo + h, bs)
    W22 = _winv_from_leaves(LD, leaves, lo + h, hi, bs)
    # off-diagonal blocks of the packed factor lie entirely below the
    # diagonal: they ARE L21
    L21 = LD[:, lo + h : hi, lo : lo + h]
    out = torch.zeros((LD.shape[0], n, n), dtype=LD.dtype, device=LD.device)
    out[:, :h, :h] = W11
    out[:, h:, :h] = -(W22 @ (L21 @ W11))
    out[:, h:, h:] = W22
    return out


def ldl_factor_winv_batched(A: torch.Tensor, block_size: int = 128):
    """Batched LDL^T that also returns the global W = L^{-1}: (N, n, n) ->
    (LD, d, W), all padded to npad.  The panel inverses come out of
    :func:`_panel_factor_batch_winv` and W is assembled from them by
    recursive halving."""
    LD, bs, leaves = _batched_sweep(A, block_size, _panel_factor_batch_winv)
    W = _winv_from_leaves(LD, leaves, 0, LD.shape[-1], bs)
    return LD, torch.diagonal(LD, dim1=1, dim2=2), W
