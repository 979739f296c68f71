"""Batched dense LDL^T with inertia and explicit W = L^{-1}: the subset of
``parapint_tpu.ops.ldl`` that the banded Schur solver runs.

Unpivoted LDL^T with 1x1 pivots, right-looking over panels: each panel is
factored by :func:`parapint_tpu_torch.ops.ldl_panel.ldl_panels_slab_winv`
(the CUDA kernel for f32 CUDA tensors), the panel solve and trailing update
are batched matmuls, and the global W is assembled from the panel inverses
by recursive halving.  Inverses use the block-recursive form, never Neumann
doubling (``parapint_tpu/ops/ldl.py:167-187`` records that doubling lost
every digit on the Burgers chain Schur complements).
"""

import torch

from parapint_tpu_torch.ops.ldl_panel import MAX_PANEL, ldl_panels_slab_winv

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


def _unit_lower_inv_b(L: torch.Tensor) -> torch.Tensor:
    """Batched inverse of unit lower-triangular (N, b, b): static-halving
    recursion over an exact-substitution base."""
    n = L.shape[-1]
    if n <= _SUBST_BASE:
        return _unit_lower_inv_subst(L)
    h = max(_SUBST_BASE, ((n // 2 + 7) // 8) * 8)
    if h >= n:
        h = n - _SUBST_BASE
    W11 = _unit_lower_inv_b(L[:, :h, :h])
    W22 = _unit_lower_inv_b(L[:, h:, h:])
    W21 = -(W22 @ (L[:, h:, :h] @ W11))
    out = torch.zeros_like(L)
    out[:, :h, :h] = W11
    out[:, h:, :h] = W21
    out[:, h:, h:] = W22
    return out


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


def _panel_factor_batch_winv(Akk: torch.Tensor):
    """Batched panel factorization + panel inverse W = L^{-1}.

    f32 panels with b % 8 == 0 and b <= 128 go to the panel kernel's
    wrapper (kernel on CUDA, plain version on the CPU); other dtypes (the
    f64 reference runs) use the column sweep plus the recursive inverse,
    as the reference's non-Pallas path does."""
    b = Akk.shape[-1]
    if Akk.dtype == torch.float32 and b <= MAX_PANEL and b % 8 == 0:
        return ldl_panels_slab_winv(Akk.contiguous())
    F = _ldl_unblocked(Akk)
    eye = torch.eye(b, dtype=Akk.dtype, device=Akk.device)
    return F, _unit_lower_inv_b(torch.tril(F, -1) + eye)


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
    (LD, d, W), all padded to npad (identity padding, excluded from the
    inertia through ``ldl_inertia``'s ``n``).

    The panel width snaps UP to a multiple of 8 (e.g. the chain SC's 49-wide
    tiles factor as 56-wide panels), so odd tiles stay on the panel kernel.
    """
    N, n, _ = A.shape
    bs = min(block_size, _round_up(max(8, n), 8))
    npad = _round_up(max(n, 1), bs)
    if npad != n:
        Ap = torch.zeros((N, npad, npad), dtype=A.dtype, device=A.device)
        Ap[:, :n, :n] = A
        idx = torch.arange(n, npad, device=A.device)
        Ap[:, idx, idx] = 1.0
        A = Ap
    nb = npad // bs
    LD = torch.zeros_like(A)
    leaves = []
    T = A
    for k in range(nb):
        o = k * bs
        Fkk, Wkk = _panel_factor_batch_winv(T[:, :bs, :bs])
        leaves.append(Wkk)
        dk = torch.diagonal(Fkk, dim1=1, dim2=2)
        X = T[:, bs:, :bs] @ Wkk.transpose(1, 2)  # L21 * D
        dk_safe = torch.where(dk.abs() > 0, dk, torch.ones_like(dk))
        L21 = X / dk_safe[:, None, :]
        T = T[:, bs:, bs:] - L21 @ X.transpose(1, 2)
        LD[:, o : o + bs, o : o + bs] = Fkk
        LD[:, o + bs :, o : o + bs] = L21
    W = _winv_from_leaves(LD, leaves, 0, npad, bs)
    return LD, torch.diagonal(LD, dim1=1, dim2=2), W
