"""Banded matrices: storage, products and block-tridiagonal tiling
(counterpart of ``parapint_tpu.ops.banded``).

A general banded matrix B (n x n) with bands d in [-p, p] is stored
row-indexed, ``bands[d + p, i] = B[i, i + d]`` (zero where the column falls
outside [0, n)).  A symmetric matrix G with half-bandwidth p is stored as
its lower bands, ``sym_bands[e, i] = G[i + e, i]`` for e in [0, p].  Tiled
into ts x ts tiles with ts >= p it is block-tridiagonal, which the banded
Schur solver factors by a block-Thomas sweep and the condensed solver by
cyclic reduction.

Every function is an O(n p) (``banded_btb``: O(n p^2)) stencil of shifted
slices; leading batch dimensions broadcast.
"""

import torch
import torch.nn.functional as F


def _shift(v: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., i] = v[..., i - d] where 0 <= i - d < n, else 0."""
    n = v.shape[-1]
    if d >= 0:
        return F.pad(v[..., : n - d], (d, 0))
    return F.pad(v[..., -d:], (0, -d))


def banded_matvec(bands: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """B @ x for row-indexed band stores: bands (..., 2p+1, n), x (..., n),
    leading dimensions broadcast."""
    p = (bands.shape[-2] - 1) // 2
    out = None
    for d in range(-p, p + 1):
        # y[i] += B[i, i+d] x[i+d]
        term = bands[..., d + p, :] * _shift(x, -d)
        out = term if out is None else out + term
    return out


def banded_rmatvec(bands: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """B^T @ y for row-indexed band stores: bands (..., 2p+1, n), y (..., n),
    leading dimensions broadcast."""
    p = (bands.shape[-2] - 1) // 2
    out = None
    for d in range(-p, p + 1):
        # (B^T y)[i+d] += B[i, i+d] y[i]
        term = _shift(bands[..., d + p, :] * y, d)
        out = term if out is None else out + term
    return out


def banded_btb(bands: torch.Tensor) -> torch.Tensor:
    """Lower bands of B^T B: bands (..., 2p+1, n) -> (..., 2p+1, n) with
    out[e, i] = (B^T B)[i+e, i], e in [0, 2p].

    (B^T B)[i+e, i] = sum_d B[i-d, i] B[i-d, i+e]
                    = sum_d bands[d+p, i-d] bands[d+e+p, i-d],
    each product formed at row i-d and shifted by d.
    """
    p = (bands.shape[-2] - 1) // 2
    n = bands.shape[-1]
    keep = torch.arange(n, device=bands.device)
    out = []
    for e in range(2 * p + 1):
        acc = torch.zeros_like(bands[..., 0, :])
        for d in range(-p, p - e + 1):
            acc = acc + _shift(bands[..., d + p, :] * bands[..., d + e + p, :], d)
        # column i + e must lie in the matrix for the symmetric store
        out.append(torch.where(keep + e < n, acc, 0.0))
    return torch.stack(out, dim=-2)


def sym_banded_matvec(sym_bands: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """G @ x for one symmetric banded matrix; sym_bands (p+1, n), x (n,) or
    (n, k).  An O(n * p) stencil: no dense (n, n) operand."""
    pp1, n = sym_bands.shape
    vec = x.dim() == 1
    if vec:
        x = x[:, None]
    out = sym_bands[0][:, None] * x
    for e in range(1, pp1):
        band = sym_bands[e, : n - e][:, None]  # G[i+e, i], i < n - e
        lower = torch.zeros_like(out)
        lower[e:] = band * x[: n - e]  # y[i+e] += G[i+e, i] x[i]
        upper = torch.zeros_like(out)
        upper[: n - e] = band * x[e:]  # y[i] += G[i+e, i] x[i+e]
        out = out + lower + upper
    return out[:, 0] if vec else out


def sym_band_to_tridiag_tiles(sym_bands: torch.Tensor, ts: int):
    """Tile symmetric banded matrices (..., p+1, n) with p <= ts and
    n % ts == 0 into block-tridiagonal tiles: (diag (..., m, ts, ts),
    upper (..., m-1, ts, ts)) with upper[g] = G[tile g, tile g+1].

    Skew construction: per tile g, X[b, e] = G[g*ts+b+e, g*ts+b]; padding
    each row of X to width W+1 (W = ts + p + 1), flattening, dropping the
    tail and re-viewing as (ts, W) shifts row b right by b, so the
    transpose holds the dense lower trapezoid of the tile column.
    """
    *lead, pp1, n = sym_bands.shape
    p = pp1 - 1
    if p > ts:
        raise ValueError(f"half-bandwidth {p} exceeds tile size {ts}")
    if n % ts != 0:
        raise ValueError(f"n={n} not a multiple of tile size {ts}")
    m = n // ts
    X = sym_bands.reshape(*lead, pp1, m, ts).movedim(-3, -1)  # (..., m, ts, pp1)
    W = ts + pp1
    Xp = F.pad(X, (0, W + 1 - pp1))  # (..., m, ts, W+1)
    Z = Xp.reshape(*lead, m, ts * (W + 1))[..., : ts * W].reshape(*lead, m, ts, W)
    Mfull = Z.transpose(-1, -2)  # (..., m, W, ts)
    Lw = Mfull[..., :ts, :]
    diag = Lw + torch.tril(Lw, -1).transpose(-1, -2)
    r = min(pp1, ts)
    upper = Mfull[..., :-1, ts : ts + r, :].transpose(-1, -2)  # (..., m-1, ts, r)
    if r < ts:
        upper = F.pad(upper, (0, ts - r))
    return diag, upper


def pad_sym_band(sym_bands: torch.Tensor, ts: int):
    """Pad a band store (..., p+1, n) so n becomes a multiple of ts; padded
    rows are identity (+1 pivots, decoupled).  Returns (padded, n_pad)."""
    *lead, pp1, n = sym_bands.shape
    rem = (-n) % ts
    if rem == 0:
        return sym_bands, 0
    pad = torch.zeros((*lead, pp1, rem), dtype=sym_bands.dtype, device=sym_bands.device)
    pad[..., 0, :] = 1.0
    return torch.cat([sym_bands, pad], dim=-1), rem
