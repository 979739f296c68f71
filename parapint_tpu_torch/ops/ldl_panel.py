"""Batched LDL^T panel factorizations (with and without W = L^{-1}): the CUDA
kernel's five entries and their plain PyTorch versions.

Counterparts of ``parapint_tpu/ops/pallas_ldl.py``:

- :func:`ldl_panels_slab_winv` — ``ldl_panels_slab_winv`` (Pallas body
  ``_make_slab_kernel(with_w=True)``), packed LDL^T and W, b % 8 == 0;
- :func:`ldl_panels_slab` — ``ldl_panels_slab`` (``with_w=False``), packed
  LDL^T, b % 8 == 0;
- :func:`ldl_panels` — ``ldl_panels`` (``_panel_kernel``), packed LDL^T of
  any width 1 <= b <= 128;
- :func:`ldl_panels_batched_winv` — ``ldl_panels_batched_winv``
  (``_panel_kernel_batched_winv``), packed LDL^T and W, any width;
- :func:`ldl_panels_batched` — ``ldl_panels_batched``
  (``_panel_kernel_batched``), packed LDL^T, any width.

One kernel template serves all five, ``parapint_tpu_torch/csrc/ldl_panel_winv.cu``
(``kWithW`` true for the two W entries, false for the other three); its
header says what bounds it on the card and how the design answers that.
The Pallas kernels' batch chunk (``chunk``, ``winv_max_chunk``) models the
TPU's VMEM and has no counterpart: one CTA per panel spreads a batch over
the SMs.

Each wrapper takes its plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises, and adds one to its own
``launches`` count.  The kernel is compiled with ``nvcc`` at first use
(``ops/cuda_build.py``).
"""

import ctypes
from typing import Tuple

import numpy as np
import torch

from parapint_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "ldl_panel_winv.cu"
MAX_PANEL = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "ldl_panel_winv_f32": [_P, _P, _P, _I, _I, _P],
    "ldl_panel_f32": [_P, _P, _I, _I, _P],
}


def _load() -> ctypes.CDLL:
    return cuda_build.load(SOURCE, SIGNATURES)


def _sweep(A: torch.Tensor, with_w: bool):
    """Right-looking unblocked sweep over the true pivot column, plus (with
    ``with_w``) the W = L^{-1} recurrence W[j+1:] -= l (x) W[j].  Only the
    lower triangle of A is read; the strict upper of the result is 0."""
    B, b, _ = A.shape
    M = torch.tril(A)
    W = torch.eye(b, dtype=A.dtype, device=A.device).expand(B, b, b).clone() if with_w else None
    for j in range(b):
        piv = M[:, j, j]
        piv_safe = torch.where(piv.abs() > 0, piv, torch.ones_like(piv))
        col = M[:, j + 1 :, j]
        l = col / piv_safe[:, None]
        M[:, j + 1 :, j + 1 :] -= torch.tril(l[:, :, None] * col[:, None, :])
        M[:, j + 1 :, j] = l
        if with_w:
            W[:, j + 1 :, : j + 1] -= l[:, :, None] * W[:, None, j, : j + 1]
    return M, W


def ldl_panels_slab_winv_plain(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ldl_panels_slab_winv` and
    :func:`ldl_panels_batched_winv`: A (B, b, b) -> (LD, W), LD packed
    (strict lower = unit L, diagonal = D, strict upper = 0).  Zero pivots
    divide by 1."""
    return _sweep(A, with_w=True)


def ldl_panels_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ldl_panels`, :func:`ldl_panels_slab` and
    :func:`ldl_panels_batched`: A (B, b, b) -> packed LD."""
    return _sweep(A, with_w=False)[0]


ldl_panels_slab_plain = ldl_panels_plain
ldl_panels_batched_plain = ldl_panels_plain
ldl_panels_batched_winv_plain = ldl_panels_slab_winv_plain


def random_panels(B, b, seed, garbage_upper=False, zero_pivot=False) -> np.ndarray:
    """Seeded symmetric indefinite float32 panels (B, b, b) with a strong
    mixed-sign diagonal, for holding the kernel against its plain version
    (the construction of the JAX package's slab-kernel tests).

    ``garbage_upper`` overwrites the strict upper triangle with large noise
    (only the lower triangle may be read); ``zero_pivot`` decouples row and
    column b // 2, an exact-zero pivot.
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, b, b))
    A = (A + A.transpose(0, 2, 1)) / 2
    signs = np.where(rng.random((B, b)) < 0.3, -1.0, 1.0)
    A += np.einsum("bi,ij->bij", signs * 2 * b, np.eye(b))
    if garbage_upper:
        iu = np.triu_indices(b, 1)
        A[:, iu[0], iu[1]] = rng.standard_normal((B, len(iu[0]))) * 1e3
    if zero_pivot:
        k = b // 2
        A[:, k, :] = 0.0
        A[:, :, k] = 0.0
    return A.astype(np.float32)


def _check(A: torch.Tensor, multiple_of_8: bool) -> None:
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"expected (B, b, b) panels, got {tuple(A.shape)}")
    b = A.shape[-1]
    if not 0 < b <= MAX_PANEL or (multiple_of_8 and b % 8 != 0):
        need = "a multiple of 8 and " if multiple_of_8 else ""
        raise ValueError(f"panel size b={b} must be {need}<= {MAX_PANEL}")
    if A.dtype != torch.float32:
        raise TypeError(f"expected float32 panels, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("panels must be contiguous")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A.device}")


def _launch(name: str, A: torch.Tensor, *outs: torch.Tensor) -> None:
    B, b, _ = A.shape
    lib = _load()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = getattr(lib, name)(A.data_ptr(), *(o.data_ptr() for o in outs), B, b, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _w_entry(entry, A: torch.Tensor, multiple_of_8: bool):
    """The shared body of the two W entries: check, then the plain version
    on the CPU or one launch counted on ``entry``."""
    _check(A, multiple_of_8)
    if A.device.type == "cpu":
        return ldl_panels_slab_winv_plain(A)
    LD, W = torch.empty_like(A), torch.empty_like(A)
    if A.shape[0]:
        _launch("ldl_panel_winv_f32", A, LD, W)
        entry.launches += 1
    return LD, W


def ldl_panels_slab_winv(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, b, b) f32 symmetric panels -> (packed LD, W = L^{-1}); b % 8 == 0
    and b <= 128.  CPU: the plain version; CUDA: the kernel on the current
    stream (the call does not synchronise)."""
    return _w_entry(ldl_panels_slab_winv, A, multiple_of_8=True)


def ldl_panels_batched_winv(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, b, b) f32 symmetric panels -> (packed LD, W = L^{-1}); any
    1 <= b <= 128 (the column-by-column entry: ``PT_PANEL_ALGO=column`` and
    widths that are not a multiple of 8)."""
    return _w_entry(ldl_panels_batched_winv, A, multiple_of_8=False)


def _no_w_entry(entry, A: torch.Tensor, multiple_of_8: bool) -> torch.Tensor:
    """The shared body of the two no-W entries: check, then the plain
    version on the CPU or one launch counted on ``entry``."""
    _check(A, multiple_of_8)
    if A.device.type == "cpu":
        return ldl_panels_plain(A)
    LD = torch.empty_like(A)
    if A.shape[0]:
        _launch("ldl_panel_f32", A, LD)
        entry.launches += 1
    return LD


def ldl_panels_slab(A: torch.Tensor) -> torch.Tensor:
    """(B, b, b) f32 symmetric panels -> packed LD; b % 8 == 0 and b <= 128
    (the batched no-W factorization of ``ldl_factor_batched``)."""
    return _no_w_entry(ldl_panels_slab, A, multiple_of_8=True)


def ldl_panels(A: torch.Tensor) -> torch.Tensor:
    """(B, b, b) f32 symmetric panels -> packed LD; any 1 <= b <= 128 (the
    per-panel factorization of the dense ``ldl_factor``)."""
    return _no_w_entry(ldl_panels, A, multiple_of_8=False)


def ldl_panels_batched(A: torch.Tensor) -> torch.Tensor:
    """(B, b, b) f32 symmetric panels -> packed LD; any 1 <= b <= 128 (the
    column-by-column batched factorization of ``ldl_factor_batched``)."""
    return _no_w_entry(ldl_panels_batched, A, multiple_of_8=False)


ENTRIES = (
    ldl_panels_slab_winv, ldl_panels_slab, ldl_panels, ldl_panels_batched_winv, ldl_panels_batched,
)
for _entry in ENTRIES:
    _entry.launches = 0
