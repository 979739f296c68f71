"""Read-only streaming probe K7: the CUDA kernel and its plain PyTorch version.

Counterpart of ``tools/kernel_lab.py::cmd_bw`` (inner Pallas body ``kern``):
the column sums ``W.sum(1, keepdim=True)`` of a batch of (n, n) float32
matrices, (B, n, n) -> (B, 1, n).  It reads W once and does almost no
arithmetic, so its rate is what a pure read of W reaches on the card: the
ceiling of the W-form back solve K6 (``ops/winv_apply.py``), which reads the
same bytes through the same build and launch path.  The kernel source is
``parapint_tpu_torch/csrc/read_reduce.cu``.

The Pallas probe swept ``C``, the matrices per grid step, a TPU block choice.
Here the knob is ``rows_per_cta``, the rows of one matrix a CTA sums
(default: K6's 64).  The sum runs in a fixed order, each tile of
``rows_per_cta`` rows down its rows, then the tiles in order, so kernel and
plain version agree bit for bit.

The wrapper :func:`read_reduce` takes the plain version only for a tensor on
the CPU.  For a CUDA tensor it launches the kernel (a row pass and a tile
reduction, on the current stream) or raises, and adds one to
``read_reduce.launches`` per call.
"""

import ctypes

import torch

from parapint_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "read_reduce.cu"
ROWS_PER_CTA = 64  # K6's rows per CTA (kRows in csrc/winv_apply.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"read_reduce_f32": [_P, _P, _P, _I, _I, _I, _P]}


def _load() -> ctypes.CDLL:
    return cuda_build.load(SOURCE, SIGNATURES)


def read_reduce_plain(W: torch.Tensor, rows_per_cta: int = ROWS_PER_CTA) -> torch.Tensor:
    """Plain version: W (B, n, n) -> (B, 1, n) column sums, added in the
    kernel's order (rows of each tile in order from 0, then the tiles in
    order from 0)."""
    B, n, _ = W.shape
    rows = max(1, min(rows_per_cta, n))  # one tile of n rows sums as one of more
    ntiles = -(-n // rows)
    # zero rows past n leave every partial sum unchanged (x + 0 == x)
    Wt = torch.nn.functional.pad(W, (0, 0, 0, ntiles * rows - n)).reshape(B, ntiles, rows, n)
    part = torch.zeros((B, ntiles, n), dtype=W.dtype, device=W.device)
    for i in range(rows):
        part += Wt[:, :, i, :]
    out = torch.zeros((B, n), dtype=W.dtype, device=W.device)
    for t in range(ntiles):
        out += part[:, t, :]
    return out[:, None, :]


def _check(W: torch.Tensor, rows_per_cta: int) -> None:
    if W.dim() != 3 or W.shape[1] != W.shape[2]:
        raise ValueError(f"expected W (B, n, n), got {tuple(W.shape)}")
    if W.dtype != torch.float32:
        raise TypeError(f"W must be float32, got {W.dtype}")
    if W.shape[-1] % 4 != 0:
        raise ValueError(f"n={W.shape[-1]} must be a multiple of 4 (16-byte loads)")
    if not W.is_contiguous():
        raise ValueError("W must be contiguous")
    if rows_per_cta < 1:
        raise ValueError(f"rows_per_cta={rows_per_cta} must be >= 1")
    if W.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {W.device}")


def read_reduce(W: torch.Tensor, rows_per_cta: int = ROWS_PER_CTA) -> torch.Tensor:
    """Column sums of W (B, n, n) f32 -> (B, 1, n) f32; n % 4 == 0.  CPU: the
    plain version; CUDA: the kernel (the call does not synchronise)."""
    _check(W, rows_per_cta)
    if W.device.type == "cpu":
        return read_reduce_plain(W, rows_per_cta)
    B, n, _ = W.shape
    out = torch.empty((B, 1, n), dtype=torch.float32, device=W.device)
    if B == 0 or n == 0:
        return out
    if W.data_ptr() % 16 != 0:
        raise ValueError("W must be 16-byte aligned")
    partial = torch.empty((B, -(-n // rows_per_cta), n), dtype=torch.float32, device=W.device)
    lib = _load()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.read_reduce_f32(W.data_ptr(), partial.data_ptr(), out.data_ptr(), B, n,
                                  rows_per_cta, stream)
    if err != 0:
        raise RuntimeError(f"read_reduce launch failed: cudaError {err}")
    read_reduce.launches += 1
    return out


read_reduce.launches = 0
