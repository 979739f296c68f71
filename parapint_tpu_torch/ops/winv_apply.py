"""W-form block back solve: the CUDA kernel and its plain PyTorch version.

Counterpart of ``parapint_tpu/ops/winv_apply.py::winv_apply_fused`` (Pallas
body ``_apply_kernel``): batched K_b^{-1} rhs_b = s_b W_b^T D_b^{-1} W_b
(s_b rhs_b) with W = L^{-1} of the Ruiz-scaled blocks, stored in f32 or bf16
and accumulated in f32.  The kernel source is
``parapint_tpu_torch/csrc/winv_apply.cu``; its header says what bounds it
(bytes: W is read once) and how the design answers that.  The TPU-only
``PT_APPLY_ALGO=dot`` variant of the reference has no counterpart.

The wrapper :func:`winv_apply_fused` takes the plain version only for a
tensor on the CPU.  For a CUDA tensor it launches the kernel (a row pass and
a tile reduction, on the current stream) or raises, and adds one to
``winv_apply_fused.launches`` per call (and to ``launches_bf16`` when W is
bf16).
"""

import ctypes

import torch

from parapint_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "winv_apply.cu"
MAX_N = 4096

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "winv_apply_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "winv_apply_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "winv_apply_rows_per_cta": [],
}


def _load() -> ctypes.CDLL:
    return cuda_build.load(SOURCE, SIGNATURES)


def winv_apply_plain(W, d, s, b) -> torch.Tensor:
    """Plain version: the two-GEMV form (``parapint_tpu/linalg/schur.py:317-328``).
    W (B, n, n), d (B, n), s and b (B, nk) -> (B, nk), computed in f32 for an
    f32 or bf16 W (f64 for an f64 W); b pads with 0 past nk; zero pivots
    divide by 1."""
    cdt = torch.promote_types(W.dtype, torch.float32)
    nk = b.shape[-1]
    n = W.shape[-1]
    Wc = W.to(cdt)
    sf = s.to(cdt)
    v = b.to(cdt) * sf
    if n != nk:
        v = torch.nn.functional.pad(v, (0, n - nk))
    df = d.to(cdt)
    d_safe = torch.where(df.abs() > 0, df, torch.ones_like(df))
    y = (Wc @ v[:, :, None])[..., 0]
    x = (Wc.transpose(1, 2) @ (y / d_safe)[:, :, None])[..., 0]
    return x[:, :nk] * sf


def _check(W, d, s, b) -> None:
    if W.dim() != 3 or W.shape[1] != W.shape[2]:
        raise ValueError(f"expected W (B, n, n), got {tuple(W.shape)}")
    B, n, _ = W.shape
    if W.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"W must be float32 or bfloat16, got {W.dtype}")
    if n % 8 != 0 or n > MAX_N:
        raise ValueError(f"block size n={n} must be a multiple of 8 and <= {MAX_N}")
    nk = b.shape[-1]
    shapes = {"d": (d, (B, n)), "s": (s, (B, nk)), "b": (b, (B, nk))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if nk > n:
        raise ValueError(f"nk={nk} exceeds n={n}")
    for t in (W, d, s, b):
        if not t.is_contiguous():
            raise ValueError("W, d, s and b must be contiguous")
        if t.device != W.device:
            raise ValueError("W, d, s and b must be on one device")
    if W.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {W.device}")


def winv_apply_fused(W, d, s, b) -> torch.Tensor:
    """Batched K^{-1} b with one pass over W per block: W (B, n, n) f32 or
    bf16, d (B, n) f32, s and b (B, nk) f32 -> (B, nk) f32.  CPU: the plain
    version; CUDA: the kernel (the call does not synchronise)."""
    _check(W, d, s, b)
    if W.device.type == "cpu":
        return winv_apply_plain(W, d, s, b)
    B, n, _ = W.shape
    nk = b.shape[-1]
    x = torch.empty((B, nk), dtype=torch.float32, device=W.device)
    if B == 0:
        return x
    lib = _load()
    rows = lib.winv_apply_rows_per_cta()
    partial = torch.empty((B, -(-n // rows), n), dtype=torch.float32, device=W.device)
    fn = lib.winv_apply_bf16 if W.dtype == torch.bfloat16 else lib.winv_apply_f32
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(W.data_ptr(), d.data_ptr(), s.data_ptr(), b.data_ptr(),
                 partial.data_ptr(), x.data_ptr(), B, n, nk, stream)
    if err != 0:
        raise RuntimeError(f"winv_apply launch failed: cudaError {err}")
    winv_apply_fused.launches += 1
    winv_apply_fused.launches_bf16 += W.dtype == torch.bfloat16
    return x


winv_apply_fused.launches = 0
winv_apply_fused.launches_bf16 = 0
