"""Batched LDL^T + L^{-1} panel factorization: the CUDA kernel and its plain
PyTorch version.

Counterpart of ``parapint_tpu/ops/pallas_ldl.py::ldl_panels_slab_winv``
(Pallas body ``_make_slab_kernel(with_w=True)``).  The kernel source is
``parapint_tpu_torch/csrc/ldl_panel_winv.cu``; its header says what bounds
it on the card and how the design answers that.

The wrapper :func:`ldl_panels_slab_winv` takes the plain version only for a
tensor on the CPU.  For a CUDA tensor it launches the kernel or raises.

The kernel is compiled with ``nvcc`` at first use into
``parapint_tpu_torch/_build/`` (a plain C-ABI shared library keyed by a hash
of the source, loaded with ``ctypes``), so a fresh checkout builds it on the
first factorization.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ldl_panel_winv.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
MAX_PANEL = 128

_lib: Optional[ctypes.CDLL] = None
# compiler output of the build that actually compiled (None when the
# library existed already): ptxas reports registers, shared memory, spills
build_log: Optional[str] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: cannot build the LDL panel kernel")
    return found


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path.

    The library name carries a hash of the source and the flags, so an edit
    to either rebuilds.  The output is written under a temporary name and
    renamed, so concurrent first uses never load a half-written file.
    """
    global build_log
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libldl_panel_winv-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log = proc.stdout + proc.stderr
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.ldl_panel_winv_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ldl_panels_slab_winv_plain(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: right-looking unblocked sweep over the true
    pivot column plus the W = L^{-1} recurrence W[j+1:] -= l (x) W[j].

    A (B, b, b) -> (LD, W), both (B, b, b): strict lower of LD = unit L,
    diagonal = D, strict upper = 0; only the lower triangle of A is read.
    Zero pivots divide by 1.
    """
    B, b, _ = A.shape
    M = torch.tril(A)
    W = torch.eye(b, dtype=A.dtype, device=A.device).expand(B, b, b).clone()
    for j in range(b):
        piv = M[:, j, j]
        piv_safe = torch.where(piv.abs() > 0, piv, torch.ones_like(piv))
        col = M[:, j + 1 :, j]
        l = col / piv_safe[:, None]
        M[:, j + 1 :, j + 1 :] -= torch.tril(l[:, :, None] * col[:, None, :])
        M[:, j + 1 :, j] = l
        W[:, j + 1 :, : j + 1] -= l[:, :, None] * W[:, None, j, : j + 1]
    return M, W


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


def _check(A: torch.Tensor) -> None:
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"expected (B, b, b) panels, got {tuple(A.shape)}")
    b = A.shape[-1]
    if b % 8 != 0 or not 0 < b <= MAX_PANEL:
        raise ValueError(f"panel size b={b} must be a multiple of 8 and <= {MAX_PANEL}")
    if A.dtype != torch.float32:
        raise TypeError(f"expected float32 panels, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("panels must be contiguous")


def ldl_panels_slab_winv(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, b, b) f32 symmetric panels -> (packed LD, W = L^{-1}).

    b % 8 == 0 and b <= 128.  A CPU tensor goes through
    :func:`ldl_panels_slab_winv_plain`; a CUDA tensor through the kernel,
    on the current stream (the call does not synchronise).  Each kernel
    launch adds one to ``ldl_panels_slab_winv.launches``.
    """
    _check(A)
    if A.device.type == "cpu":
        return ldl_panels_slab_winv_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    B, b, _ = A.shape
    LD = torch.empty_like(A)
    W = torch.empty_like(A)
    if B == 0:
        return LD, W
    lib = _load()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.ldl_panel_winv_f32(
            A.data_ptr(), LD.data_ptr(), W.data_ptr(), B, b, stream
        )
    if err != 0:
        raise RuntimeError(f"ldl_panel_winv_f32 launch failed: cudaError {err}")
    ldl_panels_slab_winv.launches += 1
    return LD, W


ldl_panels_slab_winv.launches = 0
