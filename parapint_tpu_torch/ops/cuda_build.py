"""Build and load the port's native code.

Each ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a``, and each
``csrc/*.cpp`` file (the host Bunch-Kaufman factorization) with ``g++``,
into a plain C-ABI shared library under ``parapint_tpu_torch/_build/``
(gitignored), keyed by a hash of the source and the flags, and loaded with
``ctypes``.  A fresh checkout therefore builds a library at its first use;
:func:`build_all` compiles several sources at once (one compiler process
each, started together).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# the JAX package's flags for the same host source (parapint_tpu/native)
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_libs: Dict[Path, ctypes.CDLL] = {}
# compiler output of each build that actually compiled (absent when the
# library existed already): ptxas reports registers, shared memory, spills
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return found


def _compiler(source: Path):
    """(compiler, flags) for ``source``: nvcc for ``.cu``, g++ otherwise."""
    if source.suffix == ".cu":
        return nvcc(), NVCC_FLAGS
    return "g++", GXX_FLAGS


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives (hash of source + flags)."""
    flags = NVCC_FLAGS if source.suffix == ".cu" else GXX_FLAGS
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{key}.so"


def _start(source: Path):
    """Start the compiler for ``source`` unless its library exists; returns
    (out, tmp, process) or None."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    compiler, flags = _compiler(source)
    cmd = [compiler, *flags, "-o", tmp, str(source)]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(source: Path, started) -> Path:
    if started is None:
        return library_path(source)
    out, tmp, proc = started
    try:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{proc.args[0]} failed on {source.name} ({proc.returncode}):\n{log}")
        # written under a temporary name and renamed, so concurrent first
        # uses never load a half-written file
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_logs[source.name] = log
    return out


def build(source: Path) -> Path:
    """Compile ``source`` if its library is not built yet; returns its path."""
    return _finish(source, _start(source))


def build_all(sources: Iterable[Path]) -> Dict[str, Path]:
    """Compile every source not built yet, all nvcc processes at once."""
    sources = list(sources)
    started = [_start(s) for s in sources]
    return {s.name: _finish(s, st) for s, st in zip(sources, started)}


def load(source: Path, signatures: Optional[dict] = None, restype=ctypes.c_int) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use).  ``signatures``
    maps a C function name to its argtypes; every function returns
    ``restype``."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for name, argtypes in (signatures or {}).items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[source] = lib
    return lib
