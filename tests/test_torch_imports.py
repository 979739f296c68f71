"""Import guard: the PyTorch port never imports JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "parapint_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "parapint_tpu")
SOURCES = sorted(PKG.rglob("*.py"))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_package_has_sources():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES}
    assert {
        "__init__.py", "ops/ldl_panel.py", "ops/winv_apply.py", "ops/cuda_build.py",
        "linalg/dense.py", "linalg/schur.py", "algorithms/fused.py",
        "algorithms/interior_point.py", "interfaces/single.py", "interfaces/stochastic.py",
        "models/model.py", "models/ad.py", "utils/timer.py", "utils/checkpoint.py",
        "utils/device.py", "examples/stochastic.py", "examples/dynamics.py",
        "examples/interior_point.py", "ops/read_reduce.py", "utils/profile.py",
        "tools/__init__.py", "tools/kernel_lab.py", "tools/profile_numeric.py",
        "tools/profile_bench.py", "linalg/pcg_schur.py", "linalg/condensed.py",
        "interfaces/heterogeneous.py", "examples/performance/schur_complement.py",
        "linalg/sharded_schur.py", "parallel/__init__.py", "parallel/mesh.py",
        "parallel/distributed.py", "compat.py", "linalg/host_bk.py", "tools/bench.py",
        "tools/bench_all.py",
    } <= names
    for source in ("ldl_panel_winv.cu", "winv_apply.cu", "read_reduce.cu", "bk_ldl.cpp"):
        assert (PKG / "csrc" / source).exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PKG).as_posix())
def test_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, parapint_tpu_torch, parapint_tpu_torch.convert, "
        "parapint_tpu_torch.examples.burgers, parapint_tpu_torch.ops.ldl_panel, "
        "parapint_tpu_torch.ops.winv_apply, parapint_tpu_torch.ops.cuda_build, "
        "parapint_tpu_torch.linalg.dense, parapint_tpu_torch.linalg.schur, "
        "parapint_tpu_torch.interfaces.single, parapint_tpu_torch.interfaces.stochastic, "
        "parapint_tpu_torch.models, parapint_tpu_torch.utils.checkpoint, "
        "parapint_tpu_torch.examples.stochastic, parapint_tpu_torch.examples.dynamics, "
        "parapint_tpu_torch.examples.interior_point, parapint_tpu_torch.ops.read_reduce, "
        "parapint_tpu_torch.utils.profile, parapint_tpu_torch.tools.kernel_lab, "
        "parapint_tpu_torch.tools.profile_numeric, parapint_tpu_torch.tools.profile_bench, "
        "parapint_tpu_torch.linalg.pcg_schur, parapint_tpu_torch.linalg.condensed, "
        "parapint_tpu_torch.interfaces.heterogeneous, "
        "parapint_tpu_torch.examples.performance.schur_complement, "
        "parapint_tpu_torch.linalg.sharded_schur, parapint_tpu_torch.parallel.mesh, "
        "parapint_tpu_torch.parallel.distributed, parapint_tpu_torch.compat, "
        "parapint_tpu_torch.linalg.host_bk, parapint_tpu_torch.tools.bench, "
        "parapint_tpu_torch.tools.bench_all; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'parapint_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_precision_policy():
    import torch

    import parapint_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
