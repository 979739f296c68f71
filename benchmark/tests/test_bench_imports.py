"""What the benchmark's files may import and read."""

import ast
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "parapint_tpu"}
ROOT_SCRIPTS = ("bench.py", "bench_all.py", "chip_smoke.py", "BENCH_", "profile_flagship.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    # whole top-level names: parapint_tpu_torch begins with parapint_tpu
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [f for f in FILES if f.name != Path(__file__).name],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_root_bench_scripts_read(path):
    tree = ast.parse(path.read_text())
    strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    for s in strings:
        # naming a root script in a docstring is fine; a path to one is not
        assert not any(s.strip().endswith(r) or s.startswith(r) for r in ROOT_SCRIPTS), s
    assert not {"chip_smoke", "bench", "bench_all", "profile_flagship"} & top_level_imports(path)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py"))
                         + sorted((BENCH / "tests" / "fixture" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"parapint_tpu_torch", "benchmark"})


@pytest.mark.parametrize("name", ["harness.py", "trace.py"])
def test_harness_names_no_interface_nor_member_key(name):
    """What is particular to a model sits in its own modules: the harness
    and the trace name no interface or model class of the program and no
    member key of any model."""
    import parapint_tpu_torch as ptt

    text = (BENCH / name).read_text()
    classes = [c for c in ptt.__all__ if c.endswith(("Interface", "ModelSpec", "KindSpec"))]
    assert "DynamicSchurComplementInteriorPointInterface" in classes
    assert [c for c in classes if c in text] == []
    assert re.findall(r"\b(y0|height|edge)\b", text) == []


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    from benchmark import harness

    import parapint_tpu_torch  # noqa: F401  (begins with parapint_tpu, is not it)

    base = harness.jax_modules()
    monkeypatch.setitem(sys.modules, "parapint_tpu.linalg", types.ModuleType("parapint_tpu.linalg"))
    assert harness.jax_modules() == sorted(set(base) | {"parapint_tpu"})
