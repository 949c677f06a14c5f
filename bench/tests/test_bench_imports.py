"""No module of the benchmark loads JAX or the JAX package, compared on
whole top-level names (the port's name begins with the JAX package's),
and the plain reference loads nothing of the system under test."""

import ast

import pytest

from bench.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_takes_nothing_of_the_system():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch", "bench"}), path


def test_forbidden_names_are_whole_names():
    from bench import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert "repro_torch" not in harness.forbidden_modules()
