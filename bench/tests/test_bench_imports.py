"""No module of the benchmark loads JAX or the JAX package, compared on
whole top-level names (the port's name begins with the JAX package's),
the plain reference loads nothing of the system under test, and the
harness names no architecture: only model modules reach a reference."""

import ast

import pytest

from bench.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# reach every model-specific piece through the cell's model module
ARCHITECTURE_FREE = ("harness.py", "check.py", "counts.py", "drivers.py", "spec.py")
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def imported_modules(path):
    """Every module a file imports by name, in full (``from a.b import c``
    gives ``a.b`` and ``a.b.c``; a relative import is under ``bench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = ".".join(x for x in ("bench", base) if x)
            out.add(base)
            out |= {f"{base}.{a.name}" for a in node.names}
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


@pytest.mark.parametrize("name", ARCHITECTURE_FREE)
def test_the_harness_names_no_architecture(name):
    path = BENCH_DIR / name
    named = [m for m in imported_modules(path)
             if m.split(".")[:2] in (["bench", "models"], ["bench", "reference"])]
    assert not named, named
    assert "decoder" not in path.read_text().lower()


def test_imported_modules_sees_every_form(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import bench.models.decoder\n"
                    "from bench.reference import decoder\n"
                    "from .models import other\n")
    assert imported_modules(path) >= {"bench.models.decoder", "bench.reference.decoder",
                                      "bench.models.other"}
