"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under perfbench/, and nothing of the program in the reference."""

import ast
import pathlib

from perfbench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "raytracingdiffusioncurves_tpu"}


def _imports(path: pathlib.Path) -> set[str]:
    """Top-level names of every module a file imports (whole names)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(core.BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f


def test_reference_imports_nothing_of_the_program():
    files = sorted((core.BENCH / "reference").rglob("*.py"))
    for f in files:
        got = _imports(f)
        assert "raytracingdiffusioncurves_torch" not in got, f
        assert got <= {"__future__", "dataclasses", "functools", "math", "typing", "xml",
                       "numpy", "torch"}, (f, got)


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's; only whole names count
    assert "raytracingdiffusioncurves_torch".split(".")[0] not in FORBIDDEN
    assert set(core.FORBIDDEN) == FORBIDDEN
