"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing but torch, numpy and the standard library."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "gpirt_tpu", "bench", "chip_smoke", "native"}
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs
                 if f.endswith(".py"))


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_imports_no_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "typing", "numpy", "torch"}


def test_the_check_sees_whole_names():
    from benchmark.run import forbidden_modules
    import gpirt_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert "gpirt_tpu" not in forbidden_modules()
