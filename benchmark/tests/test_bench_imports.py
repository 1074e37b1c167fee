"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port: top-level module names, read from
the sources, compared whole (``cedar_tpu_torch`` begins with
``cedar_tpu`` and is another package)."""

import ast

import pytest

from benchmark import harness

FILES = sorted(harness.BENCH.rglob("*.py"))


def imported(path) -> set:
    """The top-level names of the modules that ``path`` imports (absolute
    imports; a relative one stays inside the benchmark)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value.split(".", 1)[0])
    return out


def test_the_check_compares_whole_names():
    assert "cedar_tpu_torch".split(".", 1)[0] not in harness.FORBIDDEN
    assert "cedar_tpu.solver".split(".", 1)[0] in harness.FORBIDDEN


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(harness.BENCH)) for p in FILES])
def test_no_jax(path):
    assert not imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert imported(path) <= {"__future__", "importlib", "math", "numpy",
                              "torch"}


def test_a_run_loads_no_jax():
    """A whole run on the CPU, then the look at ``sys.modules``; the repo's
    own test session may have loaded JAX already, so only what the run adds
    counts."""
    import sys

    from benchmark.tests.helpers import run_tiny

    before = set(harness.forbidden_modules())
    run_tiny("poisson2d-8192.rhs", seconds=0.05)
    assert set(harness.forbidden_modules()) == before
    assert not any(m.split(".", 1)[0] in harness.FORBIDDEN
                   for m in sys.modules if m.startswith("cedar_tpu_torch"))
