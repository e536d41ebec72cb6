"""Nothing under jfbench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their top-level name whole: jellyfish_tpu_torch begins with
jellyfish_tpu."""

import ast
import subprocess
import sys

import pytest

from jfbench import harness

FILES = sorted(harness.BENCH.rglob("*.py"))


def imported(path):
    """Top-level names of every module that a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.partition(".")[0])
    return names


def test_top_level_names_are_compared_whole():
    assert "jellyfish_tpu_torch".partition(".")[0] not in harness.FORBIDDEN
    assert "jellyfish_tpu.counter".partition(".")[0] in harness.FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.BENCH)))
def test_no_jax(path):
    assert not imported(path) & set(harness.FORBIDDEN)


def test_spans_wrap_only_the_port():
    from jfbench import spans

    targets = [t for s in spans.SPANS.values() for t in s["targets"]]
    for m in (harness.BENCH / "metrics").glob("*.py"):
        assert set(harness.load_module(harness.BENCH, "metrics",
                                       m.stem).SPANS) <= set(spans.SPANS)
    assert targets
    for t in targets:
        assert t.partition(":")[0].partition(".")[0] == "jellyfish_tpu_torch"


@pytest.mark.parametrize("path", sorted(
    (harness.BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "numpy", "torch"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import jfbench.reference.count; "
            "print(sorted({m.partition('.')[0] for m in sys.modules}))"
            % str(harness.BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "jellyfish_tpu_torch" not in out and "'jax'" not in out


def test_a_run_leaves_no_forbidden_module_loaded():
    code = ("import sys; sys.path.insert(0, %r); "
            "from jfbench import harness; "
            "import jellyfish_tpu_torch.counter, jellyfish_tpu_torch.cli; "
            "print(harness.forbidden_modules())"
            % str(harness.BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
