"""The import guard: nothing of the benchmark imports JAX, its
companions or the JAX package (top-level names compared whole), and
the reference and the frozen copies import nothing of the program."""
import ast
import os
import sys

import pytest

import harness

FILES = sorted(os.path.relpath(os.path.join(d, f), harness.BENCH_DIR)
               for d, _, fs in os.walk(harness.BENCH_DIR)
               for f in fs if f.endswith(".py"))


def imported_tops(path: str) -> set:
    with open(os.path.join(harness.BENCH_DIR, path)) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES)
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [f for f in FILES if f.startswith(
    ("reference" + os.sep, "frozen" + os.sep))])
def test_reference_imports_nothing_of_the_program(path):
    assert "homerhevc_torch" not in imported_tops(path)


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "homerhevc_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "homerhevc_tpu.api", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["homerhevc_tpu", "jax"]


def test_a_run_loads_no_jax():
    """The program and the harness, imported in a fresh process, load
    none of the forbidden modules."""
    import subprocess
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness; "
            "import homerhevc_torch.api, homerhevc_torch.utils.profiler; "
            "from reference import check; "
            "print(harness.forbidden_modules())"
            % (harness.BENCH_DIR, harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
