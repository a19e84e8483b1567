"""What the benchmark may import and open: nothing it runs imports a module
whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (each
compared whole: ``repro_torch`` is the program, not ``repro``); the
references import nothing of the program; nothing reads ``benchmarks/``."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

PB = harness.ROOT / "perfbench"
SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.relative_to(PB).parts)
REFERENCES = sorted((PB / "reference").glob("*.py"))


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert tops <= {"__future__", "numpy"}, tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_source_names_the_benchmarks_folder(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks/" not in node.value and node.value != "benchmarks", path
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                else [node.module or ""]
            assert not any(n.split(".")[0] == "benchmarks" for n in names), path


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded(["repro_torch", "repro_torch.models", "jaxtyping",
                                     "flaxen", "reprox"]) == []
    assert harness.forbidden_loaded(["repro.core", "jaxlib.xla", "flax", "jax", "numpy"]) \
        == ["flax", "jax", "jaxlib", "repro"]


def test_a_run_of_the_driver_loads_nothing_forbidden():
    """The driver runs a small cell in a fresh process, which then holds
    no forbidden module."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from perfbench import harness\n"
        "from perfbench.drivers import stream\n"
        "from perfbench.tests import tiny\n"
        "stream.run(tiny.cell(tiny.histo_config(), tiny.stream_traffic(), "
        "tiny.load('limits', 'histo-sweep'), seconds=0.1))\n"
        "print(harness.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_without_a_result_where_there_is_no_program(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/: the run fails
    and prints no result line."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "histo-sweep",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
