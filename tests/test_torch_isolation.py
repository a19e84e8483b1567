"""The port stands alone: nothing under ``src/repro_torch/`` or
``examples/torch/`` and no line of ``chip_smoke.py`` imports ``jax`` or the
JAX package ``repro``, and
importing every module of the port leaves both out of ``sys.modules``."""
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)\b", re.M)


def _port_files():
    return (sorted(PORT.rglob("*.py")) + sorted((REPO / "examples" / "torch").glob("*.py"))
            + [REPO / "chip_smoke.py"])


def test_no_source_line_imports_jax_or_repro():
    files = _port_files()
    assert len(files) > 15
    offenders = {str(p.relative_to(REPO)): IMPORT_RE.findall(p.read_text())
                 for p in files if IMPORT_RE.search(p.read_text())}
    assert not offenders, offenders


def test_importing_the_port_loads_neither_jax_nor_repro():
    modules = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(modules)
