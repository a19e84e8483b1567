"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (pointers and the stream as
``void*``, each entry returns its ``cudaGetLastError()``), so it compiles in
seconds with nvcc alone, without PyTorch's headers.  A source whose call
cost matters may also make its library a CPython extension module of the
same name (Python.h only), loaded with ``load_module``.  Builds land in
``build/repro_torch/`` at the repository root, named by a hash of the source,
of every header under ``csrc/`` and of the flags, so an edited source or
header is never served from a stale library.
Nothing is built at import: the first kernel call builds what it needs, and
``build`` compiles several sources at once (one nvcc process each).  Each
nvcc build and each first load of a library is reported, with its wall
seconds, to ``core.compilemon``: they are what stalls a first flush.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{sysconfig.get_paths()['include']}")

_lock = threading.Lock()
_libs: dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return str(path)


def _target(name: str) -> tuple[Path, Path]:
    """The source of ``name`` and its library's path, named by a hash of
    the source, every header under ``csrc/`` and the flags."""
    src = CSRC / f"{name}.cu"
    sha = hashlib.sha1(src.read_bytes())
    for header in sorted(p for p in CSRC.iterdir() if p.suffix in (".h", ".cuh")):
        sha.update(header.name.encode() + header.read_bytes())
    sha.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{sha.hexdigest()[:12]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile the named sources (every ``csrc/*.cu`` when none is named)
    that are not built yet, all at once.

    Returns each name's compiler output (the ``-Xptxas -v`` register and
    shared-memory report; empty for a library that was already built).
    Raises RuntimeError, after every nvcc has ended, if any build failed."""
    names = names or tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    logs = dict.fromkeys(names, "")
    with _lock:
        t0 = time.perf_counter()
        jobs = []
        for name in names:
            src, lib = _target(name)
            if lib.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, lib, tmp, proc))
        failed = []
        for name, lib, tmp, proc in jobs:
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode:
                failed.append(f"nvcc failed for {name}.cu:\n{out}")
            else:
                tmp.replace(lib)
        if jobs:
            _stalled(len(jobs), time.perf_counter() - t0)
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs


def _stalled(events: int, seconds: float) -> None:
    """Report builds or loads to ``core.compilemon`` (imported here: the
    core package imports the kernels)."""
    from repro_torch.core import compilemon
    compilemon.record(events, seconds)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build(name)
    with _lock:
        if name not in _libs:
            t0 = time.perf_counter()
            _libs[name] = ctypes.CDLL(str(_target(name)[1]))
            _stalled(1, time.perf_counter() - t0)
        return _libs[name]


def load_module(name: str):
    """``csrc/<name>.cu``'s library, built on first use and imported as the
    CPython extension module ``name`` that it defines."""
    key = f"module {name}"
    with _lock:
        mod = _libs.get(key)
    if mod is not None:
        return mod
    build(name)
    path = str(_target(name)[1])
    with _lock:
        if key not in _libs:
            t0 = time.perf_counter()
            loader = importlib.machinery.ExtensionFileLoader(name, path)
            spec = importlib.util.spec_from_file_location(name, path, loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _libs[key] = mod
            _stalled(1, time.perf_counter() - t0)
        return _libs[key]
