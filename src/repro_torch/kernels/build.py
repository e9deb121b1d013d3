"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Nothing is built when a module is imported.  The first call that needs a
kernel compiles its source from ``csrc/`` into ``_build/`` (keyed by a
hash of the source and the flags, so an edited source rebuilds) and loads
it; later calls in the process reuse the loaded library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


class Library:
    """One compiled kernel source: the loaded ``ctypes`` library, the
    seconds its build took (0.0 when it was already built) and the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills),
    kept beside the library so that a later process reads it too."""

    def __init__(self, cdll: ctypes.CDLL, build_seconds: float, log: str):
        self.cdll = cdll
        self.build_seconds = build_seconds
        self.log = log


def load(name: str) -> Library:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    report = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        report.write_text(log)
        os.replace(tmp, so)
    log = report.read_text() if report.exists() else ""
    lib = Library(ctypes.CDLL(str(so)), seconds, log)
    _LOADED[name] = lib
    return lib


def ptxas_report(log: str) -> dict:
    """Each entry function of a build's ``-Xptxas -v`` report, by its
    (mangled) name: registers a thread and spill stores and loads
    (bytes)."""
    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function '|Function "
                          r"properties for )([^' ]+)", line)
        if found:
            name = found.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found:
            out[name].update(spill_stores=int(found.group(1)),
                             spill_loads=int(found.group(2)))
        found = re.search(r"Used (\d+) registers", line)
        if found:
            out[name]["registers"] = int(found.group(1))
    return out
