"""Build the package's CUDA sources with ``nvcc`` at first use, and load them.

Each source under ``csrc/`` is compiled to its own shared library with a
plain C interface (bound with ``ctypes``) for ``sm_90a``.  The build goes to
``build/<name>-<hash>/`` inside the package, keyed by a hash of the source
and the flags, so a changed source rebuilds and an unchanged one loads.
The directory is git-ignored.  ``ptxas -v`` reports each kernel's registers,
shared memory and spills; the report is kept beside the library
(:func:`build_report`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _build_dir(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path.  Safe against concurrent builds: each
    compiles into a private temporary file and renames it into place."""
    out_dir = _build_dir(name)
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    (out_dir / "ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the last build of ``name`` (registers,
    shared memory, spill stores/loads per kernel)."""
    report = _build_dir(name) / "ptxas.txt"
    return report.read_text() if report.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(str(build(name)))
