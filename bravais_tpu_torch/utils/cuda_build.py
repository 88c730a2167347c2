"""Build the package's hand-written CUDA kernels.

Each source under ``bravais_tpu_torch/csrc/`` is compiled at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
with a plain C interface under the git-ignored ``bravais_tpu_torch/_build/``
and loaded with ctypes. The library's file name carries a hash of its
source and of the shared headers (``csrc/*.cuh``), so an edit rebuilds.
``build_all`` starts one ``nvcc`` per source, all at once. Nothing is
built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["build", "build_all", "load", "check", "SOURCES"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

#: The kernel sources of the package (stems of ``csrc/*.cu``).
SOURCES = ("jacobi_eigh", "nd_apply", "h1_apply")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)"
                       " — the CUDA kernels are built from source")


def _paths(name: str):
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(_CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    tag = h.hexdigest()[:16]
    return src, _BUILD / f"lib{name}_{tag}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    (library path, temporary output, process or None)."""
    src, lib = _paths(name)
    if lib.exists():
        return lib, None, None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"{lib.name}.tmp{os.getpid()}"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
           "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return lib, tmp, proc


def _finish(lib: Path, tmp: Path, proc) -> Path:
    if proc is None:
        return lib
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {lib.name}:"
                           f"\n{out}\n{err}")
    lib.with_name(lib.name.replace(".so", ".ptxas.txt")).write_text(err)
    os.replace(tmp, lib)
    return lib


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` for sm_90a if its library is not built
    yet; returns the library path. Raises on a failed build."""
    return _finish(*_start(name))


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Build several sources in parallel (one ``nvcc`` each, all started
    before any is awaited); returns {name: library path}."""
    started = {nm: _start(nm) for nm in names}
    try:
        return {nm: _finish(*st) for nm, st in started.items()}
    finally:
        for _, _, proc in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)))
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
