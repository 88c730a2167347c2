"""ctypes binding of the native host core, ``csrc/bravais_host.cpp`` at
the root of the repository: C++ dense assemblers of the Bloch Helmholtz
and quasi-periodic Maxwell pencils (the native twins of
``operators/dense.py``, a second oracle) and the periodic H1 dof map.

Port of ``bravais_tpu/utils/native.py``. The library is compiled at first
use with ``g++ -O3 -fPIC -shared -std=c++17`` into the git-ignored
``bravais_tpu_torch/_build/``, its file name tagged with a hash of the
source (an edit rebuilds); nothing is written beside the source. Where
the reference returns None without a toolchain, ``load`` raises and names
the missing ``g++``. Nothing is built or loaded when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

from bravais_tpu_torch.operators.coefficients import eval_coefficient

__all__ = ["load", "assemble_h1", "assemble_nedelec", "h1_dof_map"]

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "bravais_host.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"

_lib = None


def _build() -> Path:
    """Compile the source unless its tagged library exists; returns the
    library path. Raises without ``g++`` or on a failed build."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib = _BUILD / f"libbravais_host_{tag}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: bravais_tpu_torch.utils.native "
                           f"compiles {_SRC} with it")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"{lib.name}.tmp{os.getpid()}"
    r = subprocess.run([cxx, "-O3", "-fPIC", "-shared", "-std=c++17",
                        "-Wall", "-o", str(tmp), str(_SRC)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}) for {_SRC}:\n"
                           f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The native library (built on first use), with every function's
    argument and result types declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.bh_assemble_h1.argtypes = [
        ctypes.c_int, i64p, ctypes.c_int, ctypes.c_int, f64p, f64p, f64p,
        f64p, ctypes.c_double, f64p, f64p, f64p, f64p, f64p]
    lib.bh_assemble_h1.restype = ctypes.c_int
    lib.bh_assemble_nedelec.argtypes = [
        i64p, ctypes.c_int, ctypes.c_int, f64p, f64p, f64p, f64p, f64p,
        f64p, f64p, ctypes.c_double, f64p, f64p, f64p, f64p, f64p]
    lib.bh_assemble_nedelec.restype = ctypes.c_int
    lib.bh_h1_dof_map.argtypes = [ctypes.c_int, i64p, ctypes.c_int, i64p]
    lib.bh_h1_dof_map.restype = ctypes.c_int
    _lib = lib
    return _lib


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float64))


def _coef_elem_major(space, coef) -> np.ndarray:
    """A coefficient at the interleaved quadrature points (n₁, q, ...,
    n_d, q) as (elements, q^d), both in C order."""
    cq = eval_coefficient(coef, space.qpoints_phys())
    d = space.dim
    perm = [2 * i for i in range(d)] + [2 * i + 1 for i in range(d)]
    return _f64(np.transpose(cq, perm).reshape(space.grid.n_elements, -1))


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed rc={rc}")


def assemble_h1(space, k, alpha=1.0, beta=1.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Native twin of ``operators.dense.assemble_h1``: (A, M) complex128
    (N, N)."""
    lib = load()
    N = space.ndofs
    A = np.zeros((N, N), np.complex128)
    M = np.zeros((N, N), np.complex128)
    k = _f64(k)
    if k.shape != (space.dim,):
        raise ValueError(f"k has shape {k.shape}, the space dim "
                         f"{space.dim}")
    _check(lib.bh_assemble_h1(
        space.dim, np.asarray(space.grid.shape, np.int64), space.p, space.q,
        _f64(space.basis.B), _f64(space.basis.D), _f64(space.basis.qwts),
        _f64(space.grid.Jinv), float(space.grid.detJ),
        _coef_elem_major(space, alpha), _coef_elem_major(space, beta), k,
        A.view(np.float64), M.view(np.float64)), "bh_assemble_h1")
    return A, M


def assemble_nedelec(space, k, eps=1.0, mu_inv=1.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Native twin of ``operators.dense.assemble_nedelec`` (quasi-periodic
    form): (A, M) complex128 (N, N)."""
    lib = load()
    N = space.ndofs
    A = np.zeros((N, N), np.complex128)
    M = np.zeros((N, N), np.complex128)
    phases = np.exp(1j * (space.grid.lattice.A @ np.asarray(k, np.float64)))
    _check(lib.bh_assemble_nedelec(
        np.asarray(space.grid.shape, np.int64), space.p, space.q,
        _f64(space.closed.B), _f64(space.closed.D), _f64(space.open.B),
        _f64(space.open.D), _f64(space.closed.qwts), _f64(space.grid.J),
        _f64(space.grid.Jinv), float(np.linalg.det(space.grid.J)),
        _coef_elem_major(space, eps), _coef_elem_major(space, mu_inv),
        _f64(phases.view(np.float64)), A.view(np.float64),
        M.view(np.float64)), "bh_assemble_nedelec")
    return A, M


def h1_dof_map(space) -> np.ndarray:
    """Global dof of every element's local H1 dof: (elements, (p+1)^d)
    int64, elements and local dofs in C order, wrapped periodically."""
    lib = load()
    nloc = (space.p + 1) ** space.dim
    out = np.zeros(space.grid.n_elements * nloc, np.int64)
    _check(lib.bh_h1_dof_map(space.dim, np.asarray(space.grid.shape,
                                                   np.int64), space.p, out),
           "bh_h1_dof_map")
    return out.reshape(space.grid.n_elements, nloc)
