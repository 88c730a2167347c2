"""Wrapper of the hand-written CUDA Jacobi eigensolver kernel.

``csrc/jacobi_eigh.cu`` replaces ``bravais_tpu/eigen/pallas_jacobi.py::
jacobi_eigh_pallas`` on NVIDIA Hopper (sm_90a). It is built at first use
by ``utils/cuda_build.py`` (nvcc into ``bravais_tpu_torch/_build/``, a
plain C interface loaded with ctypes). Nothing is built or loaded when
this module is imported.

``launches`` counts kernel launches; it is incremented only where the
kernel is launched.
"""

from __future__ import annotations

import ctypes

import torch

from bravais_tpu_torch.eigen.jacobi_eigh import pad_odd, sort_pairs
from bravais_tpu_torch.utils import cuda_build

__all__ = ["jacobi_eigh_cuda", "sweeps_run", "launches", "MAX_N"]

MAX_N = 64
launches = 0

_lib = None
_ready = set()   # device indices the kernel's shared-memory opt-in is set on


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("jacobi_eigh")
        fn = lib.jacobi_eigh_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.jacobi_eigh_init.argtypes = []
        lib.jacobi_eigh_init.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(H: torch.Tensor, sweeps: int, rel_tol: float | None):
    """Check H, pad odd n and launch the kernel once; returns the
    unsorted (w, V) of the padded (nb, n, n) batch and the sweeps each
    matrix ran."""
    global launches
    if not H.is_cuda or H.dtype != torch.complex64:
        raise ValueError(f"jacobi_eigh_cuda takes a CUDA complex64 tensor,"
                         f" got {H.dtype} on {H.device}")
    if H.ndim < 2 or H.shape[-1] != H.shape[-2] or H.shape[-1] > MAX_N \
            or H.shape[-1] < 1:
        raise ValueError(f"jacobi_eigh_cuda takes (..., n, n) with "
                         f"n <= {MAX_N}, got {tuple(H.shape)}")
    if H.shape[-1] % 2:
        H = pad_odd(H)
    n = H.shape[-1]
    Hc = H.reshape(-1, n, n).contiguous()
    nb = Hc.shape[0]
    w = torch.empty((nb, n), dtype=torch.float32, device=H.device)
    V = torch.empty((nb, n, n), dtype=torch.complex64, device=H.device)
    nsw = torch.empty((nb,), dtype=torch.int32, device=H.device)
    tol = float(rel_tol if rel_tol is not None
                else torch.finfo(torch.float32).eps)
    lib = _load()
    with torch.cuda.device(H.device):
        if H.device.index not in _ready:
            err = lib.jacobi_eigh_init()
            if err != 0:
                raise RuntimeError(f"jacobi_eigh kernel init failed: CUDA "
                                   f"error {err} on {H.device}")
            _ready.add(H.device.index)
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = lib.jacobi_eigh_launch(Hc.data_ptr(), w.data_ptr(),
                                     V.data_ptr(), nsw.data_ptr(), nb, n,
                                     int(sweeps), tol, stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"jacobi_eigh kernel launch failed: CUDA error "
                           f"{err} (batch={nb}, n={n})")
    return w, V, nsw


def jacobi_eigh_cuda(H: torch.Tensor, sweeps: int = 24,
                     rel_tol: float | None = None):
    """(w ascending, V) of Hermitian complex64 (..., n, n) on a CUDA
    device, n ≤ 64 (odd n padded). Same contract as
    ``jacobi_eigh.jacobi_eigh``: Rutishauser stop at ``rel_tol``
    (default float32 eps), at most ``sweeps`` sweeps."""
    w, V, _ = _launch(H, sweeps, rel_tol)
    n0 = H.shape[-1]
    w, V = sort_pairs(w, V, n0)
    batch_shape = H.shape[:-2]
    return w.reshape(batch_shape + (n0,)), V.reshape(batch_shape + (n0, n0))


def sweeps_run(H: torch.Tensor, sweeps: int = 24,
               rel_tol: float | None = None) -> torch.Tensor:
    """Diagnostic: the number of sweeps the kernel runs on each matrix
    of ``H`` (..., n, n) before its Rutishauser stop (int32, shape
    ``H.shape[:-2]``)."""
    return _launch(H, sweeps, rel_tol)[2].reshape(H.shape[:-2])
