"""Wrapper of the hand-written CUDA Jacobi eigensolver kernel.

``csrc/jacobi_eigh.cu`` replaces ``bravais_tpu/eigen/pallas_jacobi.py::
jacobi_eigh_pallas`` on NVIDIA Hopper (sm_90a). It is built at first use
by ``utils/cuda_build.py`` (nvcc into ``bravais_tpu_torch/_build/``, a
plain C interface loaded with ctypes). Nothing is built or loaded when
this module is imported.

One call is one kernel launch: the kernel takes odd n itself (a "bye" in
the circle method) and writes the eigenpairs in ascending, stable order,
so no pad, sort or gather runs on the device around it.

``launches`` counts kernel launches; it is incremented only where the
kernel is launched.
"""

from __future__ import annotations

import ctypes

import torch

from bravais_tpu_torch.utils import cuda_build

__all__ = ["jacobi_eigh_cuda", "sweeps_run", "launches", "launch_shape",
           "MAX_N", "MAX_ITEMS"]

MAX_N = 64
#: Blocks or V rows one thread of the kernel owns at most (``kMaxItems``).
MAX_ITEMS = 8
#: Items an item thread gets at most from ``launch_shape`` below its
#: 512-thread cap (the group sizes this gives measured best on the H100).
ITEMS_PER_THREAD = 3
launches = 0

_lib = None
_ready = set()   # device indices the kernel's shared-memory opt-in is set on


def launch_shape(n: int, batch: int) -> tuple:
    """(G, per_block): the kernel's threads per matrix and matrices per
    block for (batch, n, n). A round of the padded ne = n + (n mod 2)
    has ne/2·(ne/2−1)/2 off-diagonal 2×2 H blocks and n·ne/2 V rows to
    update; a group is the rotation warp and as many warps of item
    threads as give each at most ``ITEMS_PER_THREAD`` of them (64 to 512
    threads in all), and groups under 256 threads share a block."""
    ne = n + n % 2
    P = ne // 2
    items = P * (P - 1) // 2 + n * P
    warps = -(-items // (32 * ITEMS_PER_THREAD))
    G = min(512, 32 * (1 + max(1, warps)))
    if (G - 32) * MAX_ITEMS < items:
        raise ValueError(f"n={n} needs more than {MAX_ITEMS} items a thread")
    return G, max(1, min(256 // G, batch))


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("jacobi_eigh")
        fn = lib.jacobi_eigh_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.jacobi_eigh_init.argtypes = []
        lib.jacobi_eigh_init.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(H: torch.Tensor, sweeps: int, rel_tol: float | None):
    """Check H and launch the kernel once; returns (w ascending, V, the
    sweeps each matrix ran) of the (nb, n, n) batch."""
    global launches
    if not H.is_cuda or H.dtype != torch.complex64:
        raise ValueError(f"jacobi_eigh_cuda takes a CUDA complex64 tensor,"
                         f" got {H.dtype} on {H.device}")
    if H.ndim < 2 or H.shape[-1] != H.shape[-2] or H.shape[-1] > MAX_N \
            or H.shape[-1] < 1:
        raise ValueError(f"jacobi_eigh_cuda takes (..., n, n) with "
                         f"n <= {MAX_N}, got {tuple(H.shape)}")
    n = H.shape[-1]
    Hc = H.reshape(-1, n, n).contiguous()
    nb = Hc.shape[0]
    w = torch.empty((nb, n), dtype=torch.float32, device=H.device)
    V = torch.empty((nb, n, n), dtype=torch.complex64, device=H.device)
    nsw = torch.empty((nb,), dtype=torch.int32, device=H.device)
    tol = float(rel_tol if rel_tol is not None
                else torch.finfo(torch.float32).eps)
    G, per_block = launch_shape(n, nb)
    lib = _load()
    with torch.cuda.device(H.device):
        if H.device.index not in _ready:
            cuda_build.check(lib.jacobi_eigh_init(),
                             f"jacobi_eigh kernel init on {H.device}")
            _ready.add(H.device.index)
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = lib.jacobi_eigh_launch(Hc.data_ptr(), w.data_ptr(),
                                     V.data_ptr(), nsw.data_ptr(), nb, n, G,
                                     per_block, int(sweeps), tol, stream)
    launches += 1
    cuda_build.check(err, f"jacobi_eigh launch (batch={nb}, n={n})")
    return w, V, nsw


def jacobi_eigh_cuda(H: torch.Tensor, sweeps: int = 24,
                     rel_tol: float | None = None):
    """(w ascending, V) of Hermitian complex64 (..., n, n) on a CUDA
    device, n ≤ 64. Same contract as ``jacobi_eigh.jacobi_eigh``:
    Rutishauser stop at ``rel_tol`` (default float32 eps), at most
    ``sweeps`` sweeps."""
    w, V, _ = _launch(H, sweeps, rel_tol)
    return w.reshape(H.shape[:-1]), V.reshape(H.shape)


def sweeps_run(H: torch.Tensor, sweeps: int = 24,
               rel_tol: float | None = None) -> torch.Tensor:
    """Diagnostic: the number of sweeps the kernel runs on each matrix
    of ``H`` (..., n, n) before its Rutishauser stop (int32, shape
    ``H.shape[:-2]``)."""
    return _launch(H, sweeps, rel_tol)[2].reshape(H.shape[:-2])
