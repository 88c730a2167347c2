"""Fused Nédélec curl-curl and ε-mass element apply: the wrapper of the
hand-written CUDA kernel ``csrc/nd_apply.cu`` and its plain torch
version.

Replaces ``bravais_tpu/operators/pallas/nd_apply.py::nedelec_block_apply``.
Per element and block row: y = A_e u (6 derivative contractions, the
J/detJ·μ⁻¹·w mixing, 6 transposed contractions) and m = M_e u (3 value
contractions, the Ginv·ε·w mixing, 3 transposed contractions).

Layout (element-major, one element-row's dofs contiguous):

* ``ue``: (rows·E, 3·p·l²) complex64, row-major over (row, element); per
  element-row the three components one after the other, component c
  row-major over its extents ``comp_shapes(p)[c]`` (p values on its open
  axis c, l = p + 1 on the two closed ones);
* coefficient planes ``muw``, ``epsw``: (E, q, q, q) float32, μ⁻¹ and ε
  times the quadrature weights.

``nedelec_apply`` dispatches on where ``ue`` lies: a CPU tensor runs
``nedelec_apply_plain``; a CUDA tensor launches the kernel (built at first
use by ``utils/cuda_build.py``) or raises. ``launches`` counts kernel
launches and ``launches_by_mode`` splits them by the halves computed
("AM", "A", "M"); both are incremented only where the kernel launches.
``launch_shape`` reports the kernel's blocks and their residency.
"""

from __future__ import annotations

import copy
import ctypes

import numpy as np
import torch

from bravais_tpu_torch.spaces.tensor import contract, contract_t
from bravais_tpu_torch.utils import cuda_build

__all__ = ["NdConsts", "comp_shapes", "launch_shape", "nedelec_apply",
           "nedelec_apply_plain", "launches", "launches_by_mode", "work"]

launches = 0
launches_by_mode = {"AM": 0, "A": 0, "M": 0}

_WANT = {"A": 1, "M": 2, "AM": 3}
_CYC = ((0, 1, 2), (1, 2, 0), (2, 0, 1))
_lib = None


def comp_shapes(p: int):
    """The local extents of the three components of one element: p on
    the component's own (open) axis, p + 1 on the two closed ones."""
    return [tuple(p if i == c else p + 1 for i in range(3)) for c in range(3)]


class NdConsts:
    """The kernel's constant inputs on one device: the 1D tables
    (4, q, l) (Bc, Dc, Bo, Do; the open ones, (q, p), padded with a zero
    column), the coefficient planes (E, q, q, q) and the metric (J, Ginv,
    1/detJ) on the host, all in ``rdtype`` (float32, the kernel's; float64
    for a complex128 plain apply), and J, Ginv, detJ (signed) as host
    floats. ``ndof`` = 3·p·l² values per element-row."""

    def __init__(self, Bc, Dc, Bo, Do, muw, epsw, J, Ginv, detJ, device,
                 rdtype=torch.float32):
        q, l = np.shape(Bc)
        tabs = np.stack([np.pad(np.asarray(T, np.float64),
                                ((0, 0), (0, l - np.shape(T)[1])))
                         for T in (Bc, Dc, Bo, Do)])
        self.q, self.l, self.p = q, l, l - 1
        self.ndof = 3 * self.p * l * l
        self.rdtype = rdtype
        npdt = torch.empty((), dtype=rdtype).numpy().dtype
        self.host_tabs = np.ascontiguousarray(tabs, npdt)
        self.tables = torch.as_tensor(self.host_tabs, device=device)
        self.muw = torch.as_tensor(np.ascontiguousarray(muw, npdt),
                                   device=device)
        self.epsw = torch.as_tensor(np.ascontiguousarray(epsw, npdt),
                                    device=device)
        self.nelem = self.muw.shape[0]
        self.J = np.asarray(J, np.float64)
        self.Ginv = np.asarray(Ginv, np.float64)
        self.detJ = float(detJ)
        self.host_metric = np.concatenate(
            [self.J.ravel(), self.Ginv.ravel(), [1.0 / self.detJ]]
        ).astype(npdt)
        # The launch's constant pointers, taken once (the arrays above
        # hold the memory).
        self.ptrs = (self.muw.data_ptr(), self.epsw.data_ptr(),
                     self.host_tabs.ctypes.data, self.host_metric.ctypes.data)

    def elements(self, lo: int, hi: int) -> "NdConsts":
        """The same constants on the elements [lo, hi) only (a slab of
        whole element planes: the planes' rows are row-major over the
        element grid)."""
        c = copy.copy(self)
        c.muw = self.muw[lo:hi].contiguous()
        c.epsw = self.epsw[lo:hi].contiguous()
        c.nelem = hi - lo
        c.ptrs = (c.muw.data_ptr(), c.epsw.data_ptr()) + self.ptrs[2:]
        return c

    @classmethod
    def from_space(cls, space, eps_q64, mu_inv_q64, device,
                   rdtype=torch.float32) -> "NdConsts":
        """Tables, metric and ε·w, μ⁻¹·w planes of a ``NedelecSpace``
        (coefficients sampled at its quadrature points, (n₁,q,n₂,q,n₃,q))
        in ``rdtype``."""
        sp = space
        qshape = tuple(x for n in sp.grid.shape for x in (n, sp.q))
        wq = np.asarray(sp.quad_weight(), np.float64)

        def plane(coef_q):
            full = np.broadcast_to(np.asarray(coef_q, np.float64) * wq, qshape)
            return full.transpose(0, 2, 4, 1, 3, 5).reshape(
                (-1,) + (sp.q,) * 3)

        return cls(sp.closed.B, sp.closed.D, sp.open.B, sp.open.D,
                   plane(mu_inv_q64), plane(eps_q64), sp.grid.J, sp.grid.Ginv,
                   np.linalg.det(sp.grid.J), device, rdtype)


def work(nblocks: int, c: NdConsts, want: str = "AM"):
    """(bytes, flops) one call must move and compute: ``ue`` (its 3·p·l²
    values per element-row) read once, each wanted output written once,
    the used coefficient planes read once; the multiply-adds of the
    kernel's plan (complex × real = 4 flops) and its pointwise mixing
    (48 flops a point for the curl, K = JᵀJ/detJ² and μ⁻¹·w; 42 for Ginv
    and ε·w). Per component, forward: the first closed axis with Bc (and Dc for A),
    the second with BB (M), BD and DB (A), the open axis (p → q) for each
    of those; transposed: the open axis first (q → p), then the two
    closed axes, the two curl terms of an output summed in the last
    stage."""
    q, l, p = c.q, c.l, c.p
    wa, wm = "A" in want, "M" in want
    src = wm + 2 * wa
    macs = 3 * ((1 + wa) * q * l * l * p
                + src * (2 * q ** 3 * p + 2 * q * q * l * p + q * l * l * p))
    point = q ** 3 * (48 * wa + 42 * wm)
    nbytes = (nblocks * c.ndof * 8 * (1 + wa + wm)
              + c.nelem * q ** 3 * 4 * (wa + wm))
    return nbytes, nblocks * (4 * macs + point)


def _tabs(T, comp, deriv=None):
    """Tables of component ``comp`` on the three axes: open on axis comp
    (Bo/Do without their zero column), D on axis ``deriv``."""
    p = T.shape[2] - 1
    return [T[2 + int(i == deriv)][:, :p] if i == comp
            else T[int(i == deriv)] for i in range(3)]


def nedelec_apply_plain(ue: torch.Tensor, c: NdConsts, want: str = "AM"):
    """Plain torch version of the kernel, in the constants' precision:
    (y, m) with None for the half not in ``want``."""
    E, n = c.nelem, c.p * c.l * c.l
    rows = ue.shape[0] // E
    x = [ue[:, s * n:(s + 1) * n].reshape((rows, E) + ext)
         for s, ext in enumerate(comp_shapes(c.p))]
    T = c.tables.to(ue.device)
    muw, epsw = c.muw.to(ue.device), c.epsw.to(ue.device)

    def flat(parts):
        return torch.cat([t.reshape(ue.shape[0], n) for t in parts], dim=1)

    y = m = None
    if "M" in want:
        uh = [contract(x[s], _tabs(T, s)) for s in range(3)]
        m = flat([contract_t(epsw * sum(float(c.Ginv[r, s]) * uh[s]
                                        for s in range(3)), _tabs(T, r))
                  for r in range(3)])
    if "A" in want:
        D = {(s, t): contract(x[t], _tabs(T, t, s))
             for t in range(3) for s in range(3) if s != t}
        ch = [D[(s, t)] - D[(t, s)] for _, s, t in _CYC]
        f = [muw * sum(float(c.J[r, s]) * ch[s] for s in range(3)) / c.detJ
             for r in range(3)]
        cf = [sum(float(c.J[s, r]) * f[s] for s in range(3)) / c.detJ
              for r in range(3)]
        yc = []
        for comp in range(3):
            acc = 0.0
            for s in range(3):
                if s != comp:
                    r = 3 - s - comp
                    sign = 1.0 if (r + 1) % 3 == s else -1.0
                    acc = acc + sign * contract_t(cf[r], _tabs(T, comp, s))
            yc.append(acc)
        y = flat(yc)
    return y, m


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("nd_apply")
        fn = lib.nd_apply_launch
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.nd_apply_occupancy
        occ.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        occ.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(ue: torch.Tensor, c: NdConsts):
    if ue.dtype != torch.complex64 or ue.dim() != 2 \
            or ue.shape[1] != c.ndof or ue.shape[0] % c.nelem \
            or not ue.is_contiguous():
        raise ValueError(f"nedelec_apply takes a contiguous complex64 "
                         f"(rows·{c.nelem}, {c.ndof}) tensor, got "
                         f"{ue.dtype} {tuple(ue.shape)}")
    if c.rdtype != torch.float32:
        raise ValueError(f"the nd kernel takes float32 constants, got "
                         f"{c.rdtype}")
    if c.muw.device != ue.device:
        raise ValueError(f"coefficients on {c.muw.device}, dofs on "
                         f"{ue.device}")


def _launch(ue: torch.Tensor, c: NdConsts, want: str):
    global launches
    _check(ue, c)
    y = torch.empty_like(ue) if "A" in want else None
    m = torch.empty_like(ue) if "M" in want else None
    fn = _load().nd_apply_launch
    muw, epsw, tabs, metric = c.ptrs
    args = (ue.data_ptr(), muw, epsw, y.data_ptr() if y is not None else None,
            m.data_ptr() if m is not None else None, tabs, metric, c.q, c.l,
            c.nelem, ue.shape[0], _WANT[want])
    dev = ue.device
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    launches_by_mode[want] += 1
    cuda_build.check(err, f"nd_apply launch ({want}, {ue.shape[0]} blocks)")
    return y, m


def launch_shape(ue: torch.Tensor, c: NdConsts, want: str = "AM") -> dict:
    """The kernel's launch for ``ue`` on its CUDA device: element-rows per
    block, threads per block, dynamic shared bytes per block and resident
    blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    _check(ue, c)
    out = np.zeros(4, np.int32)
    with torch.cuda.device(ue.device):
        err = _load().nd_apply_occupancy(c.q, c.l, c.nelem, ue.shape[0],
                                         _WANT[want], out.ctypes.data)
    cuda_build.check(err, "nd_apply occupancy")
    return dict(zip(("rows_per_block", "threads", "smem_bytes",
                     "blocks_per_sm"), out.tolist()))


def nedelec_apply(ue: torch.Tensor, c: NdConsts, want: str = "AM"):
    """(y, m) = (A_e u, M_e u) on element-major dofs ``ue``; the half not
    in ``want`` ("AM", "A" or "M") is None. CPU tensors run the plain
    version; CUDA tensors the kernel."""
    if want not in _WANT:
        raise ValueError(f"want must be one of {sorted(_WANT)}, got {want!r}")
    if ue.device.type == "cpu":
        return nedelec_apply_plain(ue, c, want)
    if not ue.is_cuda:
        raise ValueError(f"nedelec_apply: no kernel for {ue.device}")
    return _launch(ue, c, want)
