"""Fused Bloch H1 stiffness and mass element apply: the wrapper of the
hand-written CUDA kernel ``csrc/h1_apply.cu`` and its plain torch version.

Replaces ``bravais_tpu/operators/pallas/h1_apply.py::helmholtz_block_apply``.
Per element and block row: y = (∇+ik)ᴴα(∇+ik)u (value and gradient by
sum-factorized contractions, the Jinvᵀ metric and the ik shift, α·w,
transposed contractions) and m = β-mass; d = 2 or 3.

Layout (element-major, one element-row's dofs contiguous):

* ``ue``: (rows·E, l, ..., l) complex64 (d local axes), row-major over
  (row, element);
* ``alpha_w``, ``beta_w``: (E, q, ..., q) float32, α and β times the
  quadrature weights (which carry |det J|);
* ``k``: d host floats (a scalar argument of the kernel).

``helmholtz_apply`` dispatches on where ``ue`` lies: a CPU tensor runs
``helmholtz_apply_plain``; a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches and ``launches_by_want`` splits them by
the halves computed ("AM", "A", "M"); both are incremented only at the
launch. ``apply_global`` wraps it for blocks of global dofs (the periodic or
quasi-periodic element gather, the element-major layout, the
scatter-add), as ``QPLaplace`` and ``BlochHelmholtz`` call it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bravais_tpu_torch.spaces.tensor import (contract, contract_t,
                                             gather_qp, scatter_add_qp)
from bravais_tpu_torch.utils import cuda_build

__all__ = ["H1Consts", "apply_global", "helmholtz_apply",
           "helmholtz_apply_plain", "launches", "launches_by_want", "work"]

launches = 0
launches_by_want = {"AM": 0, "A": 0, "M": 0}

_WANT = {"A": 1, "M": 2, "AM": 3}
_lib = None


class H1Consts:
    """The kernel's constant inputs on one device: tables (2, q, l) (B, D),
    the α·w and β·w planes (E, q, ..., q), both in ``rdtype`` (float32,
    the kernel's; float64 for a complex128 plain apply), and the metric
    Jinvᵀ, Jinv (d × d) as host floats."""

    def __init__(self, B, D, alpha_w, beta_w, JinvT, Jinv, device,
                 rdtype=torch.float32):
        tabs = np.stack([np.asarray(B, np.float64), np.asarray(D, np.float64)])
        self.q, self.l = tabs.shape[1:]
        self.host_tabs = np.ascontiguousarray(tabs, np.float32)
        self.tables = torch.as_tensor(tabs, dtype=rdtype, device=device)
        self.alpha_w = torch.as_tensor(np.ascontiguousarray(alpha_w),
                                       dtype=rdtype, device=device)
        self.beta_w = torch.as_tensor(np.ascontiguousarray(beta_w),
                                      dtype=rdtype, device=device)
        self.nelem = self.alpha_w.shape[0]
        self.d = self.alpha_w.ndim - 1
        self.JinvT = np.asarray(JinvT, np.float64)
        self.Jinv = np.asarray(Jinv, np.float64)
        metric = np.zeros((2, 3, 3))
        metric[0, :self.d, :self.d] = self.JinvT
        metric[1, :self.d, :self.d] = self.Jinv
        self.host_metric = metric.ravel()

    @classmethod
    def from_space(cls, space, alpha_q64, beta_q64, device,
                   rdtype=torch.float32) -> "H1Consts":
        """Tables, metric and α·w, β·w planes of an ``H1Space``
        (coefficients sampled at its quadrature points, (n₁,q,...))."""
        sp = space
        d = sp.dim
        qshape = tuple(x for n in sp.grid.shape for x in (n, sp.q))
        wq = np.asarray(sp.quad_weight(), np.float64)
        perm = [2 * i for i in range(d)] + [2 * i + 1 for i in range(d)]

        def plane(coef_q):
            full = np.broadcast_to(np.asarray(coef_q, np.float64) * wq, qshape)
            return full.transpose(perm).reshape((-1,) + (sp.q,) * d)

        return cls(sp.basis.B, sp.basis.D, plane(alpha_q64), plane(beta_q64),
                   sp.grid.Jinv.T, sp.grid.Jinv, device, rdtype)


def work(nblocks: int, c: H1Consts, k, want: str = "AM"):
    """(bytes, flops) one call must move and compute: ``ue`` read once,
    each wanted output written once, the used planes read once; the
    multiply-adds (complex × real = 4 flops) of the kernel's shared-stage
    plan (forward: B·u and D·u, then BB, BD, DB, then the value and the
    gradients; transposed: terms that share their remaining tables summed
    before the next stage; the ik terms skipped at k = 0, as the kernel
    does) and its pointwise terms."""
    q, l, d = c.q, c.l, c.d
    wa, wm = "A" in want, "M" in want
    kz = not np.any(np.asarray(k, np.float64))
    need_uq = wm or (wa and not kz)
    if d == 3:
        fwd = ((1 + wa) * q * l ** 3 + (1 + 2 * wa) * q * q * l * l
               + (need_uq + 3 * wa) * q ** 3 * l)
        trn = (wa * ((3 + (not kz)) * q ** 3 * l + 3 * q * q * l * l
                     + 2 * q * l ** 3)
               + wm * (q ** 3 * l + q * q * l * l + q * l ** 3))
    else:
        fwd = (1 + wa) * q * l * l + (need_uq + 2 * wa) * q * q * l
        trn = (wa * ((2 + (not kz)) * q * q * l + 2 * q * l * l)
               + wm * (q * q * l + q * l * l))
    point = q ** d * (wa * (8 * d * d + 12 * d) + 2 * wm)
    nbytes = (nblocks * l ** d * 8 * (1 + wa + wm)
              + c.nelem * q ** d * 4 * (wa + wm))
    return nbytes, nblocks * (4 * (fwd + trn) + point)


def helmholtz_apply_plain(ue: torch.Tensor, c: H1Consts, k,
                          want: str = "AM"):
    """Plain torch version of the kernel: (y, m) with None for the half
    not in ``want``."""
    d, E = c.d, c.nelem
    x = ue.reshape((ue.shape[0] // E, E) + ue.shape[1:])
    B, D = c.tables.to(ue.device)
    aw, bw = c.alpha_w.to(ue.device), c.beta_w.to(ue.device)
    k = [float(v) for v in k]
    uq = contract(x, [B] * d)
    y = m = None
    if "A" in want:
        g = [contract(x, [D if i == r else B for i in range(d)])
             for r in range(d)]
        f = [aw * (sum(float(c.JinvT[r, s]) * g[s] for s in range(d))
                   + 1j * k[r] * uq) for r in range(d)]
        y = contract_t(-1j * sum(k[r] * f[r] for r in range(d)), [B] * d)
        for r in range(d):
            y = y + contract_t(sum(float(c.Jinv[r, s]) * f[s]
                                   for s in range(d)),
                               [D if i == r else B for i in range(d)])
        y = y.reshape(ue.shape)
    if "M" in want:
        m = contract_t(bw * uq, [B] * d).reshape(ue.shape)
    return y, m


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("h1_apply")
        fn = lib.h1_apply_launch
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(ue: torch.Tensor, c: H1Consts, k, want: str):
    global launches
    shape = (c.l,) * c.d
    if ue.dtype != torch.complex64 or tuple(ue.shape[1:]) != shape \
            or ue.shape[0] % c.nelem or not ue.is_contiguous():
        raise ValueError(f"helmholtz_apply takes a contiguous complex64 "
                         f"(rows·{c.nelem}, {shape}) tensor, got "
                         f"{ue.dtype} {tuple(ue.shape)}")
    if c.alpha_w.device != ue.device or c.alpha_w.dtype != torch.float32:
        raise ValueError(f"coefficients {c.alpha_w.dtype} on "
                         f"{c.alpha_w.device}, the kernel takes float32 on "
                         f"{ue.device}")
    kv = np.zeros(3)
    kv[:c.d] = np.asarray(k, np.float64)
    metric = np.concatenate([c.host_metric, kv]).astype(np.float32)
    y = torch.empty_like(ue) if "A" in want else None
    m = torch.empty_like(ue) if "M" in want else None
    lib = _load()
    with torch.cuda.device(ue.device):
        stream = torch.cuda.current_stream(ue.device).cuda_stream
        err = lib.h1_apply_launch(
            ue.data_ptr(), c.alpha_w.data_ptr(), c.beta_w.data_ptr(),
            y.data_ptr() if y is not None else None,
            m.data_ptr() if m is not None else None,
            c.host_tabs.ctypes.data, metric.ctypes.data,
            c.q, c.l, c.d, c.nelem, ue.shape[0], _WANT[want], stream)
    launches += 1
    launches_by_want[want] += 1
    cuda_build.check(err, f"h1_apply launch ({want}, {ue.shape[0]} blocks)")
    return y, m


def helmholtz_apply(ue: torch.Tensor, c: H1Consts, k, want: str = "AM"):
    """(y, m) = ((∇+ik)ᴴα(∇+ik) u, β-mass u) on element-major dofs
    ``ue``; the half not in ``want`` ("AM", "A" or "M") is None. CPU
    tensors run the plain version; CUDA tensors the kernel."""
    if want not in _WANT:
        raise ValueError(f"want must be one of {sorted(_WANT)}, got {want!r}")
    if len(k) != c.d:
        raise ValueError(f"k has {len(k)} components, the space {c.d}")
    if ue.device.type == "cpu":
        return helmholtz_apply_plain(ue, c, k, want)
    if not ue.is_cuda:
        raise ValueError(f"helmholtz_apply: no kernel for {ue.device}")
    return _launch(ue, c, k, want)


def apply_global(space, u: torch.Tensor, c: H1Consts, k, want: str = "AM",
                 phases=None):
    """(y, m) of :func:`helmholtz_apply` on a block of global dofs ``u``
    (rows, N₁, ..., N_d) of ``space``: the periodic element gather (the
    quasi-periodic one with the wrap ``phases``), the element-major
    layout, the element apply and the scatter-add of each half in
    ``want`` (None for the other); both halves share one scatter."""
    sp = space
    d = sp.dim
    n, pp, cl = sp.grid.shape, (sp.p,) * d, (True,) * d
    ph = phases if phases is not None else [None] * d
    R, l = u.shape[0], sp.p + 1
    ue = gather_qp(u, n, pp, cl, ph)               # (R, n₁, l, n₂, l, ...)
    perm = [0] + [1 + 2 * i for i in range(d)] + [2 + 2 * i for i in range(d)]
    ue = ue.permute(perm).reshape((-1,) + (l,) * d).contiguous()
    y, m = helmholtz_apply(ue, c, k, want)
    halves = [t for t in (y, m) if t is not None]
    t = halves[0] if len(halves) == 1 else torch.cat(halves)
    inv = [0] + [x for i in range(d) for x in (1 + i, 1 + d + i)]
    t = t.reshape((-1,) + tuple(n) + (l,) * d).permute(inv)
    out = iter(scatter_add_qp(t, n, pp, cl, ph).split(R))
    return (next(out) if y is not None else None,
            next(out) if m is not None else None)
