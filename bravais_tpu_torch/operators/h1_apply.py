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
* ``k``: d host floats, or a table (nk, d) of k-points for a k-batched
  solve: the rows then come in nk groups of equal size, one k each (row
  group g of ``rows`` rows uses ``k[g]``). The kernel takes the table by
  value, ``MAX_K`` k-points a launch; a larger table is split into
  launches.

``helmholtz_apply`` dispatches on where ``ue`` lies: a CPU tensor runs
``helmholtz_apply_plain``; a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches and ``launches_by_want`` splits them by
the halves computed ("AM", "A", "M"); both are incremented only at the
launch. ``apply_global`` wraps it for blocks of global dofs (the periodic or
quasi-periodic element gather, the element-major layout, the
scatter-add), as ``QPLaplace`` and ``BlochHelmholtz`` call it.
"""

from __future__ import annotations

import copy
import ctypes

import numpy as np
import torch

from bravais_tpu_torch.spaces.tensor import gather_qp, scatter_add_qp
from bravais_tpu_torch.utils import cuda_build

__all__ = ["H1Consts", "apply_global", "helmholtz_apply",
           "helmholtz_apply_plain", "launches", "launches_by_want", "work"]

launches = 0
launches_by_want = {"AM": 0, "A": 0, "M": 0}

_WANT = {"A": 1, "M": 2, "AM": 3}
#: k-points one launch takes (``kMaxK`` of ``csrc/h1_apply.cu``).
MAX_K = 64
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

    def elements(self, lo: int, hi: int) -> "H1Consts":
        """The same constants on the elements [lo, hi) only (a slab of
        whole element planes: the planes' rows are row-major over the
        element grid)."""
        c = copy.copy(self)
        c.alpha_w = self.alpha_w[lo:hi].contiguous()
        c.beta_w = self.beta_w[lo:hi].contiguous()
        c.nelem = hi - lo
        return c

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
    before the next stage; the ik terms skipped when every k of ``k``, one
    k-point or a table, is 0, as the kernel does) and its pointwise
    terms."""
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


def _k_table(k, d: int) -> np.ndarray:
    """k as a float64 table (nk, d); raises on a wrong width."""
    kt = np.asarray(k, np.float64)
    kt = kt[None] if kt.ndim == 1 else kt
    if kt.ndim != 2 or kt.shape[1] != d or kt.shape[0] < 1:
        raise ValueError(f"k must be ({d},) or (nk, {d}), got "
                         f"{np.shape(k)}")
    return kt


def _along(x: torch.Tensor, T: torch.Tensor, ax: int,
           transpose: bool = False) -> torch.Tensor:
    """Contract axis ``ax`` of the real x with the table T (q, l): by T
    (l → q), or by Tᵀ (q → l) with ``transpose``."""
    return torch.movedim(torch.tensordot(x, T, dims=([ax], [0 if transpose
                                                           else 1])), -1, ax)


def helmholtz_apply_plain(ue: torch.Tensor, c: H1Consts, k,
                          want: str = "AM"):
    """Plain torch version of the kernel: (y, m) with None for the half
    not in ``want``. ``k``: one k-point (d,) or a table (nk, d), one k per
    group of rows.

    The same plan as the kernel, in real arithmetic on stacked (real,
    imaginary) planes: forward B·u and D·u once, then (3D) BB, BD, DB,
    then the value and the gradients; pointwise f = α·w((Jinvᵀg)_r +
    ik_r u_q), s = −ik·f, h = Jinv f; transposed, the terms that share
    their remaining tables summed before the next stage."""
    d, E = c.d, c.nelem
    kt = _k_table(k, d)
    B, D = c.tables.to(ue.device)
    aw, bw = c.alpha_w.to(ue.device), c.beta_w.to(ue.device)
    # (2, nk, rows, E, l, ..., l): the real and imaginary planes.
    x = torch.stack([ue.real, ue.imag]).to(B.dtype).reshape(
        (2, kt.shape[0], -1, E) + ue.shape[1:])
    # k as (d, 1, nk, 1, ..., 1): per axis, a column over the row groups.
    kc = torch.as_tensor(kt.T, dtype=B.dtype, device=ue.device).reshape(
        (d, 1, kt.shape[0]) + (1,) * (d + 2))
    ax = [x.ndim - d + i for i in range(d)]
    wa, wm = "A" in want, "M" in want
    Bu, Du = _along(x, B, ax[0]), _along(x, D, ax[0]) if wa else None
    if d == 3:
        BB = _along(Bu, B, ax[1])
        uq = _along(BB, B, ax[2])
        if wa:
            g = [_along(_along(Du, B, ax[1]), B, ax[2]),
                 _along(_along(Bu, D, ax[1]), B, ax[2]),
                 _along(BB, D, ax[2])]
    else:
        uq = _along(Bu, B, ax[1])
        if wa:
            g = [_along(Du, B, ax[1]), _along(Bu, D, ax[1])]
    y = m = None
    if wa:
        def metric(Mx, V):     # (Σ_s Mx[r, s] V_s)_r over the stacked axis
            return torch.tensordot(torch.as_tensor(Mx, dtype=B.dtype,
                                                   device=ue.device),
                                   V, dims=([1], [0]))
        # f_r = α·w((Jinvᵀ g)_r + i k_r u_q): i u_q is (−Im, Re) u_q.
        f = aw * (metric(c.JinvT, torch.stack(g))
                  + kc * torch.stack([-uq[1], uq[0]]))
        # s = −i Σ_r k_r f_r: (Σ k Im f, −Σ k Re f).
        kf = (kc * f).sum(dim=0)
        s_ = torch.stack([kf[1], -kf[0]])
        h = metric(c.Jinv, f)
        t = ax[-1]
        if d == 3:
            A0 = _along(h[0], B, t, True)
            A1 = _along(h[1], B, t, True)
            A2 = _along(h[2], D, t, True) + _along(s_, B, t, True)
            YD = _along(A0, B, ax[1], True)
            YB = _along(A1, D, ax[1], True) + _along(A2, B, ax[1], True)
            yt = _along(YD, D, ax[0], True) + _along(YB, B, ax[0], True)
        else:
            A0 = _along(h[0], B, t, True)
            A1 = _along(h[1], D, t, True) + _along(s_, B, t, True)
            yt = _along(A0, D, ax[0], True) + _along(A1, B, ax[0], True)
        y = torch.complex(yt[0], yt[1]).reshape(ue.shape).to(ue.dtype)
    if wm:
        mt = bw * uq
        for i in reversed(range(d)):
            mt = _along(mt, B, ax[i], True)
        m = torch.complex(mt[0], mt[1]).reshape(ue.shape).to(ue.dtype)
    return y, m


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("h1_apply")
        fn = lib.h1_apply_launch
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(ue: torch.Tensor, c: H1Consts, kt: np.ndarray, want: str):
    """The kernel on ``ue`` with the k table ``kt`` (nk, d): one launch
    per ``MAX_K`` k-points (each a contiguous run of row groups)."""
    global launches
    shape = (c.l,) * c.d
    nk = kt.shape[0]
    if ue.dtype != torch.complex64 or tuple(ue.shape[1:]) != shape \
            or ue.shape[0] % (c.nelem * nk) or not ue.is_contiguous():
        raise ValueError(f"helmholtz_apply takes a contiguous complex64 "
                         f"(nk·rows·{c.nelem}, {shape}) tensor with nk = "
                         f"{nk}, got {ue.dtype} {tuple(ue.shape)}")
    if c.alpha_w.device != ue.device or c.alpha_w.dtype != torch.float32:
        raise ValueError(f"coefficients {c.alpha_w.dtype} on "
                         f"{c.alpha_w.device}, the kernel takes float32 on "
                         f"{ue.device}")
    metric = c.host_metric.astype(np.float32)
    ktab = np.zeros((nk, 3), np.float32)
    ktab[:, :c.d] = kt
    y = torch.empty_like(ue) if "A" in want else None
    m = torch.empty_like(ue) if "M" in want else None
    per_k = ue.shape[0] // nk          # blocks of one k's row group
    lib = _load()
    with torch.cuda.device(ue.device):
        stream = torch.cuda.current_stream(ue.device).cuda_stream
        for j in range(0, nk, MAX_K):
            nj = min(MAX_K, nk - j)
            sl = slice(j * per_k, (j + nj) * per_k)
            kj = ktab[j:j + nj]          # a view: ktab keeps it alive
            err = lib.h1_apply_launch(
                ue[sl].data_ptr(), c.alpha_w.data_ptr(),
                c.beta_w.data_ptr(),
                y[sl].data_ptr() if y is not None else None,
                m[sl].data_ptr() if m is not None else None,
                c.host_tabs.ctypes.data, metric.ctypes.data,
                kj.ctypes.data, nj,
                c.q, c.l, c.d, c.nelem, nj * per_k, _WANT[want], stream)
            launches += 1
            launches_by_want[want] += 1
            cuda_build.check(err, f"h1_apply launch ({want}, {nj * per_k} "
                             f"blocks, {nj} k)")
    return y, m


def helmholtz_apply(ue: torch.Tensor, c: H1Consts, k, want: str = "AM"):
    """(y, m) = ((∇+ik)ᴴα(∇+ik) u, β-mass u) on element-major dofs
    ``ue``; the half not in ``want`` ("AM", "A" or "M") is None. ``k``:
    one k-point (d,) or a table (nk, d), one k per group of rows. CPU
    tensors run the plain version; CUDA tensors the kernel."""
    if want not in _WANT:
        raise ValueError(f"want must be one of {sorted(_WANT)}, got {want!r}")
    kt = _k_table(k, c.d)
    if ue.device.type == "cpu":
        return helmholtz_apply_plain(ue, c, k, want)
    if not ue.is_cuda:
        raise ValueError(f"helmholtz_apply: no kernel for {ue.device}")
    return _launch(ue, c, kt, want)


def apply_global(space, u: torch.Tensor, c: H1Consts, k, want: str = "AM",
                 phases=None, mesh=None):
    """(y, m) of :func:`helmholtz_apply` on a block of global dofs ``u``
    (rows, N₁, ..., N_d) of ``space`` (with a k table (nk, d), nk groups
    of rows/nk rows, one k each): the periodic element gather (the
    quasi-periodic one with the wrap ``phases``), the element-major
    layout, the element apply and the scatter-add of each half in
    ``want`` (None for the other); both halves share one scatter. With
    ``mesh``, ``u`` is this rank's slab of axis 0 (its n₁/P·p dof planes)
    and ``c`` holds the slab's elements (``H1Consts.elements``): the
    gather and scatter exchange the slab's halo over the mesh."""
    sp = space
    d = sp.dim
    n, pp, cl = list(sp.grid.shape), (sp.p,) * d, (True,) * d
    if mesh is not None:
        n[0] = u.shape[1] // sp.p
    ph = phases if phases is not None else [None] * d
    R, l = u.shape[0], sp.p + 1
    ue = gather_qp(u, n, pp, cl, ph, mesh)         # (R, n₁, l, n₂, l, ...)
    perm = [0] + [1 + 2 * i for i in range(d)] + [2 + 2 * i for i in range(d)]
    ue = ue.permute(perm).reshape((-1,) + (l,) * d).contiguous()
    y, m = helmholtz_apply(ue, c, k, want)
    halves = [t for t in (y, m) if t is not None]
    t = halves[0] if len(halves) == 1 else torch.cat(halves)
    inv = [0] + [x for i in range(d) for x in (1 + i, 1 + d + i)]
    t = t.reshape((-1,) + tuple(n) + (l,) * d).permute(inv)
    out = iter(scatter_add_qp(t, n, pp, cl, ph, mesh).split(R))
    return (next(out) if y is not None else None,
            next(out) if m is not None else None)
