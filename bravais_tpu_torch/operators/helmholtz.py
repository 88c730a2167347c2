"""Matrix-free Bloch-shifted scalar Helmholtz operator on H1.

Port of ``bravais_tpu/operators/helmholtz.py``:

    a_k(u, v) = ∫ α (∇u + i k u) · conj(∇v + i k v) dx   (stiffness A(k))
    m(u, v)   = ∫ β u conj(v) dx                          (mass M)

TM polarization is α = 1, β = ε(x); TE is α = 1/ε(x), β = 1.

What is here:

* device applies on blocks (rows, N₁, ..., N_d): ``apply_A`` (kernel half
  "A" at k), ``apply_M`` ("M") and the fused pair ``apply_AM`` ("AM"),
  all through the H1 element kernel (``operators/h1_apply.py``, on CUDA
  the hand-written ``csrc/h1_apply.cu``) — where the reference computes
  ``apply_A`` in XLA and only the fused pair in Pallas, both compute the
  same function;
* the real diagonals ``diag_A(k)``, ``diag_M`` and ``diag0`` (the k = 0
  stiffness diagonal), built once on the host;
* the f64 host twins ``apply_A_np`` and ``apply_M_np`` (one field);
* ``HelmholtzSlab``: one rank's slab of the operator split along its
  first dof axis over a process group (domain decomposition: the applies
  and ``diag_A`` with a halo exchange);
* the SPECTRAL engine (element-invariant coefficients): ``qp_fastdiag``
  (the "A" and "M" stencils of the quasi-periodic twin discretization,
  probed on the 3×3 same-Jacobian twin grid and cached on disk),
  ``qp_fd_shift`` and ``make_solve_fn``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from bravais_tpu_torch.operators.coefficients import (CoefLike,
                                                      eval_coefficient)
from bravais_tpu_torch.operators.h1_apply import H1Consts, apply_global
from bravais_tpu_torch.spaces import tensor as dtensor
from bravais_tpu_torch.spaces import tensor_np as tensor
from bravais_tpu_torch.spaces.h1 import H1Space

__all__ = ["BlochHelmholtz", "HelmholtzSlab"]


class BlochHelmholtz:
    """A(k) and M for −(∇+ik)·α(∇+ik)u = λ β u on ``space``; ``alpha`` and
    ``beta`` are scalars, quadrature planes or callables x ↦ value, kept as
    given (the multigrid resamples them on its coarse levels). Device
    work runs on ``device`` (default the CUDA device) in ``dtype``."""

    def __init__(self, space: H1Space, alpha: CoefLike = 1.0,
                 beta: CoefLike = 1.0, dtype=torch.complex64,
                 device="cuda"):
        self.space = space
        self.dtype = dtype
        self.rdtype = dtype.to_real()
        self.device = torch.device(device)
        xq = space.qpoints_phys()
        self.alpha = alpha
        self.beta = beta
        self._alpha_q64 = eval_coefficient(alpha, xq)
        self._beta_q64 = eval_coefficient(beta, xq)
        self.A_rows = space.grid.lattice.A.astype(np.float64)
        self._np_rdtype = torch.empty((), dtype=self.rdtype).numpy().dtype
        # k-independent diagonal pieces: diag A(k) = diag_S + |k|² diag_Mα.
        diag_S, diag_Ma = self._build_diagonals()
        self._diag_S = diag_S
        self._diag_M = self._mass_diagonal(self._beta_q64)
        self._dev_diag_S, self._dev_diag_Ma = (
            torch.as_tensor(a, device=self.device) for a in (diag_S, diag_Ma))
        self._consts = None

    # -- device applies ---------------------------------------------------

    def consts(self) -> H1Consts:
        """The h1 kernel's tables, metric and α·w, β·w planes on the
        device, in the working precision (built once)."""
        if self._consts is None:
            self._consts = H1Consts.from_space(
                self.space, self._alpha_q64, self._beta_q64, self.device,
                self.rdtype)
        return self._consts

    def _k(self, k) -> np.ndarray:
        """k rounded to the working precision: one k-point (d,) or a table
        (nk, d)."""
        k = np.asarray(k, self._np_rdtype)
        if k.ndim not in (1, 2) or k.shape[-1] != self.space.dim:
            raise ValueError(f"k must be ({self.space.dim},) or (nk, "
                             f"{self.space.dim}), got {k.shape}")
        return k.astype(np.float64)

    def _apply(self, u: torch.Tensor, k, want: str):
        """``apply_global`` on a block u (rows, N₁, ..., N_d) at one k, or
        on a k-batched block (nk, rows, N₁, ..., N_d) with a k table
        (nk, d): the k's row groups go through one element apply."""
        d = self.space.dim
        if k.ndim == 2 and (u.ndim != d + 2 or u.shape[0] != k.shape[0]):
            raise ValueError(f"a k table {k.shape} takes blocks (nk, rows, "
                             f"*N) with nk = {k.shape[0]}, got "
                             f"{tuple(u.shape)}")
        flat = u.reshape((-1,) + tuple(u.shape[u.ndim - d:])).to(self.dtype)
        return tuple(t.reshape(u.shape) if t is not None else None
                     for t in apply_global(self.space, flat, self.consts(),
                                           k, want))

    def apply_A(self, u: torch.Tensor, k) -> torch.Tensor:
        """A(k) u for a block u (rows, N₁, ..., N_d), or for a k-batched
        block (nk, rows, N₁, ..., N_d) with k of shape (nk, d)."""
        return self._apply(u, self._k(k), "A")[0]

    def apply_M(self, u: torch.Tensor, k=None) -> torch.Tensor:
        """M u (k-free β-mass) for a block u, with any leading axes
        ((rows, ...) or (nk, rows, ...))."""
        return self._apply(u, np.zeros(self.space.dim), "M")[1]

    def apply_AM(self, u: torch.Tensor, k):
        """(A(k) u, M u) from one fused element apply; blocks and k as in
        :meth:`apply_A`."""
        return self._apply(u, self._k(k), "AM")

    def diag_A(self, k) -> torch.Tensor:
        """Real diagonal of A(k) on the device (Jacobi / Chebyshev
        scaling): (N₁, ..., N_d) at one k, (nk, N₁, ..., N_d) for a k
        table (nk, d)."""
        return self._diag_at(k, self._dev_diag_S, self._dev_diag_Ma)

    def _diag_at(self, k, diag_S, diag_Ma) -> torch.Tensor:
        """diag_S + |k|² diag_Mα, at one k or per k of a table."""
        k = np.asarray(k, self._np_rdtype)
        if k.ndim == 1:
            return diag_S + float(np.sum(k * k)) * diag_Ma
        ksq = torch.as_tensor(np.sum(k * k, axis=-1), device=self.device)
        return diag_S + ksq.reshape((-1,) + (1,) * self.space.dim) * diag_Ma

    @property
    def diag_M(self) -> np.ndarray:
        return self._diag_M

    @property
    def diag0(self) -> np.ndarray:
        """The k-independent (k = 0) stiffness diagonal."""
        return self._diag_S

    # -- host f64 twins ---------------------------------------------------

    def _np_args(self):
        sp = self.space
        d = sp.dim
        return (sp.grid.shape, (sp.p,) * d, (True,) * d)

    def apply_A_np(self, u: np.ndarray, k: np.ndarray) -> np.ndarray:
        """f64 host A(k) u of one field (N₁, ..., N_d)."""
        sp = self.space
        d = sp.dim
        B64, D64 = sp.basis.B, sp.basis.D
        tabs = [[D64 if r == i else B64 for i in range(d)] for r in range(d)]
        wq = sp.quad_weight()
        Jinv = sp.grid.Jinv
        kb = np.asarray(k, np.float64).reshape((d,) + (1,) * 2 * d)
        ue = tensor.gather_np(np.asarray(u, np.complex128), *self._np_args())
        uq = tensor.contract_np(ue, [B64] * d)
        ghat = np.stack([tensor.contract_np(ue, tabs[r]) for r in range(d)])
        g = np.einsum("rs,s...->r...", Jinv.T, ghat)
        f = self._alpha_q64 * (g + 1j * kb * uq)
        s = -1j * np.sum(kb * f, axis=0)
        fhat = np.einsum("rs,s...->r...", Jinv, f)
        y = tensor.contract_t_np(wq * s, [B64] * d)
        for r in range(d):
            y = y + tensor.contract_t_np(wq * fhat[r], tabs[r])
        return tensor.scatter_add_np(y, *self._np_args())

    def apply_M_np(self, u: np.ndarray, k=None) -> np.ndarray:
        """f64 host M u of one field (``k`` is ignored: the mass is
        k-free)."""
        sp = self.space
        B64 = sp.basis.B
        uq = tensor.contract_np(
            tensor.gather_np(np.asarray(u, np.complex128), *self._np_args()),
            [B64] * sp.dim)
        return tensor.scatter_add_np(
            tensor.contract_t_np(sp.quad_weight() * self._beta_q64 * uq,
                                 [B64] * sp.dim), *self._np_args())

    # -- host diagonals -----------------------------------------------------

    def _rd_tables(self):
        """B, D and the quadrature weights rounded to the working
        precision, as the reference's diagonals use them."""
        rd = self._np_rdtype
        sp = self.space
        return (sp.basis.B.astype(rd), sp.basis.D.astype(rd),
                sp.quad_weight().astype(rd))

    def _build_diagonals(self):
        """diag_S[j] = Σ_q w α Σ_rs Ginv[rs] ĝ_r ĝ_s |_loc(j) and
        diag_Mα[j] = Σ_q w α φ_j(x_q)², by squared-table contractions."""
        args = self._np_args()
        return tuple(tensor.scatter_add_np(e, *args).astype(self._np_rdtype)
                     for e in self._diagonal_elements())

    def _diagonal_elements(self):
        """The element contributions (n₁, l, n₂, l, ...) to diag_S and
        diag_Mα, before their scatter-add to the dofs (f64)."""
        sp = self.space
        d = sp.dim
        B, D, wq = self._rd_tables()
        Ginv = sp.grid.Ginv
        wa = (wq * self._alpha_q64.astype(self._np_rdtype)).astype(np.float64)
        BB = B * B
        diag_S = 0.0
        for r in range(d):
            for s in range(d):
                tabs = []
                for i in range(d):
                    if i == r and i == s:
                        tabs.append(D * D)
                    elif i == r or i == s:
                        tabs.append(D * B)
                    else:
                        tabs.append(BB)
                diag_S = diag_S + Ginv[r, s] * tensor.contract_t_np(wa, tabs)
        return diag_S, tensor.contract_t_np(wa, [BB] * d)

    def _mass_diagonal(self, coef_q):
        B, _, wq = self._rd_tables()
        wb = (wq * coef_q.astype(self._np_rdtype)).astype(np.float64)
        return tensor.scatter_add_np(
            tensor.contract_t_np(wb, [B * B] * self.space.dim),
            *self._np_args()).astype(self._np_rdtype)

    # -- spectral (twisted-DFT block) engine --------------------------------

    def _coef_elem_invariant(self) -> bool:
        """True when α and β repeat identically in every element
        (constants included): the FastDiag factorization is then exact
        for the quasi-periodic twin discretization."""
        q, d = self.space.q, self.space.dim
        shape = tuple(x for n in self.space.grid.shape for x in (n, q))
        for a in (self._alpha_q64, self._beta_q64):
            a6 = np.broadcast_to(a, shape)
            ref = a6[(slice(0, 1), slice(None)) * d]
            if not np.allclose(a6, ref, rtol=1e-12, atol=0.0):
                return False
        return True

    def qp_fastdiag(self):
        """FastDiag with the "A" (−∇·α∇) and "M" (β-mass) stencils of the
        quasi-periodic twin discretization (phases in the wrap instead of
        pointwise ik). Exact for element-invariant coefficients, the
        mean-coefficient twin otherwise. Constant coefficients are probed
        on the shrunken same-Jacobian twin grid (``stencil_twin``). Host
        setup, cached in memory and on disk."""
        if not hasattr(self, "_qp_fd"):
            from bravais_tpu_torch.operators.fastdiag import FastDiag
            from bravais_tpu_torch.operators.qplaplace import QPLaplace
            sp = self.space
            if self._coef_elem_invariant():
                al, be = self.alpha, self.beta
            else:
                al = float(np.mean(self._alpha_q64))
                be = float(np.mean(self._beta_q64))
            ext_sp = sp
            if (all(n >= 3 for n in sp.grid.shape)
                    and any(n > 3 for n in sp.grid.shape)
                    and not callable(al) and not callable(be)
                    and np.ndim(al) == 0 and np.ndim(be) == 0):
                ext_sp = H1Space.make(sp.grid.stencil_twin(), sp.p, sp.q)
            stiff = QPLaplace(ext_sp, alpha=al, dtype=self.dtype,
                              device=self.device)
            mass = QPLaplace(ext_sp, alpha=0.0, beta=be, shift=1.0,
                             dtype=self.dtype, device=self.device)
            fd = FastDiag(sp.grid.shape, sp.p, 1, self.A_rows,
                          device=self.device, dtype=self.dtype)
            k0 = np.zeros(sp.dim)
            fd.add_stencil(
                "A", lambda u: stiff.apply_A_np(u, k0),
                cache_key=("h1A", sp.q, np.asarray(stiff._alpha_q64).tobytes()),
                extract_shape=ext_sp.grid.shape)
            fd.add_stencil(
                "M", lambda u: mass.apply_A_np(u, k0),
                cache_key=("h1M", sp.q, np.asarray(mass._beta_q64).tobytes()),
                extract_shape=ext_sp.grid.shape)
            self._qp_fd = fd
        return self._qp_fd

    def set_qp_fastdiag(self, fd) -> None:
        """Use a prebuilt FastDiag holding "A" and "M" (e.g. one carried
        across from the reference by ``convert``) instead of extracting."""
        missing = {"A", "M"} - set(fd.stencils)
        if missing:
            raise ValueError(f"FastDiag lacks stencils {sorted(missing)}")
        self._qp_fd = fd

    def qp_fd_shift(self) -> float:
        """Band-scale shift s of the (A + sM)⁻¹ block preconditioner."""
        B = self.space.grid.lattice.B
        return float(0.5 * np.max(np.sum(B * B, axis=1))
                     * np.mean(self._beta_q64))

    def make_solve_fn(self, engine: str = "spectral") -> Callable:
        """LOBPCG entirely in the twisted-DFT block basis: per k the
        blocks TA, TM and the (A + sM)⁻¹ preconditioner as the block
        matrix Ycᴴ Yc, Yc = chol(TA + sTM)⁻¹ (s = ``qp_fd_shift``); every
        per-iteration operation is a batched D×D block product. The
        Rayleigh–Ritz eigh stops at ``PROD_RR_TOL``. Solves the
        quasi-periodic discretization of the same Bloch problem (its
        eigenvalues differ from the matrix-free operator's only at
        discretization-error level).

        Returns ``solve(X0, k, nev, tol, maxiter)`` → (LobpcgResult with
        field eigenvectors (m, N₁, ..., N_d), support (m, B)). With a k
        table (nk, d) it solves every k at once (``solve.batched``): the
        blocks (nk, B, D, D), one Cholesky per k and block, the start
        block X0 (m, *N) shared (or one per k, (nk, m, *N)), and a
        k-batched LOBPCG; every output then
        has a leading k axis. ``solve.refine_np`` is the exact f64 block
        refine of one k (``FastDiag.spectral_refine_np``)."""
        from bravais_tpu_torch.eigen.lobpcg import (PROD_RR_TOL,
                                                    engine_scale_floor,
                                                    lobpcg)

        if engine != "spectral":
            raise ValueError(f"unknown engine {engine!r}")
        if min(self.space.grid.shape) < 3:
            raise ValueError("spectral engine needs n_i >= 3 per axis")
        if not self._coef_elem_invariant():
            raise ValueError("engine='spectral' requires element-translation-"
                             "invariant coefficients; use the matrix-free "
                             "path (BandSweep without solve_fn)")
        sfloor = engine_scale_floor(self.dtype)
        s_ = self.qp_fd_shift()
        self.qp_fastdiag()    # host stencil extraction, cached

        def cols(X):   # (..., L, B, D) rows → (..., B, D, L) block columns
            return X.movedim(-3, -1)

        def rows(Y):
            return Y.movedim(-1, -3)

        def solve(X0, k, nev, tol, maxiter):
            fd = self.qp_fastdiag()
            F = fd._fwd_mats(fd._theta(k))
            TA = fd.blocks([("A", 1.0)], k)
            TM = fd.blocks([("M", 1.0)], k)
            # HPD shifted pencil: its Cholesky inverse (chol raises if not).
            Lc = torch.linalg.cholesky(TA + s_ * TM)
            eyeD = torch.eye(fd.D, dtype=self.dtype, device=self.device)
            Yc = torch.linalg.solve_triangular(Lc, eyeD.expand(Lc.shape),
                                               upper=False)
            Tpc = Yc.mH @ Yc
            res = lobpcg(lambda X: rows(TA @ cols(X)),
                         lambda X: rows(TM @ cols(X)),
                         fd.to_blocks(X0, F), nev, maxiter=maxiter, tol=tol,
                         precond=lambda R: rows(Tpc @ cols(R)),
                         scale_floor=sfloor, rr_tol=PROD_RR_TOL,
                         batched=np.ndim(k) == 2)
            support = (res.eigenvectors.abs() ** 2).sum(dim=-1)
            Xf = fd.from_blocks(res.eigenvectors, F)
            return res._replace(eigenvectors=Xf), support

        solve.provides_support = True
        solve.batched = True
        solve.refine_np = (lambda support, k, nev:
                           self.qp_fastdiag().spectral_refine_np(support, k,
                                                                 nev))
        return solve


class HelmholtzSlab:
    """One rank's slab of a ``BlochHelmholtz`` split along its first dof
    axis over a process group (``parallel.mesh.KMesh``): domain
    decomposition of one k's operator, the reference's dof-axis sharding
    (``tests/test_domain_decomposition.py``).

    Rank r owns elements [r·n₁/P, (r+1)·n₁/P) of axis 0 and their n₁/P·p
    leading dof planes (``dofs``; ``take`` cuts them from a global
    block), so its blocks are (rows, n₁/P·p, N₂, ...). ``apply_A``,
    ``apply_M``, ``apply_AM`` run the operator's element apply (the h1
    kernel on CUDA) on the slab's elements, with the coefficient planes
    cut to them, and exchange the one-plane halo with the neighbouring
    ranks (``parallel/halo.py``); ``diag_A`` scatters the slab's element
    diagonals through the same exchange. Every rank makes each call
    together with the others. Refuses n₁ % P ≠ 0."""

    def __init__(self, op: BlochHelmholtz, mesh):
        from bravais_tpu_torch.parallel.halo import slab
        self.op, self.mesh = op, mesh
        sp = op.space
        d, p = sp.dim, sp.p
        self.space, self.dtype, self.rdtype = sp, op.dtype, op.rdtype
        self.device = op.device
        e0, ne = slab(sp.grid.shape[0], mesh)
        self.dofs = slice(e0 * p, (e0 + ne) * p)
        per = int(np.prod(sp.grid.shape[1:]))
        self._consts = op.consts().elements(e0 * per, (e0 + ne) * per)
        n = (ne,) + tuple(sp.grid.shape[1:])
        # The element diagonals of the slab, scattered over the mesh.
        self._diag_S, self._diag_Ma = (
            dtensor.scatter_add_qp(
                torch.as_tensor(e[e0:e0 + ne][None], device=self.device),
                n, (p,) * d, (True,) * d, [None] * d, mesh)[0]
            .to(self.rdtype) for e in op._diagonal_elements())

    def take(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a global block (..., N₁, ..., N_d)."""
        return u[(Ellipsis, self.dofs) + (slice(None),)
                 * (self.space.dim - 1)]

    def _apply(self, u: torch.Tensor, k, want: str):
        d = self.space.dim
        flat = u.reshape((-1,) + tuple(u.shape[u.ndim - d:])).to(self.dtype)
        return tuple(t.reshape(u.shape) if t is not None else None
                     for t in apply_global(self.space, flat, self._consts,
                                           k, want, mesh=self.mesh))

    def apply_A(self, u: torch.Tensor, k) -> torch.Tensor:
        """A(k) u on a slab block (rows, n₁/P·p, N₂, ...)."""
        return self._apply(u, self.op._k(k), "A")[0]

    def apply_M(self, u: torch.Tensor, k=None) -> torch.Tensor:
        """M u on a slab block."""
        return self._apply(u, np.zeros(self.space.dim), "M")[1]

    def apply_AM(self, u: torch.Tensor, k):
        """(A(k) u, M u) on a slab block from one fused element apply."""
        return self._apply(u, self.op._k(k), "AM")

    def diag_A(self, k) -> torch.Tensor:
        """The slab's part of the real diagonal of A(k), (n₁/P·p, N₂,
        ...)."""
        return self.op._diag_at(k, self._diag_S, self._diag_Ma)
