"""Bloch Maxwell curl-curl on tensor Nédélec elements — the spectral
(twisted-DFT block) engine.

Port of the spectral-engine half of ``bravais_tpu/operators/curlcurl.py``.
The Bloch problem is posed QUASI-PERIODICALLY: fields satisfy
u(x + a_i) = e^{i k·a_i} u(x), the operator is the plain curl-curl

    a(u, v) = ∫ μ⁻¹ (∇×u)·conj(∇×v),   m(u, v) = ∫ ε u·conj(v),

and k enters only through the wrap phases. For element-translation-
invariant coefficients (every empty-lattice configuration) the pencil
(A(k), M) and the discrete gradient G(k) are block-diagonal in the
twisted-DFT basis (``operators/fastdiag.py``), so the whole LOBPCG runs
on batched D×D blocks.

What is here:

* host f64 twins (NumPy): ``apply_A_np``, ``apply_M_np``,
  ``apply_Gk_np`` — used to extract the k=0 stencils S_δ once;
* ``fastdiag()`` / ``fastdiag_G()``: the A, M and G stencils, probed on
  the 3×3×3 same-Jacobian twin grid and cached on disk;
* ``make_spectral_solve_fn``: LOBPCG on the device blocks with the exact
  Cholesky gradient projector and the (A + sM)⁻¹ factor preconditioner
  (the reference's ``proj_method="chol"``, ``pc_rep="factor"``);
* ``spectral_refine_np``: the exact f64 host refine of the candidate
  blocks.

The field engine (matrix-free device applies, the Pallas Nédélec
kernel), the companion ``BlochHelmholtz`` and the operator diagonals are
not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from bravais_tpu_torch.operators.coefficients import (CoefLike,
                                                      eval_coefficient)
from bravais_tpu_torch.spaces import tensor_np as tensor
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

__all__ = ["BlochCurlCurl"]

_CYC = ((0, 1, 2), (1, 2, 0), (2, 0, 1))  # (r, s, t) cyclic triples

#: LOBPCG residual-scale floor of the spectral solve in complex64 (the
#: f64 refine certifies the near-zero bands) and in other dtypes.
SCALE_FLOOR_F32, SCALE_FLOOR = 0.3, 3e-2


class BlochCurlCurl:
    """Host twins, stencils and the spectral solve for
    (∇+ik)×μ⁻¹(∇+ik)× u = ω² ε u on ``space`` (NedelecSpace). Fields are
    (3, N₁, N₂, N₃) complex; device work runs on ``device`` in
    ``dtype``."""

    def __init__(self, space: NedelecSpace, eps: CoefLike = 1.0,
                 mu_inv: CoefLike = 1.0, dtype=torch.complex64,
                 device="cpu"):
        self.space = space
        self.dtype = dtype
        self.rdtype = dtype.to_real()
        self.device = torch.device(device)
        xq = space.qpoints_phys()
        self._eps_fn = eps
        self._mu_inv_fn = mu_inv
        self._eps_q64 = eval_coefficient(eps, xq)
        self._mu_inv_q64 = eval_coefficient(mu_inv, xq)
        g = space.grid
        self.A_rows = g.lattice.A.astype(np.float64)   # rows a_i
        self.detJs = float(np.linalg.det(g.J))

    # -- host f64 twins -------------------------------------------------------

    def _np_phases(self, k):
        return np.exp(1j * (self.A_rows @ np.asarray(k, np.float64)))

    def _apply_np(self, u, k, which):
        """f64 host apply of a field (3, N₁, N₂, N₃) or a block
        (m, 3, N₁, N₂, N₃) (block axis moved last, where the positional
        helpers ignore it)."""
        u = np.asarray(u, np.complex128)
        if u.ndim == 5:
            out = self._apply_np_core(np.moveaxis(u, 0, -1), k, which,
                                      batched=True)
            return np.moveaxis(out, -1, 0)
        return self._apply_np_core(u, k, which, batched=False)

    def _apply_np_core(self, u, k, which, batched):
        sp = self.space
        ph = self._np_phases(k)
        bc = (Ellipsis, None) if batched else Ellipsis
        Bc, Dc = sp.closed.B, sp.closed.D
        Bo, Do = sp.open.B, sp.open.D

        def gath(uc, c):
            out = uc
            for i in range(3):
                ax = 2 * i
                shape = out.shape
                n, p = sp.grid.shape[i], sp.p
                out = out.reshape(*shape[:ax], n, p, *shape[ax + 1:])
                if i != c:
                    first = np.take(out, [0], axis=ax + 1)
                    rolled = np.roll(first, -1, axis=ax)
                    sel = [slice(None)] * rolled.ndim
                    sel[ax] = slice(n - 1, n)
                    rolled[tuple(sel)] = rolled[tuple(sel)] * ph[i]
                    out = np.concatenate([out, rolled], axis=ax + 1)
            return out

        def scat(rc, c):
            out = rc
            for i in reversed(range(3)):
                ax = 2 * i
                n, p = sp.grid.shape[i], sp.p
                if i == c:
                    shape = out.shape
                    out = out.reshape(*shape[:ax], n * p, *shape[ax + 2:])
                else:
                    main = np.take(out, range(p), axis=ax + 1).copy()
                    last = np.take(out, [p], axis=ax + 1)
                    rolled = np.roll(last, 1, axis=ax)
                    sel = [slice(None)] * rolled.ndim
                    sel[ax] = slice(0, 1)
                    rolled[tuple(sel)] = rolled[tuple(sel)] * np.conj(ph[i])
                    idx = (slice(None),) * (ax + 1) + (0,)
                    main[idx] += np.squeeze(rolled, axis=ax + 1)
                    shape = main.shape
                    out = main.reshape(*shape[:ax], n * p, *shape[ax + 2:])
            return out

        def vtab(c):
            return [Bo if i == c else Bc for i in range(3)]

        def dtab(c, s):
            out = []
            for i in range(3):
                if i == c:
                    out.append(Do if i == s else Bo)
                else:
                    out.append(Dc if i == s else Bc)
            return out

        ue = [gath(u[c], c) for c in range(3)]
        wq = sp.quad_weight()
        if which == "M":
            uhat = np.stack([tensor.contract_np(ue[c], vtab(c))
                             for c in range(3)])
            g = (self._eps_q64 * wq)[bc] * np.einsum(
                "rs,s...->r...", sp.grid.Ginv, uhat)
            y = [tensor.contract_t_np(g[c], vtab(c)) for c in range(3)]
            return np.stack([scat(y[c], c) for c in range(3)])
        chat = []
        for r, s, t in _CYC:
            chat.append(tensor.contract_np(ue[t], dtab(t, s))
                        - tensor.contract_np(ue[s], dtab(s, t)))
        chat = np.stack(chat)
        cph = np.einsum("rs,s...->r...", sp.grid.J, chat) / self.detJs
        f = (self._mu_inv_q64 * wq)[bc] * cph
        cf = np.einsum("sr,s...->r...", sp.grid.J, f) / self.detJs
        y = [0.0, 0.0, 0.0]
        for r, s, t in _CYC:
            y[t] = y[t] + tensor.contract_t_np(cf[r], dtab(t, s))
            y[s] = y[s] - tensor.contract_t_np(cf[r], dtab(s, t))
        return np.stack([scat(y[c], c) for c in range(3)])

    def apply_A_np(self, u, k):
        return self._apply_np(u, k, "A")

    def apply_M_np(self, u, k):
        return self._apply_np(u, k, "M")

    def apply_Gk_np(self, phi, k):
        """f64 host discrete gradient ∇φ: quasi-periodic H1 scalar
        (N₁, N₂, N₃) or block (m, N₁, N₂, N₃) → ND field."""
        phi = np.asarray(phi, np.complex128)
        if phi.ndim == 4:
            out = self._apply_Gk_np_core(np.moveaxis(phi, 0, -1), k)
            return np.moveaxis(out, -1, 0)
        return self._apply_Gk_np_core(phi, k)

    def _apply_Gk_np_core(self, phi, k):
        sp = self.space
        ph = self._np_phases(k)
        out = []
        for c in range(3):
            g = tensor.gather_axis_np(phi, c, sp.grid.shape[c], sp.p,
                                      ph[c])
            d = np.moveaxis(
                np.tensordot(sp.Dnode, g, axes=((1,), (c + 1,))), 0, c + 1)
            shape = d.shape
            out.append(d.reshape(*shape[:c], sp.grid.shape[c] * sp.p,
                                 *shape[c + 2:]))
        return np.stack(out)

    # -- stencils (twisted-DFT block factorization) ---------------------------

    def _coef_elem_invariant(self) -> bool:
        """True when ε and μ⁻¹ repeat identically in every element
        (includes constants) — then the FastDiag factorization is EXACT."""
        q = self.space.q
        for a in (self._eps_q64, self._mu_inv_q64):
            a6 = np.broadcast_to(
                a, tuple(x for n in self.space.grid.shape for x in (n, q)))
            ref = a6[:1, :, :1, :, :1, :]
            if not np.allclose(a6, ref, rtol=1e-12, atol=0.0):
                return False
        return True

    def fastdiag(self):
        """FastDiag with the "A" and "M" stencils. Constant coefficients
        are probed on the shrunken same-Jacobian twin grid
        (``PeriodicGrid.stencil_twin``: identical stencils at O((3/n)³)
        of the probing cost); element-invariant callables keep the
        production grid. Host setup, cached in memory and on disk."""
        if not hasattr(self, "_fd"):
            from bravais_tpu_torch.operators.fastdiag import FastDiag
            if not self._coef_elem_invariant():
                raise ValueError("the spectral engine needs element-"
                                 "translation-invariant coefficients")
            sp = self.space
            shrink = (all(n >= 3 for n in sp.grid.shape)
                      and any(n > 3 for n in sp.grid.shape))
            if (shrink and not callable(self._eps_fn)
                    and not callable(self._mu_inv_fn)
                    and np.ndim(self._eps_fn) == 0
                    and np.ndim(self._mu_inv_fn) == 0):
                twin = BlochCurlCurl(
                    NedelecSpace.make(sp.grid.stencil_twin(), sp.p, sp.q),
                    eps=float(self._eps_fn), mu_inv=float(self._mu_inv_fn),
                    dtype=self.dtype, device=self.device)
            else:
                twin = self
            k0 = np.zeros(3)
            fd = FastDiag(sp.grid.shape, sp.p, 3, self.A_rows,
                          device=self.device, dtype=self.dtype)
            ck = (sp.q, np.asarray(twin._eps_q64).tobytes(),
                  np.asarray(twin._mu_inv_q64).tobytes())
            tshape = twin.space.grid.shape
            fd.add_stencil("A", lambda u: twin.apply_A_np(u, k0),
                           cache_key=("ccA",) + ck, extract_shape=tshape)
            fd.add_stencil("M", lambda u: twin.apply_M_np(u, k0),
                           cache_key=("ccM",) + ck, extract_shape=tshape)
            self._fd = fd
            self._fd_twin = twin
        return self._fd

    def fastdiag_G(self):
        """The fastdiag bundle with the rectangular discrete-gradient
        stencil "G" (ND ← H1) added — the spectral engine builds the
        deflation operator L = GᴴMG in block space from it."""
        fd = self.fastdiag()
        if "G" not in fd.stencils:
            from bravais_tpu_torch.operators.fastdiag import (
                _disk_cached, extract_stencil_rect)
            k0 = np.zeros(3)
            sp = self.space
            twin = getattr(self, "_fd_twin", self)
            fd.stencils["G"] = _disk_cached(
                ("ccG", sp.grid.shape, sp.p, self.A_rows.tobytes()),
                lambda: extract_stencil_rect(
                    lambda u: twin.apply_Gk_np(u, k0), 3, 1,
                    twin.space.grid.shape, twin.space.p))
        return fd

    def set_fastdiag(self, fd) -> None:
        """Use a prebuilt FastDiag holding "A", "M" and "G" (e.g. one
        carried across from the reference by
        ``convert.fastdiag_from_reference``) instead of extracting."""
        missing = {"A", "M", "G"} - set(fd.stencils)
        if missing:
            raise ValueError(f"FastDiag lacks stencils {sorted(missing)}")
        self._fd = fd

    def default_fd_shift(self) -> float:
        """Spectral shift s of the (A + sM)⁻¹ preconditioner: the band
        scale, so low modes get gain ~1/(λ+s) while the high end is
        crushed."""
        B = self.space.grid.lattice.B
        return float(0.5 * np.max(np.sum(B * B, axis=1)))

    def fd_sigma(self, m: int) -> float:
        """Kernel shift σ ≈ 2.5× an empty-lattice upper estimate of the
        m-th block eigenvalue (scaled by mean ε): the refine's σ-shifted
        gradient copies land safely above the physical bands."""
        import itertools as _it
        lat = self.space.grid.lattice
        kc = 0.5 * lat.B.sum(axis=0)
        vals = sorted(float(np.sum((kc + np.asarray(mm, np.float64)
                                    @ lat.B) ** 2))
                      for mm in _it.product(range(-3, 4), repeat=3))
        vals = sorted(v for v in vals[:m] for _ in (0, 1))[:m]
        lam_m = vals[-1] / max(float(np.mean(self._eps_q64)), 1e-30)
        return max(2.5 * lam_m, 2.0 * self.default_fd_shift())

    # -- host f64 refine ------------------------------------------------------

    def spectral_refine_np(self, support: np.ndarray, k: np.ndarray,
                           nev: int):
        """Exact f64 eigenvalues of the candidate blocks.

        The twisted-DFT blocks are exact invariant subspaces of the
        discrete pencil, so the exact discrete eigenvalues are the union
        over frequencies of each block's deflated eigenvalues.
        ``support[r, b] = Σ_j |X̂[r, b, j]|²`` (block energy of LOBPCG row
        r) picks the candidate blocks carrying the nev+2 lowest rows;
        each gets a σ-shifted generalized eigensolve (gradients moved to
        σ, copies dropped at 0.9σ, residuals against the ORIGINAL pencil).
        Returns (eigenvalues[:nev], residual certificates[:nev]), or None
        when the support is all zero."""
        import scipy.linalg

        fd = self.fastdiag_G()
        nrows = min(nev + 2, support.shape[0])
        idx = fd.candidate_blocks(support[:nrows])
        if idx.size == 0:
            return None
        k = np.asarray(k, np.float64)
        TA, TM, TG = fd.blocks_np_multi(["A", "M", "G"], k, idx)
        sigma = self.fd_sigma(nev + 4)            # ≥2.5× the nev-th band
        lams, ress = [], []
        for A_, M_, G_ in zip(TA, TM, TG):
            A_ = 0.5 * (A_ + A_.conj().T)
            M_ = 0.5 * (M_ + M_.conj().T)
            W = M_ @ G_                            # (D, Dh1)
            L = 0.5 * ((G_.conj().T @ W) + (G_.conj().T @ W).conj().T)
            nh = L.shape[0]
            tr = max(float(np.trace(L).real) / nh, 0.0)
            delta = max(1e-12 * tr, np.finfo(np.float64).tiny)
            Lc = scipy.linalg.cholesky(L + delta * np.eye(nh), lower=True)
            dg = np.real(np.diag(Lc)).copy()
            drop = (dg * dg) <= 2.0 * delta        # θ→0 rank drop at Γ
            if drop.any():
                big = dg.max() / np.finfo(np.float64).eps
                Lc[drop, :] = 0.0
                Lc[:, drop] = 0.0
                Lc[drop, drop] = big
            Y = scipy.linalg.solve_triangular(Lc, W.conj().T, lower=True)
            As = A_ + sigma * (Y.conj().T @ Y)    # + σ·M̂ĜL̂⁻¹ĜᴴM̂
            Rm = scipy.linalg.cholesky(M_, lower=True)
            T1 = scipy.linalg.solve_triangular(Rm, As, lower=True)
            Ast = scipy.linalg.solve_triangular(
                Rm, T1.conj().T, lower=True)       # L⁻¹ As L⁻ᴴ
            kmax = min(nev + 1, Ast.shape[0] - 1)
            w, Yv = scipy.linalg.eigh(0.5 * (Ast + Ast.conj().T),
                                      subset_by_index=[0, kmax],
                                      driver="evr")
            keep = w < 0.9 * sigma                # drop shifted ∇-copies
            w, Yv = w[keep], Yv[:, keep]
            X = scipy.linalg.solve_triangular(Rm, Yv, lower=True,
                                              trans='C')  # L⁻ᴴ y
            MX = M_ @ X
            R = A_ @ X - MX * w[None, :]          # ORIGINAL pencil
            nrm = np.maximum(np.linalg.norm(MX, axis=0), 1e-30)
            lams.append(w)
            ress.append(np.linalg.norm(R, axis=0) / nrm)
        allw = np.concatenate(lams)
        allr = np.concatenate(ress)
        order = np.argsort(allw)[:nev]
        lam = allw[order]
        # initial=0: candidate blocks holding only σ-copies leave allw
        # empty; the caller's cross-check then reports the short result.
        scale = np.maximum(np.abs(lam), max(
            3e-2 * float(np.abs(allw).max(initial=0.0)), 1e-3))
        return lam, allr[order] / scale

    # -- the spectral solve ---------------------------------------------------

    def make_spectral_solve_fn(self) -> Callable:
        """LOBPCG run entirely in the twisted-DFT block basis.

        Per k: the blocks TA, TM, TG; the (A + sM)⁻¹ preconditioner
        (s = ``default_fd_shift``) as its triangular factor
        Yc = chol(TA + sTM)⁻¹, applied as Ycᴴ(Yc·R); the exact gradient
        projector G L⁻¹ Gᴴ M through a δ-regularized Cholesky of
        L = ĜᴴM̂Ĝ. Every per-iteration operation is a batched block
        product over the B blocks. The Rayleigh–Ritz eigh stops at
        ``PROD_RR_TOL``.

        Returns ``solve(X0, k, nev, tol, maxiter)`` → (LobpcgResult with
        field eigenvectors (m, 3, N₁, N₂, N₃), support (m, B));
        ``solve.refine_np`` is the matching host refine.
        """
        from bravais_tpu_torch.eigen.lobpcg import PROD_RR_TOL, lobpcg

        sfloor = (SCALE_FLOOR_F32 if self.dtype == torch.complex64
                  else SCALE_FLOOR)
        s_ = self.default_fd_shift()
        fi = torch.finfo(self.rdtype)
        self.fastdiag_G()  # host stencil extraction (A, M, G), cached

        def cols(X):   # (L, B, D) rows → (B, D, L) block columns
            return X.permute(1, 2, 0)

        def rows(Y):
            return Y.permute(2, 0, 1)

        def solve(X0, k, nev, tol, maxiter):
            fd = self.fastdiag_G()
            F = fd._fwd_mats(fd._theta(k))
            TA = fd.blocks([("A", 1.0)], k)
            TM = fd.blocks([("M", 1.0)], k)
            TG = fd.blocks([("G", 1.0)], k)          # (B, D, Dh1)
            TGH = TG.mH
            # (A+sM)⁻¹ as the factor Yc = L⁻¹ (HPD: chol raises if not).
            Lc = torch.linalg.cholesky(TA + s_ * TM)
            eyeD = torch.eye(fd.D, dtype=self.dtype, device=self.device)
            Yc = torch.linalg.solve_triangular(
                Lc, eyeD.expand(Lc.shape), upper=False)
            YcH = Yc.mH                               # adjoint view
            # Projector factor: chol(L + δI), δ relative to the block
            # trace; rows cholesky_ex flags as failed are zeroed, and every
            # direction with a pivot at/below δ (the Γ harmonic) gets a
            # huge pivot, which zeroes it in the solve instead of
            # amplifying it by 1/δ.
            Lb = TGH @ (TM @ TG)                      # (B, Dh1, Dh1)
            nh = Lb.shape[-1]
            trm = torch.diagonal(Lb, dim1=-2, dim2=-1).real.sum(-1) / nh
            delta = 1e-7 * trm
            eyeH = torch.eye(nh, dtype=self.dtype, device=self.device)
            Rl, info = torch.linalg.cholesky_ex(Lb + delta[:, None, None]
                                                * eyeH)
            ridx = torch.arange(nh, device=self.device)
            failed = (info[:, None] > 0) & (ridx[None, :] >= info[:, None] - 1)
            Rl = torch.where(failed[..., None], 0.0, Rl)
            dg = torch.diagonal(Rl, dim1=-2, dim2=-1).real
            big = dg.max() / fi.eps
            dfloor = torch.clamp(delta, min=fi.tiny)
            tiny = (dg * dg) <= (2.0 * dfloor)[:, None]
            Rl = Rl + torch.diag_embed((tiny * big).to(self.dtype))
            RlH = Rl.mH

            def proj_cols(xc):
                r = TGH @ (TM @ xc)
                z = torch.linalg.solve_triangular(Rl, r, upper=False)
                phi = torch.linalg.solve_triangular(RlH, z, upper=True)
                return TG @ phi

            def proj(X):
                return rows(proj_cols(cols(X)))

            def pcond(R):
                zc = YcH @ (Yc @ cols(R))
                return rows(zc - proj_cols(zc))

            X0b = fd.to_blocks(X0, F)
            X0b = X0b - proj(X0b)
            res = lobpcg(lambda X: rows(TA @ cols(X)),
                         lambda X: rows(TM @ cols(X)), X0b, nev,
                         maxiter=maxiter, tol=tol, precond=pcond,
                         scale_floor=sfloor, kernel_project=proj,
                         rr_tol=PROD_RR_TOL)
            # Block support of each row: the tiny (m, B) array the host
            # refine needs instead of the full eigenvector block.
            support = (res.eigenvectors.abs() ** 2).sum(dim=-1)
            Xf = fd.from_blocks(res.eigenvectors, F)
            return res._replace(eigenvectors=Xf), support

        solve.refine_np = self.spectral_refine_np
        return solve
