"""k-path band sweeps: warm-started and cold.

Port of ``BandSweep`` (the refine and ``device_tol`` rules, the
preconditioner choice, the built-in solve, ``_refine_host``, ``run_warm``
and ``run``) from ``bravais_tpu/bands/sweep.py``. Each k is solved on the
device, then refined in f64 on the host. The solve is an engine's
``solve_fn`` or, without one, the built-in LOBPCG on the operator's
matrix-free ``apply_A``/``apply_M`` with its fused ``apply_AM`` and a
Jacobi or geometric-multigrid preconditioner. The refine:

* a SPECTRAL solve hands over the tiny (m, B) block support, and the
  exact f64 block refine (``solve_fn.refine_np``) replaces the float32
  eigenvalues; a refine that fails its cross-check against the device
  values (or an empty support) falls back to ``host_rayleigh_ritz`` on
  the whole m-row block;
* a FIELD or built-in solve (no support) brings the eigenvector block to
  the host and refines it with ``host_rayleigh_ritz`` on its lowest
  nev+2 rows.

``run_warm`` starts each k from the previous k's eigenvector block (which
stays on the device); ``run`` starts every k from the seeded start block
and solves a chunk of k-points as ONE k-batched solve, a LOBPCG with a
leading k axis (as the reference vmaps a chunk): every engine's
``solve_fn`` takes a k table (nk, d) (``solve.batched``: the scalar and
Maxwell spectral engines, the Maxwell field engine with either
deflation), and so does the built-in solve with any preconditioner (the
Jacobi diagonal per k, the geometric-multigrid V-cycle with a k table, a
caller's preconditioner given the k table) on a ``BlochHelmholtz`` or a
``BlochCurlCurl``. The k of a chunk step in lockstep and a k that is done
is frozen (``chunk=1`` solves the k one at a time). Each k of a chunk is
then refined on the host. With a ``writer`` (``bands.io.BandWriter``) each
finished k (``run_warm``) or chunk (``run``) is on disk at once, so a
killed sweep resumes where it stopped.

The reference overlaps the host refine of k (or of a chunk) with the
device solve of the next (``bravais_tpu/bands/sweep.py`` ``run`` and
``run_warm``); this host-driven loop still runs them one after the
other. The chain/segment modes, the sharded sweeps and the near-Γ loose
stop are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from bravais_tpu_torch.eigen.lobpcg import PROD_RR_TOL, lobpcg
from bravais_tpu_torch.eigen.precond import jacobi
from bravais_tpu_torch.eigen.refine import host_rayleigh_ritz

__all__ = ["BandSweep", "SweepResult"]

#: numpy seed of the start block (the reference's default; both packages
#: draw the same block from it).
SEED = 0


@dataclasses.dataclass
class SweepResult:
    """Band table for a sampled k-path.

    eigenvalues : (nk, nev) λ (scalar) or ω² (Maxwell), refined when on
    iterations  : (nk,) LOBPCG iterations per k-point
    residuals   : (nk, nev) relative residuals (f64 certificates when
                  refined)
    wall_s      : wall time of the whole sweep, device work included
    refine_s    : the part of ``wall_s`` spent in the host f64 refine
    fallbacks   : k-points whose spectral refine failed its cross-check
                  (or had an empty support) and went to the host
                  Rayleigh–Ritz
    eigenvectors: (nk, nev, *dof_shape) complex device modes (the solve's
                  eigenvector rows, before the refine), host; only with
                  ``keep_vectors``
    """

    eigenvalues: np.ndarray
    iterations: np.ndarray
    residuals: np.ndarray
    wall_s: float
    refine_s: float = 0.0
    fallbacks: int = 0
    eigenvectors: Optional[np.ndarray] = None


class BandSweep:
    """Warm-started sweep over Cartesian k-points.

    Parameters
    ----------
    operator   : ``BlochCurlCurl`` or ``BlochHelmholtz``; its space and
                 dtype define the problem.
    solve_fn   : an engine's ``make_spectral_solve_fn()`` /
                 ``make_solve_fn()``, or None for the built-in LOBPCG on
                 the operator's matrix-free applies.
    nev        : number of bands; ``block`` the LOBPCG block size
                 (default nev + max(4, nev // 2)).
    tol        : target; in complex64 with ``tol < 1e-4`` the f64 refine
                 is on and the device loop stops at ``device_tol``
                 (default max(tol, 1e-5)).
    precond    : the built-in solve's preconditioner: "auto" (geometric
                 multigrid for a ``BlochHelmholtz`` whose coefficients
                 vary between elements, Jacobi otherwise), "jacobi",
                 "gmg", None, or a callable k ↦ block preconditioner
                 (``run`` calls it with a k table (nk, d), and its
                 preconditioner takes (nk, rows, *dof) blocks).
    seed       : numpy seed of the start block.
    keep_vectors : return each k's eigenvector rows in
                 ``SweepResult.eigenvectors`` (for mode dumps).
    """

    def __init__(self, operator, solve_fn: Optional[Callable] = None,
                 nev: int = 10, block: Optional[int] = None,
                 tol: float = 1e-6, maxiter: int = 200,
                 device_tol: Optional[float] = None, precond="auto",
                 seed: int = SEED, keep_vectors: bool = False):
        self.op = operator
        self.seed = seed
        self.keep_vectors = keep_vectors
        self.builtin = solve_fn is None
        self.solve_fn = solve_fn if solve_fn is not None else self._solve
        self.nev = nev
        self.m = block if block is not None else nev + max(4, nev // 2)
        self.maxiter = maxiter
        # In f32 the device converges to a loose residual and the f64
        # host refine recovers the eigenvalue accuracy; ``tol`` below the
        # f32 floor is redirected into the refine.
        is_f32 = operator.dtype == torch.complex64
        self.refine = is_f32 and tol < 1e-4
        self.tol = max(tol, 1e-5) if (is_f32 and self.refine) else tol
        # The spectral refine is an exact block eigensolve, so the device
        # loop only has to identify the support blocks.
        if device_tol is not None and self.refine:
            self.tol = device_tol
        self.precond = precond
        self.gmg = None
        if solve_fn is None:
            self._resolve_precond()

    def _resolve_precond(self):
        """Resolve ``precond="auto"`` and build the GMG hierarchy now, not
        inside the first solve. Jacobi stalls on the stiffness contrast of
        varying-α scalar problems (the TE air-hole crystal), which one
        V-cycle per iteration converges."""
        from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
        pre = self.precond
        if pre == "auto":
            pre = ("gmg" if isinstance(self.op, BlochHelmholtz)
                   and not self.op._coef_elem_invariant() else "jacobi")
        if pre == "gmg":
            from bravais_tpu_torch.eigen.gmg import GMG
            self.gmg = GMG(self.op)
        elif not (pre in ("jacobi", None) or callable(pre)):
            raise ValueError(f"unknown precond {pre!r}")
        self.precond_mode = pre

    def _make_precond(self, k):
        """The resolved preconditioner at k, or at a k table (nk, d) on
        k-batched blocks (nk, rows, *dof): Jacobi with one diagonal per
        k, the V-cycle with the table, or the caller's callable given the
        table."""
        pre = self.precond_mode
        if pre == "gmg":
            return self.gmg.precond(k)
        if pre == "jacobi":
            return jacobi(self.op.diag_A(k), batched=np.ndim(k) == 2)
        if callable(pre):
            return pre(k)
        return None

    def _solve(self, X0, k, nev, tol, maxiter):
        """The built-in solve: LOBPCG on (A(k), M) with the fused (A, M)
        element apply and the resolved preconditioner; no block support.
        At a k table (nk, d) one k-batched LOBPCG from X0 (m, *dof),
        shared by every k."""
        op = self.op
        batched = np.ndim(k) == 2
        if batched:
            X0 = X0.expand((len(k),) + tuple(X0.shape))
        # M gets k too: a BlochCurlCurl mass wraps with the Bloch phases.
        return lobpcg(lambda x: op.apply_A(x, k), lambda x: op.apply_M(x, k),
                      X0, nev, maxiter=maxiter, tol=tol,
                      precond=self._make_precond(k),
                      AM=lambda x: op.apply_AM(x, k),
                      rr_tol=PROD_RR_TOL, batched=batched), None

    def _batched_solve(self) -> Callable:
        """The solve ``run`` gives a whole chunk of k at once: the built-in
        solve or an engine's ``solve_fn`` (each sets ``batched = True``);
        raises for a ``solve_fn`` that takes one k only."""
        if self.builtin:
            return self._solve
        if not getattr(self.solve_fn, "batched", False):
            raise ValueError("run solves a chunk of k-points at once: its "
                             "solve_fn must take a k table (nk, d) and set "
                             "batched = True (run_warm takes one k a solve)")
        return self.solve_fn

    def _x0(self) -> torch.Tensor:
        """Start block from ``np.random.default_rng(seed)``, drawn as the
        reference draws it (real and imaginary planes)."""
        rng = np.random.default_rng(self.seed)
        sp = self.op.space
        shp = (self.m,) + tuple(getattr(sp, "field_shape", sp.dof_shape))
        t = torch.as_tensor(np.stack([rng.standard_normal(shp),
                                      rng.standard_normal(shp)]),
                            dtype=self.op.rdtype, device=self.op.device)
        return torch.complex(t[0], t[1])

    def _refine_host(self, lam_d: np.ndarray, support, X: torch.Tensor,
                     k):
        """f64 refine of one k-point; returns (eigenvalues, residuals,
        fell back). With a block ``support`` (spectral solve): the exact
        block refine, cross-checked against the device eigenvalues ``lam_d``;
        a failed check or an empty support falls back to the host
        Rayleigh–Ritz on all m rows of the eigenvector block ``X`` (a
        true band may sit in a guard row). Without (field or built-in
        solve): the host Rayleigh–Ritz on the lowest nev+2 rows."""
        if support is None:
            lam, res = host_rayleigh_ritz(self.op, X.cpu().numpy(), k,
                                          self.nev)
            return lam, res, False
        ref = self.solve_fn.refine_np(support, k, self.nev)
        if ref is not None:
            lam, res = ref
            lam_d = lam_d[:self.nev]
            sc = np.maximum(np.abs(lam_d),
                            3e-2 * max(float(np.abs(lam_d).max()), 1e-30))
            if lam.size == lam_d.size and np.all(
                    np.abs(lam - lam_d) / sc < 3e-2):
                return lam, res, False
        lam, res = host_rayleigh_ritz(self.op, X.cpu().numpy(), k,
                                      self.nev, rows=X.shape[0])
        return lam, res, True

    def _refined(self, r, support, X, k, j=None):
        """One k's row of the result from a solve's output ``r`` (and its
        block ``support``; index ``j`` into a k-batched one): (eigenvalues,
        iterations, residuals, seconds in the refine, fell back)."""
        pick = (lambda t: t) if j is None else (lambda t: t[j])
        lam = pick(r.eigenvalues).double().cpu().numpy()
        res = pick(r.residual_norms).double().cpu().numpy()
        its = int(pick(r.iterations))
        dt, fell = 0.0, False
        if self.refine:
            sup = (pick(support).double().cpu().numpy()
                   if support is not None else None)
            t1 = time.perf_counter()
            lam, res, fell = self._refine_host(lam, sup, X, k)
            dt = time.perf_counter() - t1
        return lam, its, res, dt, fell

    def _solve_refined(self, X, k):
        """Solve at k from the block ``X`` and refine; returns (eigenvalues,
        iterations, residuals, seconds in the refine, fell back, the
        solve's eigenvector block on the device)."""
        r, support = self.solve_fn(X, k, self.nev, self.tol, self.maxiter)
        return (*self._refined(r, support, r.eigenvectors, k),
                r.eigenvectors)

    def _rounded(self, k_cart) -> np.ndarray:
        """The k-points rounded to the device's real precision, as the
        reference rounds them: the solve and the f64 refine see the same
        k."""
        rdtype = torch.empty((), dtype=self.op.rdtype).numpy().dtype
        return np.asarray(k_cart, rdtype)

    def _result(self, rows, wall, vecs) -> SweepResult:
        lams, itss, ress, dts, fells = zip(*rows)
        return SweepResult(np.asarray(lams), np.asarray(itss, np.int32),
                           np.asarray(ress), wall_s=wall,
                           refine_s=float(sum(dts)),
                           fallbacks=int(sum(fells)),
                           eigenvectors=(np.stack(vecs)
                                         if vecs is not None else None))

    def run_warm(self, k_cart: np.ndarray, writer=None,
                 k_index: Optional[np.ndarray] = None) -> SweepResult:
        """Sequential sweep, each k warm-started from the previous
        eigenvector block. With ``writer``, every finished k is written
        at once under its global index ``k_index[i]`` (default i)."""
        k_cart = self._rounded(k_cart)
        X = self._x0()
        rows, vecs = [], [] if self.keep_vectors else None
        t0 = time.perf_counter()
        for i, k in enumerate(k_cart):
            *row, X = self._solve_refined(X, k)
            rows.append(row)
            if vecs is not None:
                vecs.append(X[:self.nev].cpu().numpy())
            if writer is not None:
                lam, its, res = row[:3]
                gi = int(k_index[i]) if k_index is not None else i
                writer.write_chunk([gi], lam[None, :self.nev], [its],
                                   res[None, :self.nev])
        return self._result(rows, time.perf_counter() - t0, vecs)

    def run(self, k_cart: np.ndarray, chunk: Optional[int] = None,
            writer=None, k_index: Optional[np.ndarray] = None
            ) -> SweepResult:
        """Cold sweep: every k solved from the seeded start block, in
        chunks of ``chunk`` k-points (default all). A chunk is one
        k-batched solve (module docstring); each k is then refined on the
        host. With ``writer``, each finished chunk is
        written at once under the global indices ``k_index`` (default
        0..nk-1)."""
        k_cart = self._rounded(k_cart)
        nk = len(k_cart)
        chunk = chunk or nk
        X0 = self._x0()
        bsolve = self._batched_solve()
        rows, vecs = [], [] if self.keep_vectors else None
        t0 = time.perf_counter()
        for s in range(0, nk, chunk):
            ks = k_cart[s:s + chunk]
            r, support = bsolve(X0, ks, self.nev, self.tol, self.maxiter)
            part = [self._refined(r, support, r.eigenvectors[j], k, j)
                    for j, k in enumerate(ks)]
            if vecs is not None:
                vecs.extend(r.eigenvectors[:, :self.nev].cpu().numpy())
            rows.extend(part)
            if writer is not None:
                gidx = (k_index[s:s + len(part)] if k_index is not None
                        else range(s, s + len(part)))
                lam, its, res = (np.asarray(c) for c in
                                 list(zip(*part))[:3])
                writer.write_chunk(gidx, lam[:, :self.nev], its,
                                   res[:, :self.nev])
        return self._result(rows, time.perf_counter() - t0, vecs)
