"""Host float64 Rayleigh–Ritz refinement.

Port of ``bravais_tpu/eigen/refine.py``. The float32 LOBPCG stops at a
loose residual; one Rayleigh–Ritz in float64 on the host, on the
operators' matrix-free NumPy twins, recovers eigenvalues to
~residual²/gap accuracy. It is the refine of the field engine and of the
matrix-free scalar solve, and the spectral engines' fallback after a
failed cross-check. Operators whose twins take a whole block set
``supports_batched_np``; the others are applied row by row.

Maxwell gradient-kernel handling, chosen by coefficient structure:

* element-invariant ε — the exact fast-diagonal projection of the block
  (``gradient_component_np``);
* varying ε — a σ-SHIFT of the gradient subspace inside the
  Rayleigh–Ritz: Ĝ_A ← Ĝ_A + σ·Kp with Kp = ⟨GᴴM x_i, L̃⁻¹ GᴴM x_j⟩ and
  L̃ the mean-ε twin solve. The term vanishes exactly on physical vectors
  (GᴴM x = 0) for any HPD L̃ and pushes every gradient direction up by
  ≥ σ·(min ε/ε̄). Reported eigenvalues are the ORIGINAL-pencil Rayleigh
  quotients of the shifted-pencil Ritz vectors, and the residual
  certificate is taken against the original pencil.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.linalg

__all__ = ["host_rayleigh_ritz"]


def host_rayleigh_ritz(op, X: np.ndarray, k: np.ndarray, nev: int,
                       rows: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """f64 Rayleigh–Ritz of the pencil (A(k), M) on span(X[:rows]).

    ``X``: complex eigenvector block (m, *dof_shape) from the device
    solve, rows ascending by device Ritz value. ``rows`` (default nev+2,
    capped at m) keeps the lowest rows. Returns (eigenvalues[:nev],
    residuals[:nev]), the residuals relative f64 residual norms — an
    a-posteriori certificate of each band. A rank-deficient block pads
    with the top value and the residual sentinel 1e6.
    """
    X = np.asarray(X).astype(np.complex128)
    rows = min(X.shape[0], rows if rows is not None else nev + 2)
    X = X[:rows]
    m = X.shape[0]
    k = np.asarray(k, np.float64)
    is_maxwell = (hasattr(op, "gradient_component_np")
                  and min(op.space.grid.shape) >= 3)
    invariant = is_maxwell and op._coef_elem_invariant()
    if invariant:
        X = X - op.gradient_component_np(X, k)
    Xf = X.reshape(m, -1)
    if getattr(op, "supports_batched_np", False):
        AXs = np.asarray(op.apply_A_np(X, k))
        MXs = np.asarray(op.apply_M_np(X, k))
    else:                      # host twins of one field (BlochHelmholtz)
        AXs = np.stack([op.apply_A_np(x, k) for x in X])
        MXs = np.stack([op.apply_M_np(x, k) for x in X])
    AX = AXs.reshape(m, -1)
    MX = MXs.reshape(m, -1)
    GA = Xf.conj() @ AX.T
    GM = Xf.conj() @ MX.T
    GA = 0.5 * (GA + GA.conj().T)
    GM = 0.5 * (GM + GM.conj().T)
    GAs = GA
    if is_maxwell and not invariant:
        # σ is the fd_sigma band-scale estimate over the twin's lower
        # bound a = min ε/ε̄, so the shifted gradient floor σ·a keeps
        # fd_sigma's ≥2.5× margin over the nev-th band at any contrast.
        a, _ = op.cheby_bounds()
        sigma = op.fd_sigma(m) / max(a, 1e-12)
        C = op.apply_GkH_np(MXs, k)               # (m, N₁, N₂, N₃) H1
        Z = op.fastdiag_L().solver_np([("L", 1.0)], k)(C)
        Kp = C.reshape(m, -1).conj() @ Z.reshape(m, -1).T
        GAs = GA + sigma * 0.5 * (Kp + Kp.conj().T)
    # Guard against (near-)dependent rows of the f32 block.
    w, V = scipy.linalg.eigh(GM)
    good = w > 1e-10 * w.max()
    C_ = V[:, good] / np.sqrt(w[good])
    H = C_.conj().T @ GAs @ C_
    theta, Y = scipy.linalg.eigh(0.5 * (H + H.conj().T))
    nev_req = nev
    nev = min(nev, theta.size)
    coeff = C_ @ Y[:, :nev]                       # (m, nev)
    # Original-pencil Rayleigh quotients (drops the +σ‖leak‖² bias).
    lam = np.real(np.diag(coeff.conj().T @ GA @ coeff))
    order = np.argsort(lam)
    lam = lam[order]
    coeff = coeff[:, order]
    R = coeff.T @ AX - lam[:, None] * (coeff.T @ MX)
    scale = np.maximum(np.abs(lam), max(3e-2 * np.abs(lam).max(), 1e-3))
    res = np.linalg.norm(R, axis=1) / scale
    if nev < nev_req:
        pad = nev_req - nev
        top = lam[-1] if nev else 0.0
        lam = np.concatenate([lam, np.full(pad, top)])
        res = np.concatenate([res, np.full(pad, 1e6)])
    return lam, res
