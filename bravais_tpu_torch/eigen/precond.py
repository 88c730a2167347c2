"""Preconditioners for the LOBPCG eigensolves.

Port of ``bravais_tpu/eigen/precond.py``: the operator-diagonal Jacobi
preconditioner, and the diagonally scaled Chebyshev smoother with the
power-iteration estimate of its upper bound. Geometric multigrid lives
in ``eigen/gmg.py`` and plugs into the same interface, ``precond(R) ->
W`` on blocks (rows, *dof_shape), or (nk, rows, *dof_shape) with
``batched``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["jacobi", "chebyshev", "estimate_lmax"]


def _scale(diag: torch.Tensor, batched: bool) -> torch.Tensor:
    """The clamped real diagonal, with a row axis after the k axis when
    ``batched``."""
    d = torch.clamp(diag.real, min=1e-30)
    return d.unsqueeze(1) if batched else d


def jacobi(diag: torch.Tensor, batched: bool = False) -> Callable:
    """Diagonal (Jacobi) preconditioner W = R / diag (``diag`` real, of
    the dof shape, on the device of the blocks it will scale). With
    ``batched``, ``diag`` is (nk, *dof_shape), one diagonal per k, and
    scales k-batched blocks (nk, rows, *dof_shape)."""
    d = _scale(diag, batched)

    def apply(R):
        return R / d
    return apply


def estimate_lmax(A: Callable, diag: torch.Tensor, shape, iters: int = 12,
                  seed: int = 7, dtype=torch.complex64) -> torch.Tensor:
    """Power-iteration estimate of λ_max(D⁻¹A), inflated by 1.1 for
    safety: a real 0-dim tensor on ``diag``'s device. The start vector of
    ``shape`` comes from ``np.random.default_rng(seed)`` (real, then
    imaginary part, as the reference draws it); ``A`` acts on a tensor of
    ``shape`` (a field, or a block of one row)."""
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    v = torch.as_tensor(v0, device=diag.device).to(dtype)
    d = _scale(diag, False)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = A(v) / d
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    w = A(v) / d
    lam = (torch.vdot(v.flatten(), w.flatten()).real
           / torch.vdot(v.flatten(), v.flatten()).real)
    return 1.1 * lam


def chebyshev(A: Callable, diag: torch.Tensor, lmax, degree: int = 3,
              lmin_frac: float = 0.06, batched: bool = False) -> Callable:
    """Chebyshev smoothing preconditioner on the diagonally scaled
    operator D⁻¹A over [lmin_frac·λmax, λmax] (the multigrid smoother
    recipe, used alone as a stronger-than-Jacobi LOBPCG preconditioner):
    ``degree`` terms of the Chebyshev iteration for D⁻¹A x = D⁻¹R from
    x = 0. ``A`` acts on blocks (rows, *dof_shape), ``diag`` is of the dof
    shape; with ``batched``, blocks (nk, rows, *dof_shape), ``diag``
    (nk, *dof_shape) and ``lmax`` a scalar or one value per k (nk,)."""
    d = _scale(diag, batched)
    if batched and torch.is_tensor(lmax) and lmax.ndim == 1:
        lmax = lmax.to(d.device).reshape((-1,) + (1,) * (d.ndim - 1))
    lo = lmin_frac * lmax
    theta = 0.5 * (lmax + lo)
    delta = 0.5 * (lmax - lo)
    sigma1 = theta / delta

    def apply(R):
        b = R / d
        x = b / theta
        rk = b - A(x) / d
        rho_old = 1.0 / sigma1
        dx = x
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma1 - rho_old)
            dx = rho * rho_old * dx + (2.0 * rho / delta) * rk
            x = x + dx
            rk = rk - A(dx) / d
            rho_old = rho
        return x
    return apply
