"""Geometric multigrid preconditioner for the Bloch H1 operator.

Port of ``GMG`` from ``bravais_tpu/eigen/gmg.py``, exploiting the
structured periodic grid:

* hierarchy: p-coarsen p → 1 (embedded nodal interpolation), then
  h-coarsen n → n/2 while n is even and n/2 ≥ ``MIN_COARSE`` (GLL p=1
  nodes at n coincide with the corner and midpoint nodes of n/2
  elements, so both transfers are the same per-element contraction);
  every level is a ``BlochHelmholtz`` rediscretized from the coefficient
  callables, so every level's ``apply_A`` is the H1 element kernel;
* smoother: Chebyshev(``NU``) on the diagonally scaled operator over
  [λmax/15, λmax], λmax from a host f64 power iteration at k = 0 (×1.25;
  the |k|² part scales A and its diagonal alike);
* coarsest level: ``COARSE_SWEEPS`` Chebyshev sweeps.

Where the reference vmapped a single-field V-cycle, this one acts on
whole blocks (rows, *dof_shape), and with a k table (nk, d) on k-batched
blocks (nk, rows, *dof_shape): each level's diagonal per k, each level
apply one h1 launch with the table, the transfers over the nk·rows rows
(what the reference's vmap over a chunk of k computes). λmax and the
Chebyshev scalars come from k = 0 and are shared by every k; they are
computed in the working precision, as the reference's traced scalars
are.
``QPGMG`` (the quasi-periodic variant) is not ported: its only caller is
the reference's ``gmg`` deflation.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.spaces import tensor
from bravais_tpu_torch.spaces.basis1d import lagrange_eval
from bravais_tpu_torch.spaces.h1 import H1Space

__all__ = ["GMG"]

NU = 3              # Chebyshev sweeps before and after the coarse solve
COARSE_SWEEPS = 8   # Chebyshev sweeps on the coarsest level
MIN_COARSE = 2      # the coarsest grid has at least this many elements/axis


def _prolong_table(fine_nodes: np.ndarray) -> np.ndarray:
    """(n_fine_local, 2): p=1 hat values at the fine element-local nodes
    (the last, shared node dropped)."""
    B, _ = lagrange_eval(np.array([0.0, 1.0]), fine_nodes[:-1])
    return B


class _Level:
    def __init__(self, op: BlochHelmholtz, lmax: float):
        self.op = op
        self.lmax = lmax


class GMG:
    """V-cycle preconditioner factory for an ``H1Space`` Bloch operator:
    ``GMG(fine_op).precond(k)`` is the block preconditioner at k. The
    coarse levels resample ``fine_op``'s coefficients (scalars or
    callables), in its dtype and on its device."""

    def __init__(self, fine_op: BlochHelmholtz):
        space = fine_op.space
        lat = space.grid.lattice

        specs = [(space.grid.shape, space.p)]
        if space.p > 1:
            specs.append((space.grid.shape, 1))
        n = np.asarray(space.grid.shape)
        while np.all(n % 2 == 0) and np.all(n // 2 >= MIN_COARSE):
            n = n // 2
            specs.append((tuple(int(x) for x in n), 1))

        self.levels: List[_Level] = [_Level(fine_op,
                                            self._lmax_host(fine_op))]
        for shape, p in specs[1:]:
            sp = H1Space.make(PeriodicGrid.make(lat, shape), p,
                              max(p + 2, 3))
            op = BlochHelmholtz(sp, alpha=fine_op.alpha,
                                beta=fine_op.beta, dtype=fine_op.dtype,
                                device=fine_op.device)
            self.levels.append(_Level(op, self._lmax_host(op)))

        # Transfer tables, level i → i+1 (restriction is the transpose):
        # (fine locals per coarse element, 2), on the device in the
        # complex working dtype.
        self._ptabs = []
        for i in range(len(self.levels) - 1):
            fine = self.levels[i].op.space
            coarse = self.levels[i + 1].op.space
            if fine.grid.shape == coarse.grid.shape:   # p → 1
                tab = _prolong_table(fine.basis.nodes)
            else:                                       # h → h/2 (p = 1)
                tab = _prolong_table(np.array([0.0, 0.5, 1.0]))
            op0 = self.levels[0].op
            self._ptabs.append(torch.as_tensor(
                tab.astype(op0._np_rdtype), device=op0.device).to(op0.dtype))

    @staticmethod
    def _lmax_host(op: BlochHelmholtz) -> float:
        """Host power-iteration bound for λ_max(D⁻¹A(0)) on the f64 twin
        (plus margin); one k = 0 bound covers the Brillouin zone."""
        sp = op.space
        rng = np.random.default_rng(11)
        v = rng.standard_normal(sp.dof_shape) \
            + 1j * rng.standard_normal(sp.dof_shape)
        d = np.maximum(np.asarray(op.diag0, np.float64), 1e-30)
        k0 = np.zeros(sp.dim)
        lam = 1.0
        for _ in range(30):
            w = op.apply_A_np(v, k0) / d
            lam = float(np.linalg.norm(w.ravel()) / np.linalg.norm(v.ravel()))
            v = w / np.linalg.norm(w.ravel())
        return 1.25 * lam

    # -- transfers (blocks with a leading row axis) -------------------------

    def _prolong(self, i: int, u: torch.Tensor) -> torch.Tensor:
        """coarse level i+1 → fine level i (values: assign semantics)."""
        coarse = self.levels[i + 1].op.space
        d = coarse.dim
        if u.ndim == d + 2:                 # k-batched: fold k into rows
            return self._prolong(i, u.flatten(0, 1)).unflatten(
                0, u.shape[:2])
        tab = self._ptabs[i]
        nf = tab.shape[0]
        n = coarse.grid.shape
        ue = tensor.gather(u, n, (coarse.p,) * d, (True,) * d)
        perm = [0] + [1 + 2 * j for j in range(d)] + [2 + 2 * j
                                                      for j in range(d)]
        ue = tensor.contract(ue.permute(perm), [tab] * d)  # (R, n.., nf..)
        inv = [0] + [x for j in range(d) for x in (1 + j, 1 + d + j)]
        # The locals are the element's fine nodes with the shared node
        # dropped, so a reshape reassembles the fine global array.
        return ue.permute(inv).reshape((u.shape[0],)
                                       + tuple(m * nf for m in n))

    def _restrict(self, i: int, r: torch.Tensor) -> torch.Tensor:
        """fine level i → coarse level i+1 (residuals: the adjoint)."""
        coarse = self.levels[i + 1].op.space
        d = coarse.dim
        if r.ndim == d + 2:                 # k-batched: fold k into rows
            return self._restrict(i, r.flatten(0, 1)).unflatten(
                0, r.shape[:2])
        tab = self._ptabs[i]
        nf = tab.shape[0]
        n = coarse.grid.shape
        r = r.reshape((r.shape[0],) + tuple(x for m in n for x in (m, nf)))
        perm = [0] + [1 + 2 * j for j in range(d)] + [2 + 2 * j
                                                      for j in range(d)]
        r = tensor.contract_t(r.permute(perm), [tab] * d)  # (R, n.., 2..)
        inv = [0] + [x for j in range(d) for x in (1 + j, 1 + d + j)]
        return tensor.scatter_add(r.permute(inv), n, (coarse.p,) * d,
                                  (True,) * d)

    # -- smoother and V-cycle -------------------------------------------------

    def _chebyshev(self, lev: _Level, d, k, b, x, nu: int):
        """x ← x + p(D⁻¹A)(b − A x), Chebyshev on [λmax/15, λmax] (D the
        level's clamped diagonal ``d``); the scalars in the working
        precision."""
        op = lev.op
        rt = op._np_rdtype.type
        lmax = rt(lev.lmax)
        lo = lmax / rt(15.0)
        theta = rt(0.5) * (lmax + lo)
        delta = rt(0.5) * (lmax - lo)
        sigma1 = theta / delta

        r = (b - op.apply_A(x, k)) / d
        dx = r / float(theta)
        x = x + dx
        rho_old = rt(1.0) / sigma1
        for _ in range(nu - 1):
            r = r - op.apply_A(dx, k) / d
            rho = rt(1.0) / (rt(2.0) * sigma1 - rho_old)
            dx = float(rho * rho_old) * dx + float(rt(2.0) * rho / delta) * r
            x = x + dx
            rho_old = rho
        return x

    def _vcycle(self, i: int, k, dk, b):
        lev = self.levels[i]
        if i == len(self.levels) - 1:
            return self._chebyshev(lev, dk[i], k, b, torch.zeros_like(b),
                                   COARSE_SWEEPS)
        x = self._chebyshev(lev, dk[i], k, b, torch.zeros_like(b), NU)
        r = b - lev.op.apply_A(x, k)
        xc = self._vcycle(i + 1, k, dk, self._restrict(i, r))
        x = x + self._prolong(i, xc)
        return self._chebyshev(lev, dk[i], k, b, x, NU)

    def launches_per_vcycle(self) -> int:
        """The operator applies (H1 kernel "A" launches on the card) of one
        V-cycle: 2ν + 1 on each level above the coarsest (smoothing before
        and after, the residual), ``COARSE_SWEEPS`` on the coarsest."""
        return (len(self.levels) - 1) * (2 * NU + 1) + COARSE_SWEEPS

    def precond(self, k) -> Callable:
        """The V-cycle preconditioner W = V(k) R on blocks (rows,
        *dof_shape), or on k-batched blocks (nk, rows, *dof_shape) for a
        k table (nk, d); the levels' diagonals at k ((nk, 1, *N) for a
        table) are formed once here."""
        dk = [torch.clamp(lv.op.diag_A(k), min=1e-30) for lv in self.levels]
        if np.ndim(k) == 2:
            dk = [d.unsqueeze(1) for d in dk]

        def apply(R):
            return self._vcycle(0, k, dk, R.to(self.levels[0].op.dtype))
        return apply
