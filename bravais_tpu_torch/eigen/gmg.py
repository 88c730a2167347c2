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

``QPGMG`` is the quasi-periodic variant (the reference's ``QPGMG``): the
same hierarchy on ``QPLaplace`` levels (the Maxwell deflation operator
L = Gᴴ M_ε G at the fine level), transfers that carry the Bloch wrap
phases, and an exact coarsest solve in place of the coarse sweeps.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch

from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.operators.qplaplace import QPLaplace
from bravais_tpu_torch.spaces import tensor
from bravais_tpu_torch.spaces.basis1d import lagrange_eval
from bravais_tpu_torch.spaces.h1 import H1Space

__all__ = ["GMG", "QPGMG"]

NU = 3              # Chebyshev sweeps before and after the coarse solve
COARSE_SWEEPS = 8   # Chebyshev sweeps on the coarsest level
MIN_COARSE = 2      # the coarsest grid has at least this many elements/axis


def _prolong_table(fine_nodes: np.ndarray) -> np.ndarray:
    """(n_fine_local, 2): p=1 hat values at the fine element-local nodes
    (the last, shared node dropped)."""
    B, _ = lagrange_eval(np.array([0.0, 1.0]), fine_nodes[:-1])
    return B


def _level_spaces(space: H1Space) -> list:
    """The hierarchy's spaces: ``space``, then (n, 1) if p > 1, then
    (n/2, 1), ... while every n is even and n/2 ≥ ``MIN_COARSE``; the
    coarse levels with q = max(p + 2, 3)."""
    lat = space.grid.lattice
    specs = []
    if space.p > 1:
        specs.append((space.grid.shape, 1))
    n = np.asarray(space.grid.shape)
    while np.all(n % 2 == 0) and np.all(n // 2 >= MIN_COARSE):
        n = n // 2
        specs.append((tuple(int(x) for x in n), 1))
    return [space] + [H1Space.make(PeriodicGrid.make(lat, shape), p,
                                   max(p + 2, 3)) for shape, p in specs]


class _Level:
    def __init__(self, op, lmax: float):
        self.op = op
        self.lmax = lmax
        # The working real precision as a numpy scalar type (the
        # Chebyshev scalars are computed in it).
        self.rt = torch.empty((), dtype=op.rdtype).numpy().dtype.type


class GMG:
    """V-cycle preconditioner factory for an ``H1Space`` Bloch operator:
    ``GMG(fine_op).precond(k)`` is the block preconditioner at k. The
    coarse levels resample ``fine_op``'s coefficients (scalars or
    callables), in its dtype and on its device."""

    def __init__(self, fine_op: BlochHelmholtz):
        self._init_levels([fine_op] + [
            BlochHelmholtz(sp, alpha=fine_op.alpha, beta=fine_op.beta,
                           dtype=fine_op.dtype, device=fine_op.device)
            for sp in _level_spaces(fine_op.space)[1:]])

    def _init_levels(self, ops: list) -> None:
        """The levels (each with its λmax bound) and the transfer tables,
        level i → i+1 (restriction is the transpose): (fine locals per
        coarse element, 2), on the device in the complex working dtype."""
        self.levels: List[_Level] = [_Level(op, self._lmax_host(op))
                                     for op in ops]
        self._ptabs = []
        op0 = ops[0]
        for i in range(len(ops) - 1):
            fine, coarse = ops[i].space, ops[i + 1].space
            if fine.grid.shape == coarse.grid.shape:   # p → 1
                tab = _prolong_table(fine.basis.nodes)
            else:                                       # h → h/2 (p = 1)
                tab = _prolong_table(np.array([0.0, 0.5, 1.0]))
            self._ptabs.append(torch.as_tensor(tab, device=op0.device).to(
                op0.rdtype).to(op0.dtype))

    @staticmethod
    def _lmax_host(op) -> float:
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

    # -- the hooks QPGMG overrides --------------------------------------------

    def _apply(self, lev: _Level, x: torch.Tensor, k) -> torch.Tensor:
        """The level operator at k (here a k or a k table)."""
        return lev.op.apply_A(x, k)

    def _phases(self, k) -> list:
        """The transfers' wrap phase per axis (None: periodic)."""
        return [None] * self.levels[0].op.space.dim

    def _coarse_solve(self, lev: _Level, k, d, b):
        """The coarsest level: ``COARSE_SWEEPS`` Chebyshev sweeps."""
        return self._chebyshev(lev, d, k, b, torch.zeros_like(b),
                               COARSE_SWEEPS)

    # -- transfers (blocks with a leading row axis) -------------------------

    def _prolong(self, i: int, u: torch.Tensor, k=None) -> torch.Tensor:
        """coarse level i+1 → fine level i (values: assign semantics)."""
        coarse = self.levels[i + 1].op.space
        d = coarse.dim
        if u.ndim == d + 2:                 # k-batched: fold k into rows
            return self._prolong(i, u.flatten(0, 1), k).unflatten(
                0, u.shape[:2])
        tab = self._ptabs[i]
        nf = tab.shape[0]
        n = coarse.grid.shape
        ue = tensor.gather_qp(u, n, (coarse.p,) * d, (True,) * d,
                              self._phases(k))
        perm = [0] + [1 + 2 * j for j in range(d)] + [2 + 2 * j
                                                      for j in range(d)]
        ue = tensor.contract(ue.permute(perm), [tab] * d)  # (R, n.., nf..)
        inv = [0] + [x for j in range(d) for x in (1 + j, 1 + d + j)]
        # The locals are the element's fine nodes with the shared node
        # dropped, so a reshape reassembles the fine global array.
        return ue.permute(inv).reshape((u.shape[0],)
                                       + tuple(m * nf for m in n))

    def _restrict(self, i: int, r: torch.Tensor, k=None) -> torch.Tensor:
        """fine level i → coarse level i+1 (residuals: the adjoint)."""
        coarse = self.levels[i + 1].op.space
        d = coarse.dim
        if r.ndim == d + 2:                 # k-batched: fold k into rows
            return self._restrict(i, r.flatten(0, 1), k).unflatten(
                0, r.shape[:2])
        tab = self._ptabs[i]
        nf = tab.shape[0]
        n = coarse.grid.shape
        r = r.reshape((r.shape[0],) + tuple(x for m in n for x in (m, nf)))
        perm = [0] + [1 + 2 * j for j in range(d)] + [2 + 2 * j
                                                      for j in range(d)]
        r = tensor.contract_t(r.permute(perm), [tab] * d)  # (R, n.., 2..)
        inv = [0] + [x for j in range(d) for x in (1 + j, 1 + d + j)]
        return tensor.scatter_add_qp(r.permute(inv), n, (coarse.p,) * d,
                                     (True,) * d, self._phases(k))

    # -- smoother and V-cycle -------------------------------------------------

    def _chebyshev(self, lev: _Level, d, k, b, x, nu: int):
        """x ← x + p(D⁻¹A)(b − A x), Chebyshev on [λmax/15, λmax] (D the
        level's clamped diagonal ``d``); the scalars in the working
        precision."""
        rt = lev.rt
        lmax = rt(lev.lmax)
        lo = lmax / rt(15.0)
        theta = rt(0.5) * (lmax + lo)
        delta = rt(0.5) * (lmax - lo)
        sigma1 = theta / delta

        r = (b - self._apply(lev, x, k)) / d
        dx = r / float(theta)
        x = x + dx
        rho_old = rt(1.0) / sigma1
        for _ in range(nu - 1):
            r = r - self._apply(lev, dx, k) / d
            rho = rt(1.0) / (rt(2.0) * sigma1 - rho_old)
            dx = float(rho * rho_old) * dx + float(rt(2.0) * rho / delta) * r
            x = x + dx
            rho_old = rho
        return x

    def _vcycle(self, i: int, k, dk, b):
        lev = self.levels[i]
        if i == len(self.levels) - 1:
            return self._coarse_solve(lev, k, dk[i], b)
        x = self._chebyshev(lev, dk[i], k, b, torch.zeros_like(b), NU)
        r = b - self._apply(lev, x, k)
        xc = self._vcycle(i + 1, k, dk, self._restrict(i, r, k))
        x = x + self._prolong(i, xc, k)
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


class _QPState(NamedTuple):
    """What a ``QPGMG`` V-cycle needs at one k or a k table, formed once:
    the phases ((d,) or (nk, d)), the same per axis (scalars or (nk,)
    vectors, as the transfers take them) and the LU factors of the
    coarsest matrix ((N, N) or (nk, N, N))."""
    ph: torch.Tensor
    axes: list
    lu: tuple


class QPGMG(GMG):
    """Multigrid for the QUASI-PERIODIC scalar Laplacian Λ φ =
    −∇·(α∇φ) + shift·βφ (``QPLaplace``; with α = ε it is the Maxwell
    deflation operator L = Gᴴ M_ε G). Port of the reference's ``QPGMG``:
    the ``GMG`` hierarchy and smoothers on ``QPLaplace`` levels, whose
    applies are the h1 kernel at k = 0 with the Bloch phases in the
    gather; transfers that carry the same wrap phases; and an exact
    coarsest solve (``_coarse_lu``).

    ``solver(k)`` forms the phases, the diagonals and the coarse factors
    at one k (d,) or a k table (nk, d) once, and returns ``solve(b,
    cycles=3)`` for blocks (rows, *N) or (nk, rows, *N): Richardson plus
    V-cycles, x ≈ Λ⁻¹ b. ``solve(k, b, cycles)`` is the reference's
    one-call form."""

    def __init__(self, space: H1Space, alpha=1.0, beta=1.0,
                 shift: float = 0.0, dtype=torch.complex64, device="cuda"):
        self._init_levels([QPLaplace(sp, alpha=alpha, beta=beta,
                                     shift=shift, dtype=dtype, device=device)
                           for sp in _level_spaces(space)])
        # |phases| = 1: the diagonals do not depend on k.
        self._diags = [torch.as_tensor(lv.op.diag0, device=lv.op.device).to(
            lv.op.rdtype) for lv in self.levels]

    def _apply(self, lev: _Level, x: torch.Tensor, st: _QPState):
        return lev.op.apply_A(x, ph=st.ph)

    def _phases(self, st: _QPState) -> list:
        return st.axes

    def _coarse_lu(self, ph: torch.Tensor) -> tuple:
        """LU factors of the coarsest matrix at the phases ``ph``, the
        level's operator applied to its N identity columns (one h1 launch
        on N rows, nk·N for a table) with the Tikhonov guard (1e-7·tr/N in
        float32, 1e-12·tr/N in float64) for the exactly singular Γ case,
        whose spurious constant component G does not see. Chebyshev
        smoothing never reaches modes below λmax/15, so the near-null
        constant near Γ, the mode the gradient deflation must resolve,
        only this exact solve reaches."""
        op = self.levels[-1].op
        shape = tuple(op.space.dof_shape)
        N = int(np.prod(shape))
        eye = torch.eye(N, dtype=op.dtype, device=op.device)
        cols = eye.reshape((N,) + shape)
        if ph.ndim == 2:
            cols = cols.expand((ph.shape[0],) + cols.shape)
        Ac = op.apply_A(cols, ph=ph).reshape(cols.shape[:-len(shape)]
                                             + (N,)).mT   # columns A e_j
        tr = torch.diagonal(Ac, dim1=-2, dim2=-1).real.sum(-1) / N
        guard = 1e-7 if op.rdtype == torch.float32 else 1e-12
        Ac = Ac + (guard * tr)[..., None, None] * eye
        return torch.linalg.lu_factor(Ac)

    def _coarse_solve(self, lev: _Level, st: _QPState, d, b):
        """The exact coarsest solve: the LU factors of ``_coarse_lu`` (what
        the reference's ``jnp.linalg.solve`` does in one call, factored
        once per k here), every row of ``b`` a right-hand side."""
        lead = b.shape[:b.ndim - lev.op.space.dim]
        rhs = b.reshape(lead + (-1,)).mT                  # (..., N, rows)
        return torch.linalg.lu_solve(*st.lu, rhs).mT.reshape(b.shape)

    def launches_per_vcycle(self) -> int:
        """h1 launches of one V-cycle: 2ν + 1 on each level above the
        coarsest, none for the exact coarse solve."""
        return (len(self.levels) - 1) * (2 * NU + 1)

    def launches_per_solve(self, cycles: int = 3) -> int:
        """h1 launches of one ``solve`` of ``cycles`` V-cycles (each
        Richardson step adds one residual apply); forming a solver adds
        one more, the coarse assembly."""
        return cycles * self.launches_per_vcycle() + cycles - 1

    def solver(self, k) -> Callable:
        """``solve(b, cycles=3)`` at one k (d,) or a k table (nk, d), the
        phases, diagonals and coarse factors formed here once."""
        ph = self.levels[0].op.phases(k)
        st = _QPState(ph, [ph[..., i] for i in range(ph.shape[-1])],
                      self._coarse_lu(ph))
        lev0 = self.levels[0]

        def solve(b: torch.Tensor, cycles: int = 3) -> torch.Tensor:
            b = b.to(lev0.op.dtype)
            x = self._vcycle(0, st, self._diags, b)
            for _ in range(cycles - 1):
                x = x + self._vcycle(0, st, self._diags,
                                     b - self._apply(lev0, x, st))
            return x
        return solve

    def solve(self, k, b: torch.Tensor, cycles: int = 3) -> torch.Tensor:
        """Approximate Λ⁻¹ b by ``cycles`` Richardson + V-cycle steps."""
        return self.solver(k)(b, cycles)
