"""Periodic tensor-product Nédélec (first kind, hex) H(curl) space.

SURVEY.md App. C.1: component c lives in
open_c ⊗ closed_{others}:  E_x ∈ Q_{p-1,p,p}, E_y ∈ Q_{p,p-1,p},
E_z ∈ Q_{p,p,p-1} — tangential continuity is exactly the closed-direction
node sharing, and on the periodic grid every component has the SAME
global dof shape (n_1 p, n_2 p, n_3 p): clean stacked arrays, no
orientation flips (the structured-grid win over general meshes).

Fields are stored as (3, N_1, N_2, N_3) complex arrays.

Also provides the 1D blocks of the Bloch discrete gradient
G_k = ∇ + i k ⊙ Π  (App. C.1 / C.3): per element, ``Dnode`` maps closed
nodal coefficients to the open coefficients of the exact derivative
(degree p-1 interpolated at its own Gauss nodes — exact), and ``Inode``
interpolates closed (degree p) values onto the open nodes.

Port of ``bravais_tpu/spaces/nedelec.py``: the host metadata, tables and
quadrature, copied verbatim; the device element gather/scatter is in
``spaces/tensor.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.spaces.basis1d import (Basis1D, lagrange_eval,
                                        make_closed_basis, make_open_basis)

__all__ = ["NedelecSpace"]


@dataclasses.dataclass(frozen=True)
class NedelecSpace:
    grid: PeriodicGrid
    p: int
    closed: Basis1D   # degree p, p+1 GLL nodes
    open: Basis1D     # degree p-1, p Gauss nodes
    Dnode: np.ndarray  # (p, p+1): d/dx of closed basis at open nodes
    Inode: np.ndarray  # (p, p+1): closed basis values at open nodes

    @classmethod
    def make(cls, grid: PeriodicGrid, p: int, q: int | None = None
             ) -> "NedelecSpace":
        if grid.dim != 3:
            raise ValueError("NedelecSpace is 3D (2D Maxwell reduces to "
                             "scalar TM/TE on H1 — SURVEY.md App. B.1)")
        q = q if q is not None else p + 2
        closed = make_closed_basis(p, q)
        topen = make_open_basis(p, q)
        Inode, Dnode = lagrange_eval(closed.nodes, topen.nodes)
        return cls(grid=grid, p=p, closed=closed, open=topen,
                   Dnode=Dnode, Inode=Inode)

    @property
    def dim(self) -> int:
        return 3

    @property
    def q(self) -> int:
        return len(self.closed.qpts)

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        """Per-component global shape; full field is (3, *dof_shape)."""
        return tuple(n * self.p for n in self.grid.shape)

    @property
    def field_shape(self) -> Tuple[int, ...]:
        return (3,) + self.dof_shape

    @property
    def ndofs(self) -> int:
        return 3 * int(np.prod(self.dof_shape))

    def flags(self, c: int) -> Tuple[bool, bool, bool]:
        """closed-direction flags for component c (open in dim c)."""
        return tuple(i != c for i in range(3))

    # value/derivative tables at quadrature points for component c ----------
    def value_tables(self, c: int) -> List[np.ndarray]:
        return [self.open.B if i == c else self.closed.B for i in range(3)]

    def deriv_tables(self, c: int, s: int) -> List[np.ndarray]:
        """Tables for ∂̂_s of component c at qpts (s != c for curl)."""
        out = []
        for i in range(3):
            if i == c:
                out.append(self.open.D if i == s else self.open.B)
            else:
                out.append(self.closed.D if i == s else self.closed.B)
        return out

    # -- host helpers --------------------------------------------------------
    def qpoints_phys(self) -> np.ndarray:
        return self.grid.qpoints_phys([self.closed.qpts] * 3)

    def quad_weight(self) -> np.ndarray:
        w = np.array(1.0)
        for _ in range(3):
            w = np.multiply.outer(w, self.closed.qwts)
        return (w * self.grid.detJ).reshape(
            tuple(x for _ in range(3) for x in (1, self.q)))
