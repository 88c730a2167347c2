"""Periodic tensor-product H1 (continuous nodal) finite element space.

SURVEY.md App. C.1: closed (GLL-Lagrange) basis in every direction on the
periodic n_1 x ... x n_d grid — exactly (n_i p)_i dofs per direction, no
constrained/slave dofs. Reference equivalent: MFEM ``H1_FECollection`` +
periodic ``FiniteElementSpace`` (SURVEY.md §2.2 #8).

Port of ``bravais_tpu/spaces/h1.py``: the host metadata, tables and
quadrature, copied verbatim; the device element gather/scatter is in
``spaces/tensor.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.spaces.basis1d import Basis1D, make_closed_basis

__all__ = ["H1Space"]


@dataclasses.dataclass(frozen=True)
class H1Space:
    """Scalar H1 space of order ``p`` with ``q``-point Gauss quadrature."""

    grid: PeriodicGrid
    p: int
    basis: Basis1D

    @classmethod
    def make(cls, grid: PeriodicGrid, p: int, q: int | None = None
             ) -> "H1Space":
        q = q if q is not None else p + 2  # safe default (App. C.1)
        return cls(grid=grid, p=p, basis=make_closed_basis(p, q))

    @property
    def dim(self) -> int:
        return self.grid.dim

    @property
    def q(self) -> int:
        return len(self.basis.qpts)

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        return tuple(n * self.p for n in self.grid.shape)

    @property
    def ndofs(self) -> int:
        return int(np.prod(self.dof_shape))

    @property
    def qpt_shape(self) -> Tuple[int, ...]:
        """Interleaved (n_1, q, ..., n_d, q) quadrature-array shape."""
        out = []
        for n in self.grid.shape:
            out.extend([n, self.q])
        return tuple(out)

    # -- host-side helpers --------------------------------------------------
    def qpoints_phys(self) -> np.ndarray:
        """Physical coordinates of all quadrature points,
        shape (n_1, q, ..., n_d, q, d)."""
        return self.grid.qpoints_phys([self.basis.qpts] * self.dim)

    def node_coords(self) -> np.ndarray:
        """Physical coordinates of the global dof nodes,
        shape (N_1, ..., N_d, d). Useful for initial guesses / plotting."""
        g = self.grid
        fr = []
        for i, n in enumerate(g.shape):
            e = np.arange(n)[:, None]
            # Drop each element's last (shared) node -> N_i = n*p entries.
            f = ((e + self.basis.nodes[None, :-1]) / n).ravel()
            fr.append(f)
        mesh = np.meshgrid(*fr, indexing="ij")
        frac = np.stack(mesh, axis=-1)
        return frac @ g.lattice.A

    def quad_weight(self) -> np.ndarray:
        """Tensor-product quadrature weights times |det J|, shaped
        (1, q, 1, q, ...) so it broadcasts over the interleaved
        (element, qpt) axes of quadrature-space arrays."""
        w = np.array(1.0)
        for _ in range(self.dim):
            w = np.multiply.outer(w, self.basis.qwts)
        return (w * self.grid.detJ).reshape(
            tuple(x for _ in range(self.dim) for x in (1, self.q)))
