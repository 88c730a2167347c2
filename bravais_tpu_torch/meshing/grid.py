"""Periodic structured meshes of the primitive cell.

The rebuild's equivalent of mfem-bravais' unit-cell / periodic mesh
generation (SURVEY.md §2.1 #2, §3.2): instead of an unstructured hex/tet
mesh plus ``CreatePeriodicVertexMapping``, the primitive *parallelepiped*
spanned by a_1..a_d is meshed by a logically-rectangular n_1 x .. x n_d
grid, periodic by index arithmetic. Every element shares ONE affine
Jacobian, so the whole geometry reduces to a handful of constant d x d
matrices — the key structural win for the TPU rebuild (SURVEY.md §7.0).

Wigner–Seitz cells (the reference's ``GetWignerSeitzMesh`` option) are
deliberately NOT meshed: any primitive cell tiles the lattice, and the
Bloch spectra are identical for every choice of fundamental domain —
the parallelepiped keeps the mesh logically rectangular. Geometry that
the reference expresses through the WS cell boundary is expressed here
through coefficients sampled at quadrature points (ε(x) with the
periodic-nearest-image distance, operators/coefficients.py).

Copied verbatim from ``bravais_tpu/meshing/grid.py`` (pure NumPy) so the
PyTorch port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from bravais_tpu_torch.lattices import Lattice

__all__ = ["PeriodicGrid"]


@dataclasses.dataclass(frozen=True)
class PeriodicGrid:
    """A periodic structured grid on the primitive cell of ``lattice``.

    Attributes
    ----------
    lattice : the Bravais lattice
    shape   : elements per primitive direction, (n_1, ..., n_d)
    J       : (d, d) constant element Jacobian, columns a_i / n_i
              (maps reference [0,1]^d to a physical element)
    detJ    : |det J| (element volume)
    Jinv    : J^{-1}
    Ginv    : J^{-1} J^{-T} — the metric used to pull gradients back:
              grad_x u . grad_x v = (ghat_u)^T Ginv ghat_v
    """

    lattice: Lattice
    shape: Tuple[int, ...]
    J: np.ndarray
    detJ: float
    Jinv: np.ndarray
    Ginv: np.ndarray

    @classmethod
    def make(cls, lattice: Lattice, shape) -> "PeriodicGrid":
        if isinstance(shape, int):
            shape = (shape,) * lattice.dim
        shape = tuple(int(n) for n in shape)
        if len(shape) != lattice.dim:
            raise ValueError(f"shape {shape} does not match lattice dim "
                             f"{lattice.dim}")
        if any(n < 1 for n in shape):
            raise ValueError("need at least one element per direction")
        # Columns of J are the element edge vectors a_i / n_i.
        J = np.stack([lattice.A[i] / shape[i]
                      for i in range(lattice.dim)], axis=1)
        detJ = float(abs(np.linalg.det(J)))
        Jinv = np.linalg.inv(J)
        return cls(lattice=lattice, shape=shape, J=J, detJ=detJ, Jinv=Jinv,
                   Ginv=Jinv @ Jinv.T)

    def stencil_twin(self, m: int = 3) -> "PeriodicGrid":
        """A grid with ``m`` elements per axis and the SAME element
        Jacobian as this one (twin lattice a'_i = m·a_i/n_i, so
        a'_i/m = a_i/n_i).

        A k=0 unit-dof probe's response is supported on the adjacent
        elements only, so FastDiag stencil extraction on this twin
        yields the production grid's S_δ blocks EXACTLY (same element
        geometry, same 1D tables, element-invariant coefficients) at
        O((m/n)^d) the per-probe cost — the cold-start host setup drops
        from minutes to seconds at production sizes
        (fastdiag.extract_stencil; gated by
        tests/test_fastdiag.py stencil-twin parity)."""
        lat = self.lattice
        A2 = np.stack([lat.A[i] * (float(m) / self.shape[i])
                       for i in range(self.dim)])
        lat2 = dataclasses.replace(
            lat, A=A2, B=2.0 * np.pi * np.linalg.inv(A2).T)
        return PeriodicGrid.make(lat2, (m,) * self.dim)

    @property
    def dim(self) -> int:
        return self.lattice.dim

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape))

    def qpoints_phys(self, qpts_1d: Sequence[np.ndarray]) -> np.ndarray:
        """Physical coordinates of all quadrature points.

        ``qpts_1d`` is a length-d list of 1D reference qpoint arrays.
        Returns shape ``(n_1, q_1, ..., n_d, q_d, d)`` — interleaved
        (element, qpt) axes, matching the layout used by the operator
        applies. Used once per run to sample coefficients eps(x), etc.
        """
        d = self.dim
        fracs = []  # fractional coordinate along each primitive direction
        for i in range(d):
            e = np.arange(self.shape[i])[:, None]
            fr = (e + np.asarray(qpts_1d[i])[None, :]) / self.shape[i]
            fracs.append(fr)  # (n_i, q_i)
        grids = np.meshgrid(*[f.ravel() for f in fracs], indexing="ij")
        frac = np.stack(grids, axis=-1)  # (n1*q1, ..., nd*qd, d)
        x = frac @ self.lattice.A  # sum_i frac_i * a_i
        shp = []
        for i in range(d):
            shp.extend([self.shape[i], len(np.asarray(qpts_1d[i]))])
        return x.reshape(*shp, d)
