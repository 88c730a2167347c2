"""1D basis / quadrature tables for tensor-product FE spaces.

The building blocks of SURVEY.md App. C.1: per reference element [0, 1],

* the **closed** basis — p+1 Gauss–Lobatto–Legendre (GLL) node Lagrange
  polynomials of degree p (C0-continuous across elements; used by H1 and
  by the tangentially-continuous directions of Nédélec elements);
* the **open** basis — p Gauss node Lagrange polynomials of degree p−1
  (discontinuous across elements; the normal directions of Nédélec).

Everything here is one-time host-side setup (NumPy float64); the tables
are later cast to the compute dtype and closed over by jitted applies.

Reference equivalent: MFEM ``H1_FECollection`` / ``ND_FECollection``
shape-function tables (SURVEY.md §2.2 #8).

Copied verbatim from ``bravais_tpu/spaces/basis1d.py`` (pure NumPy) so the
PyTorch port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["gll_nodes", "gauss_nodes", "lagrange_eval", "Basis1D",
           "make_closed_basis", "make_open_basis"]


def gll_nodes(p: int) -> np.ndarray:
    """p+1 Gauss–Lobatto–Legendre nodes on [0, 1] (degree-p closed basis)."""
    if p == 0:
        raise ValueError("closed basis requires p >= 1")
    if p == 1:
        x = np.array([-1.0, 1.0])
    else:
        # Interior GLL nodes are the roots of P_p'(x) on (-1, 1).
        leg = np.polynomial.legendre.Legendre.basis(p)
        interior = np.sort(leg.deriv().roots())
        x = np.concatenate([[-1.0], interior, [1.0]])
    return 0.5 * (x + 1.0)


def gauss_nodes(q: int) -> tuple[np.ndarray, np.ndarray]:
    """q-point Gauss–Legendre nodes and weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(q)
    return 0.5 * (x + 1.0), 0.5 * w


def lagrange_eval(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray,
                                                             np.ndarray]:
    """Values and derivatives of the Lagrange basis on ``nodes`` at ``x``.

    Returns (B, D) with ``B[i, j] = phi_j(x_i)``, ``D[i, j] = phi_j'(x_i)``.
    Barycentric formulation — stable for the orders used here (p <= 8).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = nodes.size
    # Barycentric weights.
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    wb = 1.0 / np.prod(diff, axis=1)

    B = np.empty((x.size, n))
    D = np.empty((x.size, n))
    for i, xi in enumerate(x):
        d = xi - nodes
        hit = np.isclose(d, 0.0, atol=1e-14)
        if hit.any():
            j = int(np.argmax(hit))
            B[i] = 0.0
            B[i, j] = 1.0
            # phi_m'(x_j) = (w_m / w_j) / (x_j - x_m); phi_j' = -sum others.
            with np.errstate(divide="ignore", invalid="ignore"):
                dj = (wb / wb[j]) / d
            dj[j] = 0.0
            dj[j] = -np.sum(dj)
            D[i] = dj
        else:
            t = wb / d
            s = np.sum(t)
            B[i] = t / s
            # derivative of barycentric interpolant of each basis function
            t2 = wb / d ** 2
            s2 = np.sum(t2)
            # phi_j'(x) = (B_j * s2 - t2_j) / s  ... derived from
            # phi_j = t_j / s, t_j' = -t2_j, s' = -s2.
            D[i] = (B[i] * s2 - t2) / s
    return B, D


@dataclasses.dataclass(frozen=True)
class Basis1D:
    """Tabulated 1D basis at quadrature points.

    B[q, j] = phi_j(x_q), D[q, j] = phi_j'(x_q) on the reference [0, 1].
    """

    p: int            # polynomial degree
    ndof: int         # dofs per element (p+1 closed, p open)
    closed: bool
    nodes: np.ndarray  # (ndof,)
    qpts: np.ndarray   # (q,)
    qwts: np.ndarray   # (q,)
    B: np.ndarray      # (q, ndof)
    D: np.ndarray      # (q, ndof)


def make_closed_basis(p: int, q: int) -> Basis1D:
    nodes = gll_nodes(p)
    x, w = gauss_nodes(q)
    B, D = lagrange_eval(nodes, x)
    return Basis1D(p=p, ndof=p + 1, closed=True, nodes=nodes, qpts=x,
                   qwts=w, B=B, D=D)


def make_open_basis(p: int, q: int) -> Basis1D:
    """Open (discontinuous) basis: p Gauss nodes, degree p-1."""
    nodes, _ = gauss_nodes(p)
    x, w = gauss_nodes(q)
    B, D = lagrange_eval(nodes, x)
    return Basis1D(p=p, ndof=p, closed=False, nodes=nodes, qpts=x, qwts=w,
                   B=B, D=D)
