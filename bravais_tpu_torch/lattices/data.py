"""Bravais lattice registry: primitive vectors, reciprocal vectors,
Setyawan–Curtarolo high-symmetry points and paths.

Covers all 14 3D Bravais lattices with their S&C parameter-dependent
variants (BCT1/2, ORCF1/2/3, RHL1/2, MCLC1–5, TRI1a/1b/2a/2b) plus the
5 2D lattices (square, rectangular, centered-rectangular, hexagonal,
oblique).

Reference equivalent: the ``BravaisLattice`` class hierarchy of
mfem-bravais (SURVEY.md §2.1 #1; primitive-vector table SURVEY.md App. A).
Symmetry-point conventions: W. Setyawan, S. Curtarolo, Comp. Mater. Sci.
49 (2010) 299 — fractional coordinates are w.r.t. the *reciprocal
primitive* basis (k_cart = sum_i f_i b_i).

This is pure host-side data (NumPy float64), mirroring its role in the
reference (serial C++ setup code); nothing here touches the device.

For MCLC variants the S&C point tables involve parameter-dependent
fractions that could not be verified in this offline environment; per
SURVEY.md App. A's sanctioned fallback these lattices use a generic
fractional-coordinate path (correctness of every eigensolve is unaffected
— any k in the BZ is a valid, oracle-checkable problem; only path labels
deviate). They are flagged with ``generic_path=True``.

Copied verbatim from ``bravais_tpu/lattices/data.py`` (pure NumPy) so the
PyTorch port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Lattice", "make_lattice", "LATTICE_NAMES", "LATTICE_NAMES_2D"]

# 3D lattice family names (canonical S&C abbreviations, lowercase accepted).
LATTICE_NAMES = [
    "CUB", "FCC", "BCC", "TET", "BCT", "ORC", "ORCF", "ORCI", "ORCC",
    "HEX", "RHL", "MCL", "MCLC", "TRI",
]
LATTICE_NAMES_2D = ["SQR", "RECT", "CRECT", "HEX2D", "OBL"]

_ALIASES = {
    "CUBIC": "CUB", "SC": "CUB", "SIMPLE_CUBIC": "CUB",
    "FACE_CENTERED_CUBIC": "FCC", "BODY_CENTERED_CUBIC": "BCC",
    "TETRAGONAL": "TET", "BODY_CENTERED_TETRAGONAL": "BCT",
    "ORTHORHOMBIC": "ORC", "HEXAGONAL": "HEX", "RHOMBOHEDRAL": "RHL",
    "MONOCLINIC": "MCL", "TRICLINIC": "TRI",
    "SQUARE": "SQR", "RECTANGULAR": "RECT",
    "CENTERED_RECTANGULAR": "CRECT", "HEXAGONAL_2D": "HEX2D",
    "HEX_2D": "HEX2D", "OBLIQUE": "OBL",
}


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A Bravais lattice with its symmetry-point data.

    Attributes
    ----------
    name          : family name ("FCC", "SQR", ...)
    variant       : S&C variant label ("BCT1", "ORCF3", ... or == name)
    dim           : 2 or 3
    A             : (dim, dim) primitive vectors as ROWS (a_i = A[i])
    B             : (dim, dim) reciprocal vectors as ROWS, b_i . a_j = 2 pi delta_ij
    points        : label -> fractional coords in the reciprocal basis
    path          : list of connected subpaths, each a list of labels
    params        : the conventional-cell parameters used to build it
    generic_path  : True when the S&C table for this variant was not
                    encodable offline and a generic fractional path is used
                    (SURVEY.md App. A fallback)
    """

    name: str
    variant: str
    dim: int
    A: np.ndarray
    B: np.ndarray
    points: Dict[str, np.ndarray]
    path: List[List[str]]
    params: Dict[str, float]
    generic_path: bool = False

    def k_cart(self, frac) -> np.ndarray:
        """Fractional (reciprocal-basis) -> Cartesian k. Accepts (..., dim)."""
        return np.asarray(frac, dtype=np.float64) @ self.B

    def point_cart(self, label: str) -> np.ndarray:
        return self.k_cart(self.points[label])

    @property
    def cell_volume(self) -> float:
        return float(abs(np.linalg.det(self.A)))

    def __repr__(self) -> str:  # keep dataclass arrays out of logs
        return (f"Lattice({self.variant}, dim={self.dim}, "
                f"points={list(self.points)})")


def _reciprocal(A: np.ndarray) -> np.ndarray:
    """Rows b_i with b_i . a_j = 2 pi delta_ij (SURVEY.md App. A)."""
    return 2.0 * np.pi * np.linalg.inv(A).T


def _pts(d: Dict[str, Sequence[float]]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, dtype=np.float64) for k, v in d.items()}


def _generic_path_3d() -> Tuple[Dict[str, np.ndarray], List[List[str]]]:
    """SURVEY.md App. A fallback path: Γ → b1/2 → (b1+b2)/2 → (b1+b2+b3)/2 → Γ."""
    pts = _pts({
        "G": (0, 0, 0),
        "Q1": (0.5, 0, 0),
        "Q2": (0.5, 0.5, 0),
        "Q3": (0.5, 0.5, 0.5),
    })
    return pts, [["G", "Q1", "Q2", "Q3", "G"]]


# ---------------------------------------------------------------------------
# 3D lattice constructors. Each returns (A, points, path, variant, generic).
# Primitive-vector table: SURVEY.md App. A (standard crystallography).
# ---------------------------------------------------------------------------

def _cub(a, b, c, al, be, ga):
    A = np.diag([a, a, a]).astype(np.float64)
    pts = _pts({"G": (0, 0, 0), "X": (0, 0.5, 0), "M": (0.5, 0.5, 0),
                "R": (0.5, 0.5, 0.5)})
    path = [["G", "X", "M", "G", "R", "X"], ["M", "R"]]
    return A, pts, path, "CUB", False


def _fcc(a, b, c, al, be, ga):
    A = np.array([[0, a / 2, a / 2], [a / 2, 0, a / 2], [a / 2, a / 2, 0]])
    pts = _pts({
        "G": (0, 0, 0), "K": (3 / 8, 3 / 8, 3 / 4), "L": (0.5, 0.5, 0.5),
        "U": (5 / 8, 1 / 4, 5 / 8), "W": (0.5, 1 / 4, 3 / 4),
        "X": (0.5, 0, 0.5),
    })
    path = [["G", "X", "W", "K", "G", "L", "U", "W", "L", "K"], ["U", "X"]]
    return A, pts, path, "FCC", False


def _bcc(a, b, c, al, be, ga):
    A = np.array([[-a / 2, a / 2, a / 2], [a / 2, -a / 2, a / 2],
                  [a / 2, a / 2, -a / 2]])
    pts = _pts({"G": (0, 0, 0), "H": (0.5, -0.5, 0.5), "P": (0.25, 0.25, 0.25),
                "N": (0, 0, 0.5)})
    path = [["G", "H", "N", "G", "P", "H"], ["P", "N"]]
    return A, pts, path, "BCC", False


def _tet(a, b, c, al, be, ga):
    A = np.diag([a, a, c]).astype(np.float64)
    pts = _pts({"G": (0, 0, 0), "A": (0.5, 0.5, 0.5), "M": (0.5, 0.5, 0),
                "R": (0, 0.5, 0.5), "X": (0, 0.5, 0), "Z": (0, 0, 0.5)})
    path = [["G", "X", "M", "G", "Z", "R", "A", "Z"], ["X", "R"], ["M", "A"]]
    return A, pts, path, "TET", False


def _bct(a, b, c, al, be, ga):
    A = np.array([[-a / 2, a / 2, c / 2], [a / 2, -a / 2, c / 2],
                  [a / 2, a / 2, -c / 2]])
    if c < a:  # BCT1 (S&C dispatch: SURVEY.md App. A)
        eta = (1 + c * c / (a * a)) / 4
        pts = _pts({
            "G": (0, 0, 0), "M": (-0.5, 0.5, 0.5), "N": (0, 0.5, 0),
            "P": (0.25, 0.25, 0.25), "X": (0, 0, 0.5),
            "Z": (eta, eta, -eta), "Z1": (-eta, 1 - eta, eta),
        })
        path = [["G", "X", "M", "G", "Z", "P", "N", "Z1", "M"], ["X", "P"]]
        return A, pts, path, "BCT1", False
    eta = (1 + a * a / (c * c)) / 4
    zeta = a * a / (2 * c * c)
    pts = _pts({
        "G": (0, 0, 0), "N": (0, 0.5, 0), "P": (0.25, 0.25, 0.25),
        "S": (-eta, eta, eta), "S1": (eta, 1 - eta, -eta),
        "X": (0, 0, 0.5), "Y": (-zeta, zeta, 0.5), "Y1": (0.5, 0.5, -zeta),
        "Z": (0.5, 0.5, -0.5),
    })
    path = [["G", "X", "Y", "S", "G", "Z", "S1", "N", "P", "Y1", "Z"],
            ["X", "P"]]
    return A, pts, path, "BCT2", False


def _orc(a, b, c, al, be, ga):
    A = np.diag([a, b, c]).astype(np.float64)
    pts = _pts({
        "G": (0, 0, 0), "R": (0.5, 0.5, 0.5), "S": (0.5, 0.5, 0),
        "T": (0, 0.5, 0.5), "U": (0.5, 0, 0.5), "X": (0.5, 0, 0),
        "Y": (0, 0.5, 0), "Z": (0, 0, 0.5),
    })
    path = [["G", "X", "S", "Y", "G", "Z", "U", "R", "T", "Z"],
            ["Y", "T"], ["U", "X"], ["S", "R"]]
    return A, pts, path, "ORC", False


def _orcf(a, b, c, al, be, ga):
    A = np.array([[0, b / 2, c / 2], [a / 2, 0, c / 2], [a / 2, b / 2, 0]])
    ia, ib, ic = 1 / a ** 2, 1 / b ** 2, 1 / c ** 2
    if ia > ib + ic + 1e-12 or abs(ia - ib - ic) <= 1e-12:
        # ORCF1 (>) and ORCF3 (=) share the point table (S&C).
        zeta = (1 + a * a / (b * b) - a * a / (c * c)) / 4
        eta = (1 + a * a / (b * b) + a * a / (c * c)) / 4
        pts = _pts({
            "G": (0, 0, 0), "A": (0.5, 0.5 + zeta, zeta),
            "A1": (0.5, 0.5 - zeta, 1 - zeta), "L": (0.5, 0.5, 0.5),
            "T": (1, 0.5, 0.5), "X": (0, eta, eta),
            "X1": (1, 1 - eta, 1 - eta), "Y": (0.5, 0, 0.5),
            "Z": (0.5, 0.5, 0),
        })
        variant = "ORCF3" if abs(ia - ib - ic) <= 1e-12 else "ORCF1"
        path = [["G", "Y", "T", "Z", "G", "X", "A1", "Y"], ["T", "X1"],
                ["X", "A", "Z"], ["L", "G"]]
        if variant == "ORCF3":  # X1 coincides with X-like point; S&C drops it
            path = [["G", "Y", "T", "Z", "G", "X", "A1", "Y"],
                    ["X", "A", "Z"], ["L", "G"]]
        return A, pts, path, variant, False
    # ORCF2
    eta = (1 + a * a / (b * b) - a * a / (c * c)) / 4
    phi = (1 + c * c / (b * b) - c * c / (a * a)) / 4
    delta = (1 + b * b / (a * a) - b * b / (c * c)) / 4
    pts = _pts({
        "G": (0, 0, 0), "C": (0.5, 0.5 - eta, 1 - eta),
        "C1": (0.5, 0.5 + eta, eta), "D": (0.5 - delta, 0.5, 1 - delta),
        "D1": (0.5 + delta, 0.5, delta), "L": (0.5, 0.5, 0.5),
        "H": (1 - phi, 0.5 - phi, 0.5), "H1": (phi, 0.5 + phi, 0.5),
        "X": (0, 0.5, 0.5), "Y": (0.5, 0, 0.5), "Z": (0.5, 0.5, 0),
    })
    path = [["G", "Y", "C", "D", "X", "G", "Z", "D1", "H", "C"],
            ["C1", "Z"], ["X", "H1"], ["H", "Y"], ["L", "G"]]
    return A, pts, path, "ORCF2", False


def _orci(a, b, c, al, be, ga):
    A = np.array([[-a / 2, b / 2, c / 2], [a / 2, -b / 2, c / 2],
                  [a / 2, b / 2, -c / 2]])
    zeta = (1 + a * a / (c * c)) / 4
    eta = (1 + b * b / (c * c)) / 4
    delta = (b * b - a * a) / (4 * c * c)
    mu = (a * a + b * b) / (4 * c * c)
    pts = _pts({
        "G": (0, 0, 0), "L": (-mu, mu, 0.5 - delta),
        "L1": (mu, -mu, 0.5 + delta), "L2": (0.5 - delta, 0.5 + delta, -mu),
        "R": (0, 0.5, 0), "S": (0.5, 0, 0), "T": (0, 0, 0.5),
        "W": (0.25, 0.25, 0.25), "X": (-zeta, zeta, zeta),
        "X1": (zeta, 1 - zeta, -zeta), "Y": (eta, -eta, eta),
        "Y1": (1 - eta, eta, -eta), "Z": (0.5, 0.5, -0.5),
    })
    path = [["G", "X", "L", "T", "W", "R", "X1", "Z", "G", "Y", "S", "W"],
            ["L1", "Y"], ["Y1", "Z"]]
    return A, pts, path, "ORCI", False


def _orcc(a, b, c, al, be, ga):
    A = np.array([[a / 2, -b / 2, 0], [a / 2, b / 2, 0], [0, 0, c]])
    zeta = (1 + a * a / (b * b)) / 4
    pts = _pts({
        "G": (0, 0, 0), "A": (zeta, zeta, 0.5),
        "A1": (-zeta, 1 - zeta, 0.5), "R": (0, 0.5, 0.5), "S": (0, 0.5, 0),
        "T": (-0.5, 0.5, 0.5), "X": (zeta, zeta, 0),
        "X1": (-zeta, 1 - zeta, 0), "Y": (-0.5, 0.5, 0), "Z": (0, 0, 0.5),
    })
    path = [["G", "X", "S", "R", "A", "Z", "G", "Y", "X1", "A1", "T", "Y"],
            ["Z", "T"]]
    return A, pts, path, "ORCC", False


def _hex(a, b, c, al, be, ga):
    A = np.array([[a / 2, -a * np.sqrt(3) / 2, 0],
                  [a / 2, a * np.sqrt(3) / 2, 0], [0, 0, c]])
    pts = _pts({
        "G": (0, 0, 0), "A": (0, 0, 0.5), "H": (1 / 3, 1 / 3, 0.5),
        "K": (1 / 3, 1 / 3, 0), "L": (0.5, 0, 0.5), "M": (0.5, 0, 0),
    })
    path = [["G", "M", "K", "G", "A", "L", "H", "A"], ["L", "M"], ["K", "H"]]
    return A, pts, path, "HEX", False


def _rhl(a, b, c, al, be, ga):
    ca = np.cos(al)
    ch = np.cos(al / 2)
    sh = np.sin(al / 2)
    a3z = a * np.sqrt(max(1 - ca * ca / (ch * ch), 0.0))
    A = np.array([[a * ch, -a * sh, 0], [a * ch, a * sh, 0],
                  [a * ca / ch, 0, a3z]])
    if al < np.pi / 2:  # RHL1
        eta = (1 + 4 * ca) / (2 + 4 * ca)
        nu = 0.75 - eta / 2
        pts = _pts({
            "G": (0, 0, 0), "B": (eta, 0.5, 1 - eta),
            "B1": (0.5, 1 - eta, eta - 1), "F": (0.5, 0.5, 0),
            "L": (0.5, 0, 0), "L1": (0, 0, -0.5), "P": (eta, nu, nu),
            "P1": (1 - nu, 1 - nu, 1 - eta), "P2": (nu, nu, eta - 1),
            "Q": (1 - nu, nu, 0), "X": (nu, 0, -nu), "Z": (0.5, 0.5, 0.5),
        })
        path = [["G", "L", "B1"], ["B", "Z", "G", "X"],
                ["Q", "F", "P1", "Z"], ["L", "P"]]
        return A, pts, path, "RHL1", False
    # RHL2
    eta = 1 / (2 * np.tan(al / 2) ** 2)
    nu = 0.75 - eta / 2
    pts = _pts({
        "G": (0, 0, 0), "F": (0.5, -0.5, 0), "L": (0.5, 0, 0),
        "P": (1 - nu, -nu, 1 - nu), "P1": (nu, nu - 1, nu - 1),
        "Q": (eta, eta, eta), "Q1": (1 - eta, -eta, -eta),
        "Z": (0.5, -0.5, 0.5),
    })
    path = [["G", "P", "Z", "Q", "G", "F", "P1", "Q1", "L", "Z"]]
    return A, pts, path, "RHL2", False


def _reduce_oblique_plane(b, c, al, reduce_b):
    """Normalize a monoclinic oblique-plane basis {(b,0), (c·cosα, c·sinα)}
    into the S&C conventional regime: α < 90° and c·cosα ≤ b/2 (plus
    b ≤ c when ``reduce_b``). Returns (b, c, α) of a congruent lattice.

    Lattice-preserving moves only: c ← c − m·b_vec (skew reduction),
    c ← −c (inversion), swap b↔c (MCL only — both plane vectors are free
    primitive vectors; for MCLC b is welded to the C-centering), and a
    180° rotation about the axis normal to the plane (maps the in-plane
    component c_y → −c_y with the centering pattern onto itself), which
    turns the post-reduction obtuse case c_y ∈ [−b/2, 0) into the acute
    one WITHOUT a reflection. Without this step, strongly skewed or
    obtuse cells drove the S&C fraction formulas (η, ψ, …) out of [0,1]
    and forced the generic-path fallback (round-4 gap; SURVEY.md §2.1 #1).
    """
    v1 = np.array([b, 0.0])
    v2 = np.array([c * np.cos(al), c * np.sin(al)])
    for _ in range(64):
        m = np.rint(np.dot(v1, v2) / np.dot(v1, v1))
        v2 = v2 - m * v1
        if reduce_b and np.dot(v2, v2) < np.dot(v1, v1):
            v1, v2 = v2, v1
            continue
        if m == 0:
            break
    # Orient: v1 along +y (rotation within the plane), v2_z > 0
    # (take −v2 if needed), then v2_y ≥ 0 via the 180° rotation.
    b2 = float(np.linalg.norm(v1))
    c2 = float(np.linalg.norm(v2))
    cy = abs(float(np.dot(v1, v2))) / b2
    cz = abs(float(v1[0] * v2[1] - v1[1] * v2[0])) / b2
    return b2, c2, float(np.arctan2(cz, cy))


def _mcl(a, b, c, al, be, ga):
    # S&C MCL convention: unique axis with b <= c, alpha < 90 deg.
    # Arbitrary cells are first reduced into that regime (same lattice).
    b, c, al = _reduce_oblique_plane(b, c, al, reduce_b=True)
    A = np.array([[a, 0, 0], [0, b, 0],
                  [0, c * np.cos(al), c * np.sin(al)]])
    sa = np.sin(al)
    eta = (1 - b * np.cos(al) / c) / (2 * sa * sa)
    nu = 0.5 - eta * c * np.cos(al) / b
    pts = _pts({
        "G": (0, 0, 0), "A": (0.5, 0.5, 0), "C": (0, 0.5, 0.5),
        "D": (0.5, 0, 0.5), "D1": (0.5, 0, -0.5), "E": (0.5, 0.5, 0.5),
        "H": (0, eta, 1 - nu), "H1": (0, 1 - eta, nu), "H2": (0, eta, -nu),
        "M": (0.5, eta, 1 - nu), "M1": (0.5, 1 - eta, nu),
        "M2": (0.5, eta, -nu), "X": (0, 0.5, 0), "Y": (0, 0, 0.5),
        "Y1": (0, 0, -0.5), "Z": (0.5, 0, 0),
    })
    path = [["G", "Y", "H", "C", "E", "M1", "A", "X", "H1"],
            ["M", "D", "Z"], ["Y", "D"]]
    if not _path_on_bz(_reciprocal(A), pts, path):
        pts, path = _generic_path_3d()
        return A, pts, path, "MCL", True
    return A, pts, path, "MCL", False


def _path_on_bz(B: np.ndarray, pts: Dict[str, np.ndarray],
                path: List[List[str]], tol: float = 1e-7) -> bool:
    """True when every non-Γ path point lies ON the first-BZ boundary
    (Voronoi property of S&C symmetry points: |k| = min_G |k − G| with
    the minimum attained at some G ≠ 0). Used as a runtime validity
    guard for the parameter-dependent MCLC tables."""
    import itertools as _it
    Gs = np.array([m for m in _it.product(range(-2, 3), repeat=3)
                   if m != (0, 0, 0)], np.float64) @ B
    for lbl in {x for seg in path for x in seg}:
        k = pts[lbl] @ B
        r = np.linalg.norm(k)
        if r < tol:      # Γ
            continue
        dmin = np.min(np.linalg.norm(k - Gs[None], axis=-1))
        if abs(r - dmin) > tol * max(r, 1.0):
            return False
    return True


def _mclc(a, b, c, al, be, ga):
    # C-centered monoclinic, S&C convention (unique axis alpha).
    # b is welded to the C-centering, so only the c-axis is reduced
    # (skew mod b + orientation flips — same lattice, see
    # _reduce_oblique_plane).
    b, c, al = _reduce_oblique_plane(b, c, al, reduce_b=False)
    A = np.array([[a / 2, b / 2, 0], [-a / 2, b / 2, 0],
                  [0, c * np.cos(al), c * np.sin(al)]])
    B = _reciprocal(A)
    # Variant dispatch from the reciprocal angle kgamma (S&C):
    kga = np.arccos(B[0] @ B[1] / (np.linalg.norm(B[0]) * np.linalg.norm(B[1])))
    if kga > np.pi / 2 + 1e-10:
        variant = "MCLC1"
    elif abs(kga - np.pi / 2) <= 1e-10:
        variant = "MCLC2"
    else:
        t = b * np.cos(al) / c + (b * np.sin(al) / a) ** 2
        variant = "MCLC3" if t < 1 - 1e-10 else ("MCLC4" if t <= 1 + 1e-10
                                                 else "MCLC5")
    # S&C parameter-dependent point tables (offline recollection,
    # VALIDATED numerically: every path point of every variant
    # satisfies the BZ Voronoi property |k| = min_G |k−G| over wide
    # parameter scans — see tests/test_lattices.py). The cell
    # normalization above keeps the fraction formulas in-regime for
    # arbitrary inputs (obtuse α / strong c-skew previously fell back);
    # the _path_on_bz guard below remains as a backstop → sanctioned
    # generic-path fallback (SURVEY.md App. A; labels only,
    # eigensolves unaffected).
    sa, ca = np.sin(al), np.cos(al)
    if variant in ("MCLC1", "MCLC2"):
        ze = (2 - b * ca / c) / (4 * sa * sa)
        eta = 0.5 + 2 * ze * c * ca / b
        psi = 0.75 - a * a / (4 * b * b * sa * sa)
        phi = psi + (0.75 - psi) * b * ca / c
        pts = _pts({
            "G": (0, 0, 0), "N": (0.5, 0, 0), "N1": (0, -0.5, 0),
            "F": (1 - ze, 1 - ze, 1 - eta), "F1": (ze, ze, eta),
            "F2": (-ze, -ze, 1 - eta), "F3": (1 - ze, -ze, 1 - eta),
            "I": (phi, 1 - phi, 0.5), "I1": (1 - phi, phi - 1, 0.5),
            "L": (0.5, 0.5, 0.5), "M": (0.5, 0, 0.5),
            "X": (1 - psi, psi - 1, 0), "X1": (psi, 1 - psi, 0),
            "X2": (psi - 1, -psi, 0), "Y": (0.5, 0.5, 0),
            "Y1": (-0.5, -0.5, 0), "Z": (0, 0, 0.5),
        })
        path = ([["G", "Y", "F", "L", "I"], ["I1", "Z", "F1"],
                 ["Y", "X1"], ["X", "G", "N"], ["M", "G"]]
                if variant == "MCLC1" else
                [["G", "Y", "F", "L", "I"], ["I1", "Z", "F1"],
                 ["N", "G", "M"]])
    elif variant in ("MCLC3", "MCLC4"):
        mu = (1 + b * b / (a * a)) / 4
        de = b * c * ca / (2 * a * a)
        ze = mu - 0.25 + (1 - b * ca / c) / (4 * sa * sa)
        eta = 0.5 + 2 * ze * c * ca / b
        phi = 1 + ze - 2 * mu
        psi = eta - 2 * de
        pts = _pts({
            "G": (0, 0, 0), "F": (1 - phi, 1 - phi, 1 - psi),
            "F1": (phi, phi - 1, psi), "F2": (1 - phi, -phi, 1 - psi),
            "H": (ze, ze, eta), "H1": (1 - ze, -ze, 1 - eta),
            "H2": (-ze, -ze, 1 - eta), "I": (0.5, -0.5, 0.5),
            "M": (0.5, 0, 0.5), "N": (0.5, 0, 0), "N1": (0, -0.5, 0),
            "X": (0.5, -0.5, 0), "Y": (mu, mu, de),
            "Y1": (1 - mu, -mu, -de), "Y2": (-mu, -mu, -de),
            "Y3": (mu, mu - 1, de), "Z": (0, 0, 0.5),
        })
        path = ([["G", "Y", "F", "H", "Z", "I", "F1"],
                 ["H1", "Y1", "X", "G", "N"], ["M", "G"]]
                if variant == "MCLC3" else
                [["G", "Y", "F", "H", "Z", "I"],
                 ["H1", "Y1", "X", "G", "N"], ["M", "G"]])
    else:  # MCLC5
        ze = (b * b / (a * a) + (1 - b * ca / c) / (sa * sa)) / 4
        eta = 0.5 + 2 * ze * c * ca / b
        mu = eta / 2 + b * b / (4 * a * a) - b * c * ca / (2 * a * a)
        nu = 2 * mu - ze
        rho = 1 - ze * a * a / (b * b)
        om = (4 * nu - 1 - b * b * sa * sa / (a * a)) * c / (2 * b * ca)
        de = ze * c * ca / b + om / 2 - 0.25
        pts = _pts({
            "G": (0, 0, 0), "F": (nu, nu, om),
            "F1": (1 - nu, 1 - nu, 1 - om), "F2": (nu, nu - 1, om),
            "H": (ze, ze, eta), "H1": (1 - ze, -ze, 1 - eta),
            "H2": (-ze, -ze, 1 - eta), "I": (rho, 1 - rho, 0.5),
            "I1": (1 - rho, rho - 1, 0.5), "L": (0.5, 0.5, 0.5),
            "M": (0.5, 0, 0.5), "N": (0.5, 0, 0), "N1": (0, -0.5, 0),
            "X": (0.5, -0.5, 0), "Y": (mu, mu, de),
            "Y1": (1 - mu, -mu, -de), "Y2": (-mu, -mu, -de),
            "Y3": (mu, mu - 1, de), "Z": (0, 0, 0.5),
        })
        path = [["G", "Y", "F", "L", "I"], ["I1", "Z", "H", "F1"],
                ["H1", "Y1", "X", "G", "N"], ["M", "G"]]
    if not _path_on_bz(B, pts, path):
        pts, path = _generic_path_3d()
        return A, pts, path, variant, True
    return A, pts, path, variant, False


def _tri(a, b, c, al, be, ga):
    cal, cbe, cga = np.cos(al), np.cos(be), np.cos(ga)
    sga = np.sin(ga)
    a3y = c * (cal - cbe * cga) / sga
    a3z = c * np.sqrt(max(
        1 - cal * cal - cbe * cbe - cga * cga + 2 * cal * cbe * cga, 0.0)) / sga
    A = np.array([[a, 0, 0], [b * cga, b * sga, 0], [c * cbe, a3y, a3z]])
    B = _reciprocal(A)

    def _ang(u, v):
        return np.arccos(u @ v / (np.linalg.norm(u) * np.linalg.norm(v)))

    kal, kbe, kga = _ang(B[1], B[2]), _ang(B[0], B[2]), _ang(B[0], B[1])
    obtuse = kal > np.pi / 2 - 1e-10 and kbe > np.pi / 2 - 1e-10 \
        and kga > np.pi / 2 - 1e-10
    if obtuse:
        variant = "TRI2a" if abs(kga - np.pi / 2) <= 1e-10 else "TRI1a"
        pts = _pts({
            "G": (0, 0, 0), "L": (0.5, 0.5, 0), "M": (0, 0.5, 0.5),
            "N": (0.5, 0, 0.5), "R": (0.5, 0.5, 0.5), "X": (0.5, 0, 0),
            "Y": (0, 0.5, 0), "Z": (0, 0, 0.5),
        })
    else:
        variant = "TRI2b" if abs(kga - np.pi / 2) <= 1e-10 else "TRI1b"
        pts = _pts({
            "G": (0, 0, 0), "L": (0.5, -0.5, 0), "M": (0, 0, 0.5),
            "N": (-0.5, -0.5, 0.5), "R": (0, -0.5, 0.5), "X": (0, -0.5, 0),
            "Y": (0.5, 0, 0), "Z": (-0.5, 0, 0.5),
        })
    path = [["X", "G", "Y"], ["L", "G", "Z"], ["N", "G", "M"], ["R", "G"]]
    return A, pts, path, variant, False


# ---------------------------------------------------------------------------
# 2D lattices (SURVEY.md App. A).
# ---------------------------------------------------------------------------

def _sqr(a, b, c, al, be, ga):
    A = np.array([[a, 0], [0, a]])
    pts = _pts({"G": (0, 0), "X": (0.5, 0), "M": (0.5, 0.5)})
    return A, pts, [["G", "X", "M", "G"]], "SQR", False


def _rect(a, b, c, al, be, ga):
    A = np.array([[a, 0], [0, b]])
    pts = _pts({"G": (0, 0), "X": (0.5, 0), "Y": (0, 0.5), "S": (0.5, 0.5)})
    return A, pts, [["G", "X", "S", "Y", "G"]], "RECT", False


def _crect(a, b, c, al, be, ga):
    A = np.array([[a / 2, -b / 2], [a / 2, b / 2]])
    pts = _pts({"G": (0, 0), "X": (0.5, 0.5), "Y1": (0.25, 0.75),
                "Y": (0.75, 0.25)})
    return A, pts, [["G", "X", "Y1", "G"]], "CRECT", False


def _hex2d(a, b, c, al, be, ga):
    A = np.array([[a, 0], [-a / 2, a * np.sqrt(3) / 2]])
    pts = _pts({"G": (0, 0), "M": (0.5, 0), "K": (1 / 3, 1 / 3)})
    return A, pts, [["G", "M", "K", "G"]], "HEX2D", False


def _obl(a, b, c, al, be, ga):
    A = np.array([[a, 0], [b * np.cos(ga), b * np.sin(ga)]])
    pts = _pts({"G": (0, 0), "X": (0.5, 0), "Y": (0, 0.5), "C": (0.5, 0.5)})
    return A, pts, [["G", "X", "C", "Y", "G"]], "OBL", False


_BUILDERS = {
    "CUB": _cub, "FCC": _fcc, "BCC": _bcc, "TET": _tet, "BCT": _bct,
    "ORC": _orc, "ORCF": _orcf, "ORCI": _orci, "ORCC": _orcc, "HEX": _hex,
    "RHL": _rhl, "MCL": _mcl, "MCLC": _mclc, "TRI": _tri,
    "SQR": _sqr, "RECT": _rect, "CRECT": _crect, "HEX2D": _hex2d, "OBL": _obl,
}

_DEFAULTS = {  # sensible conventional-cell defaults per family
    "TET": dict(c=1.4), "BCT": dict(c=0.8), "ORC": dict(b=1.2, c=1.4),
    "ORCF": dict(b=1.2, c=1.4), "ORCI": dict(b=1.2, c=1.4),
    "ORCC": dict(b=1.2, c=1.4), "HEX": dict(c=1.4),
    "RHL": dict(alpha=np.deg2rad(60.0)),
    "MCL": dict(b=1.1, c=1.3, alpha=np.deg2rad(75.0)),
    "MCLC": dict(b=1.1, c=1.3, alpha=np.deg2rad(75.0)),
    "TRI": dict(b=1.1, c=1.3, alpha=np.deg2rad(75.0),
                beta=np.deg2rad(80.0), gamma=np.deg2rad(85.0)),
    "RECT": dict(b=1.4), "CRECT": dict(b=1.4),
    "OBL": dict(b=1.3, gamma=np.deg2rad(75.0)),
}


def make_lattice(name: str, a: float = 1.0, b: Optional[float] = None,
                 c: Optional[float] = None, alpha: Optional[float] = None,
                 beta: Optional[float] = None,
                 gamma: Optional[float] = None) -> Lattice:
    """Factory for any of the 14 3D + 5 2D Bravais lattices.

    Angles are in radians. Unspecified parameters fall back to family
    defaults (b, c default relative to ``a``). Reference equivalent:
    ``BravaisLatticeFactory`` (SURVEY.md §2.1 #1, §3.2).
    """
    key = _ALIASES.get(name.upper().replace("-", "_"), name.upper())
    if key not in _BUILDERS:
        raise ValueError(
            f"unknown lattice {name!r}; choose from "
            f"{LATTICE_NAMES + LATTICE_NAMES_2D}")
    d = _DEFAULTS.get(key, {})
    b = b if b is not None else d.get("b", a)
    c = c if c is not None else d.get("c", a)
    alpha = alpha if alpha is not None else d.get("alpha", np.pi / 2)
    beta = beta if beta is not None else d.get("beta", np.pi / 2)
    gamma = gamma if gamma is not None else d.get("gamma", np.pi / 2)
    A, pts, path, variant, generic = _BUILDERS[key](a, b, c, alpha, beta,
                                                    gamma)
    A = np.asarray(A, dtype=np.float64)
    if key in ("MCL", "MCLC"):
        # Report the NORMALIZED conventional cell (the one A was built
        # from — see _reduce_oblique_plane) so params round-trip:
        # make_lattice(name, **lat.params) rebuilds the identical A.
        b = float(A[1, 1]) if key == "MCL" else float(2 * A[0, 1])
        c = float(np.hypot(A[2, 1], A[2, 2]))
        alpha = float(np.arctan2(A[2, 2], A[2, 1]))
    return Lattice(
        name=key, variant=variant, dim=A.shape[0], A=A, B=_reciprocal(A),
        points=pts, path=path,
        params=dict(a=a, b=b, c=c, alpha=alpha, beta=beta, gamma=gamma),
        generic_path=generic)
