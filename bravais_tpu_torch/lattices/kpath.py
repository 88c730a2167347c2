"""High-symmetry k-path sampling (reference: the k-path loop of the
mfem-bravais band apps, SURVEY.md §2.1 #6, §3.1).

Copied verbatim from ``bravais_tpu/lattices/kpath.py`` (pure NumPy) so the
PyTorch port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bravais_tpu_torch.lattices.data import Lattice

__all__ = ["KPath", "kpath"]


@dataclasses.dataclass(frozen=True)
class KPath:
    """A sampled k-path.

    Attributes
    ----------
    k_cart   : (nk, dim) Cartesian k-points
    k_frac   : (nk, dim) fractional coords in the reciprocal basis
    dist     : (nk,) cumulative arc length along the path (plot x-axis);
               restarts continue accumulating (segment breaks only affect
               labels, matching band-diagram convention)
    labels   : list of (index, label) ticks for plotting
    segments : list of (start, stop) index ranges, one per connected subpath
    """

    k_cart: np.ndarray
    k_frac: np.ndarray
    dist: np.ndarray
    labels: List[Tuple[int, str]]
    segments: List[Tuple[int, int]]

    @property
    def nk(self) -> int:
        return self.k_cart.shape[0]


def kpath(lattice: Lattice, npts: int = 64,
          path: Optional[Sequence[Sequence[str]]] = None,
          extra_points: Optional[Dict[str, Sequence[float]]] = None) -> KPath:
    """Sample ``npts`` total k-points along a symmetry path.

    Points are distributed across legs proportionally to Cartesian arc
    length (every symmetry point is always included exactly once per leg
    junction). ``path`` overrides the lattice's default S&C path, e.g.
    ``[["G", "X", "W", "L"]]`` for the headline FCC Γ–X–W–L diagram
    (BASELINE.json:5). ``extra_points`` adds labeled fractional points.
    """
    pts = dict(lattice.points)
    if extra_points:
        pts.update({k: np.asarray(v, float) for k, v in extra_points.items()})
    subpaths = [list(s) for s in (path if path is not None else lattice.path)]
    for s in subpaths:
        for lab in s:
            if lab not in pts:
                raise KeyError(f"symmetry point {lab!r} not defined for "
                               f"{lattice.variant}")

    # Legs: (label_from, label_to, cart_from, cart_to, length, subpath_id)
    legs = []
    for si, s in enumerate(subpaths):
        for u, v in zip(s[:-1], s[1:]):
            cu, cv = lattice.k_cart(pts[u]), lattice.k_cart(pts[v])
            legs.append((u, v, cu, cv, float(np.linalg.norm(cv - cu)), si))
    total_len = sum(l[4] for l in legs)
    n_min = len(subpaths) + len(legs)
    if npts < n_min:
        raise ValueError(f"npts={npts} cannot hold every symmetry point; "
                         f"this path needs npts >= {n_min}")
    if total_len <= 0.0:
        raise ValueError("k-path has zero total length (repeated points?)")
    n_interior = npts - n_min

    # Distribute interior points by leg length (largest-remainder rounding).
    quotas = [l[4] / total_len * n_interior for l in legs]
    counts = [int(q) for q in quotas]
    rem = n_interior - sum(counts)
    for i in np.argsort([c - q for c, q in zip(counts, quotas)])[:rem]:
        counts[i] += 1

    k_cart_list: List[np.ndarray] = []
    k_frac_list: List[np.ndarray] = []
    dist_list: List[float] = []
    labels: List[Tuple[int, str]] = []
    segments: List[Tuple[int, int]] = []
    d = 0.0
    prev_sub = -1
    seg_start = 0
    for (u, v, cu, cv, length, si), cnt in zip(legs, counts):
        fu, fv = pts[u], pts[v]
        if si != prev_sub:  # start of a connected subpath: emit its head
            if prev_sub >= 0:
                segments.append((seg_start, len(k_cart_list)))
            seg_start = len(k_cart_list)
            labels.append((len(k_cart_list), u))
            k_cart_list.append(cu)
            k_frac_list.append(np.asarray(fu, float))
            dist_list.append(d)
            prev_sub = si
        ts = np.linspace(0.0, 1.0, cnt + 2)[1:]  # interior + endpoint
        for t in ts:
            k_cart_list.append(cu + t * (cv - cu))
            k_frac_list.append(fu + t * (np.asarray(fv, float) - fu))
            dist_list.append(d + t * length)
        labels.append((len(k_cart_list) - 1, v))
        d += length
    segments.append((seg_start, len(k_cart_list)))

    # Merge consecutive duplicate label entries at the same index.
    merged: List[Tuple[int, str]] = []
    for idx, lab in labels:
        if merged and merged[-1][0] == idx:
            if merged[-1][1] != lab:
                merged[-1] = (idx, f"{merged[-1][1]}|{lab}")
        else:
            merged.append((idx, lab))

    return KPath(
        k_cart=np.asarray(k_cart_list, dtype=np.float64),
        k_frac=np.asarray(k_frac_list, dtype=np.float64),
        dist=np.asarray(dist_list, dtype=np.float64),
        labels=merged, segments=segments)
