"""Scalar coefficients sampled at quadrature points (host, f64).

Port of ``CoefLike`` and ``eval_coefficient`` from
``bravais_tpu/operators/helmholtz.py:39-60`` and of the dielectric shapes
of ``bravais_tpu/operators/coefficients.py`` (``periodic_distance``,
``smoothed_indicator``, ``dielectric_rod``, ``dielectric_sphere``):
material interfaces are resolved in the coefficient, sampled at the
quadrature points, optionally averaged over each quadrature subcell
(``subcell_average``).

Shape predicates take physical coordinates ``x`` (..., d).
"""

from __future__ import annotations

from itertools import product
from typing import Callable, Union

import numpy as np

__all__ = ["CoefLike", "eval_coefficient", "periodic_distance",
           "smoothed_indicator", "dielectric_rod", "dielectric_sphere",
           "subcell_average"]

CoefLike = Union[float, np.ndarray, Callable[[np.ndarray], np.ndarray]]


def eval_coefficient(coef: CoefLike, x: np.ndarray) -> np.ndarray:
    """Evaluate a scalar coefficient at points ``x`` of shape (..., d)."""
    if callable(coef):
        v = np.asarray(coef(x), dtype=np.float64)
        if v.shape != x.shape[:-1]:
            raise ValueError(f"coefficient returned shape {v.shape}, "
                             f"expected {x.shape[:-1]}")
        return v
    return np.broadcast_to(np.asarray(coef, dtype=np.float64),
                           x.shape[:-1]).copy()


def periodic_distance(x: np.ndarray, center, lattice_A: np.ndarray
                      ) -> np.ndarray:
    """Distance from ``x`` (..., d) to ``center`` modulo lattice
    translations (nearest image over the 3^d neighbour cells)."""
    d = x.shape[-1]
    delta = x - np.asarray(center, dtype=np.float64)
    best = None
    for shift in product((-1.0, 0.0, 1.0), repeat=d):
        r = np.linalg.norm(delta + np.asarray(shift) @ lattice_A, axis=-1)
        best = r if best is None else np.minimum(best, r)
    return best


def smoothed_indicator(r: np.ndarray, radius: float, width: float
                       ) -> np.ndarray:
    """~1 inside r < radius, ~0 outside, smoothed over ``width`` (tanh
    profile); width=0 gives the sharp indicator."""
    if width <= 0:
        return (r < radius).astype(np.float64)
    return 0.5 * (1.0 - np.tanh((r - radius) / width))


def dielectric_rod(eps_in: float, eps_out: float, radius: float,
                   center, lattice_A: np.ndarray,
                   width: float = 0.0) -> Callable:
    """Circular rod (2D) or sphere (3D) of permittivity ``eps_in`` in a
    background ``eps_out``, periodically repeated."""
    def eps(x: np.ndarray) -> np.ndarray:
        r = periodic_distance(x, center, lattice_A)
        ind = smoothed_indicator(r, radius, width)
        return eps_out + (eps_in - eps_out) * ind
    return eps


# 3D: the same formula — the periodic distance handles it.
dielectric_sphere = dielectric_rod


def subcell_average(fn: Callable, cell_vectors: np.ndarray,
                    nsub: int = 4) -> Callable:
    """Subcell smoothing: the mean of ``fn`` over an ``nsub``^d midpoint
    grid spanning the cell around each sample point, so the weak form
    integrates the locally averaged material instead of a pointwise-
    sampled sharp interface. ``cell_vectors``: (d, d) rows spanning the
    cell in physical coordinates — ``lattice.A / (n * q)``, the
    quadrature-point spacing. TM averages ε, TE 1/ε (the coefficient its
    weak form integrates)."""
    V = np.asarray(cell_vectors, np.float64)
    d = V.shape[0]
    ax = [(np.arange(nsub) + 0.5) / nsub - 0.5 for _ in range(d)]
    mesh = np.meshgrid(*ax, indexing="ij")
    disp = np.stack([m.ravel() for m in mesh], axis=-1) @ V  # (nsub^d, d)

    def avg(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        return np.mean(fn(x[..., None, :] + disp), axis=-1)

    return avg
