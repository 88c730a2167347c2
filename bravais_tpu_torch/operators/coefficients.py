"""Scalar coefficients sampled at quadrature points (host, f64).

Port of ``CoefLike`` and ``eval_coefficient`` from
``bravais_tpu/operators/helmholtz.py:39-60``. Only what the
empty-lattice slice needs; the dielectric shapes of
``bravais_tpu/operators/coefficients.py`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np

__all__ = ["CoefLike", "eval_coefficient"]

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
