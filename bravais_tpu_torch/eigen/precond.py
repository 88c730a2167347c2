"""Preconditioners for the LOBPCG eigensolves.

Port of ``bravais_tpu/eigen/precond.py``: the operator-diagonal Jacobi
preconditioner. Geometric multigrid lives in ``eigen/gmg.py`` and plugs
into the same interface, ``precond(R) -> W`` on blocks (rows,
*dof_shape). The reference's ``chebyshev`` and ``estimate_lmax`` have no
caller on any path of the port and are not ported.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["jacobi"]


def jacobi(diag: torch.Tensor, batched: bool = False) -> Callable:
    """Diagonal (Jacobi) preconditioner W = R / diag (``diag`` real, of
    the dof shape, on the device of the blocks it will scale). With
    ``batched``, ``diag`` is (nk, *dof_shape), one diagonal per k, and
    scales k-batched blocks (nk, rows, *dof_shape)."""
    d = torch.clamp(diag.real, min=1e-30)
    if batched:
        d = d.unsqueeze(1)

    def apply(R):
        return R / d
    return apply
