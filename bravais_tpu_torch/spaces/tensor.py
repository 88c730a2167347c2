"""Device (torch) tensor-product element machinery on periodic grids.

The device half of ``bravais_tpu/spaces/tensor.py``: the periodic element
gather and its adjoint scatter-add (``gather``, ``scatter_add``), their
quasi-periodic variants (``gather_axis``, ``scatter_add_axis`` with the
Bloch wrap phase; ``gather_qp``, ``scatter_add_qp`` over every axis) and
the sum-factorized 1D contractions (``contract``, ``contract_t``). The
multi-axis gathers take axis 0 of a slab split over a process group
through ``parallel/halo.py``.

Every array carries a leading block-row axis that the functions pass
through: the port's LOBPCG hands whole blocks (rows, *dof_shape) to the
operators, where the reference vmapped a single-field function. ``axis``
arguments count positions AFTER that row axis, so they read as in the
reference.

Layouts (per row, as in the reference):

* global dofs ``(N_1, ..., N_d)`` with ``N_i = n_i p_i``;
* gathered element dofs interleave element and local axes,
  ``(n_1, l_1, n_2, l_2, ...)`` with ``l_i = p_i + 1`` on closed axes;
* ``contract``/``contract_t`` act on the TRAILING d local axes of an
  element-major array ``(..., l_1, ..., l_d)`` — the layout the element
  kernels take (one element's dofs contiguous), so the kernels' plain
  versions are built from them.

The ``*_np`` host twins live in ``spaces/tensor_np.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["gather", "scatter_add", "gather_axis", "scatter_add_axis",
           "gather_qp", "scatter_add_qp", "contract", "contract_t"]


def _phased(x: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """x times the wrap phase: a complex scalar tensor, or a per-k vector
    (nk,) whose entries scale nk equal groups of x's rows (row group g
    takes ``phase[g]``, the k-batched layout)."""
    if not isinstance(phase, torch.Tensor) or phase.ndim == 0:
        return x * phase
    nk = phase.shape[0]
    return (x.reshape((nk, -1) + x.shape[1:])
            * phase.reshape((nk,) + (1,) * x.ndim)).reshape(x.shape)


def gather_axis(u: torch.Tensor, axis: int, n: int, p: int, phase=None
                ) -> torch.Tensor:
    """Closed gather along one axis: size n*p -> (n, p+1) at ``axis``.
    ``phase`` (a complex scalar tensor, a per-k vector (nk,) over nk equal
    row groups, or None) multiplies the wrapped entry (the last element's
    shared node, at x = a_i)."""
    a = axis + 1
    shape = u.shape
    u = u.reshape(*shape[:a], n, p, *shape[a + 1:])
    first = u.narrow(a + 1, 0, 1)
    if phase is None:
        rolled = torch.roll(first, -1, dims=a)
    else:
        rolled = torch.cat([first.narrow(a, 1, n - 1),
                            _phased(first.narrow(a, 0, 1), phase)], dim=a)
    return torch.cat([u, rolled], dim=a + 1)


def scatter_add_axis(r: torch.Tensor, axis: int, n: int, p: int,
                     phase=None) -> torch.Tensor:
    """Adjoint of :func:`gather_axis` (conjugate phase on the wrap; a
    per-k ``phase`` (nk,) as there)."""
    a = axis + 1
    main = r.narrow(a + 1, 0, p)
    last = r.narrow(a + 1, p, 1)
    if phase is None:
        last = torch.roll(last, 1, dims=a)
    else:
        last = torch.cat([_phased(last.narrow(a, n - 1, 1), phase.conj()),
                          last.narrow(a, 0, n - 1)], dim=a)
    main = torch.cat([main.narrow(a + 1, 0, 1) + last,
                      main.narrow(a + 1, 1, p - 1)], dim=a + 1)
    shape = main.shape
    return main.reshape(*shape[:a], n * p, *shape[a + 2:])


def gather_qp(u: torch.Tensor, shape: Sequence[int], p: Sequence[int],
              closed: Sequence[bool], phases, mesh=None) -> torch.Tensor:
    """Quasi-periodic multi-axis gather: closed axes wrap with their
    Bloch phase (``phases[i]``: a scalar, or per k (nk,) over nk equal
    row groups; ignored on open axes). With ``mesh`` (a
    ``parallel.mesh.KMesh``), axis 0 is this rank's slab of ``shape[0]``
    elements, closed across the ranks (``parallel/halo.py``)."""
    for i in range(len(shape)):
        ax = 2 * i
        if closed[i] and i == 0 and mesh is not None:
            from bravais_tpu_torch.parallel.halo import gather_axis0
            u = gather_axis0(u, shape[0], p[0], mesh, phases[0])
        elif closed[i]:
            u = gather_axis(u, ax, shape[i], p[i], phases[i])
        else:
            s = u.shape
            u = u.reshape(*s[:ax + 1], shape[i], p[i], *s[ax + 2:])
    return u


def scatter_add_qp(r: torch.Tensor, shape: Sequence[int], p: Sequence[int],
                   closed: Sequence[bool], phases, mesh=None) -> torch.Tensor:
    """Adjoint of :func:`gather_qp` (``mesh`` as there)."""
    for i in reversed(range(len(shape))):
        ax = 2 * i
        if closed[i] and i == 0 and mesh is not None:
            from bravais_tpu_torch.parallel.halo import scatter_add_axis0
            r = scatter_add_axis0(r, shape[0], p[0], mesh, phases[0])
        elif closed[i]:
            r = scatter_add_axis(r, ax, shape[i], p[i], phases[i])
        else:
            s = r.shape
            r = r.reshape(*s[:ax + 1], shape[i] * p[i], *s[ax + 3:])
    return r


def gather(u: torch.Tensor, shape: Sequence[int], p: Sequence[int],
           closed: Sequence[bool]) -> torch.Tensor:
    """Periodic multi-axis gather (no phase): global dofs (rows, N_1,
    ..., N_d) -> element dofs (rows, n_1, l_1, ..., n_d, l_d)."""
    return gather_qp(u, shape, p, closed, [None] * len(shape))


def scatter_add(r: torch.Tensor, shape: Sequence[int], p: Sequence[int],
                closed: Sequence[bool]) -> torch.Tensor:
    """Adjoint of :func:`gather`."""
    return scatter_add_qp(r, shape, p, closed, [None] * len(shape))


def _table(T, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(T, dtype=x.dtype, device=x.device)


def contract(x: torch.Tensor, tables: Sequence) -> torch.Tensor:
    """Element dofs -> quadrature values: contract the trailing d local
    axes of ``x`` (..., l_1, ..., l_d) with ``tables[i]`` (q_i, l_i)."""
    d = len(tables)
    for i, T in enumerate(tables):
        ax = x.ndim - d + i
        x = torch.movedim(torch.tensordot(x, _table(T, x).T,
                                          dims=([ax], [0])), -1, ax)
    return x


def contract_t(x: torch.Tensor, tables: Sequence) -> torch.Tensor:
    """Transpose of :func:`contract`: (..., q_1, ..., q_d) ->
    (..., l_1, ..., l_d)."""
    d = len(tables)
    for i, T in enumerate(tables):
        ax = x.ndim - d + i
        x = torch.movedim(torch.tensordot(x, _table(T, x),
                                          dims=([ax], [0])), -1, ax)
    return x
