"""The axis-0 halo exchange of a grid split into slabs over a process
group: domain decomposition of one k's operator.

The reference shards a dof axis of the operator's state with a
``NamedSharding`` and lets XLA turn the periodic element gather into a
halo exchange and the Grams into all-reduces
(``tests/test_domain_decomposition.py``). Here the exchange is written:
``gather_axis0`` and ``scatter_add_axis0`` are ``spaces/tensor.py``'s
``gather_axis`` and ``scatter_add_axis`` for axis 0 of a slab, with the
periodic wrap across the ranks.

Rank r of P owns elements [r·n₁/P, (r+1)·n₁/P) of axis 0 and the dof
planes that begin them (``slab``), n₁/P·p planes. The gather needs one
more node plane, the first of rank r+1's slab (rank 0's for the last
rank), and only the rank that owns the last element applies the Bloch
wrap phase to it. The scatter sends each slab's last node contribution
to rank r+1, which adds it to its first plane (the last rank sends it
with the conjugate phase). At P = 1 the same code exchanges with itself
(``KMesh.shift`` returns its input): the local periodic wrap.

Slabs are aligned to elements: ``slab`` refuses n₁ % P ≠ 0. XLA's
partitioner could cut anywhere; this is a deliberate restriction, which
keeps every element's dofs on one rank and each kernel launch unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bravais_tpu_torch.spaces.tensor import _phased

__all__ = ["slab", "gather_axis0", "scatter_add_axis0"]


def slab(n: int, mesh) -> Tuple[int, int]:
    """(first element, element count) of this rank's slab of the ``n``
    elements of axis 0; raises unless the ranks split them evenly."""
    P = mesh.size
    if n % P:
        raise ValueError(f"domain decomposition splits axis 0 into {P} "
                         f"slabs of whole elements: its {n} elements are "
                         f"not a multiple of {P} (n1 % P = {n % P})")
    ne = n // P
    return mesh.rank * ne, ne


def _wraps(mesh) -> bool:
    """True on the rank that owns the last element (the Bloch wrap)."""
    return mesh.rank == mesh.size - 1


def gather_axis0(u: torch.Tensor, n: int, p: int, mesh, phase=None
                 ) -> torch.Tensor:
    """Closed gather along axis 0 of a slab: u (rows, n·p, ...) →
    (rows, n, p+1, ...), the slab's n elements each with its closing node
    (the next element's first plane; the slab's last element takes the
    next rank's first plane). ``phase`` (a scalar tensor, a per-k vector
    (nk,) over nk equal row groups, or None) multiplies the wrapped plane
    on the last rank."""
    shape = u.shape
    u = u.reshape(shape[0], n, p, *shape[2:])
    first = u.narrow(2, 0, 1)                    # (rows, n, 1, ...)
    ghost = mesh.shift(first.narrow(1, 0, 1), -1)
    if phase is not None and _wraps(mesh):
        ghost = _phased(ghost, phase)
    rolled = torch.cat([first.narrow(1, 1, n - 1), ghost], dim=1)
    return torch.cat([u, rolled], dim=2)


def scatter_add_axis0(r: torch.Tensor, n: int, p: int, mesh, phase=None
                      ) -> torch.Tensor:
    """Adjoint of :func:`gather_axis0`: (rows, n, p+1, ...) → (rows, n·p,
    ...); the slab's last closing node goes to the next rank's first
    plane (with the conjugate ``phase`` from the last rank)."""
    main = r.narrow(2, 0, p)
    last = r.narrow(2, p, 1)                     # (rows, n, 1, ...)
    out = last.narrow(1, n - 1, 1)
    if phase is not None and _wraps(mesh):
        out = _phased(out, phase.conj())
    recv = mesh.shift(out, 1)
    last = torch.cat([recv, last.narrow(1, 0, n - 1)], dim=1)
    main = torch.cat([main.narrow(2, 0, 1) + last, main.narrow(2, 1, p - 1)],
                     dim=2)
    shape = main.shape
    return main.reshape(shape[0], n * p, *shape[3:])
