"""Host (NumPy, f64) tensor-product element machinery on periodic grids.

The ``*_np`` half of ``bravais_tpu/spaces/tensor.py`` (lines 110-146 and
198-225), copied verbatim: the element gather / scatter-add and the
sum-factorized 1D contractions the f64 host twins and the stencil
extraction run on. The device half (torch, with a leading block-row
axis) is ``spaces/tensor.py``.

Layout convention (as in the reference):

* global dof arrays have one axis per spatial dimension,
  ``(N_1, ..., N_d)`` with ``N_i = n_i * p_i``;
* element-local arrays interleave element and local axes,
  ``(n_1, l_1, n_2, l_2, ...)`` with ``l_i = p_i + 1`` for closed
  directions (last node shared with the next element) and ``p_i`` for
  open ones;
* quadrature-space arrays are ``(n_1, q_1, n_2, q_2, ...)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gather_np", "scatter_add_np", "contract_np", "contract_t_np",
           "gather_axis_np", "scatter_add_axis_np"]


def gather_np(u, shape, p, closed):
    for i in range(len(shape)):
        ax = 2 * i
        u = u.reshape(*u.shape[:ax], shape[i], p[i], *u.shape[ax + 1:])
        if closed[i]:
            first = np.take(u, [0], axis=ax + 1)
            u = np.concatenate([u, np.roll(first, -1, axis=ax)],
                               axis=ax + 1)
    return u


def scatter_add_np(r, shape, p, closed):
    for i in reversed(range(len(shape))):
        ax = 2 * i
        if closed[i]:
            main = np.take(r, range(p[i]), axis=ax + 1).copy()
            last = np.roll(np.take(r, [p[i]], axis=ax + 1), 1, axis=ax)
            idx = (slice(None),) * (ax + 1) + (0,)
            main[idx] += np.squeeze(last, axis=ax + 1)
        else:
            main = r
        r = main.reshape(*main.shape[:ax], shape[i] * p[i],
                         *main.shape[ax + 2:])
    return r


def contract_np(ue, tables):
    for i in range(len(tables)):
        ax = 2 * i + 1
        ue = np.moveaxis(np.tensordot(tables[i], ue, axes=((1,), (ax,))),
                         0, ax)
    return ue


def contract_t_np(vq, tables):
    for i in range(len(tables)):
        ax = 2 * i + 1
        vq = np.moveaxis(np.tensordot(tables[i], vq, axes=((0,), (ax,))),
                         0, ax)
    return vq


def gather_axis_np(u, axis, n, p, phase=None):
    """Closed gather along one axis: size n*p -> (n, p+1) at ``axis``;
    ``phase`` (complex scalar or None) multiplies the wrapped entry."""
    shape = u.shape
    u = u.reshape(*shape[:axis], n, p, *shape[axis + 1:])
    first = np.take(u, [0], axis=axis + 1)
    rolled = np.roll(first, -1, axis=axis)
    if phase is not None:
        sel = [slice(None)] * rolled.ndim
        sel[axis] = slice(n - 1, n)
        rolled = rolled.copy()
        rolled[tuple(sel)] = rolled[tuple(sel)] * phase
    return np.concatenate([u, rolled], axis=axis + 1)


def scatter_add_axis_np(r, axis, n, p, phase=None):
    """Adjoint of :func:`gather_axis_np` (conjugate phase on the wrap)."""
    main = np.take(r, range(p), axis=axis + 1).copy()
    last = np.roll(np.take(r, [p], axis=axis + 1), 1, axis=axis)
    if phase is not None:
        sel = [slice(None)] * last.ndim
        sel[axis] = slice(0, 1)
        last[tuple(sel)] = last[tuple(sel)] * np.conj(phase)
    idx = (slice(None),) * (axis + 1) + (0,)
    main[idx] += np.squeeze(last, axis=axis + 1)
    shape = main.shape
    return main.reshape(*shape[:axis], n * p, *shape[axis + 2:])
