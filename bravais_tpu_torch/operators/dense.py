"""Dense assembly oracle (host, NumPy complex128).

Port of ``assemble_h1`` from ``bravais_tpu/operators/dense.py``: a
straightforward assembly of the Bloch Helmholtz A(k) and M as dense
matrices with naive per-element loops, sharing nothing with the
matrix-free path except the 1D basis tables. A generalized eigensolve of
the pair gives small-problem band oracles (``chip_smoke.py`` runs it on
the card, where there is no JAX). The Nédélec assembly is not ported.
"""

from __future__ import annotations

import itertools

import numpy as np

from bravais_tpu_torch.operators.coefficients import (CoefLike,
                                                      eval_coefficient)
from bravais_tpu_torch.spaces.h1 import H1Space

__all__ = ["assemble_h1"]


def assemble_h1(space: H1Space, k, alpha: CoefLike = 1.0,
                beta: CoefLike = 1.0):
    """Dense A(k) and M of the Bloch Helmholtz problem on ``space``:
    (A, M) complex128 (N, N), N = space.ndofs, dofs in C order of the
    (N₁, ..., N_d) grid."""
    d = space.dim
    p1 = space.p + 1
    q = space.q
    k = np.asarray(k, dtype=np.float64)
    B, D = space.basis.B, space.basis.D  # (q, p1)
    JinvT = space.grid.Jinv.T

    # Local tables over tensor qpts/dofs: Phi[Q, L], Ghat[r, Q, L].
    qidx = list(itertools.product(range(q), repeat=d))
    lidx = list(itertools.product(range(p1), repeat=d))
    Phi = np.zeros((len(qidx), len(lidx)))
    Ghat = np.zeros((d, len(qidx), len(lidx)))
    for Q, qs in enumerate(qidx):
        for L, js in enumerate(lidx):
            Phi[Q, L] = np.prod([B[qs[i], js[i]] for i in range(d)])
            for r in range(d):
                Ghat[r, Q, L] = np.prod(
                    [(D if i == r else B)[qs[i], js[i]] for i in range(d)])
    Gphys = np.einsum("rs,sQL->rQL", JinvT, Ghat)
    P = Gphys + 1j * k[:, None, None] * Phi[None]   # (∇φ_L + ikφ_L)_r at Q

    wq1 = space.basis.qwts
    wQ = np.array([np.prod([wq1[qs[i]] for i in range(d)]) for qs in qidx])
    wQ = wQ * space.grid.detJ

    xq = space.qpoints_phys()  # (n1,q,...,nd,q,d) interleaved
    perm = [2 * i for i in range(d)] + [2 * i + 1 for i in range(d)]
    nel = space.grid.n_elements
    alpha_e = np.transpose(eval_coefficient(alpha, xq),
                           perm).reshape(nel, len(qidx))
    beta_e = np.transpose(eval_coefficient(beta, xq),
                          perm).reshape(nel, len(qidx))

    N = space.ndofs
    A = np.zeros((N, N), dtype=np.complex128)
    M = np.zeros((N, N), dtype=np.complex128)
    Nd = space.dof_shape
    strides = np.cumprod([1] + list(Nd[::-1]))[::-1][1:]  # C-order strides
    for e, es in enumerate(itertools.product(*[range(n)
                                               for n in space.grid.shape])):
        A_loc = np.einsum("Q,rQa,rQb->ab", wQ * alpha_e[e], P.conj(), P)
        M_loc = np.einsum("Q,Qa,Qb->ab", wQ * beta_e[e], Phi, Phi)
        gidx = np.array(
            [sum(((es[i] * space.p + js[i]) % Nd[i]) * strides[i]
                 for i in range(d)) for js in lidx])
        np.add.at(A, (gidx[:, None], gidx[None, :]), A_loc)
        np.add.at(M, (gidx[:, None], gidx[None, :]), M_loc)
    return A, M
