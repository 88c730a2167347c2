"""Dense assembly oracle (host, NumPy complex128).

Port of ``bravais_tpu/operators/dense.py``: straightforward assemblies
of the Bloch Helmholtz (``assemble_h1``) and quasi-periodic Maxwell
(``assemble_nedelec``) A(k) and M as dense matrices with naive
per-element loops, sharing nothing with the matrix-free path except the
1D basis tables. A generalized eigensolve of the pair gives
small-problem band oracles (``chip_smoke.py`` runs them on the card,
where there is no JAX); ``deflated_nedelec_bands`` is the Maxwell one,
with the curl-curl kernel removed.
"""

from __future__ import annotations

import itertools

import numpy as np

from bravais_tpu_torch.operators.coefficients import (CoefLike,
                                                      eval_coefficient)
from bravais_tpu_torch.spaces.h1 import H1Space

__all__ = ["assemble_h1", "assemble_nedelec", "deflated_nedelec_bands"]


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


def assemble_nedelec(space, k, eps: CoefLike = 1.0, mu_inv: CoefLike = 1.0):
    """Dense A(k) and M of the Bloch Maxwell problem in the quasi-periodic
    formulation on ``space`` (NedelecSpace): the plain curl-curl, k only
    in the Bloch phase e^{i k·a_i} of the dofs whose periodic image
    wraps, as the curl-curl operator realizes it. (A, M) complex128
    (N, N), N = 3·(n p)³, dofs in C order of (3, N₁, N₂, N₃). Covariant
    value transform J⁻ᵀ, curl transform J / det J."""
    p = space.p
    q = space.q
    k = np.asarray(k, dtype=np.float64)
    Bc, Dc = space.closed.B, space.closed.D    # (q, p+1)
    Bo, Do = space.open.B, space.open.D        # (q, p)
    J = space.grid.J
    JinvT = space.grid.Jinv.T
    detJs = np.linalg.det(J)
    eye = np.eye(3)

    qidx = list(itertools.product(range(q), repeat=3))
    # Local index (c, j1, j2, j3): j_c in 0..p-1, the others in 0..p.
    lidx = []
    for c in range(3):
        sizes = [p if i == c else p + 1 for i in range(3)]
        for js in itertools.product(*[range(s) for s in sizes]):
            lidx.append((c,) + js)
    nL = len(lidx)
    nQ = len(qidx)

    Val = np.zeros((3, nQ, nL))       # physical value vector
    Crl = np.zeros((3, nQ, nL))       # physical curl vector
    for L, (c, *js) in enumerate(lidx):
        for Q, qs in enumerate(qidx):
            phi = 1.0
            grad = np.ones(3)
            for i in range(3):
                phi *= (Bo if i == c else Bc)[qs[i], js[i]]
            for s in range(3):
                g = 1.0
                for i in range(3):
                    if i == s:
                        g *= (Do if i == c else Dc)[qs[i], js[i]]
                    else:
                        g *= (Bo if i == c else Bc)[qs[i], js[i]]
                grad[s] = g
            Val[:, Q, L] = JinvT[:, c] * phi
            Crl[:, Q, L] = J @ np.cross(grad, eye[c]) / detJs
    P = Crl.astype(complex)   # quasi-periodic: no ik × value term
    phases = np.exp(1j * (np.asarray(space.grid.lattice.A) @ k))

    wq1 = space.closed.qwts
    wQ = np.array([np.prod([wq1[qs[i]] for i in range(3)]) for qs in qidx])
    wQ = wQ * abs(detJs)

    xq = space.qpoints_phys()
    perm = [0, 2, 4, 1, 3, 5]
    nel = space.grid.n_elements
    eps_e = np.transpose(eval_coefficient(eps, xq), perm).reshape(nel, nQ)
    mu_e = np.transpose(eval_coefficient(mu_inv, xq), perm).reshape(nel, nQ)

    Nd = space.dof_shape
    Ncomp = int(np.prod(Nd))
    N = 3 * Ncomp
    strides = np.array([Nd[1] * Nd[2], Nd[2], 1])
    A = np.zeros((N, N), dtype=np.complex128)
    M = np.zeros((N, N), dtype=np.complex128)
    for e, es in enumerate(itertools.product(*[range(n)
                                               for n in space.grid.shape])):
        A_loc = np.einsum("Q,rQa,rQb->ab", wQ * mu_e[e], P.conj(), P)
        M_loc = np.einsum("Q,rQa,rQb->ab", wQ * eps_e[e], Val, Val)
        gidx = np.empty(nL, dtype=np.int64)
        pf = np.ones(nL, dtype=complex)   # Bloch phase of each local dof
        for L, (c, *js) in enumerate(lidx):
            flat = 0
            for i in range(3):
                gi_raw = es[i] * p + js[i]
                gi = gi_raw % Nd[i]
                if gi_raw >= Nd[i]:       # a wrapped copy: local value =
                    pf[L] *= phases[i]    # phase · stored dof value
                flat += gi * strides[i]
            gidx[L] = c * Ncomp + flat
        # u_loc = diag(pf) u_glob  ⇒  A_glob += conj(pf_a) A_loc pf_b
        np.add.at(A, (gidx[:, None], gidx[None, :]),
                  np.conj(pf)[:, None] * A_loc * pf[None, :])
        np.add.at(M, (gidx[:, None], gidx[None, :]),
                  np.conj(pf)[:, None] * M_loc * pf[None, :])
    return A, M


def deflated_nedelec_bands(A, M, G, nev: int) -> np.ndarray:
    """The lowest ``nev`` eigenvalues of the dense Maxwell pencil (A, M)
    with the curl-curl kernel removed: G (N, N_h1) holds the discrete
    gradients of the H1 unit vectors, the orthogonal complement of
    span(M G) carries the physical fields, and the reduced Hermitian
    pencil on it is solved by a generalized eigh (complex128, host)."""
    import scipy.linalg

    Q2 = scipy.linalg.orth(M @ G)
    U2, _, _ = np.linalg.svd(Q2, full_matrices=True)
    comp = U2[:, Q2.shape[1]:]
    Ar = comp.conj().T @ A @ comp
    Mr = comp.conj().T @ M @ comp
    return scipy.linalg.eigh(Ar, Mr, eigvals_only=True)[:nev]
