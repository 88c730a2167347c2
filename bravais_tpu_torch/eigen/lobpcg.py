"""Complex LOBPCG eigensolver with fixed block shapes.

Port of ``bravais_tpu/eigen/lobpcg.py``: finds the lowest ``nev``
eigenpairs of the Hermitian pencil (A, M), A x = λ M x, with a block of
``m`` vectors, soft locking by masking (shapes never change), Cholesky
(CholeskyQR2) whitening of the S-basis Gram with a δ-regularized drop of
near-null directions, a Jacobi Rayleigh–Ritz (``jacobi_eigh``, on CUDA
the hand-written kernel), and the reference's guards: zero-row reseed,
rank-aware ``done``, whiteout freeze, degeneration stop, a refresh of
AX/MX/AP/MP every ``seg = 16`` iterations and the stagnation stop.

The reference's ``lax.while_loop`` is a Python loop here. Every tensor
keeps its shape across iterations, so a later change can capture one
segment in a CUDA graph.

A leading k axis (``batched=True``) solves nk pencils at once, with the
semantics of ``jax.vmap`` over the reference's nested loops: every
per-row quantity (Ritz values, residuals, locks, whitening, the (nk, 3m,
3m) Rayleigh–Ritz, ``done``, the stops) is per k and reduces over that
k's rows only; the active k-points step in lockstep (they share the
iteration count and the segment boundaries); a k that is done keeps its
state unchanged (``torch.where`` on an (nk,) mask) while the others go
on. The loop reads the (nk,) done flags from the host once per
iteration. The unbatched call is the same code with no leading axis.

A block whose dof axis is split over a process group (domain
decomposition, ``HelmholtzSlab``) runs with ``reduce``: every sum over
the dof axis is completed over the group, and each rank then does the
same small dense work.

Conventions: block arrays are (m, N) with each ROW a vector ((nk, m, N)
batched); ⟨x, y⟩ = conj(x)·y; Gram G[i, j] = ⟨s_i, Op s_j⟩ = conj(S) @
(Op S)ᵀ. The operators ``A(X)``, ``M(X)``, ``AM(X)`` (the fused pair),
``precond(R)`` and ``kernel_project(X)`` act on whole blocks
(rows, *dof_shape), or (nk, rows, *dof_shape) batched.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bravais_tpu_torch.eigen.jacobi_eigh import jacobi_eigh

__all__ = ["lobpcg", "LobpcgResult", "PROD_RR_TOL", "engine_scale_floor"]

#: Production Rayleigh–Ritz eigh stop (the reference's value, measured
#: iteration- and accuracy-neutral up to 1e-3 there).
PROD_RR_TOL = 1e-4

def engine_scale_floor(dtype) -> float:
    """Residual-scale floor of the engines' device solves: 0.3 in
    complex64 (the f64 refine certifies the near-zero bands), 3e-2 in
    other dtypes."""
    return 0.3 if dtype == torch.complex64 else 3e-2


#: Zero rows of a warm start are reseeded from this seed when the caller
#: passes no generator (the reference's fixed PRNGKey(0x5EED)).
RESEED = 0x5EED


class LobpcgResult(NamedTuple):
    """Batched (``batched=True``): every field gains a leading k axis and
    ``iterations`` is an (nk,) int64 numpy array."""
    eigenvalues: torch.Tensor    # (nev,) real, ascending
    eigenvectors: torch.Tensor   # (m, *dof_shape): first nev rows converged
    iterations: "int | np.ndarray"
    residual_norms: torch.Tensor  # (nev,) relative residual norms at exit
    converged: torch.Tensor      # (nev,) bool


def _hermitize(G):
    return 0.5 * (G + G.mH)


def _whiten(G, eps):
    """C with CᴴGC ≈ I on the well-conditioned subspace of the
    Hermitian PSD Gram G (..., n, n), dropping directions with eigenvalue
    below ``eps * max`` (per matrix). Dropped directions become zero
    columns; returns (C, good_mask)."""
    w, V = jacobi_eigh(_hermitize(G))
    wmax = torch.clamp(w.abs().amax(-1, keepdim=True),
                       min=torch.finfo(w.dtype).tiny)
    good = w > eps * wmax
    inv = torch.where(good, torch.rsqrt(torch.where(good, w, 1.0)), 0.0)
    return V * inv[..., None, :].to(V.dtype), good


def _chol_rows(G, big, whole: bool):
    """Cholesky factor of G (..., n, n) with failed rows rebuilt as huge
    decoupled diagonals (``big`` (..., 1) per matrix), which zeroes those
    directions in L⁻¹; returns (L, ok_rows). ``cholesky_ex``'s ``info``
    names the first failed pivot: with ``whole`` every row of that
    matrix fails, else the rows from that pivot on. Rows with non-finite
    entries fail too."""
    L, info = torch.linalg.cholesky_ex(G)
    info = info[..., None]
    if whole:
        ok = info == 0
    else:
        rows = torch.arange(G.shape[-1], device=G.device)
        ok = (info == 0) | (rows < info - 1)
    ok = ok & torch.isfinite(torch.view_as_real(L)).all(dim=-1).all(dim=-1)
    L = torch.where(ok[..., None], L, 0.0)
    L = L + torch.diag_embed((~ok).to(big.dtype) * big).to(G.dtype)
    return L, ok


def _whiten_chol(G, eps):
    """Cholesky-based whitening — same contract as :func:`_whiten`.

    δ-regularized chol(G + δI), δ = 20·eps·max(diag) per matrix:
    directions with Gram eigenvalue ≤ δ come out damped and are flagged
    by the whitened M-norm diag(CᴴGC) = 1 − δ‖C[:, i]‖² < 1/2, then a
    second (CholeskyQR2) pass re-measures the whitened Gram from the
    ORIGINAL G so amplified noise directions drop out (see the reference
    docstring for the measured failures each step prevents).

    A failed pivot of the first factorization drops every direction, as
    the reference's JAX Cholesky does (an all-NaN factor): G + δI is then
    no Gram of the basis (the recombined MX/MP have drifted from M X,
    M P), LOBPCG's whiteout guard freezes the block, and the next segment
    refresh recomputes AX/MX/AP/MP. Keeping the rows above the pivot went
    on iterating on the drifted state until its residuals read as
    converged (config 3's degenerate k 1: 13 iterations, 1e-3 off). A
    failed pivot of the second factorization, of G₂ ≈ I, is an amplified
    noise direction, and only it and the rows after it drop, as the
    reference's comment on that pass has it; dropping the whole block
    there froze config 1's k 1 (SQR n=16 p=4) from its 2nd iteration to
    its stagnation stop at 32, where the reference takes 4."""
    G = _hermitize(G)
    rdtype = G.real.dtype
    n = G.shape[-1]
    fi = torch.finfo(rdtype)
    dmax = torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1).real
                       .amax(-1, keepdim=True), min=fi.tiny)   # (..., 1)
    delta = 20.0 * eps * dmax
    eye = torch.eye(n, dtype=G.dtype, device=G.device).expand(G.shape)
    big = dmax / fi.eps
    L, fin = _chol_rows(G + delta[..., None] * eye, big, whole=True)
    Cm = torch.linalg.solve_triangular(L, eye, upper=False)   # L⁻¹
    mnorm = 1.0 - delta * (Cm.abs() ** 2).sum(dim=-1)
    good = (mnorm > 0.5) & fin
    # Dropped directions become ZERO columns (their 1/√δ-scaled entries
    # would otherwise swamp H and cost the Jacobi RR its small values).
    Cm = Cm * good[..., None].to(Cm.dtype)
    G2 = Cm @ G @ Cm.mH
    d2 = torch.diagonal(G2, dim1=-2, dim2=-1).real
    good = good & (d2 > 0.5)
    gm = good.to(rdtype)
    G2 = (G2 * (gm[..., :, None] * gm[..., None, :]).to(G2.dtype)
          + torch.diag_embed(1.0 - gm).to(G2.dtype))
    L2, fin2 = _chol_rows(_hermitize(G2), big, whole=False)
    good = good & fin2
    Cm2 = torch.linalg.solve_triangular(L2, eye, upper=False) @ Cm
    Cm2 = Cm2 * good[..., None].to(Cm2.dtype)
    return Cm2.mH, good


def _gram(U, V):
    """G[..., i, j] = ⟨u_i, v_j⟩ for row blocks U, V (..., n, N). With a
    leading k axis a complex64 Gram is formed in complex128 and rounded
    back. A float32 GEMM's accumulation order follows the batch shape
    (cuBLAS picks its kernel and split by it), and LOBPCG's whitening
    amplifies the difference once the residuals near their floor: on the
    H100 config 3's k 15 took 15 iterations in a batch of 16 k and 13
    alone, and a one-pass strided-batched GEMM over config 4's 98,304
    columns raised its nudged Γ's float32 floor 4–5× (32 iterations
    against 18 alone). In complex128 both take what they take alone."""
    if U.ndim > 2 and U.dtype == torch.complex64:
        w = torch.complex128
        return (U.to(w).conj() @ V.to(w).mT).to(U.dtype)
    return U.conj() @ V.mT


def lobpcg(A: Callable, M: Optional[Callable], X0: torch.Tensor, nev: int,
           maxiter: int = 200, tol: float = 1e-6,
           precond: Optional[Callable] = None,
           AM: Optional[Callable] = None,
           scale_floor: float = 3e-2,
           kernel_project: Optional[Callable] = None,
           rr_tol: Optional[float] = None,
           generator: Optional[torch.Generator] = None,
           batched: bool = False,
           reduce: Optional[Callable] = None) -> LobpcgResult:
    """LOBPCG on the Hermitian pencil (A, M) — see module docstring.

    ``X0``: (m, *dof_shape) complex start block, m >= nev; with
    ``batched``, (nk, m, *dof_shape), one pencil per k (a start block
    shared by all k: ``X0.expand(nk, *X0.shape)``), and every operator
    takes and returns (nk, rows, *dof_shape) blocks. ``M=None`` is
    the identity mass. ``AM(X)`` returns (A X, M X) in one call (e.g. the
    fused Nédélec element kernel); it serves every place that needs
    both, and separate ``A``/``M`` calls serve the rest. Relative residual ‖Ax − λMx‖ / scale with
    scale = max(|λ_j|, ``scale_floor``·max|λ|, 1e-3) (max over the k's
    own rows).
    ``kernel_project(X)`` returns the kernel component of each row; it
    is subtracted from the updated X and P every iteration.
    ``rr_tol``: looser Rutishauser stop for the Rayleigh–Ritz eigh (None
    keeps machine precision). ``generator``: source of the noise that
    reseeds zero rows of ``X0`` (default: seeded with ``RESEED`` on
    X0's device; every k draws the same noise, as under the reference's
    vmap).
    ``reduce(t)``: sums a tensor over a process group in place (e.g.
    ``KMesh.all_reduce_``) for a block whose dof axis is split over the
    group's ranks (domain decomposition: every rank holds its slab of
    each row and runs this call with the others). Every sum over the dof
    axis goes through it (the Grams, the row norms, the Rayleigh quotients
    and the residual norms), so the small dense work that follows runs
    alike on every rank from the same input. A reseeded zero row then
    takes noise of its slab's size on each rank, not the unsplit
    block's.
    """
    lead = tuple(X0.shape[:1]) if batched else ()
    nk = X0.shape[0] if batched else 1
    m = X0.shape[len(lead)]
    dof_shape = tuple(X0.shape[len(lead) + 1:])
    if nev > m:
        raise ValueError(f"nev={nev} exceeds block size m={m}")
    cdtype = X0.dtype
    rdtype = cdtype.to_real()
    fi = torch.finfo(rdtype)
    dev = X0.device
    eps = 50.0 * fi.eps
    floor = scale_floor

    def flat(op):
        return lambda X: op(X.reshape(X.shape[:-1] + dof_shape)).reshape(
            X.shape[:-1] + (-1,))

    def flat2(op):
        def f(X):
            a, b = op(X.reshape(X.shape[:-1] + dof_shape))
            return (a.reshape(X.shape[:-1] + (-1,)),
                    b.reshape(X.shape[:-1] + (-1,)))
        return f

    Af = flat(A)
    Mf = flat(M) if M is not None else (lambda X: X)
    AMf = flat2(AM) if AM is not None else (lambda X: (Af(X), Mf(X)))
    Pf = flat(precond) if precond is not None else None
    Kf = flat(kernel_project) if kernel_project is not None else None

    def rsum(t):
        # A sum over the dof axis: completed over the group's slabs.
        return t if reduce is None else reduce(t)

    def gram(U, V):
        return rsum(_gram(U, V))

    def dots(U, V):       # ⟨u_i, v_i⟩ per row
        return rsum((U.conj() * V).sum(dim=-1)).real

    def norms(U):
        if reduce is None:
            return torch.linalg.vector_norm(U, dim=-1)
        return torch.sqrt(rsum(torch.linalg.vector_norm(U, dim=-1) ** 2))

    X = X0.reshape(lead + (m, -1)).to(cdtype)
    # Reseed degenerate (zero) warm-start rows: zero rows are ABSORBING
    # under the LOBPCG update (R = 0 ⇒ W = 0). The max(·, 1) floor makes
    # an all-zero block reseed every row.
    rn = norms(X)
    bad0 = rn < 1e-6 * torch.clamp(rn.amax(-1, keepdim=True), min=1.0)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(RESEED)
    fr = torch.randn((2, m, X.shape[-1]), generator=generator, dtype=rdtype,
                     device=dev)
    X = torch.where(bad0[..., None], torch.complex(fr[0], fr[1]), X)

    C, _ = _whiten(gram(X, Mf(X)), eps)
    X = C.mT @ X                     # M-orthonormal start block
    P = torch.zeros_like(X)
    res = torch.full(lead + (m,), float("inf"), dtype=rdtype, device=dev)

    def rownorm(U, MU):
        s = torch.rsqrt(torch.clamp(dots(U, MU), min=fi.tiny))
        # Exact-zero (locked) rows stay zero.
        nz = (norms(U) > 0).to(rdtype)
        return (s * nz)[..., None]

    def body(X, AX, MX, P, AP, MP):
        # Ritz values of the current (M-orthonormal) X.
        lam = dots(X, AX)
        R = AX - MX * lam[..., None]
        alam = lam.abs()
        scale = torch.maximum(alam, torch.clamp(
            floor * alam.amax(-1, keepdim=True), min=1e-3))
        rel = norms(R) / scale
        # A whitening-dropped (all-zero) row must read as unconverged.
        xnorm = dots(X, MX)
        rel = torch.where(xnorm > 0.5, rel, float("inf"))
        conv = rel < tol

        W = Pf(R) if Pf is not None else R
        # M-project out span(X):  w_i -= Σ_j ⟨x_j, M w_i⟩ x_j.
        W = W - gram(W, MX).conj() @ X
        # Soft locking: zero converged rows of W and P.
        mask = (~conv)[..., None].to(rdtype)
        W = W * mask
        P, AP, MP = P * mask, AP * mask, MP * mask
        AW, MW = AMf(W)
        # Unit M-norm W and P rows keep the S-basis Gram well scaled.
        sw, sp_ = rownorm(W, MW), rownorm(P, MP)
        W, AW, MW = W * sw, AW * sw, MW * sw
        P, AP, MP = P * sp_, AP * sp_, MP * sp_

        S = torch.cat([X, W, P], dim=-2)                  # (3m, N)
        AS = torch.cat([AX, AW, AP], dim=-2)
        MS = torch.cat([MX, MW, MP], dim=-2)
        C, good = _whiten_chol(gram(S, MS), eps)         # (3m, 3m)
        H = _hermitize(C.mH @ gram(S, AS) @ C)
        # Dropped directions: Ritz values above the spectrum, moderately
        # (a Gershgorin bound keeps the matrix scale sane).
        big = 2.0 * H.abs().sum(dim=-1).amax(-1, keepdim=True) + 1.0
        H = H + torch.diag_embed((~good).to(rdtype) * big).to(H.dtype)
        theta, Y = jacobi_eigh(H, rel_tol=rr_tol)         # ascending
        Ym = C @ Y[..., :m]                               # coeffs of new X
        Xn, AXn, MXn = Ym.mT @ S, Ym.mT @ AS, Ym.mT @ MS
        # Implicit new P: W/P components of the update (X block zeroed).
        Yp = Ym.clone()
        Yp[..., :m, :] = 0
        Pn, APn, MPn = Yp.mT @ S, Yp.mT @ AS, Yp.mT @ MS
        # Whiteout guard: if whitening dropped EVERY direction the update
        # is zero (absorbing); freeze the block instead.
        ok = good.any(dim=-1)[..., None, None]
        Xn, AXn, MXn = (torch.where(ok, a, b) for a, b in
                        ((Xn, X), (AXn, AX), (MXn, MX)))
        Pn, APn, MPn = (torch.where(ok, a, b) for a, b in
                        ((Pn, P), (APn, AP), (MPn, MP)))
        if Kf is not None:
            # One 2m-row projector call for X and P (A annihilates the
            # removed kernel component, so AX needs no correction).
            K2 = Kf(torch.cat([Xn, Pn], dim=-2))
            M2 = Mf(K2)
            Xn, MXn = Xn - K2[..., :m, :], MXn - M2[..., :m, :]
            Pn, MPn = Pn - K2[..., m:, :], MPn - M2[..., m:, :]
        # RANK-AWARE done: the nev LOWEST healthy Ritz rows must be
        # converged, not rows [:nev] (warm starts arrive unsorted).
        lam_eff = torch.where(xnorm > 0.5, lam, float("inf"))
        low = torch.argsort(lam_eff, dim=-1, stable=True)[..., :nev]
        done = (torch.gather(rel, -1, low) < tol).all(dim=-1)
        # Degeneration stop: fewer than nev healthy rows cannot complete.
        done = done | ((xnorm > 0.5).sum(dim=-1) < nev)
        return (Xn, AXn, MXn, Pn, APn, MPn), rel, done

    def tracked(res):
        # Worst of the nev BEST finite rows (an inf sentinel of a
        # dropped row must not disarm the stagnation stop).
        resh = torch.where(torch.isfinite(res), torch.clamp(res, max=1e6),
                           1e6)
        return torch.sort(resh, dim=-1).values[..., :nev].amax(dim=-1)

    def freeze(keep, old, new):
        # A k that is done keeps its state: where(done) per k.
        return tuple(torch.where(keep, a, b) for a, b in zip(old, new))

    # ``done``: the device flags, (nk,) batched or 0-d; ``done_h``: their
    # host copy, read once per iteration. While no k is done nothing is
    # frozen (with one k, done ends the loop).
    its = np.zeros(nk, np.int64)
    done_h = np.zeros(nk, bool)
    done = state = None
    it, seg = 0, 16
    while it < maxiter and not done_h.all():
        # Segment refresh (also the first AX/MX/AP/MP): they are formed
        # by recombination inside a segment; recomputing them between
        # segments kills the drift.
        fresh = (X, *AMf(X), P, *AMf(P))
        state = (freeze(done[..., None, None], state, fresh)
                 if done_h.any() else fresh)
        res0 = tracked(res)
        it0 = it
        while it < maxiter and it - it0 < seg and not done_h.all():
            new, rel, done_t = body(*state)
            if done_h.any():
                state = freeze(done[..., None, None], state, new)
                res = torch.where(done[..., None], res, rel)
                done = done | done_t
            else:
                state, res, done = new, rel, done_t
            X, P = state[0], state[3]
            its[~done_h] += 1
            it += 1
            # The one host read per iteration: the convergence flags.
            done_h = done.cpu().numpy().reshape(nk)
        # Stagnation stop: a whole segment without progress on the worst
        # tracked residual means a numerical floor.
        if not done_h.all():
            floored = tracked(res) > 0.97 * res0
            done = done | floored if done_h.any() else floored
            done_h = done.cpu().numpy().reshape(nk)

    X, AX, MX = state[0], state[1], state[2]
    # Final Ritz data on the exit state (X M-orthonormal up to roundoff).
    nrm = torch.clamp(dots(X, MX), min=fi.tiny)
    lam = dots(X, AX) / nrm
    R = AX - MX * lam[..., None]
    alam = lam.abs()
    rel = norms(R) / torch.maximum(
        alam, torch.clamp(floor * alam.amax(-1, keepdim=True), min=1e-3))
    # Zero (whitening-dropped) rows: unconverged AND sorted last.
    healthy = nrm > 0.5 * nrm.amax(-1, keepdim=True)
    rel = torch.where(healthy, rel, float("inf"))
    lam = torch.where(healthy, lam, float("inf"))
    lam, order = torch.sort(lam, dim=-1, stable=True)
    rel = torch.gather(rel, -1, order)
    Xout = torch.gather(X, -2, order[..., None].expand(X.shape))
    # Keep inf sentinels out of caller outputs; converged=False flags them.
    finite = torch.isfinite(lam)
    lam_top = torch.where(finite, lam, -float("inf")).amax(-1, keepdim=True)
    lam_top = torch.where(torch.isfinite(lam_top), lam_top, 0.0)
    lam = torch.where(finite, lam, lam_top)
    rel = torch.where(torch.isfinite(rel), torch.clamp(rel, max=1e6), 1e6)
    return LobpcgResult(eigenvalues=lam[..., :nev],
                        eigenvectors=Xout.reshape(lead + (m,) + dof_shape),
                        iterations=its if batched else int(its[0]),
                        residual_norms=rel[..., :nev],
                        converged=rel[..., :nev] < tol)
