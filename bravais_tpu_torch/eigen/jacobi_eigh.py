"""Batched Hermitian eigensolver by cyclic (round-robin) Jacobi.

Port of ``bravais_tpu/eigen/jacobi_eigh.py``. It serves the LOBPCG
Rayleigh–Ritz, where a general float32 eigensolver loses the LOW
eigenvalues of graded matrices (a Ritz matrix whose W block carries
Rayleigh quotients up to λ_max(A)); two-sided Jacobi keeps the
Demmel–Veselić relative accuracy because rotations compare entries
locally.

Algorithm: sweeps of n−1 round-robin rounds (circle-method tournament);
each round applies n/2 disjoint complex Givens rotations G, H ← Gᴴ H G,
V ← V G, then re-hermitizes H. Before each sweep the Rutishauser test
``max |H_ij|² / |H_ii H_jj| ≤ rel_tol²`` stops a converged matrix; the
sweep count is capped at ``sweeps``.

``jacobi_eigh`` dispatches on where the tensor lies: a CPU tensor runs
the plain torch version below; a CUDA complex64 tensor with n ≤ 64 runs
the hand-written kernel (``eigen/jacobi_cuda.py``,
``csrc/jacobi_eigh.cu``); any other CUDA input raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["jacobi_eigh", "jacobi_eigh_plain", "plain_sweeps_run",
           "round_robin_pairs"]


@lru_cache(maxsize=None)
def round_robin_pairs(n: int) -> tuple:
    """(p, q), each (n-1, n/2) int64: per round, the pairs of the
    circle-method tournament with p < q (the reference's
    ``_round_robin_schedule``). n must be even."""
    if n % 2:
        raise ValueError(f"round-robin schedule needs even n, got {n}")
    others = list(range(1, n))
    top, bot = [], []
    for r in range(n - 1):
        lst = [0] + others[r:] + others[:r]
        top.append(lst[: n // 2])
        bot.append(lst[n // 2:][::-1])
    top, bot = np.asarray(top), np.asarray(bot)
    return np.minimum(top, bot), np.maximum(top, bot)


def pad_odd(H: torch.Tensor) -> torch.Tensor:
    """Pad odd n with a DECOUPLED row/col (zero off-diagonals, so every
    rotation touching it is the identity) whose diagonal exceeds the
    spectrum (Gershgorin): it sorts last and is sliced off."""
    n0 = H.shape[-1]
    big = 2.0 * H.abs().sum(dim=-1).amax() + 1.0
    Hp = H.new_zeros(H.shape[:-2] + (n0 + 1, n0 + 1))
    Hp[..., :n0, :n0] = H
    Hp[..., n0, n0] = big
    return Hp


def sort_pairs(w: torch.Tensor, V: torch.Tensor, n0: int):
    """Ascending (stable) order of the eigenpairs, pad dropped."""
    w, order = torch.sort(w, dim=-1, stable=True)
    V = torch.gather(V, -1, order.unsqueeze(-2).expand(V.shape))
    return w[..., :n0], V[..., :n0, :n0]


def jacobi_eigh_plain(H: torch.Tensor, sweeps: int = 24,
                      rel_tol: float | None = None):
    """Eigendecomposition of Hermitian (..., n, n) in plain torch ops.

    Returns (w, V): w (..., n) real ascending, V (..., n, n) with columns
    the eigenvectors, H ≈ V diag(w) Vᴴ. Each matrix of a batch stops on
    its own Rutishauser test (``rel_tol``; default machine eps) or at
    ``sweeps`` sweeps. One host read of the convergence flags per sweep.
    """
    return _plain(H, sweeps, rel_tol)[:2]


def plain_sweeps_run(H: torch.Tensor, sweeps: int = 24,
                     rel_tol: float | None = None) -> torch.Tensor:
    """The sweeps the plain version runs on each matrix of ``H``
    (..., n, n) before its Rutishauser stop (int32, ``H.shape[:-2]``):
    the counterpart of ``jacobi_cuda.sweeps_run``."""
    return _plain(H, sweeps, rel_tol)[2]


def _plain(H: torch.Tensor, sweeps: int, rel_tol: float | None):
    """(w, V, sweeps run per matrix) of the plain version."""
    n0 = H.shape[-1]
    batch_shape = H.shape[:-2]
    rdtype = H.real.dtype
    fi = torch.finfo(rdtype)
    if n0 % 2:
        H = pad_odd(H)
    n = H.shape[-1]
    H = H.reshape(-1, n, n).clone()
    nb = H.shape[0]
    V = torch.eye(n, dtype=H.dtype, device=H.device).expand(nb, n, n)
    V = V.clone()
    P, Q = (torch.as_tensor(a, device=H.device)
            for a in round_robin_pairs(n))
    eps2 = (rel_tol if rel_tol is not None else fi.eps) ** 2
    tiny = fi.tiny * 100
    offmask = ~torch.eye(n, dtype=torch.bool, device=H.device)
    nsw = torch.zeros(nb, dtype=torch.int32, device=H.device)
    for s in range(sweeps + 1):
        d = torch.diagonal(H, dim1=-2, dim2=-1).abs()
        dd = torch.clamp(d[:, :, None] * d[:, None, :], min=fi.tiny * 1e6)
        ratio = torch.where(offmask, H.abs() ** 2 / dd, 0.0)
        active = ratio.amax(dim=(-2, -1)) > eps2             # (nb,)
        if s == sweeps or not bool(active.any()):
            break
        nsw += active.to(torch.int32)
        for r in range(n - 1):
            p, q = P[r], Q[r]
            app = H[:, p, p].real
            aqq = H[:, q, q].real
            apq = H[:, p, q]
            absa = apq.abs()
            safe = (absa > tiny) & active[:, None]
            one = torch.ones_like(absa)
            phase = torch.where(safe, apq / torch.where(safe, absa, one),
                                torch.ones_like(apq))
            tau = (aqq - app) / (2.0 * torch.where(safe, absa, one))
            # sign(0) must be +1 here (τ=0 ⇒ the full 45° rotation).
            sgn = torch.where(tau >= 0, 1.0, -1.0).to(rdtype)
            t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(safe, t, 0.0)
            c = torch.rsqrt(1.0 + t * t)
            sn = (t * c) * phase                                 # complex sine
            # H ← Gᴴ H on rows p, q
            Hp_, Hq_ = H[:, p, :], H[:, q, :]
            H[:, p, :] = c[..., None] * Hp_ - sn[..., None] * Hq_
            H[:, q, :] = sn.conj()[..., None] * Hp_ + c[..., None] * Hq_
            # H ← H G and V ← V G on columns p, q
            for M in (H, V):
                Mp, Mq = M[:, :, p], M[:, :, q]
                M[:, :, p] = c[:, None, :] * Mp - sn.conj()[:, None, :] * Mq
                M[:, :, q] = sn[:, None, :] * Mp + c[:, None, :] * Mq
            H = 0.5 * (H + H.mH)
    w = torch.diagonal(H, dim1=-2, dim2=-1).real
    w, V = sort_pairs(w, V, n0)
    return (w.reshape(batch_shape + (n0,)), V.reshape(batch_shape + (n0, n0)),
            nsw.reshape(batch_shape))


def jacobi_eigh(H: torch.Tensor, sweeps: int = 24,
                rel_tol: float | None = None):
    """Eigendecomposition of Hermitian (..., n, n): (w ascending, V).

    ``rel_tol``: optional looser Rutishauser stop (default machine eps).
    Subspace-iterative callers (the LOBPCG Rayleigh–Ritz) can stop early;
    exact-factorization callers (whitening) keep the default.
    """
    if H.device.type == "cpu":
        return jacobi_eigh_plain(H, sweeps, rel_tol)
    from bravais_tpu_torch.eigen import jacobi_cuda
    if H.is_cuda and H.dtype == torch.complex64 \
            and H.shape[-1] <= jacobi_cuda.MAX_N:
        return jacobi_cuda.jacobi_eigh_cuda(H, sweeps, rel_tol)
    raise ValueError(
        f"jacobi_eigh: no kernel for {H.dtype} n={H.shape[-1]} on "
        f"{H.device} (the CUDA kernel takes complex64 with n <= "
        f"{jacobi_cuda.MAX_N})")
