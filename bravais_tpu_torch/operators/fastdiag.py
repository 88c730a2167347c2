"""Fast block-diagonalization of quasi-periodic operators (twisted DFT).

Port of ``bravais_tpu/operators/fastdiag.py``. Every quasi-periodic
operator of the framework (curl-curl A, mass M, discrete gradient G) is
invariant under element translations; on the n₁×n₂×n₃ element grid it
is block-circulant with a nearest-neighbour stencil

    (A u)[e] = Σ_{δ ∈ {-1,0,1}ᵈ} S_δ u[e+δ],

and the twisted DFT û[m] = Σ_e e^{-i θ_m·e} u[e] with
θ_{m,i} = (k·a_i + 2π m_i)/n_i block-diagonalizes it exactly:

    Â(k)_m = Σ_δ S_δ e^{i θ_m·δ}        (one D×D block per frequency m).

Three halves:

* host (NumPy f64): stencil extraction from the k=0 host twins, with a
  disk cache (``_disk_cached``, ``extract_stencil``,
  ``extract_stencil_rect``, ``FastDiag.add_stencil``);
* device (torch complex64): ``blocks``, ``to_blocks``, ``from_blocks``,
  the block solver ``solver`` and the block apply ``matvec`` (a
  cross-check of the stencils) on the FastDiag's ``device``;
* host refine helpers (f64): ``blocks_np``, ``blocks_np_multi``,
  ``candidate_blocks``, the spectral block solver ``solver_np`` (and its
  one-shot ``solve_np``) and the exact block refine of pencils without a
  nullspace (scalar Helmholtz) ``spectral_refine_np``.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

__all__ = ["FastDiag", "extract_stencil", "extract_stencil_rect"]

def _disk_cached(key_obj, compute):
    """Load/store a numpy array under a content-hash key in the repo's
    stencil cache (BRAVAIS_STENCIL_CACHE overrides; empty string
    disables). Atomic write; any IO failure falls back to computing.
    Keys are namespaced with "torch" so this package and the JAX
    reference never read each other's files."""
    import hashlib
    import os
    import pickle

    cdir = os.environ.get(
        "BRAVAIS_STENCIL_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            ".stencil_cache"))
    if not cdir:
        return compute()
    try:
        key = hashlib.sha256(pickle.dumps(
            ("torch",) + tuple(key_obj), protocol=4)).hexdigest()[:32]
        path = os.path.join(cdir, "torch_" + key + ".npy")
        if os.path.exists(path):
            return np.load(path)
        arr = compute()
        os.makedirs(cdir, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)
        return arr
    except (OSError, pickle.PicklingError):
        return compute()


def extract_stencil_rect(apply0: Callable, ncomp_out: int, ncomp_in: int,
                         shape: Sequence[int], p: int) -> np.ndarray:
    """Rectangular variant of :func:`extract_stencil` for operators
    between two dof layouts on the same element grid (e.g. the discrete
    gradient G: scalar H1 → 3-component ND). Returns
    (3ᵈ, ncomp_out·pᵈ, ncomp_in·pᵈ)."""
    shape = tuple(int(n) for n in shape)
    d = len(shape)
    if any(n < 3 for n in shape):
        raise ValueError(f"FastDiag needs n_i >= 3 per axis, got {shape}")
    e0 = tuple(n // 2 for n in shape)
    offsets = list(itertools.product((-1, 0, 1), repeat=d))
    Dout = ncomp_out * p ** d
    Din = ncomp_in * p ** d
    out = np.zeros((len(offsets), Dout, Din), np.complex128)
    N = tuple(n * p for n in shape)
    col = 0
    for c in range(ncomp_in):
        for loc in itertools.product(range(p), repeat=d):
            u = np.zeros((ncomp_in,) + N, np.complex128)
            u[(c,) + tuple(e0[i] * p + loc[i] for i in range(d))] = 1.0
            y = apply0(u if ncomp_in > 1 else u[0])
            y = np.asarray(y).reshape((ncomp_out,) + N)
            for s, off in enumerate(offsets):
                sl = tuple(slice((e0[i] + off[i]) * p,
                                 (e0[i] + off[i]) * p + p)
                           for i in range(d))
                out[len(offsets) - 1 - s, :, col] = \
                    y[(slice(None),) + sl].reshape(Dout)
            col += 1
    if np.max(np.abs(out.imag)) <= 1e-12 * max(np.max(np.abs(out)), 1.0):
        return out.real.copy()
    return out


def extract_stencil(apply0: Callable, ncomp: int, shape: Sequence[int],
                    p: int) -> np.ndarray:
    """Extract the (3ᵈ, D, D) neighbour-coupling blocks of a
    quasi-periodic operator from its k=0 host apply.

    ``apply0``: u -> A(k=0) u on (ncomp, *N) fields ((*N,) if ncomp==1),
    N_i = n_i p. Probes every element-local basis dof of an interior
    element; the response at elements e0+δ is column (c, l) of S_δ.
    """
    shape = tuple(int(n) for n in shape)
    d = len(shape)
    if any(n < 3 for n in shape):
        raise ValueError(f"FastDiag needs n_i >= 3 per axis, got {shape}")
    e0 = tuple(n // 2 for n in shape)
    offsets = list(itertools.product((-1, 0, 1), repeat=d))
    D = ncomp * p ** d
    out = np.zeros((len(offsets), D, D), np.float64)
    N = tuple(n * p for n in shape)
    col = 0
    for c in range(ncomp):
        for loc in itertools.product(range(p), repeat=d):
            u = np.zeros((ncomp,) + N, np.complex128)
            u[(c,) + tuple(e0[i] * p + loc[i] for i in range(d))] = 1.0
            y = apply0(u if ncomp > 1 else u[0])
            y = np.asarray(y).reshape((ncomp,) + N)
            if np.max(np.abs(y.imag)) > 1e-12 * max(np.max(np.abs(y)), 1.0):
                raise ValueError("operator is not real at k=0 — not a "
                                 "quasi-periodic stencil operator")
            for s, off in enumerate(offsets):
                # y[e0+off] = S_{-off} u[e0]  ⇒  store at index of -off,
                # which is the reversed position in the product order.
                sl = tuple(slice((e0[i] + off[i]) * p,
                                 (e0[i] + off[i]) * p + p)
                           for i in range(d))
                out[len(offsets) - 1 - s, :, col] = \
                    y[(slice(None),) + sl].real.reshape(D)
            col += 1
    return out


class FastDiag:
    """Twisted-DFT block-diagonal factory for one dof layout.

    Holds the k=0 stencils as f64 numpy arrays (``stencils``) and builds
    complex64 blocks on ``device``; the float32 device copy of each
    stencil combination is made once and kept.
    """

    def __init__(self, shape: Sequence[int], p: int, ncomp: int,
                 A_rows: np.ndarray, device, dtype=torch.complex64):
        self.shape = tuple(int(n) for n in shape)
        self.d = len(self.shape)
        self.p = int(p)
        self.ncomp = int(ncomp)
        self.A_rows = np.asarray(A_rows, np.float64)  # rows a_i
        self.device = torch.device(device)
        self.dtype = dtype
        self.rdtype = dtype.to_real()
        self.D = ncomp * p ** self.d
        self.nblocks = int(np.prod(self.shape))
        self.offsets = np.asarray(
            list(itertools.product((-1, 0, 1), repeat=self.d)), np.int64)
        self.stencils: dict[str, np.ndarray] = {}
        self._dev_stencils: dict = {}
        self._multi_cache: dict = {}

    @property
    def field_shape(self) -> Tuple[int, ...]:
        N = tuple(n * self.p for n in self.shape)
        return ((self.ncomp,) + N) if self.ncomp > 1 else N

    def add_stencil(self, name: str, apply0: Callable,
                    cache_key=None, extract_shape=None) -> "FastDiag":
        """Extract (or load) the k=0 stencil. ``cache_key``: any
        picklable object fully determining the stencil (operator
        coefficients, grid, order) — enables the disk cache.
        ``extract_shape``: probe on a SMALLER grid than the production
        one — ``apply0`` must then be the operator twin on a
        ``PeriodicGrid.stencil_twin`` grid (same element Jacobian,
        element-invariant coefficients), whose stencils are identical
        at a fraction of the probing cost."""
        shp = (tuple(int(n) for n in extract_shape)
               if extract_shape is not None else self.shape)

        def compute():
            return extract_stencil(apply0, self.ncomp, shp, self.p)
        self.stencils[name] = (_disk_cached(
            ("stencil", name, self.shape, self.p, self.ncomp,
             self.A_rows.tobytes(), cache_key), compute)
            if cache_key is not None else compute())
        return self

    # -- device half -----------------------------------------------------

    def _theta(self, k) -> list:
        """Per-axis twisted frequencies θ_{m,i} = (k·a_i + 2πm)/n_i, in
        the real working precision (as the reference computes them): d
        tensors (n_i,) at one k (d,), (nk, n_i) for a k table (nk, d)."""
        A = torch.as_tensor(self.A_rows, dtype=self.rdtype,
                            device=self.device)
        kt = torch.as_tensor(np.asarray(k, np.float64), dtype=self.rdtype,
                             device=self.device)
        ka = A @ kt if kt.ndim == 1 else kt @ A.mT
        return [(ka[..., i, None] + 2.0 * math.pi * torch.arange(
            n, dtype=self.rdtype, device=self.device)) / n
            for i, n in enumerate(self.shape)]

    def _fwd_mats(self, theta) -> list:
        """F_i[m, e] = e^{-i θ_m e} (inverse is Fᴴ/n); (nk, n, n) with a
        leading k axis on θ."""
        out = []
        for i, n in enumerate(self.shape):
            e = torch.arange(n, dtype=self.rdtype, device=self.device)
            ang = -theta[i][..., :, None] * e[None, :]
            out.append(torch.polar(torch.ones_like(ang), ang))
        return out

    def _stencil_dev(self, terms) -> torch.Tensor:
        """(flattened float stencil on the device, block shape), made
        once per combination of terms."""
        key = tuple((nm, float(c)) for nm, c in terms)
        if key not in self._dev_stencils:
            Sh = sum(float(c) * self.stencils[nm] for nm, c in terms)
            self._dev_stencils[key] = (
                torch.as_tensor(Sh.reshape(Sh.shape[0], -1),
                                dtype=self.rdtype, device=self.device),
                Sh.shape[1:])
        return self._dev_stencils[key]

    def blocks(self, terms: Sequence[Tuple[str, float]], k) -> torch.Tensor:
        """(nblocks, D, Dc) complex blocks of Σ coeff·stencil at k;
        (nk, nblocks, D, Dc) for a k table (nk, d)."""
        theta = self._theta(k)
        lead = tuple(theta[0].shape[:-1])
        # per-δ phase  w[s, b] = Π_i e^{i θ_{m_i} δ_i}
        w = None
        for i in range(self.d):
            zi = torch.polar(torch.ones_like(theta[i]), theta[i])
            di = torch.as_tensor(self.offsets[:, i], device=self.device)
            zi, one = zi[..., None, :], torch.ones_like(zi)[..., None, :]
            wi = torch.where((di == 1)[:, None], zi,
                             torch.where((di == -1)[:, None], zi.conj(),
                                         one))                  # (..., S, n_i)
            w = wi if w is None else (w[..., None] * wi.reshape(
                wi.shape[:-1] + (1,) * (w.ndim - len(lead) - 1)
                + wi.shape[-1:]))
        w = w.reshape(lead + (w.shape[len(lead)], -1))         # (..., S, B)
        Sf, bshape = self._stencil_dev(terms)
        # Real stencils: two real GEMMs instead of a complex×real one.
        T = torch.complex(w.real.mT @ Sf, w.imag.mT @ Sf)
        return T.reshape(lead + (w.shape[-1],) + tuple(bshape))

    def to_blocks(self, u: torch.Tensor, F: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
        """Fields (L, *field_shape) → (L, nblocks, D) twisted-DFT
        coefficients. With k-batched ``F`` ((nk, n, n) each): fields
        (nk, L, *field_shape), or (L, *field_shape) shared by all k, →
        (nk, L, nblocks, D)."""
        d, p = self.d, self.p
        inter = tuple(x for n in self.shape for x in (n, p))
        if F[0].ndim == 2:
            L = u.shape[0]
            u = u.to(self.dtype).reshape((L, self.ncomp) + inter)
            for i in range(d):
                ax = 2 + 2 * i
                u = torch.movedim(torch.tensordot(F[i], u,
                                                  dims=([1], [ax])), 0, ax)
            perm = ([0] + [2 + 2 * i for i in range(d)] + [1]
                    + [3 + 2 * i for i in range(d)])
            return u.permute(perm).reshape(L, self.nblocks, self.D)
        nk = F[0].shape[0]
        L = u.shape[u.ndim - len(self.field_shape) - 1]
        u = u.to(self.dtype).reshape((-1, L, self.ncomp) + inter)
        u = u.expand((nk,) + u.shape[1:])
        for i in range(d):
            ax = 3 + 2 * i
            u = torch.movedim(u, ax, -1)
            # û[..., m] = Σ_e F[k, m, e] u[..., e], one GEMM per k.
            u = torch.movedim((u.reshape(nk, -1, u.shape[-1]) @ F[i].mT)
                              .reshape(u.shape), -1, ax)
        perm = ([0, 1] + [3 + 2 * i for i in range(d)] + [2]
                + [4 + 2 * i for i in range(d)])
        return u.permute(perm).reshape(nk, L, self.nblocks, self.D)

    def from_blocks(self, v: torch.Tensor, F: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
        """Inverse of :meth:`to_blocks`: (L, nblocks, D) → fields;
        (nk, L, nblocks, D) → (nk, L, *field_shape) with k-batched F."""
        d, p = self.d, self.p
        if F[0].ndim == 2:
            L = v.shape[0]
            v = v.reshape((L,) + tuple(self.shape) + (self.ncomp,)
                          + (p,) * d)
            perm = [0, d + 1] + [x for i in range(d)
                                 for x in (1 + i, d + 2 + i)]
            u = v.permute(perm)
            for i in range(d):
                ax = 2 + 2 * i
                Fi_inv = F[i].conj().T / self.shape[i]
                u = torch.movedim(torch.tensordot(Fi_inv, u,
                                                  dims=([1], [ax])), 0, ax)
            return u.reshape((L,) + self.field_shape)
        nk, L = v.shape[:2]
        v = v.reshape((nk, L) + tuple(self.shape) + (self.ncomp,) + (p,) * d)
        perm = [0, 1, d + 2] + [x for i in range(d)
                                for x in (2 + i, d + 3 + i)]
        u = v.permute(perm)
        for i in range(d):
            ax = 3 + 2 * i
            Fi_inv = F[i].conj().mT / self.shape[i]
            u = torch.movedim(u, ax, -1)
            u = torch.movedim((u.reshape(nk, -1, u.shape[-1]) @ Fi_inv.mT)
                              .reshape(u.shape), -1, ax)
        return u.reshape((nk, L) + self.field_shape)

    def solver(self, terms: Sequence[Tuple[str, float]], k,
               method: str = "lu") -> Callable:
        """u ↦ (Σ coeff·Op)⁻¹ u on blocks of fields (rows, *field_shape):
        twisted DFT → batched block inverse-matvec → inverse DFT. Build
        once per k, outside the LOBPCG loop. With a k table (nk, d) it
        solves k-batched blocks (nk, rows, *field_shape), one k per
        block, from (nk, nblocks, D, D) blocks factored in one call.

        ``method``: "lu" — the batched dense inverse (``torch.linalg.inv``;
        right for the well-conditioned shifted (A + sM) preconditioner);
        "eigh" — the batched Jacobi eigendecomposition (``jacobi_eigh``,
        on CUDA the hand-written kernel) with a spectral pseudo-inverse
        (eigenvalues ≤ 0 dropped): the deflation Laplacian's
        near-null block near Γ then errs only along eigendirections, and
        exact Γ gets a clean pseudo-inverse."""
        F = self._fwd_mats(self._theta(k))
        T = self.blocks(terms, k)
        if method == "eigh":
            from bravais_tpu_torch.eigen.jacobi_eigh import jacobi_eigh
            w, V = jacobi_eigh(T)
            good = w > 0.0
            winv = torch.where(good, 1.0 / torch.where(good, w, 1.0), 0.0)
            winv = winv.to(self.dtype)[..., None]
            VH = V.mH

            def inv_cols(vc):
                return V @ (winv * (VH @ vc))
        elif method == "lu":
            Tinv = torch.linalg.inv(T)

            def inv_cols(vc):
                return Tinv @ vc
        else:
            raise ValueError(f"method must be 'lu' or 'eigh', got {method!r}")

        def solve(u):
            v = self.to_blocks(u, F)               # ([nk,] L, B, D)
            x = inv_cols(v.movedim(-3, -1)).movedim(-1, -3)
            return self.from_blocks(x, F).reshape(u.shape)

        return solve

    def matvec(self, terms: Sequence[Tuple[str, float]], k) -> Callable:
        """u ↦ (Σ coeff·Op) u through the block factorization, on blocks
        of fields (rows, *field_shape), or k-batched (nk, rows, ...) with
        a k table: a cross-check of the stencils against the operator's
        own apply."""
        F = self._fwd_mats(self._theta(k))
        T = self.blocks(terms, k)

        def mv(u):
            v = self.to_blocks(u, F)               # ([nk,] L, B, D)
            y = (T @ v.movedim(-3, -1)).movedim(-1, -3)
            return self.from_blocks(y, F).reshape(u.shape)

        return mv

    # -- host (NumPy, f64) refine helpers ---------------------------------

    def _phase_weights_np(self, k: np.ndarray):
        """Twisted phase angles θ_i and the per-offset weight matrix
        w (noffsets, nblocks) at k — the single host-side definition of
        the quasi-periodic phase convention."""
        k = np.asarray(k, np.float64)
        theta = [(self.A_rows[i] @ k + 2.0 * np.pi * np.arange(n)) / n
                 for i, n in enumerate(self.shape)]
        w = None
        for i in range(self.d):
            wi = np.exp(1j * theta[i])[None, :] ** \
                self.offsets[:, i].astype(np.float64)[:, None]
            w = wi if w is None else np.einsum("s...,sn->s...n", w, wi)
        return theta, w.reshape(w.shape[0], -1)

    def blocks_np(self, terms: Sequence[Tuple[str, float]],
                  k: np.ndarray, idx=None) -> np.ndarray:
        """f64 host twin of :meth:`blocks`, optionally restricted to the
        flat block indices ``idx``. Rectangular stencils ("G") are
        supported."""
        _, w = self._phase_weights_np(k)
        if idx is not None:
            w = w[:, np.asarray(idx, np.int64)]
        S = sum(float(c) * self.stencils[nm] for nm, c in terms)
        Sf = S.reshape(S.shape[0], -1)
        if np.isrealobj(Sf):
            T = (np.ascontiguousarray(w.real.T) @ Sf
                 + 1j * (np.ascontiguousarray(w.imag.T) @ Sf))
        else:
            T = w.T @ Sf
        return T.reshape(w.shape[1], S.shape[1], S.shape[2])

    def blocks_np_multi(self, names: Sequence[str], k: np.ndarray,
                        idx=None) -> list:
        """Several stencils' blocks at the same (k, idx) in one pair of
        dgemms (the refine needs A, M and G together). Stencils may have
        different column dimensions; rows must match."""
        _, w = self._phase_weights_np(k)
        if idx is not None:
            w = w[:, np.asarray(idx, np.int64)]
        mats = [self.stencils[nm] for nm in names]
        cols = [m.shape[1] * m.shape[2] for m in mats]
        ck = tuple(names)
        Sf = self._multi_cache.get(ck)
        if Sf is None:
            Sf = np.concatenate([m.reshape(m.shape[0], -1)
                                 for m in mats], axis=1)
            self._multi_cache[ck] = Sf
        if np.isrealobj(Sf):
            T = (np.ascontiguousarray(w.real.T) @ Sf
                 + 1j * (np.ascontiguousarray(w.imag.T) @ Sf))
        else:
            T = w.T @ Sf
        out, o = [], 0
        for m, c in zip(mats, cols):
            out.append(T[:, o:o + c].reshape(w.shape[1], m.shape[1],
                                             m.shape[2]))
            o += c
        return out

    def candidate_blocks(self, support: np.ndarray, topk: int = 4,
                         tau: float = 1e-5) -> np.ndarray:
        """Flat block indices carrying the converged bands: per LOBPCG
        row, the ``topk`` largest-|X̂|² blocks above ``tau``·row-max."""
        sup = np.asarray(support, np.float64)
        cand = set()
        for r in range(sup.shape[0]):
            order = np.argsort(sup[r])[::-1][:topk]
            mx = sup[r][order[0]]
            for b in order:
                if sup[r][b] > tau * mx:
                    cand.add(int(b))
        return np.asarray(sorted(cand), np.int64)

    def spectral_refine_np(self, support: np.ndarray, k: np.ndarray,
                           nev: int):
        """Exact f64 refine for pencils without a nullspace to deflate
        (scalar Helmholtz): the generalized eigh of each candidate block
        of the "A" and "M" stencils. Returns (eigenvalues[:nev], residual
        certificates[:nev]) — the blocks are exact invariant subspaces,
        so the certificates are at machine precision — or None when the
        support is all zero (the caller falls back). The certificates are
        relative to max(|λ|, 3e-2·max|λ_blocks|, 1e-3)."""
        import scipy.linalg

        idx = self.candidate_blocks(support)
        if idx.size == 0:
            return None
        k = np.asarray(k, np.float64)
        TA, TM = self.blocks_np_multi(["A", "M"], k, idx)
        lams, ress = [], []
        for A_, M_ in zip(TA, TM):
            A_ = 0.5 * (A_ + A_.conj().T)
            M_ = 0.5 * (M_ + M_.conj().T)
            w, X = scipy.linalg.eigh(A_, M_)
            MX = M_ @ X
            R = A_ @ X - MX * w[None, :]
            nrm = np.maximum(np.linalg.norm(MX, axis=0), 1e-30)
            lams.append(w)
            ress.append(np.linalg.norm(R, axis=0) / nrm)
        allw = np.concatenate(lams)
        allr = np.concatenate(ress)
        order = np.argsort(allw)[:nev]
        lam = allw[order]
        scale = np.maximum(np.abs(lam),
                           max(3e-2 * float(np.abs(allw).max()), 1e-3))
        return lam, allr[order] / scale

    def solver_np(self, terms: Sequence[Tuple[str, float]],
                  k: np.ndarray) -> Callable:
        """f64 spectral block solver on the host (pseudo-inverse with the
        relative eigenvalue cutoff 1e-12). The eigendecomposition is
        done once here; the returned closure solves a field or a block
        of fields with a leading axis (the refine's gradient handling)."""
        d, p = self.d, self.p
        theta, w = self._phase_weights_np(k)
        F = [np.exp(-1j * th[:, None] * np.arange(n)[None, :])
             for th, n in zip(theta, self.shape)]
        S = sum(float(c) * self.stencils[nm] for nm, c in terms)
        T = np.einsum("sb,sij->bij", w, S)
        lam, V = np.linalg.eigh(0.5 * (T + np.conj(np.swapaxes(T, 1, 2))))
        good = lam > 1e-12 * lam.max(axis=-1, keepdims=True)
        linv = np.where(good, 1.0 / np.where(good, lam, 1.0), 0.0)

        base_ndim = self.d + (1 if self.ncomp > 1 else 0)

        def solve(u):
            u = np.asarray(u, np.complex128)
            if u.ndim == base_ndim + 1:  # leading block axis
                return np.stack([solve(x) for x in u])
            x = u.reshape(
                (self.ncomp,) + tuple(y for n in self.shape
                                      for y in (n, p)))
            for i in range(d):
                ax = 1 + 2 * i
                x = np.moveaxis(np.tensordot(F[i], x, axes=((1,), (ax,))),
                                0, ax)
            perm = [1 + 2 * i for i in range(d)] + [0] + \
                [2 + 2 * i for i in range(d)]
            v = x.transpose(perm).reshape(self.nblocks, self.D)
            c = np.einsum("bij,bj->bi", np.conj(np.swapaxes(V, 1, 2)), v)
            v = np.einsum("bij,bj->bi", V, linv * c)
            v = v.reshape(tuple(self.shape) + (self.ncomp,) + (p,) * d)
            perm2 = [d] + [y for i in range(d) for y in (i, d + 1 + i)]
            x = v.transpose(perm2)
            for i in range(d):
                ax = 1 + 2 * i
                Fi_inv = np.conj(F[i]).T / self.shape[i]
                x = np.moveaxis(
                    np.tensordot(Fi_inv, x, axes=((1,), (ax,))), 0, ax)
            x = x.reshape((self.ncomp,) + tuple(n * p for n in self.shape))
            out = x[0] if self.ncomp == 1 else x
            return out.reshape(np.asarray(u).shape)

        return solve

    def solve_np(self, terms: Sequence[Tuple[str, float]], u: np.ndarray,
                 k: np.ndarray) -> np.ndarray:
        """One-shot :meth:`solver_np` (a field or a block of fields)."""
        return self.solver_np(terms, k)(u)
