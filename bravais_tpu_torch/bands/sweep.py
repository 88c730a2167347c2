"""k-path band sweeps: warm-started and cold.

Port of ``BandSweep`` (the refine and ``device_tol`` rules, the
preconditioner choice, the built-in solve, ``_refine_host``, ``run_warm``,
``run_warm_chain``, ``run`` and ``run_warm_sharded``) from
``bravais_tpu/bands/sweep.py``.
Each k is solved on the device, then refined in f64 on the host. The
solve is an engine's ``solve_fn`` or, without one, the built-in LOBPCG
on the operator's matrix-free ``apply_A``/``apply_M`` with its fused
``apply_AM`` and a Jacobi or geometric-multigrid preconditioner. The
refine:

* a SPECTRAL solve hands over the tiny (m, B) block support, and the
  exact f64 block refine (``solve_fn.refine_np``) replaces the float32
  eigenvalues; a refine that fails its cross-check against the device
  values (or an empty support) falls back to ``host_rayleigh_ritz`` on
  the whole m-row block;
* a FIELD or built-in solve (no support) brings the eigenvector block to
  the host and refines it with ``host_rayleigh_ritz`` on its lowest
  nev+2 rows.

``run_warm`` starts each k from the previous k's eigenvector block (which
stays on the device); ``run`` starts every k from the seeded start block
and solves a chunk of k-points as ONE k-batched solve, a LOBPCG with a
leading k axis (as the reference vmaps a chunk): every engine's
``solve_fn`` takes a k table (nk, d) (``solve.batched``: the scalar and
Maxwell spectral engines, the Maxwell field engine with either
deflation), and so does the built-in solve with any preconditioner (the
Jacobi diagonal per k, the geometric-multigrid V-cycle with a k table, a
caller's preconditioner given the k table) on a ``BlochHelmholtz`` or a
``BlochCurlCurl``. The k of a chunk step in lockstep and a k that is done
is frozen (``chunk=1`` solves the k one at a time).

Both sweeps overlap the host refine with the device, as the reference
does (``bravais_tpu/bands/sweep.py`` ``run`` and ``run_warm``): the main
thread solves k (or a chunk), copies what the refine needs to the host
(the eigenvalues, residuals, iterations, the block support, the
eigenvector rows of a field or built-in solve), hands those arrays to
one worker thread that refines them, and solves the next k (or chunk)
meanwhile (``run_warm`` starts it from the block still on the device).
The worker touches no device tensor, so the refine does not wait behind
the device's queue; the one exception is a spectral refine that falls
back, which reads its k's block from the device then. Rows are collected
in k order; with a ``writer`` (``bands.io.BandWriter``) each finished k
(``run_warm``) or chunk (``run``) is on disk at once, so a killed sweep
resumes where it stopped (a solve that raises still writes the k before
it, once that k's refine is done). ``SweepResult.solve_s`` is the main
thread's time in the solves and ``refine_s`` the worker's in the refine;
the part of the refine hidden behind the solves is (solve_s + refine_s −
wall_s) / refine_s.

Sharded over a ``torch.distributed`` group (``mesh``, a
``parallel.mesh.KMesh``; every rank calls the sweep alike), as the
reference shards the k axis over a device mesh: ``run(k, mesh=)`` pads
each chunk with its last k to a multiple of the group size and each rank
solves its share as one k-batched solve on its own device, refining it on
its own worker thread; ``run_warm_sharded`` cuts the path into contiguous
segments, each warm-started from its own previous block, one k-batched
solve per path position over the rank's segments (without a mesh: every
segment on one device). Each chunk's (or position's) rows are gathered
from every rank in k order and written by rank 0; every rank returns the
same ``SweepResult``.

The reference's other sweep schedules: ``run_warm_chain`` (the warm
sweep in chains of k whose preconditioners or whole setups an engine can
build for the chain at once), ``restart_tol`` (``run``'s two-phase
k-batched solve) and ``near_gamma_tol`` (``run_warm``'s looser device
stop near Γ).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from bravais_tpu_torch.eigen.lobpcg import PROD_RR_TOL, lobpcg
from bravais_tpu_torch.eigen.precond import jacobi
from bravais_tpu_torch.eigen.refine import host_rayleigh_ritz
from bravais_tpu_torch.parallel.mesh import replicated, shard_k

__all__ = ["BandSweep", "SweepResult"]

#: numpy seed of the start block (the reference's default; both packages
#: draw the same block from it).
SEED = 0


@dataclasses.dataclass
class SweepResult:
    """Band table for a sampled k-path.

    eigenvalues : (nk, nev) λ (scalar) or ω² (Maxwell), refined when on
    iterations  : (nk,) LOBPCG iterations per k-point
    residuals   : (nk, nev) relative residuals (f64 certificates when
                  refined)
    wall_s      : wall time of the whole sweep, device work included
    refine_s    : seconds of the host f64 refine (on the worker thread,
                  beside the next solve)
    solve_s     : seconds the main thread spent in the device solves,
                  the copies of their outputs to the host included
    fallbacks   : k-points whose spectral refine failed its cross-check
                  (or had an empty support) and went to the host
                  Rayleigh–Ritz
    eigenvectors: (nk, nev, *dof_shape) complex device modes (the solve's
                  eigenvector rows, before the refine), host; only with
                  ``keep_vectors``
    """

    eigenvalues: np.ndarray
    iterations: np.ndarray
    residuals: np.ndarray
    wall_s: float
    refine_s: float = 0.0
    fallbacks: int = 0
    eigenvectors: Optional[np.ndarray] = None
    solve_s: float = 0.0


class _Fetched(NamedTuple):
    """One solve's outputs on the host, with a leading k axis: device
    eigenvalues, iterations and residuals; the block support (spectral
    solve, refine on) or None; the eigenvector rows the refine needs (or
    None without a refine: a spectral solve's whole block left where the
    solve put it, read only by a refine that falls back); the rows
    ``keep_vectors`` keeps (or None)."""
    lam: np.ndarray
    its: np.ndarray
    res: np.ndarray
    sup: Optional[np.ndarray]
    X: "np.ndarray | torch.Tensor | list | None"
    vecs: Optional[np.ndarray]


def _joined(parts) -> _Fetched:
    """Single solves' fetched outputs (each with a k axis of length 1)
    as one, k after k: host arrays concatenated, device blocks (a spectral
    solve's, read only by a refine that falls back) listed."""
    def join(xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], np.ndarray):
            return np.concatenate(xs)
        return [x[0] for x in xs]
    return _Fetched(*(join(list(f)) for f in zip(*parts)))


class BandSweep:
    """Warm-started sweep over Cartesian k-points.

    Parameters
    ----------
    operator   : ``BlochCurlCurl`` or ``BlochHelmholtz``; its space and
                 dtype define the problem.
    solve_fn   : an engine's ``make_spectral_solve_fn()`` /
                 ``make_solve_fn()``, or None for the built-in LOBPCG on
                 the operator's matrix-free applies.
    nev        : number of bands; ``block`` the LOBPCG block size
                 (default nev + max(4, nev // 2)).
    tol        : target; in complex64 with ``tol < 1e-4`` the f64 refine
                 is on and the device loop stops at ``device_tol``
                 (default max(tol, 1e-5)).
    precond    : the built-in solve's preconditioner: "auto" (geometric
                 multigrid for a ``BlochHelmholtz`` whose coefficients
                 vary between elements, Jacobi otherwise), "jacobi",
                 "gmg", None, or a callable k ↦ block preconditioner
                 (``run`` calls it with a k table (nk, d), and its
                 preconditioner takes (nk, rows, *dof) blocks).
    seed       : numpy seed of the start block.
    keep_vectors : return each k's eigenvector rows in
                 ``SweepResult.eigenvectors`` (for mode dumps).
    restart_tol : ``run`` only: each chunk's k-batched solve stops at this
                 residual, then restarts from its blocks down to the
                 device stop (two phases; a k's iterations are their
                 sum). A batch runs until its slowest k is done, so the
                 restart bounds a straggler's first phase at the loose
                 stop. None (the default): one phase.
    near_gamma_tol, near_gamma_norm : ``run_warm`` only, with the refine
                 on: a k with |k| < ``near_gamma_norm`` stops at
                 max(``near_gamma_tol``, device stop). Near Γ the float32
                 deflation's floor lies above the field engine's device
                 stop, and the f64 refine recovers from the looser stop.
                 Off by default (None, or a zero norm).
    """

    def __init__(self, operator, solve_fn: Optional[Callable] = None,
                 nev: int = 10, block: Optional[int] = None,
                 tol: float = 1e-6, maxiter: int = 200,
                 device_tol: Optional[float] = None, precond="auto",
                 seed: int = SEED, keep_vectors: bool = False,
                 restart_tol: Optional[float] = None,
                 near_gamma_tol: Optional[float] = None,
                 near_gamma_norm: float = 0.0):
        self.op = operator
        self.seed = seed
        self.keep_vectors = keep_vectors
        self.builtin = solve_fn is None
        self.solve_fn = solve_fn if solve_fn is not None else self._solve
        self.nev = nev
        self.m = block if block is not None else nev + max(4, nev // 2)
        self.maxiter = maxiter
        # In f32 the device converges to a loose residual and the f64
        # host refine recovers the eigenvalue accuracy; ``tol`` below the
        # f32 floor is redirected into the refine.
        is_f32 = operator.dtype == torch.complex64
        self.refine = is_f32 and tol < 1e-4
        self.tol = max(tol, 1e-5) if (is_f32 and self.refine) else tol
        # The spectral refine is an exact block eigensolve, so the device
        # loop only has to identify the support blocks.
        if device_tol is not None and self.refine:
            self.tol = device_tol
        self.restart_tol = restart_tol
        self.near_gamma_tol = near_gamma_tol if self.refine else None
        self.near_gamma_norm = near_gamma_norm
        #: the preconditioner mode the last ``run_warm_chain`` ran, after
        #: the engine's downgrades
        self.chain_mode = None
        self.precond = precond
        self.gmg = None
        if solve_fn is None:
            self._resolve_precond()

    def _tol_for_k(self, k) -> float:
        """``run_warm``'s device stop at k: max(``near_gamma_tol``, the
        device stop) inside the ball |k| < ``near_gamma_norm``, the device
        stop elsewhere."""
        if (self.near_gamma_tol is not None and self.near_gamma_norm > 0
                and float(np.linalg.norm(k)) < self.near_gamma_norm):
            return max(self.near_gamma_tol, self.tol)
        return self.tol

    def _resolve_precond(self):
        """Resolve ``precond="auto"`` and build the GMG hierarchy now, not
        inside the first solve. Jacobi stalls on the stiffness contrast of
        varying-α scalar problems (the TE air-hole crystal), which one
        V-cycle per iteration converges."""
        from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
        pre = self.precond
        if pre == "auto":
            pre = ("gmg" if isinstance(self.op, BlochHelmholtz)
                   and not self.op._coef_elem_invariant() else "jacobi")
        if pre == "gmg":
            from bravais_tpu_torch.eigen.gmg import GMG
            self.gmg = GMG(self.op)
        elif not (pre in ("jacobi", None) or callable(pre)):
            raise ValueError(f"unknown precond {pre!r}")
        self.precond_mode = pre

    def _make_precond(self, k):
        """The resolved preconditioner at k, or at a k table (nk, d) on
        k-batched blocks (nk, rows, *dof): Jacobi with one diagonal per
        k, the V-cycle with the table, or the caller's callable given the
        table."""
        pre = self.precond_mode
        if pre == "gmg":
            return self.gmg.precond(k)
        if pre == "jacobi":
            return jacobi(self.op.diag_A(k), batched=np.ndim(k) == 2)
        if callable(pre):
            return pre(k)
        return None

    def _solve(self, X0, k, nev, tol, maxiter):
        """The built-in solve: LOBPCG on (A(k), M) with the fused (A, M)
        element apply and the resolved preconditioner; no block support.
        At a k table (nk, d) one k-batched LOBPCG from X0 (m, *dof),
        shared by every k, or (nk, m, *dof), a start block per k."""
        op = self.op
        batched = np.ndim(k) == 2
        if batched and X0.ndim == 1 + len(self._dof_shape()):
            X0 = X0.expand((len(k),) + tuple(X0.shape))
        # M gets k too: a BlochCurlCurl mass wraps with the Bloch phases.
        return lobpcg(lambda x: op.apply_A(x, k), lambda x: op.apply_M(x, k),
                      X0, nev, maxiter=maxiter, tol=tol,
                      precond=self._make_precond(k),
                      AM=lambda x: op.apply_AM(x, k),
                      rr_tol=PROD_RR_TOL, batched=batched), None

    def _batched_solve(self) -> Callable:
        """The solve ``run`` gives a whole chunk of k at once: the built-in
        solve or an engine's ``solve_fn`` (each sets ``batched = True``);
        raises for a ``solve_fn`` that takes one k only."""
        if self.builtin:
            return self._solve
        if not getattr(self.solve_fn, "batched", False):
            raise ValueError("run solves a chunk of k-points at once: its "
                             "solve_fn must take a k table (nk, d) and set "
                             "batched = True (run_warm takes one k a solve)")
        return self.solve_fn

    def _dof_shape(self) -> tuple:
        sp = self.op.space
        return tuple(getattr(sp, "field_shape", sp.dof_shape))

    def _x0(self) -> torch.Tensor:
        """Start block from ``np.random.default_rng(seed)``, drawn as the
        reference draws it (real and imaginary planes)."""
        rng = np.random.default_rng(self.seed)
        shp = (self.m,) + self._dof_shape()
        t = torch.as_tensor(np.stack([rng.standard_normal(shp),
                                      rng.standard_normal(shp)]),
                            dtype=self.op.rdtype, device=self.op.device)
        return torch.complex(t[0], t[1])

    def _refine_host(self, lam_d: np.ndarray, support, X, k):
        """f64 refine of one k-point; returns (eigenvalues, residuals,
        fell back). With a block ``support`` (spectral solve): the exact
        block refine, cross-checked against the device eigenvalues ``lam_d``;
        a failed check or an empty support falls back to the host
        Rayleigh–Ritz on all m rows of the eigenvector block ``X`` (a
        true band may sit in a guard row). Without (field or built-in
        solve): the host Rayleigh–Ritz on the lowest nev+2 rows. ``X`` is
        a host array (the sweeps fetch it before the refine) or, with a
        ``support``, the solve's block as a tensor, copied to the host
        only if the refine falls back."""
        if support is None:
            lam, res = host_rayleigh_ritz(self.op, np.asarray(X), k,
                                          self.nev)
            return lam, res, False
        ref = self.solve_fn.refine_np(support, k, self.nev)
        if ref is not None:
            lam, res = ref
            lam_d = lam_d[:self.nev]
            sc = np.maximum(np.abs(lam_d),
                            3e-2 * max(float(np.abs(lam_d).max()), 1e-30))
            if lam.size == lam_d.size and np.all(
                    np.abs(lam - lam_d) / sc < 3e-2):
                return lam, res, False
        if torch.is_tensor(X):
            X = X.cpu().numpy()
        lam, res = host_rayleigh_ritz(self.op, X, k, self.nev,
                                      rows=X.shape[0])
        return lam, res, True

    def _fetch(self, r, support, batched: bool) -> _Fetched:
        """One solve's outputs on the host, copied on the main thread
        before the next solve is dispatched, so that the refine's worker
        thread touches no device tensor. With ``batched`` every output
        has a leading k axis; a single solve gets one of length 1."""
        def lead(t):
            return t if batched else t[None]

        def host(t):
            # A copy also on the CPU, where the next solve may reuse the
            # solve's memory while the worker reads it.
            return t.to("cpu", copy=True).numpy()
        X = lead(r.eigenvectors)
        sup = Xh = vecs = None
        if self.refine:
            if support is not None:
                # The spectral refine's fallback takes all m rows: they
                # stay where the solve left them, read only on a fallback.
                sup = host(lead(support).double())
                Xh = X
            else:
                # The host Rayleigh–Ritz takes the lowest nev+2.
                Xh = host(X[:, :self.nev + 2])
        if self.keep_vectors:
            vecs = (Xh[:, :self.nev] if isinstance(Xh, np.ndarray)
                    else host(X[:, :self.nev]))
        return _Fetched(host(lead(r.eigenvalues).double()),
                        np.reshape(np.asarray(r.iterations), -1),
                        host(lead(r.residual_norms).double()), sup, Xh, vecs)

    def _refine_chunk(self, got: _Fetched, ks) -> list:
        """The rows of a fetched chunk's first len(ks) k, each refined in
        turn (the worker thread's job): per k (eigenvalues, iterations,
        residuals, seconds in the refine, fell back)."""
        rows = []
        for j, k in enumerate(ks):
            lam, res, dt, fell = got.lam[j], got.res[j], 0.0, False
            if self.refine:
                t1 = time.perf_counter()
                lam, res, fell = self._refine_host(
                    lam, None if got.sup is None else got.sup[j], got.X[j],
                    k)
                dt = time.perf_counter() - t1
            rows.append((lam, int(got.its[j]), res, dt, fell))
        return rows

    def _pipelined(self, solves: Iterator, nk: int, writer,
                   k_index: Optional[np.ndarray], mesh=None) -> SweepResult:
        """Drive ``solves``, whose every step solves the next chunk of k
        on the main thread and yields (the positions in the sweep's k
        table of its real rows, their k, its fetched outputs), with each
        chunk's refine on one worker thread while the main thread solves
        the next chunk. A solve's rows past its real ones (a shard's
        padding) are not refined. With ``mesh`` every rank does this for
        its share and each chunk's rows are gathered from every rank (on
        the main thread, in step) and written by rank 0. Rows are written
        through ``writer`` chunk by chunk, in k order within a chunk; a
        refine's exception is raised here once the chunks before it are
        written. A solve's exception is raised once the chunk before it,
        if its refine succeeded, is written."""
        rows = [None] * nk
        vecs = [None] * nk if self.keep_vectors else None
        solve_s = 0.0

        def collect(idx, got, fut):
            vs = (got.vecs[:len(idx)] if vecs is not None
                  else [None] * len(idx))
            idx, both = replicated(mesh, idx, list(zip(fut.result(), vs)))
            for i, (row, v) in zip(idx, both):
                rows[i] = row
                if vecs is not None:
                    vecs[i] = v
            if writer is not None and (mesh is None or mesh.rank == 0):
                gidx = (k_index[idx] if k_index is not None else idx)
                lam, its, res = (np.asarray(c) for c in
                                 list(zip(*(rows[i] for i in idx)))[:3])
                writer.write_chunk(gidx, lam[:, :self.nev], its,
                                   res[:, :self.nev])

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = None
            try:
                while True:
                    t1 = time.perf_counter()
                    step = next(solves, None)
                    solve_s += time.perf_counter() - t1
                    if step is None:
                        break
                    idx, ks, got = step
                    fut = pool.submit(self._refine_chunk, got,
                                      ks[:len(idx)])
                    if pending is not None:
                        done, pending = pending, None
                        collect(*done)
                    pending = (idx, got, fut)
            except BaseException:
                # The serial sweep had written the chunk before a failed
                # solve: so is it here, once its refine is done.
                if pending is not None and pending[2].exception() is None:
                    collect(*pending)
                raise
            if pending is not None:
                collect(*pending)
        return self._result(rows, time.perf_counter() - t0, solve_s, vecs)

    def _rounded(self, k_cart) -> np.ndarray:
        """The k-points rounded to the device's real precision, as the
        reference rounds them: the solve and the f64 refine see the same
        k."""
        rdtype = torch.empty((), dtype=self.op.rdtype).numpy().dtype
        return np.asarray(k_cart, rdtype)

    def _result(self, rows, wall, solve_s, vecs) -> SweepResult:
        lams, itss, ress, dts, fells = zip(*rows)
        return SweepResult(np.asarray(lams), np.asarray(itss, np.int32),
                           np.asarray(ress), wall_s=wall,
                           refine_s=float(sum(dts)), solve_s=solve_s,
                           fallbacks=int(sum(fells)),
                           eigenvectors=(np.stack(vecs)
                                         if vecs is not None else None))

    def run_warm(self, k_cart: np.ndarray, writer=None,
                 k_index: Optional[np.ndarray] = None) -> SweepResult:
        """Sequential sweep, each k warm-started from the previous
        eigenvector block, which stays on the device; k's host refine
        runs while k+1 is solved. With ``writer``, every finished k is
        written at once under its global index ``k_index[i]`` (default
        i). Each k stops at ``_tol_for_k`` (the near-Γ loose stop)."""
        k_cart = self._rounded(k_cart)

        def solves(X):
            for i, k in enumerate(k_cart):
                r, support = self.solve_fn(X, k, self.nev,
                                           self._tol_for_k(k), self.maxiter)
                X = r.eigenvectors
                yield [i], k[None], self._fetch(r, support, batched=False)
        return self._pipelined(solves(self._x0()), len(k_cart), writer,
                               k_index)

    def run_warm_chain(self, k_cart: np.ndarray, chain: int = 4,
                       writer=None, k_index: Optional[np.ndarray] = None,
                       reuse_precond: bool = False,
                       precond: str = "per-k") -> SweepResult:
        """``run_warm`` in chains of ``chain`` consecutive k (the
        reference's ``run_warm_chain``): every k warm-started from the
        previous k's block, across chains too, each k solved at the device
        stop. A chain is one step of the pipeline: its k are refined on
        the worker thread while the next chain is solved, and written
        through ``writer`` (under ``k_index``) chain by chain.

        ``precond`` says where the solve's per-k setup comes from:

        * "per-k": each solve builds its own (``run_warm``'s solves);
        * "chain-mid" (also ``reuse_precond=True``): one
          ``solve_fn.build_pc`` at the chain's middle k, reused by the
          chain's solves (stale by up to chain/2 k);
        * "batched": one ``build_pc`` on the chain's k table, each solve
          handed its own k's;
        * "batched-setup": one ``solve_fn.build_setup`` (blocks,
          preconditioner, projector factor) on the chain's k table, each
          solve handed its own k's.

        An engine without ``build_setup`` runs "batched-setup" as
        "batched", one without ``build_pc`` every mode as "per-k" (the
        spectral Maxwell engine has both); ``chain_mode`` records the mode
        that ran. Raises ``ValueError`` for an unknown mode. A ragged last
        chain holds fewer k (the reference pads it with its last k);
        chain-mid then builds at its middle k of the padded chain."""
        if reuse_precond and precond == "per-k":
            precond = "chain-mid"
        if precond not in ("per-k", "chain-mid", "batched",
                           "batched-setup"):
            raise ValueError(f"unknown precond mode {precond!r}")
        build_pc = getattr(self.solve_fn, "build_pc", None)
        build_setup = getattr(self.solve_fn, "build_setup", None)
        if precond == "batched-setup" and build_setup is None:
            precond = "batched"
        if build_pc is None:
            precond = "per-k"
        self.chain_mode = precond
        k_cart = self._rounded(k_cart)
        nk = len(k_cart)
        chain = max(1, min(int(chain), nk))

        def hooks(ks):
            """The keywords of each of the chain's solves."""
            if precond == "chain-mid":
                pc = build_pc(ks[min(chain // 2, len(ks) - 1)])
                return [{"pc": pc}] * len(ks)
            if precond == "batched":
                pcs = build_pc(ks)
                return [{"pc": pcs[j]} for j in range(len(ks))]
            if precond == "batched-setup":
                su = build_setup(ks)
                return [{"setup": tuple(t[j] for t in su)}
                        for j in range(len(ks))]
            return [{}] * len(ks)

        def solves(X):
            for s in range(0, nk, chain):
                ks = k_cart[s:s + chain]
                kws, got = hooks(ks), []
                for k, kw in zip(ks, kws):
                    r, support = self.solve_fn(X, k, self.nev, self.tol,
                                               self.maxiter, **kw)
                    X = r.eigenvectors
                    got.append(self._fetch(r, support, batched=False))
                kw = kws = None   # free the chain's setups before the next
                yield list(range(s, s + len(ks))), ks, _joined(got)
        return self._pipelined(solves(self._x0()), nk, writer, k_index)

    def run(self, k_cart: np.ndarray, mesh=None, chunk: Optional[int] = None,
            writer=None, k_index: Optional[np.ndarray] = None
            ) -> SweepResult:
        """Cold sweep: every k solved from the seeded start block, in
        chunks of ``chunk`` k-points (default all). A chunk is one
        k-batched solve (module docstring); its k are then refined on the
        host one after the other, while the next chunk is solved. With
        ``writer``, each finished chunk is written at once under the
        global indices ``k_index`` (default 0..nk-1).

        ``mesh`` (``parallel.mesh.KMesh``, every rank of its group calls
        ``run`` alike): the chunk is rounded up to a multiple of the group
        size P, each chunk padded with its last k to a multiple of P, and
        rank r solves the r-th equal share of it as one k-batched solve on
        its device and refines it on its worker thread; each chunk's rows
        are gathered from every rank in k order and written by rank 0,
        and every rank returns the same ``SweepResult``.

        With ``restart_tol`` each chunk's solve runs in two phases: to
        ``restart_tol``, then from its blocks (one per k) to the device
        stop; a k's iterations are the sum of its two phases'."""
        k_cart = self._rounded(k_cart)
        nk = len(k_cart)
        P = mesh.size if mesh is not None else 1
        chunk = -(-max(chunk or nk, P) // P) * P
        bsolve = self._batched_solve()

        def solves(X0):
            for s in range(0, nk, chunk):
                ks, lo, real = shard_k(mesh, k_cart[s:s + chunk])
                if self.restart_tol:
                    mid, _ = bsolve(X0, ks, self.nev, self.restart_tol,
                                    self.maxiter)
                    r, support = bsolve(mid.eigenvectors, ks, self.nev,
                                        self.tol, self.maxiter)
                    r = r._replace(iterations=mid.iterations + r.iterations)
                else:
                    r, support = bsolve(X0, ks, self.nev, self.tol,
                                        self.maxiter)
                yield (list(range(s + lo, s + lo + real)), ks,
                       self._fetch(r, support, batched=True))
        return self._pipelined(solves(self._x0()), nk, writer, k_index,
                               mesh)

    def run_warm_sharded(self, k_cart: np.ndarray, mesh=None, writer=None,
                         k_index: Optional[np.ndarray] = None,
                         segments: Optional[int] = None) -> SweepResult:
        """Warm starts within contiguous segments of the path, the
        segments solved side by side (the reference's combined regime,
        ``bravais_tpu/bands/sweep.py`` ``run_warm_sharded``).

        The path is padded with its last k to S·per k-points and cut into
        S contiguous segments of ``per``; S is ``segments``, by default
        the group size P of ``mesh`` (4 without one), rounded up to a
        multiple of P. At each path position t every segment's t-th k is
        solved, each warm-started from its segment's previous block (the
        seeded start block at t = 0): rank r holds segments [r·S/P,
        (r+1)·S/P) and solves their current k as one k-batched solve (a
        start block per k) on its device, the blocks staying there. Each
        position's rows are refined on the worker thread beside the next
        position's solve, gathered from every rank and written by rank 0
        (``writer``, under ``k_index``); every rank returns the same
        ``SweepResult`` in path order."""
        k_cart = self._rounded(k_cart)
        nk = len(k_cart)
        P = mesh.size if mesh is not None else 1
        S = segments or (P if mesh is not None else 4)
        S = -(-S // P) * P
        per = -(-nk // S)
        kseg = np.concatenate(
            [k_cart, np.repeat(k_cart[-1:], S * per - nk, axis=0)]
        ).reshape(S, per, -1)
        r = mesh.rank if mesh is not None else 0
        mine = range(r * S // P, (r + 1) * S // P)
        bsolve = self._batched_solve()

        def solves(X):
            for t in range(per):
                ks = kseg[list(mine), t]
                r, support = bsolve(X, ks, self.nev, self.tol,
                                    self.maxiter)
                X = r.eigenvectors
                yield ([s * per + t for s in mine if s * per + t < nk], ks,
                       self._fetch(r, support, batched=True))
        X0 = self._x0()
        return self._pipelined(
            solves(X0.expand((len(mine),) + tuple(X0.shape))), nk, writer,
            k_index, mesh)
