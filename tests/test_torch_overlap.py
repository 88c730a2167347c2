"""The host refine overlapped with the next device solve: ``run_warm``
and ``run`` refine k (or a chunk of k) on one worker thread while the
main thread solves k+1 (or the next chunk), as the reference's sweeps
do.

* order: the refine of the first k (or chunk) waits for the next solve
  to start; a sweep that refined before solving on would wait for ever,
  so the wait fails the test after 10 s;
* bit-identity: the overlapped sweeps equal the serial composition (per
  k or chunk: the solve, its outputs on the host, the refine of each k,
  then the next solve) exactly, with ``keep_vectors``, on a small FCC
  spectral problem and a config-3-shaped field problem (CUB, ε = 13
  sphere, project-cheby);
* a spectral refine that falls back reads its k's block, which the
  sweep left where the solve put it, and equals the serial composition;
* a refine's exception propagates once the rows before it are written,
  and ``python -m bravais_tpu_torch --resume`` finishes the rest; a
  solve's exception propagates once the k before it is written.
"""

import json
import threading

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from bravais_tpu_torch.bands import BandSweep, BandWriter
from bravais_tpu_torch.cli import bands_app
from bravais_tpu_torch.cli.config import RunConfig
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_sphere
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

NEV, M = 4, 8
WAIT_S = 10.0


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One host BLAS thread, as the package sets for its own processes: a
    threaded OpenBLAS spins on the cores the other test workers use (4-5x
    slower dense eigensolves here under load)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _fcc(keep_vectors=False):
    """FCC n=3 p=2, the spectral engine, 4 k off Γ."""
    lat = make_lattice("FCC")
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 3), 2),
                       device="cpu")
    sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=NEV, block=M,
                      tol=1e-6, maxiter=250, device_tol=1e-3,
                      keep_vectors=keep_vectors)
    return kpath(lat, npts=4, path=[["X", "W", "L"]]).k_cart, sweep


def _diel(keep_vectors=False):
    """Config 3's problem cut to n=3 p=2: CUB with an ε = 13 sphere, the
    field engine (project-cheby, fastdiag), 3 k off Γ."""
    lat = make_lattice("CUB")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 3), 2)
    eps = dielectric_sphere(13.0, 1.0, 0.25, 0.5 * lat.A.sum(axis=0), lat.A)
    op = BlochCurlCurl(sp, eps=eps, device="cpu")
    solve = op.make_solve_fn(deflation="project-cheby", precond="fastdiag")
    sweep = BandSweep(op, solve, nev=NEV, block=M, tol=1e-6,
                      maxiter=250, device_tol=1e-4,
                      keep_vectors=keep_vectors)
    return kpath(lat, npts=3, path=[["X", "M", "R"]]).k_cart, sweep


def _sweep(mode, sweep, kc, **kw):
    return (sweep.run_warm(kc, **kw) if mode == "warm"
            else sweep.run(kc, chunk=2, **kw))


@pytest.mark.parametrize("mode", ["warm", "chunk2"])
def test_refine_of_k_runs_beside_the_next_solve(mode):
    kc, sweep = _fcc()
    solve, refine = sweep.solve_fn, sweep._refine_host
    second = threading.Event()
    calls = []

    def gated_solve(*a):
        calls.append(threading.current_thread())
        if len(calls) == 2:
            second.set()
        return solve(*a)
    gated_solve.batched = True
    gated_solve.refine_np = solve.refine_np

    def gated_refine(*a):
        if not second.wait(WAIT_S):
            raise AssertionError("the refine of the first k ran before "
                                 "the next solve started")
        return refine(*a)

    sweep.solve_fn, sweep._refine_host = gated_solve, gated_refine
    res = _sweep(mode, sweep, kc)
    assert len(calls) == (len(kc) if mode == "warm" else 2)
    assert all(t is threading.main_thread() for t in calls)
    assert res.fallbacks == 0 and np.max(res.residuals) < 1e-10
    assert res.solve_s > 0 and res.refine_s > 0


def _serial(sweep, kc, chunk):
    """The serial composition: per k (``chunk`` None; warm-started) or
    per chunk of k (one k-batched solve from the start block) the solve,
    its outputs on the host, and the refine of each k before the next
    solve. Returns (eigenvalues, iterations, residuals, fallbacks,
    eigenvectors)."""
    kc = sweep._rounded(kc)
    X = sweep._x0()
    lam, its, res, fell, vecs = [], [], [], 0, []
    for s in range(0, len(kc), chunk or 1):
        if chunk is None:
            r, sup = sweep.solve_fn(X, kc[s], sweep.nev, sweep.tol,
                                    sweep.maxiter)
            X = r.eigenvectors
            r = type(r)(*(t[None] if torch.is_tensor(t) else np.asarray([t])
                          for t in r))
            sup = None if sup is None else sup[None]
        else:
            r, sup = sweep.solve_fn(X, kc[s:s + chunk], sweep.nev,
                                    sweep.tol, sweep.maxiter)
        for j, k in enumerate(kc[s:s + (chunk or 1)]):
            lj = r.eigenvalues[j].double().numpy()
            rj = r.residual_norms[j].double().numpy()
            lj, rj, f = sweep._refine_host(
                lj, None if sup is None else sup[j].double().numpy(),
                r.eigenvectors[j].numpy(), k)
            lam.append(lj)
            res.append(rj)
            its.append(int(r.iterations[j]))
            fell += f
            vecs.append(r.eigenvectors[j, :sweep.nev].numpy())
    return (np.asarray(lam), np.asarray(its), np.asarray(res), fell,
            np.stack(vecs))


@pytest.mark.parametrize("problem", [_fcc, _diel], ids=["fcc", "diel"])
@pytest.mark.parametrize("mode", ["warm", "chunk2"])
def test_overlap_equals_serial_composition(problem, mode):
    kc, sweep = problem(keep_vectors=True)
    got = _sweep(mode, sweep, kc)
    lam, its, res, fell, vecs = _serial(sweep, kc,
                                        None if mode == "warm" else 2)
    np.testing.assert_array_equal(got.eigenvalues, lam)
    np.testing.assert_array_equal(got.iterations, its)
    np.testing.assert_array_equal(got.residuals, res)
    assert got.fallbacks == fell
    np.testing.assert_array_equal(got.eigenvectors, vecs)


@pytest.mark.parametrize("mode", ["warm", "chunk2"])
def test_fallback_refine_equals_serial_composition(mode):
    """Every spectral refine falls back (its block refine declines): the
    host Rayleigh–Ritz then reads the k's whole block, which the sweep
    fetched lazily, and the result equals the serial composition's."""
    kc, sweep = _fcc(keep_vectors=True)
    solve = sweep.solve_fn

    def declining(*a):
        return solve(*a)
    declining.batched = True
    declining.refine_np = lambda *a: None
    sweep.solve_fn = declining
    got = _sweep(mode, sweep, kc)
    lam, its, res, fell, vecs = _serial(sweep, kc,
                                        None if mode == "warm" else 2)
    assert got.fallbacks == fell == len(kc)
    np.testing.assert_array_equal(got.eigenvalues, lam)
    np.testing.assert_array_equal(got.iterations, its)
    np.testing.assert_array_equal(got.residuals, res)
    np.testing.assert_array_equal(got.eigenvectors, vecs)


def test_solve_exception_writes_the_k_before(tmp_path):
    """The solve of k index 2 raises on the main thread: ``run_warm``
    raises it once the refine of k index 1 is done and written, so the
    writer holds k 0 and 1, as the serial sweep left it."""
    kc, sweep = _fcc()
    solve = sweep.solve_fn
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("solve failed at k index 2")
        return solve(*a)
    failing.refine_np = solve.refine_np
    sweep.solve_fn = failing
    writer = BandWriter(tmp_path, {"c": 1}, len(kc), NEV)
    with pytest.raises(RuntimeError, match="k index 2"):
        sweep.run_warm(kc, writer=writer)
    w2 = BandWriter(tmp_path, {"c": 1}, len(kc), NEV)
    assert w2.try_resume() == [0, 1]


def _failing_at_third(monkeypatch):
    """Make ``BandSweep._refine_host`` raise at its third call (k index
    2); returns the threads it ran on."""
    refine = BandSweep._refine_host
    calls = []

    def failing(self, *a):
        calls.append(threading.current_thread())
        if len(calls) == 3:
            raise RuntimeError("refine failed at k index 2")
        return refine(self, *a)

    monkeypatch.setattr(BandSweep, "_refine_host", failing)
    return calls


def test_refine_exception_propagates_and_resume_finishes(tmp_path,
                                                         monkeypatch):
    """The refine of k index 2 raises in a warm CLI run: the run raises
    it, its directory holds k 0 and 1, and ``--resume`` solves only the
    rest."""
    cfg = dict(device="cpu", lattice="SQR", problem="scalar", n=6, p=2,
               nk=5, nev=2, tol=1e-6, maxiter=100, out=str(tmp_path / "run"))
    calls = _failing_at_third(monkeypatch)
    with pytest.raises(RuntimeError, match="k index 2"):
        bands_app.run(RunConfig(**cfg), log=lambda *_: None)
    # (the refine of k 3 may have started before k 2's was collected)
    assert len(calls) >= 3
    assert all(t is not threading.main_thread() for t in calls)
    writer = BandWriter(cfg["out"], RunConfig(**cfg).identity_dict(), 5, 2)
    assert writer.try_resume() == [0, 1]

    monkeypatch.undo()
    lines = []
    bands_app.run(RunConfig(**cfg, resume=True), log=lines.append)
    solved = [json.loads(line)["k_index"] for line in lines
              if line.startswith("{")]
    assert solved == [2, 3, 4]
    dat = np.load(tmp_path / "run" / "bands.npz")
    assert np.all(np.isfinite(dat["eigenvalues"]))


def test_refine_exception_in_a_chunk_keeps_the_chunks_before(tmp_path,
                                                             monkeypatch):
    """``run(chunk=2)``: the refine of k index 2 (the second chunk's
    first k) raises; the first chunk is on disk and a resumed ``run``
    finishes the rest."""
    kc, sweep = _fcc()
    writer = BandWriter(tmp_path, {"c": 1}, len(kc), NEV)
    _failing_at_third(monkeypatch)
    with pytest.raises(RuntimeError, match="k index 2"):
        sweep.run(kc, chunk=2, writer=writer)
    w2 = BandWriter(tmp_path, {"c": 1}, len(kc), NEV)
    assert w2.try_resume() == [0, 1]
    monkeypatch.undo()
    todo = np.arange(2, len(kc))
    sweep.run(kc[todo], chunk=2, writer=w2, k_index=todo)
    assert w2.finished == list(range(len(kc)))
    np.testing.assert_allclose(w2.eigenvalues, sweep.run(kc).eigenvalues,
                               rtol=1e-10)
