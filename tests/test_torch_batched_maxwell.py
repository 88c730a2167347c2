"""The k-batched Maxwell engines: ``BandSweep.run`` solves a chunk of k as
ONE LOBPCG with a leading k axis on the spectral engine, the field engine
(both deflations) and the built-in Jacobi solve on ``BlochCurlCurl``.

* unit gates: ``lobpcg(batched=True)`` with ``kernel_project`` and a
  preconditioner equals its per-k loop; a per-k phase vector in
  ``gather_axis``/``scatter_add_axis``; ``FastDiag.solver`` with a k
  table; the field applies (nd, gradient, L) with a k table; the
  spectral projector factor's huge pivot taken per k;
* each engine at a small size (FCC n=3 p=2 at Γ nudged, X and W; config
  3's ε = 13 sphere at n=3 p=2 at Γ nudged, X and M; nev 4 in 8): the
  batched ``run`` against ``run(chunk=1)`` of the port (iterations equal
  per k, device eigenvalues within 1e-5 relative, refined within 1e-6)
  and against the JAX package's vmapped ``BandSweep.run`` with the
  matching solve (refined eigenvalues within 1e-6, iterations within ±1);
* a batched Maxwell run with a ``BandWriter`` resumes and recomputes
  nothing.

Refined eigenvalues are compared relative to max(|λ|, 1e-2 of the k's
top band): at the nudged Γ the two acoustic bands (λ ≈ 0.0125 at config
3) sit on the float32 floor of the device residual (2e-4–1e-3), where the
port's and the reference's refines differ by ≈2.5e-8 absolute (2e-6 of
λ), the size chip_smoke's 2e-7 absolute bar at the nudged Γ allows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.coefficients import \
    dielectric_sphere as sphere_ref
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.bands import BandWriter
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.eigen.lobpcg import lobpcg
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_sphere
from bravais_tpu_torch.operators.curlcurl import (BlochCurlCurl,
                                                  projector_factor)
from bravais_tpu_torch.spaces import tensor
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

NEV, BLOCK = 4, 8


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _problem(lattice):
    """(port operator, reference operator, k table (3, 3) as float32
    values): FCC empty lattice at Γ nudged, X, W; CUB with the ε = 13
    sphere (r = 0.25a) at Γ nudged, X, M; n=3 p=2."""
    lat, latr = make_lattice(lattice), make_lattice_ref(lattice)
    kw, kwr = {}, {}
    if lattice == "CUB":
        c = 0.5 * lat.A.sum(axis=0)
        kw["eps"] = dielectric_sphere(13.0, 1.0, 0.25, c, lat.A)
        kwr["eps"] = sphere_ref(13.0, 1.0, 0.25, c, latr.A, 0.0)
    third = "W" if lattice == "FCC" else "M"
    ks = np.asarray([2e-2 * lat.B[0], lat.point_cart("X"),
                     lat.point_cart(third)], np.float32).astype(np.float64)
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 3), 2),
                       device="cpu", **kw)
    ref = CurlRef(NedRef.make(GridRef.make(latr, 3), 2), dtype=jnp.complex64,
                  **kwr)
    return op, ref, ks


@pytest.fixture(scope="module")
def fcc():
    return _problem("FCC")


@pytest.fixture(scope="module")
def cub():
    return _problem("CUB")


def _recorded(sweep):
    """Record each chunk's device eigenvalues and iterations: wraps the
    solve ``run`` hands a chunk."""
    got = []
    inner = sweep._batched_solve()

    def rec(X0, ks, *a):
        r, sup = inner(X0, ks, *a)
        got.append((r.eigenvalues.numpy(), np.asarray(r.iterations)))
        return r, sup
    sweep._batched_solve = lambda: rec
    return got


def _band_err(lam, ref):
    """max |λ − λ_ref| over max(|λ_ref|, 1e-2 of the k's top band)."""
    ref = np.asarray(ref, np.float64)
    top = np.abs(ref).max(axis=1, keepdims=True)
    return float(np.max(np.abs(lam - ref)
                        / np.maximum(np.abs(ref), 1e-2 * top)))


def _batched_against_looped(sweep, ks):
    """``run`` (one batched solve) against ``run(chunk=1)``: the same
    iterations, device eigenvalues within 1e-5, refined within 1e-6;
    returns the batched result."""
    got = _recorded(sweep)
    res = sweep.run(ks)
    one = sweep.run(ks, chunk=1)
    assert len(got) == 1 + len(ks)            # one solve, then one a k
    lam_b, its_b = got[0]
    assert lam_b.shape == (len(ks), NEV)
    lam_1 = np.concatenate([g[0] for g in got[1:]])
    its_1 = np.concatenate([g[1] for g in got[1:]])
    assert its_b.tolist() == its_1.tolist() == res.iterations.tolist()
    assert one.iterations.tolist() == res.iterations.tolist()
    np.testing.assert_allclose(lam_b, lam_1, rtol=1e-5)
    assert _band_err(one.eigenvalues, res.eigenvalues) < 1e-6
    return res


# -- unit gates ---------------------------------------------------------------

def test_lobpcg_batched_kernel_project_equals_per_k_loop():
    """A batched LOBPCG with ``kernel_project`` and a preconditioner on
    (nk, rows, 4, 6) blocks against nk calls of one k each (a batch of
    one, as ``run(chunk=1)`` solves): three Hermitian pencils, each with
    its own 3-dimensional kernel and its own Jacobi diagonal; the start
    block, the preconditioned residuals and (inside the loop) X and P are
    deflated per k, as the field engine deflates them. The k stop at
    different iterations, so the done ones are frozen while the others go
    on. (A batched solve forms its Grams in complex128, ``lobpcg._gram``;
    the unbatched one in complex64, as the reference does.)"""
    rng = np.random.default_rng(4)
    nk, N, nker, dof, nev, m = 3, 24, 3, (4, 6), 3, 5
    As, Ps, ds = [], [], []
    for j in range(nk):
        Q = np.linalg.qr(rng.standard_normal((N, N))
                         + 1j * rng.standard_normal((N, N)))[0]
        lam = np.concatenate([np.zeros(nker),
                              np.linspace(1.0 + j, 20.0, N - nker)])
        A = (Q * lam) @ Q.conj().T
        As.append(0.5 * (A + A.conj().T))
        K = Q[:, :nker]
        Ps.append(K @ K.conj().T)
        ds.append(np.real(np.diag(As[-1])) + 1.0)
    A, P = (torch.as_tensor(np.stack(x), dtype=torch.complex64)
            for x in (As, Ps))
    d = torch.as_tensor(np.stack(ds), dtype=torch.float32)

    def rows(M):          # row blocks X (..., rows, 4, 6) times Mᵀ
        return lambda X: (X.reshape(X.shape[:-2] + (N,)) @ M.mT).reshape(
            X.shape)

    def deflated(Pk, dk):
        return lambda R: (lambda Z: Z - rows(Pk)(Z))(R / dk)

    X0 = torch.as_tensor(rng.standard_normal((m,) + dof)
                         + 1j * rng.standard_normal((m,) + dof),
                         dtype=torch.complex64)
    Xb = X0.expand((nk,) + X0.shape)
    kw = dict(maxiter=80, tol=1e-4, M=None)
    rb = lobpcg(rows(A), X0=Xb - rows(P)(Xb), nev=nev, batched=True,
                kernel_project=rows(P),
                precond=deflated(P, d.reshape(nk, 1, *dof)), **kw)
    loop = [lobpcg(rows(A[j:j + 1]), X0=Xb[:1] - rows(P[j:j + 1])(Xb[:1]),
                   nev=nev, batched=True, kernel_project=rows(P[j:j + 1]),
                   precond=deflated(P[j:j + 1], d[j].reshape(1, 1, *dof)),
                   **kw)
            for j in range(nk)]
    its = [int(r.iterations[0]) for r in loop]
    assert rb.iterations.tolist() == its and len(set(its)) == nk
    assert bool(rb.converged.all())
    lam = np.stack([r.eigenvalues[0].numpy() for r in loop])
    np.testing.assert_allclose(rb.eigenvalues.numpy(), lam, rtol=1e-5)
    # The kernel stays out: the bands are the lowest nonzero eigenvalues.
    want = np.stack([np.linspace(1.0 + j, 20.0, N - nker)[:nev]
                     for j in range(nk)])
    np.testing.assert_allclose(rb.eigenvalues.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("which", ["gather", "scatter"])
def test_axis_wrap_takes_a_per_k_phase(which):
    """``gather_axis``/``scatter_add_axis`` with a phase vector (nk,) on
    nk row groups equal the per-group calls with each group's scalar
    phase."""
    rng = np.random.default_rng(7)
    nk, R, n, p = 3, 2, 4, 3
    shape = (nk * R, 5, n * p, 2) if which == "gather" else \
        (nk * R, 5, n, p + 1, 2)
    u = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape),
                        dtype=torch.complex64)
    ph = torch.polar(torch.ones(nk), torch.as_tensor(rng.uniform(0, 6, nk),
                                                     dtype=torch.float32))
    fn = tensor.gather_axis if which == "gather" else tensor.scatter_add_axis
    got = fn(u, 1, n, p, ph)
    want = torch.cat([fn(u[j * R:(j + 1) * R], 1, n, p, ph[j])
                      for j in range(nk)])
    assert torch.equal(got, want)
    assert not torch.equal(got, fn(u, 1, n, p, ph[0]))


@pytest.mark.parametrize("method", ["lu", "eigh"])
def test_fastdiag_solver_takes_a_k_table(fcc, method):
    """``FastDiag.solver`` at a k table on (nk, rows, *field) blocks
    equals the per-k solvers: "lu" the (A + sM)⁻¹ preconditioner, "eigh"
    the L-twin's spectral pseudo-inverse (one Jacobi eigh of (nk, B, D,
    D))."""
    op, _, ks = fcc
    if method == "lu":
        fd, terms = op.fastdiag(), [("A", 1.0), ("M", op.default_fd_shift())]
    else:
        fd, terms = op.fastdiag_L(), [("L", 1.0)]
    rng = np.random.default_rng(3)
    shp = (len(ks), 2) + fd.field_shape
    u = torch.as_tensor(rng.standard_normal(shp) + 1j
                        * rng.standard_normal(shp), dtype=torch.complex64)
    got = fd.solver(terms, ks, method=method)(u)
    assert got.shape == u.shape
    for j, k in enumerate(ks):
        assert _rel(got[j], fd.solver(terms, k, method=method)(u[j])) < 1e-5


@pytest.mark.parametrize("which", ["AM", "Gk", "GkH", "Lk"])
def test_field_applies_take_a_k_table(cub, which):
    """The field engine's applies with a k table on (nk, rows, ...)
    blocks equal the per-k applies: the fused Nédélec (A, M), the
    gradient and its adjoint, and the deflation Laplacian L (the h1
    kernel at k = 0, the phases in the gather)."""
    op, _, ks = cub
    rng = np.random.default_rng(5)
    sp = op.space
    scalar = which in ("Gk", "Lk")
    shp = (len(ks), 2) + (tuple(sp.grid.shape[i] * sp.p for i in range(3))
                          if scalar else tuple(sp.field_shape))
    u = torch.as_tensor(rng.standard_normal(shp) + 1j
                        * rng.standard_normal(shp), dtype=torch.complex64)
    fn = {"AM": op.apply_AM, "Gk": op.apply_Gk, "GkH": op.apply_GkH,
          "Lk": op.apply_Lk}[which]
    got = fn(u, ks)
    got = got if isinstance(got, tuple) else (got,)
    for j, k in enumerate(ks):
        want = fn(u[j], k)
        for g, w in zip(got, want if isinstance(want, tuple) else (want,)):
            assert g.shape[:2] == u.shape[:2]
            assert _rel(g[j], w) < 1e-6


def test_projector_factor_pivot_is_per_k():
    """The spectral projector factor of two k batched equals each k's
    alone, though only the first has a pivot at δ (a null direction of L)
    and the two k's largest pivots differ: the huge pivot that zeroes the
    null direction is the k's own largest over ``eps``, as under the
    reference's vmap."""
    rng = np.random.default_rng(9)
    B, D, Dh = 2, 6, 3
    W = rng.standard_normal((2, B, D, D)) + 1j * rng.standard_normal(
        (2, B, D, D))
    TM = torch.as_tensor(W @ W.conj().swapaxes(-1, -2) + D * np.eye(D))
    G = rng.standard_normal((2, B, D, Dh)) + 1j * rng.standard_normal(
        (2, B, D, Dh))
    G[0, 1, :, -1] = 0.0             # k 0, block 1: a null direction of L
    G[1] *= 3.0                      # k 1: larger pivots
    TG = torch.as_tensor(G)
    both = projector_factor(TM, TG, TG.mH)
    alone = [projector_factor(TM[j], TG[j], TG[j].mH) for j in range(2)]
    for j in range(2):
        np.testing.assert_allclose(both[j].numpy(), alone[j].numpy(),
                                   rtol=1e-12, atol=0)
    dg = [torch.diagonal(a, dim1=-2, dim2=-1).real for a in alone]
    eps = torch.finfo(torch.float64).eps
    pivot = float(dg[0][1, -1])
    ordinary = float(dg[0][dg[0] < 1e6].max())
    assert pivot == pytest.approx(ordinary / eps, rel=1e-12)
    assert float(dg[1].max()) > 2 * ordinary


# -- the engines ----------------------------------------------------------------

@pytest.mark.parametrize("engine", ["spectral", "project", "project-cheby"])
def test_batched_run_matches_loop_and_reference(fcc, cub, engine):
    """Each Maxwell engine's batched ``run`` against ``run(chunk=1)`` and
    against the reference's vmapped ``run`` with the matching solve:
    ``make_solve_fn(engine="spectral")`` (FCC, device stop 1e-3),
    ``make_solve_fn(deflation="project", precond="fastdiag")`` (FCC,
    device stop 1e-4) and ``deflation="project-cheby"`` (config 3's
    sphere, device stop 1e-4)."""
    op, ref, ks = cub if engine == "project-cheby" else fcc
    if engine == "spectral":
        solve = op.make_spectral_solve_fn()
        solve_r = ref.make_solve_fn(engine="spectral")
        dtol = 1e-3
    else:
        solve = op.make_solve_fn(deflation=engine, precond="fastdiag")
        solve_r = ref.make_solve_fn(deflation=engine, precond="fastdiag")
        dtol = 1e-4
    kw = dict(nev=NEV, block=BLOCK, tol=1e-6, maxiter=200, device_tol=dtol)
    sweep = BandSweep(op, solve, **kw)
    res = _batched_against_looped(sweep, ks)
    assert res.fallbacks == 0
    rr = SweepRef(ref, solve_fn=solve_r, **kw).run(ks)
    assert np.all(np.abs(res.iterations - np.asarray(rr.iterations)) <= 1), \
        (res.iterations, rr.iterations)
    assert _band_err(res.eigenvalues,
                     np.asarray(rr.eigenvalues)[:, :NEV]) < 1e-6


def test_builtin_jacobi_on_curlcurl_is_batched(fcc):
    """The built-in solve on a ``BlochCurlCurl`` (Jacobi, no deflation)
    runs a chunk as one batched LOBPCG equal to its per-k solves (five
    iterations each, the cap)."""
    op, _, ks = fcc
    sweep = BandSweep(op, nev=NEV, block=BLOCK, tol=1e-8, maxiter=5)
    assert sweep.precond_mode == "jacobi"
    res = _batched_against_looped(sweep, ks)
    assert res.iterations.tolist() == [5, 5, 5]


def test_batched_maxwell_run_resumes_and_recomputes_nothing(fcc, tmp_path):
    """A batched spectral Maxwell run in chunks of 2 with a writer, killed
    after its first chunk: the resume solves only the unfinished k (one
    batched solve of both) and its bands equal an uninterrupted run's; a
    second resume has nothing left."""
    op, _, ks = fcc
    ks = np.concatenate([ks, 0.5 * ks[1:2]])              # nk = 4
    nk = len(ks)
    sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=NEV, block=BLOCK,
                      tol=1e-6, maxiter=200, device_tol=1e-3)
    full = sweep.run(ks, chunk=2)
    calls = []
    solve = sweep.solve_fn

    def counted(X0, k, *a):
        calls.append(np.asarray(k).shape)
        return solve(X0, k, *a)
    counted.__dict__.update(solve.__dict__)
    sweep.solve_fn = counted

    w = BandWriter(tmp_path, {"c": 8}, nk, NEV)
    sweep.run(ks[:2], chunk=2, writer=w, k_index=np.arange(2))   # killed
    w2 = BandWriter(tmp_path, {"c": 8}, nk, NEV)
    done = w2.try_resume()
    assert done == [0, 1]
    todo = np.asarray([i for i in range(nk) if i not in done])
    calls.clear()
    sweep.run(ks[todo], chunk=2, writer=w2, k_index=todo)
    assert calls == [(2, 3)]                 # one batched solve of k 2, 3
    assert w2.finished == list(range(nk))
    np.testing.assert_allclose(w2.eigenvalues, full.eigenvalues, rtol=1e-6)
    assert BandWriter(tmp_path, {"c": 8}, nk, NEV).try_resume() == \
        list(range(nk))


def test_cli_batched_mode_is_one_solve(monkeypatch, tmp_path):
    """``--mode batched`` on the Maxwell field engine runs the k-path as
    one k-batched LOBPCG: one call, with ``batched`` and all nk k, and a
    complete run directory."""
    from bravais_tpu_torch.cli import bands_app
    from bravais_tpu_torch.cli.config import RunConfig
    from bravais_tpu_torch.eigen import lobpcg as lobpcg_mod

    calls = []
    plain = lobpcg_mod.lobpcg

    def counted(*a, **kw):
        calls.append((kw.get("batched", False), tuple(a[2].shape[:1])))
        return plain(*a, **kw)
    monkeypatch.setattr(lobpcg_mod, "lobpcg", counted)
    nk = 3
    cfg = RunConfig(lattice="FCC", problem="maxwell", engine="field", n=3,
                    p=2, nk=nk, nev=3, path=[["G", "X"]], mode="batched",
                    device="cpu", out=str(tmp_path))
    w = bands_app.run(cfg, log=lambda s: None)
    assert calls == [(True, (nk,))]
    assert w.finished == list(range(nk))
    assert np.all(np.isfinite(w.eigenvalues))
