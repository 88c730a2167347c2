"""Config 3's degenerate k against the reference: the production
certification's problem (``cli/certify_dielectric.py``: CUB with an
ε = 13 sphere, r = 0.25a, n=4 p=2, complex64, project-cheby deflation at
the production Chebyshev target, the fastdiag preconditioner, 10 bands in
16, device stop 1e-4, then the f64 host Rayleigh–Ritz) on its first two
k of the nk=6 Γ–X–M–R path (the nudged Γ, then k 1 midway along Γ–X,
where the bands come in degenerate pairs), on the CPU at one thread.

The port's ``run_warm`` and the reference's (built as
``benchmarks/certify_dielectric.py`` builds it) run from the same start
block (``BandSweep(seed=s)``, drawn alike by both) at the seeds
``SEEDS``. Held at each seed: the port's k-1 bands within 1e-6
scale-aware (band floor 1e-3·max λ, as the module computes it) of the
reference's, its k-1 host residuals under 1e-3 (10× the device stop),
and its iterations at each k within ±2 of the reference's.

Before the repair these seeds failed here: the port's k 1 stopped after
13 iterations (the reference's 20–21) at scale-aware errors 1.2e-03,
7.6e-04 and 1.5e-04, host residuals up to 0.096, 0.076 and 0.024. Its
LOBPCG recombines AX/MX (and AP/MP) inside a 16-iteration segment; a
row that is mostly gradient is cut down by the kernel projection each
iteration while its AX keeps what A did not annihilate, so the drift
grows ~10× an iteration and the S-basis Gram turns indefinite. The
reference's JAX Cholesky then returns an all-NaN factor: every direction
drops, the whiteout guard freezes the block and the next segment refresh
recomputes AX/MX, after which k 1 converges. The port's factor kept the
rows above the failed pivot and iterated on the drifted AX/MX until
their residuals read as converged. ``test_whiten_chol_matches_reference``
holds the whitening itself to the reference's on such Grams.

The second (CholeskyQR2) factorization keeps its row-wise drop: a failed
pivot of G₂ ≈ I is one amplified noise direction. Dropping the whole
block there froze config 1's k 1 (SQR n=16 p=4, spectral engine) until
its stagnation stop at 32 iterations, where the reference takes 4;
``test_config1_k1_matches_reference`` holds those iterations.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.eigen.lobpcg import _whiten_chol as whiten_ref
from bravais_tpu.lattices import kpath as kpath_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.coefficients import \
    dielectric_sphere as sphere_ref
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.operators.helmholtz import BlochHelmholtz as HelmRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.cli import certify_dielectric as cd
from bravais_tpu_torch.eigen.lobpcg import _chol_rows, _whiten_chol
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.spaces.h1 import H1Space

torch.set_num_threads(1)

SEEDS = (8, 9, 11)
N, P, NK, NEV = 4, 2, 6, 10
BAR, BAND_FLOOR, RESID_BAR, ITER_SLACK = 1e-6, 1e-3, 1e-3, 2


def _ref_runs(kc):
    """The reference's f32 ``run_warm`` of k 0-1 at each seed, one
    compiled program for all: {seed: (bands, iterations)}."""
    lat = make_lattice_ref("CUB")
    sp = NedRef.make(GridRef.make(lat, N), P)
    eps = sphere_ref(13.0, 1.0, 0.25, 0.5 * lat.A.sum(axis=0), lat.A)
    op = CurlRef(sp, eps=eps, dtype=jnp.complex64)
    solve = op.make_solve_fn(deflation="project-cheby", precond="fastdiag")
    sweep = SweepRef(op, nev=NEV, block=NEV + 6, tol=1e-6, maxiter=400,
                     solve_fn=solve, device_tol=1e-4)
    out = {}
    for s in SEEDS:
        sweep.seed = s
        r = sweep.run_warm(kc)
        out[s] = (np.asarray(r.eigenvalues), np.asarray(r.iterations))
    return out


@pytest.fixture(scope="module")
def runs():
    """{seed: {"port": SweepResult, "ref": (bands, iterations)}}; the
    reference runs on a worker thread beside the port."""
    lat, sp, eps = cd.problem(N, P, 13.0, 0.25)
    kc = cd.kpoints(lat, NK)[:2]
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_ref_runs, kc)
        sweep = cd._sweep(sp, eps, NEV, torch.complex64, "cpu", 1e-4, 1e-6)
        port = {}
        for s in SEEDS:
            sweep.seed = s
            port[s] = sweep.run_warm(kc)
        ref = ref.result()
    return {s: {"port": port[s], "ref": ref[s]} for s in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
def test_k1_bands_match_reference(runs, seed):
    lam = runs[seed]["port"].eigenvalues[1]
    lam_ref = runs[seed]["ref"][0][1]
    floor = BAND_FLOOR * float(np.abs(lam_ref).max())
    err = np.abs(lam - lam_ref) / np.maximum(np.abs(lam_ref), floor)
    assert err.max() < BAR, (seed, err.max(), lam, lam_ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_k1_host_residuals(runs, seed):
    res = runs[seed]["port"].residuals[1]
    assert res.max() < RESID_BAR, (seed, res)


@pytest.mark.parametrize("seed", SEEDS)
def test_iterations_match_reference(runs, seed):
    its = runs[seed]["port"].iterations
    its_ref = runs[seed]["ref"][1]
    assert np.all(np.abs(its - its_ref) <= ITER_SLACK), (seed, its, its_ref)


def _grams():
    """Hermitian Grams (12×12, complex128): positive definite; with a
    near-null direction; indefinite at a late and at an early pivot."""
    rng = np.random.default_rng(16)
    n = 12
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Q = np.linalg.qr(A)[0]
    pd = (Q * np.geomspace(1.0, 10.0, n)) @ Q.conj().T
    near = (Q * np.r_[1e-13, np.geomspace(1.0, 10.0, n - 1)]) @ Q.conj().T
    late = pd.copy()
    late[n - 2, n - 2] = -5.0
    early = pd.copy()
    early[1, 1] = -5.0
    return {"pd": pd, "near_null": near, "indefinite_late": late,
            "indefinite_early": early}


@pytest.mark.parametrize("case", ["pd", "near_null", "indefinite_late",
                                  "indefinite_early", "batched"])
def test_whiten_chol_matches_reference(case):
    """The port's Cholesky whitening keeps the directions the reference's
    keeps, and the same C on them: an indefinite Gram (a failed pivot
    anywhere) drops every direction on both; a batch drops per matrix,
    as the reference under vmap."""
    grams = _grams()
    if case == "batched":
        G = np.stack([grams["pd"], grams["indefinite_late"]])
        C_ref, good_ref = jax.vmap(whiten_ref, in_axes=(0, None))(
            jnp.asarray(G), 50.0 * np.finfo(np.float64).eps)
    else:
        G = grams[case]
        C_ref, good_ref = whiten_ref(jnp.asarray(G),
                                     50.0 * np.finfo(np.float64).eps)
    C, good = _whiten_chol(torch.as_tensor(G),
                           50.0 * torch.finfo(torch.float64).eps)
    good_ref = np.asarray(good_ref)
    np.testing.assert_array_equal(good.numpy(), good_ref)
    np.testing.assert_allclose(C.resolve_conj().numpy(), np.asarray(C_ref),
                               rtol=0,
                               atol=1e-10 * float(np.abs(C_ref).max() or 1))
    if case.startswith("indefinite"):
        assert not good_ref.any()



@pytest.mark.parametrize("whole", [True, False])
def test_chol_rows_drop(whole):
    """A failed pivot drops every row of its matrix (``whole``, the first
    factorization) or the rows from the pivot on (the second); the other
    matrix of the batch keeps all its rows."""
    grams = _grams()
    G = torch.as_tensor(np.stack([grams["pd"], grams["indefinite_late"]]))
    _, ok = _chol_rows(G, torch.ones((2, 1), dtype=torch.float64), whole)
    n = G.shape[-1]
    assert ok[0].all()
    want = np.zeros(n, bool) if whole else np.arange(n) < n - 2
    np.testing.assert_array_equal(ok[1].numpy(), want)


def test_config1_k1_matches_reference():
    """Config 1 (the SQR empty lattice, n=16 p=4, complex64, spectral
    engine, 10 bands, device stop 1e-3) on the first two k of its
    16-point path: the port's ``run_warm`` takes the reference's
    iterations (±2) and refines the same bands (1e-6 relative). Its k-1
    solve fails the second factorization at one pivot."""
    lat = make_lattice("SQR")
    kc = kpath(lat, npts=16).k_cart[:2]
    op = BlochHelmholtz(H1Space.make(PeriodicGrid.make(lat, 16), 4),
                        dtype=torch.complex64, device="cpu")
    r = BandSweep(op, op.make_solve_fn(), nev=NEV, tol=1e-6, maxiter=400,
                  device_tol=1e-3).run_warm(kc)
    lat_r = make_lattice_ref("SQR")
    op_r = HelmRef(H1Ref.make(GridRef.make(lat_r, 16), 4),
                   dtype=jnp.complex64)
    r_ref = SweepRef(op_r, nev=NEV, tol=1e-6, maxiter=400,
                     solve_fn=op_r.make_solve_fn(), device_tol=1e-3
                     ).run_warm(kpath_ref(lat_r, npts=16).k_cart[:2])
    its_ref = np.asarray(r_ref.iterations)
    assert np.all(np.abs(r.iterations - its_ref) <= ITER_SLACK), (
        r.iterations, its_ref)
    np.testing.assert_allclose(r.eigenvalues, np.asarray(r_ref.eigenvalues),
                               rtol=1e-6)
