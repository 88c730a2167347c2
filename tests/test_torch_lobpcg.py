"""The port's LOBPCG: the reference's eigensolver tests run against the
port, and one spectral solve from the same start block in both
packages."""

import jax.numpy as jnp
import numpy as np
import scipy.linalg
import torch

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.convert import fastdiag_from_reference
from bravais_tpu_torch.eigen.lobpcg import lobpcg
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)


def _rand_hermitian(n, seed, dtype=np.complex128, spd_shift=0.0):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = 0.5 * (H + H.conj().T)
    return (H + spd_shift * np.eye(n)).astype(dtype)


def _x0(m, shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m,) + tuple(shape))
            + 1j * rng.standard_normal((m,) + tuple(shape)))


def _matop(H):
    Ht = torch.as_tensor(H)
    return lambda X: X @ Ht.T


def test_lobpcg_generalized_vs_scipy():
    n, nev, m = 90, 5, 9
    H = _rand_hermitian(n, 1)
    Mm = _rand_hermitian(n, 2, spd_shift=2.0 * n)
    exact = scipy.linalg.eigh(H, Mm, eigvals_only=True)[:nev]
    res = lobpcg(_matop(H), _matop(Mm), torch.as_tensor(_x0(m, (n,), 3)),
                 nev, maxiter=300, tol=1e-9)
    assert bool(res.converged.all())
    lam = res.eigenvalues.numpy()
    np.testing.assert_allclose(lam, exact, rtol=1e-8, atol=1e-8)
    X = res.eigenvectors.numpy()[:nev]
    for j in range(nev):
        lhs, rhs = H @ X[j], lam[j] * (Mm @ X[j])
        assert np.linalg.norm(lhs - rhs) < 1e-6 * np.linalg.norm(rhs)


def test_lobpcg_reseeds_zero_warm_rows():
    """Zero warm-start rows are absorbing without the reseed."""
    n, nev, m = 60, 5, 9
    H = _rand_hermitian(n, 7)
    exact = scipy.linalg.eigh(H, eigvals_only=True)[:nev]
    X0 = _x0(m, (n,), 11)
    X0[nev:] = 0.0
    r = lobpcg(_matop(H), None, torch.as_tensor(X0), nev, maxiter=300,
               tol=1e-9, generator=torch.Generator().manual_seed(5))
    assert bool(r.converged.all())
    np.testing.assert_allclose(r.eigenvalues.numpy(), exact, rtol=1e-8,
                               atol=1e-8)
    X = r.eigenvectors.numpy()
    assert np.all(np.linalg.norm(X[:nev], axis=1) > 0.1)


def test_lobpcg_knife_edge_tol_terminates_fast():
    """A stop below the f32 residual floor ends by the stagnation stop,
    not at maxiter, with finite outputs."""
    n, nev, m = 80, 4, 8
    H = _rand_hermitian(n, 13, dtype=np.complex64, spd_shift=4.0 * n)
    r = lobpcg(_matop(H), None,
               torch.as_tensor(_x0(m, (n,), 17).astype(np.complex64)),
               nev, maxiter=400, tol=1e-12)
    assert r.iterations < 120
    lam = r.eigenvalues.numpy()
    assert np.all(np.isfinite(lam))
    assert np.linalg.norm(r.eigenvectors.numpy()) > 0.1
    exact = scipy.linalg.eigh(H.astype(np.complex128),
                              eigvals_only=True)[:nev]
    np.testing.assert_allclose(lam, exact, rtol=1e-4)


def test_spectral_solve_matches_reference():
    """One complex64 spectral solve at FCC n=4 p=2 on the reference's
    stencils: device eigenvalues within the device stop, and the same
    candidate blocks for the refine."""
    nev, m, tol = 4, 8, 1e-3
    latr = make_lattice_ref("FCC")
    ref = CurlRef(NedRef.make(GridRef.make(latr, 4), 2),
                  dtype=jnp.complex64)
    fdr = ref.fastdiag_G()
    op = BlochCurlCurl(NedelecSpace.make(
        PeriodicGrid.make(make_lattice("FCC"), 4), 2), device="cpu")
    op.set_fastdiag(fastdiag_from_reference(
        {k: np.asarray(v) for k, v in fdr.stencils.items()}, fdr.shape,
        fdr.p, fdr.ncomp, fdr.A_rows, device="cpu"))
    k = np.asarray(latr.k_cart((0.25, 0.0, 0.25)))
    X0 = _x0(m, ref.space.field_shape, 5).astype(np.complex64)

    rr, supr = ref.make_solve_fn(engine="spectral", pc_rep="factor")(
        ref, jnp.asarray(X0), jnp.asarray(k), nev, tol, 250, None)
    r, sup = op.make_spectral_solve_fn()(torch.as_tensor(X0), k, nev, tol,
                                         250)
    lam_r = np.asarray(rr.eigenvalues, np.float64)
    lam = r.eigenvalues.double().numpy()
    scale = np.maximum(np.abs(lam_r), 0.3 * np.abs(lam_r).max())
    assert np.max(np.abs(lam - lam_r) / scale) < tol, (lam, lam_r)
    assert abs(r.iterations - int(rr.iterations)) <= 2, (
        r.iterations, int(rr.iterations))
    fd = op.fastdiag_G()
    cand = fd.candidate_blocks(sup.double().numpy()[:nev + 2])
    cand_r = fd.candidate_blocks(np.asarray(supr, np.float64)[:nev + 2])
    np.testing.assert_array_equal(cand, cand_r)
    assert r.eigenvectors.shape == (m,) + ref.space.field_shape
