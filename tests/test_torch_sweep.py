"""The slice as a whole: the port's warm spectral sweep against the JAX
``BandSweep.run_warm`` and the analytic empty-lattice bands (also at
k-points that float32 does not represent, which both packages round to
the device precision), and the spectral refine's host Rayleigh–Ritz
fallback against the JAX one."""

import jax.numpy as jnp
import numpy as np
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.eigen.refine import host_rayleigh_ritz as hrr_ref
from bravais_tpu.lattices import kpath as kpath_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu.utils.reim import to_reim
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace
from tests.oracles.analytic import maxwell_bands

torch.set_num_threads(1)

NEV, M, N, P = 4, 8, 4, 2


def _nudged(lat, kp):
    """Exact-Γ points become 2e-2·b₁ (as bench.py does)."""
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]
    return kc


def _port_sweep():
    lat = make_lattice("FCC")
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, N), P),
                       device="cpu")
    sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=NEV, block=M,
                      tol=1e-6, maxiter=250, device_tol=1e-3)
    return lat, op, sweep


def test_run_warm_matches_reference_and_oracle():
    lat, _, sweep = _port_sweep()
    kc = _nudged(lat, kpath(lat, npts=5, path=[["G", "X", "W", "L"]]))
    # The reference casts k to the device precision before solving and
    # refining; hand the port the same (float32-representable) points.
    kc = kc.astype(np.float32).astype(np.float64)
    res = sweep.run_warm(kc)

    latr = make_lattice_ref("FCC")
    kcr = _nudged(latr, kpath_ref(latr, npts=5, path=[["G", "X", "W", "L"]]))
    np.testing.assert_array_equal(kc, kcr.astype(np.float32))
    ref = CurlRef(NedRef.make(GridRef.make(latr, N), P),
                  dtype=jnp.complex64)
    sref = SweepRef(ref, nev=NEV, block=M, tol=1e-6, maxiter=250,
                    solve_fn=ref.make_solve_fn(engine="spectral",
                                               pc_rep="factor"),
                    device_tol=1e-3)
    rref = sref.run_warm(kcr)

    its, its_r = res.iterations, np.asarray(rref.iterations)
    assert np.all(np.abs(its - its_r) <= 2), (its.tolist(), its_r.tolist())
    # Both are exact f64 block eigensolves of the same candidate blocks.
    np.testing.assert_allclose(res.eigenvalues, rref.eigenvalues,
                               rtol=1e-9, atol=1e-12)
    assert np.max(res.residuals) < 1e-10
    for i, k in enumerate(kc):
        ex = maxwell_bands(lat, k, NEV)
        scale = max(ex.max(), 1e-3)
        for lam in (res.eigenvalues[i], rref.eigenvalues[i]):
            assert np.max(np.abs(lam - ex)) / scale < 6e-2, (i, lam, ex)


def test_run_warm_rounds_k_as_reference():
    """k-points that float32 does not represent: the port rounds them to
    the device precision before solving and refining, as the reference
    does, so both refine at the same k to f64 accuracy."""
    lat, _, sweep = _port_sweep()
    kc = np.asarray([lat.k_cart(f) for f in ((0.31, 0.07, 0.23),
                                             (0.37, 0.11, 0.05))])
    assert not np.array_equal(kc.astype(np.float32).astype(np.float64), kc)
    res = sweep.run_warm(kc)
    ref = CurlRef(NedRef.make(GridRef.make(make_lattice_ref("FCC"), N), P),
                  dtype=jnp.complex64)
    rref = SweepRef(ref, nev=NEV, block=M, tol=1e-6, maxiter=250,
                    solve_fn=ref.make_solve_fn(engine="spectral",
                                               pc_rep="factor"),
                    device_tol=1e-3).run_warm(kc)
    np.testing.assert_allclose(res.eigenvalues, rref.eigenvalues,
                               rtol=1e-9, atol=1e-12)
    assert res.fallbacks == 0 and np.max(res.residuals) < 1e-10


def test_refine_cross_check_failure_raises():
    """A refine that disagrees with the device (here: a support that
    points at the wrong blocks) or an empty support no longer raises: it
    falls back to the f64 host Rayleigh–Ritz on all m rows of the
    eigenvector block, which matches the JAX ``host_rayleigh_ritz`` on
    the same block (exact fast-diagonal gradient projection)."""
    lat, op, sweep = _port_sweep()
    k = np.asarray(lat.k_cart((0.25, 0.0, 0.25)))
    r, support = sweep.solve_fn(sweep._x0(), k, NEV, 1e-3, 250)
    lam_d = r.eigenvalues.double().numpy()
    sup = support.double().numpy()
    lam, res, fell = sweep._refine_host(lam_d, sup, r.eigenvectors, k)
    assert not fell and np.max(res) < 1e-10

    ref = CurlRef(NedRef.make(GridRef.make(make_lattice_ref("FCC"), N), P),
                  dtype=jnp.complex64)
    X = r.eigenvectors.numpy()
    lam_r, res_r = hrr_ref(ref, np.asarray(to_reim(jnp.asarray(X))), k, NEV,
                           rows=M)
    for bad in (np.roll(sup, 7, axis=1), np.zeros_like(sup)):
        lam_f, res_f, fell = sweep._refine_host(lam_d, bad, r.eigenvectors,
                                                k)
        assert fell
        np.testing.assert_allclose(lam_f, lam_r, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(res_f, res_r, rtol=1e-6, atol=1e-10)
    # Over a block converged only to the 1e-3 device stop, the fallback
    # still agrees with the exact block refine within the cross-check's
    # own 3e-2 bar.
    assert np.max(np.abs(lam_r - lam) / lam) < 3e-2
