"""The slice as a whole: the port's warm spectral sweep against the JAX
``BandSweep.run_warm`` and the analytic empty-lattice bands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.lattices import kpath as kpath_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.bands.sweep import BandSweep, RefineError
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
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, N), P))
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


def test_refine_cross_check_failure_raises():
    """A refine that disagrees with the device (here: a support that
    points at the wrong blocks) raises and names k instead of silently
    keeping the device values."""
    lat, op, sweep = _port_sweep()
    k = np.asarray(lat.k_cart((0.25, 0.0, 0.25)))
    r, support = sweep.solve_fn(sweep._x0(), k, NEV, 1e-3, 250)
    lam_d = r.eigenvalues.double().numpy()
    lam, res = sweep._refine_host(lam_d, support.double().numpy(), k)
    assert np.max(res) < 1e-10
    wrong = np.roll(support.double().numpy(), 7, axis=1)
    with pytest.raises(RefineError, match="k="):
        sweep._refine_host(lam_d, wrong, k)
    with pytest.raises(RefineError, match="empty"):
        sweep._refine_host(lam_d, np.zeros_like(wrong), k)
