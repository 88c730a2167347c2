"""The scalar H1 slice as a whole (configs 1 and 2 cut small) against the
JAX package on the same inputs:

* config 1 (SQR empty lattice, spectral engine), on the port's own state
  and on the reference's: the warm sweep against the reference's
  ``run_warm`` (1e-6 relative; both are exact f64 block eigensolves) and
  the analytic bands (bench.py's measure, 1e-6 at
  n=6 p=4; at n=4 p=2 the discretization error, 1e-2);
* config 2 (SQR ε = 8.9 rods, TM, matrix-free, ``precond="auto"`` → GMG,
  complex64): the refined bands within 1e-6 relative of the reference's
  ``run_warm`` and of the dense complex128 oracle (band 1 at Γ, λ = 0,
  within 1e-6 of the top band), iterations per k within ±1;
* the TE air-hole crystal at M (varying α): "auto" picks GMG and the
  refined bands hold against the dense oracle;
* ``host_rayleigh_ritz`` of a ``BlochHelmholtz`` block (twins applied
  row by row) against the reference's;
* the port's dense oracle ``assemble_h1`` against the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.eigen.refine import host_rayleigh_ritz as hrr_ref
from bravais_tpu.lattices import kpath as kpath_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.dense import assemble_h1 as assemble_ref
from bravais_tpu.operators.helmholtz import BlochHelmholtz as HelmRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu.utils.reim import to_reim
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.convert import helmholtz_from_reference
from bravais_tpu_torch.eigen.refine import host_rayleigh_ritz
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_rod
from bravais_tpu_torch.operators.dense import assemble_h1
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.spaces.h1 import H1Space
from tests.oracles.analytic import scalar_bands

torch.set_num_threads(1)


def _space(lat, n, p):
    return (H1Space.make(PeriodicGrid.make(make_lattice(lat), n), p),
            H1Ref.make(GridRef.make(make_lattice_ref(lat), n), p))


def _band_err(lam, ref):
    """|λ − λ_ref| relative to λ_ref, and to the top band where λ_ref is
    below 1e-3 of it (band 1 at Γ, λ = 0)."""
    top = np.max(np.abs(ref), axis=-1, keepdims=True)
    scale = np.where(np.abs(ref) > 1e-3 * top, np.abs(ref), top)
    return np.max(np.abs(lam - ref) / scale)


def _dense_bands(sp, k, nev, alpha=1.0, beta=1.0):
    A, M = assemble_h1(sp, k, alpha=alpha, beta=beta)
    return scipy.linalg.eigh(A, M, eigvals_only=True)[:nev]


@pytest.mark.parametrize("state", ["own", "reference"])
@pytest.mark.parametrize("n,p,analytic_tol", [(4, 2, 1e-2), (6, 4, 1e-6)],
                         ids=["n4p2", "n6p4"])
def test_config1_spectral_matches_reference_and_analytic(n, p, analytic_tol,
                                                         state):
    """``state="reference"`` runs the port on the reference's α, β planes
    and stencils (``convert.helmholtz_from_reference``); "own" on its own
    evaluation and extraction."""
    sp, spr = _space("SQR", n, p)
    lat = sp.grid.lattice
    kc = kpath(lat, npts=5).k_cart            # Γ–X–M–Γ, Γ not nudged
    opr = HelmRef(spr, dtype=jnp.complex64)
    if state == "own":
        op = BlochHelmholtz(sp, device="cpu")
    else:
        op = helmholtz_from_reference(sp, opr._alpha_q64, opr._beta_q64,
                                      opr.qp_fastdiag().stencils, "cpu")
    res = BandSweep(op, op.make_solve_fn(), nev=4, tol=1e-6, maxiter=400,
                    device_tol=1e-3).run_warm(kc)
    rref = SweepRef(opr, nev=4, tol=1e-6, maxiter=400, device_tol=1e-3,
                    solve_fn=opr.make_solve_fn()).run_warm(
        kpath_ref(make_lattice_ref("SQR"), npts=5).k_cart)
    assert res.fallbacks == 0 and np.max(res.residuals) < 1e-10
    assert _band_err(res.eigenvalues, rref.eigenvalues) < 1e-6
    assert np.all(np.abs(res.iterations - np.asarray(rref.iterations)) <= 1)
    k32 = kc.astype(np.float32).astype(np.float64)   # the solved k
    for i, k in enumerate(k32):
        ex = scalar_bands(lat, k, 4)
        err = np.max(np.abs(res.eigenvalues[i] - ex)) / max(ex.max(), 1.0)
        assert err < analytic_tol, (i, err)


def _rods(lat):
    return dielectric_rod(8.9, 1.0, 0.2, 0.5 * lat.A.sum(axis=0), lat.A)


def test_config2_gmg_sweep_matches_reference_and_dense():
    sp, spr = _space("SQR", 8, 2)
    lat = sp.grid.lattice
    eps = _rods(lat)
    kc = kpath(lat, npts=4).k_cart
    op = BlochHelmholtz(sp, alpha=1.0, beta=eps, device="cpu")
    sweep = BandSweep(op, nev=4, block=8, tol=1e-6, maxiter=400,
                      device_tol=1e-4)
    assert sweep.precond_mode == "gmg" and sweep.gmg is not None
    res = sweep.run_warm(kc)
    opr = HelmRef(spr, alpha=1.0, beta=eps, dtype=jnp.complex64)
    rref = SweepRef(opr, nev=4, block=8, tol=1e-6, maxiter=400,
                    device_tol=1e-4).run_warm(
        kpath_ref(make_lattice_ref("SQR"), npts=4).k_cart)
    assert np.all(np.abs(res.iterations - np.asarray(rref.iterations)) <= 1)
    assert _band_err(res.eigenvalues, rref.eigenvalues) < 1e-6
    dense = np.stack([_dense_bands(sp, k, 4, beta=eps)
                      for k in kc.astype(np.float32).astype(np.float64)])
    assert _band_err(res.eigenvalues, dense) < 1e-6
    assert np.max(res.residuals) < 1e-3


def test_te_air_holes_auto_picks_gmg():
    """HEX2D air holes r = 0.48a in ε = 13, TE (α = 1/ε), at M: the
    varying-stiffness case ``precond="auto"`` exists for."""
    sp, _ = _space("HEX2D", 8, 2)
    lat = sp.grid.lattice
    eps = dielectric_rod(1.0, 13.0, 0.48, 0.5 * lat.A.sum(axis=0), lat.A)
    alpha = (lambda x: 1.0 / eps(x))
    op = BlochHelmholtz(sp, alpha=alpha, beta=1.0, device="cpu")
    sweep = BandSweep(op, nev=6, block=10, tol=1e-6, maxiter=300,
                      device_tol=1e-4)
    assert sweep.precond_mode == "gmg"
    k = lat.point_cart("M")[None]
    res = sweep.run_warm(k)
    assert np.max(res.residuals) < 1e-3
    dense = _dense_bands(sp, k[0].astype(np.float32).astype(np.float64), 6,
                         alpha=alpha)
    assert _band_err(res.eigenvalues[0], dense) < 1e-6


def test_host_rayleigh_ritz_on_helmholtz_block():
    """The refine of a BlochHelmholtz block: its host twins take one field,
    so they are applied row by row, as the reference does."""
    sp, spr = _space("SQR", 4, 2)
    lat = sp.grid.lattice
    eps = _rods(lat)
    op = BlochHelmholtz(sp, alpha=1.0, beta=eps, device="cpu")
    opr = HelmRef(spr, alpha=1.0, beta=eps, dtype=jnp.complex64)
    k = np.asarray(lat.k_cart((0.3, 0.1)))
    rng = np.random.default_rng(4)
    X = (rng.standard_normal((6,) + sp.dof_shape)
         + 1j * rng.standard_normal((6,) + sp.dof_shape))
    lam, res = host_rayleigh_ritz(op, X, k, 4)
    lam_r, res_r = hrr_ref(opr, np.asarray(to_reim(jnp.asarray(X))), k, 4)
    np.testing.assert_allclose(lam, lam_r, rtol=1e-12)
    np.testing.assert_allclose(res, res_r, rtol=1e-9)


def test_assemble_h1_matches_reference():
    sp, spr = _space("HEX2D", (3, 4), 2)
    k = np.asarray(sp.grid.lattice.k_cart((0.2, -0.4)))
    beta = (lambda x: 1.0 + x[..., 0] ** 2)
    for got, want in zip(assemble_h1(sp, k, alpha=2.0, beta=beta),
                         assemble_ref(spr, k, alpha=2.0, beta=beta)):
        np.testing.assert_array_equal(got, want)
