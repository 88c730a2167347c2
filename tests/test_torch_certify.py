"""The dense Nédélec oracle (``operators/dense.py::assemble_nedelec``)
against the reference's assembly and the port's matrix-free f64 twins,
and the f32 field path certified by it: the port of
``tests/test_maxwell_bands.py::test_dielectric_f32_refine_certified``.

The certification: CUB n=4 p=2 with an ε = 13 or ε = 30 sphere (r =
0.25a), the X point, 5 bands in a block of 9, the field engine
(project-cheby deflation, fastdiag preconditioner) in complex64 with the
production device stop 1e-4, the f64 host refine, through ``run`` of one
k; the refined bands within 1e-6 relative of the complex128 dense solve
of the same discretization with the curl-curl kernel removed
(``deflated_nedelec_bands``, G built from the port's ``apply_Gk``)."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators import dense as dense_ref
from bravais_tpu.operators.coefficients import dielectric_sphere as sph_ref
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_sphere
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.operators.dense import (assemble_nedelec,
                                               deflated_nedelec_bands)
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

CERT_BAR = 1e-6


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One host BLAS thread, as the package sets for its own processes: a
    threaded OpenBLAS spins on the cores the other test workers use (4-5x
    slower dense eigensolves here under load)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _sphere(mod, lat, eps_in):
    return mod(eps_in, 1.0, 0.25, 0.5 * lat.A.sum(axis=0), lat.A, 0.0)


@pytest.mark.parametrize("lat,shape,p,k,eps_in", [
    ("CUB", (2, 2, 2), 1, (0.4, -0.7, 0.2), 1.0),
    ("FCC", (2, 2, 2), 2, (0.5, 0.25, 0.75), 1.0),
    ("CUB", (2, 2, 2), 2, (0.5, 0.0, 0.0), 13.0),
])
def test_assemble_nedelec_matches_reference(lat, shape, p, k, eps_in):
    lattice, lattice_r = make_lattice(lat), make_lattice_ref(lat)
    sp = NedelecSpace.make(PeriodicGrid.make(lattice, shape), p)
    sp_r = NedRef.make(GridRef.make(lattice_r, shape), p)
    kc = lattice.k_cart(k)
    A, M = assemble_nedelec(sp, kc, eps=_sphere(dielectric_sphere, lattice,
                                                eps_in))
    A0, M0 = dense_ref.assemble_nedelec(sp_r, kc, eps=_sphere(
        sph_ref, lattice_r, eps_in))
    np.testing.assert_allclose(A, A0, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(M, M0, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("lat,n,p,eps_in", [("CUB", 3, 2, 13.0),
                                            ("FCC", 2, 2, 1.0)])
def test_assemble_nedelec_matches_matrix_free(lat, n, p, eps_in):
    """The dense pencil applied to random fields equals the port's
    matrix-free f64 twins ``apply_A_np``/``apply_M_np`` (same quadrature,
    same quasi-periodic phases)."""
    lattice = make_lattice(lat)
    sp = NedelecSpace.make(PeriodicGrid.make(lattice, n), p)
    eps = _sphere(dielectric_sphere, lattice, eps_in)
    op = BlochCurlCurl(sp, eps=eps, dtype=torch.complex128, device="cpu")
    k = lattice.k_cart((0.3, -0.2, 0.45))
    A, M = assemble_nedelec(sp, k, eps=eps)
    rng = np.random.default_rng(3)
    U = (rng.standard_normal((3,) + sp.field_shape)
         + 1j * rng.standard_normal((3,) + sp.field_shape))
    for D, twin in ((A, op.apply_A_np), (M, op.apply_M_np)):
        got = twin(U, k).reshape(3, -1)
        want = U.reshape(3, -1) @ D.T
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("eps_in", [13.0, 30.0])
def test_dielectric_f32_refine_certified(eps_in):
    lat = make_lattice("CUB")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 4), 2)
    eps = _sphere(dielectric_sphere, lat, eps_in)
    op32 = BlochCurlCurl(sp, eps=eps, device="cpu")
    assert not op32._coef_elem_invariant()
    k = np.asarray(lat.k_cart((0.5, 0.0, 0.0)), np.float32)
    solve = op32.make_solve_fn(deflation="project-cheby", precond="fastdiag")
    sweep = BandSweep(op32, solve, nev=5, block=9, tol=1e-6, maxiter=250,
                      device_tol=1e-4)
    assert sweep.refine and sweep.tol == 1e-4
    res = sweep.run(np.asarray([k]))

    k64 = np.asarray(k, np.float64)
    A, M = assemble_nedelec(sp, k64, eps=eps)
    op64 = BlochCurlCurl(sp, eps=eps, dtype=torch.complex128, device="cpu")
    nh = int(np.prod(sp.dof_shape))
    units = torch.eye(nh, dtype=torch.complex128).reshape((nh,)
                                                          + sp.dof_shape)
    G = op64.apply_Gk(units, k64).reshape(nh, -1).T.numpy()
    oracle = deflated_nedelec_bands(A, M, G, 5)
    rel = np.abs(res.eigenvalues[0] - oracle) / np.abs(oracle)
    assert rel.max() < CERT_BAR, (eps_in, res.eigenvalues[0], oracle)
