"""Discretization convergence order on the port (the reference's
``tests/test_convergence.py``): the empty-lattice eigenvalue error of the
dense H1 pencil (``assemble_h1``) decays at the spectral-element rate
under h-refinement, with the reference's order floors, and its errors
equal the reference's to 1e-10 relative; the Nédélec p=2 error, from the
exact twisted-DFT block spectrum through ``spectral_refine_np(...,
topk=fd.nblocks, tau=0.0)`` (every block a candidate), decays at order
> 3.4 and equals the reference's to 1e-8 relative."""

import numpy as np
import pytest
import scipy.linalg

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.dense import assemble_h1 as assemble_ref
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.dense import assemble_h1
from bravais_tpu_torch.spaces.h1 import H1Space
from tests.oracles.analytic import maxwell_bands, scalar_bands


def _h1_err(n, p, k, nb=4, ref=False):
    if ref:
        A, M = assemble_ref(H1Ref.make(GridRef.make(
            make_lattice_ref("SQR"), n), p), k)
    else:
        A, M = assemble_h1(H1Space.make(PeriodicGrid.make(
            make_lattice("SQR"), n), p), k)
    vals = scipy.linalg.eigh(np.asarray(A), np.asarray(M),
                             eigvals_only=True)[:nb]
    ex = scalar_bands(make_lattice_ref("SQR"), k, nb, mmax=4)
    # band 1 is exact (constant envelope); measure bands 2..nb
    return float(np.max(np.abs(vals[1:] - ex[1:]) / ex[1:]))


@pytest.mark.parametrize("p,order_floor", [(1, 1.6), (2, 3.5), (3, 5.2)])
def test_h1_eigenvalue_convergence_order(p, order_floor):
    k = make_lattice("SQR").k_cart((0.21, 0.13))
    e1, e2 = _h1_err(4, p, k), _h1_err(8, p, k)
    order = np.log2(e1 / e2)
    assert order > order_floor, (p, e1, e2, order)
    for e, n in ((e1, 4), (e2, 8)):
        assert abs(e - _h1_err(n, p, k, ref=True)) <= 1e-10 * e, (p, n)


def test_nedelec_eigenvalue_convergence_order():
    """Maxwell p=2 on CUB, n = 3 → 6: the exact discrete eigenvalues of
    every twisted-DFT block (f64, no solver error) approach the analytic
    bands at order > 3.4, as in the reference."""
    import jax.numpy as jnp
    import torch
    from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
    from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace

    k = np.asarray(make_lattice("CUB").k_cart((0.21, 0.13, 0.17)))
    errs = []
    for n in (3, 6):
        op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(
            make_lattice("CUB"), n), 2), dtype=torch.complex128,
            device="cpu")
        fd = op.fastdiag_G()
        sup = np.ones((1, fd.nblocks))  # all blocks are candidates
        lam, _ = op.spectral_refine_np(sup, k, 6, topk=fd.nblocks, tau=0.0)
        ref = CurlRef(NedRef.make(GridRef.make(make_lattice_ref("CUB"), n),
                                  2), dtype=jnp.complex128)
        lam_r, _ = ref.spectral_refine_np(sup, k, 6, topk=fd.nblocks,
                                          tau=0.0)
        np.testing.assert_allclose(lam, lam_r, rtol=1e-8)
        ex = maxwell_bands(make_lattice_ref("CUB"), k, 6, mmax=3)
        errs.append(float(np.max(np.abs(lam - ex) / ex)))
    order = np.log2(errs[0] / errs[1])
    assert order > 3.4, (errs, order)
