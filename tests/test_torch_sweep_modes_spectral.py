"""``BandSweep.run_warm_chain`` on the spectral Maxwell engine, whose solve
takes a prebuilt preconditioner (``pc=``) or setup (``setup=``), against
the JAX package (``tests/test_sweep.py``'s problem: FCC n=3 p=2,
complex128, 4 bands in 8, tol 1e-8, Γ–X–W at 7 points with Γ nudged,
chains of 3, so the last chain is ragged):

* "per-k" against the reference's ``run_warm_chain``: iterations equal,
  eigenvalues within 1e-10 relative; and bit for bit the port's
  ``run_warm``;
* "chain-mid" (one preconditioner at the chain's middle k) against
  ``run_warm``: eigenvalues within 1e-8 relative (a stale preconditioner
  moves the iterations, not the bands);
* "batched" (every chain k's preconditioner in one call) and
  "batched-setup" (every chain k's blocks, preconditioner and projector
  factor in one call) against "per-k": iterations equal, eigenvalues
  within 1e-12 relative."""

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
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

KW = dict(nev=4, block=8, tol=1e-8, maxiter=200)
CHAIN = 3


def nudged(lat, kc):
    kc = kc.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]
    return kc


def fcc(npts=7, path=("G", "X", "W")):
    """(operator, k-points) of the port's FCC n=3 p=2 problem."""
    lat = make_lattice("FCC")
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 3), 2),
                       dtype=torch.complex128, device="cpu")
    return op, nudged(lat, kpath(lat, npts=npts, path=[list(path)]).k_cart)


def fcc_ref(npts=7, path=("G", "X", "W")):
    """(reference operator, k-points) of the same problem."""
    lat = make_lattice_ref("FCC")
    op = CurlRef(NedRef.make(GridRef.make(lat, 3), 2), dtype=jnp.complex128)
    return op, nudged(lat, kpath_ref(lat, npts=npts,
                                     path=[list(path)]).k_cart)


def rel(a, b):
    """max |a − b| / |b| (no band of these k is near 0)."""
    return float(np.max(np.abs(a - b) / np.abs(b)))


def sweep(op, **kw):
    return BandSweep(op, op.make_spectral_solve_fn(**kw), **KW)


@pytest.fixture(scope="module")
def per_k():
    """(operator, k-points, the port's "per-k" chain)."""
    op, kc = fcc()
    return op, kc, sweep(op).run_warm_chain(kc, chain=CHAIN)


def test_per_k_chain_matches_reference_and_run_warm(per_k):
    op, kc, res = per_k
    opr, kcr = fcc_ref()
    np.testing.assert_array_equal(kc, kcr)
    sref = SweepRef(opr, solve_fn=opr.make_solve_fn(engine="spectral",
                                                    pc_rep="factor"), **KW)
    ref = sref.run_warm_chain(kcr, chain=CHAIN)
    assert sref._jit_chain_mode == "per-k"
    np.testing.assert_array_equal(res.iterations, ref.iterations)
    assert rel(res.eigenvalues, ref.eigenvalues) < 1e-10
    assert res.fallbacks == 0
    warm = sweep(op).run_warm(kc)
    np.testing.assert_array_equal(res.eigenvalues, warm.eigenvalues)
    np.testing.assert_array_equal(res.iterations, warm.iterations)


def test_chain_mid_matches_run_warm(per_k):
    op, kc, ref = per_k
    sw = sweep(op)
    res = sw.run_warm_chain(kc, chain=CHAIN, reuse_precond=True)
    assert sw.chain_mode == "chain-mid"
    assert rel(res.eigenvalues, ref.eigenvalues) < 1e-8
    assert res.iterations.sum() >= ref.iterations.sum()


@pytest.mark.parametrize("mode", ["batched", "batched-setup"])
def test_batched_modes_match_per_k(mode, per_k):
    op, kc, ref = per_k
    sw = sweep(op)
    res = sw.run_warm_chain(kc, chain=CHAIN, precond=mode)
    assert sw.chain_mode == mode
    np.testing.assert_array_equal(res.iterations, ref.iterations)
    assert rel(res.eigenvalues, ref.eigenvalues) < 1e-12
