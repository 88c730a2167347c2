"""The k-batched geometric multigrid: config 2's TM rods (SQR, ε = 8.9,
r = 0.2a, α = 1, β = ε) cut to n=8 p=2 (4 levels), at three k.

* the V-cycle with a k table on (nk, rows, *N) blocks against the per-k
  V-cycles (within 1e-5 relative: float32, the same operations);
* ``BandSweep.run``'s built-in solve with GMG as ONE k-batched LOBPCG
  against ``run(chunk=1)`` (iterations equal per k, device eigenvalues
  within 1e-5 relative, refined within 1e-6) and against the JAX
  package's vmapped ``BandSweep.run`` with ``precond=GMG(...).precond``
  (refined eigenvalues within 1e-6 relative, iterations within ±1), with
  the hierarchy built by the sweep and with the port's
  ``GMG(op).precond`` handed in as a callable."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.eigen.gmg import GMG as GMGRef
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.helmholtz import BlochHelmholtz as HelmRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.eigen.gmg import GMG
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_rod
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.spaces.h1 import H1Space

torch.set_num_threads(1)

NEV, BLOCK = 4, 8


@pytest.fixture(scope="module")
def rods():
    """(port operator, ε, k table (3, 2) as float32 values): k at 0.1 b₁,
    X and M."""
    lat = make_lattice("SQR")
    eps = dielectric_rod(8.9, 1.0, 0.2, 0.5 * lat.A.sum(axis=0), lat.A)
    op = BlochHelmholtz(H1Space.make(PeriodicGrid.make(lat, 8), 2),
                        alpha=1.0, beta=eps, device="cpu")
    ks = np.asarray([lat.k_cart((0.1, 0.0)), lat.point_cart("X"),
                     lat.point_cart("M")], np.float32).astype(np.float64)
    return op, eps, ks


def test_vcycle_takes_a_k_table(rods):
    """``GMG.precond`` at a k table on (nk, rows, *N) blocks: each level's
    diagonal per k, each level apply one h1 call with the table, the
    transfers over the nk·rows rows; equal to the per-k V-cycles."""
    op, _, ks = rods
    sweep = BandSweep(op, nev=NEV, block=BLOCK)
    assert sweep.precond_mode == "gmg" and len(sweep.gmg.levels) == 4
    rng = np.random.default_rng(2)
    shp = (len(ks), 3) + op.space.dof_shape
    R = torch.as_tensor(rng.standard_normal(shp)
                        + 1j * rng.standard_normal(shp), dtype=torch.complex64)
    W = sweep.gmg.precond(ks)(R)
    assert W.shape == R.shape
    for j, k in enumerate(ks):
        Wj = sweep.gmg.precond(k)(R[j])
        assert float(torch.linalg.vector_norm(W[j] - Wj)
                     / torch.linalg.vector_norm(Wj)) < 1e-5


KW = dict(nev=NEV, block=BLOCK, tol=1e-6, maxiter=400, device_tol=1e-4)


@pytest.fixture(scope="module")
def reference_run(rods):
    """The reference's vmapped run with ``precond=GMG(...).precond``."""
    _, eps, ks = rods
    spr = H1Ref.make(GridRef.make(make_lattice_ref("SQR"), 8), 2)
    opr = HelmRef(spr, alpha=1.0, beta=eps, dtype=jnp.complex64)
    gmg = GMGRef(spr, alpha=1.0, beta=eps, dtype=jnp.complex64, fine_op=opr)
    return SweepRef(opr, precond=gmg.precond, **KW).run(ks)


@pytest.mark.parametrize("precond", ["auto", "callable"])
def test_batched_gmg_run_matches_loop_and_reference(rods, reference_run,
                                                    precond):
    """The built-in solve with GMG solves the three k as one batched
    LOBPCG: against ``run(chunk=1)`` and against the reference's vmapped
    run from the same seeded start block. ``precond="auto"`` builds the
    hierarchy; "callable" hands the sweep ``GMG(op).precond``, as the
    reference's caller does, which ``run`` calls with the k table."""
    op, _, ks = rods
    pre = GMG(op).precond if precond == "callable" else "auto"
    sweep = BandSweep(op, precond=pre, **KW)
    got = []
    inner = sweep._batched_solve()

    def rec(X0, k, *a):
        r, sup = inner(X0, k, *a)
        got.append((r.eigenvalues.numpy(), np.asarray(r.iterations)))
        return r, sup
    sweep._batched_solve = lambda: rec
    res = sweep.run(ks)
    one = sweep.run(ks, chunk=1)
    assert len(got) == 1 + len(ks)            # one solve, then one a k
    its_1 = np.concatenate([g[1] for g in got[1:]]).tolist()
    assert got[0][1].tolist() == its_1 == res.iterations.tolist()
    assert one.iterations.tolist() == res.iterations.tolist()
    np.testing.assert_allclose(got[0][0],
                               np.concatenate([g[0] for g in got[1:]]),
                               rtol=1e-5)
    np.testing.assert_allclose(one.eigenvalues, res.eigenvalues, rtol=1e-6)

    rr = reference_run
    assert np.all(np.abs(res.iterations - np.asarray(rr.iterations)) <= 1), \
        (res.iterations, rr.iterations)
    np.testing.assert_allclose(res.eigenvalues,
                               np.asarray(rr.eigenvalues)[:, :NEV],
                               rtol=1e-6)
