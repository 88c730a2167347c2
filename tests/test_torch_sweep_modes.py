"""The reference's remaining sweep schedules on the built-in solve, against
the JAX package's (``tests/test_sweep.py``'s problems: SQR scalar
Helmholtz, n=6 p=2, complex128, Jacobi):

* ``run_warm_chain`` with a ragged last chain (nk=10, chain 4) against
  the k-batched ``run`` (1e-9) and the reference's ``run_warm_chain``
  (eigenvalues within 1e-10 relative): the chain is ``run_warm``'s solves
  in ``run_warm``'s order, bit for bit, as the reference's chain gives its
  ``run_warm``'s iterations. The built-in solve's warm iterations differ
  between the packages in ``run_warm`` already (port [38, 17, 6, 7, 7, 6,
  8, 4, 4, 5], reference [40, 16, 6, 7, 10, 7, 14, 7, 7, 12]), so they
  are held port against port here; the spectral engine's chain is held to
  the reference's iterations;
* the chain with ``keep_vectors`` and a writer: every mode satisfies the
  reference operator's eigen-equation, every k is on disk;
* ``restart_tol``: the two-phase ``run`` against the single-phase ``run``
  (1e-9) and the reference's two-phase run (1e-9), its iterations the sum
  of the two phases' solves and within ±2 of the reference's (measured:
  port [43, 39, 38, 40, 39, 39], reference [41, 39, 38, 41, 39, 41]; the
  single-phase runs part by ±1 already). Its residuals stay under 1e-8: a
  LOBPCG at tol 1e-9 reports up to 2.7e-9 (port, the restart run's Γ
  pair) and 1.1e-9 (the reference's single-phase run).

The spectral engine's chain modes are in
``test_torch_sweep_modes_spectral.py`` and ``test_torch_sweep_modes_pc.py``,
the field engine's chain and the near-Γ stop in
``test_torch_sweep_modes_field.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.lattices import kpath as kpath_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.helmholtz import BlochHelmholtz as HelmRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu_torch.bands import BandWriter
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.spaces.h1 import H1Space

torch.set_num_threads(1)

KW = dict(nev=3, block=6, tol=1e-9, maxiter=200)


def _port(n=6, p=2):
    lat = make_lattice("SQR")
    sp = H1Space.make(PeriodicGrid.make(lat, n), p)
    return lat, BlochHelmholtz(sp, dtype=torch.complex128, device="cpu")


def _ref(n=6, p=2):
    lat = make_lattice_ref("SQR")
    return lat, HelmRef(H1Ref.make(GridRef.make(lat, n), p),
                        dtype=jnp.complex128)


def _rel(a, b):
    """max |a − b| over max(|b|, 1e-3 of the k's top band): the zero band
    at Γ is held absolutely."""
    scale = np.maximum(np.abs(b), 1e-3 * np.abs(b).max(axis=1,
                                                       keepdims=True))
    return float(np.max(np.abs(a - b) / scale))


@pytest.fixture(scope="module")
def chain10():
    """The port's chain of 4 over 10 k (a ragged last chain of 2) and the
    reference's on the same k."""
    lat, op = _port()
    kc = kpath(lat, npts=10).k_cart
    latr, opr = _ref()
    np.testing.assert_array_equal(kc, kpath_ref(latr, npts=10).k_cart)
    res = BandSweep(op, **KW).run_warm_chain(kc, chain=4)
    ref = SweepRef(opr, **KW).run_warm_chain(kc, chain=4)
    return op, kc, res, ref


def test_warm_chain_matches_batched_and_reference(chain10):
    op, kc, res, ref = chain10
    assert res.eigenvalues.shape == (len(kc), 3)
    assert res.iterations.shape == (len(kc),)
    batched = BandSweep(op, **KW).run(kc)
    np.testing.assert_allclose(res.eigenvalues, batched.eigenvalues,
                               rtol=1e-9, atol=1e-9)
    assert _rel(res.eigenvalues, ref.eigenvalues) < 1e-10
    # The chain is run_warm's solves in run_warm's order.
    warm = BandSweep(op, **KW).run_warm(kc)
    np.testing.assert_array_equal(res.eigenvalues, warm.eigenvalues)
    np.testing.assert_array_equal(res.iterations, warm.iterations)


def test_warm_chain_keep_vectors_and_writer(tmp_path):
    lat, op = _port()
    _, opr = _ref()
    kc = kpath(lat, npts=6).k_cart
    w = BandWriter(tmp_path / "run", {"t": 1}, len(kc), 2)
    calls = []
    orig = w.write_chunk
    w.write_chunk = lambda idx, *a: (calls.append(list(idx)), orig(idx, *a))
    sweep = BandSweep(op, **dict(KW, nev=2), keep_vectors=True)
    res = sweep.run_warm_chain(kc, chain=4, writer=w)
    assert sweep.chain_mode == "per-k"       # the built-in solve: no hooks
    assert calls == [[0, 1, 2, 3], [4, 5]]   # chain by chain
    assert res.eigenvectors.shape[:2] == (len(kc), 2)
    for i in range(len(kc)):
        k = jnp.asarray(kc[i])
        for j in range(2):
            x = jnp.asarray(res.eigenvectors[i, j])
            Av = np.asarray(opr.apply_A(x, k))
            Mv = np.asarray(opr.apply_M(x))
            lam = res.eigenvalues[i, j]
            r = np.linalg.norm(Av - lam * Mv)
            assert r < 1e-6 * max(abs(lam), 1.0) * np.linalg.norm(Mv), (
                i, j, r)
    assert w.finished == list(range(len(kc)))
    np.testing.assert_array_equal(w.eigenvalues, res.eigenvalues)


def test_restart_matches_single_phase_and_reference():
    lat, op = _port()
    kc = kpath(lat, npts=6).k_cart
    sweep = BandSweep(op, **KW, restart_tol=1e-3)
    calls, solve = [], sweep._batched_solve()

    def recording(*args):
        r, support = solve(*args)
        calls.append((args[3], r.iterations.copy()))
        return r, support
    sweep._batched_solve = lambda: recording
    res = sweep.run(kc)
    one = BandSweep(op, **KW).run(kc)
    np.testing.assert_allclose(res.eigenvalues, one.eigenvalues, rtol=1e-9,
                               atol=1e-9)
    assert np.max(res.residuals) < 1e-8
    assert [tol for tol, _ in calls] == [1e-3, 1e-9]
    np.testing.assert_array_equal(res.iterations,
                                  calls[0][1] + calls[1][1])
    latr, opr = _ref()
    ref = SweepRef(opr, **KW, restart_tol=1e-3).run(
        kpath_ref(latr, npts=6).k_cart)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                               rtol=1e-9, atol=1e-9)
    assert np.all(np.abs(res.iterations - ref.iterations) <= 2), (
        res.iterations, ref.iterations)
