"""The k-batched sweep (a LOBPCG with a leading k axis) against a per-k
loop of the same solve and against the JAX package's vmapped
``BandSweep.run``, on 3D ``BlochHelmholtz`` (TRI, config 5's most oblique
lattice, cut to n=3 p=2), and a batched run checkpointed by a
``BandWriter`` and resumed.

Tolerances: batched against looped, iterations equal per k and device
eigenvalues within 1e-5 relative (float32, sums batched in another
order); against the reference's vmapped run, refined eigenvalues within
1e-6 relative (f64 refines of device vectors or supports that agree to
float32) and iterations within ±1 per k."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.helmholtz import BlochHelmholtz as HelmRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu_torch.bands import BandWriter
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.cli.config5_all14 import KFRAC, PARAMS
from bravais_tpu_torch.eigen.lobpcg import PROD_RR_TOL, lobpcg
from bravais_tpu_torch.eigen.precond import jacobi
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.spaces.h1 import H1Space

torch.set_num_threads(1)

NEV, BLOCK = 4, 8
# KFRAC rows 0, 1 and 5: the matrix-free solve of row 1 stops at 16
# iterations (a segment boundary), the others run on to 17 and 21.
ROWS = [0, 1, 5]


def _tri(n=3, p=2):
    lat = make_lattice("TRI", **PARAMS["TRI"])
    sp = H1Space.make(PeriodicGrid.make(lat, n), p)
    ks = np.asarray([lat.k_cart(f) for f in KFRAC[ROWS]], np.float32)
    return lat, BlochHelmholtz(sp, device="cpu"), ks


def _x0(op, m=BLOCK, seed=0):
    rng = np.random.default_rng(seed)
    shp = (m,) + tuple(op.space.dof_shape)
    return torch.complex(torch.as_tensor(rng.standard_normal(shp),
                                         dtype=torch.float32),
                         torch.as_tensor(rng.standard_normal(shp),
                                         dtype=torch.float32))


def test_batched_lobpcg_equals_per_k_loop():
    """One batched LOBPCG over three k against three unbatched calls of
    the same solve (Jacobi preconditioner, fused (A, M)): a k that is done
    is frozen while the others go on, so each k takes the iterations it
    takes alone."""
    _, op, ks = _tri()
    X0 = _x0(op)
    kw = dict(maxiter=300, tol=1e-5, rr_tol=PROD_RR_TOL)
    rb = lobpcg(lambda x: op.apply_A(x, ks), op.apply_M,
                X0.expand((len(ks),) + X0.shape), NEV,
                precond=jacobi(op.diag_A(ks), batched=True),
                AM=lambda x: op.apply_AM(x, ks), batched=True, **kw)
    loop = [lobpcg(lambda x: op.apply_A(x, k), op.apply_M, X0, NEV,
                   precond=jacobi(op.diag_A(k)),
                   AM=lambda x: op.apply_AM(x, k), **kw) for k in ks]
    its = [r.iterations for r in loop]
    assert rb.iterations.tolist() == its, (rb.iterations, its)
    assert len(set(its)) == len(its)          # the k-points stop apart
    lam = np.stack([r.eigenvalues.numpy() for r in loop])
    assert rb.eigenvalues.shape == (len(ks), NEV)
    np.testing.assert_allclose(rb.eigenvalues.numpy(), lam, rtol=1e-5)
    assert rb.eigenvectors.shape == (len(ks), BLOCK) + op.space.dof_shape
    assert bool(rb.converged.all())


@pytest.mark.parametrize("engine", ["field", "spectral"])
def test_batched_run_matches_reference_vmapped(engine):
    """The port's ``run`` (one batched solve) against the reference's
    ``run`` (one vmapped program) from the same seeded start block, on the
    matrix-free engine ("field": Jacobi, fused h1 apply) and the spectral
    engine; then ``chunk=1`` (one k per solve) gives the same bands and
    iterations."""
    lat, op, ks = _tri()
    spr = H1Ref.make(GridRef.make(make_lattice_ref("TRI", **PARAMS["TRI"]),
                                  3), 2)
    opr = HelmRef(spr, dtype=jnp.complex64)
    solve = op.make_solve_fn() if engine == "spectral" else None
    solve_ref = (opr.make_solve_fn(engine="spectral")
                 if engine == "spectral" else None)
    sweep = BandSweep(op, solve, nev=NEV, block=BLOCK, tol=1e-6,
                      maxiter=300)
    res = sweep.run(ks)
    ref = SweepRef(opr, nev=NEV, block=BLOCK, tol=1e-6, maxiter=300,
                   solve_fn=solve_ref).run(np.asarray(ks, np.float64))
    lam_r = np.asarray(ref.eigenvalues)[:, :NEV]
    np.testing.assert_allclose(res.eigenvalues, lam_r, rtol=1e-6)
    assert np.all(np.abs(res.iterations - np.asarray(ref.iterations)) <= 1), \
        (res.iterations, ref.iterations)
    one = sweep.run(ks, chunk=1)
    assert one.iterations.tolist() == res.iterations.tolist()
    np.testing.assert_allclose(one.eigenvalues, res.eigenvalues, rtol=1e-6)


def test_batched_run_resumes_and_recomputes_nothing(tmp_path):
    """A batched run in chunks of 2 with a writer is killed after its first
    chunk; the resume solves only the k it had not finished (one batched
    solve of them) and the bands equal an uninterrupted run's; a second
    resume solves nothing."""
    _, op, ks = _tri()
    ks = np.concatenate([ks, ks[:1] * 0.5])              # nk = 4
    nk = len(ks)
    sweep = BandSweep(op, op.make_solve_fn(), nev=NEV, block=BLOCK,
                      tol=1e-6, maxiter=300)
    full = sweep.run(ks, chunk=2)
    calls = []
    solve = sweep.solve_fn

    def counted(X0, k, *a):
        calls.append(np.asarray(k).shape)
        return solve(X0, k, *a)
    counted.__dict__.update(solve.__dict__)
    sweep.solve_fn = counted

    w = BandWriter(tmp_path, {"c": 5}, nk, NEV)
    sweep.run(ks[:2], chunk=2, writer=w, k_index=np.arange(2))   # killed
    w2 = BandWriter(tmp_path, {"c": 5}, nk, NEV)
    done = w2.try_resume()
    assert done == [0, 1]
    todo = np.asarray([i for i in range(nk) if i not in done])
    calls.clear()
    sweep.run(ks[todo], chunk=2, writer=w2, k_index=todo)
    assert calls == [(2, 3)]                 # one batched solve of k 2, 3
    assert w2.finished == list(range(nk))
    np.testing.assert_allclose(w2.eigenvalues, full.eigenvalues, rtol=1e-6)
    w3 = BandWriter(tmp_path, {"c": 5}, nk, NEV)
    assert w3.try_resume() == list(range(nk))
