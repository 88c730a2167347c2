"""Config 4 on the field engine against the JAX package: the exact
"project" deflation on the FCC and BCC empty lattices, ``cheby_target``,
the Maxwell and QP-Laplace diagonals, and the built-in sweep on a
``BlochCurlCurl`` (Jacobi from ``diag_A``).

* (a) one "project" solve at a non-Γ k on FCC and on BCC (n=3, p=2,
  complex64) from the same numpy start block as the reference's
  ``make_solve_fn(deflation="project", precond="fastdiag")``: eigenvalues
  within 1e-5 relative, iteration counts within ±1 (the two sum in
  another order, and the port fuses A and M);
* (b) a short warm FCC sweep on it against the analytic bands, within
  the discretization error of n=3 p=2;
* (b') at bench.py's field stop 1e-4 the error left in the refined
  bands (against a 1e-5 sweep) is the reference's, within a factor 2,
  from the same start block;
* (c) every deflation and outer preconditioner builds, but "project"
  with an ε-sphere, an unknown deflation and an unknown precond raise;
* (d) ``cheby_steps(t)`` equals the reference's, and a deep projector
  (``cheby_target=1e-3``) agrees with the production one;
* (e) the diagonals against the reference's in float64, to 1e-12;
* (f) ``BandSweep`` without a ``solve_fn`` on a float64 FCC operator runs
  the built-in LOBPCG with Jacobi from ``diag_A`` and agrees with the
  reference's built-in solve on the same start block to 1e-6 absolute
  (without deflation the lowest eigenvalues are the gradient kernel's
  zeros, so a relative bound means nothing there). The reference's own
  ``BandSweep`` cannot run this case: its built-in solve calls
  ``apply_M`` without k, which ``BlochCurlCurl.apply_M`` needs; the
  reference side therefore binds k to ``apply_M`` on its operator.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.coefficients import \
    dielectric_sphere as sphere_ref
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.operators.qplaplace import QPLaplace as QPLRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_sphere
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.operators.qplaplace import QPLaplace
from bravais_tpu_torch.spaces.h1 import H1Space
from bravais_tpu_torch.spaces.nedelec import NedelecSpace
from tests.oracles.analytic import maxwell_bands

torch.set_num_threads(1)

N, P, NEV, M = 3, 2, 4, 8
DEVICE_TOL = 1e-4


def _sphere(lat, eps_in=13.0):
    return (dielectric_sphere(eps_in, 1.0, 0.25, 0.5 * lat.A.sum(axis=0),
                              lat.A),
            sphere_ref(eps_in, 1.0, 0.25, 0.5 * lat.A.sum(axis=0), lat.A,
                       0.0))


def _ops(name, n=N, p=P, dtype=torch.complex64, eps=(1.0, 1.0)):
    """(port operator on the CPU, reference operator) of one problem."""
    sp = NedelecSpace.make(PeriodicGrid.make(make_lattice(name), n), p)
    spr = NedRef.make(GridRef.make(make_lattice_ref(name), n), p)
    jdt = jnp.complex64 if dtype == torch.complex64 else jnp.complex128
    return (BlochCurlCurl(sp, eps=eps[0], dtype=dtype, device="cpu"),
            CurlRef(spr, eps=eps[1], dtype=jdt))


def _start(shape, m, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m,) + shape)
            + 1j * rng.standard_normal((m,) + shape)).astype(np.complex64)


@pytest.mark.parametrize("name,kfrac", [("FCC", (0.3, 0.1, 0.2)),
                                        ("BCC", (0.25, 0.1, 0.15))])
def test_project_solve_matches_reference(name, kfrac):
    op, ref = _ops(name)
    k = np.asarray(make_lattice(name).k_cart(kfrac), np.float32)
    X0 = _start(op.space.field_shape, M)
    r, support = op.make_solve_fn(deflation="project", precond="fastdiag")(
        torch.as_tensor(X0), k.astype(np.float64), NEV, DEVICE_TOL, 250)
    assert support is None
    rr = ref.make_solve_fn(deflation="project", precond="fastdiag")(
        ref, jnp.asarray(X0), jnp.asarray(k), NEV, DEVICE_TOL, 250, None)
    lam, lam_r = r.eigenvalues.numpy(), np.asarray(rr.eigenvalues)
    assert abs(r.iterations - int(rr.iterations)) <= 1, (
        r.iterations, int(rr.iterations))
    np.testing.assert_allclose(lam, lam_r, rtol=1e-5)
    # The deflated solve finds the physical bands, not the kernel's zeros.
    ex = maxwell_bands(make_lattice_ref(name), k.astype(np.float64), NEV)
    assert np.max(np.abs(lam - ex) / ex) < 6e-2, (lam, ex)


def test_project_warm_sweep_analytic():
    """Γ (nudged), X and a point toward W: the refined bands against the
    analytic ones. n=3 p=2 is 2.04e-2 off them (the upper pair at the
    nudged Γ); the bar 3e-2 sits above that discretization error and
    below the 6e-2 the reference's slow FCC test allows at this size."""
    op, _ = _ops("FCC")
    lat = make_lattice("FCC")
    kc = kpath(lat, npts=5, path=[["G", "X", "W", "L"]]).k_cart[:3].copy()
    kc[0] = 2e-2 * lat.B[0]
    solve = op.make_solve_fn(deflation="project", precond="fastdiag")
    sweep = BandSweep(op, solve, nev=NEV, block=M, tol=1e-6, maxiter=250,
                      device_tol=DEVICE_TOL)
    res = sweep.run_warm(kc)
    k32 = kc.astype(np.float32).astype(np.float64)
    for i, k in enumerate(k32):
        ex = maxwell_bands(make_lattice_ref("FCC"), k, NEV)
        err = np.max(np.abs(res.eigenvalues[i] - ex)) / max(ex.max(), 1.0)
        assert err < 3e-2, (i, res.eigenvalues[i], ex)
    assert np.max(res.residuals) < 1e-2


def test_bench_field_stop_error_matches_reference():
    """bench.py's field device stop 1e-4 on the FCC path (Γ nudged, then
    k index 1 of 16, warm), FCC n=4 p=4: the error that stop leaves in
    the refined bands, measured against the port's own sweep at 1e-5, is
    the reference's too. Both sweeps start from the same seeded block;
    per k the iteration counts agree within ±1 and the two errors within
    a factor 2 (max |Δλ| over max(λ, 1)). So the port's miss of the 1e-6
    bar at this stop on the full-size path is not a port fault."""
    lat = make_lattice("FCC")
    kc = kpath(lat, npts=16, path=[["G", "X", "W", "L"]]).k_cart[:2].copy()
    kc[0] = 2e-2 * lat.B[0]
    op, ref = _ops("FCC", n=4, p=4)
    kw = dict(nev=10, block=16, tol=1e-6, maxiter=250)
    tight, loose = (BandSweep(op, op.make_solve_fn(deflation="project",
                                                   precond="fastdiag"),
                              device_tol=t, **kw).run_warm(kc)
                    for t in (1e-5, 1e-4))
    loose_r = SweepRef(ref, solve_fn=ref.make_solve_fn(
        deflation="project", precond="fastdiag"), device_tol=1e-4,
        **kw).run_warm(kc)
    scale = np.maximum(tight.eigenvalues.max(axis=1), 1.0)
    err = np.max(np.abs(loose.eigenvalues - tight.eigenvalues),
                 axis=1) / scale
    err_r = np.max(np.abs(np.asarray(loose_r.eigenvalues)
                          - tight.eigenvalues), axis=1) / scale
    print(f"stop 1e-4 error per k: port {err}, reference {err_r}; iters "
          f"port {loose.iterations}, reference {loose_r.iterations}")
    np.testing.assert_allclose(loose.iterations, loose_r.iterations,
                               atol=1)
    assert np.all(err > 0) and np.all(err_r > 0)
    assert np.all(np.maximum(err / err_r, err_r / err) < 2.0), (err, err_r)


def test_project_refuses_varying_eps_and_unknown_names():
    """Every deflation the reference offers builds with every outer
    preconditioner, but "project" with varying ε (the reference's own
    refusal); an unknown deflation or precond raises."""
    lat = make_lattice("CUB")
    op, _ = _ops("CUB", eps=_sphere(lat))
    with pytest.raises(ValueError, match="element-translation-invariant"):
        op.make_solve_fn(deflation="project")
    for name in ("cg", "gmg", "fastdiag", "project-cg", "project-cheby"):
        for pc in (None, "fastdiag", "fastdiag-cg"):
            assert op.make_solve_fn(deflation=name, precond=pc).batched
    with pytest.raises(ValueError, match="deflation must be one of"):
        op.make_solve_fn(deflation="lanczos")
    with pytest.raises(ValueError, match="precond must be one of"):
        op.make_solve_fn(precond="jacobi")


@pytest.mark.parametrize("target", [1e-6, 1e-3, 0.15, 0.3])
def test_cheby_steps_match_reference(target):
    op, ref = _ops("CUB", n=4, eps=_sphere(make_lattice("CUB")))
    assert op.cheby_steps(target) == ref.cheby_steps(target)


def test_cheby_target_override_deepens_and_agrees():
    """A smaller contraction target gives strictly more Chebyshev steps,
    and a deep-projector solve agrees with the production projector on
    the eigenvalues (the reference's test of the same name: CUB ε = 13
    sphere, n=4 p=2, complex64, one solve at X to 1e-5, bar 1e-4)."""
    lat = make_lattice("CUB")
    op, _ = _ops("CUB", n=4, eps=_sphere(lat))
    assert op.cheby_steps(1e-6) > op.cheby_steps(1e-3) > op.cheby_steps()
    assert op.cheby_steps(0.15) == op.cheby_steps()
    k = np.asarray(lat.k_cart((0.5, 0.0, 0.0)), np.float32)
    rng = np.random.default_rng(0)
    shp = (8 + 4,) + op.space.field_shape
    X0 = torch.as_tensor((rng.standard_normal(shp)
                          + 1j * rng.standard_normal(shp)
                          ).astype(np.complex64))
    lam = [op.make_solve_fn(deflation="project-cheby", precond="fastdiag",
                            cheby_target=t)(X0, k, 8, 1e-5, 250)[0]
           .eigenvalues.numpy() for t in (None, 1e-3)]
    assert np.max(np.abs(lam[1] - lam[0]) / np.abs(lam[0])) < 1e-4, lam


@pytest.mark.parametrize("case", ["FCC", "CUB sphere"])
def test_maxwell_diagonals_match_reference(case):
    name = case.split()[0]
    eps = (_sphere(make_lattice(name)) if "sphere" in case else (1.0, 1.0))
    op, ref = _ops(name, n=3, dtype=torch.complex128, eps=eps)
    d = op.diag_A(np.zeros(3))
    assert d.device.type == "cpu" and d.dtype == torch.float64
    for got, want in ((d.numpy(), np.asarray(ref.diag_A(jnp.zeros(3)))),
                      (op.diag_M, np.asarray(ref.diag_M))):
        assert got.shape == want.shape == op.space.field_shape
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("shift", [0.0, 0.7])
def test_qplaplace_diagonal_matches_reference(shift):
    lat = make_lattice("FCC")
    eps, eps_r = _sphere(lat, 5.0)
    sp = H1Space.make(PeriodicGrid.make(lat, 3), 2)
    spr = H1Ref.make(GridRef.make(make_lattice_ref("FCC"), 3), 2)
    beta = (lambda x: 1.0 + x[..., 0] ** 2)
    op = QPLaplace(sp, alpha=eps, beta=beta, shift=shift,
                   dtype=torch.complex128, device="cpu")
    ref = QPLRef(spr, alpha=eps_r, beta=beta, shift=shift,
                 dtype=jnp.complex128)
    for got, want in ((op.diag_A(np.zeros(3)), ref.diag_A()),
                      (op.diag0, ref.diag0)):
        assert got.shape == sp.dof_shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                                   atol=0)


def test_builtin_sweep_runs_jacobi_on_curlcurl():
    """Fails on a tree whose ``BlochCurlCurl`` lacks ``diag_A`` (the
    built-in solve's Jacobi preconditioner raised AttributeError)."""
    op, ref = _ops("FCC", dtype=torch.complex128)
    k = np.asarray(make_lattice("FCC").k_cart((0.3, 0.1, 0.2)))
    sweep = BandSweep(op, nev=NEV, block=M, tol=1e-8, maxiter=5)
    assert sweep.precond_mode == "jacobi"
    res = sweep.run_warm(k[None])
    assert res.iterations[0] == 5

    ref.apply_M = functools.partial(CurlRef.apply_M, ref,
                                    k=jnp.asarray(k))
    res_r = SweepRef(ref, nev=NEV, block=M, tol=1e-8, maxiter=5
                     ).run_warm(k[None])
    assert int(res_r.iterations[0]) == 5
    np.testing.assert_allclose(res.eigenvalues, res_r.eigenvalues, rtol=0,
                               atol=1e-6)
