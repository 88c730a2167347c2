"""The field engine (the dielectric path) against the JAX package: CUB
with an ε = 13 sphere (r = 0.25a), n = 4, p = 2, on state carried across
by ``convert`` (the ε and μ⁻¹ quadrature planes, the mean-twin A, M
stencils and the L stencil).

* the projector's pieces (G, Gᴴ, L, the block solvers, the Chebyshev
  gradient projector) on a block of random fields, and the Chebyshev
  recursion's float32 coefficients against the reference's;
* one project-cheby solve at X: iterations within ±3 of the JAX solve's,
  refined eigenvalues within 1e-6 relative of the complex128 dense
  oracle of the same discretisation;
* a 3-point warm sweep against the JAX ``BandSweep.run_warm`` with the
  same solve (refined eigenvalues within 1e-6 relative; k handed as
  float32-representable values, as the reference rounds them);
* the host refine ``host_rayleigh_ritz`` against the JAX one on the same
  block, to 1e-10.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.eigen.refine import host_rayleigh_ritz as hrr_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.coefficients import \
    dielectric_sphere as sphere_ref
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu.utils.reim import to_reim
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.convert import curlcurl_field_from_reference
from bravais_tpu_torch.eigen.refine import host_rayleigh_ritz
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_sphere
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace
from tests.test_maxwell_bands import _dense_deflated_dielectric

torch.set_num_threads(1)

N, P, NEV, M = 4, 2, 5, 9
DEVICE_TOL = 1e-4
# X, then two points toward M (fractions of the reciprocal basis).
KFRAC = [(0.5, 0.0, 0.0), (0.5, 0.25, 0.0), (0.5, 0.5, 0.0)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def pair():
    """(reference op, port op on the reference's field state, float32
    k-points as float64)."""
    latr = make_lattice_ref("CUB")
    eps = sphere_ref(13.0, 1.0, 0.25, 0.5 * latr.A.sum(axis=0), latr.A, 0.0)
    ref = CurlRef(NedRef.make(GridRef.make(latr, N), P), eps=eps,
                  dtype=jnp.complex64)
    fd, fdL = ref.fastdiag(), ref.fastdiag_L()
    sp = NedelecSpace.make(PeriodicGrid.make(make_lattice("CUB"), N), P)
    op = curlcurl_field_from_reference(
        sp, ref._eps_q64, ref._mu_inv_q64,
        {k: np.asarray(v) for k, v in fd.stencils.items()},
        np.asarray(fdL.stencils["L"]), "cpu")
    kc = np.asarray([latr.k_cart(f) for f in KFRAC], np.float32)
    return ref, op, kc.astype(np.float64)


@pytest.fixture(scope="module")
def ref_sweep(pair):
    """The JAX warm sweep over the k-points (its first solve is the
    single solve at X from the sweep's seed-0 start block)."""
    ref, _, kc = pair
    sweep = SweepRef(ref, nev=NEV, block=M, tol=1e-6, maxiter=250,
                     solve_fn=ref.make_solve_fn(deflation="project-cheby",
                                                precond="fastdiag"),
                     device_tol=DEVICE_TOL)
    return sweep.run_warm(kc)


@pytest.fixture(scope="module")
def port_sweep(pair):
    _, op, _ = pair
    solve = op.make_solve_fn(deflation="project-cheby", precond="fastdiag")
    return BandSweep(op, solve, nev=NEV, block=M, tol=1e-6, maxiter=250,
                     device_tol=DEVICE_TOL)


def test_port_coefficients_and_stencils_match_reference(pair):
    """The port's own ε sampling and mean-twin stencil extraction give
    the state ``convert`` carried across."""
    ref, op, _ = pair
    lat = make_lattice("CUB")
    eps = dielectric_sphere(13.0, 1.0, 0.25, 0.5 * lat.A.sum(axis=0), lat.A)
    own = BlochCurlCurl(op.space, eps=eps, device="cpu")
    np.testing.assert_array_equal(own._eps_q64, ref._eps_q64)
    assert own.cheby_bounds() == ref.cheby_bounds()
    assert own.cheby_steps() == ref.cheby_steps()
    for name in ("A", "M"):
        S = np.asarray(ref._fd.stencils[name])
        np.testing.assert_allclose(own.fastdiag().stencils[name], S,
                                   rtol=0, atol=1e-13 * np.abs(S).max())
    S = np.asarray(ref._fdL.stencils["L"])
    np.testing.assert_allclose(own.fastdiag_L().stencils["L"], S, rtol=0,
                               atol=1e-13 * np.abs(S).max())


def test_projector_pieces_match_reference(pair):
    """G, Gᴴ, L, the (A + sM)⁻¹ "lu" and L-twin "eigh" block solvers, the
    f64 host solver and the Chebyshev projector on a two-row block."""
    ref, op, kc = pair
    k = kc[1]
    kj = jnp.asarray(k, jnp.float32)
    rng = np.random.default_rng(4)
    u = (rng.standard_normal((2,) + op.space.field_shape)
         + 1j * rng.standard_normal((2,) + op.space.field_shape)
         ).astype(np.complex64)
    ut = torch.as_tensor(u)
    phi = op.apply_GkH(ut, k)
    phi_r = np.stack([np.asarray(ref.apply_GkH(jnp.asarray(x), kj))
                      for x in u])
    assert _rel(phi.numpy(), phi_r) < 2e-6
    ph = np.asarray(phi_r, np.complex64)
    assert _rel(op.apply_Gk(torch.as_tensor(ph), k).numpy(),
                np.stack([np.asarray(ref.apply_Gk(jnp.asarray(x), kj))
                          for x in ph])) < 2e-6
    assert _rel(op.apply_Lk(torch.as_tensor(ph), k).numpy(),
                np.stack([np.asarray(ref.apply_Lk(jnp.asarray(x), kj))
                          for x in ph])) < 2e-6

    lsolve = op.fastdiag_L().solver([("L", 1.0)], k, method="eigh")
    lsolve_r = ref.fastdiag_L().solver([("L", 1.0)], kj, method="eigh")
    assert _rel(lsolve(torch.as_tensor(ph)).numpy(),
                np.stack([np.asarray(lsolve_r(jnp.asarray(x)))
                          for x in ph])) < 2e-5
    pc, pc_r = op.fd_precond(k), ref.fd_precond(kj)
    assert _rel(pc(ut).numpy(),
                np.stack([np.asarray(pc_r(jnp.asarray(x))) for x in u])) \
        < 2e-5
    hs = op.fastdiag_L().solver_np([("L", 1.0)], k)
    hs_r = ref.fastdiag_L().solver_np([("L", 1.0)], k)
    np.testing.assert_allclose(hs(phi_r), hs_r(phi_r), rtol=1e-10,
                               atol=1e-12 * np.abs(hs_r(phi_r)).max())
    gc = op.gradient_component_cheby(ut, k, lsolve=lsolve).numpy()
    gc_r = np.stack([np.asarray(ref.gradient_component_cheby(
        jnp.asarray(x), kj, lsolve=lsolve_r)) for x in u])
    assert _rel(gc, gc_r) < 2e-5


def test_cheby_recursion_in_device_precision(pair):
    """The projector's ρ recursion runs in float32 as the reference's
    fori_loop carries it. With every operator replaced by an exact
    complex128 map (identity, and L by a diagonal within the Chebyshev
    bounds) only the recursion's own rounding remains, so the two agree
    to f64 rounding; ρ in Python floats would be off by ~1e-8. k is not
    float32-representable (the patched maps ignore it)."""
    ref, op, _ = pair
    k = np.asarray(make_lattice("CUB").k_cart((0.31, 0.07, 0.23)))
    assert not np.array_equal(k.astype(np.float32).astype(np.float64), k)
    a, b = op.cheby_bounds()
    lam = np.linspace(a, b, 64)
    u = np.random.default_rng(6).standard_normal(64) + 1j

    ref2 = copy.copy(ref)
    for name in ("apply_M", "apply_GkH", "apply_Gk"):
        setattr(ref2, name, lambda x, k: x)
    ref2.apply_Lk = lambda x, k: jnp.asarray(lam) * x
    want = np.asarray(ref2.gradient_component_cheby(
        jnp.asarray(u), jnp.asarray(k), lsolve=lambda x: x))

    op2 = copy.copy(op)
    for name in ("apply_M", "apply_GkH", "apply_Gk"):
        setattr(op2, name, lambda x, ph=None: x)
    op2.apply_Lk = lambda x, ph=None: torch.as_tensor(lam) * x
    got = op2.gradient_component_cheby(torch.as_tensor(u), k,
                                       lsolve=lambda x: x).numpy()
    assert want.dtype == got.dtype == np.complex128
    assert _rel(got, want) < 1e-13


def test_field_solve_matches_reference_and_dense_oracle(pair, ref_sweep,
                                                        port_sweep):
    """One project-cheby solve at X from the sweep's seed-0 block."""
    ref, op, kc = pair
    r, support = port_sweep.solve_fn(port_sweep._x0(), kc[0], NEV,
                                      DEVICE_TOL, 250)
    assert support is None
    its_r = int(ref_sweep.iterations[0])
    assert abs(r.iterations - its_r) <= 3, (r.iterations, its_r)
    lam, res = host_rayleigh_ritz(op, r.eigenvectors.numpy(), kc[0], NEV)
    op64 = CurlRef(ref.space, eps=ref._eps_fn, dtype=jnp.complex128)
    dense = _dense_deflated_dielectric(ref.space, op64, kc[0], NEV)
    assert np.max(np.abs(lam - dense) / np.abs(dense)) < 1e-6, (lam, dense)
    assert np.all(np.isfinite(res)) and np.max(res) < 1e-2


def test_warm_sweep_matches_reference(pair, ref_sweep, port_sweep):
    _, _, kc = pair
    res = port_sweep.run_warm(kc)
    assert np.all(np.abs(res.iterations - ref_sweep.iterations) <= 3), (
        res.iterations.tolist(), np.asarray(ref_sweep.iterations).tolist())
    np.testing.assert_allclose(res.eigenvalues, ref_sweep.eigenvalues,
                               rtol=1e-6)
    assert res.fallbacks == 0 and np.max(res.residuals) < 1e-2


def test_host_refine_matches_reference(pair, port_sweep):
    """Both σ-shift refines on the same device block, for the default
    nev + 2 rows and for all m rows."""
    ref, op, kc = pair
    r, _ = port_sweep.solve_fn(port_sweep._x0(), kc[2], NEV, DEVICE_TOL,
                               250)
    X = r.eigenvectors.numpy()
    X_reim = np.asarray(to_reim(jnp.asarray(X)))
    for rows in (None, M):
        lam, res = host_rayleigh_ritz(op, X, kc[2], NEV, rows=rows)
        lam_r, res_r = hrr_ref(ref, X_reim, kc[2], NEV, rows=rows)
        np.testing.assert_allclose(lam, lam_r, rtol=1e-10)
        np.testing.assert_allclose(res, res_r, rtol=1e-6, atol=1e-12)
