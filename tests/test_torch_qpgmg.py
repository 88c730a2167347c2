"""The port's quasi-periodic multigrid (``eigen/gmg.py`` ``QPGMG``) and
the σ-shift Maxwell engine it serves (``make_solve_fn(deflation="gmg")``,
the CLI's ``gmg`` engine) against the JAX reference, complex128 on the
CPU (the reference's Pallas kernels are off there):

* ``QPGMG.solve`` against the reference's ``op.qp_gmg().solve`` on CUB
  n=4 p=2 at a generic k and near Γ, 5 cycles: within 1e-10 relative, and
  both within the reference's own residual gate 1e-4
  (``tests/test_gmg.py::test_qpgmg_solves_deflation_operator``);
* a k table of 3 equals the 3 one-k solves (1e-12);
* ``gradient_component_gmg`` (1e-10) and ``sigma_shift`` (1e-14) against
  the reference;
* the whole solve on FCC n=2 p=2, nev 4 in 8, tol 1e-8, at a generic k
  and at the nudged Γ: ``BandSweep.run`` (one k-batched solve from the
  seeded start block) against the reference's
  ``make_solve_fn(deflation_gmg=True)`` with its sweep's Jacobi
  preconditioner from the same block, k by k (eigenvalues within 1e-9
  scale-aware, iterations within ±1: roundoff), and against
  ``run_warm`` on those k (1e-9).

The reference's solves are jitted (most of the file's time, ~2 min on
one thread, is their compiles and the port's tol-1e-8 solves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.eigen.precond import jacobi as jacobi_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

KFRACS = {"generic": (0.31, 0.17, 0.05), "near-gamma": (2e-3, 0.0, 0.0)}
NEV, M, TOL, MAXITER = 4, 8, 1e-8, 400


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(a, b):
    return float(np.linalg.norm(np.ravel(a - b)) / np.linalg.norm(np.ravel(b)))


def _pair(name, n, p):
    """(port operator on the CPU, reference operator), complex128."""
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(
        make_lattice(name), n), p), dtype=torch.complex128, device="cpu")
    ref = CurlRef(NedRef.make(GridRef.make(make_lattice_ref(name), n), p),
                  dtype=jnp.complex128)
    return op, ref


@pytest.fixture(scope="module")
def cub():
    op, ref = _pair("CUB", 4, 2)
    gmg = ref.qp_gmg()
    solve_r = jax.jit(lambda k, b: jax.vmap(
        lambda x: gmg.solve(k, x, cycles=5))(b))
    return op, ref, solve_r


def test_qpgmg_levels_match_reference(cub):
    op, ref, _ = cub
    got = [(lv.op.space.grid.shape, lv.op.space.p, lv.op.space.q, lv.lmax)
           for lv in op.qp_gmg().levels]
    want = [(lv.op.space.grid.shape, lv.op.space.p, lv.op.space.q, lv.lmax)
            for lv in ref.qp_gmg().levels]
    assert [g[:3] for g in got] == [w[:3] for w in want] == [
        ((4, 4, 4), 2, 4), ((4, 4, 4), 1, 3), ((2, 2, 2), 1, 3)]
    for g, w in zip(got, want):
        assert abs(g[3] - w[3]) <= 1e-12 * w[3]


@pytest.mark.parametrize("where", list(KFRACS))
def test_qpgmg_solve_matches_reference(cub, where):
    """5 cycles on L x = b (b = L φ for a random φ): the port's solve
    within 1e-10 of the reference's, both within the reference's
    residual gate 1e-4 (the near-Γ constant mode only the exact coarse
    solve reaches)."""
    op, ref, solve_r = cub
    k = make_lattice("CUB").k_cart(KFRACS[where])
    phi = _rand((2,) + op.h1.dof_shape, 3)
    b = op.apply_Lk(torch.as_tensor(phi), k)
    x = op.qp_gmg().solve(k, b, cycles=5)
    x_r = np.asarray(solve_r(jnp.asarray(k), jnp.asarray(b.numpy())))
    assert _rel(x.numpy(), x_r) < 1e-10
    for xx in (x, torch.as_tensor(x_r)):
        assert _rel(op.apply_Lk(xx, k).numpy(), b.numpy()) < 1e-4


def test_qpgmg_k_table_equals_single_k(cub):
    op, _, _ = cub
    lat = make_lattice("CUB")
    ks = np.stack([lat.k_cart(f) for f in KFRACS.values()]
                  + [lat.point_cart("X")])
    b = torch.as_tensor(_rand((3, 2) + op.h1.dof_shape, 5))
    gmg = op.qp_gmg()
    x = gmg.solve(ks, b, cycles=3)
    for j, k in enumerate(ks):
        assert _rel(x[j].numpy(), gmg.solve(k, b[j], cycles=3).numpy()) \
            < 1e-12


def test_gradient_component_and_sigma_match_reference(cub):
    op, ref, _ = cub
    assert abs(op.sigma_shift - ref.sigma_shift) <= 1e-14 * ref.sigma_shift
    k = make_lattice("CUB").k_cart(KFRACS["generic"])
    u = _rand((1,) + op.space.field_shape, 9)
    g = op.gradient_component_gmg(torch.as_tensor(u), k).numpy()
    g_r = np.asarray(jax.jit(ref.gradient_component_gmg)(
        jnp.asarray(u[0]), jnp.asarray(k)))
    assert _rel(g[0], g_r) < 1e-10


@pytest.fixture(scope="module")
def fcc():
    """FCC n=2 p=2 (the CLI's n < 3 auto route) on the gmg engine at a
    generic k and the nudged Γ: the port's sweep through ``run`` (one
    k-batched solve from the seeded start block) and ``run_warm``, the
    start block, and the reference's jitted solve."""
    op, ref = _pair("FCC", 2, 2)
    lat = make_lattice("FCC")
    ks = np.stack([lat.k_cart((0.3, 0.1, 0.2)), 2e-2 * lat.B[0]])
    sweep = BandSweep(op, op.make_solve_fn(deflation="gmg", precond=None),
                      nev=NEV, block=M, tol=TOL, maxiter=MAXITER)
    solve_r = ref.make_solve_fn(deflation_gmg=True)
    run_r = jax.jit(lambda X0, k: solve_r(
        ref, X0, k, NEV, TOL, MAXITER, jacobi_ref(ref.diag_A(k))))
    return ks, sweep.run(ks), sweep.run_warm(ks), sweep._x0(), run_r


def _scaled_err(lam, lam_r):
    lam, lam_r = np.asarray(lam), np.asarray(lam_r)
    top = np.abs(lam_r).max(axis=-1, keepdims=True)
    return float(np.max(np.abs(lam - lam_r)
                        / np.maximum(np.abs(lam_r), 1e-2 * top)))


@pytest.mark.parametrize("j", [0, 1], ids=["generic", "nudged-gamma"])
def test_gmg_engine_matches_reference(fcc, j):
    """The k-batched run's k j against the reference's solve at k j from
    the same start block: a batched k steps as its own solve would (a done
    k is frozen), so iterations agree to roundoff (±1)."""
    ks, batched, _, X0, run_r = fcc
    rr = run_r(jnp.asarray(X0.numpy()), jnp.asarray(ks[j]))
    assert abs(int(batched.iterations[j]) - int(rr.iterations)) <= 1
    assert _scaled_err(batched.eigenvalues[j], rr.eigenvalues) < 1e-9
    assert np.all(batched.residuals[j] < TOL)


def test_gmg_engine_batched_run_matches_run_warm(fcc):
    _, batched, warm, _, _ = fcc
    assert batched.eigenvalues.shape == warm.eigenvalues.shape == (2, NEV)
    assert _scaled_err(batched.eigenvalues, warm.eigenvalues) < 1e-9
    assert np.all(warm.residuals < TOL)
