"""The port's geometric multigrid (``eigen/gmg.py``) against the JAX
reference's ``GMG`` on the config-2 shape cut small (SQR, ε = 8.9 rods
r = 0.2a, TM: α = 1, β = ε; n = 8, p = 2), complex128: the level
hierarchy, every level's λmax bound (1e-12 relative), the transfers
(1e-12 relative, adjoint to each other), one V-cycle on a random 4-row
block against the reference's vmapped V-cycle (1e-10 relative), and the
port's copy of ``test_vcycle_solves_shifted_system``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.eigen.gmg import GMG as GMGRef
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.helmholtz import BlochHelmholtz as HelmRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu_torch.eigen.gmg import GMG
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_rod
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.spaces.h1 import H1Space

torch.set_num_threads(1)

N, P = 8, 2


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def pair():
    lat = make_lattice("SQR")
    eps = dielectric_rod(8.9, 1.0, 0.2, 0.5 * lat.A.sum(axis=0), lat.A)
    sp = H1Space.make(PeriodicGrid.make(lat, N), P)
    op = BlochHelmholtz(sp, alpha=1.0, beta=eps, dtype=torch.complex128,
                        device="cpu")
    gmg = GMG(op)
    spr = H1Ref.make(GridRef.make(make_lattice_ref("SQR"), N), P)
    opr = HelmRef(spr, alpha=1.0, beta=eps, dtype=jnp.complex128)
    gmgr = GMGRef(spr, alpha=1.0, beta=eps, dtype=jnp.complex128,
                  fine_op=opr)
    return lat, op, gmg, gmgr


def test_levels_match_reference(pair):
    _, _, gmg, gmgr = pair
    shapes = [(lv.op.space.grid.shape, lv.op.space.p, lv.op.space.q)
              for lv in gmg.levels]
    assert shapes == [(lv.op.space.grid.shape, lv.op.space.p,
                       lv.op.space.q) for lv in gmgr.levels]
    assert shapes == [((8, 8), 2, 4), ((8, 8), 1, 3), ((4, 4), 1, 3),
                      ((2, 2), 1, 3)]


def test_lmax_matches_reference(pair):
    _, _, gmg, gmgr = pair
    for lv, lvr in zip(gmg.levels, gmgr.levels):
        assert abs(lv.lmax - lvr.lmax) <= 1e-12 * lvr.lmax


def test_transfers_match_reference_and_are_adjoint(pair):
    _, _, gmg, gmgr = pair
    for i in range(len(gmg.levels) - 1):
        fine = gmg.levels[i].op.space
        coarse = gmg.levels[i + 1].op.space
        uc = _rand((2,) + coarse.dof_shape, 10 + i)
        rf = _rand((2,) + fine.dof_shape, 20 + i)
        Pu = gmg._prolong(i, torch.as_tensor(uc)).numpy()
        Rr = gmg._restrict(i, torch.as_tensor(rf)).numpy()
        Pu_r = np.stack([np.asarray(gmgr._prolong(i, jnp.asarray(u)))
                         for u in uc])
        Rr_r = np.stack([np.asarray(gmgr._restrict(i, jnp.asarray(r)))
                         for r in rf])
        np.testing.assert_allclose(Pu, Pu_r, rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(Rr, Rr_r, rtol=1e-12, atol=1e-13)
        # <r, P u> == <R r, u>
        lhs = np.vdot(rf[0], Pu[0])
        rhs = np.vdot(Rr[0], uc[0])
        np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
        ones = torch.ones((1,) + coarse.dof_shape, dtype=torch.complex128)
        np.testing.assert_allclose(gmg._prolong(i, ones).numpy(), 1.0,
                                   atol=1e-13)


def test_vcycle_matches_reference(pair):
    lat, op, gmg, gmgr = pair
    k = np.asarray(lat.k_cart((0.31, 0.17)))
    B = _rand((4,) + op.space.dof_shape, 5)
    y = gmg.precond(k)(torch.as_tensor(B)).numpy()
    y_r = np.asarray(jax.jit(jax.vmap(gmgr.precond(jnp.asarray(k))))(
        jnp.asarray(B)))
    assert np.linalg.norm(y - y_r) / np.linalg.norm(y_r) < 1e-10


def test_vcycle_solves_shifted_system(pair):
    """Richardson iteration with the V-cycle converges fast for A(k)
    (the port's copy of the reference's test, on a 2-row block)."""
    lat, op, gmg, _ = pair
    k = np.asarray(lat.k_cart((0.31, 0.17)))
    b = torch.as_tensor(_rand((2,) + op.space.dof_shape, 1))
    V = gmg.precond(k)
    x = torch.zeros_like(b)
    r0 = torch.linalg.vector_norm(b, dim=(1, 2))
    for _ in range(10):
        x = x + V(b - op.apply_A(x, k))
    r = torch.linalg.vector_norm(b - op.apply_A(x, k), dim=(1, 2))
    assert bool((r < 1e-5 * r0).all()), (r / r0).tolist()
