"""The fused Bloch H1 element apply: the plain torch version of the CUDA
kernel against the JAX Pallas kernel (interpret mode) at k≠0 in 2D and
3D, and the port's ``QPLaplace`` (the field engine's deflation
Laplacian) against the JAX one. Tolerance 2e-6 relative (float32, sums
in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.pallas.h1_apply import helmholtz_block_apply
from bravais_tpu.operators.qplaplace import QPLaplace as QPLRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import eval_coefficient
from bravais_tpu_torch.operators.h1_apply import (H1Consts,
                                                  helmholtz_apply_plain)
from bravais_tpu_torch.operators.qplaplace import QPLaplace
from bravais_tpu_torch.spaces.h1 import H1Space

torch.set_num_threads(1)

TOL = 2e-6
ROWS = 2


def _alpha(x):
    return 1 + 0.3 * x[..., 0] ** 2


def _beta(x):
    return 1 + np.sum(x ** 2, axis=-1)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("lat,shape,p", [
    ("SQR", (4, 4), 2), ("HEX2D", (3, 4), 3),
    ("FCC", (3, 3, 3), 2), ("CUB", (2, 2, 2), 3),
])
def test_plain_matches_pallas_kernel(lat, shape, p):
    """Two block rows at k≠0 through the plain version and, feature-major
    with the coefficients tiled per row, through the JAX kernel."""
    lattice = make_lattice(lat)
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p)
    d = sp.dim
    xq = sp.qpoints_phys()
    a64, b64 = eval_coefficient(_alpha, xq), eval_coefficient(_beta, xq)
    c = H1Consts.from_space(sp, a64, b64, "cpu")
    E, l = c.nelem, p + 1
    ue = _cplx(np.random.default_rng(0), (ROWS * E,) + (l,) * d)
    k = np.asarray(lattice.k_cart([0.3] * d), np.float32)
    y, m = helmholtz_apply_plain(torch.as_tensor(ue), c, k)

    perm = [2 * i for i in range(d)] + [2 * i + 1 for i in range(d)]

    def plane(a):
        e = a.transpose(perm).reshape(E, -1).astype(np.float32)
        return jnp.asarray(np.tile(e, (ROWS, 1)).T)

    fm = ue.reshape(ROWS * E, -1).T
    yr, yi, mr, mi = helmholtz_block_apply(
        jnp.asarray(fm.real), jnp.asarray(fm.imag), plane(a64), plane(b64),
        jnp.asarray(k), B=sp.basis.B.astype(np.float32),
        D=sp.basis.D.astype(np.float32), JinvT=sp.grid.Jinv.T.tolist(),
        Jinv=sp.grid.Jinv.tolist(),
        wq=sp.quad_weight().ravel().astype(np.float32), interpret=True)
    y_ref = (np.asarray(yr) + 1j * np.asarray(yi)).T.reshape(ue.shape)
    m_ref = (np.asarray(mr) + 1j * np.asarray(mi)).T.reshape(ue.shape)
    assert _rel(y.numpy(), y_ref) < TOL
    assert _rel(m.numpy(), m_ref) < TOL


@pytest.mark.parametrize("kfrac", [(0.3, 0.2, 0.1), (0.0, 0.0, 0.0)])
def test_qplaplace_matches_reference(kfrac):
    """The device apply on a two-row block (phases in the gather, the
    kernel's plain version at k = 0 inside) at k ≠ 0 and at Γ, and the
    f64 host twin, against the JAX QPLaplace (the deflation Laplacian)."""
    sp = H1Space.make(PeriodicGrid.make(make_lattice("FCC"), 4), 2)
    spr = H1Ref.make(GridRef.make(make_lattice_ref("FCC"), 4), 2)
    op = QPLaplace(sp, alpha=_beta, device="cpu")
    ref = QPLRef(spr, alpha=_beta, dtype=jnp.complex64)
    u = _cplx(np.random.default_rng(0), (ROWS,) + sp.dof_shape)
    k = np.asarray(make_lattice("FCC").k_cart(kfrac), np.float32)
    y = op.apply_A(torch.as_tensor(u), k).numpy()
    y_ref = np.stack([np.asarray(ref.apply_A(jnp.asarray(x), jnp.asarray(k)))
                      for x in u])
    assert y.shape == u.shape
    assert _rel(y, y_ref) < TOL
    u64 = u[0].astype(np.complex128)
    np.testing.assert_allclose(op.apply_A_np(u64), ref.apply_A_np(u64, None),
                               rtol=1e-12, atol=1e-12)
