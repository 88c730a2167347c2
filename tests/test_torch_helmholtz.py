"""The port's ``BlochHelmholtz`` against the JAX reference on the same
numpy-seeded inputs: the device applies (plain version on the CPU) at
k ≠ 0 with varying α and β against the reference's ``apply_A``/``apply_M``
and its fused Pallas kernel in interpret mode, the diagonals, the f64
host twins, the quasi-periodic stencils and the mass-shifted
``QPLaplace``. Tolerances: complex128 1e-12 relative, complex64 1e-5
relative (the kernel's float32 tables and planes), host f64 twins 1e-13,
diagonals 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.helmholtz import BlochHelmholtz as HelmRef
from bravais_tpu.operators.qplaplace import QPLaplace as QPLRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.operators.qplaplace import QPLaplace
from bravais_tpu_torch.spaces.h1 import H1Space

torch.set_num_threads(1)

CASES = [("SQR", (4, 4), 2), ("HEX2D", (3, 4), 3)]
IDS = ["SQR-p2", "HEX2D-p3"]
KFRAC = (0.31, 0.17)


def _alpha(x):
    return 1.0 + 0.3 * np.sin(2 * np.pi * x[..., 0]) ** 2 + 0.2 * x[..., 1]


def _beta(x):
    return 2.0 + np.cos(2 * np.pi * x[..., 1]) + 0.5 * x[..., 0]


def _pair(lat, shape, p, dtype=torch.complex128):
    sp = H1Space.make(PeriodicGrid.make(make_lattice(lat), shape), p)
    spr = H1Ref.make(GridRef.make(make_lattice_ref(lat), shape), p)
    rdt = jnp.complex128 if dtype == torch.complex128 else jnp.complex64
    return (BlochHelmholtz(sp, alpha=_alpha, beta=_beta, dtype=dtype,
                           device="cpu"),
            HelmRef(spr, alpha=_alpha, beta=_beta, dtype=rdt))


def _block(shape, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows,) + shape)
            + 1j * rng.standard_normal((rows,) + shape))


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-12),
                                       (torch.complex64, 1e-5)],
                         ids=["c128", "c64"])
@pytest.mark.parametrize("lat,shape,p", CASES, ids=IDS)
def test_applies_match_reference(lat, shape, p, dtype, tol):
    op, ref = _pair(lat, shape, p, dtype)
    k = np.asarray(make_lattice(lat).k_cart(KFRAC))
    U = _block(op.space.dof_shape)
    Ut = torch.as_tensor(U).to(dtype)
    y = op.apply_A(Ut, k).numpy()
    m = op.apply_M(Ut).numpy()
    ya, ma = (t.numpy() for t in op.apply_AM(Ut, k))
    y_r = np.stack([np.asarray(ref.apply_A(jnp.asarray(u), jnp.asarray(k)))
                    for u in U])
    m_r = np.stack([np.asarray(ref.apply_M(jnp.asarray(u))) for u in U])
    for got, want in ((y, y_r), (m, m_r), (ya, y_r), (ma, m_r)):
        assert _rel(got, want) < tol


@pytest.mark.parametrize("lat,shape,p", CASES, ids=IDS)
def test_apply_AM_matches_pallas_interpret(lat, shape, p):
    """The fused pair (plain version of the h1 kernel, complex64) against
    the reference's Pallas kernel in interpret mode at k ≠ 0."""
    op, ref = _pair(lat, shape, p, torch.complex64)
    k = np.asarray(make_lattice(lat).k_cart(KFRAC))
    U = _block(op.space.dof_shape, rows=2, seed=1)
    ya, ma = (t.numpy() for t in op.apply_AM(torch.as_tensor(U), k))
    for i, u in enumerate(U):
        yp, mp = ref.apply_AM_pallas(jnp.asarray(u, jnp.complex64),
                                     jnp.asarray(k), interpret=True)
        assert _rel(ya[i], yp) < 1e-5
        assert _rel(ma[i], mp) < 1e-5


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64],
                         ids=["c128", "c64"])
@pytest.mark.parametrize("lat,shape,p", CASES, ids=IDS)
def test_diagonals_match_reference(lat, shape, p, dtype):
    op, ref = _pair(lat, shape, p, dtype)
    k = np.asarray(make_lattice(lat).k_cart(KFRAC))
    for got, want in ((op.diag_A(k).numpy(),
                       np.asarray(ref.diag_A(jnp.asarray(k)))),
                      (op.diag_M, ref.diag_M), (op.diag0, ref.diag0)):
        want = np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("lat,shape,p", CASES, ids=IDS)
def test_host_twins_match_reference(lat, shape, p):
    op, ref = _pair(lat, shape, p)
    k = np.asarray(make_lattice(lat).k_cart(KFRAC))
    u = _block(op.space.dof_shape, rows=1, seed=2)[0]
    np.testing.assert_allclose(op.apply_A_np(u, k), ref.apply_A_np(u, k),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(op.apply_M_np(u), ref.apply_M_np(u),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("coef", ["constant", "rods"])
def test_qp_fastdiag_stencils_match_reference(coef, monkeypatch):
    """The "A" and "M" stencils of the quasi-periodic twin: constant
    coefficients probe the 3×3 stencil twin, varying ones the mean twin.
    The disk cache is off, so both packages really extract."""
    monkeypatch.setenv("BRAVAIS_STENCIL_CACHE", "")
    lat = make_lattice("SQR")
    sp = H1Space.make(PeriodicGrid.make(lat, 5), 3)
    spr = H1Ref.make(GridRef.make(make_lattice_ref("SQR"), 5), 3)
    kw = ({} if coef == "constant" else {"alpha": _alpha, "beta": _beta})
    fd = BlochHelmholtz(sp, device="cpu", **kw).qp_fastdiag()
    fdr = HelmRef(spr, dtype=jnp.complex64, **kw).qp_fastdiag()
    for name in ("A", "M"):
        S, Sr = fd.stencils[name], np.asarray(fdr.stencils[name])
        assert S.shape == Sr.shape, name
        np.testing.assert_allclose(S, Sr, rtol=0,
                                   atol=1e-14 * np.abs(Sr).max(),
                                   err_msg=name)


def test_shifted_qplaplace_matches_reference():
    """QPLaplace(α, β, shift): the f64 twin to 1e-13 and the device apply
    (the kernel's "AM" halves, plain version) to 1e-12 in complex128, at
    k ≠ 0."""
    lat = make_lattice("HEX2D")
    sp = H1Space.make(PeriodicGrid.make(lat, (3, 4)), 2)
    spr = H1Ref.make(GridRef.make(make_lattice_ref("HEX2D"), (3, 4)), 2)
    op = QPLaplace(sp, alpha=_alpha, beta=_beta, shift=0.7,
                   dtype=torch.complex128, device="cpu")
    ref = QPLRef(spr, alpha=_alpha, beta=_beta, shift=0.7,
                 dtype=jnp.complex128)
    k = np.asarray(lat.k_cart(KFRAC))
    U = _block(sp.dof_shape, rows=2, seed=3)
    np.testing.assert_allclose(op.apply_A_np(U[0], k), ref.apply_A_np(U[0], k),
                               rtol=1e-13, atol=1e-13)
    y = op.apply_A(torch.as_tensor(U), k).numpy()
    y_r = np.stack([np.asarray(ref.apply_A(jnp.asarray(u), jnp.asarray(k)))
                    for u in U])
    assert _rel(y, y_r) < 1e-12
