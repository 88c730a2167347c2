"""The Nédélec constants in the working precision: a complex128
``BlochCurlCurl`` applies with float64 tables, coefficient planes and
metric (``NdConsts(rdtype=)``), so its device applies equal the f64 host
twins and the reference's complex128 applies to roundoff; a complex64
operator keeps the float32 constants the nd kernel takes, and the
kernel's checks refuse anything else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.coefficients import \
    dielectric_sphere as sphere_ref
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators import nd_apply
from bravais_tpu_torch.operators.coefficients import dielectric_sphere
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

N, P, KFRAC, ROWS = 3, 2, (0.3, 0.1, -0.2), 2


def _ops(lattice, dtype):
    """(port operator, reference operator, k, a seeded random block
    (ROWS, 3, N₁, N₂, N₃)): CUB with an ε = 13 sphere, or empty FCC."""
    lat, latr = make_lattice(lattice), make_lattice_ref(lattice)
    eps = eps_r = 1.0
    if lattice == "CUB":
        c = 0.5 * lat.A.sum(axis=0)
        eps = dielectric_sphere(13.0, 1.0, 0.25, c, lat.A)
        eps_r = sphere_ref(13.0, 1.0, 0.25, c, latr.A, 0.0)
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, N), P),
                       eps=eps, dtype=dtype, device="cpu")
    ref = CurlRef(NedRef.make(GridRef.make(latr, N), P), eps=eps_r,
                  dtype=jnp.complex128)
    rng = np.random.default_rng(7)
    shp = (2, ROWS) + tuple(op.space.field_shape)
    u = rng.standard_normal(shp)
    return op, ref, np.asarray(lat.k_cart(KFRAC)), u[0] + 1j * u[1]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("lattice", ["CUB", "FCC"])
def test_complex128_applies_match_f64_twin_and_reference(lattice):
    """complex128 ``apply_A``, ``apply_M`` and ``apply_AM`` equal the
    port's f64 host twins and the reference's complex128 applies at 1e-12
    (float32 constants left them 2.33e-08 off)."""
    op, ref, k, u = _ops(lattice, torch.complex128)
    c = op.nd_consts()
    assert c.rdtype == torch.float64
    for t in (c.tables, c.muw, c.epsw):
        assert t.dtype == torch.float64
    assert c.host_metric.dtype == np.float64
    ut = torch.as_tensor(u)
    A = op.apply_A(ut, k).numpy()
    M = op.apply_M(ut, k).numpy()
    AM = [t.numpy() for t in op.apply_AM(ut, k)]
    kj = jnp.asarray(k)
    want_A = [np.asarray(jax.jit(ref.apply_A)(jnp.asarray(x), kj)) for x in u]
    want_M = [np.asarray(jax.jit(ref.apply_M)(jnp.asarray(x), kj)) for x in u]
    for r in range(ROWS):
        for got, twin, jx in ((A[r], op.apply_A_np(u[r], k), want_A[r]),
                              (M[r], op.apply_M_np(u[r], k), want_M[r]),
                              (AM[0][r], op.apply_A_np(u[r], k), want_A[r]),
                              (AM[1][r], op.apply_M_np(u[r], k), want_M[r])):
            np.testing.assert_allclose(got, twin, rtol=1e-12,
                                       atol=1e-12 * np.abs(twin).max())
            np.testing.assert_allclose(got, jx, rtol=1e-12,
                                       atol=1e-12 * np.abs(jx).max())


@pytest.mark.parametrize("lattice", ["CUB", "FCC"])
def test_complex64_keeps_float32_constants(lattice):
    """A complex64 operator's constants stay float32 (the kernel's), and
    its apply is the float32-constant apply: the complex64 result equals
    the plain version on the same float32 constants bit for bit, and sits
    at float32 rounding from the f64 twin."""
    op, _, k, u = _ops(lattice, torch.complex64)
    c = op.nd_consts()
    assert c.rdtype == torch.float32 and c.host_metric.dtype == np.float32
    for t in (c.tables, c.muw, c.epsw):
        assert t.dtype == torch.float32
    ut = torch.as_tensor(u, dtype=torch.complex64)
    A, M = (t.numpy() for t in op.apply_AM(ut, k))
    ph = op.phases(k)
    ue = op._gather_stacked(ut, ph)
    y, m = nd_apply.nedelec_apply_plain(ue, c, "AM")
    assert np.array_equal(A, op._scatter_stacked(y, ph).numpy())
    assert np.array_equal(M, op._scatter_stacked(m, ph).numpy())
    for r in range(ROWS):
        assert _rel(A[r], op.apply_A_np(u[r], k)) < 1e-5
        assert _rel(M[r], op.apply_M_np(u[r], k)) < 1e-5


def test_kernel_refuses_all_but_complex64_and_float32_constants():
    """The nd kernel's launch check takes complex64 dofs with float32
    constants only: complex128 dofs, and complex64 dofs with float64
    constants, are refused before any pointer is passed."""
    op64, _, _, _ = _ops("FCC", torch.complex128)
    op32, _, _, _ = _ops("FCC", torch.complex64)
    c64, c32 = op64.nd_consts(), op32.nd_consts()
    shape = (ROWS * c32.nelem, c32.ndof)
    with pytest.raises(ValueError, match="complex64"):
        nd_apply._check(torch.zeros(shape, dtype=torch.complex128), c64)
    with pytest.raises(ValueError, match="float32 constants"):
        nd_apply._check(torch.zeros(shape, dtype=torch.complex64), c64)
    nd_apply._check(torch.zeros(shape, dtype=torch.complex64), c32)
