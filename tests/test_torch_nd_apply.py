"""The fused Nédélec element apply: the plain torch version of the CUDA
kernel against the JAX Pallas kernel (interpret mode) on identical
planes (the port's compact element layout padded to the kernel's), and
the port's field-engine applies A, M, (A, M) against the JAX stacked
applies. Tolerance 2e-5 relative (float32, sums in another
order; the bound of ``test_pallas_kernel.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.operators.pallas.nd_apply import nedelec_block_apply
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import eval_coefficient
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.operators.nd_apply import (NdConsts, comp_shapes,
                                                  nedelec_apply_plain)
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

TOL = 2e-5
ROWS = 2
CASES = [("FCC", 3, 2), ("CUB", 3, 1), ("HEX", 3, 3)]


def _eps(x):
    return 1 + 0.4 * x[..., 0] ** 2


def _mu_inv(x):
    return 1 + 0.2 * np.sum(x ** 2, axis=-1)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _padded(ue, p):
    """Compact element dofs (N, 3·p·l²) -> the Pallas kernel's (N, 3, l,
    l, l), a zero slot at the end of each component's open axis."""
    l = p + 1
    out = np.zeros((ue.shape[0], 3, l, l, l), ue.dtype)
    off = 0
    for c, ext in enumerate(comp_shapes(p)):
        size = int(np.prod(ext))
        out[(slice(None), c) + tuple(slice(0, e) for e in ext)] = \
            ue[:, off:off + size].reshape((-1,) + ext)
        off += size
    return out


def _compact(up, p):
    """Inverse of :func:`_padded` (pad slots dropped)."""
    return np.concatenate(
        [up[(slice(None), c) + tuple(slice(0, e) for e in ext)].reshape(
            up.shape[0], -1) for c, ext in enumerate(comp_shapes(p))], axis=1)


@pytest.mark.parametrize("lat,n,p", CASES)
def test_plain_matches_pallas_kernel(lat, n, p):
    """Two block rows of element dofs through the plain version and,
    padded and feature-major with the coefficient planes tiled per row,
    through the JAX kernel; the "A" and "M" halves equal the fused call's
    and the kernel's outputs are zero in the pad slots."""
    sp = NedelecSpace.make(PeriodicGrid.make(make_lattice(lat), n), p)
    xq = sp.qpoints_phys()
    c = NdConsts.from_space(sp, eval_coefficient(_eps, xq),
                            eval_coefficient(_mu_inv, xq), "cpu")
    l, E = p + 1, c.nelem
    ue = _cplx(np.random.default_rng(1), (ROWS * E, 3 * p * l * l))
    y, m = nedelec_apply_plain(torch.as_tensor(ue), c)
    ya, _ = nedelec_apply_plain(torch.as_tensor(ue), c, "A")
    _, mm = nedelec_apply_plain(torch.as_tensor(ue), c, "M")
    np.testing.assert_array_equal(ya.numpy(), y.numpy())
    np.testing.assert_array_equal(mm.numpy(), m.numpy())

    up = _padded(ue, p)
    np.testing.assert_array_equal(_compact(up, p), ue)
    fm = up.reshape(ROWS * E, -1).T                # (3·l³, rows·E)

    def plane(t):
        return jnp.asarray(np.tile(t.numpy().reshape(E, -1), (ROWS, 1)).T)

    embed = (lambda T: np.pad(T, ((0, 0), (0, 1))))
    yr, yi, mr, mi = nedelec_block_apply(
        jnp.asarray(fm.real), jnp.asarray(fm.imag), plane(c.muw),
        plane(c.epsw), Bc=sp.closed.B, Dc=sp.closed.D,
        Bo=embed(sp.open.B), Do=embed(sp.open.D), J=sp.grid.J.tolist(),
        Ginv=sp.grid.Ginv.tolist(), detJ=float(np.linalg.det(sp.grid.J)),
        interpret=True)
    y_ref = (np.asarray(yr) + 1j * np.asarray(yi)).T.reshape(up.shape)
    m_ref = (np.asarray(mr) + 1j * np.asarray(mi)).T.reshape(up.shape)
    for t in (y_ref, m_ref):
        np.testing.assert_array_equal(_padded(_compact(t, p), p), t)
    assert _rel(y.numpy(), _compact(y_ref, p)) < TOL
    assert _rel(m.numpy(), _compact(m_ref, p)) < TOL


@pytest.mark.parametrize("lat,n,p", CASES)
def test_applies_match_reference(lat, n, p):
    """apply_A, apply_M and apply_AM on a two-row block at k≠0 with
    varying ε and μ⁻¹ against the JAX stacked apply_A / apply_M of each
    row."""
    op = BlochCurlCurl(NedelecSpace.make(
        PeriodicGrid.make(make_lattice(lat), n), p), eps=_eps,
        mu_inv=_mu_inv, device="cpu")
    ref = CurlRef(NedRef.make(GridRef.make(make_lattice_ref(lat), n), p),
                  eps=_eps, mu_inv=_mu_inv, dtype=jnp.complex64)
    u = _cplx(np.random.default_rng(2), (ROWS,) + op.space.field_shape)
    k = np.asarray(make_lattice(lat).k_cart([0.3, 0.2, 0.1]), np.float32)
    ut = torch.as_tensor(u)
    y, m = op.apply_AM(ut, k)
    kj = jnp.asarray(k)
    y_ref = np.stack([np.asarray(ref.apply_A(jnp.asarray(x), kj)) for x in u])
    m_ref = np.stack([np.asarray(ref.apply_M(jnp.asarray(x), kj)) for x in u])
    assert y.shape == u.shape and m.shape == u.shape
    assert _rel(y.numpy(), y_ref) < TOL
    assert _rel(m.numpy(), m_ref) < TOL
    assert _rel(op.apply_A(ut, k).numpy(), y_ref) < TOL
    assert _rel(op.apply_M(ut, k).numpy(), m_ref) < TOL
