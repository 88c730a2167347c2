"""The Chebyshev preconditioner and its λ_max estimate
(``eigen/precond.py``), and the varying-ε branch of
``BlochCurlCurl.gradient_component_np`` (the twin-preconditioned CG on
the true deflation Laplacian), against the reference on the CPU in
complex128 (rtol 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.eigen import precond as precond_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.coefficients import dielectric_sphere as sph_ref
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.eigen import precond
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_sphere
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

DOF = (4, 5)
RTOL = 1e-10


def _hpd(seed, n=int(np.prod(DOF))):
    """A Hermitian positive definite matrix with a spread spectrum."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Q = np.linalg.qr(Z)[0]
    return (Q * np.geomspace(0.05, 20.0, n)) @ Q.conj().T


def _ops(S):
    """The operator x ↦ S x: on one field (reference) and on blocks
    (rows, *DOF) (port)."""
    St = torch.as_tensor(S)

    def field_ref(x):
        return (jnp.asarray(S) @ x.reshape(-1)).reshape(x.shape)

    def blocks(X):
        return (X.reshape(*X.shape[:-2], -1) @ St.T).reshape(X.shape)
    return field_ref, blocks


def test_estimate_lmax_and_chebyshev_match_reference():
    S = _hpd(0)
    diag = (np.real(np.diag(S))
            * np.linspace(0.8, 1.2, S.shape[0])).reshape(DOF)
    a_ref, a = _ops(S)
    lam_r = float(precond_ref.estimate_lmax(a_ref, jnp.asarray(diag), DOF,
                                            dtype=jnp.complex128))
    lam = precond.estimate_lmax(a, torch.as_tensor(diag), (1,) + DOF,
                                dtype=torch.complex128)
    assert lam.ndim == 0
    np.testing.assert_allclose(float(lam), lam_r, rtol=RTOL)

    rng = np.random.default_rng(1)
    R = rng.standard_normal((3,) + DOF) + 1j * rng.standard_normal((3,) + DOF)
    for degree in (1, 3, 5):
        ref = precond_ref.chebyshev(a_ref, jnp.asarray(diag), lam_r,
                                    degree=degree)
        want = np.stack([np.asarray(ref(jnp.asarray(r))) for r in R])
        got = precond.chebyshev(a, torch.as_tensor(diag), lam,
                                degree=degree)(torch.as_tensor(R)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_chebyshev_batched_equals_per_k():
    """With ``batched`` each k's blocks get that k's diagonal and λ_max,
    as the unbatched preconditioner of that k gives them."""
    Ss = [_hpd(s) for s in (2, 3)]
    diags = np.stack([np.real(np.diag(S)).reshape(DOF) for S in Ss])
    ops = [_ops(S)[1] for S in Ss]
    lmax = torch.tensor([precond.estimate_lmax(
        op, torch.as_tensor(dg), (1,) + DOF, dtype=torch.complex128)
        for op, dg in zip(ops, diags)])

    def batched_op(X):
        return torch.stack([op(x) for op, x in zip(ops, X)])

    rng = np.random.default_rng(4)
    R = torch.as_tensor(rng.standard_normal((2, 3) + DOF)
                        + 1j * rng.standard_normal((2, 3) + DOF))
    got = precond.chebyshev(batched_op, torch.as_tensor(diags), lmax,
                            batched=True)(R)
    for j in range(2):
        want = precond.chebyshev(ops[j], torch.as_tensor(diags[j]),
                                 lmax[j])(R[j])
        torch.testing.assert_close(got[j], want, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("rows", [None, 2])
def test_gradient_component_varying_eps_matches_reference(rows):
    lat, lat_r = make_lattice("CUB"), make_lattice_ref("CUB")
    c = 0.5 * lat.A.sum(axis=0)
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 3), 2),
                       eps=dielectric_sphere(13.0, 1.0, 0.25, c, lat.A),
                       dtype=torch.complex128, device="cpu")
    ref = CurlRef(NedRef.make(GridRef.make(lat_r, 3), 2),
                  eps=sph_ref(13.0, 1.0, 0.25, c, lat_r.A),
                  dtype=jnp.complex128)
    assert not op._coef_elem_invariant()
    k = lat.k_cart((0.3, -0.1, 0.2))
    shape = ((rows,) if rows else ()) + op.space.field_shape
    rng = np.random.default_rng(5)
    u = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    want = ref.gradient_component_np(u, k)
    got = op.gradient_component_np(u, k)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # It is a projection onto gradients: applying it again changes little.
    again = op.gradient_component_np(got, k)
    assert np.linalg.norm(again - got) < 1e-3 * np.linalg.norm(got)
