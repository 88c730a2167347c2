"""The port's twisted-DFT device half against the JAX FastDiag, on the
reference's own stencils carried across by ``convert``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.convert import fastdiag_from_reference

torch.set_num_threads(1)

KFRAC = [(0.25, 0.0, 0.25), (0.5, 0.25, 0.75)]


@pytest.fixture(scope="module")
def pair():
    """(reference FastDiag, port FastDiag on the same stencils)."""
    lat = make_lattice_ref("FCC")
    ref = CurlRef(NedRef.make(GridRef.make(lat, 4), 2), dtype=jnp.complex64)
    fdr = ref.fastdiag_G()
    fd = fastdiag_from_reference(
        {k: np.asarray(v) for k, v in fdr.stencils.items()},
        fdr.shape, fdr.p, fdr.ncomp, fdr.A_rows, device="cpu")
    return lat, fdr, fd


@pytest.mark.parametrize("kf", KFRAC)
def test_blocks_match_reference(pair, kf):
    lat, fdr, fd = pair
    k = np.asarray(lat.k_cart(kf))
    for name in ("A", "M", "G"):
        Tr = np.asarray(fdr.blocks([(name, 1.0)], jnp.asarray(k)))
        T = fd.blocks([(name, 1.0)], k)
        assert T.dtype == torch.complex64 and T.shape == Tr.shape, name
        err = np.abs(T.numpy() - Tr).max() / np.abs(Tr).max()
        assert err < 1e-6, (name, err)


@pytest.mark.parametrize("kf", KFRAC)
def test_to_from_blocks_roundtrip_and_match(pair, kf):
    lat, fdr, fd = pair
    k = np.asarray(lat.k_cart(kf))
    rng = np.random.default_rng(11)
    shp = (3,) + tuple(n * fd.p for n in fd.shape)
    u = (rng.standard_normal((2,) + shp)
         + 1j * rng.standard_normal((2,) + shp)).astype(np.complex64)
    F = fd._fwd_mats(fd._theta(k))
    v = fd.to_blocks(torch.as_tensor(u), F)
    assert v.shape == (2, fd.nblocks, fd.D)
    Fr = fdr._fwd_mats(fdr._theta(jnp.asarray(k)))
    vr = np.stack([np.asarray(fdr.to_blocks(jnp.asarray(x), Fr))
                   for x in u])
    assert np.abs(v.numpy() - vr).max() / np.abs(vr).max() < 1e-6
    back = fd.from_blocks(v, F).numpy()
    assert back.shape == u.shape
    assert np.abs(back - u).max() / np.abs(u).max() < 1e-5
    backr = np.stack([np.asarray(fdr.from_blocks(jnp.asarray(x), Fr))
                      for x in vr])
    assert np.abs(back - backr).max() / np.abs(backr).max() < 1e-6


def test_host_blocks_match_device_blocks(pair):
    """The f64 host refine blocks and the complex64 device blocks share
    one phase convention."""
    lat, _, fd = pair
    k = np.asarray(lat.k_cart(KFRAC[1]))
    idx = np.asarray([0, 5, 17, 63])
    TA, TM, TG = fd.blocks_np_multi(["A", "M", "G"], k, idx)
    for name, Th in (("A", TA), ("M", TM), ("G", TG)):
        np.testing.assert_allclose(
            Th, fd.blocks_np([(name, 1.0)], k, idx), rtol=1e-13)
        Td = fd.blocks([(name, 1.0)], k).numpy()[idx]
        assert np.abs(Td - Th).max() / np.abs(Th).max() < 1e-6, name


# -- the port's own stencils: matvec and the host solve ----------------------

K_TEST = np.array([0.37, -0.21, 0.55])


def _op(lat="FCC", n=3, p=2, eps=1.0):
    from bravais_tpu_torch.lattices import make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace
    sp = NedelecSpace.make(PeriodicGrid.make(make_lattice(lat), n), p)
    return BlochCurlCurl(sp, eps=eps, dtype=torch.complex128, device="cpu")


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape))


@pytest.mark.parametrize("lat,n,p", [("FCC", 3, 2), ("CUB", 4, 1),
                                     ("HEX", 3, 3)])
def test_matvec_reproduces_A_and_M(lat, n, p):
    """The reference's ``test_blocks_reproduce_A_and_M``: the factorized
    matvec of the port's own stencils equals the matrix-free applies at a
    generic k (complex128, 1e-9), on a block of two fields and, with a
    table of two k, on a k-batched block."""
    op = _op(lat, n, p)
    fd = op.fastdiag()
    u = _rand((2,) + op.space.field_shape)
    ks = np.stack([K_TEST, 0.5 * K_TEST[::-1]])
    for name, apply in (("A", op.apply_A), ("M", op.apply_M)):
        got = fd.matvec([(name, 1.0)], K_TEST)(u)
        want = apply(u, K_TEST)
        assert torch.allclose(got, want, rtol=1e-9,
                              atol=1e-9 * float(want.abs().max())), name
        ub = torch.stack([u, 2.0 * u])
        got = fd.matvec([(name, 1.0)], ks)(ub)
        for j, k in enumerate(ks):
            want = apply(ub[j], k)
            assert torch.allclose(got[j], want, rtol=1e-9,
                                  atol=1e-9 * float(want.abs().max()))


def test_varying_eps_falls_back_to_mean_twin():
    """The reference's test of the same name: with varying ε the blocks
    are the mean-coefficient twin's, not exact for A, but the block solve
    inverts its own matvec (1e-10); the host ``solve_np`` (f64) agrees
    with the device solve on the same terms."""
    def eps(x):
        return 1.0 + 0.5 * np.cos(2 * np.pi * x[..., 0])

    op = _op("CUB", 4, 1, eps=eps)
    assert not op._coef_elem_invariant()
    fd = op.fastdiag()
    terms = [("A", 1.0), ("M", 1.0)]
    b = _rand((1,) + op.space.field_shape, 4)
    x = fd.solver(terms, K_TEST)(b)
    r = fd.matvec(terms, K_TEST)(x) - b
    assert float(torch.linalg.vector_norm(r)
                 / torch.linalg.vector_norm(b)) < 1e-10
    xh = fd.solve_np(terms, b[0].numpy(), K_TEST)
    assert np.linalg.norm(xh - x[0].numpy()) / np.linalg.norm(xh) < 1e-10


@pytest.mark.parametrize("kf", KFRAC)
def test_matvec_and_solve_np_match_reference(pair, kf):
    """``matvec`` (complex64, on the device) and ``solve_np`` (f64, on the
    host) against the reference's on the same stencils, k and fields:
    1e-6 relative in complex64, 1e-12 in f64."""
    lat, fdr, fd = pair
    k = np.asarray(lat.k_cart(kf))
    rng = np.random.default_rng(5)
    shp = (3,) + tuple(n * fd.p for n in fd.shape)
    u = rng.standard_normal((2,) + shp) + 1j * rng.standard_normal(
        (2,) + shp)
    for terms in ([("A", 1.0)], [("M", 1.0)], [("A", 1.0), ("M", 0.5)]):
        got = fd.matvec(terms, k)(
            torch.as_tensor(u.astype(np.complex64))).numpy()
        mvr = fdr.matvec(terms, jnp.asarray(k))
        want = np.stack([np.asarray(mvr(jnp.asarray(x, jnp.complex64)))
                         for x in u])
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-6, (terms, err)
    terms = [("A", 1.0), ("M", 0.5)]
    got = fd.solve_np(terms, u, k)
    want = fdr.solve_np(terms, u, k)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
