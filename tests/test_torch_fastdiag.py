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
