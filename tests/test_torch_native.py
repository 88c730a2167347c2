"""The port's native host core binding (``utils/native.py``: the C++
dense assemblers of ``csrc/bravais_host.cpp``, built with g++ into
``bravais_tpu_torch/_build/``) against the port's and the reference's
NumPy dense assemblers, and its H1 dof map: the port of
``tests/test_native.py``."""

import numpy as np
import pytest

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators import dense as dense_ref
from bravais_tpu.operators.coefficients import dielectric_rod as rod_ref
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators import dense
from bravais_tpu_torch.operators.coefficients import dielectric_rod
from bravais_tpu_torch.spaces.h1 import H1Space
from bravais_tpu_torch.spaces.nedelec import NedelecSpace
from bravais_tpu_torch.utils import native


@pytest.mark.parametrize("lat,shape,p,k", [
    ("SQR", (3, 3), 2, (0.7, -0.3)),
    ("HEX2D", (2, 3), 3, (0.0, 0.0)),
    ("FCC", (2, 2, 2), 2, (0.5, 0.2, -0.9)),
])
def test_native_h1_matches_numpy(lat, shape, p, k):
    lattice, lattice_r = make_lattice(lat), make_lattice_ref(lat)
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p)
    sp_r = H1Ref.make(GridRef.make(lattice_r, shape), p)
    c = 0.5 * lattice.A.sum(0)
    eps, eps_r = ((dielectric_rod(8.9, 1.0, 0.2, c, lattice.A),
                   rod_ref(8.9, 1.0, 0.2, c, lattice_r.A))
                  if lattice.dim == 2 else (1.0, 1.0))
    An, Mn = native.assemble_h1(sp, np.asarray(k), alpha=1.0, beta=eps)
    for A0, M0 in (dense.assemble_h1(sp, np.asarray(k), alpha=1.0, beta=eps),
                   dense_ref.assemble_h1(sp_r, np.asarray(k), alpha=1.0,
                                         beta=eps_r)):
        np.testing.assert_allclose(An, A0, rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(Mn, M0, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("lat,shape,p,k", [
    ("CUB", (2, 2, 2), 1, (0.4, -0.7, 0.2)),
    ("FCC", (2, 2, 2), 2, (0.5, 0.25, 0.75)),
])
def test_native_nedelec_matches_numpy(lat, shape, p, k):
    lattice, lattice_r = make_lattice(lat), make_lattice_ref(lat)
    sp = NedelecSpace.make(PeriodicGrid.make(lattice, shape), p)
    sp_r = NedRef.make(GridRef.make(lattice_r, shape), p)
    kc = lattice.k_cart(k)
    An, Mn = native.assemble_nedelec(sp, kc)
    for A0, M0 in (dense.assemble_nedelec(sp, kc),
                   dense_ref.assemble_nedelec(sp_r, kc)):
        np.testing.assert_allclose(An, A0, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(Mn, M0, rtol=1e-12, atol=1e-12)


def test_native_dof_map():
    sp = H1Space.make(PeriodicGrid.make(make_lattice("SQR"), (3, 2)), 2)
    gm = native.h1_dof_map(sp)
    assert gm.shape == (6, 9)
    # wrap: element (2, 1) local (2, 2) -> global ((2*2+2)%6, (1*2+2)%4)=(0,0)
    assert gm[-1, -1] == 0
    assert gm.min() == 0 and gm.max() == sp.ndofs - 1


def test_native_builds_into_the_package_build_dir():
    """The library lives under ``bravais_tpu_torch/_build/``, named by the
    source's hash; nothing is built beside the source."""
    lib = native._build()
    assert lib.parent.name == "_build"
    assert lib.parent.parent.name == "bravais_tpu_torch"
    assert lib.name.startswith("libbravais_host_") and lib.exists()
