"""Config 5's capability core on the port's dense oracle: the
empty-lattice scalar bands of ``operators/dense.py::assemble_h1`` match
the analytic |k+G|² on every 3D Bravais lattice family and every 2D
lattice (the reference's ``tests/test_all_lattices.py`` bars: 5e-2 / 2e-2
relative on a coarse mesh, band 1 exact to 1e-10), and the assembled
matrices equal the reference's ``assemble_h1`` to 1e-12."""

import numpy as np
import pytest
import scipy.linalg

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.dense import assemble_h1 as assemble_ref
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu_torch.cli.config5_all14 import PARAMS
from bravais_tpu_torch.lattices import (LATTICE_NAMES, LATTICE_NAMES_2D,
                                        make_lattice)
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.dense import assemble_h1
from bravais_tpu_torch.spaces.h1 import H1Space
from tests.oracles.analytic import scalar_bands


def _check(name, kw, kf, n, rtol, mmax):
    lat = make_lattice(name, **kw)
    k = lat.k_cart(kf)
    A, M = assemble_h1(H1Space.make(PeriodicGrid.make(lat, n), 2), k)
    Ar, Mr = assemble_ref(H1Ref.make(GridRef.make(
        make_lattice_ref(name, **kw), n), 2), k)
    for X, Xr in ((A, Ar), (M, Mr)):
        np.testing.assert_allclose(X, np.asarray(Xr), rtol=0,
                                   atol=1e-12 * np.abs(Xr).max())
    vals = scipy.linalg.eigh(A, M, eigvals_only=True)[:3]
    exact = scalar_bands(make_lattice_ref(name, **kw), k, 3, mmax=mmax)
    np.testing.assert_allclose(vals, exact, rtol=rtol)
    # Band 1 (constant envelope) is exact in the shifted formulation.
    np.testing.assert_allclose(vals[0], exact[0], rtol=1e-10)


@pytest.mark.parametrize("name", LATTICE_NAMES)
def test_empty_lattice_bands_3d(name):
    _check(name, PARAMS.get(name, {}), np.array([0.21, 0.13, 0.17]), 4,
           5e-2, 4)


@pytest.mark.parametrize("name", LATTICE_NAMES_2D)
def test_empty_lattice_bands_2d(name):
    _check(name, {}, np.array([0.21, 0.13]), 5, 2e-2, 5)
