"""Host layer of the PyTorch port against the JAX reference: lattices,
k-paths, grids, space metadata and the k=0 stencils S_δ (A, M, G)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bravais_tpu_torch  # noqa: F401  (sets the port's precision flags)
from bravais_tpu.lattices import kpath as kpath_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.h1 import H1Space
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _assert_same(a, b, path=""):
    """Structural equality of dataclasses / dicts / arrays / scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _assert_same(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name", ["FCC", "CUB", "HEX", "SQR", "HEX2D"])
def test_lattice_and_kpath_match_reference(name):
    _assert_same(make_lattice(name), make_lattice_ref(name), name)
    lat, ref = make_lattice(name), make_lattice_ref(name)
    _assert_same(kpath(lat, npts=17), kpath_ref(ref, npts=17), "kpath")
    for label in lat.points:
        np.testing.assert_array_equal(lat.point_cart(label),
                                      ref.point_cart(label), err_msg=label)


@pytest.mark.parametrize("name,shape", [("FCC", (5, 4, 6)), ("HEX", 4)])
def test_grid_and_stencil_twin_match_reference(name, shape):
    g = PeriodicGrid.make(make_lattice(name), shape)
    gr = GridRef.make(make_lattice_ref(name), shape)
    _assert_same(g, gr, "grid")
    _assert_same(g.stencil_twin(), gr.stencil_twin(), "twin")


@pytest.mark.parametrize("p", [1, 2, 4])
def test_space_metadata_match_reference(p):
    g = PeriodicGrid.make(make_lattice("FCC"), 3)
    gr = GridRef.make(make_lattice_ref("FCC"), 3)
    for sp, spr in ((NedelecSpace.make(g, p), NedRef.make(gr, p)),
                    (H1Space.make(g, p), H1Ref.make(gr, p))):
        _assert_same(sp, spr, type(sp).__name__)
        np.testing.assert_array_equal(sp.quad_weight(), spr.quad_weight())
        np.testing.assert_array_equal(sp.qpoints_phys(),
                                      spr.qpoints_phys())
        assert sp.dof_shape == spr.dof_shape and sp.ndofs == spr.ndofs


@pytest.mark.parametrize("n", [4, 3], ids=["twin", "direct"])
def test_stencils_match_reference(n, monkeypatch):
    """S_δ of A, M and G at FCC p=2: n=4 probes the 3×3×3 stencil twin,
    n=3 the production grid itself. The disk cache is off, so both
    packages really extract."""
    monkeypatch.setenv("BRAVAIS_STENCIL_CACHE", "")
    op = BlochCurlCurl(NedelecSpace.make(
        PeriodicGrid.make(make_lattice("FCC"), n), 2), device="cpu")
    ref = CurlRef(NedRef.make(GridRef.make(make_lattice_ref("FCC"), n), 2),
                  dtype=jnp.complex64)
    fd, fdr = op.fastdiag_G(), ref.fastdiag_G()
    assert op._fd_twin.space.grid.shape == ref._fd_twin.space.grid.shape
    for name in ("A", "M", "G"):
        S, Sr = fd.stencils[name], np.asarray(fdr.stencils[name])
        assert S.shape == Sr.shape, name
        np.testing.assert_allclose(S, Sr, rtol=0,
                                   atol=1e-14 * np.abs(Sr).max(),
                                   err_msg=name)


def test_import_keeps_jax_out():
    code = ("import sys, bravais_tpu_torch, bravais_tpu_torch.convert, "
            "bravais_tpu_torch.bands.sweep, bravais_tpu_torch.bands.io, "
            "bravais_tpu_torch.cli.config, bravais_tpu_torch.cli.bands_app, "
            "bravais_tpu_torch.cli.config5_all14, "
            "bravais_tpu_torch.cli.certify_dielectric, "
            "bravais_tpu_torch.cli.scale_demo, "
            "bravais_tpu_torch.operators.coefficients, "
            "bravais_tpu_torch.operators.curlcurl, "
            "bravais_tpu_torch.operators.fastdiag, "
            "bravais_tpu_torch.operators.qplaplace, "
            "bravais_tpu_torch.operators.helmholtz, "
            "bravais_tpu_torch.operators.dense, "
            "bravais_tpu_torch.eigen.gmg, "
            "bravais_tpu_torch.eigen.precond, "
            "bravais_tpu_torch.eigen.refine, "
            "bravais_tpu_torch.eigen.jacobi_cuda, "
            "bravais_tpu_torch.utils.timing, "
            "bravais_tpu_torch.utils.native, "
            "bravais_tpu_torch.utils.profiling, "
            "bravais_tpu_torch.utils.debug, "
            "bravais_tpu_torch.parallel, bravais_tpu_torch.parallel.mesh, "
            "bravais_tpu_torch.parallel.halo; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'bravais_tpu.'))] "
            "+ [m for m in ('bravais_tpu', 'triton') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
