"""The port on several processes: k-point sharding (``BandSweep.run``
with a mesh, ``run_warm_sharded``, the CLI's ``--shard``) and domain
decomposition (``HelmholtzSlab``, ``CurlCurlSlab``, LOBPCG's ``reduce``)
over ``torch.distributed`` with gloo on the CPU.

One module fixture starts 4 ranks once (``tests/torch_ranks.py``, a
``file://`` rendezvous in the test's temporary directory, one thread
each); they run every check of the file together and return their
results. Meanwhile this process runs the JAX reference on the same
inputs (seeded numpy), as the reference's sharded tests run it
(``tests/test_sweep.py``, ``tests/test_checkpoint.py``,
``tests/test_domain_decomposition.py``, ``tests/test_config5.py``), and
each sharded result is held against the port's unsharded run (computed
by the ranks) and the reference's, to the reference's tolerances. The
spawned ranks import neither JAX nor the JAX package.
"""

import os
import pickle
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu.eigen.lobpcg import lobpcg as lobpcg_ref
from bravais_tpu.eigen.precond import jacobi as jacobi_ref
from bravais_tpu.lattices import kpath as kpath_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.operators.helmholtz import BlochHelmholtz as HelmRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.cli import bands_app, scale_demo
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.parallel.halo import gather_axis0, scatter_add_axis0
from bravais_tpu_torch.parallel.mesh import KMesh, replicated, shard_k
from bravais_tpu_torch.spaces.h1 import H1Space
from bravais_tpu_torch.spaces.tensor import gather_axis, scatter_add_axis

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
TRI = {"alpha": np.deg2rad(80), "beta": np.deg2rad(85),
       "gamma": np.deg2rad(75)}
MAXWELL_KFRAC = [(0.25, 0.0, 0.25), (0.3, 0.05, 0.3), (0.5, 0.25, 0.75),
                 (0.45, 0.2, 0.6), (0.4, 0.3, 0.5), (0.5, 0.5, 0.5),
                 (0.2, 0.1, 0.15), (0.35, 0.15, 0.4)]


class Ranks:
    """The spawned ranks; ``results()`` waits for them (all or none)."""

    def __init__(self, tmp):
        self.tmp = tmp
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_ranks.py"),
             str(r), str(RANKS), str(tmp / "store"), str(tmp)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(RANKS)]
        self._got = None

    def results(self):
        if self._got is None:
            try:
                logs = [p.communicate(timeout=300)[0] for p in self.procs]
            finally:
                self.stop()
            bad = [(r, p.returncode, logs[r][-3000:])
                   for r, p in enumerate(self.procs) if p.returncode]
            assert not bad, bad
            self._got = []
            for r in range(RANKS):
                with open(self.tmp / f"rank{r}.pkl", "rb") as f:
                    self._got.append(pickle.load(f))
        return self._got

    def unsharded(self, key):
        """The unsharded run ``key`` from whichever rank computed it."""
        return next(g["unsharded"][key] for g in self.results()
                    if key in g["unsharded"])

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("ranks"))
    yield r
    r.stop()


def _sqr(n):
    lat = make_lattice_ref("SQR")
    return lat, HelmRef(H1Ref.make(GridRef.make(lat, n), 2),
                        dtype=jnp.complex128)


def _randc(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _ref_run():
    lat, op = _sqr(6)
    return {"run": SweepRef(op, nev=3, block=6, tol=1e-9, maxiter=200).run(
        kpath_ref(lat, npts=10).k_cart).eigenvalues}


def _ref_ckpt_warm():
    lat, op8 = _sqr(8)
    return {"ckpt_warm": SweepRef(op8, nev=3, block=5, tol=1e-9,
                                  maxiter=80).run_warm(
        kpath_ref(lat, npts=10).k_cart).eigenvalues}


def _ref_maxwell_warm():
    lat = make_lattice_ref("FCC")
    op = CurlRef(NedRef.make(GridRef.make(lat, 3), 2), dtype=jnp.complex64)
    ks = np.asarray([lat.k_cart(f) for f in MAXWELL_KFRAC], np.float32)
    return {"maxwell_warm": SweepRef(
        op, nev=4, block=8, tol=1e-6, maxiter=150,
        solve_fn=op.make_solve_fn(engine="spectral")).run_warm(ks)
        .eigenvalues}


def _ref_decomposed():
    out = {}
    lat, op8 = _sqr(8)
    k = jnp.asarray(lat.k_cart((0.31, 0.17)))
    u = jnp.asarray(_randc(np.random.default_rng(0), op8.space.dof_shape))
    out["h1_A"] = np.asarray(jax.jit(op8.apply_A)(u, k))
    X0 = jnp.asarray(_randc(np.random.default_rng(2),
                            (6,) + op8.space.dof_shape))

    def solve(X0):
        r = lobpcg_ref(lambda x: op8.apply_A(x, k), op8.apply_M, X0, 3,
                       maxiter=150, tol=1e-9,
                       precond=jacobi_ref(op8.diag_A(k)))
        return r.eigenvalues, r.iterations
    out["lobpcg"] = np.asarray(jax.jit(solve)(X0)[0])

    latf = make_lattice_ref("FCC")
    opc = CurlRef(NedRef.make(GridRef.make(latf, 4), 2), dtype=jnp.complex128)
    uc = jnp.asarray(_randc(np.random.default_rng(1), opc.space.field_shape))
    out["nd_A"] = np.asarray(jax.jit(opc.apply_A)(
        uc, jnp.asarray(latf.k_cart((0.5, 0.25, 0.75)))))
    ks = latf.k_cart(scale_demo.DD_KFRAC)
    for dt, kdt in ((jnp.complex64, np.float32), (jnp.complex128, np.float64)):
        ops = CurlRef(NedRef.make(GridRef.make(latf, 4), 2), dtype=dt)
        us = jnp.asarray(scale_demo.dd_field(ops.space)[0], dt)
        out[f"scale_dd_{jnp.dtype(dt).name}"] = float(np.linalg.norm(
            np.asarray(jax.jit(ops.apply_A)(us, jnp.asarray(ks, kdt)))))
    latt = make_lattice_ref("TRI", **TRI)
    opt = HelmRef(H1Ref.make(GridRef.make(latt, 4), 4), dtype=jnp.complex128)
    ur = np.random.default_rng(0).standard_normal((2,) + opt.space.dof_shape)
    out["tri_A"] = np.asarray(jax.jit(opt.apply_A)(
        jnp.asarray(ur[0] + 1j * ur[1]),
        jnp.asarray(latt.k_cart([0.21, 0.13, 0.17]))))
    return out


@pytest.fixture(scope="module")
def ref(ranks):
    """The JAX reference's runs, made while the ranks run (``ranks``
    starts them first), one thread each: their compiles overlap."""
    parts = (_ref_run, _ref_ckpt_warm, _ref_maxwell_warm, _ref_decomposed)
    with ThreadPoolExecutor(len(parts)) as pool:
        return {key: val for fut in [pool.submit(f) for f in parts]
                for key, val in fut.result().items()}


def _sharded(ranks, key):
    """Rank 0's result of ``key``, after checking that every rank returned
    the same band table."""
    got = [g["sharded"][key] for g in ranks.results()]
    for g in got[1:]:
        np.testing.assert_array_equal(g["eigenvalues"],
                                      got[0]["eigenvalues"])
        np.testing.assert_array_equal(g["iterations"], got[0]["iterations"])
    return got[0]


def _slabs(ranks, key, dofs_key, axis):
    """The ranks' slabs of ``key`` joined along the dof ``axis``, after
    checking they tile it in rank order."""
    parts = [g["decomposed"] for g in ranks.results()]
    spans = [p[dofs_key] for p in parts]
    assert spans[0][0] == 0 and all(a[1] == b[0]
                                    for a, b in zip(spans, spans[1:]))
    return np.concatenate([p[key] for p in parts], axis=axis)


def test_sweep_sharded_8dev(ranks, ref):
    """tests/test_sweep.py::test_sweep_sharded_8dev over 4 ranks: nk=10
    pads to 12, shares of 3; the same bands as the unsharded run and the
    reference's."""
    got = _sharded(ranks, "run")
    assert got["eigenvalues"].shape == (10, 3)
    for want in (ranks.unsharded("run")["eigenvalues"], ref["run"]):
        np.testing.assert_allclose(got["eigenvalues"], want, rtol=1e-9,
                                   atol=1e-9)


def test_warm_sharded_matches_warm(ranks, ref):
    """tests/test_checkpoint.py::test_warm_sharded_matches_warm: one
    warm-started segment per rank against the same segments on one
    process and the reference's sequential warm sweep."""
    got = _sharded(ranks, "warm_sharded")
    for want in (ranks.unsharded("segments")["eigenvalues"],
                 ref["ckpt_warm"]):
        assert got["eigenvalues"].shape == want.shape
        np.testing.assert_allclose(got["eigenvalues"], want, rtol=1e-7,
                                   atol=1e-9)


def test_warm_sharded_keep_vectors(ranks):
    """tests/test_sweep.py::test_warm_sharded_keep_vectors: the gathered
    eigenvector rows satisfy the eigen equation of their k."""
    got = _sharded(ranks, "warm_sharded")
    lat = make_lattice("SQR")
    op = BlochHelmholtz(H1Space.make(PeriodicGrid.make(lat, 8), 2),
                        dtype=torch.complex128, device="cpu")
    kc = kpath(lat, npts=10).k_cart
    vecs = got["eigenvectors"]
    assert vecs.shape == (10, 3) + tuple(op.space.dof_shape)
    for i in range(0, 10, 3):
        x = torch.as_tensor(vecs[i])
        Av = op.apply_A(x, kc[i]).numpy()
        Mv = op.apply_M(x).numpy()
        for j in range(3):
            lam = got["eigenvalues"][i, j]
            r = np.linalg.norm(Av[j] - lam * Mv[j])
            assert r < 1e-6 * max(abs(lam), 1.0) * np.linalg.norm(Mv[j]), (
                i, j, r)


def test_warm_seg_single_device(ranks, ref):
    """tests/test_sweep.py::test_warm_seg_single_device: segments=4 with
    no mesh (one k-batched solve a path position, a start block per
    segment), on test_checkpoint.py's problem, against the reference's
    warm sweep."""
    got = ranks.unsharded("segments")
    np.testing.assert_allclose(got["eigenvalues"], ref["ckpt_warm"],
                               rtol=1e-9, atol=1e-9)


def test_warm_sharded_maxwell_spectral(ranks, ref):
    """tests/test_checkpoint.py::test_warm_sharded_maxwell_spectral: the
    spectral engine's support and refine through the sharded warm
    sweep."""
    got = _sharded(ranks, "maxwell_warm_sharded")
    one = ranks.unsharded("maxwell_segments")
    assert np.max(one["residuals"]) < 1e-9
    assert np.max(got["residuals"]) < 1e-9
    for want in (one["eigenvalues"], ref["maxwell_warm"]):
        np.testing.assert_allclose(got["eigenvalues"], want, rtol=1e-6,
                                   atol=1e-9)


def test_sharded_run_resumes(ranks, ref):
    """A sharded ``run`` written by rank 0 (the first 4 k, in chunks of
    2 rounded to 4), resumed: the resume solves only the 6 k left, and a
    second resume finds all 10 finished. The table (tests/
    test_checkpoint.py's problem and settings: 2 bands to 1e-6) equals the
    sequential warm sweeps' lowest 2 bands to test_checkpoint.py's
    tolerance."""
    got = ranks.results()[0]["sharded"]["resume"]
    assert got["done_after_first"] == [0, 1, 2, 3]
    assert got["todo"] == [4, 5, 6, 7, 8, 9] and got["solved"] == 6
    assert got["done_after_second"] == list(range(10))
    for want in (ranks.unsharded("segments")["eigenvalues"],
                 ref["ckpt_warm"]):
        np.testing.assert_allclose(got["bands"], want[:, :2], rtol=1e-7,
                                   atol=1e-9)


def test_sharded_helmholtz_apply_matches(ranks, ref):
    """tests/test_domain_decomposition.py::
    test_sharded_helmholtz_apply_matches (SQR n=8 p=2, complex128, first
    dof axis over 4 ranks), and the fused pair and the diagonal."""
    un = ranks.unsharded("h1_A")
    got = _slabs(ranks, "h1_A", "h1_dofs", 0)
    for want in (un, ref["h1_A"]):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    for i, want in enumerate(ranks.unsharded("h1_AM")):
        parts = [g["decomposed"]["h1_AM"][i] for g in ranks.results()]
        np.testing.assert_allclose(np.concatenate(parts), want, rtol=1e-12,
                                   atol=1e-13)
    np.testing.assert_allclose(_slabs(ranks, "h1_diag", "h1_dofs", 0),
                               ranks.unsharded("h1_diag"), rtol=1e-12)


def test_sharded_curlcurl_apply_matches(ranks, ref):
    """tests/test_domain_decomposition.py::
    test_sharded_curlcurl_apply_matches (FCC n=4 p=2: one element a
    slab, the halo of the two closed components with the wrap phase),
    1e-12 against the unsharded apply and against the reference's
    complex128 apply: a complex128 operator's Nédélec constants are
    float64 (``NdConsts(rdtype=)``). The norm check at 1e-6 is kept."""
    got = _slabs(ranks, "nd_A", "nd_dofs", 1)
    np.testing.assert_allclose(got, ranks.unsharded("nd_A"), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got, ref["nd_A"], rtol=1e-12,
                               atol=1e-12 * np.abs(ref["nd_A"]).max())
    assert (np.linalg.norm(got - ref["nd_A"])
            < 1e-6 * np.linalg.norm(ref["nd_A"]))
    for i, want in enumerate(ranks.unsharded("nd_AM")):
        parts = [g["decomposed"]["nd_AM"][i] for g in ranks.results()]
        np.testing.assert_allclose(np.concatenate(parts, axis=1), want,
                                   rtol=1e-12, atol=1e-12)


def test_sharded_eigensolve_matches(ranks, ref):
    """tests/test_domain_decomposition.py::test_sharded_eigensolve_matches:
    Jacobi-preconditioned LOBPCG with the dof axis over 4 ranks and every
    dof-axis sum reduced over them."""
    got = [g["decomposed"]["lobpcg"] for g in ranks.results()]
    for g in got[1:]:
        np.testing.assert_array_equal(g["eigenvalues"], got[0]["eigenvalues"])
    for want in (ranks.unsharded("lobpcg")["eigenvalues"], ref["lobpcg"]):
        np.testing.assert_allclose(got[0]["eigenvalues"], want, rtol=1e-9)


def test_scale_demo_dd_step_over_four_ranks(ranks, ref):
    """``scale_demo --part dd``'s step (FCC n=4 p=2 at the reference's
    k, the seed-0 field, a 2-iteration LOBPCG with its Grams reduced)
    over the 4 ranks: the apply's norm equals the reference's
    ``BlochCurlCurl.apply_A`` norm (1e-6 in complex64, 1e-12 in
    complex128), and the eigenvalues equal the unsharded port's (1e-9 in
    complex128)."""
    got = [g["decomposed"]["scale_dd"] for g in ranks.results()]
    un = ranks.unsharded("scale_dd")
    assert [g["complex128"]["slab"] for g in got] == [[0, 2], [2, 4],
                                                      [4, 6], [6, 8]]
    for dt, bar in (("complex64", 1e-6), ("complex128", 1e-12)):
        want = ref[f"scale_dd_{dt}"]
        for g in got:
            assert g[dt]["finite"]
            assert abs(g[dt]["norm"] - want) <= bar * want, (dt, g[dt])
            np.testing.assert_array_equal(g[dt]["eigenvalues"],
                                          got[0][dt]["eigenvalues"])
    np.testing.assert_allclose(got[0]["complex128"]["eigenvalues"],
                               un["complex128"]["eigenvalues"],
                               rtol=1e-9)
    np.testing.assert_allclose(got[0]["complex64"]["eigenvalues"],
                               un["complex64"]["eigenvalues"],
                               rtol=1e-5)


def test_config5_dd_sharded_apply_p4(ranks, ref):
    """tests/test_config5.py::test_config5_dd_sharded_apply_p4: TRI n=4
    p=4 over 4 ranks."""
    got = _slabs(ranks, "tri_A", "tri_dofs", 0)
    for want in (ranks.unsharded("tri_A"), ref["tri_A"]):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_uneven_slabs_refused(ranks):
    """Slabs hold whole elements: n₁ = 6 over 4 ranks is refused."""
    for g in ranks.results():
        assert "not a multiple of 4" in g["decomposed"]["uneven"]


def test_ranks_keep_jax_out(ranks):
    """The spawned ranks ran over gloo and imported neither JAX nor the
    JAX package."""
    for g in ranks.results():
        assert g["size"] == RANKS and g["transport"] == "gloo"
        assert g["imported"] == []


@pytest.mark.parametrize("phase", [None, 0.6 - 0.8j, "per-k"])
def test_halo_at_one_rank_is_the_periodic_wrap(phase):
    """At one rank the halo exchange is the rank's own periodic wrap: the
    slab gather and scatter equal ``gather_axis``/``scatter_add_axis``
    exactly, with a wrap phase and with per-k phases over row groups."""
    mesh = KMesh(rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    rng = np.random.default_rng(5)
    n, p = 3, 2
    u = torch.as_tensor(_randc(rng, (4, n * p, 5)))
    ph = (None if phase is None else torch.tensor([0.6 - 0.8j, 0.28 + 0.96j])
          if phase == "per-k" else torch.tensor(phase))
    g = gather_axis0(u, n, p, mesh, ph)
    assert torch.equal(g, gather_axis(u, 0, n, p, ph))
    r = torch.as_tensor(_randc(rng, tuple(g.shape)))
    assert torch.equal(scatter_add_axis0(r, n, p, mesh, ph),
                       scatter_add_axis(r, 0, n, p, ph))


def test_shard_k_pads_with_the_last_k():
    """nk = 10 over 4 ranks: shares of 3 in rank order, the last padded
    with k 9; rows gathered by their positions come back in k order."""
    k = np.arange(20.0).reshape(10, 2)
    shares = [shard_k(KMesh(r, 4, torch.device("cpu"), "gloo"), k)
              for r in range(4)]
    assert [len(s) for s, _, _ in shares] == [3, 3, 3, 3]
    assert [(lo, real) for _, lo, real in shares] == [(0, 3), (3, 3), (6, 3),
                                                      (9, 1)]
    np.testing.assert_array_equal(shares[3][0], k[[9, 9, 9]])
    np.testing.assert_array_equal(
        np.concatenate([s[:real] for s, _, real in shares]), k)
    assert replicated(None, [2, 0, 1], ["c", "a", "b"]) == (
        [0, 1, 2], ["a", "b", "c"])


CLI = ["--device", "cpu", "--lattice", "SQR", "--problem", "scalar", "--n",
       "4", "--p", "2", "--nk", "6", "--nev", "2", "--tol", "1e-6",
       "--precision", "f64", "--maxiter", "60"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_ranks(argv, size):
    """``python -m bravais_tpu_torch`` as ``size`` ranks of a group formed
    from the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT; ``localhost``); returns rank 0's output."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bravais_tpu_torch", *argv],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(size),
                 LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                 MASTER_PORT=port, OMP_NUM_THREADS="1", PYTHONPATH=REPO),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(size)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert not any(line.startswith("{") for line in outs[1][0].splitlines())
    return outs[0][0]


def test_cli_shard_matches_unsharded_and_resumes(tmp_path, capsys):
    """``--shard --mode batched`` at 2 ranks through the CLI's own
    environment path (``BandSweep.run`` with the mesh) writes the band
    table of an unsharded run (rank 0 alone writes and logs), and
    ``--resume`` recomputes nothing."""
    bands_app.main(CLI + ["--mode", "batched", "--out",
                          str(tmp_path / "one")])
    capsys.readouterr()
    argv = CLI + ["--mode", "batched", "--shard", "--out",
                  str(tmp_path / "two")]
    out = _cli_ranks(argv, 2)
    assert "# sharded over 2 ranks (gloo)" in out
    assert sum(line.startswith("{") for line in out.splitlines()) == 6
    one, two = (np.load(tmp_path / d / "bands.npz") for d in ("one", "two"))
    np.testing.assert_allclose(two["eigenvalues"], one["eigenvalues"],
                               rtol=1e-9, atol=1e-9)
    again = _cli_ranks(argv + ["--resume"], 2)
    assert "all k-points already finished" in again
    assert not any(line.startswith("{") for line in again.splitlines())


def test_cli_shard_without_a_launcher_is_a_group_of_one(tmp_path, capsys):
    """Without a launcher's environment ``--shard`` runs as a group of
    one and says so (``--mode warm``: ``run_warm_sharded``, one
    segment)."""
    env = {v: os.environ.pop(v) for v in ("RANK", "WORLD_SIZE")
           if v in os.environ}
    try:
        bands_app.main(CLI + ["--shard", "--out", str(tmp_path / "r")])
    finally:
        os.environ.update(env)
    out = capsys.readouterr().out
    assert "# sharded over 1 rank (gloo)" in out
    assert sum(line.startswith("{") for line in out.splitlines()) == 6
    assert not torch.distributed.is_initialized()
