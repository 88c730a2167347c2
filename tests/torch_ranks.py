"""One rank of ``tests/test_torch_parallel.py``'s process group: the
port's k-sharded sweeps and domain decomposition on the CPU over gloo.

    python tests/torch_ranks.py RANK SIZE STORE OUT [cuda]

joins the group of SIZE ranks through the ``file://STORE`` rendezvous
(no TCP port), runs every check below with the others, and pickles its
results to ``OUT/rank<RANK>.pkl``. With ``cuda`` (``tests/
test_torch_cuda.py``) the ranks share the card ``cuda:0`` over gloo and
run ``card`` only. Each rank also computes some of the
unsharded runs that the sharded ones are held against (the ranks share
that work out; ``UNSHARDED``), and reports which modules of JAX or of the
JAX package it imported (none: this file and the port import torch,
numpy and scipy only).

The problems are those of the reference's sharded tests
(``tests/test_sweep.py``, ``tests/test_checkpoint.py``,
``tests/test_domain_decomposition.py``, ``tests/test_config5.py``), with
their seeds, and the step of ``benchmarks/scale_demo.py --part dd`` at
FCC n=4 p=2.
"""

import os
import pickle
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bravais_tpu_torch.bands import BandSweep, BandWriter  # noqa: E402
from bravais_tpu_torch.cli.scale_demo import dd_step  # noqa: E402
from bravais_tpu_torch.eigen.lobpcg import lobpcg  # noqa: E402
from bravais_tpu_torch.eigen.precond import jacobi  # noqa: E402
from bravais_tpu_torch.lattices import kpath, make_lattice  # noqa: E402
from bravais_tpu_torch.meshing.grid import PeriodicGrid  # noqa: E402
from bravais_tpu_torch.operators.curlcurl import (  # noqa: E402
    BlochCurlCurl, CurlCurlSlab)
from bravais_tpu_torch.operators.helmholtz import (  # noqa: E402
    BlochHelmholtz, HelmholtzSlab)
from bravais_tpu_torch.parallel.mesh import kpoint_mesh  # noqa: E402
from bravais_tpu_torch.spaces.h1 import H1Space  # noqa: E402
from bravais_tpu_torch.spaces.nedelec import NedelecSpace  # noqa: E402

#: config 5's TRI variant (``cli/config5_all14.py`` ``PARAMS``).
TRI = {"alpha": np.deg2rad(80), "beta": np.deg2rad(85),
       "gamma": np.deg2rad(75)}
#: The Maxwell spectral problem of test_checkpoint.py's
#: test_warm_sharded_maxwell_spectral.
MAXWELL_KFRAC = [(0.25, 0.0, 0.25), (0.3, 0.05, 0.3), (0.5, 0.25, 0.75),
                 (0.45, 0.2, 0.6), (0.4, 0.3, 0.5), (0.5, 0.5, 0.5),
                 (0.2, 0.1, 0.15), (0.35, 0.15, 0.4)]


def scalar(n, p, lattice="SQR", **kw):
    lat = make_lattice(lattice, **kw)
    return lat, BlochHelmholtz(H1Space.make(PeriodicGrid.make(lat, n), p),
                               dtype=torch.complex128, device="cpu")


def sweep_sqr(op, **kw):
    """test_sweep.py's sweep settings."""
    kw.setdefault("nev", 3)
    return BandSweep(op, block=6, tol=1e-9, maxiter=200, **kw)


def sweep_ckpt(op, **kw):
    """test_checkpoint.py's test_warm_sharded_matches_warm settings."""
    return BandSweep(op, nev=3, block=5, tol=1e-9, maxiter=80, **kw)


def maxwell():
    lat = make_lattice("FCC")
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 3), 2),
                       dtype=torch.complex64, device="cpu")
    ks = np.asarray([lat.k_cart(f) for f in MAXWELL_KFRAC], np.float32)
    return op, ks, lambda: BandSweep(op, op.make_spectral_solve_fn(), nev=4,
                                     block=8, tol=1e-6, maxiter=150)


def table(res):
    return {"eigenvalues": res.eigenvalues, "iterations": res.iterations,
            "residuals": res.residuals}


def randc(rng, shape):
    return torch.as_tensor(rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape))


def sharded(mesh, out):
    """The k-sharded sweeps and the sharded ``run`` with a resumed
    ``BandWriter``."""
    got = {}
    lat, op = scalar(6, 2)
    kc = kpath(lat, npts=10).k_cart
    got["run"] = table(sweep_sqr(op).run(kc, mesh=mesh))
    # test_warm_sharded_matches_warm's problem, its eigenvector rows kept
    # (test_warm_sharded_keep_vectors' gate is the eigen-equation).
    _, op8 = scalar(8, 2)
    r = sweep_ckpt(op8, keep_vectors=True).run_warm_sharded(kc, mesh)
    got["warm_sharded"] = dict(table(r), eigenvectors=r.eigenvectors)
    _, ks, mk = maxwell()
    got["maxwell_warm_sharded"] = table(mk().run_warm_sharded(ks, mesh))

    # A sharded run written by rank 0 in two parts, the second resumed;
    # a third resume finds every k finished (test_checkpoint.py's
    # checkpoint problem and settings).
    run_dir = os.path.join(out, "run")
    cfg = {"lattice": "SQR", "n": 8, "p": 2}

    def writer():
        if mesh.rank:
            return None, None
        w = BandWriter(run_dir, cfg, len(kc), 2)
        return w, w.try_resume()

    def ckpt_run(ks, **kw):
        return BandSweep(op8, nev=2, block=4, tol=1e-6, maxiter=60).run(
            ks, mesh=mesh, **kw)

    w, done = writer()
    first = np.arange(4)
    ckpt_run(kc[first], chunk=2, writer=w, k_index=first)
    w, done = writer()
    done = mesh.broadcast_object(done)
    todo = np.asarray([i for i in range(len(kc)) if i not in set(done)])
    rest = ckpt_run(kc[todo], writer=w, k_index=todo)
    w, again = writer()
    got["resume"] = {"done_after_first": done, "todo": todo.tolist(),
                     "solved": len(rest.iterations),
                     "done_after_second": mesh.broadcast_object(again)}
    if w is not None:
        got["resume"]["bands"] = w.eigenvalues.copy()
    return got


def decomposed(mesh):
    """Domain decomposition: the slab applies and diagonal, and a
    Jacobi-preconditioned LOBPCG with the Grams summed over the group."""
    got = {}
    lat, op = scalar(8, 2)
    k = lat.k_cart((0.31, 0.17))
    sl = HelmholtzSlab(op, mesh)
    u = randc(np.random.default_rng(0), sp_shape(op))[None]
    got["h1_dofs"] = (sl.dofs.start, sl.dofs.stop)
    got["h1_A"] = sl.apply_A(sl.take(u), k)[0].numpy()
    got["h1_AM"] = [t[0].numpy() for t in sl.apply_AM(sl.take(u), k)]
    got["h1_diag"] = sl.diag_A(k).numpy()

    latf = make_lattice("FCC")
    opf = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(latf, 4), 2),
                        dtype=torch.complex128, device="cpu")
    kf = latf.k_cart((0.5, 0.25, 0.75))
    cs = CurlCurlSlab(opf, mesh)
    uf = randc(np.random.default_rng(1), opf.space.field_shape)[None]
    got["nd_dofs"] = (cs.dofs.start, cs.dofs.stop)
    got["nd_A"] = cs.apply_A(cs.take(uf), kf)[0].numpy()
    got["nd_AM"] = [t[0].numpy() for t in cs.apply_AM(cs.take(uf), kf)]

    X0 = randc(np.random.default_rng(2), (6,) + sp_shape(op))
    r = lobpcg(lambda x: sl.apply_A(x, k), sl.apply_M, sl.take(X0), 3,
               maxiter=150, tol=1e-9, precond=jacobi(sl.diag_A(k)),
               reduce=mesh.all_reduce_)
    got["lobpcg"] = {"eigenvalues": r.eigenvalues.numpy(),
                     "iterations": r.iterations}

    latt, opt = scalar(4, 4, "TRI", **TRI)
    slt = HelmholtzSlab(opt, mesh)
    ur = np.random.default_rng(0).standard_normal((2,) + sp_shape(opt))
    ut = torch.as_tensor(ur[0] + 1j * ur[1])[None]
    got["tri_dofs"] = (slt.dofs.start, slt.dofs.stop)
    got["tri_A"] = slt.apply_A(
        slt.take(ut), latt.k_cart([0.21, 0.13, 0.17]))[0].numpy()

    try:
        HelmholtzSlab(scalar(6, 2)[1], mesh)
        got["uneven"] = None
    except ValueError as e:
        got["uneven"] = str(e)

    # scale_demo --part dd's step at FCC n=4 p=2 (one element a slab).
    got["scale_dd"] = {name: scale_dd(getattr(torch, name), mesh)
                       for name in ("complex64", "complex128")}
    return got


def scale_dd(dtype, mesh=None):
    """``scale_demo.dd_step`` at FCC n=4 p=2, m=16, nev 10: the apply's
    norm and the 2-iteration eigenvalues."""
    r = dd_step(4, 2, 16, 10, dtype, "cpu", mesh)
    return {"norm": r["norm"], "eigenvalues": r["eigenvalues"],
            "slab": r["slab"], "finite": r["finite"]}


def sp_shape(op):
    return tuple(op.space.dof_shape)


def unsharded(rank):
    """This rank's part of the unsharded runs (``UNSHARDED``): the
    unsharded ``run``, and each segmented warm sweep without a mesh (the
    same segments on one process, one k-batched solve per position)."""
    got = {}
    if rank in UNSHARDED["run"]:
        lat, op = scalar(6, 2)
        got["run"] = table(sweep_sqr(op).run(kpath(lat, npts=10).k_cart))
    if rank in UNSHARDED["segments"]:
        lat, op8 = scalar(8, 2)
        got["segments"] = table(sweep_ckpt(op8).run_warm_sharded(
            kpath(lat, npts=10).k_cart, segments=4))
    if rank in UNSHARDED["maxwell_segments"]:
        _, ks, mk = maxwell()
        got["maxwell_segments"] = table(mk().run_warm_sharded(
            ks, segments=4))
    if rank in UNSHARDED["dd"]:
        lat, op = scalar(8, 2)
        k = lat.k_cart((0.31, 0.17))
        u = randc(np.random.default_rng(0), sp_shape(op))[None]
        got["h1_A"] = op.apply_A(u, k)[0].numpy()
        got["h1_AM"] = [t[0].numpy() for t in op.apply_AM(u, k)]
        got["h1_diag"] = op.diag_A(k).numpy()
        X0 = randc(np.random.default_rng(2), (6,) + sp_shape(op))
        r = lobpcg(lambda x: op.apply_A(x, k), op.apply_M, X0, 3,
                   maxiter=150, tol=1e-9, precond=jacobi(op.diag_A(k)))
        got["lobpcg"] = {"eigenvalues": r.eigenvalues.numpy(),
                         "iterations": r.iterations}
        latf = make_lattice("FCC")
        opf = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(latf, 4), 2),
                            dtype=torch.complex128, device="cpu")
        uf = randc(np.random.default_rng(1), opf.space.field_shape)[None]
        kf = latf.k_cart((0.5, 0.25, 0.75))
        got["nd_A"] = opf.apply_A(uf, kf)[0].numpy()
        got["nd_AM"] = [t[0].numpy() for t in opf.apply_AM(uf, kf)]
        latt, opt = scalar(4, 4, "TRI", **TRI)
        ur = np.random.default_rng(0).standard_normal((2,) + sp_shape(opt))
        got["tri_A"] = opt.apply_A(torch.as_tensor(ur[0] + 1j * ur[1])[None],
                                   latt.k_cart([0.21, 0.13, 0.17]))[0].numpy()
        got["scale_dd"] = {name: scale_dd(getattr(torch, name))
                           for name in ("complex64", "complex128")}
    return got


#: Which rank of the 4 computes each unsharded run.
UNSHARDED = {"run": (0,), "segments": (1,), "maxwell_segments": (2,),
             "dd": (3,)}


def card(mesh):
    """On the card (``cuda`` job): the FCC headline problem cut to n=4
    (p=4, 12,288 Nédélec dofs, 8 k of Γ–X–W–L with Γ nudged, 10 bands in
    16, the spectral engine at device stop 1e-3 with the f64 refine)
    through the sharded ``run`` and, on rank 0, on one rank; and the
    fused field apply of a slab of 4 rows against the one-rank apply."""
    got = {}
    lat = make_lattice("FCC")
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 4), 4),
                       device=mesh.device)
    kc = kpath(lat, npts=8, path=[["G", "X", "W", "L"]]).k_cart
    kc[np.linalg.norm(kc, axis=1) < 1e-12] = 2e-2 * lat.B[0]
    sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=10, block=16,
                      tol=1e-6, maxiter=250, device_tol=1e-3)
    got["run"] = table(sweep.run(kc, mesh=mesh))
    if mesh.rank == 0:
        got["one_rank"] = table(sweep.run(kc))
    cs = CurlCurlSlab(op, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(3)
    u = torch.randn((4,) + tuple(op.space.field_shape),
                    dtype=torch.complex64, device=mesh.device, generator=gen)
    slab = cs.apply_AM(cs.take(u).contiguous(), kc[3])
    full = op.apply_AM(u, kc[3])
    got["dd_err"] = max(float((a - cs.take(b)).abs().max() / b.abs().max())
                        for a, b in zip(slab, full))
    got["transport"] = mesh.transport(u)
    return got


def main():
    rank, size, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    if sys.argv[5:] == ["cuda"]:
        mesh = kpoint_mesh("gloo", "cuda:0", rank=rank, size=size,
                           init_method="file://" + store)
        got = card(mesh)
        mesh.close()
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
        return
    mesh = kpoint_mesh("gloo", "cpu", rank=rank, size=size,
                       init_method="file://" + store)
    got = {"rank": rank, "size": mesh.size,
           "sharded": sharded(mesh, out), "decomposed": decomposed(mesh),
           "transport": mesh.transport(torch.zeros(1))}
    mesh.close()
    got["unsharded"] = unsharded(rank)
    got["imported"] = sorted(
        m for m in sys.modules
        if m in ("jax", "bravais_tpu") or m.startswith(("jax.",
                                                        "bravais_tpu.")))
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)


if __name__ == "__main__":
    main()
