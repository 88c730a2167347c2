"""Config 5: the all-14-Bravais-lattice p=4 sweep (port of
``benchmarks/config5_all14.py``).

    python -m bravais_tpu_torch.cli.config5_all14 [--n 6] [--p 4] [--nev 6]
        [--engine spectral|field] [--device cuda|cpu] [--write PATH]
        [--shard]

For every 3D Bravais lattice family (the variant parameters ``PARAMS``
where the family needs them) it solves the empty-lattice scalar Helmholtz
problem at order p on an n³ grid at the 8 generic interior k-points
``KFRAC``, all 8 in ONE k-batched ``BandSweep.run`` (a LOBPCG with a
leading k axis), and holds the nev lowest refined bands against the
analytic oracle λ = |k+G|², exact for every lattice and every k. Engines:
"spectral" (the twisted-DFT block engine, ``make_solve_fn``) and "field"
(the matrix-free built-in solve: the fused h1 element apply and the
Jacobi preconditioner).

Each lattice reports the wall of its ``run`` as measured here (the
reference prints the sweep's ``wall_s`` instead, which its batched mode
does not fill), the host-refine seconds inside it, and the first
lattice's setup beside them: the kernel build on the card (``--device
cuda``) and each lattice's host stencil extraction. It prints a markdown
table and exits 1 if the worst error is 1e-5 or more (the reference's
gate). ``--write PATH`` also writes the table to PATH. It runs on the
CUDA device unless ``--device cpu`` is given; without a card it exits
with an error. ``--shard`` (the reference's k over several devices)
splits each lattice's 8 k over the ranks of a ``torch.distributed``
group, every lattice's ``run`` with the mesh (``torchrun --standalone
--nproc-per-node P -m -- bravais_tpu_torch.cli.config5_all14 --shard``:
one card per rank, NCCL; ``--device cpu``: gloo; without a launcher a
group of one; the ``--`` keeps torchrun's parser from reading ``--n`` as
its own); rank 0 prints the table and writes ``--write``.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time

import numpy as np

__all__ = ["KFRAC", "PARAMS", "build", "run_one", "scalar_bands", "main"]

PARAMS = {
    "BCT": {"c": 0.8}, "ORCF": {"a": 0.9, "b": 1.1, "c": 1.3},
    "RHL": {"alpha": np.deg2rad(70)},
    "TRI": {"alpha": np.deg2rad(80), "beta": np.deg2rad(85),
            "gamma": np.deg2rad(75)},
}

# 8 generic interior fractional k-points (no symmetry, no Γ): every one
# is a valid analytic-oracle eigenproblem on every lattice.
KFRAC = np.array([
    [0.21, 0.13, 0.17], [0.11, 0.31, 0.07], [0.41, 0.23, 0.11],
    [0.05, 0.17, 0.37], [0.29, 0.41, 0.19], [0.33, 0.09, 0.27],
    [0.15, 0.25, 0.45], [0.37, 0.35, 0.13]])


def scalar_bands(lattice, k, nbands: int, mmax: int = 6) -> np.ndarray:
    """Lowest ``nbands`` empty-lattice scalar eigenvalues λ = |k+G|² over
    the reciprocal vectors G = m·B, |m_i| ≤ ``mmax``."""
    k = np.asarray(k, np.float64)
    vals = sorted(float(np.sum((k + np.asarray(m, np.float64) @ lattice.B)
                               ** 2))
                  for m in itertools.product(range(-mmax, mmax + 1),
                                             repeat=lattice.dim))
    return np.asarray(vals[:nbands])


def build(name, n, p, nev, tol, maxiter, engine="spectral", device="cuda"):
    """(lattice, k-points (8, 3), operator, BandSweep) of one lattice:
    complex64 on ``device``, block nev + 4, the engine's solve (the host
    stencils are extracted here for "spectral")."""
    import torch

    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.lattices import make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
    from bravais_tpu_torch.spaces.h1 import H1Space

    if engine not in ("spectral", "field"):
        raise ValueError(f"engine must be 'spectral' or 'field', got "
                         f"{engine!r}")
    lat = make_lattice(name, **PARAMS.get(name, {}))
    sp = H1Space.make(PeriodicGrid.make(lat, n), p)
    op = BlochHelmholtz(sp, dtype=torch.complex64, device=device)
    k_cart = np.asarray([lat.k_cart(f) for f in KFRAC], np.float64)
    solve_fn = op.make_solve_fn() if engine == "spectral" else None
    sweep = BandSweep(op, solve_fn, nev=nev, block=nev + 4, tol=tol,
                      maxiter=maxiter)
    return lat, k_cart, op, sweep


def max_rel_err(lat, k_cart, eigenvalues) -> float:
    """The reference's measure: max over k of max |λ − λ_exact| over
    max(λ_exact max, 1)."""
    errs = []
    for i, k in enumerate(k_cart):
        ex = scalar_bands(lat, k, eigenvalues.shape[1], mmax=5)
        errs.append(np.max(np.abs(eigenvalues[i] - ex)) / max(ex.max(), 1.0))
    return float(np.max(errs))


def run_one(name, n, p, nev, tol, maxiter, engine="spectral",
            device="cuda", chunk=None, mesh=None):
    """One lattice: every k in one batched ``run`` (or chunks of
    ``chunk``; over the ranks of ``mesh`` when given); returns its record
    (lattice variant, dofs, max relative error, mean and per-k
    iterations, setup seconds, the measured wall of the run and the host
    refine inside it)."""
    t0 = time.perf_counter()
    lat, k_cart, op, sweep = build(name, n, p, nev, tol, maxiter, engine,
                                   device)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sweep.run(k_cart, mesh=mesh, chunk=chunk)
    wall = time.perf_counter() - t0
    return {"lattice": lat.variant, "dofs": op.space.ndofs,
            "max_rel_err": max_rel_err(lat, k_cart, res.eigenvalues),
            "mean_iters": float(np.mean(res.iterations)),
            "iterations": [int(i) for i in res.iterations],
            "setup_s": setup, "wall_s": wall, "refine_s": res.refine_s,
            "eigenvalues": res.eigenvalues}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m bravais_tpu_torch.cli.config5_all14",
        description="Config 5: all 14 Bravais lattices, empty-lattice "
        "scalar Helmholtz at order p, 8 k-points in one batched sweep "
        "per lattice, against the analytic bands.")
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--nev", type=int, default=6)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=300)
    ap.add_argument("--engine", choices=["spectral", "field"],
                    default="spectral")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--write", metavar="PATH",
                    help="also write the markdown table to PATH")
    ap.add_argument("--shard", action="store_true",
                    help="split each lattice's k over the ranks of a "
                    "torch.distributed group (torchrun)")
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    mesh = None
    if args.shard:
        from bravais_tpu_torch.parallel.mesh import kpoint_mesh
        mesh = kpoint_mesh("nccl" if args.device == "cuda" else "gloo",
                           args.device)
    try:
        return _main(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _main(args, mesh):
    import torch

    from bravais_tpu_torch.lattices import LATTICE_NAMES

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    device = str(mesh.device) if mesh is not None else args.device
    build_s = 0.0
    if args.device == "cuda":
        from bravais_tpu_torch.utils import cuda_build
        t0 = time.perf_counter()
        cuda_build.build_all()
        build_s = time.perf_counter() - t0
        dev = torch.cuda.get_device_name(0)
    else:
        dev = "cpu"
    if mesh is not None:
        dev += (f", k sharded over {mesh.size} rank"
                f"{'s' * (mesh.size > 1)} ({mesh.backend})")
    say(f"# kernels built in {build_s:.2f} s", flush=True)
    rows = []
    for name in LATTICE_NAMES:
        r = run_one(name, args.n, args.p, args.nev, args.tol, args.maxiter,
                    args.engine, device, mesh=mesh)
        rows.append(r)
        say(f"# {r['lattice']:8s} dofs={r['dofs']:6d} "
              f"err={r['max_rel_err']:.2e} iters={r['mean_iters']:5.1f} "
              f"setup={r['setup_s']:6.2f}s wall={r['wall_s']:7.3f}s "
              f"refine={r['refine_s']:6.3f}s", flush=True)

    hdr = (f"# Config 5 — all-14-lattice p={args.p} sweep ({args.engine} "
           f"engine)\n\nEmpty-lattice scalar Helmholtz, n={args.n} "
           f"p={args.p}, {len(KFRAC)} generic k-points per lattice in ONE "
           f"k-batched run, nev={args.nev}, tol={args.tol:g}, device "
           f"`{dev}`, kernels built in {build_s:.2f} s. Validation: max "
           "relative eigenvalue error vs the analytic oracle |k+G|^2 over "
           "all k and bands. Wall: the measured run (host refine "
           "included); setup: operator, stencils and sweep.\n\n"
           "| lattice | dofs | max rel err | mean iters | setup s | wall s "
           "| refine s |\n|---|---|---|---|---|---|---|\n")
    body = "".join(
        f"| {r['lattice']} | {r['dofs']} | {r['max_rel_err']:.2e} | "
        f"{r['mean_iters']:.1f} | {r['setup_s']:.2f} | {r['wall_s']:.3f} | "
        f"{r['refine_s']:.3f} |\n" for r in rows)
    worst = max(r["max_rel_err"] for r in rows)
    above = [r["lattice"] for r in rows if r["max_rel_err"] > 1e-6]
    foot = (f"\nWorst-case error over all 14 families: {worst:.2e}; above "
            f"1e-6: {', '.join(above) or 'none'}.\n")
    say(hdr + body + foot)
    if args.write and lead:
        import pathlib
        pathlib.Path(args.write).write_text(hdr + body + foot)
    return 0 if worst < 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
