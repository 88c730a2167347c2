"""Config 3 certified at production size (port of
``benchmarks/certify_dielectric.py``).

    python -m bravais_tpu_torch.cli.certify_dielectric [--n 6] [--p 3]
        [--nev 10] [--nk 16] [--eps-in 13] [--radius 0.25]
        [--k-indices 0,1,5,10,15] [--bar 1e-6] [--band-floor 1e-3]
        [--f64-tol 1e-9] [--oracle-cheby-target 1e-6] [--device cuda|cpu]

The production path is the FULL nk-point warm sweep of config 3 (CUB with
an ε sphere, Γ–X–M–R, exact Γ nudged to 2e-2·b₁) in complex64 on
``--device`` (default the card): the field engine with the project-cheby
deflation at the production Chebyshev target and the fastdiag
preconditioner, device stop 1e-4, then the f64 host Rayleigh–Ritz; the
sampled k are certified out of it. The oracle solves each sampled k cold
on the CPU in complex128 with a deep Chebyshev projector
(``--oracle-cheby-target``) to the ``--f64-tol`` residual stop, with no
refine. The sampled k are independent, so they are solved in a pool of
host processes (spawned, one thread each; bit for bit the sequential
solves).

Two errors per band: strict |Δλ|/|λ64|, and scale-aware
|Δλ|/max(|λ64|, band_floor·max|λ64|) (the nudged Γ's acoustic bands are
O(|k|²) small, so a strict relative error there amplifies an absolute
agreement by an arbitrary denominator). It prints one JSON line per
certified k plus a summary line, with the reference's keys, and exits 1
if any k misses the scale-aware ``--bar`` or the oracle did not converge
(a residual above 100·``--f64-tol``). The oracle is long at production
size: minutes per k on one core.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

__all__ = ["certify", "default_jobs", "kpoints", "main", "oracle_k", "parser",
           "problem"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m bravais_tpu_torch.cli.certify_dielectric",
        description="Certify config 3's f32 warm sweep against a cold "
        "complex128 matrix-free oracle at the sampled k-points.")
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--nk", type=int, default=16)
    ap.add_argument("--eps-in", type=float, default=13.0)
    ap.add_argument("--radius", type=float, default=0.25)
    ap.add_argument("--k-indices", type=str, default="0,1,5,10,15",
                    help="indices into the nk-point G-X-M-R path to "
                    "certify (k=1, the smallest nonzero |k|, stalls near "
                    "the float32 floor on the device)")
    ap.add_argument("--bar", type=float, default=1e-6,
                    help="scale-aware relative eigenvalue agreement bar")
    ap.add_argument("--band-floor", type=float, default=1e-3,
                    help="scale-aware denominator floor, as a fraction "
                    "of the k-point's largest certified eigenvalue")
    ap.add_argument("--f64-tol", type=float, default=1e-9,
                    help="complex128 oracle residual stop")
    ap.add_argument("--oracle-cheby-target", type=float, default=1e-6,
                    help="kernel-projector contraction per application "
                    "for the oracle (production uses 0.15)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the f32 production sweep runs (the oracle "
                    "always runs on the CPU)")
    return ap


def problem(n, p, eps_in, radius):
    """(lattice, Nédélec space, ε): CUB with an ε sphere at the cell's
    centre."""
    from bravais_tpu_torch.lattices import make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.coefficients import dielectric_sphere
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace

    lat = make_lattice("CUB")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, n), p)
    eps = dielectric_sphere(eps_in, 1.0, radius, 0.5 * lat.A.sum(axis=0),
                            lat.A)
    return lat, sp, eps


def kpoints(lat, nk) -> np.ndarray:
    """The nk Γ–X–M–R k-points with exact Γ nudged to 2e-2·b₁."""
    from bravais_tpu_torch.lattices import kpath

    kc = kpath(lat, npts=nk, path=[["G", "X", "M", "R"]]).k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]
    return kc


def _sweep(sp, eps, nev, dtype, device, device_tol, tol, cheby_target=None):
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl

    op = BlochCurlCurl(sp, eps=eps, dtype=dtype, device=device)
    solve = op.make_solve_fn(deflation="project-cheby", precond="fastdiag",
                             cheby_target=cheby_target)
    return BandSweep(op, solve, nev=nev, block=nev + 6, tol=tol,
                     maxiter=400, device_tol=device_tol)


def oracle_k(cfg: dict, k) -> dict:
    """One sampled k solved cold on the CPU in complex128 (``cfg``: n, p,
    nev, eps_in, radius, f64_tol, cheby_target), with one torch thread:
    {"lam", "iters", "res"}. A module-level function, so that a spawned
    pool can run it."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, sp, eps = problem(cfg["n"], cfg["p"], cfg["eps_in"],
                             cfg["radius"])
        sweep = _sweep(sp, eps, cfg["nev"], torch.complex128, "cpu", None,
                       cfg["f64_tol"], cfg["cheby_target"])
        r = sweep.run_warm(np.asarray(k, np.float64)[None])
    finally:
        torch.set_num_threads(threads)
    return {"lam": np.asarray(r.eigenvalues[0]), "iters": int(r.iterations[0]),
            "res": float(np.max(r.residuals[0]))}


def _oracle(cfg, ks, jobs):
    """``oracle_k`` at each k: in this process (``jobs`` 1) or in a pool
    of ``jobs`` spawned processes."""
    if jobs <= 1:
        return [oracle_k(cfg, k) for k in ks]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # One thread a process; and glibc keeps the freed blocks of the
    # plain element applies' large temporaries instead of returning them
    # to the system and faulting them in again on the next apply (a
    # complex128 solve at n=6 p=3: 60 s → 43 s for 3 iterations on one
    # Intel Xeon core).
    over = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
            "MALLOC_MMAP_THRESHOLD_": str(32 << 20),
            "MALLOC_TRIM_THRESHOLD_": str(16 << 30),
            "MALLOC_TOP_PAD_": str(256 << 20)}
    env = {v: os.environ.get(v) for v in over}
    os.environ.update(over)
    try:
        with ProcessPoolExecutor(
                jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            return list(ex.map(oracle_k, [cfg] * len(ks), ks))
    finally:
        for v, val in env.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val


def default_jobs(nsampled: int) -> int:
    """Oracle processes: one per sampled k, at most the cores this process
    may run on."""
    return max(1, min(nsampled, len(os.sched_getaffinity(0))))


def certify(args, jobs: int | None = None) -> dict:
    """The certification of ``args`` (``parser()``'s namespace):
    {"records": per-k JSON records, "summary": the summary record,
    "f32": the production sweep's ``SweepResult``, "oracle": {k index:
    ``oracle_k``'s record}, "steps": its Chebyshev steps,
    "oracle_steps"}. ``jobs``: oracle processes (default
    ``default_jobs``)."""
    import torch

    idx = [int(s) for s in args.k_indices.split(",")]
    lat, sp, eps = problem(args.n, args.p, args.eps_in, args.radius)
    kc = kpoints(lat, args.nk)
    if args.device == "cuda":
        from bravais_tpu_torch.utils import cuda_build
        cuda_build.build_all()
    sweep32 = _sweep(sp, eps, args.nev, torch.complex64, args.device, 1e-4,
                     1e-6)
    t0 = time.time()
    r32 = sweep32.run_warm(kc)
    if args.device == "cuda":
        torch.cuda.synchronize()
    t32 = time.time() - t0
    cfg = {"n": args.n, "p": args.p, "nev": args.nev, "eps_in": args.eps_in,
           "radius": args.radius, "f64_tol": args.f64_tol,
           "cheby_target": args.oracle_cheby_target}
    t0 = time.time()
    r64 = dict(zip(idx, _oracle(cfg, [kc[i] for i in idx],
                                jobs or default_jobs(len(idx)))))
    t64 = time.time() - t0

    worst_scaled = worst_strict = 0.0
    oracle_bad, records = [], []
    ok = True
    for i in idx:
        lam32 = np.asarray(r32.eigenvalues[i])[:args.nev]
        lam64 = r64[i]["lam"][:args.nev]
        res64 = r64[i]["res"]
        if res64 > 100.0 * args.f64_tol:
            oracle_bad.append(i)
        strict = np.abs(lam32 - lam64) / np.maximum(np.abs(lam64), 1e-30)
        floor = args.band_floor * float(np.abs(lam64).max())
        scaled = np.abs(lam32 - lam64) / np.maximum(np.abs(lam64), floor)
        worst_strict = max(worst_strict, float(strict.max()))
        worst_scaled = max(worst_scaled, float(scaled.max()))
        ok &= bool(scaled.max() < args.bar)
        records.append({
            "k_index": i, "k": [float(x) for x in kc[i]],
            "max_rel_err_scaled": float(scaled.max()),
            "max_rel_err_strict": float(strict.max()),
            "rel_err_strict_per_band": [float(f"{v:.3g}") for v in strict],
            "f32_iters": int(r32.iterations[i]),
            "f64_iters": r64[i]["iters"],
            "f32_max_resid": float(np.max(r32.residuals[i])),
            "f64_max_resid": res64,
            "lam_lo": float(lam64[0]), "lam_hi": float(lam64[-1]),
        })
    summary = {
        "summary": "dielectric f32+refine (full warm sweep) vs f64 "
                   "matrix-free cold oracle",
        "n": args.n, "p": args.p, "ndofs": sp.ndofs, "nev": args.nev,
        "eps_in": args.eps_in, "radius": args.radius,
        "k_indices": idx, "bar": args.bar,
        "band_floor": args.band_floor,
        "oracle_cheby_target": args.oracle_cheby_target,
        "worst_rel_err_scaled": worst_scaled,
        "worst_rel_err_strict": worst_strict,
        "oracle_unconverged_k": oracle_bad,
        "certified": bool(ok and not oracle_bad),
        "f32_wall_s": round(t32, 1), "f64_wall_s": round(t64, 1),
    }
    return {"records": records, "summary": summary, "f32": r32,
            "oracle": r64, "steps": sweep32.op.cheby_steps(),
            "oracle_steps": sweep32.op.cheby_steps(args.oracle_cheby_target),
            "f32_wall": t32, "f64_wall": t64}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    dev = (torch.cuda.get_device_name(0) if args.device == "cuda"
           else "cpu")
    jobs = default_jobs(len(args.k_indices.split(",")))
    print(f"# f32 sweep on {dev}; complex128 oracle on the CPU in {jobs} "
          f"process{'es' * (jobs > 1)}", flush=True)
    got = certify(args, jobs)
    print(f"# walls: f32 sweep {got['f32_wall']:.3f} s, oracle "
          f"{got['f64_wall']:.3f} s; Chebyshev steps {got['steps']} "
          f"(oracle {got['oracle_steps']})", flush=True)
    for rec in got["records"]:
        print(json.dumps(rec))
    print(json.dumps(got["summary"]), flush=True)
    return 0 if got["summary"]["certified"] else 1


if __name__ == "__main__":
    sys.exit(main())
