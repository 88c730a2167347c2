"""One k-point at the edge of a card, and beyond it (port of
``benchmarks/scale_demo.py``).

    python -m bravais_tpu_torch.cli.scale_demo --part single [--p 4] [--m 16]
    torchrun --standalone --nproc-per-node 4 -m -- \\
        bravais_tpu_torch.cli.scale_demo --part dd [--n N] [--p 4] [--m 16]

``--part single`` (one card): the footprint of the FCC headline's
spectral warm solve (p=4, nev 10 in a block of m=16). The reference's
model counts (B, D, D) complex64 block arrays, B = n³ blocks of D = 3p³:
B·D²·8 bytes each, ≈6 of them. Here the array count is fitted from the
peaks (``torch.cuda.max_memory_allocated``) of the warm solve at n = 8,
12 and 16 (the nudged Γ and X), and the fit must lie within 10% of each.
The part then runs the headline at the largest n that the fitted model
puts under 90% of the card's memory (``torch.cuda.get_device_properties``)
at the nudged Γ, X, W and L, and reports its eig/s, its peak against the
model and its error against the analytic bands (bench.py's measure, bar
1e-6).

``--part dd`` (a ``torch.distributed`` group from the launcher's
environment, NCCL, one card a rank): the reference's problem, the FCC
field operator at k = (0.3, 0.1, 0.2) (fractional), order p, with a
plain LOBPCG (``apply_A``/``apply_M``, 10 bands in a block of m, 2
iterations) whose one-card footprint exceeds the card. Rank 0 fits a
one-card model of that LOBPCG, peak = a·ndofs + b, from its measured
peaks at n = 8, 12, 16 and 24; the part takes the smallest n (n % 4 = 0)
whose one-card prediction exceeds the card by at least 10% and whose
per-rank prediction (its share of the dofs, plus one halo plane) stays
under 75% of it (``--n`` overrides). Then, over the group, on
``CurlCurlSlab`` (the dof axis split into slabs of whole elements): the
2-iteration LOBPCG with its Gram sums reduced over the ranks, and one
``apply_A`` of the seed-0 random field at full shape. It prints the
one-card footprint predicted, each rank's measured peak and the executed
apply's (finite) norm.

Each part prints one JSON line per measurement and exits 1 if a gate
fails.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import sys
import time

import numpy as np

__all__ = ["analytic_error", "array_bytes", "dd_choose", "dd_field",
           "dd_predict", "dd_start", "dd_step", "fcc_operator", "fit_count",
           "fit_linear", "headline_run", "largest_n", "main",
           "reference_model", "single_fit"]

#: Part single: the n of the measured peaks, the bands, the device stop,
#: the model's bar and the share of the card the largest n may fill.
SINGLE_NS, NEV, DEVICE_TOL, FIT_BAR, SINGLE_SHARE = (8, 12, 16), 10, 1e-3, \
    0.10, 0.90
ERR_BAR = 1e-6
#: Part dd: the n of the one-card peaks, the reference's k, the margin
#: over the card and the share of it a rank may fill.
DD_NS, DD_KFRAC, DD_OVER, DD_RANK_SHARE = (8, 12, 16, 24), (0.3, 0.1, 0.2), \
    1.10, 0.75
DD_ITERS, DD_TOL, DD_SEED = 2, 1e-5, 1


def array_bytes(n: int, p: int) -> int:
    """Bytes of one (B, D, D) complex64 block array: B = n³, D = 3p³."""
    return n ** 3 * (3 * p ** 3) ** 2 * 8


def reference_model(p: int) -> list:
    """The reference's footprint lines (``benchmarks/scale_demo.py
    --part single``): GiB per (B, D, D) array and 6 of them."""
    out = []
    for n in (8, 10, 12, 14, 16):
        per = array_bytes(n, p) / 2 ** 30
        out.append({"metric": f"spectral-engine block-array GiB (n={n} p=4)",
                    "value": round(per, 2),
                    "unit": "GiB per (B,D,D) array",
                    "est_program_GiB": round(6 * per, 1)})
    return out


def fit_count(sizes, peaks) -> float:
    """The count c minimizing Σ (c·size/peak − 1)²: arrays of ``sizes``
    bytes that the ``peaks`` hold."""
    r = np.asarray(sizes, np.float64) / np.asarray(peaks, np.float64)
    return float(r.sum() / (r * r).sum())


def fit_linear(xs, ys) -> tuple:
    """(a, b) of the least-squares line y = a·x + b."""
    a, b = np.polyfit(np.asarray(xs, np.float64), np.asarray(ys, np.float64),
                      1)
    return float(a), float(b)


def analytic_error(lam, lat, k) -> float:
    """bench.py's measure: max |λ − λ_exact| over max(λ_exact max, 1),
    λ_exact the len(lam) lowest empty-lattice Maxwell bands (|k+G|² over
    |m_i| ≤ 3, each twice)."""
    vals = sorted(float(np.sum((np.asarray(k) + np.asarray(m) @ lat.B) ** 2))
                  for m in itertools.product(range(-3, 4), repeat=3))
    ex = np.asarray(sorted(vals * 2)[:len(lam)])
    return float(np.max(np.abs(np.asarray(lam) - ex))) / max(
        float(ex.max()), 1.0)


def fcc_operator(n, p, dtype, device):
    """(lattice, ``BlochCurlCurl``) of the empty FCC cell at n, order p."""
    from bravais_tpu_torch.lattices import make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace

    lat = make_lattice("FCC")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, n), p)
    return lat, BlochCurlCurl(sp, dtype=dtype, device=device)


def _free(device) -> int:
    """Collect, release the cached blocks and reset the peak; returns the
    device bytes still allocated (the base a peak is measured over)."""
    import torch
    gc.collect()
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _peak(device, base):
    """The device bytes allocated at the peak since ``_free`` over
    ``base`` (None on the CPU)."""
    import torch
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) - base


def headline_k(lat, labels=("G", "X", "W", "L")) -> np.ndarray:
    """The headline path's (FCC Γ–X–W–L, nk=16) symmetry points among
    ``labels``, exact Γ nudged to 2e-2·b₁."""
    from bravais_tpu_torch.lattices import kpath

    kp = kpath(lat, npts=16, path=[["G", "X", "W", "L"]])
    idx = [i for i, name in kp.labels if name in labels]
    kc = kp.k_cart[idx].copy()
    kc[np.linalg.norm(kc, axis=1) < 1e-12] = 2e-2 * lat.B[0]
    return kc


def headline_run(n, p, m, labels, device) -> dict:
    """The headline's spectral warm solve at n over the ``labels``
    symmetry points on ``device``: its peak device bytes (the
    operator's set-up and stencils included), wall, eig/s, iterations and
    error against the analytic bands."""
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep

    device = torch.device(device)
    base = _free(device)
    lat, op = fcc_operator(n, p, torch.complex64, device)
    kc = headline_k(lat, labels)
    sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=NEV, block=m,
                      tol=1e-6, maxiter=250, device_tol=DEVICE_TOL)
    t0 = time.perf_counter()
    res = sweep.run_warm(kc)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    peak = _peak(device, base)
    k32 = kc.astype(np.float32).astype(np.float64)
    err = max(analytic_error(res.eigenvalues[i], lat, k)
              for i, k in enumerate(k32))
    out = {"n": n, "ndofs": op.space.ndofs, "k": len(kc), "peak": peak,
           "wall_s": wall, "eig_per_s": len(kc) / wall,
           "iterations": res.iterations.tolist(), "err": err,
           "fallbacks": int(res.fallbacks)}
    del sweep, op, res
    _free(device)
    return out


def single_fit(ns, p, m, device) -> dict:
    """The headline's warm-solve peaks at each n of ``ns`` (nudged Γ and
    X), the fitted array count c and each peak's deviation from
    c·``array_bytes``."""
    runs = [headline_run(n, p, m, ("G", "X"), device) for n in ns]
    c = fit_count([array_bytes(n, p) for n in ns], [r["peak"] for r in runs])
    dev = [c * array_bytes(r["n"], p) / r["peak"] - 1.0 for r in runs]
    return {"runs": runs, "count": c, "deviation": dev}


def part_single(args) -> int:
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_properties(dev).total_memory
    for rec in reference_model(args.p):
        print(json.dumps(rec))
    fit = single_fit(SINGLE_NS, args.p, args.m, dev)
    c = fit["count"]
    for r, d in zip(fit["runs"], fit["deviation"]):
        print(json.dumps({
            "metric": f"headline spectral warm solve peak (FCC n={r['n']} "
                      f"p={args.p}, {r['ndofs']} dofs, nudged G and X)",
            "value": r["peak"] / 2 ** 30, "unit": "GiB",
            "model_GiB": c * array_bytes(r["n"], args.p) / 2 ** 30,
            "model_over_peak_minus_1": d, "wall_s": r["wall_s"],
            "max_eig_err": r["err"]}), flush=True)
    n = largest_n(c, args.p, cap)
    print(json.dumps({
        "metric": "fitted footprint model", "arrays": c,
        "unit": "(B,D,D) complex64 arrays at the peak",
        "fit_within": max(abs(d) for d in fit["deviation"]),
        "capacity_GiB": cap / 2 ** 30, "largest_n": n,
        "largest_n_model_GiB": c * array_bytes(n, args.p) / 2 ** 30,
        "device": torch.cuda.get_device_name(dev)}), flush=True)
    big = headline_run(n, args.p, args.m, ("G", "X", "W", "L"), dev)
    print(json.dumps({
        "metric": f"headline at the largest n (FCC n={n} p={args.p}, "
                  f"{big['ndofs']} dofs, nev {NEV} in {args.m}, "
                  f"{big['k']} k)",
        "value": big["eig_per_s"], "unit": "eig/s",
        "wall_s": big["wall_s"], "iterations": big["iterations"],
        "max_eig_err": big["err"], "fallbacks": big["fallbacks"],
        "peak_GiB": big["peak"] / 2 ** 30,
        "peak_over_model": big["peak"] / (c * array_bytes(n, args.p))}),
        flush=True)
    ok = (max(abs(d) for d in fit["deviation"]) < FIT_BAR
          and big["err"] < ERR_BAR and big["fallbacks"] == 0
          and all(r["err"] < ERR_BAR for r in fit["runs"]))
    return 0 if ok else 1


# -- part dd -----------------------------------------------------------------

def dd_field(space) -> np.ndarray:
    """The reference's executed input: the seed-0 float32 normal pair
    (2, 1, *field) as one complex field (1, *field)."""
    u = np.random.default_rng(0).standard_normal(
        (2, 1) + tuple(space.field_shape)).astype(np.float32)
    return u[0] + 1j * u[1]


def dd_start(space, m: int, planes: slice, seed: int = DD_SEED
             ) -> np.ndarray:
    """The LOBPCG start block's dof planes ``planes`` of axis 1, complex
    (m, 3, len, N₂, N₃): plane i drawn from ``default_rng([seed, i])``, so
    that a rank draws only its slab and the slabs tile the one-card
    block."""
    shp = (2, m, 3) + tuple(space.field_shape[2:])
    out = []
    for i in range(planes.start, planes.stop):
        x = np.random.default_rng([seed, i]).standard_normal(shp)
        out.append(x[0] + 1j * x[1])
    return np.stack(out, axis=2)


def dd_step(n, p, m, nev, dtype, device, mesh=None) -> dict:
    """The dd part's work at n on ``device``: the 2-iteration LOBPCG (plain
    ``apply_A``/``apply_M``) at the reference's k from ``dd_start`` and
    one ``apply_A`` of ``dd_field``. With ``mesh`` on this rank's slab
    (``CurlCurlSlab``, the Gram sums and the norm reduced over the group);
    without, on the whole field. Returns the eigenvalues, iterations, the
    apply's norm, walls, and the peak device bytes (CUDA) and the nd
    launches (by half) of the two steps."""
    import torch
    from bravais_tpu_torch.eigen.lobpcg import lobpcg
    from bravais_tpu_torch.operators import nd_apply
    from bravais_tpu_torch.operators.curlcurl import CurlCurlSlab

    device = torch.device(device)
    base = _free(device)
    lat, op = fcc_operator(n, p, dtype, device)
    sp = op.space
    k = np.asarray(lat.k_cart(DD_KFRAC), np.float64)
    if mesh is None:
        A, planes, reduce = op, slice(0, sp.field_shape[1]), None
    else:
        A = CurlCurlSlab(op, mesh)
        planes, reduce = A.dofs, mesh.all_reduce_
    X0 = torch.as_tensor(dd_start(sp, m, planes), dtype=dtype, device=device)
    u = torch.as_tensor(dd_field(sp)[..., planes, :, :], dtype=dtype,
                        device=device)
    before = dict(nd_apply.launches_by_mode)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()
    r = lobpcg(lambda x: A.apply_A(x, k), lambda x: A.apply_M(x, k), X0, nev,
               maxiter=DD_ITERS, tol=DD_TOL, reduce=reduce)
    lam = r.eigenvalues.double().cpu().numpy()
    sync()
    t_lobpcg = time.perf_counter() - t0
    del X0, r
    t0 = time.perf_counter()
    y = A.apply_A(u, k)
    sq = (y.abs() ** 2).sum().reshape(1).double()
    if reduce is not None:
        reduce(sq)
    norm = float(sq.sqrt())
    sync()
    t_apply = time.perf_counter() - t0
    out = {"n": n, "ndofs": sp.ndofs, "eigenvalues": lam,
           "iterations": DD_ITERS, "norm": norm, "finite": bool(
               torch.isfinite(y).all()), "lobpcg_s": t_lobpcg,
           "apply_s": t_apply, "slab": [planes.start, planes.stop],
           "nd": {w: nd_apply.launches_by_mode[w] - before[w]
                  for w in before},
           "peak": _peak(device, base)}
    del y, u, A, op
    _free(device)
    return out


def dd_predict(a, b, n, p, P) -> tuple:
    """(one card's, one of P ranks') predicted bytes of the dd part at n
    from the fitted line a·ndofs + b: a rank holds its share of the dofs
    plus one halo plane of the n·p."""
    nd = 3 * n ** 3 * p ** 3
    return a * nd + b, a * nd * (1 / P + 1 / (n * p)) + b


def dd_choose(a, b, cap, p, P, n=None) -> int:
    """The dd part's n: ``n`` if given, else the smallest n (n % P = 0)
    whose one-card prediction is at least ``DD_OVER`` times the card's
    bytes ``cap`` and whose per-rank prediction stays under
    ``DD_RANK_SHARE`` of it (``dd_predict``)."""
    if n is not None:
        return n
    for n in range(P, 1025, P):
        one, rank = dd_predict(a, b, n, p, P)
        if one >= DD_OVER * cap and rank < DD_RANK_SHARE * cap:
            return n
    raise RuntimeError("no n fits the dd part's bounds")


def largest_n(count, p, cap) -> int:
    """The largest headline n whose fitted footprint, ``count`` (B, D, D)
    arrays, stays under ``SINGLE_SHARE`` of the card's bytes ``cap``."""
    return max(n for n in range(SINGLE_NS[0], 257)
               if count * array_bytes(n, p) <= SINGLE_SHARE * cap)


def part_dd(args) -> int:
    import torch
    from bravais_tpu_torch.parallel.mesh import kpoint_mesh
    from bravais_tpu_torch.utils import cuda_build

    mesh = kpoint_mesh("nccl", "cuda")
    try:
        dev = mesh.device
        cuda_build.build_all()
        cap = torch.cuda.get_device_properties(dev).total_memory
        fit = None
        if mesh.rank == 0:
            runs = [dd_step(n, args.p, args.m, NEV, torch.complex64, dev)
                    for n in DD_NS]
            a, b = fit_linear([r["ndofs"] for r in runs],
                              [r["peak"] for r in runs])
            for r in runs:
                pred = a * r["ndofs"] + b
                print(json.dumps({
                    "metric": f"field-engine Maxwell LOBPCG peak, 1 card "
                              f"(FCC n={r['n']} p={args.p}, {r['ndofs']} "
                              f"dofs, m={args.m})",
                    "value": r["peak"] / 2 ** 30, "unit": "GiB",
                    "model_over_peak_minus_1": pred / r["peak"] - 1.0,
                    "lobpcg_s": r["lobpcg_s"], "norm": r["norm"]}),
                    flush=True)
            n = dd_choose(a, b, cap, args.p, mesh.size, args.n)
            fit = (a, b, n)
        a, b, n = mesh.broadcast_object(fit)
        ndofs = 3 * n ** 3 * args.p ** 3
        one, per = dd_predict(a, b, n, args.p, mesh.size)
        if mesh.rank == 0:
            print(json.dumps({
                "metric": f"field-engine Maxwell LOBPCG footprint, 1 card, "
                          f"predicted (FCC n={n} p={args.p}, {ndofs} dofs, "
                          f"m={args.m})",
                "value": one / 2 ** 30, "unit": "GiB", "n": n,
                "bytes_per_dof": a, "fixed_GiB": b / 2 ** 30,
                "vec_MiB": ndofs * 8 / 2 ** 20,
                "capacity_GiB": cap / 2 ** 30,
                "fits_one_card": bool(one < cap),
                "predicted_per_rank_GiB": per / 2 ** 30,
                "device": torch.cuda.get_device_name(dev)}), flush=True)
        got = dd_step(n, args.p, args.m, NEV, torch.complex64, dev, mesh)
        recs = mesh.all_gather_object(
            {"rank": mesh.rank, "peak": got["peak"], "nd": got["nd"],
             "slab": got["slab"], "lobpcg_s": got["lobpcg_s"],
             "apply_s": got["apply_s"], "finite": got["finite"]})
        ok = (all(r["finite"] for r in recs) and np.isfinite(got["norm"])
              and np.all(np.isfinite(got["eigenvalues"])))
        if mesh.rank == 0:
            print(json.dumps({
                "metric": f"dof-sharded over {mesh.size} ranks, measured "
                          f"peak per rank",
                "value": max(r["peak"] for r in recs) / 2 ** 30,
                "unit": "GiB/rank", "per_rank_GiB": [
                    r["peak"] / 2 ** 30 for r in recs],
                "predicted_per_rank_GiB": per / 2 ** 30,
                "fits_per_rank": bool(max(r["peak"] for r in recs) < cap),
                "lobpcg_s": [r["lobpcg_s"] for r in recs],
                "eigenvalues": got["eigenvalues"].tolist(),
                "nd_launches": [r["nd"] for r in recs],
                "slabs": [r["slab"] for r in recs]}), flush=True)
            print(json.dumps({
                "metric": f"dof-sharded apply_A executed at n={n} "
                          f"p={args.p}",
                "value": got["norm"], "unit": "norm(finite)",
                "apply_s": [r["apply_s"] for r in recs], "ok": bool(ok)}),
                flush=True)
        mesh.barrier()
        return 0 if ok else 1
    finally:
        mesh.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bravais_tpu_torch.cli.scale_demo",
        description="One k-point at and beyond one card's memory: the "
        "headline's footprint model and largest n (single), the FCC field "
        "LOBPCG over a dof-sharded group (dd).")
    ap.add_argument("--part", choices=["dd", "single"], default="dd")
    ap.add_argument("--n", type=int, default=None,
                    help="dd: the grid (default: the smallest n the fitted "
                    "model puts beyond one card)")
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--m", type=int, default=16)
    args = ap.parse_args(argv)
    # Near the card's capacity the caching allocator's fixed segments
    # strand free memory between (B, D, D) arrays of gigabytes (at n=31
    # on an H100 80GB: 21.6 GiB reserved but unallocated beside 48.7 GiB
    # allocated);
    # growable segments leave the peak at what is allocated.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        ap.error("no CUDA device: both parts measure a card's memory")
    if args.part == "single":
        from bravais_tpu_torch.utils import cuda_build
        cuda_build.build_all()
        return part_single(args)
    return part_dd(args)


if __name__ == "__main__":
    sys.exit(main())
