#!/usr/bin/env python3
"""Where the time goes in the port's sweeps on one NVIDIA GPU: the FCC
headline (spectral engine), config 3 (the dielectric field engine),
config 1 (the scalar spectral engine) and config 2 TM (the matrix-free
scalar solve with the multigrid preconditioner), all as ``chip_smoke.py``
configures them.

    python3 chip_profile.py      # needs one card; no arguments

For each sweep (one cold pass first) it prints, one line each:

1. the pass: wall, host refine (on the sweep's worker thread, beside the
   next k's solve) and its hidden share, device solve split into per-k
   setup and LOBPCG (CUDA-synchronised host clock on the main thread),
   time per LOBPCG iteration with the refine beside it and in a second
   pass with the refine off, the rate over all nk k-points;
2. the per-k setup pieces at one k (CUDA events, median of 20) and, for
   the field engine, the pieces of one LOBPCG iteration: the
   preconditioner, the fused (A, M) apply, the Chebyshev gradient
   projector and the mass apply at their row counts; for config 2 the
   V-cycle and the fused (A, M) at the block's rows;
3. a ``torch.profiler`` trace of the device solve of two k-points: the
   device operations (kernels, copies, fills), the device's busy time
   and idle share of the traced window and of the same solves run
   untraced (the profiler slows the host), the device operations per
   LOBPCG iteration (a count, comparable across calls), the device time
   by group and the operations ranked by device time.

    python3 chip_profile.py --batched

traces instead the k-batched solve of one chunk (``BandSweep.run``'s
solve of all nk k at once, no refine) of the headline, config 3, config
4's FCC field path (nk = 8) and config 2 TM: the device operations, the
lockstep iterations and the k-iterations they solve, the device
operations per lockstep iteration, the busy time and idle share of the
traced window, the untraced wall of the batched solve against the same
k solved one at a time, and the peak device memory of the batched solve.

    git archive <parent commit> | (mkdir -p .chip_tmp/parent &&
        tar -x -C .chip_tmp/parent)
    python3 chip_profile.py --overlap .chip_tmp/parent

measures what the sweeps' refine overlap gains against the tree before
it (the argument: a checkout of that tree): six processes in turns
parent, this tree, this tree, parent, parent, this tree, each importing
its own tree's package and running, for the headline, config 3, config 1
and config 2 TM as this script sets them up, one cold warm pass and two
timed ones, each with its wall and ``refine_s`` (and, where the tree has
them, ``solve_s``, the hidden share and the main thread's seconds in
``BandSweep._fetch``, its copies to the host); then each path's median
walls and their ratio, this tree over the parent. First, which host
calls of the refine hold the interpreter lock: a pure-Python loop's time
beside each call, running in a loop on a second thread, over its time
alone (1 for a call that releases the lock, about 2 for one that holds
it).

    python3 chip_profile.py --switch

times the same four paths' warm passes as the serial composition and
overlapped at several interpreter switch intervals (5 ms is CPython's
default), twice in turns, the headline also with its spectral refine's
per-block eigh answered by numpy (which releases the lock).

Every figure is measured in this run; the card's name and power limit
come first.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import chip_smoke  # sets the host BLAS thread cap before numpy loads

TRACE_K = (4, 5)   # k-points of the traced window (steady warm starts)
# Device operations grouped by a substring of their name, first match wins.
GROUPS = (("Jacobi kernel", "jacobi_eigh_kernel"),
          ("nd kernel", "nd_apply_kernel"), ("h1 kernel", "h1_apply_kernel"),
          ("GEMM", "gemm"), ("triangular solve", "trsm"),
          ("Cholesky", "potrf"), ("LU and inverse", "getr"),
          ("copies", "copy"), ("copies", "Cat"), ("copies", "Memcpy"))


def timed(fn, into):
    """``fn`` wrapped to append its CUDA-synchronised wall (s) to ``into``."""
    import torch

    def w(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t)
        return out
    return w


def phase_pass(tag, kc, sweep, make_solve):
    """One warm pass with the solve and its LOBPCG timed on the main
    thread (the refine of k runs on the sweep's worker thread beside the
    solve of k+1), then the same pass with the refine off: the LOBPCG's
    ms per iteration with the refine beside it and alone (what the
    worker's share of the interpreter costs the host-driven solve).
    ``make_solve`` makes the engine's solve, or is None for the sweep's
    built-in one."""
    from bravais_tpu_torch.bands import sweep as sweep_mod
    from bravais_tpu_torch.eigen import lobpcg as lobpcg_mod

    plain = lobpcg_mod.lobpcg
    untimed = sweep.solve_fn
    runs = []
    for refine in (True, False):
        t_solve, t_lob = [], []
        lobpcg_mod.lobpcg = sweep_mod.lobpcg = timed(plain, t_lob)
        try:
            solve = make_solve() if make_solve else untimed  # binds the
            wsolve = timed(solve, t_solve)                   # timed lobpcg
            if hasattr(solve, "refine_np"):
                wsolve.refine_np = solve.refine_np
            sweep.solve_fn = wsolve
            sweep.refine = refine
            res = sweep.run_warm(kc)
        finally:
            lobpcg_mod.lobpcg = sweep_mod.lobpcg = plain
            sweep.solve_fn = make_solve() if make_solve else untimed
            sweep.refine = True
        iters = int(res.iterations.sum())
        runs.append((res, sum(t_solve), sum(t_lob), iters))
    (res, t_solve, t_lob, iters), (alone, _, t_lob1, iters1) = runs
    nk = len(kc)
    hidden = (res.solve_s + res.refine_s - res.wall_s) / res.refine_s
    chip_smoke.log(tag, f"wall {res.wall_s:.4f} s for nk={nk}: host "
                   f"refine {res.refine_s:.4f} s on the worker (hidden "
                   f"share {hidden:.4f}), device solve {t_solve:.4f} s "
                   f"(solve_s {res.solve_s:.4f} s; setup and block "
                   f"transforms {t_solve - t_lob:.4f} s, LOBPCG "
                   f"{t_lob:.4f} s over {iters} iterations = "
                   f"{1e3 * t_lob / iters:.3f} ms/iter with the refine "
                   f"beside it, {1e3 * t_lob1 / iters1:.3f} ms/iter alone "
                   f"over {iters1}); {nk / res.wall_s:.4f} eig/s over all "
                   f"k; the pass with the refine off {alone.wall_s:.4f} s")
    return res


def phase_setup(kc, op):
    """CUDA-event times of the per-k setup pieces at k = kc[TRACE_K[0]]."""
    import torch
    from bravais_tpu_torch.utils.timing import cuda_ms

    fd = op.fastdiag_G()
    k = kc[TRACE_K[0]]
    s_ = op.default_fd_shift()
    TA = fd.blocks([("A", 1.0)], k)
    TM = fd.blocks([("M", 1.0)], k)
    TG = fd.blocks([("G", 1.0)], k)
    Lc = torch.linalg.cholesky(TA + s_ * TM)
    eyeD = torch.eye(fd.D, dtype=TA.dtype, device=TA.device)
    Lb = TG.mH @ (TM @ TG)
    eyeH = 1e-7 * torch.eye(Lb.shape[-1], dtype=TA.dtype, device=TA.device)
    pieces = {
        "blocks A": lambda: fd.blocks([("A", 1.0)], k),
        "blocks M": lambda: fd.blocks([("M", 1.0)], k),
        "blocks G": lambda: fd.blocks([("G", 1.0)], k),
        f"cholesky {tuple(Lc.shape)}": lambda: torch.linalg.cholesky(
            TA + s_ * TM),
        "its triangular inverse": lambda: torch.linalg.solve_triangular(
            Lc, eyeD.expand(Lc.shape), upper=False),
        f"L = GᴴMG {tuple(Lb.shape)} and cholesky_ex": lambda:
            torch.linalg.cholesky_ex(TG.mH @ (TM @ TG) + eyeH),
    }
    ms = {name: cuda_ms(fn, reps=20) for name, fn in pieces.items()}
    chip_smoke.log("setup", f"per-k setup {sum(ms.values()):.4f} ms: " +
                   ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items()))


def phase_field_pieces(kc, op, sweep):
    """CUDA-event times of the field solve's per-k setup and of the
    pieces of one LOBPCG iteration at k = kc[TRACE_K[0]]."""
    import torch
    from bravais_tpu_torch.eigen.jacobi_eigh import jacobi_eigh
    from bravais_tpu_torch.utils.timing import cuda_ms

    k = kc[TRACE_K[0]]
    fd, fdL = op.fastdiag(), op.fastdiag_L()
    s_ = op.default_fd_shift()
    T = fd.blocks([("A", 1.0), ("M", s_)], k)
    TL = fdL.blocks([("L", 1.0)], k)
    setup = {
        f"blocks A+sM {tuple(T.shape)}":
            lambda: fd.blocks([("A", 1.0), ("M", s_)], k),
        "their inverse": lambda: torch.linalg.inv(T),
        f"blocks L {tuple(TL.shape)}": lambda: fdL.blocks([("L", 1.0)], k),
        "their Jacobi eigh": lambda: jacobi_eigh(TL),
    }
    ms = {name: cuda_ms(fn, reps=20) for name, fn in setup.items()}
    chip_smoke.log("diel setup", f"per-k setup {sum(ms.values()):.4f} ms: "
                   + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items()))
    ph = op.phases(k)
    lpc = fdL.solver([("L", 1.0)], k, method="eigh")
    pc = op.fd_precond(k)
    m = sweep.m
    gen = torch.Generator(device=op.device).manual_seed(2)
    X = torch.randn((2 * m,) + op.space.field_shape, generator=gen,
                    dtype=op.dtype, device=op.device)
    phi = torch.randn((2 * m,) + op.space.dof_shape, generator=gen,
                      dtype=op.dtype, device=op.device)

    def proj(u):
        return op.gradient_component_cheby(u, ph=ph, lsolve=lpc)

    pieces = {
        f"precond (A+sM)^-1 [{m} rows]": lambda: pc(X[:m]),
        f"projector [{m} rows]": lambda: proj(X[:m]),
        f"projector [{2 * m} rows]": lambda: proj(X),
        f"fused (A, M) [{m} rows]": lambda: op.apply_AM(X[:m], ph=ph),
        f"M [{2 * m} rows]": lambda: op.apply_M(X, ph=ph),
        f"L apply [{2 * m} rows]": lambda: op.apply_Lk(phi, ph=ph),
        f"L-twin solve [{2 * m} rows]": lambda: lpc(phi),
    }
    ms = {name: cuda_ms(fn, reps=20) for name, fn in pieces.items()}
    chip_smoke.log("diel iter", "per-iteration pieces (one iteration runs "
                   "the precond and the projector on m rows, the fused "
                   "(A, M) on m rows, the projector and M on 2m rows): "
                   + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items()))


def phase_gmg_pieces(kc, op, sweep):
    """CUDA-event times of one config-2 LOBPCG iteration's operator work
    at k = kc[TRACE_K[0]]: the V-cycle on the block's rows, one fused
    (A, M) apply and one "A" apply on each multigrid level."""
    import torch
    from bravais_tpu_torch.utils.timing import cuda_ms

    k = kc[TRACE_K[0]]
    m = sweep.m
    gen = torch.Generator(device=op.device).manual_seed(3)
    X = torch.randn((m,) + op.space.dof_shape, generator=gen,
                    dtype=op.dtype, device=op.device)
    pc = sweep.gmg.precond(k)
    pieces = {f"V-cycle [{m} rows]": lambda: pc(X),
              f"fused (A, M) [{m} rows]": lambda: op.apply_AM(X, k)}
    for lv in sweep.gmg.levels:
        sp = lv.op.space
        Y = torch.randn((m,) + sp.dof_shape, generator=gen, dtype=op.dtype,
                        device=op.device)
        pieces[f"A on {sp.grid.shape[0]}x{sp.grid.shape[1]} p{sp.p} "
               f"[{m} rows]"] = (lambda o=lv.op, y=Y: o.apply_A(y, k))
    ms = {name: cuda_ms(fn, reps=20) for name, fn in pieces.items()}
    chip_smoke.log("rods iter", "per-iteration pieces (one iteration runs "
                   f"the V-cycle, {sweep.gmg.launches_per_vcycle()} level "
                   "applies, and one fused (A, M) on m rows): "
                   + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items()))


def busy_us(dev):
    """The union of the device operations' time spans, and the window
    from the first start to the last end (µs)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def phase_batched_trace(tag, kc, sweep):
    """The device solve of the whole chunk ``kc`` as ``run`` solves it
    (one k-batched solve, no refine): untraced against the same k solved
    one at a time, then traced."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_ = sweep.op.device
    ks = sweep._rounded(kc)
    bsolve = sweep._batched_solve()
    X0 = sweep._x0()

    def batched():
        return bsolve(X0, ks, sweep.nev, sweep.tol, sweep.maxiter)[0]

    def looped():
        return [bsolve(X0, k[None], sweep.nev, sweep.tol,
                       sweep.maxiter)[0] for k in ks]
    batched()                                   # allocator, caches
    walls = {}
    for name, fn in (("batched", batched), ("looped", looped)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev_)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated(dev_) / 2**20, out)
    r = walls["batched"][2]
    its = np.asarray(r.iterations)
    its_1 = np.concatenate([np.asarray(x.iterations)
                            for x in walls["looped"][2]])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batched()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device work")
    busy, window = busy_us(dev)
    lock = int(its.max())
    chip_smoke.log(tag, f"batched device solve of nk={len(ks)}: "
                   f"{walls['batched'][0]:.4f} s untraced, peak device "
                   f"memory {walls['batched'][1]:.1f} MiB; the same k one "
                   f"at a time {walls['looped'][0]:.4f} s "
                   f"({walls['looped'][0] / walls['batched'][0]:.2f}x), "
                   f"peak {walls['looped'][1]:.1f} MiB; iterations batched "
                   f"{its.tolist()}, looped {its_1.tolist()}: {lock} "
                   f"lockstep iterations for {int(its.sum())} k-iterations "
                   f"(looped {int(its_1.sum())})")
    chip_smoke.log(tag, f"traced: {len(dev)} device operations "
                   f"({len(dev) / lock:.1f} per lockstep iteration), busy "
                   f"{busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window "
                   f"(idle share {1 - busy / window:.4f}); untraced idle "
                   f"share {1 - busy / (1e6 * walls['batched'][0]):.4f} if "
                   f"the busy time is the same")


def phase_trace(tag, kc, sweep):
    """Profile the device solve (no refine) of the TRACE_K k-points."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve = sweep.solve_fn
    r, _ = solve(sweep._x0(), kc[TRACE_K[0] - 1], sweep.nev, sweep.tol,
                 sweep.maxiter)
    X0 = r.eigenvectors
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X = X0
    for i in TRACE_K:
        X = solve(X, kc[i], sweep.nev, sweep.tol, sweep.maxiter)[0] \
            .eigenvectors
    torch.cuda.synchronize()
    plain_wall = 1e6 * (time.perf_counter() - t0)   # us, no profiler
    X, iters = X0, 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in TRACE_K:
            r, _ = solve(X, kc[i], sweep.nev, sweep.tol, sweep.maxiter)
            X = r.eigenvectors
            iters += r.iterations
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device work")
    busy, window = busy_us(dev)
    chip_smoke.log(tag, f"device solve of k {list(TRACE_K)} ({iters} "
                   f"iterations): {len(dev)} device operations "
                   f"({len(dev) / iters:.1f} per LOBPCG iteration), busy "
                   f"{busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms traced "
                   f"window (idle share {1 - busy / window:.4f}); the same "
                   f"solves untraced take {plain_wall / 1e3:.3f} ms (idle "
                   f"share {1 - busy / plain_wall:.4f} if the busy time is "
                   f"the same)")
    per_name = {}
    for e in dev:
        c, t = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    total = sum(t for _, t in per_name.values())
    share = {}
    for name, (_, t) in per_name.items():
        g = next((g for g, key in GROUPS if key in name), "other")
        share[g] = share.get(g, 0.0) + t
    chip_smoke.log(tag, "device time by group: " + ", ".join(
        f"{g} {100 * t / total:.2f}%"
        for g, t in sorted(share.items(), key=lambda x: -x[1])))
    for name, (c, t) in sorted(per_name.items(), key=lambda x: -x[1][1])[:15]:
        chip_smoke.log(tag, f"{100 * t / total:6.2f}% {t / 1e3:8.3f} ms "
                       f"x{c:<5d} {name[:110]}")


def main_batched(dev):
    """``--batched``: the k-batched solve of each path's chunk."""
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.lattices import kpath

    _, kc, _, sweep = chip_smoke.headline(dev)
    phase_batched_trace("batched headline", kc, sweep)
    del sweep
    _, kc, _, sweep = chip_smoke.dielectric(dev)
    phase_batched_trace("batched config3", kc, sweep)
    del sweep
    lat, _, op = chip_smoke.fcc_problem(dev)
    kc = chip_smoke.nudged(lat, kpath(lat, npts=chip_smoke.BATCH_FIELD_NK,
                                      path=[["G", "X", "W", "L"]]).k_cart)
    sweep = BandSweep(op, op.make_solve_fn(deflation="project",
                                             precond="fastdiag"),
                      nev=chip_smoke.NEV, block=chip_smoke.BLOCK,
                      tol=chip_smoke.TOL, maxiter=chip_smoke.MAXITER,
                      device_tol=chip_smoke.FIELD_DEVICE_TOL)
    phase_batched_trace("batched fcc_field", kc, sweep)
    del op, sweep
    kc, _, sweep = chip_smoke.rods_setup(dev)
    phase_batched_trace("batched config2", kc, sweep)
    return 0


SWITCH_INTERVALS = (5e-3, 1e-3, 2e-4, 5e-5, 1e-5)


def numpy_subset_eigh(eigh):
    """``scipy.linalg.eigh`` with its ``subset_by_index`` calls answered
    by ``numpy.linalg.eigh`` (every pair, then the subset), which releases
    the interpreter lock while it computes; other calls go to ``eigh``."""
    import numpy as np

    def w(a, *args, subset_by_index=None, **kw):
        if subset_by_index is None:
            return eigh(a, *args, **kw)
        lo, hi = subset_by_index
        lam, V = np.linalg.eigh(a)
        return lam[lo:hi + 1], V[:, lo:hi + 1]
    return w


def main_switch(dev):
    """``--switch``: each path's warm passes as the serial composition
    and overlapped at each interpreter switch interval of
    ``SWITCH_INTERVALS`` (5 ms is CPython's default), in two rounds; the
    headline also with its spectral refine's per-block eigh answered by
    numpy (``numpy_subset_eigh``)."""
    import scipy.linalg
    from bravais_tpu_torch.bands import sweep as sweep_mod

    default = sys.getswitchinterval()
    real_pool, real_eigh = sweep_mod.ThreadPoolExecutor, scipy.linalg.eigh
    setups = (("headline", lambda: chip_smoke.headline(dev)[1::2]),
              ("config3", lambda: chip_smoke.dielectric(dev)[1::2]),
              ("config1", lambda: chip_smoke.scalar_setup(dev)[::2]),
              ("config2", lambda: chip_smoke.rods_setup(dev)[::2]))
    for path, setup in setups:
        kc, sweep = setup()
        sweep.run_warm(kc)                   # cold pass
        modes = [("serial", None, False)] + [
            ("overlapped", iv, False) for iv in SWITCH_INTERVALS]
        if path == "headline":
            modes += [("serial", None, True), ("overlapped", 5e-3, True),
                      ("overlapped", 5e-5, True)]
        walls = {}
        for _ in range(2):
            for mode, iv, np_eigh in modes:
                sweep_mod.ThreadPoolExecutor = (chip_smoke.SerialPool
                                                if iv is None else real_pool)
                scipy.linalg.eigh = (numpy_subset_eigh(real_eigh) if np_eigh
                                     else real_eigh)
                sys.setswitchinterval(iv or default)
                try:
                    res = sweep.run_warm(kc)
                finally:
                    sweep_mod.ThreadPoolExecutor = real_pool
                    scipy.linalg.eigh = real_eigh
                    sys.setswitchinterval(default)
                tag = (f"{mode}{'' if iv is None else f' {iv:g} s'}"
                       f"{', numpy eigh' if np_eigh else ''}")
                walls.setdefault(tag, []).append(res.wall_s)
                chip_smoke.log("switch", f"{path} {tag}: "
                               f"{chip_smoke.overlap(res)}, iterations "
                               f"{int(res.iterations.sum())}")
        ser = min(walls["serial"])
        chip_smoke.log("switch", f"{path}: best wall over the serial "
                       f"composition's best: " + ", ".join(
                           f"{tag} {min(w) / ser:.4f}"
                           for tag, w in walls.items()))
        del sweep
    return 0


def phase_gil():
    """Which host calls of the refine hold the interpreter lock: a
    pure-Python loop's time while a second thread runs the call in a
    loop, over the loop's time alone."""
    import numpy as np
    import scipy.linalg

    rng = np.random.default_rng(0)
    Z = rng.standard_normal((192, 192)) + 1j * rng.standard_normal((192, 192))
    H = Z @ Z.conj().T + 192 * np.eye(192)
    L = np.tril(H)

    def loop():
        t = time.perf_counter()
        s = 0
        for i in range(3_000_000):
            s += i
        return time.perf_counter() - t

    calls = {
        "scipy.linalg.eigh 192 subset evr (spectral refine)":
            lambda: scipy.linalg.eigh(H, subset_by_index=[0, 11],
                                      driver="evr"),
        "scipy.linalg.eigh 192": lambda: scipy.linalg.eigh(H),
        "scipy.linalg.cholesky 192": lambda: scipy.linalg.cholesky(
            H, lower=True),
        "scipy.linalg.solve_triangular 192": lambda:
            scipy.linalg.solve_triangular(L, H, lower=True),
        "numpy.linalg.eigh 192": lambda: np.linalg.eigh(H),
        "numpy matmul 192": lambda: H @ H}
    alone = statistics.median(loop() for _ in range(3))
    out = []
    for name, fn in calls.items():
        stop = threading.Event()

        def spin():
            while not stop.is_set():
                fn()
        th = threading.Thread(target=spin)
        th.start()
        try:
            beside = loop()
        finally:
            stop.set()
            th.join()
        out.append(f"{name} {beside / alone:.2f}")
    chip_smoke.log("gil", f"a Python loop's time beside each call over its "
                   f"time alone ({alone:.3f} s): " + ", ".join(out))


OVERLAP_TURNS = "PCCPPC"
OVERLAP_PASSES = 2


def warm_passes(dev, tree):
    """One process of ``--overlap``: a cold warm pass and
    ``OVERLAP_PASSES`` timed ones of each path, with the package
    imported from ``tree``; one JSON line per timed pass."""
    import bravais_tpu_torch
    from bravais_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(json.dumps({"tree": tree, "package": bravais_tpu_torch.__file__,
                      "build_s": time.perf_counter() - t0}), flush=True)
    setups = (("headline", lambda: chip_smoke.headline(dev)[1::2]),
              ("config3", lambda: chip_smoke.dielectric(dev)[1::2]),
              ("config1", lambda: chip_smoke.scalar_setup(dev)[::2]),
              ("config2", lambda: chip_smoke.rods_setup(dev)[::2]))
    for path, setup in setups:
        kc, sweep = setup()
        fetch = []
        if hasattr(sweep, "_fetch"):
            sweep._fetch = timed(sweep._fetch, fetch)
        sweep.run_warm(kc)                   # cold pass
        for _ in range(OVERLAP_PASSES):
            fetch.clear()
            res = sweep.run_warm(kc)
            print(json.dumps({
                "path": path, "wall_s": res.wall_s,
                "refine_s": res.refine_s,
                "solve_s": getattr(res, "solve_s", None),
                "fetch_s": sum(fetch) if hasattr(sweep, "_fetch") else None,
                "iterations": int(res.iterations.sum())}), flush=True)
        del sweep


def main_overlap(parent):
    """``--overlap PARENT``: the lock probe, then the warm passes of the
    parent's tree and this one in turns ``OVERLAP_TURNS``, one process
    each."""
    phase_gil()
    trees = {"P": str(Path(parent).resolve()),
             "C": str(Path(__file__).resolve().parent)}
    walls = {}
    for turn in OVERLAP_TURNS:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, __file__, "--warm-passes",
                            trees[turn]], capture_output=True, text=True,
                           timeout=900, env=dict(os.environ))
        if r.returncode:
            raise RuntimeError(f"warm passes of {trees[turn]} exited "
                               f"{r.returncode}: {r.stderr[-3000:]}")
        for line in r.stdout.splitlines():
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if "path" not in rec:
                chip_smoke.log("overlap", f"{turn}: package "
                               f"{rec['package']}, kernels built in "
                               f"{rec['build_s']:.2f} s")
                continue
            walls.setdefault((rec["path"], turn), []).append(rec["wall_s"])
            extra = ""
            if rec["solve_s"] is not None:
                hidden = ((rec["solve_s"] + rec["refine_s"] - rec["wall_s"])
                          / rec["refine_s"])
                extra = (f", solve_s {rec['solve_s']:.4f}, hidden share "
                         f"{hidden:.4f}, fetch_s {rec['fetch_s']:.4f}")
            chip_smoke.log("overlap", f"{turn} {rec['path']}: wall_s "
                           f"{rec['wall_s']:.4f}, refine_s "
                           f"{rec['refine_s']:.4f}{extra}, iterations "
                           f"{rec['iterations']}")
        chip_smoke.log("overlap", f"{turn}: process "
                       f"{time.perf_counter() - t0:.1f} s")
    for path in ("headline", "config3", "config1", "config2"):
        p, c = (statistics.median(walls[(path, t)]) for t in "PC")
        chip_smoke.log("overlap", f"{path}: median wall parent {p:.4f} s, "
                       f"this tree {c:.4f} s ({c / p:.4f}x; "
                       f"{len(walls[(path, 'P')])} passes each)")
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--batched", action="store_true",
                      help="trace the k-batched solves instead")
    mode.add_argument("--overlap", metavar="PARENT",
                      help="time the warm passes of this tree against "
                      "those of the checkout PARENT instead")
    mode.add_argument("--switch", action="store_true",
                      help="time the overlapped warm passes at several "
                      "interpreter switch intervals instead")
    mode.add_argument("--warm-passes", metavar="TREE",
                      help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.warm_passes:
        # This process's package is TREE's (the parent's or this one).
        sys.path.insert(0, args.warm_passes)
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    import bravais_tpu_torch  # noqa: F401  (precision flags)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    chip_smoke.log("device", smi)
    if args.overlap:
        return main_overlap(args.overlap)
    dev = torch.device("cuda", 0)
    if args.batched:
        return main_batched(dev)
    if args.warm_passes:
        return warm_passes(dev, args.warm_passes)
    if args.switch:
        return main_switch(dev)
    _, kc, op, sweep = chip_smoke.headline(dev)
    sweep.run_warm(kc)   # cold pass: build, caches, allocator
    res = phase_pass("pass", kc, sweep, op.make_spectral_solve_fn)
    phase_setup(kc, op)
    phase_trace("trace", kc, sweep)
    chip_smoke.log("done", f"iters/k {res.iterations.mean():.2f}")
    del op, sweep

    _, kc, op, sweep = chip_smoke.dielectric(dev)
    sweep.run_warm(kc)
    res = phase_pass("diel pass", kc, sweep, op.make_solve_fn)
    phase_field_pieces(kc, op, sweep)
    phase_trace("diel trace", kc, sweep)
    chip_smoke.log("done", f"config 3 iters/k {res.iterations.mean():.2f}")
    del op, sweep

    kc, op, sweep = chip_smoke.scalar_setup(dev)
    sweep.run_warm(kc)
    res = phase_pass("scalar pass", kc, sweep, op.make_solve_fn)
    phase_trace("scalar trace", kc, sweep)
    chip_smoke.log("done", f"config 1 iters/k {res.iterations.mean():.2f}")
    del op, sweep

    kc, op, sweep = chip_smoke.rods_setup(dev)
    sweep.run_warm(kc)
    res = phase_pass("rods pass", kc, sweep, None)
    phase_gmg_pieces(kc, op, sweep)
    phase_trace("rods trace", kc, sweep)
    chip_smoke.log("done", f"config 2 iters/k {res.iterations.mean():.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
