#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bravais_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py        # needs one card; no arguments

Phases, one line each (a failed gate raises and the script exits
non-zero; without a CUDA device it exits 1 before doing anything):

1. device: the ``nvidia-smi`` name and power limit;
2. build: compile ``bravais_tpu_torch/csrc/jacobi_eigh.cu`` for sm_90a;
3. kernel vs plain: the Jacobi kernel against its plain torch version
   on complex64 Hermitian matrices (n = 16, 33, 48, 64; batch 1 and 8;
   the graded 45×45 matrix), then per-call times (CUDA events, median of
   50) of the kernel, the plain version and ``torch.linalg.eigh`` at
   n = 16 and 48;
4. headline sweep: FCC Maxwell, n=8 p=4 (98,304 Nédélec dofs), Γ–X–W–L
   nk=16 with Γ nudged to 2e-2·b₁, 10 bands in a block of 16, spectral
   engine, device stop 1e-3 then the f64 host refine, warm-started; one
   cold pass and 3 timed passes; max eigenvalue error against the
   analytic empty-lattice bands < 1e-6, and every Rayleigh–Ritz and
   whitening eigensolve of a pass launched the kernel.

The last two lines of standard output are a JSON object describing the
kernels and the JSON result line ``{"ok": true, "device": {...}}``.
"""

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The f64 host refine runs LAPACK on a few 192x192 blocks per k. A
# multi-threaded OpenBLAS on such small matrices thrashes on a shared host
# (measured on the H100 machine: 9 s vs 0.4 s per refine of 35 blocks), so
# cap the host BLAS before numpy loads it.
for _var in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

REPO = Path(__file__).resolve().parent

# Headline configuration (the reference's bench.py defaults).
LATTICE, N_ELEM, ORDER, NK, NEV, BLOCK = "FCC", 8, 4, 16, 10, 16
TOL, DEVICE_TOL, MAXITER, PASSES = 1e-6, 1e-3, 250, 3
ERR_BAR = 1e-6


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def rand_herm(n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Q = np.linalg.qr(A)[0]
    H = (Q * (rng.standard_normal(n) * 10)) @ Q.conj().T
    return 0.5 * (H + H.conj().T)


def graded45():
    import numpy as np
    n = 45
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = np.eye(n) + 0.3 * (A + A.conj().T) / np.sqrt(n)
    d = np.sqrt(np.concatenate([np.linspace(1, 1.01, 10),
                                np.geomspace(10.0, 1e6, n - 10)]))
    H = d[:, None] * A * d[None, :]
    return 0.5 * (H + H.conj().T)


def phase_kernels(dev):
    """Kernel vs plain gates and timings; returns the kernel's record."""
    import numpy as np
    import scipy.linalg
    import torch
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.eigen.jacobi_eigh import (jacobi_eigh,
                                                    jacobi_eigh_plain)
    from bravais_tpu_torch.utils.timing import cuda_ms

    max_abs = 0.0
    for n, batch in itertools.product((16, 33, 48, 64), (1, 8)):
        Hs = np.stack([rand_herm(n, 1000 * n + i) for i in range(batch)])
        H = torch.as_tensor(Hs.astype(np.complex64), device=dev)
        w, V = jacobi_eigh(H)
        w_pl, _ = jacobi_eigh_plain(H)
        torch.cuda.synchronize()
        w, V, w_pl = (t.cpu().numpy() for t in (w, V, w_pl))
        sweeps = jacobi_cuda.sweeps_run(H).cpu().numpy()
        ev = res = orth = 0.0
        for i in range(batch):
            scale = np.maximum(np.abs(w_pl[i]), 1e-3 * np.abs(w_pl[i]).max())
            ev = max(ev, float(np.max(np.abs(w[i] - w_pl[i]) / scale)))
            max_abs = max(max_abs, float(np.max(np.abs(w[i] - w_pl[i]))))
            R = Hs[i].astype(np.complex64) @ V[i] - V[i] * w[i][None, :]
            res = max(res, float(np.linalg.norm(R) / np.linalg.norm(Hs[i])))
            orth = max(orth, float(np.linalg.norm(
                V[i].conj().T @ V[i] - np.eye(n))))
        log("kernel", f"n={n} batch={batch}: eig err/scale {ev:.3e} "
            f"(<5e-4), |HV-VL|/|H| {res:.3e} (<2e-5), |V^H V-I| "
            f"{orth:.3e} (<2e-4), sweeps {sweeps.min()}-{sweeps.max()}")
        if not (ev < 5e-4 and res < 2e-5 and orth < 2e-4):
            raise RuntimeError(f"kernel disagrees with plain at n={n} "
                               f"batch={batch}")
    Hg = graded45()
    wref = scipy.linalg.eigh(Hg, eigvals_only=True)
    w, _ = jacobi_eigh(torch.as_tensor(Hg.astype(np.complex64), device=dev),
                       sweeps=12)
    rel = float(np.max(np.abs(w.cpu().numpy()[:10] - wref[:10])
                       / np.abs(wref[:10])))
    log("kernel", f"graded 45x45: low-10 relative error {rel:.3e} (<2e-5)")
    if not rel < 2e-5:
        raise RuntimeError("kernel loses the low eigenvalues of the "
                           "graded matrix")

    times = {}
    for n, rel_tol in ((16, None), (48, 1e-4)):
        H = torch.as_tensor(rand_herm(n, 7 + n).astype(np.complex64),
                            device=dev)
        t_k = cuda_ms(lambda: jacobi_eigh(H, rel_tol=rel_tol))
        t_p = cuda_ms(lambda: jacobi_eigh_plain(H, rel_tol=rel_tol))
        t_e = cuda_ms(lambda: torch.linalg.eigh(H))
        times[n] = (t_k, t_p, t_e)
        log("kernel", f"n={n} rel_tol={rel_tol}: kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, torch.linalg.eigh {t_e:.4f} ms "
            f"(CUDA events, median)")
    return {"name": "jacobi_eigh", "route": "cuda",
            "source": "bravais_tpu_torch/csrc/jacobi_eigh.cu",
            "replaces": "bravais_tpu/eigen/pallas_jacobi.py:155",
            "max_abs_err": max_abs, "ms": times[48][0],
            "plain_ms": times[48][1]}


def headline(dev):
    """The headline problem on ``dev``: (lattice, k-points with Γ nudged,
    operator, BandSweep). Extracts (or loads) the host stencils."""
    import numpy as np
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.lattices import kpath, make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace

    lat = make_lattice(LATTICE)
    kp = kpath(lat, npts=NK, path=[["G", "X", "W", "L"]])
    kc = kp.k_cart.copy()
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]
    sp = NedelecSpace.make(PeriodicGrid.make(lat, N_ELEM), ORDER)
    op = BlochCurlCurl(sp, dtype=torch.complex64, device=dev)
    t0 = time.perf_counter()
    fd = op.fastdiag_G()
    log("sweep", f"{sp.ndofs} dofs, B={fd.nblocks} blocks of D={fd.D}; "
        f"host stencils {time.perf_counter() - t0:.2f} s")
    sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=NEV,
                      block=BLOCK, tol=TOL, maxiter=MAXITER,
                      device_tol=DEVICE_TOL)
    return lat, kc, op, sweep


def phase_sweep(dev):
    """The headline warm sweep; returns the main path's launch count."""
    import numpy as np
    import torch
    from bravais_tpu_torch.eigen import jacobi_cuda

    lat, kc, _, sweep = headline(dev)

    def exact_bands(k, nb, mmax=3, mult=2):
        vals = sorted(float(np.sum((np.asarray(k) + np.asarray(m) @ lat.B)
                                   ** 2))
                      for m in itertools.product(range(-mmax, mmax + 1),
                                                 repeat=lat.dim))
        return np.asarray(sorted(vals * mult)[:nb])

    walls, launches = [], None
    for p in range(PASSES + 1):
        if p == 1:
            torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        jacobi_cuda.launches = 0
        res = sweep.run_warm(kc)
        torch.cuda.synchronize()
        launches = jacobi_cuda.launches
        expected = int(res.iterations.sum()) + len(kc)
        errs = [np.max(np.abs(res.eigenvalues[i] - exact_bands(kc[i], NEV)))
                / max(exact_bands(kc[i], NEV).max(), 1.0)
                for i in range(len(kc))]
        err, resid = float(max(errs)), float(np.max(res.residuals))
        tag = "cold" if p == 0 else f"pass {p}"
        log("sweep", f"{tag}: {res.wall_s:.3f} s (host refine "
            f"{res.refine_s:.3f} s), {len(kc) / res.wall_s:.3f} eig/s, "
            f"iters/k {res.iterations.mean():.2f} "
            f"{res.iterations.tolist()}, max eig err {err:.3e}, max refined "
            f"residual {resid:.3e}, Jacobi launches {launches} "
            f"(expected {expected})")
        if not err < ERR_BAR:
            raise RuntimeError(f"eigenvalue error {err:.3e} >= {ERR_BAR}")
        if not (launches > 0 and launches == expected):
            raise RuntimeError(f"Jacobi kernel launches {launches} != "
                               f"{expected} eigensolves of the sweep")
        if p:
            walls.append(res.wall_s)
    wall = statistics.median(walls)
    log("sweep", f"headline: {len(kc) / wall:.4f} eig/s (median of "
        f"{PASSES}; nk={len(kc)} / pass wall {wall:.3f} s), iters/k "
        f"{res.iterations.mean():.2f}, max eig err {err:.3e}, max refined "
        f"residual {resid:.3e}, refine cross-check failures 0, peak device "
        f"memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    return launches


def main():
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import bravais_tpu_torch  # noqa: F401  (precision flags)
    from bravais_tpu_torch.eigen import jacobi_cuda

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi:")
    print(smi, flush=True)

    t0 = time.perf_counter()
    lib = jacobi_cuda.build()
    log("build", f"{lib.name} in {time.perf_counter() - t0:.2f} s")
    ptxas = lib.with_name(lib.name.replace(".so", ".ptxas.txt"))
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", line.strip())

    record = phase_kernels(dev)
    record["launches"] = phase_sweep(dev)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
