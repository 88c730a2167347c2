#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``bravais_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py        # needs one card; no arguments
    python3 chip_smoke.py --four # the four-card records (4 cards)

Phases, one line each (a failed gate raises and the script exits
non-zero; without a CUDA device it exits 1 before doing anything). Every
sweep refines on the host beside the next device solve; each sweep line
gives its ``wall_s``, the main thread's ``solve_s``, the worker's
``refine_s`` and the refine's hidden share (solve_s + refine_s − wall_s)
/ refine_s. The hidden share rises as the two threads slow each other
down (they share the interpreter lock), so the warm paths ``[sweep]``,
``[diel]``, ``[scalar]``, ``[rods2d]`` and ``[te]`` also run one pass of
the serial composition (each k's refine before the next solve, the
sweep's executor replaced by ``SerialPool``) and print the timed passes'
median wall over its wall (below 1: the overlap gains):

1. device: the ``nvidia-smi`` name and power limit;
2. build: compile the three kernels of ``bravais_tpu_torch/csrc/``
   (``jacobi_eigh.cu``, ``nd_apply.cu``, ``h1_apply.cu``) for sm_90a, one
   ``nvcc`` each, all started together, and print each kernel entry's
   registers, barriers, spills and shared memory;
3. kernel vs plain: the Jacobi kernel against its plain torch version
   on complex64 Hermitian matrices (n = 10, 16, 30, 33, 45, 48, 64; batch
   1 and 8;
   the graded 45×45 matrix; the config-3 L-twin blocks, n = 27 × 216; the
   FCC field path's L-twin blocks, n = 64 × 512);
   the Nédélec (nd) and H1 element kernels against their plain versions
   (config-3 shapes at 16 and 48 rows, h1 also at 32, nd at the FCC
   field path's (l, q) = (5, 6) on 16 rows of 512 elements, the odd FCC
   n=3 p=2 shape, varying coefficients, every half ("AM", "A", "M"), h1 at
   k = 0 and k ≠ 0, h1 also at config 2's shapes: 16 rows of 256
   elements at (l, q) = (4, 5) and the multigrid's p=1 levels, (2, 3) on
   64 and 4 elements, at k ≠ 0, h1 at config 5's (l, q) = (5, 6) on 80
   rows of TRI n=6's 216 elements with a table of its 8 k-points;
   relative error < 2e-5); and at the k-batched paths' shapes: Jacobi on
   16 × 48×48 (Rayleigh–Ritz), 16 and 8 × 16×16 (whitening) and the
   L-twin blocks of config 3's 16 k (16·216 × 27×27) and of the FCC field
   path's 8 k (8·512 × 64×64), nd on 16·16 and 16·32 rows of config 3
   and 8·16 and 8·32 rows at (5, 6), h1 at config 3's k = 0 on 16·16 and
   16·32 rows, at config 2's levels with a table of its 16 k on 16·16
   rows and at its fine level with one k on those rows;
4. headline sweep: FCC Maxwell, n=8 p=4 (98,304 Nédélec dofs), Γ–X–W–L
   nk=16 with Γ nudged to 2e-2·b₁, 10 bands in a block of 16, spectral
   engine, device stop 1e-3 then the f64 host refine, warm-started; one
   cold pass and 3 timed passes; max eigenvalue error against the
   analytic empty-lattice bands < 1e-6, and every Rayleigh–Ritz and
   whitening eigensolve of a pass launched the kernel;
5. config-3 sweep: CUB with an ε = 13 sphere (r = 0.25a), n=6 p=3
   (17,496 Nédélec dofs), Γ–X–M–R nk=16 with Γ nudged, 10 bands in a
   block of 16, field engine (project-cheby deflation, fastdiag
   preconditioner), device stop 1e-4 then the f64 host Rayleigh–Ritz,
   warm-started; one cold pass and 2 timed passes (cut from 3 for time);
   bands 1 and 10 within
   1e-6 relative of the reference's f64 oracle record
   (``results/certify_r5/dielectric_n6p3.jsonl``) at k indices 1, 5, 10
   and 15, band 1 (the nudged-Γ acoustic band) within 2e-7 absolute and
   band 10 within 1e-6 relative at k index 0, every refined residual
   certificate finite and < 1e-2, and the nd, h1 and Jacobi launches of
   a pass equal to the calls the path makes;
6. scalar H1 sweeps, BlochHelmholtz on H1 elements, each one cold pass
   and 2 timed passes, warm-started, with the f64 host refine, the
   launches of each kernel in a pass equal to the calls the path makes:
   ``[scalar]`` config 1: SQR empty lattice, n=16 p=4 (4,096 dofs = 256
   twisted-DFT blocks of D=16), Γ–X–M–Γ nk=16 (Γ not nudged), 10 bands
   in a block of 15, spectral engine, device stop 1e-3 then the exact
   block refine; max eigenvalue error against the analytic bands < 1e-6
   and no refine fallback. ``[rods2d]`` config 2 TM: SQR with ε = 8.9
   rods of r = 0.2a (α = 1, β = ε), n=16 p=3 (2,304 dofs), Γ–X–M–Γ
   nk=16, 10 bands in a block of 16, matrix-free LOBPCG with the fused
   (A, M) h1 kernel and the geometric-multigrid preconditioner (5
   levels, every apply the h1 kernel), device stop 1e-4 then the host
   Rayleigh–Ritz; bands 1–10 at k indices 0, 5, 10, 15 within 1e-6
   relative of the dense complex128 oracle (band 1 at Γ within
   1e-6·λ₁₀), and the TM gap inside the published brackets. ``[te]``:
   HEX2D air holes r = 0.48a in ε = 13, TE (α = 1/ε), n=12 p=3, one k at
   M, 6 bands in a block of 10, GMG chosen by ``precond="auto"``; bands
   1–6 within 1e-6 relative of the dense oracle;
7. config 4: ``[fcc-field]`` the headline's FCC problem (n=8 p=4,
   Γ–X–W–L nk=16, Γ nudged, 10 bands in 16) on the field engine with the
   exact "project" deflation and the fastdiag preconditioner
   (``bench.py --engine field``), device stop 1e-5 (the sweep's default;
   bench.py's 1e-4 misses the bar, as in the reference; see
   ``FIELD_DEVICE_TOL``) then the f64
   host Rayleigh–Ritz, warm-started; one pass, its rate the cold pass's
   (cut from a cold and 3 timed passes for time; its wall is the host
   refine's, 0.99 of it); max eigenvalue error against the analytic bands
   < 1e-6, and the nd and Jacobi launches of a pass (the L-twin eigh
   included) equal to the calls the path makes. ``[cli]`` its BCC half
   through the CLI, as a user starts it: ``python -m bravais_tpu_torch
   --lattice BCC --problem maxwell --engine field --n 8 --p 4 --nk 8
   --nev 10 --out DIR`` (nk cut from 16 for time), then the same with
   ``--resume``, which must find every k finished; both exit 0, and
   ``bands.npz`` holds finite bands at all 8 k within 1e-6 of the
   analytic bands at the nudged k;
8. config 5: ``[config5]`` all 14 Bravais lattices (``LATTICE_NAMES``,
   the reference's variant parameters), empty-lattice scalar Helmholtz at
   n=6 p=4 (13,824 dofs), the 8 generic k of ``KFRAC`` in ONE k-batched
   ``BandSweep.run`` per lattice and engine (``python -m
   bravais_tpu_torch.cli.config5_all14``'s ``build``), nev 6 in a block of
   10, tol 1e-6 (device stop 1e-5, then the f64 refine), maxiter 300: the
   spectral engine (twisted-DFT blocks of D=64, exact block refine) and
   the matrix-free built-in solve (Jacobi, the h1 kernel with a k table);
   per lattice the error against |k+G|², iterations, the measured wall,
   the refine and the launches; gates: spectral worst < 1e-5 (every
   lattice above 1e-6 named), matrix-free worst < 1e-4, launches equal
   to the batch's calls, and on TRI ``run(chunk=1)`` giving the
   iterations per k within ±1 (rounding; the line counts the equal ones)
   and bands within 1e-6;
9. ``[batched]``: ``BandSweep.run`` solving a chunk of k as ONE k-batched
   LOBPCG (a leading k axis, every k in lockstep, a done k frozen) on
   every engine at full width: the FCC headline (spectral, nk=16 in one
   chunk), config 3 (field, project-cheby, nk=16), config 4's FCC field
   path (project, nk=8, cut from 16 for time) and config 2 TM (the
   built-in solve with GMG, nk=16); each the path's own gates (the
   analytic bands and no refine fallback; config 3's certify record;
   config 2's dense oracle and TM gap), every kernel's launches equal to
   the batch's calls (one per batched apply or eigh, not one per k), the
   peak device memory, and on the headline, config 3 and config 2
   ``run(chunk=1)`` (one k a solve) giving the iterations per k within ±1
   (rounding; the line counts the equal ones) and the bands within 1e-6,
   with its wall beside the batched one's; on the headline and config 3
   also ``run(chunk=4)`` (4 chunks of 4 k, each chunk's refine beside the
   next chunk's solve): the one-chunk run's bars, chunk=1's iterations
   within ±1 and each chunk's launches;
10. ``[certify]``: tests/test_maxwell_bands.py::
   test_dielectric_f32_refine_certified's problem on the card (CUB n=4
   p=2, ε = 13 and ε = 30 spheres, the X point, 5 bands in 9, the f32
   field path through the nd, h1 and Jacobi kernels, device stop 1e-4,
   ``run`` of one k): the refined bands within 1e-6 relative of the
   complex128 dense oracle (``dense.assemble_nedelec``, the curl-curl
   kernel removed), the launches equal to the solve's calls, and the
   native C++ assembly (``utils/native.py``, built here with g++) within
   1e-12 of the NumPy one;
11. ``[launched]``: every kernel call of phases 4–10 was logged by its
   shape (``install_launch_log``), with the first call's input; each shape
   is held against the plain version: nd and h1 on every half, on a
   random block of the shape (relative error < 2e-5) and on the path's
   logged block (its error over the operator's scale, < 2e-5); Jacobi on
   the logged input at the default stop (phase 3's bars) and, for a
   Rayleigh–Ritz, at its own stop (eigenvalues within 5e-4);
12. after the sweeps, so that the launch-bound sweeps run in a process
   the profiler has not traced: a ``torch.profiler`` count showing that
   one Jacobi call, one nd call (config 3, 16 rows, fused and M-half;
   the FCC field path's shapes) and one h1 call (16 rows at (3, 3, 4) and
   (3, 2, 3), every half) are each one device operation, then each
   kernel's time at the shapes the paths give it (Jacobi: 48×48 and 45×45
   Rayleigh–Ritz, 16×16 whitening, 216 × 27×27 and 512 × 64×64 L-twin;
   h1 at 16, 32 and 48 rows of config 3, at (3, 3, 4) and (3, 2, 3) on
   16 rows (``[certify-prod]``'s p = 2, config 3's multigrid p = 1
   level), config 2's fused (A, M) at
   k ≠ 0 and its multigrid levels' p=1 "A" on 64 and 4 elements; nd at
   16 and 48 rows of config 3 and 16 rows of the FCC field path; config
   5's h1 "A" and fused on 16 and 80 rows with a table of 8 k and its
   Jacobi Rayleigh–Ritz batch 8 × 30×30; the k-batched shapes of phase
   3): its
   call time between CUDA events (host issue included;
   ``ms`` in the kernels line), its device time from a ``torch.profiler``
   trace (``device_ms``), the plain version's call time, for Jacobi
   ``torch.linalg.eigh``'s call and device times (``library_ms``,
   ``library_device_ms``), and the bound; the shapes first launched by
   ``run(chunk=4)`` and ``[certify]`` are timed on their logged inputs
   too, with their calls on the main paths;
13. ``[shard]`` (between ``[certify]`` and ``[launched]``): the sharded
   paths in child processes of this script (``--shard-rank OUT``, the
   group from a launcher's environment, as ``torchrun`` sets it): first
   ``SHARD_GLOO`` gloo ranks sharing the card (NCCL refuses two ranks on
   one device and gloo moves no CUDA tensor, so the halo planes and the
   reductions go through explicit host copies; each rank prints its
   transport), then ``torch.cuda.device_count()`` NCCL ranks, one card
   each. gloo: the headline through ``run_warm_sharded`` (one segment a
   rank) and ``run``, config 5's TRI and FCC on both engines and config
   3 through ``run`` (what ``--shard`` calls), each with the counts set
   to 0 just before and read just after (each rank's launches equal to
   its share's recorded batches), the path's own gates, and rank 0's run
   of the same problem on one rank (iterations per k within ±1, bands
   within 1e-6); domain decomposition of the FCC n=8 p=4 field applies
   (16 rows, A and the fused pair), the TRI n=8 p=4 H1 apply and a
   Jacobi LOBPCG on it (each slab within 1e-5 of the one-rank apply, the
   eigenvalues within 1e-5 of rank 0's one-rank LOBPCG and within config
   5's matrix-free bar of the analytic bands); each rank holds the
   shapes it launched against the plain versions, which the kernels line
   takes in. NCCL: the headline's ``run`` and the field applies;
14. ``[certify-prod]`` (after ``[certify]``): the production-size
   config-3 certification module (``python -m
   bravais_tpu_torch.cli.certify_dielectric``) cut to CUB n=4 p=2, nk=6,
   k indices 0, 1 and 5: the full f32 warm sweep on the card (the nd, h1
   and Jacobi kernels, launches equal to the sweep's calls and logged by
   shape for ``[launched]``), the cold complex128 oracle of the sampled
   k on the host; its JSON lines and verdict, the oracle converged at
   every k and its band ends within 1e-9 of the dense complex128 solve,
   every f32 band under the module's 1e-6 scale-aware bar but band 10 at
   R (k index 5), which the reference's sweep misses too; then a seed
   sweep of k 0-1 (start blocks of seeds 0-11: each k-1 band under the
   bar against the oracle, its host residuals under 1e-3, the iterations
   logged, the launches equal to the sweeps' calls);
15. ``[scale]``: ``python -m bravais_tpu_torch.cli.scale_demo``'s
   models on the card: part single's footprint on the headline's
   spectral warm solve (FCC p=4, nudged Γ and X) at n = 8 and 12 (each
   solve's peak device memory, the fitted count of (B, D, D) complex64
   arrays within 10% of each, the bands within the analytic bar, the
   Jacobi launches equal to the solves' eigensolves, the largest n the
   fit puts under 90% of the card), and part dd's one-card model (its
   2-iteration FCC field LOBPCG and apply at n = 8, 12, 16, 24 through
   the nd kernel, bytes a dof fitted within 10% of each peak, and the n
   it picks for four ranks); after the kernel times, the nd kernel at
   that n's slab shape (16 rows of n³/4 elements) held against the plain
   version and timed.

16. ``[gmg]`` (after ``[batched]``): the σ-shift Maxwell engine
   (``make_solve_fn(deflation="gmg")``: LOBPCG on A + σ·M P, P by three
   QPGMG cycles, Jacobi) on config 3 at full width (``[diel]``'s
   problem, k-points, device stop and maxiter), through ``run_warm`` on
   the path's first 6 k (cut from 16 for time) and the k-batched ``run``
   on all 16, each with the counts set to 0 just before and
   read just after: ``[diel]``'s gates against the certify record at
   every warm-started k (a cold-started k, where the float32 σ-shift
   solve stalls as the reference's does, passes within them or with its
   f64 residual certificate ≥ 1e-2: never off them and reported
   converged) and the launches equal to the path's calls
   (``expected_field_launches``);
   then the CLI's n < 3 route in a child process (``GMG_CLI_ARGS``, no
   ``--engine``): it logs ``# engine gmg``, exits 0, and its bands lie
   within 1e-5 of the port's complex128 CPU run of the same
   configuration. Its kernel shapes (h1 on every QPGMG level with a
   16-k table and the coarse assembly, nd's "A" and "M" halves) are
   held in ``[launched]`` and timed with the kernels.

17. ``[cg]`` (after ``[gmg]``): the reference's other field-engine solves.
   Config 3 at full width on its σ-shift default for varying ε,
   ``make_solve_fn(deflation="cg", precond="fastdiag-cg",
   cg_iters=adaptive_cg_iters())`` (the per-row CG gradient projector,
   the inner-PCG preconditioner, σ = ``fd_sigma(m)``), through
   ``run_warm`` and the k-batched ``run``; then one k-batched ``run``
   each of config 3 on "project-cg" + "fastdiag-cg" and on "gmg" +
   "fastdiag", and of FCC n=3 p=2 (nk=8, Γ–X–W–L) on ``make_solve_fn()``
   ("cg" with Jacobi) and on "fastdiag" + "fastdiag". Each run with the
   counts set to 0 just before and read just after: launches equal to
   the path's calls (``expected_field_launches``; the CG's data-dependent
   h1 applies counted by ``CGSteps``, its calls held against the
   formula, each within ``cg_iters`` steps); config 3's k at ``[gmg]``'s
   gates (``gmg_check``), FCC's within 1e-5 of the spectral engine's
   bands of the same discretization, a cold k within them or flagged
   by its f64 certificate (``cold_check``). The new shapes are held in
   ``[launched]``.

18. ``[chain]`` (after ``[batched]``, before ``[gmg]``): the reference's
   remaining sweep schedules, each run with the counts set to 0 just
   before and read just after, its shapes logged for ``[launched]``. The
   headline (``[sweep]``'s setup) through ``BandSweep.run_warm_chain``
   in chains of 4 k in each preconditioner mode ("per-k", "chain-mid":
   one at the chain's middle k, "batched": every chain k's in one call,
   "batched-setup": every chain k's blocks, preconditioner and projector
   factor in one call), a cold pass and 3 timed passes each, then one
   "batched-setup" pass with ``pc_rep="inv"``: the analytic bar at every
   k, no refine fallback, Jacobi launches Σ iterations + nk; "per-k"'s
   iterations ``[sweep]``'s, "batched" and "batched-setup"'s within ±1
   of "per-k"'s (the line counts the k that differ); eig/s, solve and
   refine seconds, peak memory per mode, and one chain's setup in ms
   (CUDA events) as each mode builds it. Config 3 (``[diel]``'s problem
   and stops) through ``run_warm`` with bench.py's near-Γ loose stop
   (2e-3 for |k| < 0.15·min|bᵢ|): the k outside the ball within
   ``[diel]``'s bars, the in-ball k taking no more iterations than in
   ``[diel]``'s last pass and within the bars or flagged by an f64
   certificate ≥ 1e-3 (never reported converged off them). Config 3
   through one cold k-batched ``run`` with ``restart_tol=1e-3``:
   ``[batched]``'s bars, the lockstep iterations of each phase and the
   wall beside ``[batched]``'s single-phase run. Each config-3 run's
   launches equal to the path's calls. Then the CLI as a user starts it,
   ``--lattice FCC --problem maxwell --engine spectral --n 8 --p 4 --nk
   16 --nev 10 --mode warm-chain --chain 4 --pc-mode batched-setup``,
   and the same with ``--resume`` (``[cli]``'s gates).

``--four`` runs instead, on every card of a machine with at least four,
what exists only across cards, each job under ``python -m
torch.distributed.run --standalone --nproc-per-node <cards>`` (NCCL, one
card a rank): phase 13's jobs (``--shard-rank``, every path); the CLI's
``--shard`` on the headline problem in both modes (``--mode warm`` and
``batched``) against the same run on one card (bands within the analytic
bar and 1e-6 of one card); ``scale_demo --part dd`` (an FCC field LOBPCG
whose one-card footprint exceeds the card, dof-sharded); then, on card
0, the nd kernel at the dd slab's shape held against the plain version
and timed. Its last line is the same JSON result with the card count.

The last two lines of standard output are a JSON object describing the
kernels (with ``main_path_shapes``: every logged shape and its calls)
and the JSON result line ``{"ok": true, "device": {...}}``.
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
# Config 3 (the reference's ``bench.py --problem dielectric`` defaults,
# with its near-Γ loose stop off).
DIEL_N, DIEL_P, DIEL_EPS, DIEL_RADIUS = 6, 3, 13.0, 0.25
DIEL_DEVICE_TOL, DIEL_PASSES = 1e-4, 2
DIEL_ORACLE = REPO / "results" / "certify_r5" / "dielectric_n6p3.jsonl"
DIEL_REL_BAR, DIEL_GAMMA_ABS, DIEL_RES_BAR = 1e-6, 2e-7, 1e-2
# Config 1 (``bench.py --problem scalar`` defaults) and config 2 TM
# (``--problem rods2d``), and the TE air-hole crystal of
# tests/test_photonic2d.py::test_auto_precond_gmg_fixes_te_contrast_stall.
SCALAR_N, SCALAR_P, SCALAR_DEVICE_TOL = 16, 4, 1e-3
RODS_N, RODS_P, RODS_EPS, RODS_RADIUS, RODS_BLOCK = 16, 3, 8.9, 0.2, 16
H1_DEVICE_TOL, H1_MAXITER, H1_PASSES = 1e-4, 400, 2
RODS_ORACLE_K, RODS_REL_BAR = (0, 5, 10, 15), 1e-6
# The published TM gap of the rods (Joannopoulos ch. 5 / MPB), in ωa/2πc:
# bottom, top, gap/midgap, each (value, bracket).
TM_GAP = ((0.323, 0.015), (0.443, 0.020), (0.31, 0.04))
TE_N, TE_P, TE_EPS, TE_RADIUS, TE_NEV, TE_BLOCK = 12, 3, 13.0, 0.48, 6, 10
ELEM_BAR = 2e-5
# Config 4 on the field engine (``bench.py --engine field``: the headline
# problem, "project" deflation), one timed pass; its BCC half through the
# CLI at nk = 8. The device stop is the sweep's own default (1e-5, as the
# CLI runs it), not bench.py's field default 1e-4: the field refine is a
# Rayleigh–Ritz over the device vectors, and at 1e-4 it leaves 1.120e-06
# at k index 1 (band 10, in the 8-fold cluster at λ = 106.37), above the
# 1e-6 bar (NVIDIA H100, 700 W). The reference leaves the same error at
# that stop: from the same start block at FCC n=4 p=4 its refined bands
# sit 5.227e-07 off a 1e-5 sweep at k index 1, the port's 5.260e-07
# (tests/test_torch_maxwell_field.py::
# test_bench_field_stop_error_matches_reference).
FIELD_DEVICE_TOL, FIELD_PASSES = 1e-5, 0
CLI_ARGS = ("--lattice", "BCC", "--problem", "maxwell", "--engine", "field",
            "--n", "8", "--p", "4", "--nk", "8", "--nev", "10")
# Config 5 (``benchmarks/config5_all14.py``): all 14 lattices, n=6 p=4, the
# 8 KFRAC k in one batched run, nev 6 in a block of 10; the gates are the
# reference script's (spectral) and its recorded matrix-free worst 5.5e-5
# (docs/CONFIG5.md) rounded up.
C5_N, C5_P, C5_NEV, C5_TOL, C5_MAXITER = 6, 4, 6, 1e-6, 300
C5_SPECTRAL_BAR, C5_FIELD_BAR = 1e-5, 1e-4
# The k-batched runs (``[batched]``): each path's k in one ``BandSweep.run``
# chunk (the headline, config 3 and config 2 at their nk = 16; config 4's
# FCC field path at nk = 8, cut from 16 for time: its refine is ≈3 s a k).
BATCH_FIELD_NK = 8
# The chunked runs of ``[batched]``: the headline and config 3 in chunks of
# 4 k, each chunk's refine beside the next chunk's solve.
BATCH_CHUNK = 4
# ``[certify]``: tests/test_maxwell_bands.py::test_dielectric_f32_refine_
# certified's problem (CUB n=4 p=2, ε = 13 and 30 spheres, X, 5 bands in
# 9) against the dense complex128 oracle; the native assembly's bar.
CERT_N, CERT_P, CERT_EPS, CERT_NEV, CERT_BLOCK = 4, 2, (13.0, 30.0), 5, 9
CERT_BAR, NATIVE_BAR = 1e-6, 1e-12
# ``[certify-prod]``: the production-size certification module
# (``python -m bravais_tpu_torch.cli.certify_dielectric``) cut to CUB n=4
# p=2, nk=6, k indices 0, 1 and 5 (the f32 sweep on the card, the
# complex128 oracle on the host); its oracle's bar against the dense
# complex128 solve.
CERT_PROD_ARGS = ("--n", "4", "--p", "2", "--nk", "6", "--k-indices",
                  "0,1,5")
CERT_PROD_DENSE_BAR = 1e-9
# Its f32 gates: the (k index, band index) pairs the f32 warm sweep is let
# miss the module's scale-aware bar, and the seed sweep of k 0-1 (the
# start block's seeds, the host residual bar: 10x the device stop). At R
# (k index 5) the warm sweep of both packages misses one copy of the
# degenerate band 10 (24.222 twice in the oracle; the sweep returns the
# next band, 0.1 above): tests/test_torch_certify_script.py holds the
# port's verdict there to the reference's.
CERT_PROD_SHARED_MISS = {(5, 9)}
CERT_PROD_SEEDS = tuple(range(12))
CERT_PROD_RESID_BAR = 1e-3
# ``[scale]``: ``scale_demo --part single``'s peaks at these n.
SCALE_NS = (8, 12)
# ``[gmg]``: the CLI's n < 3 Maxwell route (``auto`` picks the gmg
# engine), against the port's own complex128 CPU run of the same
# configuration; the bar is the f32 LOBPCG's tol 1e-6, no more. FCC's
# default path has 12 symmetry points, more than nk = 8 holds, so the run
# takes the headline's Γ–X–W–L.
GMG_CLI_ARGS = ("--lattice", "FCC", "--problem", "maxwell", "--n", "2",
                "--p", "2", "--path", "G,X,W,L", "--nk", "8", "--nev", "4")
GMG_CLI_BAR = 1e-5
# ``[gmg]``'s ``run_warm`` runs the first 6 k of config 3's path (the
# certify record's k 0, 1 and 5; cut from 16 for time: ~100 iterations a
# k, ~115-150 s a pass on the H100).
GMG_WARM_NK = 6
# ``[cg]``: the element-invariant runs of the CG projector and the direct
# fast-diagonal projector, FCC n=3 p=2 on Γ–X–W–L at nk=8, held against
# the spectral engine's bands of the same discretization at GMG_CLI_BAR.
# Only "cg" + Jacobi at the nudged Γ (index 0) may instead pass flagged, by
# an f64 certificate 10x the runs' device stop or more: there the float32
# σ-shift "cg" solve with Jacobi (σ = sigma_shift) can stop at its float32
# floor, and the reference's does alike (nev 4 in 8 from the seeded block:
# both stop at 64 iterations, certificates 1.29e-3 and 1.19e-3, ROADMAP
# Reference caveats).
CG_FCC_N, CG_FCC_P, CG_FCC_NK = 3, 2, 8
CG_FCC_FLAG = 10 * FIELD_DEVICE_TOL
# ``[chain]``: ``run_warm_chain`` on the headline in chains of 4 k, in
# every preconditioner mode; config 3's near-Γ loose stop at bench.py's
# values (2e-3 inside |k| < 0.15·min|bᵢ|; an in-ball k off its bar must
# show an f64 certificate of 1e-3 or more) and its two-phase batched
# solve (phase 1 to 1e-3); the headline's problem through the CLI's
# ``--mode warm-chain``.
CHAIN = 4
CHAIN_MODES = ("per-k", "chain-mid", "batched", "batched-setup")
NEAR_GAMMA_TOL, NEAR_GAMMA_FRAC, NEAR_GAMMA_FLAG = 2e-3, 0.15, 1e-3
RESTART_TOL = 1e-3
CHAIN_CLI_ARGS = ("--lattice", "FCC", "--problem", "maxwell", "--engine",
                  "spectral", "--n", "8", "--p", "4", "--nk", "16", "--nev",
                  "10", "--mode", "warm-chain", "--chain", "4", "--pc-mode",
                  "batched-setup")
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and float32 flop/s
# outside the tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def overlap(res):
    """A sweep's time split: its wall, the main thread's device solves
    (``solve_s``), the worker thread's host refine (``refine_s``) and the
    share of the refine hidden behind the solves, (solve_s + refine_s −
    wall_s) / refine_s."""
    hidden = ((res.solve_s + res.refine_s - res.wall_s) / res.refine_s
              if res.refine_s > 0 else float("nan"))
    return (f"wall_s {res.wall_s:.4f}, solve_s {res.solve_s:.4f}, refine_s "
            f"{res.refine_s:.4f}, hidden share {hidden:.4f}")


class SerialPool:
    """A stand-in for the sweep's one-thread executor that runs each job
    when it is submitted, on the caller's thread: the serial composition
    (each k's refine before the next solve), for measurements only."""

    def __init__(self, max_workers=1):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        from concurrent.futures import Future
        fut = Future()
        fut.set_result(fn(*args))
        return fut


def serial_pass(sweep, kc):
    """One warm pass of the serial composition: ``run_warm`` with
    ``SerialPool`` in place of its executor."""
    from bravais_tpu_torch.bands import sweep as sweep_mod
    real = sweep_mod.ThreadPoolExecutor
    sweep_mod.ThreadPoolExecutor = SerialPool
    try:
        return sweep.run_warm(kc)
    finally:
        sweep_mod.ThreadPoolExecutor = real


def log_serial(tag, sweep, kc, wall):
    """One pass of the serial composition after a path's timed passes,
    and the timed passes' median ``wall`` over its wall (below 1: the
    overlap gains)."""
    ser = serial_pass(sweep, kc)
    log(tag, f"serial composition, one pass: {overlap(ser)}; the "
        f"overlapped median wall over it {wall / ser.wall_s:.4f}")


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


def bound(nbytes, flops):
    """(least time in ms, what bounds it): the bytes over the card's
    memory rate or the float32 operations over its peak, the larger."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_F32
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def jacobi_work(n, sweeps):
    """(bytes, flops) of Jacobi eigensolves of n×n complex64, one per
    entry of ``sweeps``, each entry the sweeps that matrix ran: H read, V
    and w written; per sweep one
    rotation for each of the n(n−1)/2 pairs, each updating two rows of H
    and two columns of H and V (60n flops), plus the Rutishauser test (5n²
    per test). n is the problem's size, not the kernel's padded one."""
    nbytes = len(sweeps) * (2 * n * n * 8 + n * 4)
    flops = sum(s * (n * (n - 1) // 2) * 60 * n + (s + 1) * 5 * n * n
                for s in map(int, sweeps))
    return nbytes, flops


def device_events(fn, reps=1):
    """The device operations (kernels, copies, fills) that ``reps`` calls
    of ``fn`` issue, from a ``torch.profiler`` trace after one untraced
    call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # Now and then a process's trace holds no device operation at all,
    # though every call issues some: such a trace is taken again.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            break
    return dev


def device_ms(fn, reps=20):
    """Device time of one call of ``fn`` in ms: the durations of the
    device operations that ``reps`` calls issue, summed and divided by
    ``reps``. Unlike CUDA events around one call, it leaves out the
    host's time to issue the call, which is most of a small kernel's
    call."""
    dev = device_events(fn, reps)
    if not dev:
        raise RuntimeError("the profiler recorded no device work")
    return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3


def h1_3d_low_order(dev, op3):
    """{label: h1 constants} of the 3D shapes below p = 3: (d, l, q) =
    (3, 3, 4), ``[certify-prod]``'s L-twin (config 3's problem at
    ``CERT_PROD_ARGS``' n and p), and (3, 2, 3), config 3's multigrid
    p = 1 level (``op3.qp_gmg()``, n = 6)."""
    import torch
    from bravais_tpu_torch.cli import certify_dielectric as cd
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl

    args = cd.parser().parse_args(list(CERT_PROD_ARGS))
    _, sp, eps = cd.problem(args.n, args.p, args.eps_in, args.radius)
    op = BlochCurlCurl(sp, eps=eps, dtype=torch.complex64, device=dev)
    return {"(3, 3, 4) certify-prod": op.qp_L().consts(),
            "(3, 2, 3) gmg p=1": op3.qp_gmg().levels[1].op.consts()}


def kernel_times(dev, op3, rods=None, plain=True, op4=None, op5=None,
                 kernels=("jacobi", "h1", "nd"), batched=False, logged=()):
    """Per-call times of the three kernels at the shapes the main paths
    give them: {kernel: {shape: record}}. Each record holds the time of
    one call between two CUDA events, the host's issue in it (``ms``), the
    device time of its kernel from a profiler trace (``device_ms``), the
    plain version's call (``plain_ms``, CUDA events; None without
    ``plain``), for Jacobi ``torch.linalg.eigh``'s call and device times
    on the same input (``library_ms``, ``library_device_ms``), and the
    bound. Shapes: Jacobi
    48×48 Rayleigh–Ritz at ``rel_tol`` 1e-4, 16×16 whitening, the 216 ×
    27×27 L-twin batch (both at the default stop); h1 config-3 k = 0
    "A" on 16, 32 and 48 rows, and on 16 rows at (d, l, q) = (3, 3, 4)
    (``[certify-prod]``'s CUB n=4 p=2) and (3, 2, 3) (config 3's
    multigrid p=1 level); nd config-3 fused and M-half on 16 and 48
    rows; with ``rods`` (the config-2 setup) also Jacobi 45×45 (config
    1's Rayleigh–Ritz), h1 config-2 fused (A, M) at k ≠ 0 on 16 rows of
    256 elements and its multigrid's p=1 "A" on 16 rows of 64 and of 4
    elements; with ``op4`` (the FCC field path's operator, n=8 p=4) also
    Jacobi on its 512 × 64×64 L-twin batch and nd fused and M-half on 16
    rows of its 512 elements, (l, q) = (5, 6); with ``op5`` (a config-5
    operator, n=6 p=4) also h1 "A" and fused (A, M) at (5, 6) on 16 and 80
    rows of its 216 elements with a table of its 8 k-points (2 and 10 rows
    a k: the whitening-sized block and the batched W block), and Jacobi
    on the (8, 30, 30) batch of its Rayleigh–Ritz; with ``batched`` (and
    ``rods`` and ``op4``) also the k-batched paths' shapes: Jacobi on the
    (16, 48, 48) Rayleigh–Ritz, the (16, 16, 16) whitening, config 3's
    L-twin blocks of 16 k (16·216 × 27×27) and the FCC field path's of 8
    k (8·512 × 64×64; there ``torch.linalg.eigh`` is warmed once and
    timed between events only, its trace of ≈650,000 operations too long
    to read; above 1,000 matrices one call of each plain version), nd
    fused and M-half on 16·16 and 16·32 rows of config 3 and 8·16 and
    8·32 rows of the FCC field path, h1 "A" at config 3's k = 0 on 16·16
    and 16·32 rows, on config 2's levels with a table of its 16 k on
    16·16 rows and its fine level's mass at one k on those rows; with
    ``logged`` (launch-log entries ((kernel, shape), record)) also each
    of those shapes on its logged inputs, under "path: shape", with its
    calls in the logged runs (``launches``). ``op3`` is the config-3
    operator; ``kernels`` names the kernels to time."""
    import numpy as np
    import torch
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.eigen.jacobi_eigh import (jacobi_eigh,
                                                    jacobi_eigh_plain)
    from bravais_tpu_torch.operators import h1_apply, nd_apply
    from bravais_tpu_torch.utils.timing import cuda_ms

    def record(call, plain_call, work, library=None, library_reps=20,
               plain_reps=5, library_warmup=3, library_trace=True, **extra):
        b_ms, b_by = bound(*work)
        rec = {"device_ms": device_ms(call), "ms": cuda_ms(call),
               "plain_ms": (cuda_ms(plain_call, reps=plain_reps, warmup=1)
                            if plain else None),
               "library_device_ms": (device_ms(library, library_reps)
                                     if library and library_trace else None),
               "library_ms": (cuda_ms(library, reps=library_reps,
                                      warmup=library_warmup)
                              if library else None),
               "bound_ms": b_ms, "bound_by": b_by}
        rec.update(extra)
        return rec

    out = {"jacobi": {}, "h1": {}, "nd": {}}
    gen = torch.Generator(device=dev).manual_seed(11)
    c = op3.qp_L().consts()
    k0 = [0.0] * c.d
    h1_rows = (16, 32, 48) + ((16 * 16, 16 * 32) if batched else ())
    for rows in h1_rows if "h1" in kernels else ():
        ue = torch.randn((rows * c.nelem,) + (c.l,) * c.d, generator=gen,
                         dtype=torch.complex64, device=dev)
        out["h1"][f"rows {rows} k=0 A"] = record(
            lambda: h1_apply.helmholtz_apply(ue, c, k0, "A"),
            lambda: h1_apply.helmholtz_apply_plain(ue, c, k0, "A"),
            h1_apply.work(ue.shape[0], c, k0, "A"))
    if "h1" in kernels:
        # The 3D field engine's p = 2 shape (``[certify-prod]``'s CUB
        # n = 4) and the 3D multigrid's p = 1 level (``[gmg]``'s config 3
        # at n = 6), as their projectors call them: k = 0, the Bloch phases
        # in the gather.
        for key, c in h1_3d_low_order(dev, op3).items():
            ue = torch.randn((16 * c.nelem,) + (c.l,) * c.d, generator=gen,
                             dtype=torch.complex64, device=dev)
            out["h1"][f"{key} rows 16 k=0 A"] = record(
                lambda: h1_apply.helmholtz_apply(ue, c, k0, "A"),
                lambda: h1_apply.helmholtz_apply_plain(ue, c, k0, "A"),
                h1_apply.work(ue.shape[0], c, k0, "A"))
    if rods is not None and "h1" in kernels:
        levels = rods[2].gmg.levels
        k2 = [float(v) for v in
              levels[0].op.space.grid.lattice.k_cart((0.3, 0.1))]
        for key, lv, want in (("config-2 rows 16 k!=0 AM", levels[0], "AM"),
                              ("config-2 8x8 p=1 rows 16 k!=0 A", levels[2],
                               "A"),
                              ("config-2 2x2 p=1 rows 16 k!=0 A",
                               levels[-1], "A")):
            c = lv.op.consts()
            ue = torch.randn((16 * c.nelem,) + (c.l,) * c.d, generator=gen,
                             dtype=torch.complex64, device=dev)
            out["h1"][key] = record(
                lambda: h1_apply.helmholtz_apply(ue, c, k2, want),
                lambda: h1_apply.helmholtz_apply_plain(ue, c, k2, want),
                h1_apply.work(ue.shape[0], c, k2, want))
    if op5 is not None and "h1" in kernels:
        from bravais_tpu_torch.cli.config5_all14 import KFRAC
        c = op5.consts()
        lat5 = op5.space.grid.lattice
        kt = np.asarray([lat5.k_cart(f) for f in KFRAC], np.float32)
        for rows in (16, 80):
            ue = torch.randn((rows * c.nelem,) + (c.l,) * c.d, generator=gen,
                             dtype=torch.complex64, device=dev)
            for want in ("A", "AM"):
                out["h1"][f"config-5 rows {rows} k-table 8 {want}"] = record(
                    lambda: h1_apply.helmholtz_apply(ue, c, kt, want),
                    lambda: h1_apply.helmholtz_apply_plain(ue, c, kt, want),
                    h1_apply.work(ue.shape[0], c, kt, want))
    if batched and "h1" in kernels:
        kt = np.asarray(rods[0], np.float32)
        levels = rods[2].gmg.levels
        for key, lv, want, k in (
                ("fine", levels[0], "AM", kt),
                ("8x8 p=1", levels[2], "A", kt),
                ("2x2 p=1", levels[-1], "A", kt),
                ("fine", levels[0], "M", [0.0, 0.0])):
            c = lv.op.consts()
            ue = torch.randn((16 * len(kt) * c.nelem,) + (c.l,) * c.d,
                             generator=gen, dtype=torch.complex64, device=dev)
            table = (f"k-table {len(kt)}" if np.ndim(k) == 2 else "one k")
            out["h1"][f"config-2 batched {key} rows {16 * len(kt)} {table} "
                      f"{want}"] = record(
                lambda: h1_apply.helmholtz_apply(ue, c, k, want),
                lambda: h1_apply.helmholtz_apply_plain(ue, c, k, want),
                h1_apply.work(ue.shape[0], c, k, want))
    nd_shapes = [("", op3, 16), ("", op3, 48)]
    if op4 is not None:
        nd_shapes.append(("fcc ", op4, 16))
    if batched:
        nd_shapes += [("batched ", op3, 16 * 16), ("batched ", op3, 16 * 32),
                      ("fcc batched ", op4, 8 * 16),
                      ("fcc batched ", op4, 8 * 32)]
    for tag, op, rows in nd_shapes if "nd" in kernels else ():
        c = op.nd_consts()
        ue = torch.randn((rows * c.nelem, c.ndof), generator=gen,
                         dtype=torch.complex64, device=dev)
        for want in ("AM", "M"):
            out["nd"][f"{tag}rows {rows} {want}"] = record(
                lambda: nd_apply.nedelec_apply(ue, c, want),
                lambda: nd_apply.nedelec_apply_plain(ue, c, want),
                nd_apply.work(ue.shape[0], c, want))
    jac_shapes = [("rr 48x48", rand_herm(48, 55), 1e-4),
                  ("whitening 16x16", rand_herm(16, 23), None),
                  ("l-twin 216x27x27", ltwin_blocks(op3), None)]
    if rods is not None:
        jac_shapes.append(("rr 45x45", rand_herm(45, 56), 1e-4))
    if op5 is not None:
        jac_shapes.append(("rr 8x30x30", np.stack(
            [rand_herm(30, 60 + i) for i in range(8)]), 1e-4))
    if batched:
        jac_shapes += [("batched rr 16x48x48", np.stack(
            [rand_herm(48, 300 + i) for i in range(16)]), 1e-4),
            ("batched whitening 16x16x16", np.stack(
                [rand_herm(16, 400 + i) for i in range(16)]), None),
            ("batched l-twin 16x216x27x27", ltwin_blocks(op3, 16), None),
            ("batched l-twin 8x512x64x64", ltwin_blocks(op4, 8), None)]
    # Traced after every other shape, the logged ones too: its eigh trace
    # (≈80,000 device operations) can leave the process's next traces
    # empty (below).
    last = ([("l-twin 512x64x64", ltwin_blocks(op4), None)]
            if op4 is not None else [])

    def jac_record(H, rel_tol, sweeps=24, **extra):
        huge = H.numel() // H.shape[-1] ** 2 > 1000
        nsw = jacobi_cuda.sweeps_run(H, sweeps, rel_tol).reshape(-1)
        nsw = nsw.cpu().numpy()
        # Above n = 32 ``torch.linalg.eigh`` solves a batch one matrix at
        # a time: at 512 × 64×64 one call is ≈80,000 device operations,
        # whose trace takes ≈20 s to read and leaves the next traces of
        # the process empty. So it is traced for one call, after every
        # other trace here.
        big = H.shape[-1] > 32 and H.numel() // H.shape[-1] ** 2 > 1
        # 8·512 × 64×64: one eigh call is ≈650,000 device operations (≈3
        # s), so it is warmed once and not traced.
        vast = big and huge
        return record(
            lambda: jacobi_eigh(H, sweeps, rel_tol),
            lambda: jacobi_eigh_plain(H, sweeps, rel_tol),
            jacobi_work(H.shape[-1], nsw),
            library=lambda: torch.linalg.eigh(H),
            library_reps=1 if big else 20, plain_reps=1 if huge else 5,
            library_warmup=1 if vast else 3, library_trace=not vast,
            sweeps=[int(nsw.min()), int(nsw.max())], **extra)

    for key, H, rel_tol in jac_shapes if "jacobi" in kernels else ():
        H = torch.as_tensor(H, dtype=torch.complex64, device=dev)
        out["jacobi"][key] = jac_record(H, rel_tol)
    for (kernel, shape), rec in logged:
        if kernel not in kernels:
            continue
        key = f"{rec['path']}: {shape_label(kernel, shape)}"
        if kernel == "jacobi":
            H, sweeps, rel_tol = rec["args"]
            out["jacobi"][key] = jac_record(H, rel_tol, sweeps,
                                            launches=rec["calls"])
        elif kernel == "nd":
            ue, c, want = rec["args"]
            out["nd"][key] = record(
                lambda: nd_apply.nedelec_apply(ue, c, want),
                lambda: nd_apply.nedelec_apply_plain(ue, c, want),
                nd_apply.work(ue.shape[0], c, want), launches=rec["calls"])
        else:
            ue, c, kt, want = rec["args"]
            out["h1"][key] = record(
                lambda: h1_apply.helmholtz_apply(ue, c, kt, want),
                lambda: h1_apply.helmholtz_apply_plain(ue, c, kt, want),
                h1_apply.work(ue.shape[0], c, kt, want),
                launches=rec["calls"])
    for key, H, rel_tol in last if "jacobi" in kernels else ():
        H = torch.as_tensor(H, dtype=torch.complex64, device=dev)
        out["jacobi"][key] = jac_record(H, rel_tol)
    return out


def log_times(times):
    """One line per kernel and shape of ``kernel_times``' records."""
    for kernel, shapes in times.items():
        for shape, r in shapes.items():
            lib = (f", torch.linalg.eigh {r['library_ms']:.4f} ms per call "
                   + (f"({r['library_device_ms']:.4f} ms device)"
                      if r["library_device_ms"] is not None
                      else "(device time not traced)")
                   if r["library_ms"] is not None else "")
            pl = (f", plain {r['plain_ms']:.4f} ms per call"
                  if r["plain_ms"] is not None else "")
            sw = (f", sweeps {r['sweeps']}" if "sweeps" in r else "") + (
                f", {r['launches']} calls on the main paths"
                if "launches" in r else "")
            log("time", f"{kernel} {shape}: kernel {r['ms']:.4f} ms per call "
                f"({r['device_ms']:.4f} ms device){pl}{lib}; bound "
                f"{r['bound_ms']:.6f} ms ({r['bound_by']}){sw}")


def phase_kernels(dev):
    """The Jacobi kernel's gates against its plain version and SciPy;
    returns (the max abs eigenvalue error, the max error over max(|λ|,
    1e-3 max|λ|), the gate's relative measure)."""
    import numpy as np
    import scipy.linalg
    import torch
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.eigen.jacobi_eigh import (jacobi_eigh,
                                                    jacobi_eigh_plain)

    max_abs = max_rel = 0.0
    for n, batch in itertools.product((10, 16, 30, 33, 45, 48, 64), (1, 8)):
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
        max_rel = max(max_rel, ev)
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

    return max_abs, max_rel


def phase_one_operation(dev, op3, op4):
    """A ``jacobi_eigh``, a ``nedelec_apply`` and a ``helmholtz_apply``
    call on the card are each one device operation, the kernel (no pad,
    sort, gather or copy around it): Jacobi at odd and even n (27 × 216,
    48, 64 × 512), nd on 16 rows of config 3 and of the FCC field path,
    fused and M-half, h1 on 16 rows at (d, l, q) = (3, 3, 4) and
    (3, 2, 3) (``[certify-prod]``'s p = 2, config 3's multigrid p = 1
    level), every half at k ≠ 0. ``op3`` is the config-3 operator, ``op4``
    the FCC field path's."""
    import numpy as np
    import torch
    from bravais_tpu_torch.eigen.jacobi_eigh import jacobi_eigh
    from bravais_tpu_torch.operators import h1_apply, nd_apply

    for n, batch in ((27, 216), (48, 1), (64, 512)):
        H = torch.as_tensor(np.stack([rand_herm(n, i) for i in range(batch)])
                            .astype(np.complex64), device=dev)
        ops = [e.name for e in
               device_events(lambda: jacobi_eigh(H, rel_tol=1e-4))]
        log("kernel", f"Jacobi {batch} x {n}x{n}: one call issues "
            f"{len(ops)} device operation(s) {ops} (must be 1, the kernel)")
        if len(ops) != 1 or "jacobi_eigh_kernel" not in ops[0]:
            raise RuntimeError(f"jacobi_eigh_cuda issued {ops}")
    gen = torch.Generator(device=dev).manual_seed(12)
    for op in (op3, op4):
        c = op.nd_consts()
        ue = torch.randn((16 * c.nelem, c.ndof), generator=gen,
                         dtype=torch.complex64, device=dev)
        for want in ("AM", "M"):
            ops = [e.name for e in device_events(
                lambda: nd_apply.nedelec_apply(ue, c, want))]
            log("kernel", f"nd (l, q) = ({c.l}, {c.q}) 16 rows {want}: one "
                f"call issues {len(ops)} device operation(s) {ops} (must be "
                f"1, the kernel)")
            if len(ops) != 1 or "nd_apply_kernel" not in ops[0]:
                raise RuntimeError(f"nedelec_apply issued {ops}")
    k = [float(v) for v in op3.space.grid.lattice.k_cart((0.3, 0.1, 0.0))]
    for c in h1_3d_low_order(dev, op3).values():
        ue = torch.randn((16 * c.nelem,) + (c.l,) * c.d, generator=gen,
                         dtype=torch.complex64, device=dev)
        for want in ("AM", "A", "M"):
            ops = [e.name for e in device_events(
                lambda: h1_apply.helmholtz_apply(ue, c, k, want))]
            log("kernel", f"h1 (d, l, q) = ({c.d}, {c.l}, {c.q}) 16 rows "
                f"{want}: one call issues {len(ops)} device operation(s) "
                f"{ops} (must be 1, the kernel)")
            if len(ops) != 1 or "h1_apply_kernel" not in ops[0]:
                raise RuntimeError(f"helmholtz_apply issued {ops}")


def _entry_name(mangled):
    """``name<args>`` of a mangled kernel entry (its identifier ending in
    ``_kernel`` and its integer template arguments), else the mangled
    name."""
    import re
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        start = i + m.end()
        ident = mangled[start:start + int(m.group())]
        i = start + len(ident)
        if ident.endswith("_kernel"):
            t = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[i:])
            args = re.findall(r"L[ib](-?\d+)E", t.group(1)) if t else []
            return ident + (f"<{', '.join(args)}>" if args else "")
    return mangled


def ptxas_report(libs):
    """Registers, spills, stack and static shared memory of every kernel
    entry of the built libraries ({name: library path}), from the
    ``-Xptxas -v`` output the build keeps beside each library; logs one
    line per entry and returns {name: [record, ...]}."""
    import re
    out = {}
    for name, lib in libs.items():
        path = lib.with_name(lib.name.replace(".so", ".ptxas.txt"))
        recs, cur = [], None
        text = path.read_text() if path.exists() else ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = {"entry": _entry_name(m.group(1))}
                recs.append(cur)
                continue
            if cur is None:
                continue
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("barriers", r"used (\d+) barriers"),
                             ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    cur[key] = int(m.group(1))
        for r in recs:
            log("build", f"{name} {r['entry']}: {r.get('registers')} "
                f"registers, {r.get('barriers', 0)} barriers, spill "
                f"stores/loads {r.get('spill_stores')}/"
                f"{r.get('spill_loads')} B, stack {r.get('stack')} B, static "
                f"smem {r.get('smem', 0)} B")
        out[name] = recs
    return out


def phase_jacobi_blocks(dev, label, T):
    """The Jacobi kernel on a batch of blocks T (..., n, n) a path hands
    it, against its plain version: the L-twin blocks of a field-engine
    operator (config 3: 216 of 27×27; the FCC field path: 512 of 64×64,
    and 8·512 for a batch of 8 k), the batched Rayleigh–Ritz (16 ×
    48×48); returns (the max abs eigenvalue error, the max error over
    max(|λ|, 1e-3 max|λ|))."""
    import numpy as np
    import torch
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.eigen.jacobi_eigh import (jacobi_eigh,
                                                    jacobi_eigh_plain)

    n = T.shape[-1]
    T = torch.as_tensor(T, dtype=torch.complex64, device=dev)
    T = T.reshape(-1, n, n)
    w, V = jacobi_eigh(T)
    w_pl, _ = jacobi_eigh_plain(T)
    torch.cuda.synchronize()
    Tn, w, V, w_pl = (t.cpu().numpy() for t in (T, w, V, w_pl))
    scale = np.maximum(np.abs(w_pl), 1e-3 * np.abs(w_pl).max(axis=1,
                                                             keepdims=True))
    ev = float(np.max(np.abs(w - w_pl) / scale))
    R = Tn @ V - V * w[:, None, :]
    res = float(np.max(np.linalg.norm(R, axis=(1, 2))
                       / np.linalg.norm(Tn, axis=(1, 2))))
    eye = np.eye(n)
    orth = float(np.max(np.linalg.norm(V.conj().transpose(0, 2, 1) @ V - eye,
                                       axis=(1, 2))))
    nsw = jacobi_cuda.sweeps_run(T).cpu().numpy()
    log("kernel", f"Jacobi {label} {Tn.shape[0]}x{n}x{n}: eig err/scale "
        f"{ev:.3e} (<5e-4), |HV-VL|/|H| {res:.3e} (<2e-5), |V^H V-I| "
        f"{orth:.3e} (<2e-4), sweeps {nsw.min()}-{nsw.max()}")
    if not (ev < 5e-4 and res < 2e-5 and orth < 2e-4):
        raise RuntimeError(f"Jacobi kernel disagrees with plain on {label}")
    return float(np.max(np.abs(w - w_pl))), ev


def ltwin_blocks(op, nk=None):
    """The L-twin blocks of a field-engine operator at one k, as the field
    solve's projector factors them (config 3: (216, 27, 27); the FCC
    field path: (512, 64, 64)), or at a table of ``nk`` k-points, as the
    k-batched solve factors them ((nk, 512, 64, 64))."""
    import numpy as np
    lat = op.space.grid.lattice
    if nk is None:
        return op.fastdiag_L().blocks([("L", 1.0)],
                                      np.asarray(lat.k_cart((0.1, 0.3, 0.0))))
    ks = np.asarray([lat.k_cart((0.1 + 0.05 * i, 0.3, 0.0))
                     for i in range(nk)])
    return op.fastdiag_L().blocks([("L", 1.0)], ks)


def _rel(a, b):
    import torch
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def phase_elements(dev, op3, rods, op4, op5):
    """The nd and h1 element kernels against their plain versions; returns
    their max abs errors (nd, h1). ``rods`` is the config-2 setup, whose
    multigrid levels give h1 its 2D shapes (also with a table of its 16
    k on 16·16 rows, as the k-batched V-cycle calls it); ``op4`` the FCC
    field path's operator, which gives nd its (l, q) = (5, 6) shape;
    ``op5`` a config-5 operator (TRI n=6 p=4), which gives h1 its (5, 6)
    shape with a table of the 8 k-points on 80 rows (10 a k), as the
    batched solve calls it."""
    import numpy as np
    import torch
    from bravais_tpu_torch.lattices import make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators import h1_apply, nd_apply
    from bravais_tpu_torch.operators.coefficients import eval_coefficient
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.spaces.h1 import H1Space
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace

    gen = torch.Generator(device=dev).manual_seed(11)

    def dofs(n, shape):
        return torch.randn((n,) + shape, dtype=torch.complex64, device=dev,
                           generator=gen)

    fcc = make_lattice("FCC")
    g3 = PeriodicGrid.make(fcc, 3)
    nd_small = BlochCurlCurl(
        NedelecSpace.make(g3, 2), eps=lambda x: 1 + 0.4 * x[..., 0] ** 2,
        mu_inv=lambda x: 1 + 0.2 * np.sum(x ** 2, axis=-1), device=dev)
    h1_sp = H1Space.make(g3, 2)
    xq = h1_sp.qpoints_phys()
    h1_small = h1_apply.H1Consts.from_space(
        h1_sp, eval_coefficient(lambda x: 1 + 0.3 * x[..., 0] ** 2, xq),
        eval_coefficient(lambda x: 1 + np.sum(x ** 2, axis=-1), xq), dev)
    k3 = [float(v) for v in fcc.k_cart((0.3, 0.2, 0.1))]

    # -- nd (16·16 and 8·16 rows: the k-batched field solves') --
    nd_err = 0.0
    for label, c, rows in (("config-3", op3.nd_consts(), 16),
                           ("config-3", op3.nd_consts(), 48),
                           ("config-3 batched", op3.nd_consts(), 16 * 16),
                           ("config-3 batched", op3.nd_consts(), 16 * 32),
                           ("FCC n=8 p=4", op4.nd_consts(), 16),
                           ("FCC n=8 p=4 batched", op4.nd_consts(), 8 * 16),
                           ("FCC n=8 p=4 batched", op4.nd_consts(), 8 * 32),
                           ("FCC n=3 p=2", nd_small.nd_consts(), 5)):
        nd_err = max(nd_err, hold_nd(label, c, dofs(rows * c.nelem,
                                                    (c.ndof,))))

    # -- h1 --
    max_abs = 0.0
    c3 = op3.qp_L().consts()
    kx = [float(v) for v in op3.space.grid.lattice.k_cart((0.1, 0.3, 0.2))]
    levels = rods[2].gmg.levels
    k2 = [float(v) for v in levels[0].op.space.grid.lattice.k_cart((0.3, 0.1))]
    # The fine level (the fused (A, M)) and two p=1 levels: 8×8 and the
    # coarsest 2×2.
    h1_2d = [(f"config-2 {lv.op.space.grid.shape[0]}x"
              f"{lv.op.space.grid.shape[1]} p={lv.op.space.p} k!=0",
              lv.op.consts(), 16, k2)
             for lv in (levels[0], levels[2], levels[-1])]
    from bravais_tpu_torch.cli.config5_all14 import KFRAC
    lat5 = op5.space.grid.lattice
    k5 = np.asarray([lat5.k_cart(f) for f in KFRAC], np.float32)
    h1_5 = [("config-5 TRI k-table 8", op5.consts(), 80, k5)]
    # The k-batched GMG: config 2's levels with a table of its 16 k.
    k2t = np.asarray(rods[0], np.float32)
    h1_2t = [(f"config-2 {lv.op.space.grid.shape[0]}x"
              f"{lv.op.space.grid.shape[1]} p={lv.op.space.p} k-table "
              f"{len(k2t)}", lv.op.consts(), 16 * len(k2t), k2t)
             for lv in (levels[0], levels[2], levels[-1])]
    # Its mass apply (one k, k-independent) on the same rows, and config
    # 3's L apply at k = 0 on the batched projector's nk·m and nk·2m rows.
    h1_2t += [("config-2 16x16 p=3 one k", levels[0].op.consts(),
               16 * len(k2t), k2),
              ("config-3 k=0 batched", c3, 16 * 16, [0.0] * 3),
              ("config-3 k=0 batched", c3, 16 * 32, [0.0] * 3)]
    for label, c, rows, k in [("config-3 k=0", c3, 16, [0.0] * 3),
                              ("config-3 k=0", c3, 32, [0.0] * 3),
                              ("config-3 k=0", c3, 48, [0.0] * 3),
                              ("config-3 k!=0", c3, 16, kx),
                              ("FCC n=3 p=2 k!=0", h1_small, 5, k3)] \
            + h1_2d + h1_5 + h1_2t:
        max_abs = max(max_abs, hold_h1(label, c, dofs(rows * c.nelem,
                                                      (c.l,) * c.d), k))
    return nd_err, max_abs


def hold_apply(label, kernel, plain, ue, real=None):
    """An element kernel ``kernel(u, want)`` against its plain version
    ``plain(u, want)`` on ``ue`` for every half (AM, A, M), each output's
    error relative to the plain output; with ``real`` (a block a main
    path handed the kernel, of ``ue``'s shape) also on it, each output's
    error over the norm the plain version gives ``ue`` (a random block)
    scaled by ‖real‖/‖ue‖: the operator's own scale, so that a block the
    operator nearly annihilates (or a zero block) is not measured against
    its tiny output. Raises above ``ELEM_BAR``; returns the max abs
    error."""
    import torch
    errs, rerrs, max_abs = [], [], 0.0
    unorm = torch.linalg.vector_norm(ue)
    for want in ("AM", "A", "M"):
        out, ref = kernel(ue, want), plain(ue, want)
        scales = []
        for a, b in zip(out, ref):
            if b is not None:
                errs.append(_rel(a, b))
                max_abs = max(max_abs, float((a - b).abs().max()))
                scales.append(torch.linalg.vector_norm(b) / unorm)
        if real is None:
            continue
        rnorm = torch.linalg.vector_norm(real)
        out, ref = kernel(real, want), plain(real, want)
        for a, b, g in zip((t for t in out if t is not None),
                           (t for t in ref if t is not None), scales):
            d = torch.linalg.vector_norm(a - b)
            rerrs.append(float(d / (g * rnorm)) if rnorm > 0 else float(d))
            max_abs = max(max_abs, float((a - b).abs().max()))
    err = max(errs + rerrs)
    log("kernel", f"{label}: rel err {max(errs):.3e}"
        + (f", on the path's block {max(rerrs):.3e} (over the operator's "
           f"scale)" if rerrs else "") + f" (<{ELEM_BAR:g}) over AM, A, M")
    if not err < ELEM_BAR:
        raise RuntimeError(f"kernel disagrees with plain ({label})")
    return max_abs


def hold_nd(label, c, ue, real=None):
    """``hold_apply`` of the nd kernel with the constants ``c``."""
    from bravais_tpu_torch.operators import nd_apply
    return hold_apply(
        f"nd {label} rows={ue.shape[0] // c.nelem} (l, q) = ({c.l}, {c.q})",
        lambda u, w: nd_apply.nedelec_apply(u, c, w),
        lambda u, w: nd_apply.nedelec_apply_plain(u, c, w), ue, real)


def hold_h1(label, c, ue, k, real=None):
    """``hold_apply`` of the h1 kernel with the constants ``c`` at ``k``
    (one k or a table)."""
    from bravais_tpu_torch.operators import h1_apply
    return hold_apply(
        f"h1 {label} rows={ue.shape[0] // c.nelem} (l, q) = ({c.l}, {c.q}), "
        f"{c.nelem} elements",
        lambda u, w: h1_apply.helmholtz_apply(u, c, k, w),
        lambda u, w: h1_apply.helmholtz_apply_plain(u, c, k, w), ue, real)


# -- the launch log: every kernel call of the main paths, by shape --------

#: {(kernel, shape): {"path": the run that first made the call, "calls":
#: the calls in the logged runs, "args": the first call's inputs (its
#: tensor copied on the card)}}
LAUNCHED = {}
_LOGGING = {"path": None}


def log_path(path):
    """Log the kernel calls from now on under ``path`` (None: stop)."""
    _LOGGING["path"] = path


def _keep(kernel, shape, args):
    rec = LAUNCHED.get((kernel, shape))
    if rec is None:
        rec = LAUNCHED[(kernel, shape)] = {"path": _LOGGING["path"],
                                           "calls": 0, "args": args()}
    rec["calls"] += 1


def install_launch_log():
    """Wrap each kernel's launch (the ``_launch`` of ``nd_apply``,
    ``h1_apply`` and ``jacobi_cuda``, which each wrapper calls where it
    launches) so that while a path is set every call is logged by its
    shape: nd (elements, l, q, rows, half); h1 (elements, l, q, d, rows a
    k, k-points, half, k = 0); Jacobi (matrices, n, sweeps, stop)."""
    import numpy as np
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.operators import h1_apply, nd_apply
    nd_launch, h1_launch = nd_apply._launch, h1_apply._launch
    jac_launch = jacobi_cuda._launch

    def nd(ue, c, want):
        if _LOGGING["path"] is not None:
            _keep("nd", (c.nelem, c.l, c.q, ue.shape[0] // c.nelem, want),
                  lambda: (ue.clone(), c, want))
        return nd_launch(ue, c, want)

    def h1(ue, c, kt, want):
        if _LOGGING["path"] is not None:
            nk = kt.shape[0]
            _keep("h1", (c.nelem, c.l, c.q, c.d,
                         ue.shape[0] // (c.nelem * nk), nk, want,
                         not np.any(kt)),
                  lambda: (ue.clone(), c, kt.copy(), want))
        return h1_launch(ue, c, kt, want)

    def jac(H, sweeps, rel_tol):
        if _LOGGING["path"] is not None:
            n = H.shape[-1]
            _keep("jacobi", (H.numel() // n ** 2, n, int(sweeps), rel_tol),
                  lambda: (H.clone(), int(sweeps), rel_tol))
        return jac_launch(H, sweeps, rel_tol)

    nd_apply._launch, h1_apply._launch, jacobi_cuda._launch = nd, h1, jac


def held_mib():
    """Device MiB of the launch log's kept inputs."""
    import torch
    return sum(rec["args"][0].numel() * rec["args"][0].element_size()
               for rec in LAUNCHED.values()
               if torch.is_tensor(rec["args"][0])) / 2**20


def peak_mib(dev):
    """The peak device memory since the last reset, less the launch log's
    kept inputs, in MiB."""
    import torch
    return torch.cuda.max_memory_allocated(dev) / 2**20 - held_mib()


def shape_label(kernel, shape):
    """A launch-log shape as text."""
    if kernel == "nd":
        nelem, l, q, rows, want = shape
        return f"rows {rows} x {nelem} elements (l, q) = ({l}, {q}) {want}"
    if kernel == "h1":
        nelem, l, q, d, rows, nk, want, k0 = shape
        return (f"rows {rows}x{nk} k x {nelem} elements (l, q, d) = ({l}, "
                f"{q}, {d}) {'k=0' if k0 else 'k!=0'} {want}")
    nb, n, sweeps, rel_tol = shape
    return (f"{nb}x{n}x{n} stop "
            f"{'eps' if rel_tol is None else f'{rel_tol:g}'}, {sweeps} sweeps")


def phase_launched(dev):
    """Every shape the main paths launched a kernel at (``LAUNCHED``),
    held against its plain version: nd and h1 on every half on a random
    block of the shape and on the shape's first logged block
    (``hold_apply``); Jacobi, on the first logged input, at
    the default stop (``phase_jacobi_blocks``' bars) and, where the call
    stopped early (the Rayleigh–Ritz at 1e-4), at the call's own stop, its
    eigenvalues within 5e-4 of the plain version's over max(|λ|, 1e-3
    max|λ|). Returns {kernel: max abs error}, and under "jacobi_rel" the
    Jacobi gates' max error over max(|λ|, 1e-3 max|λ|)."""
    import numpy as np
    import torch
    from bravais_tpu_torch.eigen.jacobi_eigh import (jacobi_eigh,
                                                    jacobi_eigh_plain)

    gen = torch.Generator(device=dev).manual_seed(13)
    err = {"nd": 0.0, "h1": 0.0, "jacobi": 0.0, "jacobi_rel": 0.0}
    for (kernel, shape), rec in LAUNCHED.items():
        label = (f"{rec['path']} ({rec['calls']} calls): "
                 f"{shape_label(kernel, shape)}")
        if kernel in ("nd", "h1"):
            real, c = rec["args"][:2]
            ue = torch.randn(real.shape, dtype=real.dtype, device=dev,
                             generator=gen)
        if kernel == "nd":
            err["nd"] = max(err["nd"], hold_nd(label, c, ue, real))
        elif kernel == "h1":
            err["h1"] = max(err["h1"], hold_h1(label, c, ue, rec["args"][2],
                                               real))
        else:
            H, sweeps, rel_tol = rec["args"]
            e_abs, e_rel = phase_jacobi_blocks(dev, label, H)
            err["jacobi"] = max(err["jacobi"], e_abs)
            err["jacobi_rel"] = max(err["jacobi_rel"], e_rel)
            if (sweeps, rel_tol) == (24, None):
                continue
            w = jacobi_eigh(H, sweeps, rel_tol)[0]
            w_pl = jacobi_eigh_plain(H, sweeps, rel_tol)[0]
            w, w_pl = (t.reshape(-1, H.shape[-1]).cpu().numpy()
                       for t in (w, w_pl))
            scale = np.maximum(np.abs(w_pl), 1e-3 * np.abs(w_pl).max(
                axis=1, keepdims=True))
            ev = float(np.max(np.abs(w - w_pl) / scale))
            err["jacobi"] = max(err["jacobi"], float(np.max(np.abs(w - w_pl))))
            err["jacobi_rel"] = max(err["jacobi_rel"], ev)
            log("kernel", f"Jacobi {label}, at the call's stop: eig "
                f"err/scale {ev:.3e} (<5e-4)")
            if not ev < 5e-4:
                raise RuntimeError(f"Jacobi kernel disagrees with plain at "
                                   f"the call's stop ({label})")
    torch.cuda.synchronize()
    log("launched", f"{len(LAUNCHED)} shapes of the main paths held against "
        f"the plain versions: " + ", ".join(
            f"{k} {sum(1 for kk, _ in LAUNCHED if kk == k)}"
            for k in ("jacobi", "nd", "h1")) + f"; max abs err {err}")
    return err


def nudged(lat, kc):
    """The k-points with exact Γ moved to 2e-2·b₁, as bench.py and the CLI
    move it (the gradient deflation is rank-deficient at Γ)."""
    import numpy as np
    kc = np.array(kc, np.float64)
    for i in range(kc.shape[0]):
        if np.linalg.norm(kc[i]) < 1e-12:
            kc[i] = 2e-2 * lat.B[0]
    return kc


def fcc_problem(dev):
    """(lattice, k-points Γ–X–W–L nk=16 with Γ nudged, operator) of the
    headline FCC problem, n=8 p=4, complex64 on ``dev``."""
    import torch
    from bravais_tpu_torch.lattices import kpath, make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace

    lat = make_lattice(LATTICE)
    kc = nudged(lat, kpath(lat, npts=NK, path=[["G", "X", "W", "L"]]).k_cart)
    sp = NedelecSpace.make(PeriodicGrid.make(lat, N_ELEM), ORDER)
    return lat, kc, BlochCurlCurl(sp, dtype=torch.complex64, device=dev)


def headline(dev):
    """The headline problem on ``dev``: (lattice, k-points with Γ nudged,
    operator, BandSweep). Extracts (or loads) the host stencils."""
    from bravais_tpu_torch.bands.sweep import BandSweep

    lat, kc, op = fcc_problem(dev)
    sp = op.space
    t0 = time.perf_counter()
    fd = op.fastdiag_G()
    log("sweep", f"{sp.ndofs} dofs, B={fd.nblocks} blocks of D={fd.D}; "
        f"host stencils {time.perf_counter() - t0:.2f} s")
    sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=NEV,
                      block=BLOCK, tol=TOL, maxiter=MAXITER,
                      device_tol=DEVICE_TOL)
    return lat, kc, op, sweep


def eig_error(lam, lat, k, mmax, mult):
    """bench.py's accuracy measure: max |λ − λ_exact| over max(λ_exact
    max, 1), λ_exact the lowest len(lam) empty-lattice bands (sorted
    |k+G|² over |m_i| ≤ mmax, each ``mult`` times)."""
    import numpy as np
    vals = sorted(float(np.sum((np.asarray(k) + np.asarray(m) @ lat.B) ** 2))
                  for m in itertools.product(range(-mmax, mmax + 1),
                                             repeat=lat.dim))
    ex = np.asarray(sorted(vals * mult)[:len(lam)])
    return float(np.max(np.abs(lam - ex))) / max(float(ex.max()), 1.0)


def phase_sweep(dev, head):
    """The headline warm sweep (``head``: the ``headline`` setup); returns
    (the main path's launch count, the last pass's iterations per k)."""
    import numpy as np
    import torch
    from bravais_tpu_torch.eigen import jacobi_cuda

    lat, kc, _, sweep = head

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
        errs = [eig_error(res.eigenvalues[i], lat, k, mmax=3, mult=2)
                for i, k in enumerate(kc)]
        err, resid = float(max(errs)), float(np.max(res.residuals))
        tag = "cold" if p == 0 else f"pass {p}"
        log("sweep", f"{tag}: {overlap(res)}, {len(kc) / res.wall_s:.3f} "
            f"eig/s, "
            f"iters/k {res.iterations.mean():.2f} "
            f"{res.iterations.tolist()}, max eig err {err:.3e}, max refined "
            f"residual {resid:.3e}, Jacobi launches {launches} "
            f"(expected {expected})")
        if not err < ERR_BAR:
            raise RuntimeError(f"eigenvalue error {err:.3e} >= {ERR_BAR}")
        if not (launches > 0 and launches == expected):
            raise RuntimeError(f"Jacobi kernel launches {launches} != "
                               f"{expected} eigensolves of the sweep")
        if res.fallbacks:
            raise RuntimeError(f"{res.fallbacks} refine cross-check "
                               f"failures")
        if p:
            walls.append(res.wall_s)
    wall = statistics.median(walls)
    log_serial("sweep", sweep, kc, wall)
    log("sweep", f"headline: {len(kc) / wall:.4f} eig/s (median of "
        f"{PASSES}; nk={len(kc)} / pass wall {wall:.3f} s), iters/k "
        f"{res.iterations.mean():.2f}, max eig err {err:.3e}, max refined "
        f"residual {resid:.3e}, refine cross-check failures 0, peak device "
        f"memory {peak_mib(dev):.1f} MiB")
    return launches, res.iterations


def dielectric(dev):
    """Config 3 on ``dev``: (lattice, k-points with Γ nudged, operator,
    BandSweep). Extracts (or loads) the host stencils."""
    import numpy as np
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.lattices import kpath, make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.coefficients import dielectric_sphere
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace

    lat = make_lattice("CUB")
    kc = nudged(lat, kpath(lat, npts=NK, path=[["G", "X", "M", "R"]]).k_cart)
    sp = NedelecSpace.make(PeriodicGrid.make(lat, DIEL_N), DIEL_P)
    eps = dielectric_sphere(DIEL_EPS, 1.0, DIEL_RADIUS,
                            0.5 * lat.A.sum(axis=0), lat.A)
    op = BlochCurlCurl(sp, eps=eps, dtype=torch.complex64, device=dev)
    t0 = time.perf_counter()
    solve = op.make_solve_fn(deflation="project-cheby", precond="fastdiag")
    log("diel", f"{sp.ndofs} dofs, {int(np.prod(sp.grid.shape))} elements, "
        f"q={sp.q}, Chebyshev steps {op.cheby_steps()}; host stencils "
        f"{time.perf_counter() - t0:.2f} s")
    sweep = BandSweep(op, solve, nev=NEV, block=BLOCK, tol=TOL,
                      maxiter=MAXITER, device_tol=DIEL_DEVICE_TOL)
    return lat, kc, op, sweep


def expected_launches(iterations, steps):
    """The kernel launches one pass of the field solve makes, from its
    iteration counts: per k, the projector runs once on X0 and twice per
    iteration (preconditioner, X/P deflation), each one nd M-half and
    steps−1 h1 applies (the Chebyshev projector's ``steps``; 1 for the
    exact "project" projector, which applies no h1); one M-half more for the start whitening and one
    per iteration for the deflated M X; the fused (A, M) once per
    iteration (W) and twice per 16-iteration segment (X and P refresh);
    Jacobi once per iteration (Rayleigh–Ritz), once for the start
    whitening and once for the L-twin blocks."""
    its = [int(i) for i in iterations]
    proj = sum(1 + 2 * i for i in its)
    return {"nd M": proj + sum(1 + i for i in its),
            "nd AM": sum(i + 2 * -(-i // 16) for i in its),
            "nd A": 0, "h1": (steps - 1) * proj,
            "jacobi": sum(i + 2 for i in its)}


def diel_oracle(kc, op):
    """Config 3's f64 oracle record ({k index: record}), checked against
    the sweep's configuration and k-points."""
    import numpy as np
    oracle = {}
    for line in DIEL_ORACLE.read_text().splitlines():
        rec = json.loads(line)
        if "summary" in rec:      # the record's configuration line
            got = (rec["n"], rec["p"], rec["ndofs"], rec["nev"],
                   rec["eps_in"], rec["radius"])
            want = (DIEL_N, DIEL_P, op.space.ndofs, NEV, DIEL_EPS,
                    DIEL_RADIUS)
            if got != want:
                raise RuntimeError(f"oracle record is for {got}, the sweep "
                                   f"runs {want}")
            continue
        oracle[rec["k_index"]] = rec
        if not np.allclose(rec["k"], kc[rec["k_index"]], rtol=0,
                           atol=1e-12):
            raise RuntimeError(f"oracle k {rec['k']} != path k "
                               f"{kc[rec['k_index']].tolist()}")
    return oracle


def diel_errors(res, oracle):
    """[(k index, band-1 error, band-10 error, within the bars)]: band 1
    absolute at k index 0 (the nudged Γ), relative elsewhere; band 10
    relative."""
    errs = []
    for ki, rec in sorted(oracle.items()):
        lam = res.eigenvalues[ki]
        e_lo = abs(lam[0] - rec["lam_lo"])
        e_hi = abs(lam[NEV - 1] - rec["lam_hi"]) / rec["lam_hi"]
        lo_ok = (e_lo < DIEL_GAMMA_ABS if ki == 0
                 else e_lo / rec["lam_lo"] < DIEL_REL_BAR)
        errs.append((ki, e_lo if ki == 0 else e_lo / rec["lam_lo"],
                     e_hi, lo_ok and e_hi < DIEL_REL_BAR))
    return errs


def phase_dielectric(dev, setup, passes=DIEL_PASSES):
    """The config-3 warm sweep, one cold pass and ``passes`` timed ones;
    returns (the launches of one pass, eig/s: the median over the timed
    passes, the last pass's result)."""
    import numpy as np
    import torch
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.operators import h1_apply, nd_apply

    _, kc, op, sweep = setup
    oracle = diel_oracle(kc, op)
    steps = op.cheby_steps()
    walls, shares = [], []
    for p in range(passes + 1):
        if p == 1:
            torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        jacobi_cuda.launches = nd_apply.launches = h1_apply.launches = 0
        for mode in nd_apply.launches_by_mode:
            nd_apply.launches_by_mode[mode] = 0
        res = sweep.run_warm(kc)
        torch.cuda.synchronize()
        got = {"nd M": nd_apply.launches_by_mode["M"],
               "nd AM": nd_apply.launches_by_mode["AM"],
               "nd A": nd_apply.launches_by_mode["A"],
               "h1": h1_apply.launches, "jacobi": jacobi_cuda.launches}
        want = expected_launches(res.iterations, steps)
        errs = diel_errors(res, oracle)
        resid = res.residuals.max(axis=1)
        tag = "cold" if p == 0 else f"pass {p}"
        share = res.refine_s / res.wall_s
        log("diel", f"{tag}: {overlap(res)} (refine/wall {share:.4f}), "
            f"{len(kc) / res.wall_s:.4f} eig/s, iters/k "
            f"{res.iterations.mean():.2f} {res.iterations.tolist()}, "
            f"launches {got} (expected {want})")
        log("diel", f"{tag}: oracle errors (k index: band 1 "
            f"{'abs at k 0, ' if 0 in oracle else ''}rel elsewhere; band 10 "
            f"rel) " + ", ".join(f"{ki}: {lo:.3e} {hi:.3e}"
                                 for ki, lo, hi, _ in errs))
        log("diel", f"{tag}: max refined residual per k "
            + " ".join(f"{r:.3e}" for r in resid))
        if not all(ok for *_, ok in errs):
            raise RuntimeError(f"config-3 bands off the oracle: {errs}")
        if not (np.all(np.isfinite(resid)) and resid.max() < DIEL_RES_BAR):
            raise RuntimeError(f"refined residual {resid.max():.3e} >= "
                               f"{DIEL_RES_BAR}")
        if got != want or min(got["nd M"], got["nd AM"], got["h1"],
                              got["jacobi"]) <= 0:
            raise RuntimeError(f"kernel launches {got} != the path's calls "
                               f"{want}")
        if p:
            walls.append(res.wall_s)
            shares.append(share)
    wall = statistics.median(walls)
    log_serial("diel", sweep, kc, wall)
    log("diel", f"config 3: {len(kc) / wall:.4f} eig/s (median of "
        f"{passes}; nk={len(kc)} / pass wall {wall:.3f} s), iters/k "
        f"{res.iterations.mean():.2f}, host-refine share "
        f"{statistics.median(shares):.4f}, launches per pass nd "
        f"{got['nd M'] + got['nd AM']} (M {got['nd M']}, AM {got['nd AM']}), "
        f"h1 {got['h1']}, Jacobi {got['jacobi']}, peak device memory "
        f"{peak_mib(dev):.1f} MiB")
    return got, len(kc) / wall, res


def dense_bands(space, k, nev, alpha, beta, dev):
    """The lowest ``nev`` eigenvalues of the dense complex128 pencil
    (``assemble_h1``, assembled on the host) by a Cholesky-reduced eigh on
    the card."""
    import torch
    from bravais_tpu_torch.operators.dense import assemble_h1

    A, M = (torch.as_tensor(a, device=dev)
            for a in assemble_h1(space, k, alpha=alpha, beta=beta))
    L = torch.linalg.cholesky(M)
    C = torch.linalg.solve_triangular(L, A, upper=False)      # L⁻¹A
    C = torch.linalg.solve_triangular(L, C.mH, upper=False)   # L⁻¹AL⁻ᴴ
    return torch.linalg.eigvalsh(0.5 * (C + C.mH))[:nev].cpu().numpy()


def scalar_setup(dev):
    """Config 1: (k-points, operator, BandSweep) of the SQR empty lattice
    on the spectral engine (Γ not nudged, as bench.py leaves it)."""
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.lattices import kpath, make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
    from bravais_tpu_torch.spaces.h1 import H1Space

    lat = make_lattice("SQR")
    kc = kpath(lat, npts=NK).k_cart
    sp = H1Space.make(PeriodicGrid.make(lat, SCALAR_N), SCALAR_P)
    op = BlochHelmholtz(sp, dtype=torch.complex64, device=dev)
    t0 = time.perf_counter()
    solve = op.make_solve_fn()
    fd = op.qp_fastdiag()
    log("scalar", f"{sp.ndofs} dofs, B={fd.nblocks} blocks of D={fd.D}; "
        f"host stencils {time.perf_counter() - t0:.2f} s")
    return kc, op, BandSweep(op, solve, nev=NEV, tol=TOL,
                             maxiter=H1_MAXITER, device_tol=SCALAR_DEVICE_TOL)


def h1_setup(dev, tag, lattice, n, p, alpha, beta, kc, nev, block):
    """A matrix-free scalar path: (k-points, operator, BandSweep with
    ``precond="auto"``, which builds the multigrid hierarchy here)."""
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
    from bravais_tpu_torch.spaces.h1 import H1Space

    sp = H1Space.make(PeriodicGrid.make(lattice, n), p)
    op = BlochHelmholtz(sp, alpha=alpha, beta=beta, dtype=torch.complex64,
                        device=dev)
    t0 = time.perf_counter()
    sweep = BandSweep(op, nev=nev, block=block, tol=TOL, maxiter=H1_MAXITER,
                      device_tol=H1_DEVICE_TOL)
    lv = sweep.gmg.levels if sweep.gmg is not None else []
    log(tag, f"{sp.ndofs} dofs, {sp.grid.n_elements} elements, q={sp.q}; "
        f"precond {sweep.precond_mode}, levels "
        + ", ".join(f"({x.op.space.grid.shape[0]}x{x.op.space.grid.shape[1]}"
                    f" p{x.op.space.p})" for x in lv)
        + f"; setup {time.perf_counter() - t0:.2f} s")
    return kc, op, sweep


def rods_setup(dev):
    """Config 2 TM: SQR with ε = 8.9 rods, α = 1, β = ε."""
    from bravais_tpu_torch.lattices import kpath, make_lattice
    from bravais_tpu_torch.operators.coefficients import dielectric_rod

    lat = make_lattice("SQR")
    eps = dielectric_rod(RODS_EPS, 1.0, RODS_RADIUS, 0.5 * lat.A.sum(axis=0),
                         lat.A)
    return h1_setup(dev, "rods2d", lat, RODS_N, RODS_P, 1.0, eps,
                    kpath(lat, npts=NK).k_cart, NEV, RODS_BLOCK)


def te_setup(dev):
    """The TE air-hole crystal at M: HEX2D, air holes in ε = 13, α = 1/ε,
    β = 1."""
    from bravais_tpu_torch.lattices import make_lattice
    from bravais_tpu_torch.operators.coefficients import dielectric_rod

    lat = make_lattice("HEX2D")
    eps = dielectric_rod(1.0, TE_EPS, TE_RADIUS, 0.5 * lat.A.sum(axis=0),
                         lat.A)
    return h1_setup(dev, "te", lat, TE_N, TE_P, lambda x: 1.0 / eps(x), 1.0,
                    lat.point_cart("M")[None], TE_NEV, TE_BLOCK)


def expected_h1_launches(iterations, sweep):
    """The kernel launches one pass of a scalar path makes, from its
    iteration counts. Spectral engine (the Maxwell one too): Jacobi once
    per iteration (Rayleigh–Ritz) and once per k (start whitening), no
    element kernel.
    Matrix-free: per k the h1 M-half once (start whitening), the fused
    (A, M) once per iteration (W) and twice per 16-iteration segment (X
    and P refresh), the "A" half once per operator apply of the
    preconditioner (``launches_per_vcycle`` per iteration with GMG, none
    with Jacobi); Jacobi as above."""
    its = [int(i) for i in iterations]
    out = {"h1 A": 0, "h1 AM": 0, "h1 M": 0,
           "jacobi": sum(i + 1 for i in its)}
    if getattr(sweep.solve_fn, "provides_support", False):
        return out
    v = sweep.gmg.launches_per_vcycle() if sweep.gmg is not None else 0
    out.update({"h1 A": v * sum(its),
                "h1 AM": sum(i + 2 * -(-i // 16) for i in its),
                "h1 M": len(its)})
    return out


def phase_h1_path(dev, tag, setup, check, passes=H1_PASSES):
    """One scalar path: a cold pass and ``passes`` timed ones, each with
    every count set to 0 just before and read just after. ``check(res)``
    returns (text, ok) for the path's own gates. Every pass's launches
    must equal ``expected_h1_launches``. Returns (launches of one pass,
    eig/s: the median over the timed passes)."""
    import torch
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.operators import h1_apply

    kc, _, sweep = setup
    walls, shares = [], []
    for p in range(passes + 1):
        torch.cuda.synchronize()
        jacobi_cuda.launches = h1_apply.launches = 0
        for want in h1_apply.launches_by_want:
            h1_apply.launches_by_want[want] = 0
        res = sweep.run_warm(kc)
        torch.cuda.synchronize()
        got = {"h1 A": h1_apply.launches_by_want["A"],
               "h1 AM": h1_apply.launches_by_want["AM"],
               "h1 M": h1_apply.launches_by_want["M"],
               "jacobi": jacobi_cuda.launches}
        want = expected_h1_launches(res.iterations, sweep)
        text, ok = check(res)
        ptag = "cold" if p == 0 else f"pass {p}"
        share = res.refine_s / res.wall_s
        log(tag, f"{ptag}: {overlap(res)} (refine/wall {share:.4f}), "
            f"{len(kc) / res.wall_s:.4f} eig/s, "
            f"iters/k {res.iterations.mean():.2f} {res.iterations.tolist()}, "
            f"launches {got} (expected {want}); {text}")
        if not ok:
            raise RuntimeError(f"{tag}: a gate failed: {text}")
        if got != want or any(got[key] <= 0 for key in want if want[key]):
            raise RuntimeError(f"{tag}: kernel launches {got} != the path's "
                               f"calls {want}")
        if p:
            walls.append(res.wall_s)
            shares.append(share)
    wall = statistics.median(walls)
    log_serial(tag, sweep, kc, wall)
    log(tag, f"{len(kc) / wall:.4f} eig/s (median of {passes}; nk={len(kc)} /"
        f" pass wall {wall:.4f} s), iters/k {res.iterations.mean():.2f}, "
        f"host-refine share {statistics.median(shares):.4f}, launches per "
        f"pass {got}")
    return got, len(kc) / wall


def phase_scalar(dev, setup):
    """Config 1 against the analytic empty-lattice bands (bench.py's
    measure: sorted |k+G|², mmax 5, multiplicity 1, over max(ex.max(), 1))
    < 1e-6 with no refine fallback."""
    import numpy as np
    kc, op, _ = setup
    lat = op.space.grid.lattice

    def check(res):
        err = max(eig_error(res.eigenvalues[i], lat, k, mmax=5, mult=1)
                  for i, k in enumerate(kc))
        return (f"max eig err {err:.3e} (<{ERR_BAR:g}), max refined residual "
                f"{np.max(res.residuals):.3e}, refine fallbacks "
                f"{res.fallbacks}", err < ERR_BAR and res.fallbacks == 0)
    return phase_h1_path(dev, "scalar", setup, check)


def band_errors(lam, ref):
    """max |λ − λ_ref| relative to λ_ref, or to the top band where λ_ref
    is below 1e-3 of it (band 1 at Γ, λ = 0)."""
    import numpy as np
    top = float(np.max(np.abs(ref)))
    scale = np.where(np.abs(ref) > 1e-3 * top, np.abs(ref), top)
    return float(np.max(np.abs(lam - ref) / scale))


def phase_rods2d(dev, setup):
    """Config 2 TM, warm: the gates of ``rods_check``."""
    kc, op, _ = setup
    return phase_h1_path(dev, "rods2d", setup, rods_check(kc, op, dev))


def rods_check(kc, op, dev):
    """Config 2 TM's gate on a result: refined bands 1–10 at k indices 0,
    5, 10, 15 against the dense complex128 oracle at the solved (float32)
    k, and the TM gap against the published brackets; returns check(res)
    → (text, ok)."""
    import numpy as np
    k32 = kc.astype(np.float32).astype(np.float64)
    t0 = time.perf_counter()
    oracle = {ki: dense_bands(op.space, k32[ki], NEV, op.alpha,
                              op.beta, dev) for ki in RODS_ORACLE_K}
    log("rods2d", f"dense oracle at k indices {list(oracle)}: "
        f"{time.perf_counter() - t0:.2f} s")

    def check(res):
        errs = {ki: band_errors(res.eigenvalues[ki], o)
                for ki, o in oracle.items()}
        f = np.sqrt(np.maximum(res.eigenvalues, 0.0)) / (2 * np.pi)
        lo, hi = float(f[:, 0].max()), float(f[:, 1].min())
        ratio = 2 * (hi - lo) / (hi + lo)
        gap_ok = all(abs(v - c) < b for v, (c, b) in
                     zip((lo, hi, ratio), TM_GAP))
        ok = max(errs.values()) < RODS_REL_BAR and gap_ok
        return (f"oracle errors " + ", ".join(f"k{ki} {e:.3e}"
                                              for ki, e in errs.items())
                + f" (<{RODS_REL_BAR:g}); TM gap {lo:.4f}-{hi:.4f}, ratio "
                f"{ratio:.4f} (published {TM_GAP}); max refined residual "
                f"{np.max(res.residuals):.3e}", ok)
    return check


def phase_te(dev, setup):
    """The TE air holes at M: GMG in use, bands 1–6 against the dense
    oracle."""
    import numpy as np
    kc, op, sweep = setup
    if sweep.precond_mode != "gmg":
        raise RuntimeError(f"te: precond auto chose {sweep.precond_mode}")
    k32 = kc[0].astype(np.float32).astype(np.float64)
    oracle = dense_bands(op.space, k32, TE_NEV, op.alpha, op.beta,
                         dev)

    def check(res):
        err = band_errors(res.eigenvalues[0], oracle)
        return (f"oracle error {err:.3e} (<{RODS_REL_BAR:g}), GMG in use, max "
                f"refined residual {np.max(res.residuals):.3e}",
                err < RODS_REL_BAR)
    return phase_h1_path(dev, "te", setup, check)


def phase_fcc_field(dev, setup, nd_shape, passes=FIELD_PASSES):
    """Config 4 on the field engine: the headline's FCC problem with the
    exact "project" deflation, one cold pass and ``passes`` timed ones
    (none: the cold pass is the one timed), each with every count set to
    0 just before and read just after.
    Gates: max eigenvalue error against the analytic bands < 1e-6 (k
    rounded to float32 by the sweep, as on the headline), and the nd and
    Jacobi launches of a pass equal to ``expected_launches`` with no h1
    apply. ``nd_shape`` says whether nd runs an instantiation at this
    (l, q) or the runtime extents. Returns (the launches of one pass,
    eig/s of the timed passes' median)."""
    import numpy as np
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.operators import h1_apply, nd_apply

    lat, kc, op = setup
    t0 = time.perf_counter()
    sweep = BandSweep(op, op.make_solve_fn(deflation="project",
                                           precond="fastdiag"),
                      nev=NEV, block=BLOCK, tol=TOL, maxiter=MAXITER,
                      device_tol=FIELD_DEVICE_TOL)
    c = op.nd_consts()
    log("fcc-field", f"{op.space.ndofs} dofs, {c.nelem} elements, nd at "
        f"(l, q) = ({c.l}, {c.q}) on {nd_shape}; host stencils "
        f"{time.perf_counter() - t0:.2f} s; one cold pass and {passes} "
        f"timed (cut from 3 for time; none: the cold pass is timed)")
    walls, shares = [], []
    for p in range(passes + 1):
        if p == min(1, passes):
            torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        jacobi_cuda.launches = nd_apply.launches = h1_apply.launches = 0
        for mode in nd_apply.launches_by_mode:
            nd_apply.launches_by_mode[mode] = 0
        res = sweep.run_warm(kc)
        torch.cuda.synchronize()
        got = {"nd M": nd_apply.launches_by_mode["M"],
               "nd AM": nd_apply.launches_by_mode["AM"],
               "nd A": nd_apply.launches_by_mode["A"],
               "h1": h1_apply.launches, "jacobi": jacobi_cuda.launches}
        want = expected_launches(res.iterations, 1)
        errs = [eig_error(res.eigenvalues[i], lat, k, mmax=3, mult=2)
                for i, k in enumerate(kc)]
        err = max(errs)
        share = res.refine_s / res.wall_s
        tag = "cold" if p == 0 else f"pass {p}"
        log("fcc-field", f"{tag}: {overlap(res)} (refine/wall "
            f"{share:.4f}), {len(kc) / res.wall_s:.4f} eig/s, iters/k "
            f"{res.iterations.mean():.2f} {res.iterations.tolist()}, max eig "
            f"err {err:.3e} (per k {' '.join(f'{e:.2e}' for e in errs)}), "
            f"max refined residual {np.max(res.residuals):.3e}, launches "
            f"{got} (expected {want})")
        if not err < ERR_BAR:
            raise RuntimeError(f"fcc-field: eigenvalue error {err:.3e} >= "
                               f"{ERR_BAR}")
        if got != want or min(got["nd M"], got["nd AM"],
                              got["jacobi"]) <= 0:
            raise RuntimeError(f"fcc-field: kernel launches {got} != the "
                               f"path's calls {want}")
        if p or not passes:
            walls.append(res.wall_s)
            shares.append(share)
    wall = statistics.median(walls)
    log("fcc-field", f"config 4 FCC field: {len(kc) / wall:.4f} eig/s "
        f"(median of {len(walls)}; nk={len(kc)} / pass wall {wall:.3f} s), "
        f"iters/k {res.iterations.mean():.2f} {res.iterations.tolist()}, "
        f"max eig err {err:.3e}, host-refine share "
        f"{statistics.median(shares):.4f}, launches per pass nd "
        f"{got['nd M'] + got['nd AM']} (M {got['nd M']}, AM {got['nd AM']}),"
        f" Jacobi {got['jacobi']}, peak device memory "
        f"{peak_mib(dev):.1f} MiB; nd on "
        f"{nd_shape}")
    return got, len(kc) / wall


def config5_operator(dev):
    """Config 5's TRI operator (n=6 p=4, complex64 on ``dev``), whose
    shapes the kernel gates and times use."""
    from bravais_tpu_torch.cli.config5_all14 import build
    return build("TRI", C5_N, C5_P, C5_NEV, C5_TOL, C5_MAXITER, "field",
                 dev)[2]


def phase_config5(dev):
    """Config 5: all 14 Bravais lattices at n=6 p=4 (13,824 dofs), the 8
    generic k of ``KFRAC`` in ONE k-batched ``BandSweep.run`` per lattice
    and engine (spectral, and the matrix-free built-in solve with Jacobi
    and the h1 kernel at a k table of 8), each with every count set to 0
    just before and read just after. Gates: spectral worst error < 1e-5
    (the reference script's gate; every lattice above 1e-6 named),
    matrix-free worst < 1e-4, every launch count equal to the batch's
    calls; on TRI, ``run(chunk=1)`` (one k per solve) gives the
    iterations per k within ±1 and bands within 1e-6 relative. Returns
    {engine: the launches summed over the 14 lattices}."""
    import numpy as np
    import torch
    from bravais_tpu_torch.cli.config5_all14 import build, max_rel_err
    from bravais_tpu_torch.lattices import LATTICE_NAMES

    launches, worst, above, tri = {}, {}, {}, {}
    for engine in ("spectral", "field"):
        total = {"h1 A": 0, "h1 AM": 0, "h1 M": 0, "jacobi": 0}
        errs = {}
        for name in LATTICE_NAMES:
            t0 = time.perf_counter()
            lat, kc, op, sweep = build(name, C5_N, C5_P, C5_NEV, C5_TOL,
                                       C5_MAXITER, engine, dev)
            setup = time.perf_counter() - t0
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            res = sweep.run(kc)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _counts()
            want = expected_batched_launches(res.iterations, sweep)
            err = max_rel_err(lat, kc, res.eigenvalues)
            errs[lat.variant] = err
            h1 = (f", h1 launches {got['h1 AM'] + got['h1 M']} (AM "
                  f"{got['h1 AM']}, M {got['h1 M']}; the path's calls "
                  f"{want['h1 AM'] + want['h1 M']})"
                  if engine == "field" else "")
            log("config5", f"{engine} {lat.variant}: {op.space.ndofs} dofs, "
                f"max rel err {err:.3e}, iters/k {res.iterations.mean():.2f} "
                f"{res.iterations.tolist()}, wall {wall:.3f} s (host refine "
                f"{res.refine_s:.3f} s), setup {setup:.2f} s, Jacobi "
                f"launches {got['jacobi']} (expected {want['jacobi']}){h1}")
            if got != want:
                raise RuntimeError(f"config5 {engine} {name}: launches {got}"
                                   f" != the batch's calls {want}")
            for key in total:
                total[key] += got[key]
            if name == "TRI":
                tri[engine] = (kc, sweep, res, wall)
        launches[engine] = total
        worst[engine] = max(errs.values())
        above[engine] = [v for v, e in errs.items() if e > 1e-6]
        log("config5", f"{engine}: worst error {worst[engine]:.3e} over "
            f"{len(errs)} lattices; above 1e-6: "
            f"{', '.join(above[engine]) or 'none'}; launches {total}")
    if not worst["spectral"] < C5_SPECTRAL_BAR:
        raise RuntimeError(f"config5 spectral worst {worst['spectral']:.3e}"
                           f" >= {C5_SPECTRAL_BAR}")
    if not worst["field"] < C5_FIELD_BAR:
        raise RuntimeError(f"config5 matrix-free worst {worst['field']:.3e} "
                           f">= {C5_FIELD_BAR}")
    # Batched against looped: the same solves one k at a time. The
    # arithmetic is the same but not its rounding (cuBLAS and torch pick
    # their GEMM and reduction splits by the batch's shape), so a k whose
    # residual crosses the stop at the edge may take one iteration more
    # or less: the gate allows ±1 and the line counts the k that match.
    for engine, (kc, sweep, res, wall) in tri.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = sweep.run(kc, chunk=1)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        rel = float(np.max(np.abs(one.eigenvalues - res.eigenvalues)
                           / np.abs(res.eigenvalues)))
        same = int(np.sum(one.iterations == res.iterations))
        log("config5", f"TRI {engine}: batched iters {res.iterations.tolist()}"
            f" wall {wall:.3f} s; chunk=1 iters {one.iterations.tolist()} "
            f"wall {wall1:.3f} s; the same iterations at {same} of "
            f"{len(kc)} k (the rest within ±1); bands max rel diff "
            f"{rel:.3e} (<1e-6)")
        if np.any(np.abs(one.iterations - res.iterations) > 1) \
                or not rel < 1e-6:
            raise RuntimeError(f"config5 TRI {engine}: chunk=1 differs from "
                               f"the batched run")
    return launches


def _zero_counts():
    """Every kernel's launch count set to 0."""
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.operators import h1_apply, nd_apply
    jacobi_cuda.launches = nd_apply.launches = h1_apply.launches = 0
    for d in (nd_apply.launches_by_mode, h1_apply.launches_by_want):
        for key in d:
            d[key] = 0


#: ``_counts``' keys.
COUNT_KEYS = ("nd M", "nd AM", "nd A", "h1 A", "h1 AM", "h1 M", "jacobi")


def _counts():
    """Every kernel's launch count, nd and h1 by the halves computed."""
    from bravais_tpu_torch.eigen import jacobi_cuda
    from bravais_tpu_torch.operators import h1_apply, nd_apply
    out = {f"nd {w}": nd_apply.launches_by_mode[w] for w in ("M", "AM", "A")}
    out.update({f"h1 {w}": h1_apply.launches_by_want[w]
                for w in ("A", "AM", "M")})
    out["jacobi"] = jacobi_cuda.launches
    return out


def expected_batched_launches(iterations, sweep, steps=None):
    """The kernel launches of one k-batched ``run`` (one chunk) of
    ``sweep``: the k step in lockstep, so the batch makes max(iterations)
    iterations, and every apply and eigensolve of an iteration is one
    launch for all k. A field-engine solve (``steps``: its Chebyshev
    projector's, 1 for the exact "project" one) makes the calls of
    ``expected_launches`` at that one iteration count (the L-twin eigh of
    the whole chunk one launch); every other solve those of
    ``expected_h1_launches`` (the spectral engines: Jacobi only)."""
    it = [int(max(iterations))]
    if steps is not None:
        return as_counts(expected_launches(it, steps))
    out = dict.fromkeys(COUNT_KEYS, 0)
    out.update(expected_h1_launches(it, sweep))
    return out


def as_counts(e):
    """``expected_launches``' dict under ``_counts``' keys (its h1 applies
    are the "A" half)."""
    out = dict.fromkeys(COUNT_KEYS, 0)
    out.update({key: e[key] for key in ("nd M", "nd AM", "nd A", "jacobi")})
    out["h1 A"] = e["h1"]
    return out


def analytic_check(kc, lat):
    """The headline's gates on a sweep result (text, ok): the eigenvalues
    within ``ERR_BAR`` of the analytic bands at ``kc`` and no refine
    fallback."""
    def check(res):
        err = max(eig_error(res.eigenvalues[i], lat, k, mmax=3, mult=2)
                  for i, k in enumerate(kc))
        return (f"max eig err {err:.3e} (<{ERR_BAR:g}), refine "
                f"fallbacks {res.fallbacks}",
                err < ERR_BAR and res.fallbacks == 0)
    return check


def diel_check(oracle):
    """Config 3's gates on a sweep result (text, ok): the certify
    record's bands (``diel_errors``) and the refined residuals."""
    import numpy as np

    def check(res):
        errs = diel_errors(res, oracle)
        resid = res.residuals.max()
        return ("oracle errors (k index: band 1, band 10) " + ", ".join(
            f"{ki}: {lo:.3e} {hi:.3e}" for ki, lo, hi, _ in errs)
            + f"; max refined residual {resid:.3e}",
            all(ok for *_, ok in errs) and np.isfinite(resid)
            and resid < DIEL_RES_BAR)
    return check


def phase_batched(dev, head, setup3, rods, setup4):
    """The k-batched ``BandSweep.run`` on every engine at full width, each
    run with every count set to 0 just before and read just after: the
    FCC headline (spectral, nk = 16 in one chunk), config 3 (field,
    project-cheby, nk = 16), config 4's FCC field path (project, nk =
    ``BATCH_FIELD_NK``) and config 2 TM (the built-in solve with GMG,
    nk = 16). Gates, each the path's own: the analytic bands < 1e-6 and
    no refine fallback (headline), the certify record (config 3), the
    analytic bands (config 4), the dense oracle and the TM gap (config
    2); every kernel's launches equal to the batch's calls
    (``expected_batched_launches``); on the headline, config 3 and config
    2 ``run(chunk=1)`` (one k a solve) gives the iterations per k within
    ±1 (rounding, below) and the refined bands within 1e-6. Returns
    ({path: launches of its batched run}, {path: (wall s, lockstep
    iterations) of its one-chunk run})."""
    import numpy as np
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.lattices import kpath

    lat_h, kc_h, _, sw_h = head
    _, kc3, op3, sw3 = setup3
    kc2, op2, sw2 = rods
    lat4, _, op4 = setup4
    kc4 = nudged(lat4, kpath(lat4, npts=BATCH_FIELD_NK,
                             path=[["G", "X", "W", "L"]]).k_cart)
    sw4 = BandSweep(op4, op4.make_solve_fn(deflation="project",
                                           precond="fastdiag"),
                    nev=NEV, block=BLOCK, tol=TOL, maxiter=MAXITER,
                    device_tol=FIELD_DEVICE_TOL)

    analytic = analytic_check
    check3 = diel_check(diel_oracle(kc3, op3))
    check2 = rods_check(kc2, op2, dev)
    paths = (("headline", kc_h, sw_h, analytic(kc_h, lat_h), None),
             ("config3", kc3, sw3, check3, op3.cheby_steps()),
             ("fcc_field", kc4, sw4, analytic(kc4, lat4), 1),
             ("config2", kc2, sw2, check2, None))
    launches, runs = {}, {}
    for tag, kc, sweep, check, steps in paths:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        log_path(f"batched {tag}")
        _zero_counts()
        t0 = time.perf_counter()
        res = sweep.run(kc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts()
        peak = peak_mib(dev)
        want = expected_batched_launches(res.iterations, sweep, steps)
        text, ok = check(res)
        log("batched", f"{tag}: nk={len(kc)} in one chunk, wall {wall:.3f} s"
            f" ({overlap(res)}), {len(kc) / wall:.4f} "
            f"eig/s, iterations {res.iterations.tolist()} "
            f"({int(max(res.iterations))} lockstep for "
            f"{int(res.iterations.sum())} k-iterations), peak "
            f"device memory {peak:.1f} MiB, launches {got} (expected "
            f"{want}); {text}")
        if not ok:
            raise RuntimeError(f"batched {tag}: a gate failed: {text}")
        if got != want or got["jacobi"] <= 0:
            raise RuntimeError(f"batched {tag}: kernel launches {got} != the"
                               f" batch's calls {want}")
        launches[tag] = got
        runs[tag] = (wall, int(max(res.iterations)))
        if tag == "fcc_field":
            continue
        # Batched against looped: the same solves one k at a time. The
        # batched LOBPCG forms its Grams in complex128 (``lobpcg._gram``),
        # so the batch shape no longer moves them; ±1 (as ``[config5]``)
        # is left for the float32 rest; the line counts the equal k.
        log_path(f"batched {tag} chunk=1")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = sweep.run(kc, chunk=1)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        gap = np.abs(one.iterations - res.iterations)
        diff = band_errors(one.eigenvalues, res.eigenvalues)
        log("batched", f"{tag} chunk=1: wall {wall1:.3f} s ({overlap(one)}; "
            f"{wall1 / wall:.2f}x the batched run, whose one chunk has "
            f"nothing to overlap with), "
            f"iterations {one.iterations.tolist()}: the same at "
            f"{int(np.sum(gap == 0))} of {len(kc)} k, ±1 at "
            f"{int(np.sum(gap == 1))}; bands "
            f"max diff {diff:.3e} (<1e-6; relative, to the top band below "
            f"1e-3 of it)")
        if np.any(gap > 1) or not diff < 1e-6:
            raise RuntimeError(f"batched {tag}: chunk=1 iterations "
                               f"{one.iterations.tolist()} vs "
                               f"{res.iterations.tolist()}, bands differ by "
                               f"{diff:.3e}")
        if tag == "config2":
            continue
        # Chunks of 4 k: the refine of chunk j on the worker thread while
        # chunk j+1 is solved. The same bars as the one-chunk run, the
        # iterations of chunk=1 within ±1, and each chunk's launches.
        log_path(f"batched {tag} chunk={BATCH_CHUNK}")
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        four = sweep.run(kc, chunk=BATCH_CHUNK)
        torch.cuda.synchronize()
        wall4 = time.perf_counter() - t0
        got4 = _counts()
        want4 = dict.fromkeys(got4, 0)
        for s in range(0, len(kc), BATCH_CHUNK):
            e = expected_batched_launches(four.iterations[s:s + BATCH_CHUNK],
                                          sweep, steps)
            for key in want4:
                want4[key] += e[key]
        gap4 = np.abs(four.iterations - one.iterations)
        text4, ok4 = check(four)
        log("batched", f"{tag} chunk={BATCH_CHUNK}: "
            f"{len(kc) // BATCH_CHUNK} chunks, wall {wall4:.3f} s "
            f"({overlap(four)}), iterations {four.iterations.tolist()}: "
            f"chunk=1's at {int(np.sum(gap4 == 0))} of {len(kc)} k, ±1 at "
            f"{int(np.sum(gap4 == 1))}; launches {got4} (expected "
            f"{want4}); {text4}")
        if not ok4 or np.any(gap4 > 1):
            raise RuntimeError(f"batched {tag} chunk={BATCH_CHUNK}: a gate "
                               f"failed: {text4}, iterations "
                               f"{four.iterations.tolist()} vs chunk=1 "
                               f"{one.iterations.tolist()}")
        if got4 != want4:
            raise RuntimeError(f"batched {tag} chunk={BATCH_CHUNK}: kernel "
                               f"launches {got4} != the chunks' calls "
                               f"{want4}")
        launches[f"{tag}_chunk{BATCH_CHUNK}"] = got4
    return launches, runs


def chain_setup_ms(solve, ks):
    """The setup of one chain of k ``ks`` on the spectral engine, ms
    between CUDA events: what "per-k" builds (a whole setup a k), what
    "batched-setup" builds (one call on the chain's k table), each k's
    preconditioner alone and in one call ("batched"), and the one
    preconditioner of "chain-mid". Each the median of 3 calls after
    one."""
    from bravais_tpu_torch.utils.timing import cuda_ms

    def ms(fn):
        return cuda_ms(fn, reps=3, warmup=1)
    return {
        f"{len(ks)} per-k setups": ms(
            lambda: [solve.build_setup(k) for k in ks]),
        "one batched setup": ms(lambda: solve.build_setup(ks)),
        f"{len(ks)} per-k preconditioners": ms(
            lambda: [solve.build_pc(k) for k in ks]),
        "one batched preconditioner": ms(lambda: solve.build_pc(ks)),
        "one preconditioner": ms(
            lambda: solve.build_pc(ks[len(ks) // 2]))}


def phase_chain(dev, head, sweep_its, setup3, diel_res, batched_runs):
    """``[chain]``: the reference's remaining sweep schedules at full
    width, each run with every count set to 0 just before and read just
    after.

    * The headline (``head``) through ``run_warm_chain(chain=CHAIN)`` in
      each of ``CHAIN_MODES``, one cold pass and ``PASSES`` timed ones,
      then one "batched-setup" pass with ``pc_rep="inv"``: every k
      within ``ERR_BAR`` of the analytic bands, no refine fallback,
      Jacobi launches Σ iterations + nk and no element kernel; "per-k"
      giving ``[sweep]``'s iterations (``sweep_its``) at every k,
      "batched" and "batched-setup" "per-k"'s within ±1 (the line counts
      the k that differ); the setup ms of one chain (``chain_setup_ms``).
    * Config 3 (``setup3``) through ``run_warm`` with the near-Γ loose
      stop: the k outside the ball within ``[diel]``'s bars, the in-ball
      k taking no more iterations than in ``[diel]``'s last pass
      (``diel_res``) and within the bars or flagged by an f64
      certificate ≥ ``NEAR_GAMMA_FLAG``; launches the path's calls.
    * Config 3 through one cold k-batched ``run`` with ``restart_tol``:
      ``[batched]``'s bars, its iterations the sum of the two phases',
      launches those of the two k-batched solves; its wall and lockstep
      iterations beside ``[batched]``'s single-phase run
      (``batched_runs``).
    * ``CHAIN_CLI_ARGS`` through the CLI and ``--resume`` (``cli_twice``).

    Returns {path: launches}."""
    import numpy as np
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep

    lat, kc, op, sw = head
    check = analytic_check(kc, lat)
    solve = sw.solve_fn
    launches, its_by_mode, failed = {}, {}, []
    setup = chain_setup_ms(solve, sw._rounded(kc)[:CHAIN])
    log("chain", f"headline setup of one chain of {CHAIN} k (ms, CUDA "
        f"events, median of 3): " + ", ".join(
            f"{name} {ms:.3f}" for name, ms in setup.items()))
    inv = BandSweep(op, op.make_spectral_solve_fn(pc_rep="inv"), nev=NEV,
                    block=BLOCK, tol=TOL, maxiter=MAXITER,
                    device_tol=DEVICE_TOL)
    runs = [(mode, sw, mode, PASSES) for mode in CHAIN_MODES]
    runs.append(("batched-setup inv", inv, "batched-setup", 0))
    for tag, sweep, mode, passes in runs:
        log_path(f"chain headline {tag}")
        walls = []
        for p in range(passes + 1):
            torch.cuda.synchronize()
            if p == min(passes, 1):
                torch.cuda.reset_peak_memory_stats(dev)
            _zero_counts()
            res = sweep.run_warm_chain(kc, chain=CHAIN, precond=mode)
            torch.cuda.synchronize()
            got = _counts()
            want = dict.fromkeys(COUNT_KEYS, 0)
            want["jacobi"] = int(res.iterations.sum()) + len(kc)
            text, ok = check(res)
            if p:
                walls.append(res.wall_s)
            if not ok or sweep.chain_mode != mode:
                failed.append(f"headline {tag}: {text}, mode "
                              f"{sweep.chain_mode}")
            if got != want:
                failed.append(f"headline {tag}: launches {got} != the "
                              f"path's calls {want}")
        wall = statistics.median(walls) if walls else res.wall_s
        its = res.iterations
        ref = sweep_its if mode == "per-k" else its_by_mode.get("per-k")
        diff = (int(np.sum(its != ref)) if ref is not None else None)
        if tag == "per-k" and diff:
            failed.append(f"headline per-k: iterations {its.tolist()} != "
                          f"[sweep]'s {list(sweep_its)}")
        if tag in ("batched", "batched-setup") and np.any(
                np.abs(its - ref) > 1):
            failed.append(f"headline {tag}: iterations {its.tolist()} "
                          f"vs per-k {ref.tolist()}")
        its_by_mode.setdefault(mode, its)
        launches[f"headline_{tag.replace(' ', '_')}"] = got
        log("chain", f"headline {tag}: {len(kc) / wall:.4f} eig/s ("
            + (f"median of {passes}; " if passes else "one pass; ")
            + f"{overlap(res)}), iters/k {its.mean():.2f} {its.tolist()} "
            + ("" if diff is None else
               f"({diff} of {len(kc)} k off "
               + ("[sweep]'s run_warm" if mode == "per-k" else "per-k")
               + "), ")
            + f"Jacobi {got['jacobi']} (expected {want['jacobi']}), "
            f"{text}, peak device memory {peak_mib(dev):.1f} MiB")

    _, kc3, op3, sw3 = setup3
    lat3 = setup3[0]
    oracle = diel_oracle(kc3, op3)
    steps = op3.cheby_steps()
    radius = NEAR_GAMMA_FRAC * float(np.linalg.norm(lat3.B, axis=1).min())
    ng = BandSweep(op3, sw3.solve_fn, nev=NEV, block=BLOCK, tol=TOL,
                   maxiter=MAXITER, device_tol=DIEL_DEVICE_TOL,
                   near_gamma_tol=NEAR_GAMMA_TOL, near_gamma_norm=radius)
    inside = np.linalg.norm(ng._rounded(kc3), axis=1) < radius
    log_path("chain config 3 near-gamma")
    torch.cuda.synchronize()
    _zero_counts()
    res = ng.run_warm(kc3)
    torch.cuda.synchronize()
    got = _counts()
    want = as_counts(expected_launches(res.iterations, steps))
    resid = res.residuals.max(axis=1)
    text = []
    for ki, lo, hi, ok in diel_errors(res, oracle):
        flagged = bool(inside[ki]) and resid[ki] >= NEAR_GAMMA_FLAG
        good = ok and resid[ki] < DIEL_RES_BAR
        text.append(f"{ki}: {lo:.3e} {hi:.3e}" + (
            f" (in the ball; not converged: certificate {resid[ki]:.3e})"
            if flagged and not good else ""))
        if not (good or flagged):
            failed.append(f"config 3 near-gamma k {ki}: {lo:.3e} {hi:.3e}, "
                          f"certificate {resid[ki]:.3e}")
    its, its_d = res.iterations, diel_res.iterations
    if np.any(its[inside] > its_d[inside]):
        failed.append(f"config 3 near-gamma: in-ball iterations "
                      f"{its[inside].tolist()} > [diel]'s "
                      f"{its_d[inside].tolist()}")
    if not (np.all(np.isfinite(resid))
            and np.all(resid[~inside] < DIEL_RES_BAR)):
        failed.append(f"config 3 near-gamma: residuals {resid.tolist()}")
    if got != want:
        failed.append(f"config 3 near-gamma: launches {got} != the path's "
                      f"calls {want}")
    launches["config3_near_gamma"] = got
    log("chain", f"config 3 run_warm, near-gamma stop {NEAR_GAMMA_TOL:g} "
        f"for |k| < {radius:.4f} (k {np.flatnonzero(inside).tolist()}): "
        f"{len(kc3) / res.wall_s:.4f} eig/s ({overlap(res)}), iterations "
        f"{its.tolist()} against [diel]'s {its_d.tolist()} (in the ball "
        f"{int(its[inside].sum())} against {int(its_d[inside].sum())}; "
        f"{int(its.sum())} against {int(its_d.sum())} a pass), launches "
        f"{got} (expected {want}); oracle errors (k index: band 1, band "
        f"10) {', '.join(text)}; max refined residual per k "
        + " ".join(f"{r:.3e}" for r in resid))

    rs = BandSweep(op3, sw3.solve_fn, nev=NEV, block=BLOCK, tol=TOL,
                   maxiter=MAXITER, device_tol=DIEL_DEVICE_TOL,
                   restart_tol=RESTART_TOL)
    calls, undo = _recording(rs)
    log_path("chain config 3 restart")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    res = rs.run(kc3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts()
    undo()
    want = _batch_launches(calls, rs, steps)
    text, ok = diel_check(oracle)(res)
    lock = [int(max(c)) for c in calls]
    wall1, lock1 = batched_runs["config3"]
    if not ok:
        failed.append(f"config 3 restart: {text}")
    if (len(calls) != 2 or got != want
            or not np.array_equal(res.iterations, calls[0] + calls[1])):
        failed.append(f"config 3 restart: launches {got} != the path's "
                      f"calls {want}, or iterations {res.iterations} not "
                      f"the phases' sum")
    launches["config3_restart"] = got
    log("chain", f"config 3 run, restart at {RESTART_TOL:g}: wall "
        f"{wall:.3f} s ({overlap(res)}) against [batched]'s single phase "
        f"{wall1:.3f} s; lockstep iterations {lock[0]} + {lock[1]} = "
        f"{sum(lock)} against {lock1}; iterations per k "
        f"{res.iterations.tolist()} (phase 1 {calls[0].tolist()}); peak "
        f"device memory {peak_mib(dev):.1f} MiB; launches {got} (expected "
        f"{want}); {text}")
    log_path(None)

    wall, out, iters, errs, wall2 = cli_twice("chain", CHAIN_CLI_ARGS)
    log("chain", f"FCC spectral --mode warm-chain via the CLI: {wall:.2f} s "
        f"(process start and build load included), iters/k "
        f"{np.mean(iters):.2f} {iters}, max eig err {max(errs):.3e} "
        f"(<{ERR_BAR:g}) at every k; --resume: exit 0 in {wall2:.2f} s, "
        f"nothing recomputed")
    if "# warm-chain: chains of 4, preconditioner mode batched-setup" \
            not in out.splitlines():
        failed.append("cli: the run did not say it ran batched-setup")
    if failed:
        raise RuntimeError("chain: " + "; ".join(failed))
    return launches


def expected_field_launches(iterations, deflation, precond, gmg=None):
    """The kernel launches and projector calls of field-engine solves
    (``make_solve_fn(deflation=..., precond=...)``), one per entry of
    ``iterations`` (a k's iterations, or a k-batched solve's lockstep
    count i), but the CG projector's h1 launches, which ``CGSteps`` counts.
    The σ-shift deflations ("cg", "fastdiag", "gmg"): a = i + 2⌈i/16⌉
    calls of Ã (once an iteration on W, twice a 16-iteration segment on X
    and P), each one nd "A", three nd "M" (the projector's M u, the
    shift's M P x, the pencil's M x) and one projection; two nd "M" more
    (the projector on X0, the start whitening) and one projection more on
    X0; Jacobi once an iteration (Rayleigh–Ritz), once for the whitening
    and once for the L-twin eigh but with "gmg" (whose h1 launches are
    ``gmg.launches_per_solve()`` a projection and one for the coarse
    assembly). The projecting
    deflations ("project-cg") as ``expected_launches``: 1 + 2i
    projections (X0, the preconditioner's, the X/P deflation), nd "M" for
    each and 1 + i more, the fused (A, M) hook i + 2⌈i/16⌉ times, Jacobi
    i + 2. "fastdiag-cg" adds its 3 inner steps' fused (A, M) launches an
    iteration (``make_solve_fn``'s ``inner_iters``). Returns (launches,
    projector calls)."""
    out = dict.fromkeys(("nd M", "nd AM", "nd A", "h1 A", "h1 AM", "h1 M",
                         "jacobi"), 0)
    calls = 0
    for i in map(int, iterations):
        a = i + 2 * -(-i // 16)
        if deflation.startswith("project"):
            proj = 1 + 2 * i
            out["nd M"] += proj + 1 + i
            out["nd AM"] += a
            out["jacobi"] += i + 2
        else:
            proj = 1 + a
            out["nd A"] += a
            out["nd M"] += 3 * a + 2
            out["jacobi"] += i + 1 + (deflation != "gmg")
        if deflation == "gmg":
            out["h1 A"] += 1 + gmg.launches_per_solve() * proj
        if precond == "fastdiag-cg":
            out["nd AM"] += 3 * i
        calls += proj
    return out, calls


def gmg_check(oracle, first):
    """``[gmg]``'s gates on a config-3 result (text, ok). The k before
    index ``first`` were solved from the seeded cold block (run_warm: k 0,
    the nudged Γ; the batched run: every k), those from ``first`` on warm.
    A warm k must lie within ``[diel]``'s bars (``diel_errors``, at the
    oracle's k) with its refined residual under ``DIEL_RES_BAR``. A cold
    float32 σ-shift solve at config 3 stalls (a stagnation stop, the
    reference's engine alike from the same block: §6 of PERF.md), so a
    cold k passes within the bars or with its f64 residual certificate at
    ``DIEL_RES_BAR`` or above: it may miss, but must not be reported
    converged while off the bars. ``first`` = 0 holds every k to the
    bars (``[cg]``, whose config-3 solves converge cold)."""
    import numpy as np

    def check(res):
        resid = res.residuals.max(axis=1)
        text, bad = [], []
        for ki, lo, hi, ok in diel_errors(res, oracle):
            cold = ki < first
            flagged = cold and resid[ki] >= DIEL_RES_BAR
            good = (ok and resid[ki] < DIEL_RES_BAR) or flagged
            text.append(f"{ki}: {lo:.3e} {hi:.3e}"
                        + (" (cold; not converged: certificate "
                           f"{resid[ki]:.3e})" if flagged else ""))
            if not good:
                bad.append(ki)
        warm = resid[first:]
        if not (np.all(np.isfinite(resid)) and np.all(warm < DIEL_RES_BAR)):
            bad.append("residuals")
        return ("oracle errors (k index: band 1, band 10) " + ", ".join(text)
                + (f"; max refined residual of the warm k {warm.max():.3e}"
                   if warm.size else ""), not bad)
    return check


def phase_gmg(dev, setup3):
    """``[gmg]``: the σ-shift Maxwell engine (``make_solve_fn(deflation=
    "gmg")``: LOBPCG on A + σ·M P with the QPGMG gradient projector and
    Jacobi) at full width, config 3 (n=6 p=3, 10 bands in 16, device stop
    1e-4, ``[diel]``'s maxiter, then the f64 host refine) through
    ``run_warm`` on its first ``GMG_WARM_NK`` k and the k-batched ``run``
    on all 16, each with every count
    set to 0 just before and read just after: ``[diel]``'s gates against
    the certify record at every warm-started k, a certificate that flags
    any cold-started k off them (``gmg_check``), the launches equal to the
    path's calls (``expected_field_launches``). Then the CLI's n < 3 route in a child
    process as a user starts it (``GMG_CLI_ARGS``, no ``--engine``): it
    must say it picked gmg, exit 0, and give bands within ``GMG_CLI_BAR``
    of the port's own complex128 CPU run of the same configuration, made
    here. Returns {path: launches}."""
    import argparse
    import tempfile

    import numpy as np
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.cli import bands_app
    from bravais_tpu_torch.cli.config import RunConfig

    _, kc, op, _ = setup3
    t0 = time.perf_counter()
    solve = op.make_solve_fn(deflation="gmg", precond=None)
    gmg = op.qp_gmg()
    coarse = gmg.levels[-1].op.space
    log("gmg", f"config 3 on the gmg engine: sigma {op.sigma_shift:.6g}, "
        f"QPGMG levels " + ", ".join(
            f"{lv.op.space.grid.shape[0]}^3 p={lv.op.space.p} "
            f"q={lv.op.space.q}" for lv in gmg.levels)
        + f" (coarsest {int(np.prod(coarse.dof_shape))} dofs, exact "
        f"solve), {gmg.launches_per_solve()} h1 launches a projection; "
        f"hierarchy {time.perf_counter() - t0:.2f} s")
    sweep = BandSweep(op, solve, nev=NEV, block=BLOCK, tol=TOL,
                      maxiter=MAXITER, device_tol=DIEL_DEVICE_TOL)
    oracle = diel_oracle(kc, op)
    launches, failed = {}, []
    for tag, run, ks in (("run_warm", sweep.run_warm, kc[:GMG_WARM_NK]),
                         ("run", sweep.run, kc)):
        check = gmg_check({ki: rec for ki, rec in oracle.items()
                           if ki < len(ks)},
                          first=1 if tag == "run_warm" else len(ks))
        log_path(f"gmg config 3 {tag}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        res = run(ks)
        torch.cuda.synchronize()
        got = _counts()
        its = (res.iterations.tolist() if tag == "run_warm"
               else [int(max(res.iterations))])
        want = expected_field_launches(its, "gmg", None, gmg=gmg)[0]
        text, ok = check(res)
        log("gmg", f"config 3 {tag}: nk={len(ks)}, {overlap(res)}, "
            f"{len(ks) / res.wall_s:.4f} eig/s, iterations per k "
            f"{res.iterations.tolist()} (mean {res.iterations.mean():.2f}"
            + ("" if tag == "run_warm" else
               f", {its[0]} lockstep") + f"), launches {got} (expected "
            f"{want}), peak device memory {peak_mib(dev):.1f} MiB; {text}; "
            f"max refined residual per k " + " ".join(
                f"{r:.3e}" for r in res.residuals.max(axis=1)))
        if not ok:
            failed.append(f"config 3 {tag}: a gate failed: {text}")
        if got != want or min(got["nd A"], got["nd M"], got["h1 A"],
                              got["jacobi"]) <= 0:
            failed.append(f"config 3 {tag}: kernel launches {got} != the "
                          f"path's calls {want}")
        launches[f"config3_{tag}"] = got
    log_path(None)

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "fcc_n2"
        cmd = [sys.executable, "-m", "bravais_tpu_torch", *GMG_CLI_ARGS,
               "--out", str(out)]
        log("gmg", " ".join(cmd[1:]))
        env = {k: v for k, v in os.environ.items()
               if k not in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=REPO, text=True, capture_output=True,
                           timeout=900, env=env)
        wall = time.perf_counter() - t0
        for line in r.stdout.splitlines():
            log("gmg", line)
        if r.returncode:
            raise RuntimeError(f"gmg cli exited {r.returncode}: "
                               f"{r.stderr[-3000:]}")
        if "# engine gmg" not in r.stdout.splitlines():
            raise RuntimeError("gmg cli: the n < 3 route did not pick gmg")
        lam = np.load(out / "bands.npz")["eigenvalues"]
        iters = [json.loads(line)["iters"] for line in r.stdout.splitlines()
                 if line.startswith("{")]
        ap = argparse.ArgumentParser()
        RunConfig.add_cli_args(ap)
        cfg = RunConfig.from_cli_args(ap.parse_args(
            [*GMG_CLI_ARGS, "--device", "cpu", "--precision", "f64", "--out",
             str(Path(tmp) / "cpu")]))
        t0 = time.perf_counter()
        lam_cpu = bands_app.run(cfg, log=lambda s: None).eigenvalues
        cpu_s = time.perf_counter() - t0
    err = band_errors(lam, lam_cpu)
    log("gmg", f"FCC n=2 p=2 via the CLI (auto -> gmg): {wall:.2f} s "
        f"(process start and build load included), iters/k "
        f"{np.mean(iters):.2f} {iters}; bands off the port's complex128 "
        f"CPU run ({cpu_s:.2f} s) by {err:.3e} (<{GMG_CLI_BAR:g}; relative, "
        f"to the top band below 1e-3 of it)")
    if not (lam.shape == lam_cpu.shape and np.all(np.isfinite(lam))
            and err < GMG_CLI_BAR):
        failed.append(f"cli: bands {lam.shape} off the CPU run by "
                      f"{err:.3e}")
    if failed:
        raise RuntimeError("gmg: " + "; ".join(failed))
    return launches


class CGSteps:
    """Counts the CG projector's work on ``op`` while entered: the calls of
    ``gradient_component`` and the L applies (h1 "A") made inside them, two
    a CG step. The steps are data-dependent (each row leaves the CG at its
    own tolerance), so ``[cg]``'s expected h1 launches are the applies
    counted here; its calls, and the steps of each, are held against the
    path's formula and ``cg_iters``. Leaves the instance as it found it."""

    def __init__(self, op):
        self.op = op
        self.calls = self.applies = self.most = 0

    def __enter__(self):
        op, inside = self.op, [False]
        gc, lk = op.gradient_component, op.apply_Lk

        def apply_Lk(*a, **kw):
            self.applies += inside[0]
            return lk(*a, **kw)

        def gradient_component(*a, **kw):
            before, inside[0] = self.applies, True
            try:
                return gc(*a, **kw)
            finally:
                inside[0] = False
                self.calls += 1
                self.most = max(self.most, (self.applies - before) // 2)

        op.apply_Lk, op.gradient_component = apply_Lk, gradient_component
        return self

    def __exit__(self, *exc):
        del self.op.apply_Lk, self.op.gradient_component


def cold_check(ref, first):
    """A sweep's gates against reference bands ``ref`` (nk, nev) (text,
    ok): the k from index ``first`` on within ``GMG_CLI_BAR``
    (``band_errors``) with refined residuals under ``DIEL_RES_BAR``; a k
    before it within them or flagged by its f64 certificate
    (≥ ``CG_FCC_FLAG``): never off the bar and reported converged."""
    import numpy as np

    def check(res):
        resid = res.residuals.max(axis=1)
        text, bad = [], []
        for ki in range(len(ref)):
            err = band_errors(res.eigenvalues[ki], ref[ki])
            flagged = ki < first and resid[ki] >= CG_FCC_FLAG
            ok = err < GMG_CLI_BAR and resid[ki] < DIEL_RES_BAR
            text.append(f"{ki}: {err:.3e}" + (
                f" (cold; not converged: certificate {resid[ki]:.3e})"
                if flagged and not ok else ""))
            if not (ok or flagged):
                bad.append(ki)
        return (f"bands off the reference (<{GMG_CLI_BAR:g}) "
                + ", ".join(text),
                not bad and res.eigenvalues.shape == ref.shape
                and bool(np.all(np.isfinite(res.eigenvalues))))
    return check


def cg_fcc(dev):
    """FCC n=3 p=2, element-invariant ε, Γ–X–W–L nk=8 with Γ nudged:
    (k-points, operator, the spectral engine's bands of the same
    discretization from one k-batched run on ``dev``)."""
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.lattices import kpath, make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace

    lat = make_lattice("FCC")
    kc = nudged(lat, kpath(lat, npts=CG_FCC_NK,
                           path=[["G", "X", "W", "L"]]).k_cart)
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, CG_FCC_N),
                                         CG_FCC_P),
                       dtype=torch.complex64, device=dev)
    spec = BandSweep(op, op.make_spectral_solve_fn(), nev=NEV, block=BLOCK,
                     tol=TOL, maxiter=MAXITER, device_tol=DEVICE_TOL).run(kc)
    return kc, op, spec.eigenvalues


def phase_cg(dev, setup3):
    """``[cg]``: the reference's remaining field-engine solves. Config 3 at
    full width (``[diel]``'s problem, k-points, device stop and maxiter,
    then the f64 host refine) on ``make_solve_fn(deflation="cg",
    precond="fastdiag-cg", cg_iters=adaptive_cg_iters())`` — the σ-shift
    solve with the per-row CG projector and the inner-PCG preconditioner,
    σ = ``fd_sigma(m)`` — through ``run_warm`` and the k-batched ``run``;
    then one k-batched ``run`` each of config 3 on "project-cg" +
    "fastdiag-cg" and on "gmg" + "fastdiag", and of FCC n=3 p=2 (nk=8) on
    ``make_solve_fn()`` ("cg" with Jacobi) and on "fastdiag" + "fastdiag".
    Every run with the counts set to 0 just before and read just after:
    the launches equal to the path's calls (``expected_field_launches``,
    the CG's h1 applies counted by ``CGSteps``), every CG within
    ``cg_iters`` steps; config 3's gates as ``[gmg]``'s (``gmg_check``)
    but at every k, cold or warm: within ``[diel]``'s bars with the
    refined residual under ``DIEL_RES_BAR``; FCC's against the spectral
    engine's bands of the same discretization (``cold_check``, 1e-5) at
    every k, but for "cg" + Jacobi at the nudged Γ, which may instead be
    flagged by its certificate (``CG_FCC_FLAG``). Returns {path:
    launches}."""
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep

    _, kc, op, _ = setup3
    iters3 = op.adaptive_cg_iters()
    oracle = diel_oracle(kc, op)
    t0 = time.perf_counter()
    kcf, opf, spec = cg_fcc(dev)
    log("cg", f"config 3: contrast {op.coef_contrast():g}, cg_iters "
        f"{iters3}, sigma fd_sigma({BLOCK}) {op.fd_sigma(BLOCK):.6g}; FCC "
        f"n={CG_FCC_N} p={CG_FCC_P} nk={len(kcf)}: spectral bands in "
        f"{time.perf_counter() - t0:.2f} s, sigma_shift "
        f"{opf.sigma_shift:.6g}")
    runs = [("config3", "run_warm", op, kc, "cg", "fastdiag-cg", iters3),
            ("config3", "run", op, kc, "cg", "fastdiag-cg", iters3),
            ("config3", "run", op, kc, "project-cg", "fastdiag-cg", iters3),
            ("config3", "run", op, kc, "gmg", "fastdiag", None),
            ("fcc", "run", opf, kcf, "cg", None, 25),
            ("fcc", "run", opf, kcf, "fastdiag", "fastdiag", None)]
    launches, failed = {}, []
    for conf, tag, o, ks, defl, pc, iters in runs:
        kw = {} if iters is None else {"cg_iters": iters}
        sweep = BandSweep(o, o.make_solve_fn(deflation=defl, precond=pc,
                                             **kw),
                          nev=NEV, block=BLOCK, tol=TOL, maxiter=MAXITER,
                          device_tol=(DIEL_DEVICE_TOL if conf == "config3"
                                      else FIELD_DEVICE_TOL))
        # Every k is held to the bars, the cold ones too, but FCC's
        # "cg" + Jacobi at index 0, the nudged Γ (CG_FCC_FLAG).
        first = 1 if (conf, defl, pc) == ("fcc", "cg", None) else 0
        check = (gmg_check(oracle, first) if conf == "config3"
                 else cold_check(spec, first))
        path = f"{conf} {tag} {defl} {pc or 'jacobi'}"
        log_path(f"cg {path}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with CGSteps(o) as cg:
            _zero_counts()
            res = (sweep.run_warm if tag == "run_warm" else sweep.run)(ks)
            torch.cuda.synchronize()
            got = _counts()
        its = (res.iterations.tolist() if tag == "run_warm"
               else [int(max(res.iterations))])
        want, calls = expected_field_launches(
            its, defl, pc, gmg=o.qp_gmg() if defl == "gmg" else None)
        want["h1 A"] += cg.applies
        uses_cg = defl in ("cg", "project-cg")
        text, ok = check(res)
        log("cg", f"{path}: {overlap(res)}, {len(ks) / res.wall_s:.4f} "
            f"eig/s, iterations per k {res.iterations.tolist()} (mean "
            f"{res.iterations.mean():.2f}" + ("" if tag == "run_warm" else
                                              f", {its[0]} lockstep")
            + f"), CG projections {cg.calls} (expected "
            f"{calls if uses_cg else 0}), CG steps {cg.applies // 2} "
            f"(most in one call {cg.most}), launches {got} (expected {want}),"
            f" peak device memory {peak_mib(dev):.1f} MiB; {text}; max "
            f"refined residual per k " + " ".join(
                f"{r:.3e}" for r in res.residuals.max(axis=1)))
        if not ok:
            failed.append(f"{path}: a gate failed: {text}")
        if (not (cg.calls == calls and 0 < cg.most <= iters
                 and cg.applies % 2 == 0) if uses_cg else cg.calls):
            failed.append(f"{path}: {cg.calls} CG projections (expected "
                          f"{calls}), at most {cg.most} steps in one "
                          f"(cg_iters {iters})")
        if got != want:       # each formula's kernels are all > 0
            failed.append(f"{path}: kernel launches {got} != the path's "
                          f"calls {want}")
        launches[path.replace(" ", "_")] = got
    log_path(None)
    if failed:
        raise RuntimeError("cg: " + "; ".join(failed))
    return launches


def dense_bands_nd(sp, eps, k64, nev, dev, AM=None):
    """The ``nev`` lowest bands of the Nédélec discretization ``sp`` at
    ``k64`` by a dense complex128 solve with the curl-curl kernel removed
    (``dense.assemble_nedelec`` on the host, or its (A, M) ``AM``; G from
    ``apply_Gk`` in complex128 on ``dev``; the reduced pencil by
    scipy)."""
    import numpy as np
    import torch
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.operators.dense import (assemble_nedelec,
                                                   deflated_nedelec_bands)
    A, M = AM if AM is not None else assemble_nedelec(sp, k64, eps=eps)
    nh = int(np.prod(sp.dof_shape))
    units = torch.eye(nh, dtype=torch.complex128, device=dev).reshape(
        (nh,) + sp.dof_shape)
    op64 = BlochCurlCurl(sp, eps=eps, dtype=torch.complex128, device=dev)
    G = op64.apply_Gk(units, k64).reshape(nh, -1).T.cpu().numpy()
    return deflated_nedelec_bands(A, M, G, nev)


def phase_certify(dev):
    """``tests/test_torch_certify.py``'s certification on the card: CUB
    n=4 p=2 with an ε = 13 and an ε = 30 sphere (r = 0.25a), the X point,
    5 bands in a block of 9, the f32 field path (project-cheby deflation,
    fastdiag preconditioner: the nd, h1 and Jacobi kernels), device stop
    1e-4, the f64 host refine, ``run`` of one k with every count set to 0
    just before and read just after. Gates: the refined bands within 1e-6
    relative of the complex128 dense solve of the same discretization
    with the curl-curl kernel removed (``dense.assemble_nedelec`` on the
    host, G from ``apply_Gk`` in complex128 on the card, the reduced
    pencil by scipy); the launches equal to the calls of the solve; the
    native C++ assembly (``utils/native.py``, built with g++ here)
    within 1e-12 of ``dense.assemble_nedelec``. Returns {ε: launches}."""
    import numpy as np
    import torch
    from bravais_tpu_torch.bands.sweep import BandSweep
    from bravais_tpu_torch.lattices import make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.coefficients import dielectric_sphere
    from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
    from bravais_tpu_torch.operators.dense import assemble_nedelec
    from bravais_tpu_torch.spaces.nedelec import NedelecSpace
    from bravais_tpu_torch.utils import native

    t0 = time.perf_counter()
    lib = native._build()
    log("certify", f"native host core {lib.name} built with g++ in "
        f"{time.perf_counter() - t0:.2f} s")
    lat = make_lattice("CUB")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, CERT_N), CERT_P)
    k = np.asarray(lat.k_cart((0.5, 0.0, 0.0)), np.float32)
    k64 = k.astype(np.float64)
    out = {}
    for eps_in in CERT_EPS:
        eps = dielectric_sphere(eps_in, 1.0, 0.25, 0.5 * lat.A.sum(axis=0),
                                lat.A, 0.0)
        op = BlochCurlCurl(sp, eps=eps, dtype=torch.complex64, device=dev)
        sweep = BandSweep(op, op.make_solve_fn(deflation="project-cheby",
                                               precond="fastdiag"),
                          nev=CERT_NEV,
                          block=CERT_BLOCK, tol=TOL, maxiter=MAXITER,
                          device_tol=DIEL_DEVICE_TOL)
        log_path(f"certify eps {eps_in:g}")
        torch.cuda.synchronize()
        _zero_counts()
        res = sweep.run(k[None])
        torch.cuda.synchronize()
        got = _counts()
        want = expected_batched_launches(res.iterations, sweep,
                                         op.cheby_steps())
        t0 = time.perf_counter()
        A, M = assemble_nedelec(sp, k64, eps=eps)
        t_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        An, Mn = native.assemble_nedelec(sp, k64, eps=eps)
        t_nat = time.perf_counter() - t0
        nat = max(float(np.max(np.abs(An - A)) / np.max(np.abs(A))),
                  float(np.max(np.abs(Mn - M)) / np.max(np.abs(M))))
        t0 = time.perf_counter()
        oracle = dense_bands_nd(sp, eps, k64, CERT_NEV, dev, (A, M))
        t_or = time.perf_counter() - t0
        rel = np.abs(res.eigenvalues[0] - oracle) / np.abs(oracle)
        log("certify", f"eps {eps_in:g}: {sp.ndofs} dofs, iterations "
            f"{int(res.iterations[0])}, bands {res.eigenvalues[0].tolist()}"
            f", dense oracle {oracle.tolist()} ({t_or:.2f} s), max rel err "
            f"{rel.max():.3e} (<{CERT_BAR:g}), max refined residual "
            f"{res.residuals.max():.3e}; launches {got} (expected {want}); "
            f"native assembly {t_nat:.3f} s against numpy {t_np:.3f} s, max "
            f"rel diff {nat:.3e} (<{NATIVE_BAR:g})")
        if not rel.max() < CERT_BAR:
            raise RuntimeError(f"certify eps {eps_in}: bands off the dense "
                               f"oracle by {rel.max():.3e}")
        if got != want or min(got["nd M"], got["nd AM"], got["h1 A"],
                              got["jacobi"]) <= 0:
            raise RuntimeError(f"certify eps {eps_in}: kernel launches {got}"
                               f" != the solve's calls {want}")
        if not nat < NATIVE_BAR:
            raise RuntimeError(f"certify eps {eps_in}: native assembly off "
                               f"by {nat:.3e}")
        out[eps_in] = got
    return out


def phase_certify_prod(dev):
    """``[certify-prod]``: ``cli/certify_dielectric.py``'s ``certify`` at
    ``CERT_PROD_ARGS`` (config 3's problem cut to CUB n=4 p=2, nk=6): the
    full f32 warm sweep on the card (project-cheby at the production
    target, fastdiag, device stop 1e-4, the f64 host Rayleigh–Ritz: the
    nd, h1 and Jacobi kernels), then the cold complex128 matrix-free
    oracle of the sampled k on the host (a pool of processes), with every
    count set to 0 just before and read just after; then the seed sweep:
    ``run_warm`` of k 0-1 from the start block of each seed in
    ``CERT_PROD_SEEDS``, the counts set to 0 before the first seed and
    read after the last. Logs the module's JSON lines and verdict, and
    each seed's iterations, k-1 error and residual. Gates: the oracle
    converged at every sampled k and its lowest and highest band within
    ``CERT_PROD_DENSE_BAR`` relative of the dense complex128 solve of the
    same discretization (``dense_bands_nd``); the f32 bands finite and
    every band of every sampled k under the module's scale-aware bar but
    those of ``CERT_PROD_SHARED_MISS``; at every seed each k-1 band under
    that bar against the oracle's k 1 and the k-1 host residuals under
    ``CERT_PROD_RESID_BAR``; the launches of each run equal to its
    sweeps' calls (``expected_launches``). Returns the launches of the
    certification and of the seed sweep."""
    import numpy as np
    import torch
    from bravais_tpu_torch.cli import certify_dielectric as cd

    def launches(iterations, steps):
        want = expected_launches(iterations, steps)
        return {"nd M": want["nd M"], "nd AM": want["nd AM"],
                "nd A": want["nd A"], "h1 A": want["h1"], "h1 AM": 0,
                "h1 M": 0, "jacobi": want["jacobi"]}

    def scaled_err(lam32, lam64):
        floor = args.band_floor * float(np.abs(lam64).max())
        return np.abs(lam32 - lam64) / np.maximum(np.abs(lam64), floor)

    args = cd.parser().parse_args(list(CERT_PROD_ARGS))
    log_path("certify-prod")
    torch.cuda.synchronize()
    _zero_counts()
    got = cd.certify(args)
    counts = _counts()
    log_path(None)
    want = launches(got["f32"].iterations, got["steps"])
    for rec in got["records"] + [got["summary"]]:
        log("certify-prod", json.dumps(rec))
    lat, sp, eps = cd.problem(args.n, args.p, args.eps_in, args.radius)
    kc = cd.kpoints(lat, args.nk)
    t0 = time.perf_counter()
    dense = {}
    for rec in got["records"]:
        lam = dense_bands_nd(sp, eps, kc[rec["k_index"]], args.nev, dev)
        dense[rec["k_index"]] = max(
            abs(rec["lam_lo"] - lam[0]) / abs(lam[0]),
            abs(rec["lam_hi"] - lam[-1]) / abs(lam[-1]))
    summ = got["summary"]
    missed = set()
    for ki, orc in got["oracle"].items():
        err = scaled_err(got["f32"].eigenvalues[ki][:args.nev],
                         orc["lam"][:args.nev])
        missed |= {(ki, int(b)) for b in np.flatnonzero(~(err < args.bar))}
    log("certify-prod", f"{summ['ndofs']} dofs, f32 sweep on the card "
        f"{got['f32_wall']:.3f} s (iters/k {got['f32'].iterations.tolist()}, "
        f"Chebyshev steps {got['steps']}), complex128 oracle on the host "
        f"{got['f64_wall']:.3f} s ({got['oracle_steps']} steps); the "
        f"module's verdict: certified {summ['certified']}, worst "
        f"scale-aware {summ['worst_rel_err_scaled']:.3e}; (k index, band "
        f"index) over the bar {sorted(missed)} (let miss: "
        f"{sorted(CERT_PROD_SHARED_MISS)}, the reference's sweep misses "
        f"them too); oracle unconverged {summ['oracle_unconverged_k']}, its "
        f"band ends against the dense complex128 solve "
        f"{ {k: f'{e:.3e}' for k, e in dense.items()} } "
        f"(<{CERT_PROD_DENSE_BAR:g}; {time.perf_counter() - t0:.2f} s); "
        f"launches {counts} (expected {want})")
    if summ["oracle_unconverged_k"] or not all(
            e < CERT_PROD_DENSE_BAR for e in dense.values()):
        raise RuntimeError(f"certify-prod: oracle unconverged at "
                           f"{summ['oracle_unconverged_k']} or off the "
                           f"dense solve {dense}")
    if not np.all(np.isfinite(got["f32"].eigenvalues)):
        raise RuntimeError("certify-prod: f32 bands not finite")
    if missed - CERT_PROD_SHARED_MISS:
        raise RuntimeError(f"certify-prod: f32 bands over the bar "
                           f"{args.bar:g} at (k index, band index) "
                           f"{sorted(missed - CERT_PROD_SHARED_MISS)}")
    if counts != want or min(counts["nd M"], counts["nd AM"], counts["h1 A"],
                             counts["jacobi"]) <= 0:
        raise RuntimeError(f"certify-prod: kernel launches {counts} != the "
                           f"sweep's calls {want}")

    # The seed sweep: the same f32 path from other start blocks.
    sweep = cd._sweep(sp, eps, args.nev, torch.complex64, dev, 1e-4, 1e-6)
    lam64 = got["oracle"][1]["lam"][:args.nev]
    its, bad = [], []
    log_path("certify-prod seeds")
    torch.cuda.synchronize()
    _zero_counts()
    for seed in CERT_PROD_SEEDS:
        sweep.seed = seed
        t0 = time.perf_counter()
        r = sweep.run_warm(kc[:2])
        wall = time.perf_counter() - t0
        its += r.iterations.tolist()
        err = float(scaled_err(r.eigenvalues[1][:args.nev], lam64).max())
        res = float(np.max(r.residuals[1]))
        ok = err < args.bar and res < CERT_PROD_RESID_BAR
        log("certify-prod", f"seed {seed}: iterations "
            f"{r.iterations.tolist()}, k 1 scale-aware {err:.3e} "
            f"(<{args.bar:g}), host residual {res:.3e} "
            f"(<{CERT_PROD_RESID_BAR:g}), {wall:.2f} s"
            + ("" if ok else " FAILED"))
        if not ok:
            bad.append(seed)
    torch.cuda.synchronize()
    seed_counts = _counts()
    log_path(None)
    seed_want = launches(its, got["steps"])
    log("certify-prod", f"seed sweep of k 0-1, seeds "
        f"{CERT_PROD_SEEDS[0]}-{CERT_PROD_SEEDS[-1]}: failed {bad}; "
        f"launches {seed_counts} (expected {seed_want})")
    if bad:
        raise RuntimeError(f"certify-prod: k 1 over the bar or its "
                           f"residual over {CERT_PROD_RESID_BAR:g} at seeds "
                           f"{bad}")
    if seed_counts != seed_want:
        raise RuntimeError(f"certify-prod: seed sweep launches "
                           f"{seed_counts} != its calls {seed_want}")
    return counts, seed_counts


def phase_scale(dev):
    """``[scale]``: ``scale_demo``'s models on one card. Part single: the
    footprint fit on the headline's spectral warm solve (FCC p=4, nev 10
    in 16, the nudged Γ and X) at ``SCALE_NS``, each solve's peak device
    memory over what was allocated before it; the fitted count of (B, D,
    D) complex64 arrays within 10% of each peak, the bands within the
    analytic bar, the Jacobi launches equal to the solves' eigensolves,
    and the largest n the fit puts under 90% of the card. Part dd's
    one-card model: its 2-iteration LOBPCG and field apply at n = 8, 12,
    16, 24 (the nd kernel's "A" and "M" halves at (5, 6)), the fitted
    bytes a dof within 10% of each peak, finite norms and eigenvalues,
    nd launched, and the n it picks for four ranks. Counts set to 0
    before and read after each part. Returns (the single part's Jacobi
    launches, the dd model's launches, that n)."""
    import numpy as np
    import torch
    from bravais_tpu_torch.cli import scale_demo as sd
    from bravais_tpu_torch.eigen import jacobi_cuda

    cap = torch.cuda.get_device_properties(dev).total_memory
    log_path("scale")
    torch.cuda.synchronize()
    _zero_counts()
    fit = sd.single_fit(SCALE_NS, ORDER, BLOCK, dev)
    launches = jacobi_cuda.launches
    log_path(None)
    c = fit["count"]
    want = sum(sum(r["iterations"]) + r["k"] for r in fit["runs"])
    big = sd.largest_n(c, ORDER, cap)
    for r, d in zip(fit["runs"], fit["deviation"]):
        log("scale", f"FCC n={r['n']} p={ORDER} ({r['ndofs']} dofs), "
            f"nudged G and X: peak {r['peak'] / 2**20:.1f} MiB, model "
            f"{c * sd.array_bytes(r['n'], ORDER) / 2**20:.1f} MiB "
            f"({d:+.4f}), wall {r['wall_s']:.3f} s, iterations "
            f"{r['iterations']}, max eig err {r['err']:.3e}")
    log("scale", f"fitted {c:.4f} (B, D, D) complex64 arrays at the peak, "
        f"within {max(abs(d) for d in fit['deviation']):.4f} of each (<"
        f"{sd.FIT_BAR:g}); card {cap / 2**30:.2f} GiB: the largest n under "
        f"{sd.SINGLE_SHARE:g} of it is {big} (model "
        f"{c * sd.array_bytes(big, ORDER) / 2**30:.2f} GiB); Jacobi "
        f"launches {launches} (expected {want})")
    if not (max(abs(d) for d in fit["deviation"]) < sd.FIT_BAR
            and all(r["err"] < ERR_BAR and not r["fallbacks"]
                    for r in fit["runs"])):
        raise RuntimeError(f"scale: fit {fit['deviation']} or errors "
                           f"{[r['err'] for r in fit['runs']]}")
    if not launches == want > 0:
        raise RuntimeError(f"scale: Jacobi launches {launches} != {want}")

    log_path("scale dd")
    torch.cuda.synchronize()
    _zero_counts()
    runs = [sd.dd_step(n, ORDER, BLOCK, sd.NEV, torch.complex64, dev)
            for n in sd.DD_NS]
    dd_counts = {k: v for k, v in _counts().items() if v}
    log_path(None)
    a, b = sd.fit_linear([r["ndofs"] for r in runs],
                         [r["peak"] for r in runs])
    dev_fit = [(a * r["ndofs"] + b) / r["peak"] - 1.0 for r in runs]
    n_dd = sd.dd_choose(a, b, cap, ORDER, 4)
    one, rank = sd.dd_predict(a, b, n_dd, ORDER, 4)
    for r, d in zip(runs, dev_fit):
        log("scale", f"dd model FCC n={r['n']} ({r['ndofs']} dofs): LOBPCG "
            f"peak {r['peak'] / 2**20:.1f} MiB ({d:+.4f}), {r['lobpcg_s']:.3f}"
            f" s, apply norm {r['norm']:.6e}, nd launches {r['nd']}")
    log("scale", f"dd model: {a:.1f} bytes a dof + {b / 2**30:.4f} GiB, "
        f"within {max(map(abs, dev_fit)):.4f} of each (<{sd.FIT_BAR:g}); "
        f"four ranks: n={n_dd} ({3 * n_dd ** 3 * ORDER ** 3} dofs), one "
        f"card {one / 2**30:.2f} GiB predicted, a rank {rank / 2**30:.2f} "
        f"GiB; launches {dd_counts}")
    if not (max(map(abs, dev_fit)) < sd.FIT_BAR and all(
            r["finite"] and np.all(np.isfinite(r["eigenvalues"]))
            for r in runs) and dd_counts.get("nd A", 0) > 0
            and dd_counts.get("nd M", 0) > 0):
        raise RuntimeError(f"scale: dd model {dev_fit} or launches "
                           f"{dd_counts}")
    return launches, dd_counts, n_dd


# -- [shard]: the sharded paths over torch.distributed ---------------------

#: Ranks of ``[shard]``'s gloo group, all on the one card.
SHARD_GLOO = 2
#: ``[shard]``'s domain-decomposition checks: FCC n=8 p=4 field applies
#: on a block of 16 rows, the TRI n=8 p=4 H1 apply and a Jacobi LOBPCG
#: on it (config 5's TRI, its first k), against one rank.
DD_ROWS, DD_N, DD_NEV, DD_BLOCK, DD_TOL, DD_MAXITER = 16, 8, 6, 10, 1e-5, 400
DD_APPLY_BAR, DD_EIG_BAR = 1e-5, 1e-5


def _recording(sweep):
    """Record the iterations of every k-batched solve ``sweep`` makes,
    a shard's padding included (the launches follow the batch's
    slowest k): returns (the list of iteration arrays, undo)."""
    import numpy as np
    calls, orig = [], sweep._batched_solve

    def batched():
        bsolve = orig()

        def solve(*args):
            r, support = bsolve(*args)
            calls.append(np.reshape(np.asarray(r.iterations), -1))
            return r, support
        return solve
    sweep._batched_solve = batched
    return calls, lambda: setattr(sweep, "_batched_solve", orig)


def _batch_launches(calls, sweep, steps):
    """The launches of the recorded k-batched solves
    (``expected_batched_launches`` of each, summed)."""
    want = dict.fromkeys(("nd M", "nd AM", "nd A", "h1 A", "h1 AM", "h1 M",
                          "jacobi"), 0)
    for its in calls:
        for key, v in expected_batched_launches(its, sweep, steps).items():
            want[key] += v
    return want


def shard_sweep_paths(dev, jobs):
    """[(tag, sweep, Chebyshev steps or None, run(sweep, mesh) → result,
    the same problem on one rank run(sweep, group size) → result,
    check(result) → (text, ok))]: the
    FCC headline through ``run_warm_sharded`` and ``run``, config 5's TRI
    and FCC on both engines through ``run`` (what ``config5_all14
    --shard`` calls) and config 3's field path through ``run``. ``jobs``
    "nccl" keeps the headline's ``run`` only."""
    from bravais_tpu_torch.cli.config5_all14 import build, max_rel_err

    lat, kc, _, sw = headline(dev)
    head = analytic_check(kc, lat)
    paths = [("headline run", sw, None, lambda s, m: s.run(kc, mesh=m),
              lambda s, P: s.run(kc), head)]
    if jobs == "nccl":
        return paths
    paths.insert(0, ("headline run_warm_sharded", sw, None,
                     lambda s, m: s.run_warm_sharded(kc, m),
                     lambda s, P: s.run_warm_sharded(kc, segments=P),
                     head))
    for name in ("TRI", "FCC"):
        for engine in ("spectral", "field"):
            lat5, kc5, _, sw5 = build(name, C5_N, C5_P, C5_NEV, C5_TOL,
                                      C5_MAXITER, engine, dev)
            bar = C5_SPECTRAL_BAR if engine == "spectral" else C5_FIELD_BAR

            def check(res, lat5=lat5, kc5=kc5, bar=bar):
                err = max_rel_err(lat5, kc5, res.eigenvalues)
                return f"max rel err {err:.3e} (<{bar:g})", err < bar
            paths.append((f"config5 {name} {engine}", sw5, None,
                          lambda s, m, kc5=kc5: s.run(kc5, mesh=m),
                          lambda s, P, kc5=kc5: s.run(kc5), check))
    _, kc3, op3, sw3 = dielectric(dev)
    paths.append(("config3 run", sw3, op3.cheby_steps(),
                  lambda s, m: s.run(kc3, mesh=m), lambda s, P: s.run(kc3),
                  diel_check(diel_oracle(kc3, op3))))
    return paths


def shard_sweeps(dev, mesh, jobs, out):
    """Each sharded sweep of ``shard_sweep_paths`` with every count set to
    0 just before and read just after; its launches on this rank must
    equal its share's calls (the recorded batches). Rank 0 then runs the
    same problem on one rank without a mesh and holds the sharded result
    to it: iterations per k within ±1 (the batch shape moves the float32
    reductions, as in ``[batched]``) and bands within 1e-6; every rank
    holds it to the path's own gates."""
    import numpy as np
    import torch

    tag_log = f"shard r{mesh.rank}"
    for tag, sweep, steps, run, one_rank, check in shard_sweep_paths(dev,
                                                                     jobs):
        mesh.barrier()
        torch.cuda.synchronize()
        log_path(f"shard {mesh.backend} {tag}")
        calls, undo = _recording(sweep)
        _zero_counts()
        t0 = time.perf_counter()
        res = run(sweep, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts()
        undo()
        log_path(None)
        want = _batch_launches(calls, sweep, steps)
        text, ok = check(res)
        rec = {"wall_s": wall, "iterations": res.iterations.tolist(),
               "launches": got, "expected": want,
               "batches": [c.tolist() for c in calls]}
        log(tag_log, f"{tag}: {len(res.iterations)} k over {mesh.size} "
            f"ranks ({mesh.backend}), wall {wall:.3f} s ({overlap(res)}), "
            f"iterations {res.iterations.tolist()}, this rank's batches "
            f"{rec['batches']}, launches {got} (its share's calls {want});"
            f" {text}")
        if not ok:
            raise RuntimeError(f"shard {tag}: a gate failed: {text}")
        if got != want or got["jacobi"] <= 0:
            raise RuntimeError(f"shard {tag}: launches {got} != the share's"
                               f" calls {want}")
        if mesh.rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = one_rank(sweep, mesh.size)
            torch.cuda.synchronize()
            rec["one_rank_wall_s"] = time.perf_counter() - t0
            gap = np.abs(one.iterations - res.iterations)
            diff = band_errors(res.eigenvalues, one.eigenvalues)
            rec.update(one_rank_iterations=one.iterations.tolist(),
                       band_diff=diff)
            log(tag_log, f"{tag} on one rank: wall "
                f"{rec['one_rank_wall_s']:.3f} s, iterations "
                f"{one.iterations.tolist()}: the same at "
                f"{int(np.sum(gap == 0))} of {len(gap)} k, ±1 at "
                f"{int(np.sum(gap == 1))}; bands max diff {diff:.3e} "
                f"(<1e-6)")
            if np.any(gap > 1) or not diff < 1e-6:
                raise RuntimeError(f"shard {tag}: differs from one rank")
        out["paths"][tag] = rec


def shard_dd(dev, mesh, jobs, out):
    """Domain decomposition over the group: the FCC n=8 p=4 field applies
    (``CurlCurlSlab``, A and the fused pair, the nd kernel), the TRI n=8
    p=4 H1 apply (``HelmholtzSlab``, the h1 kernel) and (``jobs`` "all")
    a Jacobi LOBPCG on it with the Grams reduced over the group, each
    with every count set to 0 just before and read just after (one launch
    an apply; the LOBPCG's those of ``expected_h1_launches``). Each slab is
    held against the one-rank apply (relative to its largest entry,
    < ``DD_APPLY_BAR``), the eigenvalues against rank 0's one-rank LOBPCG
    (< ``DD_EIG_BAR`` relative) and the analytic bands (config 5's
    matrix-free bar)."""
    import numpy as np
    import torch
    from bravais_tpu_torch.cli.config5_all14 import (KFRAC, PARAMS,
                                                     max_rel_err)
    from bravais_tpu_torch.eigen.lobpcg import PROD_RR_TOL, lobpcg
    from bravais_tpu_torch.eigen.precond import jacobi
    from bravais_tpu_torch.lattices import make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.curlcurl import CurlCurlSlab
    from bravais_tpu_torch.operators.helmholtz import (BlochHelmholtz,
                                                       HelmholtzSlab)
    from bravais_tpu_torch.spaces.h1 import H1Space

    tag_log = f"shard r{mesh.rank}"
    gen = torch.Generator(device=dev).manual_seed(21)

    def block(shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev,
                           generator=gen)

    def held(tag, slab_op, full, want, fn, u):
        slab = slab_op.take(u).contiguous()
        mesh.barrier()
        torch.cuda.synchronize()
        log_path(f"shard {mesh.backend} dd {tag}")
        _zero_counts()
        t0 = time.perf_counter()
        got = fn(slab_op, slab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
        log_path(None)
        ref = fn(full, u)
        got, ref = ((got,), (ref,)) if torch.is_tensor(got) else (got, ref)
        err = max(float((g - slab_op.take(r)).abs().max()
                        / r.abs().max()) for g, r in zip(got, ref))
        log(tag_log, f"dd {tag}: slab {tuple(slab.shape)} of "
            f"{tuple(u.shape)}, transport {mesh.transport(slab)}, wall "
            f"{wall * 1e3:.3f} ms, launches {counts} (expected {want}), "
            f"max rel err against one rank {err:.3e} "
            f"(<{DD_APPLY_BAR:g})")
        if counts != want or not err < DD_APPLY_BAR:
            raise RuntimeError(f"dd {tag}: launches {counts} or error "
                               f"{err:.3e}")
        out["dd"][tag] = {"wall_ms": wall * 1e3, "max_rel_err": err,
                          "launches": counts}

    out["dd"] = {}
    _, kc4, op4 = fcc_problem(dev)
    cs = CurlCurlSlab(op4, mesh)
    u4 = block((DD_ROWS,) + tuple(op4.space.field_shape))
    held("fcc A", cs, op4, {"nd A": 1}, lambda o, x: o.apply_A(x, kc4[5]),
         u4)
    held("fcc AM", cs, op4, {"nd AM": 1},
         lambda o, x: o.apply_AM(x, kc4[5]), u4)
    if jobs == "nccl":
        return
    lat = make_lattice("TRI", **PARAMS["TRI"])
    op = BlochHelmholtz(H1Space.make(PeriodicGrid.make(lat, DD_N), C5_P),
                        dtype=torch.complex64, device=dev)
    k = lat.k_cart(KFRAC[0])
    hs = HelmholtzSlab(op, mesh)
    held("tri A", hs, op, {"h1 A": 1}, lambda o, x: o.apply_A(x, k),
         block((DD_ROWS,) + tuple(op.space.dof_shape)))

    X0 = block((DD_BLOCK,) + tuple(op.space.dof_shape))

    def solve(o, X, **kw):
        return lobpcg(lambda x: o.apply_A(x, k), o.apply_M, X, DD_NEV,
                      maxiter=DD_MAXITER, tol=DD_TOL,
                      precond=jacobi(o.diag_A(k)),
                      AM=lambda x: o.apply_AM(x, k), rr_tol=PROD_RR_TOL,
                      **kw)
    mesh.barrier()
    torch.cuda.synchronize()
    log_path(f"shard {mesh.backend} dd tri lobpcg")
    _zero_counts()
    t0 = time.perf_counter()
    r = solve(hs, hs.take(X0).contiguous(), reduce=mesh.all_reduce_)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k_: v for k_, v in _counts().items() if v}
    log_path(None)
    its = int(r.iterations)
    want = {"h1 M": 1, "h1 AM": its + 2 * -(-its // 16), "jacobi": its + 1}
    lam = r.eigenvalues.double().cpu().numpy()
    err = max_rel_err(lat, k[None], lam[None])
    one = None
    if mesh.rank == 0:
        t0 = time.perf_counter()
        r1 = solve(op, X0)
        torch.cuda.synchronize()
        one = (r1.eigenvalues.double().cpu().numpy().tolist(),
               int(r1.iterations), time.perf_counter() - t0)
    lam1, its1, wall1 = mesh.broadcast_object(one)
    diff = float(np.max(np.abs(lam - lam1) / np.abs(lam1)))
    log(tag_log, f"dd tri lobpcg: {op.space.ndofs} dofs over {mesh.size} "
        f"ranks (transport {mesh.transport(X0)}), Jacobi, {its} iterations "
        f"in {wall:.3f} s (one rank: {its1} in {wall1:.3f} s), launches "
        f"{counts} (expected {want}), eigenvalues max rel diff from one "
        f"rank {diff:.3e} (<{DD_EIG_BAR:g}), max rel err against the "
        f"analytic bands {err:.3e} (<{C5_FIELD_BAR:g})")
    if counts != want or not diff < DD_EIG_BAR or not err < C5_FIELD_BAR:
        raise RuntimeError("dd tri lobpcg: a gate failed")
    out["dd"]["tri lobpcg"] = {"wall_s": wall, "iterations": its,
                               "one_rank_wall_s": wall1,
                               "one_rank_iterations": its1,
                               "eig_diff": diff, "eig_err": err,
                               "launches": counts}


def shard_rank(out_dir, backend, jobs):
    """One rank of ``[shard]``'s group (``--shard-rank``): the group from
    the launcher's environment (``kpoint_mesh``), the rank's card
    ``cuda:{LOCAL_RANK mod the card count}``, the kernels loaded (built
    by the parent, or here under ``torchrun``), every kernel call logged
    by shape; the sharded sweeps (``shard_sweeps``) and the domain
    decomposition (``shard_dd``), then every logged shape held against
    the plain versions (``phase_launched``). Writes
    ``OUT/rank<r>.json``."""
    import torch
    sys.path.insert(0, str(REPO))
    import bravais_tpu_torch  # noqa: F401  (precision flags)
    from bravais_tpu_torch.parallel.mesh import kpoint_mesh
    from bravais_tpu_torch.utils import cuda_build

    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    mesh = kpoint_mesh(backend, dev)
    out = {"rank": mesh.rank, "size": mesh.size, "backend": backend,
           "device": str(dev), "paths": {}, "ok": False}
    try:
        cuda_build.build_all()
        install_launch_log()
        log(f"shard r{mesh.rank}", f"rank {mesh.rank} of {mesh.size} "
            f"({backend}) on {dev}, {torch.cuda.get_device_name(dev)}; k "
            f"rows gathered with all_gather_object over {backend}; halo "
            f"and reductions of CUDA tensors: "
            f"{mesh.transport(torch.zeros(1, device=dev))}")
        shard_sweeps(dev, mesh, jobs, out)
        shard_dd(dev, mesh, jobs, out)
        out["launched_err"] = phase_launched(dev)
        out["shapes"] = {
            f"{rec['path']} r{mesh.rank}: {shape_label(kernel, shape)}":
            [kernel, rec["calls"]] for (kernel, shape), rec in LAUNCHED.items()}
        mesh.barrier()
        out["ok"] = True
    finally:
        Path(out_dir, f"rank{mesh.rank}.json").write_text(json.dumps(out))
        mesh.close()
    return 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_shard(dev):
    """``[shard]``: the sharded paths in child processes of this script
    (``--shard-rank``), as ``torchrun`` starts them (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR=localhost, MASTER_PORT): ``SHARD_GLOO`` gloo
    ranks on the one card (NCCL refuses two ranks on one device; gloo
    moves no CUDA tensor, so the halo and the reductions go through
    explicit host copies, and the transport is printed), then
    ``torch.cuda.device_count()`` NCCL ranks, one card each, on the
    headline's ``run`` and the field applies. Every rank must pass;
    returns {backend: [each rank's record]}."""
    import tempfile

    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    groups = {}
    for backend, size, jobs in (("gloo", SHARD_GLOO, "all"),
                                ("nccl", torch.cuda.device_count(), "nccl")):
        with tempfile.TemporaryDirectory() as tmp:
            port = str(_free_port())
            cmd = [sys.executable, str(REPO / "chip_smoke.py"),
                   "--shard-rank", tmp, "--backend", backend, "--jobs", jobs]
            log("shard", f"{size} {backend} rank(s): {' '.join(cmd[1:])}")
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                cmd, cwd=REPO, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(size),
                         LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                         MASTER_PORT=port)) for r in range(size)]
            try:
                logs = [p.communicate(timeout=600)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.perf_counter() - t0
            for r, text in enumerate(logs):
                for line in text.splitlines():
                    print(f"  {line}" if r else line, flush=True)
            recs = []
            for r, p in enumerate(procs):
                f = Path(tmp, f"rank{r}.json")
                rec = json.loads(f.read_text()) if f.exists() else {}
                if p.returncode or not rec.get("ok"):
                    raise RuntimeError(f"shard {backend} rank {r} exited "
                                       f"{p.returncode}: {logs[r][-3000:]}")
                recs.append(rec)
        log("shard", f"{backend}: {size} rank(s) passed in {wall:.1f} s "
            f"(process start, stencils and the one-rank runs included)")
        groups[backend] = recs
    return groups


# -- the four-card mode (``--four``) -----------------------------------------

#: The CLI problem of ``--four``'s ``--shard`` runs (the headline's).
FOUR_CLI_ARGS = ("--lattice", "FCC", "--problem", "maxwell", "--engine",
                 "spectral", "--n", str(N_ELEM), "--p", str(ORDER), "--nk",
                 str(NK), "--nev", str(NEV))


def torchrun(nproc, args, timeout=900):
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc ARGS`` from the repository (NCCL ranks, one card each); echoes
    its output and raises unless it exits 0. Returns (wall s, stdout)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *args]
    log("four", " ".join(cmd[1:]))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, text=True, capture_output=True,
                       timeout=timeout)
    wall = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        print(f"  {line}", flush=True)
    if r.returncode:
        raise RuntimeError(f"{' '.join(args)} exited {r.returncode}: "
                           f"{r.stderr[-4000:]}")
    return wall, r.stdout


def four_shard(nproc):
    """Phase 13's ``[shard]`` jobs on four ranks: ``--shard-rank`` under
    torchrun, every job of ``shard_sweeps`` and ``shard_dd`` on NCCL
    ranks, one card each; every rank must pass."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        wall, _ = torchrun(nproc, [str(REPO / "chip_smoke.py"),
                                   "--shard-rank", tmp, "--backend", "nccl",
                                   "--jobs", "all"])
        recs = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(nproc)]
    if not all(rec.get("ok") for rec in recs):
        raise RuntimeError("four: a [shard] rank failed")
    log("four", f"[shard] jobs: {nproc} NCCL ranks passed in {wall:.1f} s")


def four_cli(nproc):
    """The CLI's ``--shard`` in both modes (``--mode warm``:
    ``run_warm_sharded``; ``batched``: ``run`` with the mesh) under
    torchrun, against the same problem on one card: every band table
    finite, within ``ERR_BAR`` of the analytic bands at the k the CLI
    solved, and within 1e-6 relative of the one-card table."""
    import tempfile

    import numpy as np
    from bravais_tpu_torch.lattices import kpath, make_lattice

    lat = make_lattice(LATTICE)
    kc = nudged(lat, kpath(lat, npts=NK).k_cart).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        one = Path(tmp, "one")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "bravais_tpu_torch",
                            *FOUR_CLI_ARGS, "--out", str(one)], cwd=REPO,
                           text=True, capture_output=True, timeout=900)
        if r.returncode:
            raise RuntimeError(f"four: one-card CLI exited {r.returncode}: "
                               f"{r.stderr[-3000:]}")
        walls = {"one card": time.perf_counter() - t0}
        base = np.load(one / "bands.npz")["eigenvalues"]
        for mode in ("warm", "batched"):
            out = Path(tmp, mode)
            walls[mode], _ = torchrun(nproc, [
                "-m", "--", "bravais_tpu_torch", *FOUR_CLI_ARGS, "--shard",
                "--mode", mode, "--out", str(out)])
            lam = np.load(out / "bands.npz")["eigenvalues"]
            err = max(eig_error(lam[i], lat, k, mmax=3, mult=2)
                      for i, k in enumerate(kc.astype(np.float64)))
            diff = float(np.max(np.abs(lam - base) / np.abs(base)))
            log("four", f"CLI --shard --mode {mode}, {nproc} ranks: "
                f"{walls[mode]:.2f} s (one card {walls['one card']:.2f} s; "
                f"process start, kernel load and stencils included), max "
                f"eig err {err:.3e} (<{ERR_BAR:g}), max rel diff from one "
                f"card {diff:.3e} (<1e-6)")
            if not (lam.shape == base.shape and np.all(np.isfinite(lam))
                    and err < ERR_BAR and diff < 1e-6):
                raise RuntimeError(f"four: CLI --shard --mode {mode}")


def dd_slab_times(dev, n, nproc, launches=None):
    """The nd kernel at part dd's slab shape (16 rows of n³/``nproc``
    elements of FCC n, (l, q) = (5, 6)) held against the plain version
    on a random block (``hold_apply``), and its "A" and "M" halves (the
    LOBPCG's) timed as ``kernel_times`` times a shape, with ``launches``
    (by half) on the dd run, where there was one: {shape: record}."""
    import torch
    from bravais_tpu_torch.cli import scale_demo as sd
    from bravais_tpu_torch.operators import nd_apply
    from bravais_tpu_torch.utils.timing import cuda_ms

    _, op = sd.fcc_operator(n, ORDER, torch.complex64, dev)
    c = op.nd_consts().elements(0, n // nproc * n * n)
    del op
    gen = torch.Generator(device=dev).manual_seed(17)
    ue = torch.randn((DD_ROWS * c.nelem, c.ndof), generator=gen,
                     dtype=torch.complex64, device=dev)
    err = hold_apply(f"nd dd slab n={n} rows={DD_ROWS} x {c.nelem} "
                     f"elements (l, q) = ({c.l}, {c.q})",
                     lambda u, w: nd_apply.nedelec_apply(u, c, w),
                     lambda u, w: nd_apply.nedelec_apply_plain(u, c, w), ue)
    times = {}
    for want in ("A", "M"):
        b_ms, b_by = bound(*nd_apply.work(ue.shape[0], c, want))
        times[f"dd slab n={n}: rows {DD_ROWS} x {c.nelem} elements "
              f"{want}"] = {
            "device_ms": device_ms(
                lambda: nd_apply.nedelec_apply(ue, c, want), reps=5),
            "ms": cuda_ms(lambda: nd_apply.nedelec_apply(ue, c, want)),
            "plain_ms": cuda_ms(
                lambda: nd_apply.nedelec_apply_plain(ue, c, want), reps=2,
                warmup=1),
            "library_ms": None, "library_device_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            **({"launches": launches[want]} if launches else {})}
    log_times({"nd": times})
    return times


def four_dd(dev, nproc):
    """``scale_demo --part dd`` under torchrun, then ``dd_slab_times`` at
    its n with rank 0's launches. Returns the nd records."""
    wall, out = torchrun(nproc, ["-m", "--", "bravais_tpu_torch.cli."
                                 "scale_demo", "--part", "dd"])
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    n = next(r["n"] for r in recs if "n" in r)
    peak = next(r for r in recs if r["metric"].startswith("dof-sharded over"))
    launches = peak["nd_launches"][0]
    log("four", f"scale_demo --part dd: n={n} over {nproc} ranks in "
        f"{wall:.1f} s; rank 0's nd launches {launches}")
    return dd_slab_times(dev, n, nproc, launches)


def phase_four(dev):
    """``--four``: the records that exist only across cards, on every
    card of the machine (at least 4) under ``torch.distributed.run``:
    phase 13's ``[shard]`` jobs, the CLI's ``--shard`` in both modes, and
    ``scale_demo --part dd`` with the nd kernel at its slab's shape."""
    import torch
    nproc = torch.cuda.device_count()
    if nproc < 4:
        raise RuntimeError(f"--four needs 4 cards, found {nproc}")
    four_shard(nproc)
    four_cli(nproc)
    return four_dd(dev, nproc)


def cli_twice(tag, args):
    """The CLI in a subprocess as a user starts it (``args``, a run
    directory added), then again with ``--resume``. Gates: both exit 0;
    the first solves every k and the second none ("all k-points already
    finished"); ``bands.npz`` holds finite bands at every k within 1e-6
    (bench.py's measure) of the analytic bands at the k the CLI solved
    (Γ nudged, rounded to float32). Returns (the first run's wall in
    seconds, its stdout, iterations per k, the errors per k, the
    resume's wall)."""
    import tempfile

    import numpy as np
    from bravais_tpu_torch.lattices import kpath, make_lattice

    lat = make_lattice(args[args.index("--lattice") + 1])
    nk = int(args[args.index("--nk") + 1])
    path = (None if "--path" not in args else
            [args[args.index("--path") + 1].split(",")])
    kc = nudged(lat, kpath(lat, npts=nk, path=path).k_cart)
    kc = kc.astype(np.float32).astype(np.float64)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "run"
        cmd = [sys.executable, "-m", "bravais_tpu_torch", *args,
               "--out", str(out)]
        log(tag, " ".join(cmd[1:]))
        # The CLI as a user starts it: without this script's BLAS caps
        # (the package sets its own).
        env = {k: v for k, v in os.environ.items()
               if k not in ("OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}
        runs = []
        for extra in ((), ("--resume",)):
            t0 = time.perf_counter()
            r = subprocess.run(cmd + list(extra), cwd=REPO, text=True,
                               capture_output=True, timeout=900, env=env)
            runs.append((time.perf_counter() - t0, r))
            for line in r.stdout.splitlines():
                log(tag, line)
            if r.returncode:
                raise RuntimeError(f"{tag}: cli{' '.join(extra)} exited "
                                   f"{r.returncode}: {r.stderr[-3000:]}")
        solved = [json.loads(line) for line in runs[0][1].stdout.splitlines()
                  if line.startswith("{")]
        resumed = runs[1][1].stdout
        dat = np.load(out / "bands.npz")
        finished = json.loads((out / "manifest.json").read_text())["finished"]
    lam = dat["eigenvalues"]
    iters = [s["iters"] for s in sorted(solved, key=lambda s: s["k_index"])]
    nev = int(args[args.index("--nev") + 1])
    if sorted(s["k_index"] for s in solved) != list(range(nk)):
        raise RuntimeError(f"{tag}: solved k "
                           f"{[s['k_index'] for s in solved]}")
    if ("all k-points already finished" not in resumed
            or any(line.startswith("{") for line in resumed.splitlines())):
        raise RuntimeError(f"{tag}: --resume recomputed: {resumed[-2000:]}")
    if finished != list(range(nk)) or lam.shape != (nk, nev) \
            or not np.all(np.isfinite(lam)):
        raise RuntimeError(f"{tag}: bands.npz {lam.shape}, finished "
                           f"{finished}")
    errs = [eig_error(lam[i], lat, k, mmax=3, mult=2)
            for i, k in enumerate(kc)]
    if not max(errs) < ERR_BAR:
        raise RuntimeError(f"{tag}: eigenvalue errors {errs}")
    return runs[0][0], runs[0][1].stdout, iters, errs, runs[1][0]


def phase_cli(dev):
    """Config 4's BCC half through the CLI (``CLI_ARGS``), run and resumed
    with ``cli_twice``'s gates. Returns the wall of the first run in
    seconds."""
    import numpy as np

    wall, _, iters, errs, wall2 = cli_twice("cli", CLI_ARGS)
    log("cli", f"BCC field via the CLI: {wall:.2f} s (process start, "
        f"build load and stencils included), iters/k {np.mean(iters):.2f} "
        f"{iters}, max eig err {max(errs):.3e} (<{ERR_BAR:g}) at every k "
        f"[{', '.join(f'{e:.2e}' for e in errs)}]; --resume: exit 0 in "
        f"{wall2:.2f} s, nothing recomputed (nk {len(iters)}, cut from 16 "
        f"for time)")
    return wall


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shard-rank", metavar="OUT",
                    help="run as one rank of [shard]'s group (the group "
                    "from the launcher's environment; results to OUT)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl")
    ap.add_argument("--jobs", choices=("all", "nccl"), default="all")
    ap.add_argument("--four", action="store_true",
                    help="the four-card records instead of the one-card "
                    "smoke test: [shard]'s jobs, the CLI's --shard and "
                    "scale_demo --part dd under torch.distributed.run")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.shard_rank:
        return shard_rank(args.shard_rank, args.backend, args.jobs)
    sys.path.insert(0, str(REPO))
    import bravais_tpu_torch  # noqa: F401  (precision flags)
    from bravais_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi:")
    print(smi, flush=True)

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    log("build", ", ".join(lib.name for lib in libs.values())
        + f" in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    ptxas = ptxas_report(libs)
    if args.four:
        times = phase_four(dev)
        print(json.dumps({"kernels": [{
            "name": "nedelec_apply", "route": "cuda",
            "source": "bravais_tpu_torch/csrc/nd_apply.cu",
            "replaces": "bravais_tpu/operators/pallas/nd_apply.py:134",
            "shapes": times}]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    install_launch_log()

    jac_err, jac_rel = phase_kernels(dev)
    setup3 = dielectric(dev)
    rods = rods_setup(dev)
    setup4 = fcc_problem(dev)
    for label, T in (("L-twin config 3", ltwin_blocks(setup3[2])),
                     ("L-twin FCC field", ltwin_blocks(setup4[2])),
                     ("batched L-twin config 3, 16 k",
                      ltwin_blocks(setup3[2], 16)),
                     ("batched L-twin FCC field, 8 k",
                      ltwin_blocks(setup4[2], 8)),
                     ("batched RR", np.stack([rand_herm(48, 300 + i)
                                              for i in range(16)])),
                     ("batched whitening, 16 k",
                      np.stack([rand_herm(16, 400 + i) for i in range(16)])),
                     ("batched whitening, 8 k",
                      np.stack([rand_herm(16, 400 + i) for i in range(8)]))):
        e_abs, e_rel = phase_jacobi_blocks(dev, label, T)
        jac_err, jac_rel = max(jac_err, e_abs), max(jac_rel, e_rel)
    op5 = config5_operator(dev)
    nd_err, h1_err = phase_elements(dev, setup3[2], rods, setup4[2], op5)
    head = headline(dev)
    # Every kernel call of the main paths is logged by its shape from
    # here to ``[certify]``'s end, and held against the plain versions
    # after (``phase_launched``).
    log_path("sweep headline")
    fcc_launches, sweep_its = phase_sweep(dev, head)
    log_path("diel config 3")
    diel, _, diel_res = phase_dielectric(dev, setup3)
    scalar_set = scalar_setup(dev)
    log_path("scalar config 1")
    scalar, _ = phase_scalar(dev, scalar_set)
    log_path("rods2d config 2")
    rods2d, _ = phase_rods2d(dev, rods)
    te_set = te_setup(dev)
    log_path("te")
    te, _ = phase_te(dev, te_set)
    nd56 = any(r["entry"].startswith("nd_apply_kernel<5, 6")
               for r in ptxas["nd_apply"])
    log_path("fcc-field")
    fcc_field, _ = phase_fcc_field(
        dev, setup4, "its <5, 6> instantiation" if nd56
        else "the runtime-extent template")
    log_path(None)
    phase_cli(dev)
    log_path("config5")
    c5 = phase_config5(dev)
    batched, batched_runs = phase_batched(dev, head, setup3, rods, setup4)
    chain = phase_chain(dev, head, sweep_its, setup3, diel_res, batched_runs)
    gmg = phase_gmg(dev, setup3)
    cg = phase_cg(dev, setup3)
    cert = phase_certify(dev)
    log_path(None)
    cert_prod, cert_seeds = phase_certify_prod(dev)
    scale, scale_dd, n_dd = phase_scale(dev)
    shard = phase_shard(dev)
    launched_err = phase_launched(dev)
    # The profiler's phases come last, so that the launch-bound sweeps
    # run in a process it has not traced.
    phase_one_operation(dev, setup3[2], setup4[2])
    # Before ``kernel_times``, whose last trace can leave the process's
    # later traces empty.
    torch.cuda.empty_cache()
    dd_times = dd_slab_times(dev, n_dd, 4)
    new_runs = [(key, rec) for key, rec in LAUNCHED.items()
                if rec["path"].endswith(f"chunk={BATCH_CHUNK}")
                or rec["path"].startswith(("certify", "gmg", "cg", "chain"))]
    times = kernel_times(dev, setup3[2], rods, op4=setup4[2], op5=op5,
                         batched=True, logged=new_runs)
    log_times(times)
    times["nd"].update(dd_times)
    jac, nd_rec, h1_rec = (
        {"name": name, "route": "cuda",
         "source": f"bravais_tpu_torch/csrc/{src}.cu",
         "replaces": replaces,
         "max_abs_err": max(err, launched_err[kernel]),
         **{k: v for k, v in times[kernel][main].items()
            if k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "library_device_ms")},
         "shapes": times[kernel],
         "main_path_shapes": {
             f"{rec['path']}: {shape_label(kernel, shape)}": rec["calls"]
             for (kk, shape), rec in LAUNCHED.items() if kk == kernel}}
        for name, src, replaces, err, kernel, main in (
            ("jacobi_eigh", "jacobi_eigh",
             "bravais_tpu/eigen/pallas_jacobi.py:155", jac_err, "jacobi",
             "rr 48x48"),
            ("nedelec_apply", "nd_apply",
             "bravais_tpu/operators/pallas/nd_apply.py:134", nd_err, "nd",
             "rows 16 AM"),
            ("helmholtz_apply", "h1_apply",
             "bravais_tpu/operators/pallas/h1_apply.py:128", h1_err, "h1",
             "rows 16 k=0 A")))
    # Jacobi's eigenvalue error as its gates measure it, over max(|λ|,
    # 1e-3 max|λ|) (< 5e-4): on a large-shift matrix the absolute error
    # above grows with the shift.
    jac["max_rel_err"] = max(jac_rel, launched_err["jacobi_rel"])
    jac["launches_by_path"] = {
        "fcc_headline": fcc_launches, "config3_field": diel["jacobi"],
        "config1_scalar": scalar["jacobi"], "config2_rods2d": rods2d["jacobi"],
        "te_air_holes": te["jacobi"], "fcc_field": fcc_field["jacobi"],
        "config5_spectral": c5["spectral"]["jacobi"],
        "config5_field": c5["field"]["jacobi"],
        **{f"batched_{path}": got["jacobi"] for path, got in batched.items()},
        **{f"certify_eps{e:g}": got["jacobi"] for e, got in cert.items()},
        **{f"gmg_{path}": got["jacobi"] for path, got in gmg.items()},
        **{f"cg_{path}": got["jacobi"] for path, got in cg.items()},
        **{f"chain_{path}": got["jacobi"] for path, got in chain.items()},
        "certify_prod": cert_prod["jacobi"],
        "certify_prod_seeds": cert_seeds["jacobi"], "scale": scale,
        "scale_dd_model": scale_dd.get("jacobi", 0)}
    # [shard]: each rank's launches on each sharded path, and the shapes
    # its launch log held against the plain versions.
    shard_runs = [(f"shard_{backend}_r{rec['rank']}_{tag.replace(' ', '_')}",
                   got["launches"])
                  for backend, recs in shard.items() for rec in recs
                  for part in ("paths", "dd")
                  for tag, got in rec.get(part, {}).items()]
    for key, got in shard_runs:
        jac["launches_by_path"][key] = got.get("jacobi", 0)
    for rec_k, kernel in ((jac, "jacobi"), (nd_rec, "nd"), (h1_rec, "h1")):
        for recs in shard.values():
            for rec in recs:
                rec_k["max_abs_err"] = max(rec_k["max_abs_err"],
                                           rec["launched_err"][kernel])
                if kernel == "jacobi":
                    jac["max_rel_err"] = max(
                        jac["max_rel_err"], rec["launched_err"]["jacobi_rel"])
                rec_k["main_path_shapes"].update(
                    {label: calls for label, (kk, calls)
                     in rec["shapes"].items() if kk == kernel})
    jac["launches"] = sum(jac["launches_by_path"].values())
    nd_rec["launches_by_path"] = {
        path: {w: got.get(f"nd {w}", 0) for w in ("M", "AM", "A")}
        for path, got in (("config3_field", diel), ("fcc_field", fcc_field),
                          ("batched_config3", batched["config3"]),
                          ("batched_config3_chunk4",
                           batched["config3_chunk4"]),
                          ("batched_fcc_field", batched["fcc_field"]),
                          *((f"certify_eps{e:g}", got)
                            for e, got in cert.items()),
                          *((f"gmg_{path}", got)
                            for path, got in gmg.items()),
                          *((f"cg_{path}", got) for path, got in cg.items()),
                          *((f"chain_{path}", got)
                            for path, got in chain.items()
                            if path.startswith("config3")),
                          ("certify_prod", cert_prod),
                          ("certify_prod_seeds", cert_seeds),
                          ("scale_dd_model", scale_dd),
                          *((key, got) for key, got in shard_runs
                            if any(got.get(f"nd {w}") for w in
                                   ("M", "AM", "A"))))}
    nd_rec["launches_by_mode"] = {
        mode: sum(v[mode] for v in nd_rec["launches_by_path"].values())
        for mode in ("M", "AM", "A")}
    nd_rec["launches"] = sum(nd_rec["launches_by_mode"].values())
    h1_rec["launches_by_path"] = {
        "config3_field": diel["h1"],
        "config2_rods2d": {w: rods2d[f"h1 {w}"] for w in ("A", "AM", "M")},
        "te_air_holes": {w: te[f"h1 {w}"] for w in ("A", "AM", "M")},
        "config5_field": {w: c5["field"][f"h1 {w}"]
                          for w in ("A", "AM", "M")},
        **{f"batched_{path}": {w: batched[path][f"h1 {w}"]
                               for w in ("A", "AM", "M")}
           for path in ("config3", "config3_chunk4", "config2")},
        **{f"certify_eps{e:g}": {w: got[f"h1 {w}"] for w in ("A", "AM", "M")}
           for e, got in cert.items()},
        **{f"{tag}_{path}": {w: got[f"h1 {w}"] for w in ("A", "AM", "M")}
           for tag, runs in (("gmg", gmg), ("cg", cg), ("chain", chain))
           for path, got in runs.items() if tag != "chain"
           or path.startswith("config3")},
        **{path: {w: got[f"h1 {w}"] for w in ("A", "AM", "M")}
           for path, got in (("certify_prod", cert_prod),
                             ("certify_prod_seeds", cert_seeds))},
        **{key: {w: got.get(f"h1 {w}", 0) for w in ("A", "AM", "M")}
           for key, got in shard_runs
           if any(got.get(f"h1 {w}") for w in ("A", "AM", "M"))}}
    h1_rec["launches"] = diel["h1"] + sum(
        v for path in (rods2d, te, c5["field"], batched["config3"],
                       batched["config3_chunk4"], batched["config2"],
                       *cert.values(), *gmg.values(), *cg.values(),
                       *chain.values(), cert_prod, cert_seeds)
        for key, v in path.items() if key.startswith("h1")) + sum(
        v for _, got in shard_runs for key, v in got.items()
        if key.startswith("h1"))
    print(json.dumps({"kernels": [jac, nd_rec, h1_rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
