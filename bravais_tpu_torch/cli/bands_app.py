"""Band-structure CLI — port of ``bravais_tpu/cli/bands_app.py``.

    python -m bravais_tpu_torch --lattice SQR --problem tm \
        --eps-in 8.9 --radius 0.2 --n 16 --p 3 --nk 48 --nev 8 \
        --out results/sq_tm

Wires config -> lattice -> mesh -> operator -> k-sweep -> band table
(+ checkpoint/resume, one JSON line per k, optional plot and mode
dumps). ``--mode warm`` (the default) solves the k-points one after the
other, each from the last; ``--mode warm-chain`` does too, in chains of
``--chain`` k whose preconditioners come from ``--pc-mode`` ("per-k",
"chain-mid", "batched" or "batched-setup": ``BandSweep.run_warm_chain``;
an engine without the chain hooks runs "per-k"); ``--mode batched``
solves them all as one
k-batched solve (``BandSweep.run``) on every engine: the scalar and
Maxwell spectral engines, the Maxwell field engine and the built-in
solve with GMG or Jacobi. Runs on the CUDA device unless ``--device
cpu`` is given;
without a card it exits with an error instead of falling back to the
CPU. ``--precision f64`` runs only on the CPU and needs ``--device cpu``
(the entry point never picks the CPU by itself).

``--shard`` splits the k-points over the ranks of a ``torch.distributed``
group, as the reference's ``--shard`` splits them over a device mesh:
``--mode warm`` runs ``BandSweep.run_warm_sharded`` (one warm-started
segment of the path per rank) and ``--mode batched`` ``BandSweep.run``
with the mesh (each rank one k-batched share of the path). Under a
launcher the group comes from its environment,

    torchrun --standalone --nproc-per-node 4 -m -- bravais_tpu_torch \
        ... --shard

(one card per rank, NCCL; ``--device cpu``: gloo; the ``--`` keeps
torchrun's own parser from reading ``--n`` as an abbreviation of its
options); without one it is a group of one. Only rank 0 writes the run directory, logs and saves
modes; a ``--resume`` shards only the k still to do. ``--mode warm-chain
--shard`` exits with an error: a chain runs on one device (the reference
ignores the mesh there, and every rank would solve and write the same
chain).

The Maxwell ``gmg`` engine (``--engine gmg``, and ``auto`` on a grid
with n < 3, where the fast-diagonal stencils do not exist) is the σ-shift
solve with the quasi-periodic multigrid projector
(``BlochCurlCurl.make_solve_fn(deflation="gmg")`` with Jacobi).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


class Unsupported(ValueError):
    """A configuration the port does not run; the CLI exits with its
    message."""


def resolve_device(cfg) -> str:
    """The torch device of a run: ``cfg.device``, default "cuda". Raises
    ``Unsupported`` for ``precision="f64"`` on any device but the CPU
    (the card does not run it, and an unasked CPU run is refused too), an
    unknown device, and a CUDA run without a card."""
    import torch
    if cfg.precision not in ("f32", "f64"):
        raise Unsupported(f"unknown precision {cfg.precision!r}")
    dev = cfg.device or "cuda"
    if dev not in ("cuda", "cpu"):
        raise Unsupported(f"--device must be 'cuda' or 'cpu', got {dev!r}")
    if dev != "cpu" and cfg.precision == "f64":
        raise Unsupported("--precision f64 runs on the CPU: pass --device "
                          "cpu")
    if dev == "cuda" and not torch.cuda.is_available():
        raise Unsupported("no CUDA device: pass --device cpu to run on the "
                          "CPU")
    return dev


def check_modes(cfg) -> None:
    """Raise ``Unsupported`` for an unknown execution mode, chain or
    preconditioner mode, and for ``--mode warm-chain --shard``."""
    if cfg.mode not in ("warm", "batched", "warm-chain"):
        raise Unsupported(f"unknown --mode {cfg.mode!r}")
    if cfg.mode == "warm-chain":
        if cfg.shard:
            raise Unsupported("--mode warm-chain --shard: a chain runs on "
                              "one device; use --mode warm or batched "
                              "with --shard")
        if cfg.chain < 1:
            raise Unsupported(f"--chain must be at least 1, got "
                              f"{cfg.chain}")
        if cfg.pc_mode not in ("per-k", "chain-mid", "batched",
                               "batched-setup"):
            raise Unsupported(f"unknown --pc-mode {cfg.pc_mode!r}")
    if cfg.plot:
        import importlib.util
        if importlib.util.find_spec("matplotlib") is None:
            raise Unsupported("--plot needs matplotlib, which is not "
                              "installed")


def build_problem(cfg, device):
    """Config -> (lattice, kpath, operator) on ``device``."""
    from bravais_tpu_torch.lattices import kpath, make_lattice
    from bravais_tpu_torch.meshing.grid import PeriodicGrid
    from bravais_tpu_torch.operators.coefficients import (dielectric_rod,
                                                          subcell_average)

    lat = make_lattice(cfg.lattice, **cfg.lattice_kwargs())
    kp = kpath(lat, npts=cfg.nk, path=cfg.path)
    grid = PeriodicGrid.make(lat, cfg.n)
    eps = cfg.eps_out
    if cfg.radius > 0:
        # A rod in 2D, a sphere in 3D: the periodic distance is the same.
        eps = dielectric_rod(cfg.eps_in, cfg.eps_out, cfg.radius * cfg.a,
                             0.5 * lat.A.sum(axis=0), lat.A,
                             cfg.smooth_width)

    if cfg.problem in ("tm", "te", "scalar"):
        from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
        from bravais_tpu_torch.spaces.h1 import H1Space
        sp = H1Space.make(grid, cfg.p, cfg.quad)
        qcell = lat.A / (cfg.n * sp.q)   # quadrature subcell vectors
        if cfg.problem == "te":
            # TE (H_z): α = 1/ε, β = 1; subcell smoothing averages 1/ε,
            # the coefficient the weak form integrates.
            inv = (lambda x: 1.0 / eps(x)) if callable(eps) else 1.0 / eps
            if cfg.subcell > 1 and callable(inv):
                inv = subcell_average(inv, qcell, cfg.subcell)
            op = BlochHelmholtz(sp, alpha=inv, beta=1.0, dtype=cfg.dtype,
                                device=device)
        else:
            # TM (E_z) and the generic scalar problem: α = 1, β = ε.
            if cfg.subcell > 1 and callable(eps):
                eps = subcell_average(eps, qcell, cfg.subcell)
            op = BlochHelmholtz(sp, alpha=1.0, beta=eps, dtype=cfg.dtype,
                                device=device)
        return lat, kp, op
    if cfg.problem == "maxwell":
        from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
        from bravais_tpu_torch.spaces.nedelec import NedelecSpace
        sp = NedelecSpace.make(grid, cfg.p, cfg.quad)
        if cfg.subcell > 1 and callable(eps):
            eps = subcell_average(eps, lat.A / (cfg.n * sp.q), cfg.subcell)
        return lat, kp, BlochCurlCurl(sp, eps=eps, dtype=cfg.dtype,
                                      device=device)
    raise Unsupported(f"unknown problem {cfg.problem!r}")


def engine_name(cfg, op) -> str:
    """The engine the rule picks. Scalar problems: "spectral" where it is
    exact (element-invariant coefficients, n ≥ 3 per axis) unless another
    engine is asked for, else "builtin" (the sweep's own LOBPCG with GMG
    or Jacobi). Maxwell: ``cfg.engine``, where "auto" is "spectral" for
    invariant ε, "field" for varying ε and "gmg" on a grid with n < 3
    (no fast-diagonal stencils there)."""
    fd_ok = min(op.space.grid.shape) >= 3
    invariant = op._coef_elem_invariant()
    if cfg.problem != "maxwell":
        return ("spectral" if cfg.engine in ("auto", "spectral") and fd_ok
                and invariant else "builtin")
    if cfg.engine == "auto":
        return "gmg" if not fd_ok else "spectral" if invariant else "field"
    return cfg.engine


def make_solve_fn(cfg, op):
    """The solve hook of the engine ``engine_name`` picks: "builtin" →
    None; scalar "spectral" → ``make_solve_fn``; Maxwell "spectral" →
    ``make_spectral_solve_fn``; "field" → ``make_solve_fn`` with the exact
    "project" deflation for invariant ε and "project-cheby" for varying
    ε, each with the "fastdiag" preconditioner; "gmg" →
    ``make_solve_fn(deflation="gmg")`` with Jacobi, the σ-shift solve (the
    reference CLI's choices)."""
    engine = engine_name(cfg, op)
    invariant = op._coef_elem_invariant()
    if cfg.problem != "maxwell":
        return op.make_solve_fn() if engine == "spectral" else None
    if engine == "spectral":
        if not (min(op.space.grid.shape) >= 3 and invariant):
            raise Unsupported("--engine spectral needs element-invariant "
                              "coefficients and n >= 3 per axis; use "
                              "--engine field")
        return op.make_spectral_solve_fn()
    if engine == "field":
        return op.make_solve_fn(
            deflation="project" if invariant else "project-cheby",
            precond="fastdiag")
    if engine == "gmg":
        return op.make_solve_fn(deflation="gmg", precond=None)
    raise Unsupported(f"unknown --engine {engine!r}")


def run(cfg, log=print):
    """Run the band structure of ``cfg``; returns the ``BandWriter`` (None
    without ``cfg.out`` and on a rank other than 0). Raises
    ``Unsupported`` for what the port does not run. With ``cfg.shard``
    this process is one rank of the group (``kpoint_mesh``: NCCL on the
    card, gloo on the CPU), which it ends before returning."""
    device = resolve_device(cfg)
    check_modes(cfg)
    mesh = None
    if cfg.shard:
        from bravais_tpu_torch.parallel.mesh import kpoint_mesh
        mesh = kpoint_mesh("nccl" if device == "cuda" else "gloo", device)
        device = str(mesh.device)
        if mesh.rank:
            log = _quiet
    try:
        return _run(cfg, device, mesh, log)
    finally:
        if mesh is not None:
            mesh.close()


def _quiet(*args, **kwargs):
    """The log of a rank other than 0: nothing."""


def _run(cfg, device, mesh, log):
    import numpy as np

    from bravais_tpu_torch.bands import (BandSweep, BandWriter, plot_bands,
                                         save_modes)

    t0 = time.perf_counter()
    lat, kp, op = build_problem(cfg, device)
    log(f"# {lat.variant}: {op.space.ndofs} dofs, {kp.nk} k-points, "
        f"nev={cfg.nev}, tol={cfg.tol:g}, {cfg.precision} on {device}")
    if mesh is not None:
        log(f"# sharded over {mesh.size} rank{'s' * (mesh.size > 1)} "
            f"({mesh.backend})")

    solve_fn = make_solve_fn(cfg, op)
    log(f"# engine {engine_name(cfg, op)}")
    sweep = BandSweep(op, solve_fn, nev=cfg.nev,
                      block=cfg.block, tol=cfg.tol, maxiter=cfg.maxiter,
                      device_tol=cfg.device_tol, precond=cfg.precond,
                      seed=cfg.seed, keep_vectors=cfg.save_modes)

    writer = None
    finished = []
    if cfg.out and (mesh is None or mesh.rank == 0):
        writer = BandWriter(cfg.out, cfg.identity_dict(), kp.nk, cfg.nev)
        if cfg.resume:
            finished = writer.try_resume()
    if mesh is not None:
        finished = mesh.broadcast_object(finished)
    todo = [i for i in range(kp.nk) if i not in set(finished)]
    if not todo:
        log("# all k-points already finished (resume)")
        return writer

    kcart = kp.k_cart[todo].copy()
    if cfg.problem == "maxwell":
        # Exact Γ is the harmonic point of the quasi-periodic Maxwell
        # formulation: the gradient deflation is rank-deficient there.
        # Nudge it off-centre as the reference does; the ω² → 0 bands are
        # recovered to the same accuracy at the nudged point.
        for j in range(kcart.shape[0]):
            if np.linalg.norm(kcart[j]) < 1e-12:
                kcart[j] = 2e-2 * lat.B[0]
    todo_np = np.asarray(todo)
    # Each finished k (warm) or chunk (batched) is on disk at once.
    if cfg.mode == "warm" and mesh is not None:
        res = sweep.run_warm_sharded(kcart, mesh, writer=writer,
                                     k_index=todo_np)
    elif cfg.mode == "warm":
        res = sweep.run_warm(kcart, writer=writer, k_index=todo_np)
    elif cfg.mode == "warm-chain":
        res = sweep.run_warm_chain(kcart, chain=cfg.chain,
                                   precond=cfg.pc_mode, writer=writer,
                                   k_index=todo_np)
        log(f"# warm-chain: chains of {cfg.chain}, preconditioner mode "
            f"{sweep.chain_mode}")
    else:
        res = sweep.run(kcart, mesh=mesh, writer=writer, k_index=todo_np)

    for j, i in enumerate(todo):
        log(json.dumps({"k_index": i,
                        "k_frac": [round(float(x), 6) for x in kp.k_frac[i]],
                        "iters": int(res.iterations[j]),
                        "max_rel_res": float(np.max(res.residuals[j])),
                        "eigenvalues": [float(v)
                                        for v in res.eigenvalues[j]]}))
    if cfg.save_modes and writer is not None:
        for j, i in enumerate(todo):
            save_modes(cfg.out, i, kp.k_cart[i], res.eigenvalues[j],
                       res.eigenvectors[j])
        log(f"# modes saved for {len(todo)} k-points under {cfg.out}")
    if writer is not None and cfg.plot:
        import pathlib
        plot_bands(kp, writer.eigenvalues,
                   path=pathlib.Path(cfg.out) / "bands.png",
                   title=f"{lat.variant} {cfg.problem.upper()}")
    log(f"# done: wall {res.wall_s:.2f}s (device solves {res.solve_s:.2f}s,"
        f" host refine {res.refine_s:.2f}s beside them), "
        f"total {time.perf_counter() - t0:.1f}s, "
        f"mean iters {float(np.mean(res.iterations)):.1f}")
    return writer


def main(argv=None):
    from bravais_tpu_torch.cli.config import RunConfig
    ap = argparse.ArgumentParser(
        prog="python -m bravais_tpu_torch",
        description="Photonic band structures (the PyTorch/CUDA port).",
        epilog="Runs on the CUDA device; --device cpu runs on the host.")
    RunConfig.add_cli_args(ap)
    cfg = RunConfig.from_cli_args(ap.parse_args(argv))
    try:
        run(cfg)
    except Unsupported as e:
        ap.error(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
