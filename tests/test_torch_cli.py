"""Checkpoint/resume, mode dumps and the band-structure CLI of the port,
against the JAX package where both run.

Ports of the non-slow tests of ``tests/test_checkpoint.py`` (the chunked
cold ``run`` writes every chunk; a warm sweep killed after three k-points
has them on disk and a resume finishes the rest; a SIGKILLed CLI run
resumes recomputing only the unfinished k-points; a saved mode satisfies
its eigen-equation; the VTK dump), plus:

* the CLI's engine rule, every accept and every error, as a table;
* the gmg engine (``--engine gmg``, and ``auto`` on n < 3) run to the end
  in float64 against the reference CLI's bands (1e-8);
* ``--mode warm-chain`` run to the end, and a ``--mode warm`` run resumed
  as a warm-chain run, against the reference CLI's warm-chain bands
  (1e-8);
* a run directory written by either package loads with the other's
  ``load_bands``;
* the port's ``run(cfg)`` on a tiny float64 SQR TM-rods problem against
  the reference's ``run(cfg)``: bands within 1e-8 relative (both solve
  to the same device stop on the same discretization, so they differ by
  the stop's residual squared).
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bravais_tpu.bands import BandWriter as BandWriterRef
from bravais_tpu.bands import load_bands as load_bands_ref
from bravais_tpu.cli.bands_app import run as run_ref
from bravais_tpu.cli.config import RunConfig as RunConfigRef
from bravais_tpu_torch.bands import (BandSweep, BandWriter, load_bands,
                                     save_modes, write_vtk)
from bravais_tpu_torch.cli import bands_app
from bravais_tpu_torch.cli.config import RunConfig
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.spaces.h1 import H1Space

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _problem(n=8, p=2):
    lat = make_lattice("SQR")
    sp = H1Space.make(PeriodicGrid.make(lat, n), p)
    return lat, BlochHelmholtz(sp, dtype=torch.complex128, device="cpu")


def test_run_writes_every_chunk(tmp_path):
    lat, op = _problem()
    kp = kpath(lat, npts=6)
    sweep = BandSweep(op, nev=2, block=4, tol=1e-6, maxiter=60)
    writer = BandWriter(tmp_path, {"c": 1}, kp.nk, 2)
    calls = []
    orig = writer.write_chunk
    writer.write_chunk = lambda idx, *a: (calls.append(list(idx)),
                                          orig(idx, *a))
    res = sweep.run(kp.k_cart, chunk=4, writer=writer)
    assert calls == [[0, 1, 2, 3], [4, 5]]
    assert writer.finished == list(range(kp.nk))
    dat = np.load(tmp_path / "bands.npz")
    assert np.all(np.isfinite(dat["eigenvalues"]))
    np.testing.assert_array_equal(dat["eigenvalues"], res.eigenvalues)


def test_warm_writes_every_k_and_resume_skips(tmp_path):
    lat, op = _problem()
    kp = kpath(lat, npts=5)
    sweep = BandSweep(op, nev=2, block=4, tol=1e-6, maxiter=60)
    writer = BandWriter(tmp_path, {"c": 2}, kp.nk, 2)
    # interrupt after 3 k-points by raising from a wrapped writer
    calls = []
    orig = writer.write_chunk

    def boom(idx, *a):
        orig(idx, *a)
        calls.append(list(idx))
        if len(calls) == 3:
            raise KeyboardInterrupt

    writer.write_chunk = boom
    with pytest.raises(KeyboardInterrupt):
        sweep.run_warm(kp.k_cart, writer=writer)
    # three k-points are on disk despite the crash
    w2 = BandWriter(tmp_path, {"c": 2}, kp.nk, 2)
    done = w2.try_resume()
    assert done == [0, 1, 2]
    # resume completes only the remainder
    todo = [i for i in range(kp.nk) if i not in done]
    sweep2 = BandSweep(op, nev=2, block=4, tol=1e-6, maxiter=60)
    sweep2.run_warm(kp.k_cart[todo], writer=w2, k_index=np.asarray(todo))
    assert w2.finished == list(range(kp.nk))


def test_cli_kill9_then_resume(tmp_path):
    """SIGKILL a CLI sweep mid-run, rerun with --resume: only the
    unfinished k-points are recomputed."""
    out = tmp_path / "run"
    args = [sys.executable, "-m", "bravais_tpu_torch.cli.bands_app",
            "--device", "cpu", "--lattice", "SQR", "--problem", "scalar",
            "--n", "8", "--p", "2", "--nk", "6", "--nev", "2", "--tol",
            "1e-6", "--precision", "f64", "--maxiter", "60", "--out",
            str(out), "--resume"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(args, cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    manifest = out / "manifest.json"
    # wait until at least 2 k-points are checkpointed, then SIGKILL
    deadline = time.time() + 300
    while time.time() < deadline:
        if proc.poll() is not None:
            break  # finished before we killed it — resume is then a no-op
        if manifest.exists():
            try:
                fin = json.loads(manifest.read_text())["finished"]
            except (json.JSONDecodeError, KeyError):
                fin = []
            if len(fin) >= 2:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                break
        time.sleep(0.05)
    else:
        proc.kill()
        pytest.fail("sweep never checkpointed within 300s")
    fin_before = json.loads(manifest.read_text())["finished"]
    assert len(fin_before) >= 2
    r = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    solved = [json.loads(line) for line in r.stdout.splitlines()
              if line.startswith("{")]
    solved_idx = sorted(s["k_index"] for s in solved)
    assert solved_idx == [i for i in range(6) if i not in fin_before]
    fin_after = json.loads(manifest.read_text())["finished"]
    assert fin_after == list(range(6))
    assert np.all(np.isfinite(np.load(out / "bands.npz")["eigenvalues"]))


def test_save_modes_roundtrip(tmp_path):
    lat, op = _problem(n=6, p=1)
    kp = kpath(lat, npts=4)
    sweep = BandSweep(op, nev=2, block=4, tol=1e-8, maxiter=80,
                      keep_vectors=True)
    res = sweep.run_warm(kp.k_cart)
    assert res.eigenvectors is not None
    assert res.eigenvectors.shape == (kp.nk, 2) + op.space.dof_shape
    p = save_modes(tmp_path, 1, kp.k_cart[1], res.eigenvalues[1],
                   res.eigenvectors[1])
    dat = np.load(p)
    assert dat["X_reim"].shape == (2, 2) + op.space.dof_shape
    X = dat["X_reim"][0] + 1j * dat["X_reim"][1]
    # the saved mode satisfies the eigen-equation
    x = torch.as_tensor(X[:1])
    lam = float(dat["eigenvalues"][0])
    r = op.apply_A(x, kp.k_cart[1]) - lam * op.apply_M(x)
    nrm = float(torch.linalg.vector_norm(op.apply_M(x)))
    assert float(torch.linalg.vector_norm(r)) <= (
        1e-6 * max(abs(lam), 1.0) * nrm)


def test_write_vtk(tmp_path):
    lat, op = _problem(n=4, p=1)
    f = np.random.default_rng(0).standard_normal(op.space.dof_shape)
    p = write_vtk(tmp_path / "m.vtk", op.space.grid, {"mode0": f})
    txt = pathlib.Path(p).read_text()
    assert "STRUCTURED_GRID" in txt and "SCALARS mode0" in txt
    assert f"POINT_DATA {f.size}" in txt


class _Op:
    """Stands in for an operator in the engine rule: its grid, whether
    its coefficients are element-invariant, and which solve it was asked
    for."""

    def __init__(self, n, invariant):
        self.space = type("S", (), {"grid": type("G", (), {
            "shape": (n, n, n)})})()
        self.invariant = invariant

    def _coef_elem_invariant(self):
        return self.invariant

    def make_solve_fn(self, **kw):
        return ("make_solve_fn", kw)

    def make_spectral_solve_fn(self):
        return ("make_spectral_solve_fn", {})


SPECTRAL = ("make_spectral_solve_fn", {})
PROJECT = ("make_solve_fn", {"deflation": "project", "precond": "fastdiag"})
CHEBY = ("make_solve_fn", {"deflation": "project-cheby",
                           "precond": "fastdiag"})
GMG = ("make_solve_fn", {"deflation": "gmg", "precond": None})


@pytest.mark.parametrize("problem,engine,n,invariant,want", [
    ("maxwell", "auto", 8, True, SPECTRAL),
    ("maxwell", "spectral", 8, True, SPECTRAL),
    ("maxwell", "auto", 8, False, CHEBY),
    ("maxwell", "field", 8, True, PROJECT),
    ("maxwell", "field", 8, False, CHEBY),
    ("maxwell", "spectral", 8, False, "needs element-invariant"),
    ("maxwell", "gmg", 8, True, GMG),
    ("maxwell", "auto", 2, True, GMG),
    ("maxwell", "auto", 2, False, GMG),
    ("maxwell", "warp", 8, True, "unknown --engine"),
    ("tm", "auto", 8, True, ("make_solve_fn", {})),
    ("scalar", "spectral", 8, True, ("make_solve_fn", {})),
    ("te", "auto", 8, False, None),
    ("tm", "field", 8, True, None),
    ("tm", "auto", 2, True, None),
])
def test_engine_rule(problem, engine, n, invariant, want):
    cfg = RunConfig(problem=problem, engine=engine)
    op = _Op(n, invariant)
    if isinstance(want, str):
        with pytest.raises(bands_app.Unsupported, match=want):
            bands_app.make_solve_fn(cfg, op)
    else:
        assert bands_app.make_solve_fn(cfg, op) == want


@pytest.mark.parametrize("extra,message", [
    (["--mode", "warm-chain", "--shard"], "--mode warm-chain --shard"),
    (["--shard", "--device", "cuda"], "no CUDA device"),
    (["--device", "cuda"], "no CUDA device"),
    ([], "no CUDA device"),
    (["--precision", "f64", "--device", "cuda"], "--precision f64 runs on "
                                                 "the CPU"),
])
def test_cli_errors(extra, message, monkeypatch, capsys):
    """What the port does not run, and a missing card without --device
    cpu, exit non-zero with a message that names it, before any solve."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--lattice", "FCC", "--problem", "maxwell", "--n", "3", "--p",
            "1", "--nk", "12", "--nev", "2"]
    if "--device" not in extra and extra:
        argv += ["--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        bands_app.main(argv + extra)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("extra", [
    ["--engine", "gmg", "--n", "3", "--p", "1"],
    ["--n", "2", "--p", "2"],
], ids=["engine-gmg", "n2-auto"])
def test_gmg_engine_runs_and_matches_reference(extra, tmp_path, capsys):
    """``--engine gmg`` on an n >= 3 grid, and ``auto`` on n = 2 (the
    engine rule's gmg route), run to the end on ``--device cpu
    --precision f64``; the bands equal the reference CLI's ``run`` on the
    same configuration within 1e-8 (both solve the σ-shift pencil to the
    same stop from the same start block)."""
    argv = ["--lattice", "FCC", "--problem", "maxwell", "--path", "G,X",
            "--nk", "2", "--nev", "2", "--device", "cpu", "--precision",
            "f64", "--out", str(tmp_path / "port")] + extra
    assert bands_app.main(argv) == 0
    assert "# engine gmg" in capsys.readouterr().out.splitlines()
    lam = load_bands(tmp_path / "port")[0]["eigenvalues"]
    kw = dict(lattice="FCC", problem="maxwell", path=[["G", "X"]], nk=2,
              nev=2, precision="f64", n=int(extra[extra.index("--n") + 1]),
              p=int(extra[extra.index("--p") + 1]))
    if "--engine" in extra:
        kw["engine"] = "gmg"
    lam_r = run_ref(RunConfigRef(out=str(tmp_path / "ref"), **kw),
                    log=lambda s: None).eigenvalues
    assert np.all(np.isfinite(lam)) and lam.shape == (2, 2)
    top = np.abs(lam_r).max(axis=1, keepdims=True)
    scale = np.where(np.abs(lam_r) > 1e-3 * top, np.abs(lam_r), top)
    assert np.max(np.abs(lam - lam_r) / scale) < 1e-8, (lam, lam_r)


#: ``--mode warm-chain`` on the spectral engine (FCC n=3 p=2, Γ–X–W at 6
#: points, chains of 4, every chain k's setup in one call), float64 on the
#: CPU.
CHAIN_ARGV = ["--lattice", "FCC", "--problem", "maxwell", "--n", "3", "--p",
              "2", "--path", "G,X,W", "--nk", "6", "--nev", "4", "--device",
              "cpu", "--precision", "f64", "--mode", "warm-chain", "--chain",
              "4", "--pc-mode", "batched-setup"]


@pytest.fixture(scope="module")
def chain_ref_bands(tmp_path_factory):
    """The reference CLI's ``run`` of ``CHAIN_ARGV``'s configuration."""
    cfg = RunConfigRef(lattice="FCC", problem="maxwell", n=3, p=2,
                       path=[["G", "X", "W"]], nk=6, nev=4, precision="f64",
                       mode="warm-chain", chain=4, pc_mode="batched-setup",
                       out=str(tmp_path_factory.mktemp("ref")))
    return run_ref(cfg, log=lambda s: None).eigenvalues


def _scaled_diff(lam, lam_r):
    top = np.abs(lam_r).max(axis=1, keepdims=True)
    scale = np.where(np.abs(lam_r) > 1e-3 * top, np.abs(lam_r), top)
    return float(np.max(np.abs(lam - lam_r) / scale))


def test_warm_chain_runs_and_matches_reference(chain_ref_bands, tmp_path,
                                               capsys):
    """``--mode warm-chain`` runs to the end on ``--device cpu --precision
    f64`` with the spectral engine's every-chain-k setup, and its bands
    equal the reference CLI's warm-chain run within 1e-8 (both solve to
    the same stop from the same start block; the reference keeps the
    preconditioner as an inverse, the port as a factor)."""
    assert bands_app.main(CHAIN_ARGV + ["--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "# engine spectral" in out
    assert ("# warm-chain: chains of 4, preconditioner mode batched-setup"
            in out)
    lam = load_bands(tmp_path)[0]["eigenvalues"]
    assert np.all(np.isfinite(lam)) and lam.shape == (6, 4)
    assert _scaled_diff(lam, chain_ref_bands) < 1e-8


def test_warm_run_resumes_as_warm_chain(chain_ref_bands, tmp_path,
                                        monkeypatch, capsys):
    """A ``--mode warm`` run stopped after 3 k resumes under ``--mode
    warm-chain`` (the mode, chain and pc mode are execution-only, so the
    run directory's identity holds): the resume solves only k 3–5, and
    the whole table equals the reference's warm-chain run within 1e-8."""
    out = str(tmp_path)
    warm = CHAIN_ARGV[:CHAIN_ARGV.index("--mode")] + ["--out", out]
    orig = BandWriter.write_chunk
    calls = []

    def stop(self, idx, *a):
        orig(self, idx, *a)
        calls.append(list(idx))
        if len(calls) == 3:
            raise KeyboardInterrupt
    monkeypatch.setattr(BandWriter, "write_chunk", stop)
    with pytest.raises(KeyboardInterrupt):
        bands_app.main(warm)
    monkeypatch.setattr(BandWriter, "write_chunk", orig)
    assert load_bands(tmp_path)[1]["finished"] == [0, 1, 2]
    capsys.readouterr()
    assert bands_app.main(CHAIN_ARGV + ["--out", out, "--resume"]) == 0
    solved = [json.loads(line)["k_index"]
              for line in capsys.readouterr().out.splitlines()
              if line.startswith("{")]
    assert solved == [3, 4, 5]
    dat, man = load_bands(tmp_path)
    assert man["finished"] == list(range(6))
    assert _scaled_diff(dat["eigenvalues"], chain_ref_bands) < 1e-8


def test_plot_without_matplotlib_is_an_error(monkeypatch, capsys):
    """Where matplotlib is missing, --plot exits with a message before
    any solve instead of dropping the plot."""
    import importlib.util
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else find_spec(name, *a)))
    with pytest.raises(SystemExit) as e:
        bands_app.main(["--device", "cpu", "--problem", "scalar", "--n",
                        "4", "--p", "1", "--nk", "4", "--plot"])
    assert e.value.code == 2
    assert "--plot needs matplotlib" in capsys.readouterr().err


def test_f64_runs_on_the_cpu_and_says_so(monkeypatch, capsys):
    """--precision f64 runs on the CPU only when asked: without --device
    cpu the CLI exits 2 with a message, card or no card (an entry point
    never picks the CPU by itself); with it the run goes ahead and says
    where it runs."""
    argv = ["--lattice", "SQR", "--problem", "scalar", "--n", "4", "--p",
            "1", "--nk", "4", "--nev", "2", "--precision", "f64"]
    for card in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
        with pytest.raises(SystemExit) as e:
            bands_app.main(argv)
        assert e.value.code == 2
        assert ("--precision f64 runs on the CPU: pass --device cpu"
                in capsys.readouterr().err)
    lines = []
    cfg = RunConfig(lattice="SQR", problem="scalar", n=4, p=1, nk=4, nev=2,
                    precision="f64", device="cpu")
    bands_app.run(cfg, log=lines.append)
    assert bands_app.resolve_device(cfg) == "cpu"
    assert lines[0].endswith("f64 on cpu")
    assert lines[-1].startswith("# done: wall")


def test_run_dirs_load_across_packages(tmp_path):
    rng = np.random.default_rng(3)
    lam, its, res = rng.random((3, 2)), [4, 5, 6], rng.random((3, 2))
    for Writer, load in ((BandWriter, load_bands_ref),
                         (BandWriterRef, load_bands)):
        d = tmp_path / Writer.__module__
        w = Writer(d, {"c": 1}, 3, 2)
        w.write_chunk([0, 1, 2], lam, its, res)
        dat, man = load(d)
        np.testing.assert_array_equal(dat["eigenvalues"], lam)
        np.testing.assert_array_equal(dat["iterations"], its)
        np.testing.assert_array_equal(dat["residuals"], res)
        assert man["finished"] == [0, 1, 2] and man["nk"] == 3
    # The same config hashes alike in both packages (device is
    # execution-only), so either package resumes the other's run.
    kw = dict(lattice="SQR", problem="tm", n=6, p=2)
    assert (BandWriter(tmp_path / "a", RunConfig(device="cpu", **kw)
                       .identity_dict(), 3, 2).hash
            == BandWriterRef(tmp_path / "b", RunConfigRef(**kw)
                             .identity_dict(), 3, 2).hash)


def test_run_matches_reference_tm_rods(tmp_path):
    kw = dict(lattice="SQR", problem="tm", eps_in=8.9, radius=0.2, n=4,
              p=2, nk=4, nev=4, precision="f64")
    w = bands_app.run(RunConfig(out=str(tmp_path / "port"), device="cpu",
                                **kw),
                      log=lambda s: None)
    w_ref = run_ref(RunConfigRef(out=str(tmp_path / "ref"), **kw),
                    log=lambda s: None)
    lam, lam_r = w.eigenvalues, w_ref.eigenvalues
    assert np.all(np.isfinite(lam)) and lam.shape == (4, 4)
    top = np.abs(lam_r).max(axis=1, keepdims=True)
    scale = np.where(np.abs(lam_r) > 1e-3 * top, np.abs(lam_r), top)
    assert np.max(np.abs(lam - lam_r) / scale) < 1e-8, (lam, lam_r)


@pytest.mark.parametrize("problem,extra", [
    ("tm", dict(lattice="SQR", eps_in=8.9, radius=0.2, subcell=2)),
    ("te", dict(lattice="HEX2D", eps_in=1.0, eps_out=13.0, radius=0.3,
                subcell=2)),
    ("scalar", dict(lattice="SQR")),
    ("maxwell", dict(lattice="FCC", engine="field", path=[["G", "X"]])),
])
def test_every_problem_runs_on_the_cpu(problem, extra, tmp_path):
    """``--device cpu`` runs each CLI problem end to end (complex64, host
    refine), bands finite and the run directory complete."""
    nk = 3 if problem == "maxwell" else 4
    cfg = RunConfig(problem=problem, n=3 if problem == "maxwell" else 4,
                    p=2, nk=nk, nev=3, device="cpu", out=str(tmp_path),
                    **extra)
    lines = []
    w = bands_app.run(cfg, log=lines.append)
    assert w.finished == list(range(nk))
    assert np.all(np.isfinite(w.eigenvalues)) and np.all(w.eigenvalues > -1e-6)
    assert sum(line.startswith("{") for line in lines) == nk


def test_subcell_average_matches_reference():
    from bravais_tpu.operators.coefficients import \
        subcell_average as subcell_ref
    from bravais_tpu_torch.operators.coefficients import (dielectric_rod,
                                                          subcell_average)
    lat = make_lattice("HEX2D")
    eps = dielectric_rod(13.0, 1.0, 0.3, 0.5 * lat.A.sum(axis=0), lat.A)
    x = np.random.default_rng(5).random((7, 5, 2)) @ lat.A
    V = lat.A / 12
    got = subcell_average(eps, V, 3)(x)
    np.testing.assert_array_equal(got, subcell_ref(eps, V, 3)(x))
    assert got.shape == x.shape[:-1] and np.ptp(got) > 0
