"""The port on a CUDA device: the hand-written Jacobi, Nédélec (nd) and
H1 element kernels against their plain torch versions, the field
engine's and the scalar Helmholtz operator's fused (A, M) applies, one
multigrid V-cycle and the quasi-periodic multigrid's solve on the card
against the CPU, the warm spectral, field
and scalar sweeps and the k-batched ``run`` of every engine on the card
against the same sweeps on the CPU, and two gloo ranks sharing the card
(a k-sharded ``run`` and a domain-decomposed field apply against one
rank).
Every test skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.eigen.gmg import GMG
from bravais_tpu_torch.eigen import jacobi_cuda
from bravais_tpu_torch.eigen.jacobi_eigh import (jacobi_eigh,
                                                jacobi_eigh_plain,
                                                plain_sweeps_run)
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators import h1_apply, nd_apply
from bravais_tpu_torch.operators.coefficients import (dielectric_rod,
                                                      dielectric_sphere,
                                                      eval_coefficient)
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
from bravais_tpu_torch.spaces.h1 import H1Space
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _sphere_op(n, p, dev):
    lat = make_lattice("CUB")
    eps = dielectric_sphere(13.0, 1.0, 0.25, 0.5 * lat.A.sum(axis=0), lat.A)
    return BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, n), p),
                         eps=eps, device=dev)


def _rand_herm(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Q = np.linalg.qr(A)[0]
    H = (Q * (rng.standard_normal(n) * 10)) @ Q.conj().T
    return 0.5 * (H + H.conj().T)


@pytest.mark.parametrize("n,batch", [(16, 1), (33, 8), (48, 1), (48, 8),
                                     (64, 1), (64, 512)])
def test_kernel_matches_plain(cuda, n, batch):
    Hs = np.stack([_rand_herm(n, 7 * n + i) for i in range(batch)])
    H = torch.as_tensor(Hs.astype(np.complex64), device=cuda)
    before = jacobi_cuda.launches
    w, V = jacobi_eigh(H)
    assert jacobi_cuda.launches == before + 1
    w_pl, _ = jacobi_eigh_plain(H)
    w, V, w_pl = w.cpu().numpy(), V.cpu().numpy(), w_pl.cpu().numpy()
    for i in range(batch):
        scale = np.maximum(np.abs(w_pl[i]), 1e-3 * np.abs(w_pl[i]).max())
        assert np.max(np.abs(w[i] - w_pl[i]) / scale) < 5e-4
        R = Hs[i].astype(np.complex64) @ V[i] - V[i] * w[i][None, :]
        assert np.linalg.norm(R) / np.linalg.norm(Hs[i]) < 2e-5
        assert np.linalg.norm(V[i].conj().T @ V[i] - np.eye(n)) < 2e-4


@pytest.mark.parametrize("n,batch", [(27, 216), (2, 5), (64, 2), (16, 1),
                                     (5, 3)])
def test_kernel_order_and_sweeps_match_plain(cuda, n, batch):
    """Odd n without a pad (27 × 216, the L-twin batch), the smallest and
    the largest n: eigenpairs come back ascending in the plain version's
    order (vectors up to a phase where the eigenvalue is separated), each
    matrix's sweeps within one of the plain version's."""
    Hs = np.stack([_rand_herm(n, 31 * n + i) for i in range(batch)])
    H = torch.as_tensor(Hs.astype(np.complex64), device=cuda)
    w, V = jacobi_eigh(H)
    w_pl, V_pl = jacobi_eigh_plain(H)
    nsw = jacobi_cuda.sweeps_run(H).cpu().numpy()
    nsw_pl = plain_sweeps_run(H).cpu().numpy()
    w, V, w_pl, V_pl = (t.cpu().numpy() for t in (w, V, w_pl, V_pl))
    assert np.all(np.diff(w, axis=-1) >= 0)
    assert np.all(np.abs(nsw - nsw_pl) <= 1), (nsw.tolist(), nsw_pl.tolist())
    for i in range(batch):
        span = np.abs(w_pl[i]).max()
        assert np.max(np.abs(w[i] - w_pl[i])) < 5e-5 * span
        gap = np.minimum(np.diff(w_pl[i], prepend=-np.inf),
                         np.diff(w_pl[i], append=np.inf))
        overlap = np.abs(np.sum(V_pl[i].conj() * V[i], axis=0))
        sep = gap > 1e-2 * span
        assert np.all(overlap[sep] > 1 - 1e-3), overlap[sep].min()


def test_kernel_is_one_device_operation(cuda):
    """``jacobi_eigh_cuda`` issues the kernel and nothing else on the
    device (no pad, sort or gather), at odd and even n. Now and then a
    process's profiler trace holds no device operation at all, though the
    call issues one: such a trace is taken again, at most three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for n, batch in ((27, 216), (48, 1)):
        H = torch.as_tensor(np.stack([_rand_herm(n, i) for i in range(batch)])
                            .astype(np.complex64), device=cuda)
        jacobi_eigh(H)
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                jacobi_eigh(H, rel_tol=1e-4)
                torch.cuda.synchronize()
            dev = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            if dev:
                break
        assert len(dev) == 1 and "jacobi_eigh_kernel" in dev[0], dev


def test_kernel_graded_low_accuracy(cuda):
    n = 45
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = np.eye(n) + 0.3 * (A + A.conj().T) / np.sqrt(n)
    d = np.sqrt(np.concatenate([np.linspace(1, 1.01, 10),
                                np.geomspace(10.0, 1e6, n - 10)]))
    H = d[:, None] * A * d[None, :]
    H = 0.5 * (H + H.conj().T)
    wref = scipy.linalg.eigh(H, eigvals_only=True)
    w, _ = jacobi_eigh(torch.as_tensor(H.astype(np.complex64), device=cuda),
                       sweeps=12)
    rel = np.abs(w.cpu().numpy()[:10] - wref[:10]) / np.abs(wref[:10])
    assert rel.max() < 2e-5, rel.max()


def test_kernel_sweep_counts(cuda):
    """rel_tol = 0 runs every sweep (the TPU kernel's fixed schedule); the
    Rutishauser stop ends well inside the cap."""
    Hs = np.stack([_rand_herm(48, 50 + i) for i in range(3)])
    H = torch.as_tensor(Hs.astype(np.complex64), device=cuda)
    assert jacobi_cuda.sweeps_run(H, sweeps=12, rel_tol=0.0).tolist() \
        == [12, 12, 12]
    nsw = jacobi_cuda.sweeps_run(H, rel_tol=1e-4)
    assert nsw.shape == (3,)
    assert 1 <= int(nsw.min()) and int(nsw.max()) < 24, nsw.tolist()


def test_kernel_refuses_other_inputs(cuda):
    with pytest.raises(ValueError):
        jacobi_eigh(torch.zeros((4, 4), dtype=torch.complex128, device=cuda))
    with pytest.raises(ValueError):
        jacobi_eigh(torch.zeros((66, 66), dtype=torch.complex64,
                                device=cuda))


def test_sweep_on_cuda_matches_cpu(cuda):
    """FCC n=4 p=2, Γ–X–W–L npts=5: the refined bands are exact f64 block
    eigenvalues on both devices, and every eigensolve of the CUDA sweep
    launched the kernel (one per LOBPCG iteration + one whitening per k)."""
    lat = make_lattice("FCC")
    kc = kpath(lat, npts=5, path=[["G", "X", "W", "L"]]).k_cart.copy()
    kc[np.linalg.norm(kc, axis=1) < 1e-12] = 2e-2 * lat.B[0]
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 4), 2)
    out = {}
    for dev in ("cpu", cuda):
        op = BlochCurlCurl(sp, device=dev)
        sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=4, block=8,
                          tol=1e-6, maxiter=250, device_tol=1e-3)
        jacobi_cuda.launches = 0
        out[str(dev)] = (sweep.run_warm(kc), jacobi_cuda.launches)
    (r_cpu, _), (r_gpu, launches) = out["cpu"], out[str(cuda)]
    assert launches == int(r_gpu.iterations.sum()) + len(kc)
    assert np.all(np.abs(r_gpu.iterations - r_cpu.iterations) <= 2)
    np.testing.assert_allclose(r_gpu.eigenvalues, r_cpu.eigenvalues,
                               rtol=1e-9, atol=1e-12)
    assert np.max(r_gpu.residuals) < 1e-10


@pytest.mark.parametrize("n,p,rows", [(3, 2, 3), (6, 3, 16), (3, 1, 7),
                                      (2, 4, 5), (8, 4, 16)])
def test_nd_kernel_matches_plain(cuda, n, p, rows):
    """Every half of the Nédélec kernel against the plain version, at the
    instantiated shapes (p = 2, 3, 4; p = 4 on 16 rows of 512 elements is
    the FCC field path's call) and with runtime extents (p = 1), odd row
    counts among them; one launch per call, and its block fits on an
    SM."""
    c = _sphere_op(n, p, cuda).nd_consts()
    gen = torch.Generator(device=cuda).manual_seed(3)
    ue = torch.randn((rows * c.nelem, c.ndof), generator=gen,
                     dtype=torch.complex64, device=cuda)
    for want in ("AM", "A", "M"):
        assert nd_apply.launch_shape(ue, c, want)["blocks_per_sm"] >= 1
        before = nd_apply.launches
        out = nd_apply.nedelec_apply(ue, c, want)
        assert nd_apply.launches == before + 1
        ref = nd_apply.nedelec_apply_plain(ue, c, want)
        for a, b in zip(out, ref):
            assert (a is None) == (b is None)
            if b is not None:
                assert _rel(a, b) < 2e-5, want


@pytest.mark.parametrize("lat,shape,p,kfrac", [
    ("CUB", (6, 6, 6), 3, 0.0), ("FCC", (3, 3, 3), 2, 0.3),
    ("SQR", (4, 4), 2, 0.3)])
def test_h1_kernel_matches_plain(cuda, lat, shape, p, kfrac):
    lattice = make_lattice(lat)
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p)
    xq = sp.qpoints_phys()
    c = h1_apply.H1Consts.from_space(
        sp, eval_coefficient(lambda x: 1 + 0.3 * x[..., 0] ** 2, xq),
        eval_coefficient(lambda x: 1 + np.sum(x ** 2, axis=-1), xq), cuda)
    k = [float(v) for v in lattice.k_cart([kfrac] * sp.dim)]
    gen = torch.Generator(device=cuda).manual_seed(4)
    ue = torch.randn((4 * c.nelem,) + (c.l,) * c.d, generator=gen,
                     dtype=torch.complex64, device=cuda)
    for want in ("AM", "A", "M"):
        before = h1_apply.launches
        out = h1_apply.helmholtz_apply(ue, c, k, want)
        assert h1_apply.launches == before + 1
        ref = h1_apply.helmholtz_apply_plain(ue, c, k, want)
        for a, b in zip(out, ref):
            if b is not None:
                assert _rel(a, b) < 2e-5, want


@pytest.mark.parametrize("lat,shape,p,kfrac,rows", [
    ("CUB", (6, 6, 6), 3, 0.0, 32), ("CUB", (6, 6, 6), 3, 0.2, 32),
    ("SQR", (4, 4), 3, 0.3, 4), ("SQR", (3, 3), 4, 0.3, 4),
    ("FCC", (2, 2, 2), 4, 0.3, 4), ("FCC", (3, 3, 3), 1, 0.3, 4)])
def test_h1_kernel_shapes_match_plain(cuda, lat, shape, p, kfrac, rows):
    """Each instantiated (d, l, q) of the h1 kernel — config 3's at the
    projector's 32 rows, the 2D p = 3 and p = 4 shapes, the FCC p = 4
    field shape at k ≠ 0 and the 3D p = 1 levels' (3, 2, 3) — every
    half."""
    lattice = make_lattice(lat)
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p)
    xq = sp.qpoints_phys()
    c = h1_apply.H1Consts.from_space(
        sp, eval_coefficient(lambda x: 1 + 0.3 * x[..., 0] ** 2, xq),
        eval_coefficient(lambda x: 1 + np.sum(x ** 2, axis=-1), xq), cuda)
    k = [float(v) for v in lattice.k_cart([kfrac] * sp.dim)]
    gen = torch.Generator(device=cuda).manual_seed(5)
    ue = torch.randn((rows * c.nelem,) + (c.l,) * c.d, generator=gen,
                     dtype=torch.complex64, device=cuda)
    for want in ("AM", "A", "M"):
        out = h1_apply.helmholtz_apply(ue, c, k, want)
        ref = h1_apply.helmholtz_apply_plain(ue, c, k, want)
        for a, b in zip(out, ref):
            assert (a is None) == (b is None)
            if b is not None:
                assert _rel(a, b) < 2e-5, want


@pytest.mark.parametrize("shape,p,q,kfrac", [
    ((4, 4, 4), 2, None, 0.0), ((4, 4, 4), 2, None, 0.3),
    ((6, 6, 6), 1, None, 0.0), ((6, 6, 6), 1, None, 0.3),
    ((3, 3, 3), 2, 5, 0.3)])
def test_h1_kernel_3d_p2_p1_match_plain(cuda, shape, p, q, kfrac):
    """The 3D (d, l, q) = (3, 3, 4) of the field engine at p = 2 (the
    certification's CUB n = 4: its projector on 16 and 32 rows) and
    (3, 2, 3) of the 3D multigrid's p = 1 levels (config 3's n = 6 on 16
    rows), at k = 0 and k ≠ 0, every half, one launch a call; and a 3D
    shape no case instantiates, (3, 3, 5), on the runtime-extent
    template."""
    lattice = make_lattice("CUB")
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p, q)
    xq = sp.qpoints_phys()
    c = h1_apply.H1Consts.from_space(
        sp, eval_coefficient(lambda x: 1 + 0.3 * x[..., 0] ** 2, xq),
        eval_coefficient(lambda x: 1 + np.sum(x ** 2, axis=-1), xq), cuda)
    k = [float(v) for v in lattice.k_cart([kfrac] * 3)]
    gen = torch.Generator(device=cuda).manual_seed(16)
    for rows in ((16, 32) if p == 2 and q is None else (16,)):
        ue = torch.randn((rows * c.nelem,) + (c.l,) * 3, generator=gen,
                         dtype=torch.complex64, device=cuda)
        for want in ("AM", "A", "M"):
            before = h1_apply.launches
            out = h1_apply.helmholtz_apply(ue, c, k, want)
            assert h1_apply.launches == before + 1
            ref = h1_apply.helmholtz_apply_plain(ue, c, k, want)
            for a, b in zip(out, ref):
                assert (a is None) == (b is None)
                if b is not None:
                    assert _rel(a, b) < 2e-5, (rows, want)


@pytest.mark.parametrize("shape,p", [((4, 4, 4), 2), ((6, 6, 6), 1)])
def test_h1_kernel_is_one_device_operation(cuda, shape, p):
    """An h1 call at (3, 3, 4) and at (3, 2, 3) issues the kernel and
    nothing else on the device, for every half. Now and then a process's
    profiler trace holds no device operation at all, though the call
    issues one: such a trace is taken again, at most three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lattice = make_lattice("CUB")
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p)
    c = h1_apply.H1Consts.from_space(sp, np.ones(1), np.ones(1), cuda)
    k = [float(v) for v in lattice.k_cart([0.3] * 3)]
    ue = torch.randn((16 * c.nelem,) + (c.l,) * 3, dtype=torch.complex64,
                     device=cuda)
    for want in ("AM", "A", "M"):
        h1_apply.helmholtz_apply(ue, c, k, want)
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                h1_apply.helmholtz_apply(ue, c, k, want)
                torch.cuda.synchronize()
            dev = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            if dev:
                break
        assert len(dev) == 1 and "h1_apply_kernel" in dev[0], (want, dev)


def _kfrac_table(nk, d, seed=6):
    """nk fractional k-points whose components all differ."""
    return np.random.default_rng(seed).uniform(0.05, 0.45, (nk, d))


@pytest.mark.parametrize("lat,shape,p,nk,rows", [
    ("TRI", (6, 6, 6), 4, 8, 10), ("TRI", (6, 6, 6), 4, 8, 2),
    ("CUB", (6, 6, 6), 3, 8, 2), ("SQR", (16, 16), 3, 5, 3)])
def test_h1_kernel_k_table_matches_plain(cuda, lat, shape, p, nk, rows):
    """One launch with a table of nk distinct k-points on nk groups of
    ``rows`` rows (config 5's (l, q) = (5, 6) at its 10 rows a k, and the
    config-3 and config-2 shapes) equals the plain version with the same
    table, every half; a wrong row-group map would put one k's phase on
    another k's rows."""
    from bravais_tpu_torch.cli.config5_all14 import PARAMS
    lattice = make_lattice(lat, **PARAMS.get(lat, {}))
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p)
    c = h1_apply.H1Consts.from_space(sp, np.ones(1), np.ones(1), cuda)
    kt = np.asarray([lattice.k_cart(f) for f in _kfrac_table(nk, sp.dim)],
                    np.float32)
    gen = torch.Generator(device=cuda).manual_seed(7)
    ue = torch.randn((nk * rows * c.nelem,) + (c.l,) * c.d, generator=gen,
                     dtype=torch.complex64, device=cuda)
    for want in ("AM", "A", "M"):
        before = h1_apply.launches
        out = h1_apply.helmholtz_apply(ue, c, kt, want)
        assert h1_apply.launches == before + 1
        ref = h1_apply.helmholtz_apply_plain(ue, c, kt, want)
        for a, b in zip(out, ref):
            if b is not None:
                assert _rel(a, b) < 2e-5, want


def test_h1_kernel_splits_a_large_k_table(cuda):
    """A table of MAX_K·2 + 3 k-points goes out in three launches and
    equals the plain version."""
    lattice = make_lattice("FCC")
    sp = H1Space.make(PeriodicGrid.make(lattice, (2, 2, 2)), 2)
    c = h1_apply.H1Consts.from_space(sp, np.ones(1), np.ones(1), cuda)
    nk = 2 * h1_apply.MAX_K + 3
    kt = np.asarray([lattice.k_cart(f) for f in _kfrac_table(nk, 3)],
                    np.float32)
    gen = torch.Generator(device=cuda).manual_seed(8)
    ue = torch.randn((nk * 2 * c.nelem,) + (c.l,) * c.d, generator=gen,
                     dtype=torch.complex64, device=cuda)
    before = h1_apply.launches
    y, m = h1_apply.helmholtz_apply(ue, c, kt, "AM")
    assert h1_apply.launches == before + 3
    y_pl, m_pl = h1_apply.helmholtz_apply_plain(ue, c, kt, "AM")
    assert _rel(y, y_pl) < 2e-5 and _rel(m, m_pl) < 2e-5


@pytest.mark.parametrize("engine", ["field", "spectral"])
def test_batched_run_on_cuda_matches_cpu(cuda, engine):
    """Config 5 cut to TRI n=3 p=2, the 8 k of KFRAC in one batched
    ``run`` on the card and on the CPU: the same iterations per k (±1)
    and refined bands within 1e-6 relative; on the card every k-batched
    h1 apply is one launch."""
    from bravais_tpu_torch.cli.config5_all14 import build
    out = {}
    for dev in ("cpu", cuda):
        _, kc, op, sweep = build("TRI", 3, 2, 4, 1e-6, 300, engine, dev)
        before = h1_apply.launches
        out[str(dev)] = sweep.run(kc), h1_apply.launches - before
    (rc, _), (rg, launched) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(rg.eigenvalues, rc.eigenvalues, rtol=1e-6)
    assert np.all(np.abs(rg.iterations - rc.iterations) <= 1)
    if engine == "field":
        # start whitening (M), one fused (A, M) per iteration and two per
        # 16-iteration segment: one launch each for all 8 k
        its = int(rg.iterations.max())
        assert launched == 1 + its + 2 * -(-its // 16)



@pytest.mark.parametrize("engine", ["spectral", "project", "project-cheby",
                                    "gmg", "sigma-gmg", "cg", "project-cg"])
def test_batched_engines_on_cuda_match_cpu(cuda, engine):
    """Each engine that ``run`` now batches, three k in one k-batched
    solve on the card and on the CPU: the FCC spectral and "project"
    field engines (n=3 p=2), config 3's sphere on "project-cheby", on
    the σ-shift "gmg" deflation, on the σ-shift "cg" and on "project-cg",
    the last two with the "fastdiag-cg" preconditioner (n=3 p=2),
    config 2's rods with GMG (n=8
    p=2). The same iterations per k (±1), refined bands within 1e-6
    relative (to 1e-2 of the k's top band below it), and on the card
    every element apply of the batch is one launch for the three k: the
    field engines' nd launches equal those of one solve at the batch's
    iteration count, the σ-shift's h1 launches those of its QPGMG
    projections, and the CG projector's h1 launches its L applies."""
    out = {}
    for dev in ("cpu", cuda):
        if engine == "gmg":
            op, _ = _rods_op(8, 2, dev)
            lat = op.space.grid.lattice
            ks = np.asarray([lat.k_cart((0.1, 0.0)), lat.point_cart("X"),
                             lat.point_cart("M")])
            sweep = BandSweep(op, nev=4, block=8, tol=1e-6, maxiter=400,
                              device_tol=1e-4)
        else:
            sphere = engine in ("project-cheby", "sigma-gmg", "cg",
                                "project-cg")
            if sphere:
                op = _sphere_op(3, 2, dev)
            else:
                op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(
                    make_lattice("FCC"), 3), 2), device=dev)
            lat = op.space.grid.lattice
            ks = np.asarray([2e-2 * lat.B[0], lat.point_cart("X"),
                             lat.point_cart("M" if sphere else "W")])
            solve = (op.make_spectral_solve_fn() if engine == "spectral"
                     else op.make_solve_fn(deflation="gmg", precond=None)
                     if engine == "sigma-gmg"
                     else op.make_solve_fn(deflation=engine,
                                           precond="fastdiag-cg",
                                           cg_iters=op.adaptive_cg_iters())
                     if engine in ("cg", "project-cg")
                     else op.make_solve_fn(deflation=engine,
                                           precond="fastdiag"))
            sweep = BandSweep(op, solve, nev=4, block=8, tol=1e-6,
                              maxiter=200,
                              device_tol=1e-3 if engine == "spectral"
                              else 1e-4)
        cg = engine in ("cg", "project-cg")
        applies = _count_Lk(op) if cg else None
        nd0, h10 = nd_apply.launches, h1_apply.launches
        out[str(dev)] = (sweep.run(ks), nd_apply.launches - nd0,
                         h1_apply.launches - h10)
        if cg:
            del op.apply_Lk
    (rc, _, _), (rg, nd, h1) = out["cpu"], out[str(cuda)]
    assert np.all(np.abs(rg.iterations - rc.iterations) <= 1)
    top = np.abs(rc.eigenvalues).max(axis=1, keepdims=True)
    assert np.max(np.abs(rg.eigenvalues - rc.eigenvalues) / np.maximum(
        np.abs(rc.eigenvalues), 1e-2 * top)) < 1e-6
    it = int(rg.iterations.max())
    if engine in ("project", "project-cheby"):
        # the projector on X0, two a iteration (M-half each), the start
        # whitening and the deflated M X (M-half), the fused (A, M) once
        # an iteration and twice a 16-iteration segment
        assert nd == (1 + 2 * it) + (1 + it) + it + 2 * -(-it // 16)
    elif engine == "gmg":
        v = sweep.gmg.launches_per_vcycle()
        assert h1 == v * it + it + 2 * -(-it // 16) + 1
    elif engine == "sigma-gmg":
        # Ã on W once an iteration and on X, P twice a segment; each Ã
        # one nd "A" and three nd "M" (the projector's, the shift's, the
        # pencil's), each projection (X0's and Ã's) QPGMG's h1 launches,
        # plus the X0 projector's and the whitening's M and the coarse
        # assembly's h1.
        a = it + 2 * -(-it // 16)
        per = op.qp_gmg().launches_per_solve()
        assert nd == a + 3 * a + 2
        assert h1 == 1 + per * (1 + a)
    elif engine in ("cg", "project-cg"):
        # as "sigma-gmg" and "project-cheby", and the inner PCG's three
        # fused (A, M) an iteration; each CG step two h1 "A" (L p and the
        # true residual), as the card's run counted them
        a = it + 2 * -(-it // 16)
        pcg = 3 * it
        if engine == "cg":
            assert nd == a + 3 * a + 2 + pcg
        else:
            assert nd == (1 + 2 * it) + (1 + it) + a + pcg
        assert h1 == applies[0] > 0 and h1 % 2 == 0
    else:
        assert nd == h1 == 0


def _count_Lk(op):
    """Counts ``op.apply_Lk`` calls (an instance wrapper the caller
    deletes): [calls]."""
    calls, orig = [0], op.apply_Lk

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)
    op.apply_Lk = counted
    return calls


@pytest.mark.parametrize("table", [False, True], ids=["one-k", "k-table"])
def test_cg_projector_and_inner_pcg_on_cuda_match_cpu(cuda, table):
    """Config 3's operator (CUB ε = 13 sphere, n=6 p=3): the CG gradient
    projector (``adaptive_cg_iters()`` steps, the L-twin's eigh solve as
    preconditioner) and the inner-PCG preconditioner (3 steps) on a
    16-row block at one k, or on (4, 16)-row blocks with a table of 4 k,
    on the card against the CPU's plain path: within 1e-4 relative
    (float32 roundoff through the CG's steps); on the card each CG step
    two h1 "A" launches, one nd "M" a projection (M u), three fused nd
    (A, M) for the inner PCG."""
    lat = make_lattice("CUB")
    kfr = [(0.3, 0.2, 0.1), (0.5, 0.0, 0.0), (0.5, 0.5, 0.0),
           (0.1, 0.25, 0.4)]
    k = (np.asarray([lat.k_cart(f) for f in kfr]) if table
         else lat.k_cart(kfr[0]))
    lead = (4, 16) if table else (16,)
    out = {}
    for dev in ("cpu", cuda):
        op = _sphere_op(6, 3, dev)
        rng = np.random.default_rng(9)
        shp = lead + op.space.field_shape
        u = torch.as_tensor((rng.standard_normal(shp)
                             + 1j * rng.standard_normal(shp)
                             ).astype(np.complex64), device=dev)
        lp = op.fastdiag_L().solver([("L", 1.0)], k, method="eigh")
        applies = _count_Lk(op)
        h1a, ndm = h1_apply.launches_by_want["A"], nd_apply.launches_by_mode
        m0, am0 = ndm["M"], ndm["AM"]
        g = op.gradient_component(u, k, cg_iters=op.adaptive_cg_iters(),
                                  lprecond=lp)
        pc = op.fd_precond_cg(k, inner_iters=3)(u)
        out[str(dev)] = (g, pc, applies[0],
                         h1_apply.launches_by_want["A"] - h1a,
                         ndm["M"] - m0, ndm["AM"] - am0)
        del op.apply_Lk
    g_c, pc_c = out["cpu"][:2]
    g_g, pc_g, applies, h1, m, am = out[str(cuda)]
    assert 0 < applies <= 2 * 11 and applies % 2 == 0
    assert (h1, m, am) == (applies, 1, 3)
    assert _rel(g_g.cpu(), g_c) < 1e-4
    assert _rel(pc_g.cpu(), pc_c) < 1e-4


@pytest.mark.parametrize("table", [False, True], ids=["one-k", "k-table"])
def test_qpgmg_solve_on_cuda_matches_cpu(cuda, table):
    """Config 3's quasi-periodic multigrid (CUB ε = 13 sphere, n=6 p=3:
    levels 6³ p=3, 6³ p=1 and the exact 3³ p=1 coarse solve), three
    cycles on a 16-row block at one k or on (4, 16)-row blocks with a
    table of 4 k: the card (every level apply one h1 "A" launch, the
    coarse assembly one more) against the CPU's plain path, within 1e-5
    relative (float32 roundoff through three cycles)."""
    lat = make_lattice("CUB")
    kfr = [(0.3, 0.2, 0.1), (0.5, 0.0, 0.0), (0.5, 0.5, 0.0),
           (0.1, 0.25, 0.4)]
    k = (np.asarray([lat.k_cart(f) for f in kfr]) if table
         else lat.k_cart(kfr[0]))
    out = {}
    for dev in ("cpu", cuda):
        op = _sphere_op(6, 3, dev)
        lead = (4, 16) if table else (16,)
        rng = np.random.default_rng(8)
        shp = lead + op.h1.dof_shape
        b = (rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
             ).astype(np.complex64)
        gmg = op.qp_gmg()
        before = h1_apply.launches_by_want["A"]
        out[str(dev)] = gmg.solve(k, torch.as_tensor(b, device=dev))
        launches = h1_apply.launches_by_want["A"] - before
    assert [lv.op.space.grid.shape for lv in gmg.levels] == [
        (6, 6, 6), (6, 6, 6), (3, 3, 3)]
    assert launches == gmg.launches_per_solve() + 1
    assert _rel(out[str(cuda)].cpu(), out["cpu"]) < 1e-5


def test_element_kernels_refuse_other_inputs(cuda):
    c = _sphere_op(3, 2, cuda).nd_consts()
    bad = torch.zeros((c.nelem, c.ndof), dtype=torch.complex128,
                      device=cuda)
    with pytest.raises(ValueError):
        nd_apply.nedelec_apply(bad, c)
    with pytest.raises(ValueError):
        nd_apply.nedelec_apply(bad[:-1].to(torch.complex64), c)


def test_apply_AM_on_cuda_matches_cpu(cuda):
    ops = {dev: _sphere_op(4, 2, dev) for dev in ("cpu", cuda)}
    rng = np.random.default_rng(5)
    shp = (3,) + ops["cpu"].space.field_shape
    u = (rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
         ).astype(np.complex64)
    k = np.asarray(make_lattice("CUB").k_cart((0.3, 0.2, 0.1)))
    y_c, m_c = ops["cpu"].apply_AM(torch.as_tensor(u), k)
    y_g, m_g = ops[cuda].apply_AM(torch.as_tensor(u, device=cuda), k)
    assert _rel(y_g.cpu(), y_c) < 2e-5
    assert _rel(m_g.cpu(), m_c) < 2e-5
    L_c = ops["cpu"].apply_Lk(torch.as_tensor(u[:, 0]), k)
    L_g = ops[cuda].apply_Lk(torch.as_tensor(u[:, 0], device=cuda), k)
    assert _rel(L_g.cpu(), L_c) < 2e-5


def test_field_sweep_on_cuda_matches_cpu(cuda):
    """CUB ε-sphere n=4 p=2, three k-points: refined bands equal on both
    devices, and the card's pass launched the nd, h1 and Jacobi kernels."""
    lat = make_lattice("CUB")
    kc = np.asarray([lat.k_cart(f) for f in
                     ((0.02, 0.0, 0.0), (0.25, 0.0, 0.0), (0.5, 0.0, 0.0))])
    out = {}
    for dev in ("cpu", cuda):
        op = _sphere_op(4, 2, dev)
        solve = op.make_solve_fn(deflation="project-cheby",
                                 precond="fastdiag")
        sweep = BandSweep(op, solve, nev=5, block=9, tol=1e-6, maxiter=250,
                          device_tol=1e-4)
        jacobi_cuda.launches = nd_apply.launches = h1_apply.launches = 0
        res = sweep.run_warm(kc)
        out[str(dev)] = (res, (nd_apply.launches, h1_apply.launches,
                               jacobi_cuda.launches),
                         op.cheby_steps())
    (r_cpu, _, _), (r_gpu, (nd, h1, jac), steps) = \
        out["cpu"], out[str(cuda)]
    its = [int(i) for i in r_gpu.iterations]
    assert jac == sum(i + 2 for i in its)
    assert h1 == (steps - 1) * sum(1 + 2 * i for i in its)
    assert nd > 0
    assert np.all(np.abs(r_gpu.iterations - r_cpu.iterations) <= 3)
    np.testing.assert_allclose(r_gpu.eigenvalues, r_cpu.eigenvalues,
                               rtol=1e-6)
    assert np.max(r_gpu.residuals) < 1e-2


def _rods_op(n, p, dev):
    lat = make_lattice("SQR")
    eps = dielectric_rod(8.9, 1.0, 0.2, 0.5 * lat.A.sum(axis=0), lat.A)
    return BlochHelmholtz(H1Space.make(PeriodicGrid.make(lat, n), p),
                          alpha=1.0, beta=eps, device=dev), eps


@pytest.mark.parametrize("n,p", [(16, 3), (16, 1), (8, 1), (2, 1)])
def test_helmholtz_applies_on_cuda_match_cpu(cuda, n, p):
    """Config 2's operator and its multigrid levels' shapes, 16 rows, at
    k ≠ 0: apply_AM, apply_A and apply_M on the card against the CPU."""
    ops = {dev: _rods_op(n, p, dev)[0] for dev in ("cpu", cuda)}
    rng = np.random.default_rng(6)
    shp = (16,) + ops["cpu"].space.dof_shape
    u = (rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
         ).astype(np.complex64)
    k = np.asarray(make_lattice("SQR").k_cart((0.3, 0.1)))
    ug = torch.as_tensor(u, device=cuda)
    y_c, m_c = ops["cpu"].apply_AM(torch.as_tensor(u), k)
    y_g, m_g = ops[cuda].apply_AM(ug, k)
    assert _rel(y_g.cpu(), y_c) < 2e-5
    assert _rel(m_g.cpu(), m_c) < 2e-5
    assert _rel(ops[cuda].apply_A(ug, k).cpu(), y_c) < 2e-5
    assert _rel(ops[cuda].apply_M(ug).cpu(), m_c) < 2e-5


def test_vcycle_on_cuda_matches_cpu(cuda):
    """One GMG V-cycle of config 2 cut to n=8 p=3 (levels (8, p3), (8, p1),
    (4, p1), (2, p1)) on a 4-row block; every operator apply of it is one
    h1 "A" launch."""
    out = {}
    rng = np.random.default_rng(7)
    for dev in ("cpu", cuda):
        op, _ = _rods_op(8, 3, dev)
        gmg = GMG(op)
        shp = (4,) + op.space.dof_shape
        if dev == "cpu":
            b = (rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
                 ).astype(np.complex64)
        k = np.asarray(make_lattice("SQR").k_cart((0.3, 0.1)))
        before = h1_apply.launches_by_want["A"]
        out[str(dev)] = gmg.precond(k)(torch.as_tensor(b, device=dev))
        launches = h1_apply.launches_by_want["A"] - before
    assert launches == gmg.launches_per_vcycle() == 29
    assert _rel(out[str(cuda)].cpu(), out["cpu"]) < 1e-5


def test_scalar_spectral_sweep_on_cuda_matches_cpu(cuda):
    """Config 1 cut small (SQR n=6 p=4, Γ–X–M–Γ npts=5, 4 bands): exact f64
    block eigenvalues on both devices; Jacobi once per iteration and once
    per k."""
    lat = make_lattice("SQR")
    kc = kpath(lat, npts=5).k_cart
    out = {}
    for dev in ("cpu", cuda):
        op = BlochHelmholtz(H1Space.make(PeriodicGrid.make(lat, 6), 4),
                            device=dev)
        sweep = BandSweep(op, op.make_solve_fn(), nev=4, tol=1e-6,
                          maxiter=400, device_tol=1e-3)
        jacobi_cuda.launches = 0
        out[str(dev)] = (sweep.run_warm(kc), jacobi_cuda.launches)
    (r_cpu, _), (r_gpu, launches) = out["cpu"], out[str(cuda)]
    assert launches == int(r_gpu.iterations.sum()) + len(kc)
    assert np.all(np.abs(r_gpu.iterations - r_cpu.iterations) <= 2)
    np.testing.assert_allclose(r_gpu.eigenvalues, r_cpu.eigenvalues,
                               rtol=1e-9, atol=1e-12)
    assert r_gpu.fallbacks == 0 and np.max(r_gpu.residuals) < 1e-10


@pytest.mark.parametrize("mode", ["per-k", "chain-mid", "batched",
                                  "batched-setup"])
def test_warm_chain_on_cuda_matches_cpu(cuda, mode):
    """``run_warm_chain`` on the spectral Maxwell engine (FCC n=3 p=2,
    Γ–X–W at 7 points with Γ nudged, chains of 3, 4 bands in 8, device
    stop 1e-3 then the exact block refine) in each preconditioner mode:
    refined bands equal on both devices (1e-9), iterations within ±2,
    Jacobi once per iteration and once per k, no refine fallback."""
    lat = make_lattice("FCC")
    kc = kpath(lat, npts=7, path=[["G", "X", "W"]]).k_cart.copy()
    kc[0] = 2e-2 * lat.B[0]
    out = {}
    for dev in ("cpu", cuda):
        op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 3), 2),
                           device=dev)
        sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=4, block=8,
                          tol=1e-6, maxiter=200, device_tol=1e-3)
        jacobi_cuda.launches = 0
        out[str(dev)] = (sweep.run_warm_chain(kc, chain=3, precond=mode),
                         jacobi_cuda.launches)
        assert sweep.chain_mode == mode
    (r_cpu, _), (r_gpu, launches) = out["cpu"], out[str(cuda)]
    assert launches == int(r_gpu.iterations.sum()) + len(kc)
    assert np.all(np.abs(r_gpu.iterations - r_cpu.iterations) <= 2)
    np.testing.assert_allclose(r_gpu.eigenvalues, r_cpu.eigenvalues,
                               rtol=1e-9, atol=1e-12)
    assert r_gpu.fallbacks == 0 and np.max(r_gpu.residuals) < 1e-10


def test_rods_gmg_sweep_on_cuda_matches_cpu(cuda):
    """Config 2 cut small (SQR ε = 8.9 rods n=8 p=2, npts=4, 4 bands in a
    block of 8, precond auto → GMG): refined bands equal on both devices,
    and the card's pass launched the h1 kernel as the path calls it."""
    lat = make_lattice("SQR")
    kc = kpath(lat, npts=4).k_cart
    out = {}
    for dev in ("cpu", cuda):
        op, _ = _rods_op(8, 2, dev)
        sweep = BandSweep(op, nev=4, block=8, tol=1e-6, maxiter=400,
                          device_tol=1e-4)
        for want in h1_apply.launches_by_want:
            h1_apply.launches_by_want[want] = 0
        jacobi_cuda.launches = 0
        res = sweep.run_warm(kc)
        out[str(dev)] = (res, dict(h1_apply.launches_by_want),
                         jacobi_cuda.launches, sweep)
    (r_cpu, *_), (r_gpu, h1, jac, sweep) = out["cpu"], out[str(cuda)]
    its = [int(i) for i in r_gpu.iterations]
    assert sweep.precond_mode == "gmg"
    assert h1 == {"A": sweep.gmg.launches_per_vcycle() * sum(its),
                  "AM": sum(i + 2 * -(-i // 16) for i in its),
                  "M": len(its)}
    assert jac == sum(i + 1 for i in its)
    assert np.all(np.abs(r_gpu.iterations - r_cpu.iterations) <= 2)
    np.testing.assert_allclose(r_gpu.eigenvalues, r_cpu.eigenvalues,
                               rtol=1e-6, atol=1e-9)
    assert np.max(r_gpu.residuals) < 1e-3


def test_cli_on_cuda(cuda, tmp_path):
    """``python -m bravais_tpu_torch --device cuda`` on a small TM-rods
    problem (matrix-free, GMG) runs on the card and exits 0."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, "-m", "bravais_tpu_torch", "--device", "cuda",
         "--lattice", "SQR", "--problem", "tm", "--eps-in", "8.9",
         "--radius", "0.2", "--n", "8", "--p", "2", "--nk", "4", "--nev",
         "4", "--out", str(tmp_path)], cwd=repo, capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "f32 on cuda" in r.stdout.splitlines()[0]
    rows = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert [x["k_index"] for x in rows] == [0, 1, 2, 3]
    assert all(np.all(np.isfinite(x["eigenvalues"])) for x in rows)


_D2H = ("cpu", "to", "numpy", "item", "tolist", "__int__", "__float__",
        "__bool__", "__array__")


@pytest.mark.parametrize("engine", ["spectral", "field"])
def test_overlapped_run_warm_on_cuda_equals_serial(cuda, engine,
                                                   monkeypatch):
    """The overlapped ``run_warm`` on the card equals the serial
    composition (per k: the solve, its outputs to the host, the refine,
    then the next solve) exactly, and every read of a card tensor (a copy
    to the host, a scalar) happens on the main thread: the refine's
    worker touches none (no refine falls back here; one that did would
    read its k's block). Spectral: FCC n=3 p=2, 4 k; field: CUB ε-sphere
    n=4 p=2, project-cheby, 3 k."""
    import threading
    if engine == "spectral":
        lat = make_lattice("FCC")
        op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 3), 2),
                           device=cuda)
        sweep = BandSweep(op, op.make_spectral_solve_fn(), nev=4, block=8,
                          tol=1e-6, maxiter=250, device_tol=1e-3,
                          keep_vectors=True)
        kc = kpath(lat, npts=4, path=[["X", "W", "L"]]).k_cart
    else:
        lat = make_lattice("CUB")
        op = _sphere_op(4, 2, cuda)
        solve = op.make_solve_fn(deflation="project-cheby",
                                 precond="fastdiag")
        sweep = BandSweep(op, solve, nev=5, block=9, tol=1e-6, maxiter=250,
                          device_tol=1e-4, keep_vectors=True)
        kc = np.asarray([lat.k_cart(f) for f in ((0.25, 0.0, 0.0),
                                                 (0.5, 0.0, 0.0),
                                                 (0.5, 0.25, 0.0))])
    reads = []

    def spy(name):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, **kw):
            if self.is_cuda:
                reads.append((name, threading.current_thread()))
            return orig(self, *a, **kw)
        return wrapped

    for name in _D2H:
        monkeypatch.setattr(torch.Tensor, name, spy(name))
    got = sweep.run_warm(kc)
    monkeypatch.undo()
    assert reads and all(t is threading.main_thread() for _, t in reads)

    k32 = sweep._rounded(kc)
    X = sweep._x0()
    for i, k in enumerate(k32):
        r, sup = sweep.solve_fn(X, k, sweep.nev, sweep.tol, sweep.maxiter)
        X = r.eigenvectors
        lam, res, fell = sweep._refine_host(
            r.eigenvalues.double().cpu().numpy(),
            None if sup is None else sup.double().cpu().numpy(),
            X.cpu().numpy(), k)
        assert int(r.iterations) == got.iterations[i]
        np.testing.assert_array_equal(got.eigenvalues[i], lam)
        np.testing.assert_array_equal(got.residuals[i], res)
        np.testing.assert_array_equal(got.eigenvectors[i],
                                      X[:sweep.nev].cpu().numpy())
    assert got.fallbacks == 0


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """Two gloo ranks on the one card (``tests/torch_ranks.py ... cuda``):
    rank 0's results, rank 1's."""
    import os
    import pickle
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tmp = tmp_path_factory.mktemp("card_ranks")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests", "torch_ranks.py"),
         str(r), "2", str(tmp / "store"), str(tmp), "cuda"], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), [t[-3000:] for t in logs]
    out = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_sharded_run_on_cuda_equals_one_rank(card_ranks):
    """The FCC headline problem at n=4 over two gloo ranks on the card
    (``run`` with the mesh): every rank returns the one-rank run's bands
    (to 1e-6 relative) and its iterations within ±1 (the batch shape
    moves the float32 reductions)."""
    one = card_ranks[0]["one_rank"]
    for got in card_ranks:
        rel = np.abs(got["run"]["eigenvalues"] - one["eigenvalues"]) \
            / np.abs(one["eigenvalues"])
        assert rel.max() < 1e-6
        assert np.abs(got["run"]["iterations"]
                      - one["iterations"]).max() <= 1


def test_dd_apply_on_cuda_equals_one_rank(card_ranks):
    """The fused field apply of a slab (FCC n=4 p=4, 4 rows, the nd
    kernel) over two gloo ranks on the card, the halo through host
    copies, equals the one-rank apply to 1e-5 relative."""
    for got in card_ranks:
        assert got["transport"] == "gloo via host"
        assert got["dd_err"] < 1e-5
