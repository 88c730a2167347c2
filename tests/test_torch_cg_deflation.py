"""The field engine's CG gradient projector, the fast-diagonal projector,
the inner-PCG preconditioner and the solves built on them against the JAX
reference, complex128 on the CPU (the reference's Pallas kernels are off
there), on CUB with an ε = 13 sphere (r = 0.25a) at n=3 p=2 and on the
FCC empty lattice for the element-invariant cases:

* ``coef_contrast``, ``adaptive_cg_iters`` and the CG's Jacobi diagonal
  (``h1_diag0`` against the reference's ``_h1_diag0``): 1e-14;
* ``gradient_component`` at a generic k and at the nudged Γ, with Jacobi
  (60 steps) and with the L-twin's eigh solve as ``lprecond`` (25 steps),
  against the reference vmapped over the rows: 1e-10 per row;
* one CG per row: in a block of a pure gradient, a zero row and a random
  row, which leave the loop at different steps, each row equals its own
  projection alone, and the result differs from one CG over the whole
  block with shared α and β; a k table equals each k alone;
* ports of the reference's ``test_projection_removes_gradients`` and
  ``test_deflation_projector_exact`` at their bars, and
  ``gradient_component_fd``/``project_out_gradients`` against the
  reference per row (1e-10);
* ``fd_precond_cg`` at ``inner_iters`` 3 and 4 against the reference
  vmapped over rows: 1e-10;
* the solves from the same seeded block against the reference's: the
  default ``make_solve_fn()`` ("cg" with the sweep's Jacobi),
  ``deflation="project-cg", precond="fastdiag-cg"`` and
  ``deflation="fastdiag"`` (FCC): eigenvalues 1e-9, iterations ±1; the
  batched form of "fastdiag" against its one-k solves; σ = ``fd_sigma(m)``
  with m the block's rows under a k-batched start block.

The reference's three solves and four vmapped helpers are jitted once
each (most of the file's time with the port's plain-path solves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.eigen.precond import jacobi as jacobi_ref
from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.coefficients import \
    dielectric_sphere as sphere_ref
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import dielectric_sphere
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

KFRAC = (0.31, 0.17, 0.05)
NEV, M, TOL, MAXITER = 4, 8, 1e-6, 300


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def _pair(name, sphere):
    """(port operator on the CPU, reference operator), complex128."""
    lat, latr = make_lattice(name), make_lattice_ref(name)
    c = 0.5 * lat.A.sum(axis=0)
    eps = dielectric_sphere(13.0, 1.0, 0.25, c, lat.A) if sphere else 1.0
    eps_r = sphere_ref(13.0, 1.0, 0.25, c, latr.A, 0.0) if sphere else 1.0
    op = BlochCurlCurl(NedelecSpace.make(PeriodicGrid.make(lat, 3), 2),
                       eps=eps, dtype=torch.complex128, device="cpu")
    ref = CurlRef(NedRef.make(GridRef.make(latr, 3), 2), eps=eps_r,
                  dtype=jnp.complex128)
    return lat, op, ref


@pytest.fixture(scope="module")
def cub():
    lat, op, ref = _pair("CUB", True)
    ref.fastdiag_L()          # host stencils outside every trace
    ref.qp_L()
    return lat, op, ref


@pytest.fixture(scope="module")
def fcc():
    return _pair("FCC", False)


def _ks(lat):
    return {"generic": lat.k_cart(KFRAC), "nudged-gamma": 2e-2 * lat.B[0]}


@pytest.mark.parametrize("case", ["CUB sphere", "FCC"])
def test_contrast_budget_and_diagonal_match_reference(case, cub, fcc):
    _, op, ref = cub if case == "CUB sphere" else fcc
    assert abs(op.coef_contrast() - ref.coef_contrast()) <= \
        1e-14 * ref.coef_contrast()
    assert op.adaptive_cg_iters() == ref.adaptive_cg_iters() == (
        11 if case == "CUB sphere" else 8)
    d = op.h1_diag0
    assert d.dtype == torch.float64 and d.shape == op.h1.dof_shape
    want = np.asarray(ref._h1_diag0)
    assert np.max(np.abs(d.numpy() - want)) <= 1e-14 * np.abs(want).max()


@pytest.fixture(scope="module")
def gc_ref(cub):
    """The reference's gradient component vmapped over rows, jitted once
    per (budget, preconditioner): Jacobi at 60 steps, the L-twin at 25."""
    _, _, ref = cub

    def make(cg_iters, twin):
        def f(u, k):
            lp = (ref.fastdiag_L().solver([("L", 1.0)], k, method="eigh")
                  if twin else None)
            return jax.vmap(lambda x: ref.gradient_component(
                x, k, cg_iters, lp))(u)
        return jax.jit(f)
    return {False: make(60, False), True: make(25, True)}


@pytest.mark.parametrize("twin", [False, True], ids=["jacobi", "l-twin"])
@pytest.mark.parametrize("where", ["generic", "nudged-gamma"])
def test_gradient_component_matches_reference(cub, gc_ref, where, twin):
    lat, op, _ = cub
    k = _ks(lat)[where]
    u = _rand((3,) + op.space.field_shape, 11)
    lp = (op.fastdiag_L().solver([("L", 1.0)], k, method="eigh")
          if twin else None)
    got = op.gradient_component(torch.as_tensor(u), k,
                                cg_iters=25 if twin else 60,
                                lprecond=lp).numpy()
    want = np.asarray(gc_ref[twin](jnp.asarray(u), jnp.asarray(k)))
    for i in range(3):
        assert _rel(got[i], want[i]) < 1e-10, i


def _shared_cg(op, u, k, iters):
    """One Jacobi-preconditioned CG over the whole block (one α, one β for
    every row): the method a per-row CG must not be."""
    rhs = op.apply_GkH(op.apply_M(u, k), k)
    d = op.h1_diag0
    x, r = torch.zeros_like(rhs), rhs
    p = z = r / d
    rz = torch.vdot(r.ravel(), z.ravel()).real
    for _ in range(iters):
        Ap = op.apply_Lk(p, k)
        a = rz / torch.vdot(p.ravel(), Ap.ravel()).real
        x, r = x + a * p, r - a * Ap
        z = r / d
        rzn = torch.vdot(r.ravel(), z.ravel()).real
        p, rz = z + (rzn / rz) * p, rzn
    return op.apply_Gk(x, k)


def test_rows_run_their_own_cg(cub):
    """A block of a pure gradient, a zero row and a random row at 8 and 60
    CG steps: the rows leave the CG at different steps (counted by the L
    applies each row alone takes: the zero row at once), each row of the
    block equals its projection alone, the converged gradient comes back
    as itself, and at 8 steps one CG over the whole block with shared α
    and β gives another result."""
    lat, op, _ = cub
    k = lat.k_cart(KFRAC)
    g = op.apply_Gk(torch.as_tensor(_rand((1,) + op.h1.dof_shape, 3)), k)
    u = torch.as_tensor(_rand((1,) + op.space.field_shape, 4))
    blk = torch.cat([g, torch.zeros_like(g), u])
    orig, calls = op.apply_Lk, []

    def counted(*a, **kw):
        calls[-1] += 1
        return orig(*a, **kw)

    for iters in (8, 60):
        got = op.gradient_component(blk, k, cg_iters=iters)
        steps = []
        op.apply_Lk = counted
        try:
            for i in range(3):
                calls.append(0)
                alone = op.gradient_component(blk[i:i + 1], k, cg_iters=iters)
                steps.append(calls[-1] // 2)
                if i == 1:
                    assert not alone.any() and not got[1].any()
                else:
                    assert _rel(got[i:i + 1], alone) < 1e-12, (iters, i)
        finally:
            del op.apply_Lk
        assert steps[1] == 0 and 0 < steps[0] <= iters
        assert 0 < steps[2] <= iters, steps
        if iters == 60:
            # Converged: the gradient comes back as itself (and a shared-α
            # CG, converged too, cannot be told apart).
            assert _rel(got[0], g[0]) < 1e-10
        else:
            shared = _shared_cg(op, blk, k, iters)
            assert max(_rel(shared[i], got[i]) for i in (0, 2)) > 1e-3


def test_k_table_equals_each_k(cub):
    """``gradient_component`` (L-twin) and ``fd_precond_cg`` with a table of
    two k on (2, rows, ...) blocks equal each k's own call."""
    lat, op, _ = cub
    ks = np.stack(list(_ks(lat).values()))
    u = torch.as_tensor(_rand((2, 2) + op.space.field_shape, 5))
    lp = op.fastdiag_L().solver([("L", 1.0)], ks, method="eigh")
    got = op.gradient_component(u, ks, cg_iters=25, lprecond=lp)
    pc = op.fd_precond_cg(ks, inner_iters=3)(u)
    for j, k in enumerate(ks):
        lpj = op.fastdiag_L().solver([("L", 1.0)], k, method="eigh")
        assert _rel(got[j], op.gradient_component(
            u[j], k, cg_iters=25, lprecond=lpj)) < 1e-12
        assert _rel(pc[j], op.fd_precond_cg(k, inner_iters=3)(u[j])) < 1e-12


def test_projection_removes_gradients():
    """The reference's test of the same name (CUB n=2 p=2, ε = 1, 60 CG
    steps, at its bars): a gradient projects to nothing, and the
    projection is idempotent."""
    lat = make_lattice("CUB")
    sp = NedelecSpace.make(PeriodicGrid.make(lat, 2), 2)
    op = BlochCurlCurl(sp, dtype=torch.complex128, device="cpu")
    k = np.asarray([0.4, -0.7, 0.2])
    g = op.apply_Gk(torch.as_tensor(_rand((1,) + op.h1.dof_shape, 6)), k)
    g = g / torch.linalg.vector_norm(g)
    pg = op.project_out_gradients(g, k, cg_iters=60)
    assert float(torch.linalg.vector_norm(pg)) < 1e-6
    u = torch.as_tensor(_rand((1,) + sp.field_shape, 7))
    pu = op.project_out_gradients(u, k, cg_iters=60)
    ppu = op.project_out_gradients(pu, k, cg_iters=60)
    assert _rel(ppu, pu) < 1e-5


def test_deflation_projector_exact(fcc):
    """The reference's test of the same name (FCC n=3 p=2, the direct
    fast-diagonal projector ``gradient_component_fd``, at its bars), and
    the projector and ``project_out_gradients`` against the reference per
    row (1e-10)."""
    lat, op, ref = fcc
    k = np.array([0.37, -0.21, 0.55])
    phi = torch.as_tensor(_rand((1,) + op.h1.dof_shape, 2))
    g = op.apply_Gk(phi, k)
    assert _rel(op.gradient_component_fd(g, k), g) < 1e-10
    u = torch.as_tensor(_rand((2,) + op.space.field_shape, 3))
    pu = op.gradient_component_fd(u, k)
    assert _rel(op.gradient_component_fd(pu, k), pu) < 1e-9
    # The deflated remainder is divergence-free: Gᴴ M (u − P u) = 0.
    w = op.apply_GkH(op.apply_M(u - pu, k), k)
    w0 = op.apply_GkH(op.apply_M(u, k), k)
    assert float(torch.linalg.vector_norm(w)
                 / torch.linalg.vector_norm(w0)) < 1e-9
    qu = op.project_out_gradients(u, k, cg_iters=25)
    pu_r, qu_r = jax.jit(jax.vmap(lambda x, kk: (
        ref.gradient_component_fd(x, kk),
        ref.project_out_gradients(x, kk, 25)), in_axes=(0, None)))(
        jnp.asarray(u.numpy()), jnp.asarray(k))
    for i in range(2):
        assert _rel(pu[i], pu_r[i]) < 1e-10
        assert _rel(qu[i], qu_r[i]) < 1e-10


@pytest.mark.parametrize("inner,shift", [(3, None), (4, 37.0)])
def test_fd_precond_cg_matches_reference(cub, inner, shift):
    """``fd_precond_cg`` (and with a ``shift``, ``fd_precond``) against the
    reference vmapped over rows."""
    lat, op, ref = cub
    k = lat.k_cart(KFRAC)
    R = _rand((3,) + op.space.field_shape, 12)
    Rt, Rj, kj = torch.as_tensor(R), jnp.asarray(R), jnp.asarray(k)
    got = op.fd_precond_cg(k, shift, inner_iters=inner)(Rt).numpy()
    pcr = ref.fd_precond_cg(kj, shift, inner_iters=inner)
    want = np.asarray(jax.jit(jax.vmap(pcr))(Rj))
    pairs = [(got, want)]
    if shift is not None:
        pairs.append((op.fd_precond(k, shift)(Rt).numpy(), np.asarray(
            jax.vmap(ref.fd_precond(kj, shift))(Rj))))
    for g, w in pairs:
        for i in range(3):
            assert _rel(g[i], w[i]) < 1e-10, i


SOLVES = {
    "default": ("cub", {}),
    "project-cg": ("cub", {"deflation": "project-cg",
                           "precond": "fastdiag-cg"}),
    "fastdiag": ("fcc", {"deflation": "fastdiag"}),
}


def _x0(op):
    return _rand((M,) + op.space.field_shape, 7)


@pytest.fixture(scope="module")
def solves(cub, fcc):
    """{name: (the port's solve, the reference's)} of each of ``SOLVES`` at
    the generic k from the seeded block. The reference's ``make_solve_fn``
    gets the same keywords and, as its sweep hands it, Jacobi on
    ``diag_A``; its jitted solves run on a worker thread beside the
    port's (both release the interpreter lock while they compute)."""
    from concurrent.futures import ThreadPoolExecutor

    def reference(lat, op, ref, kw):
        solve_r = ref.make_solve_fn(**kw)
        k = jnp.asarray(lat.k_cart(KFRAC))
        rr = jax.jit(lambda X0, kk: solve_r(
            ref, X0, kk, NEV, TOL, MAXITER, jacobi_ref(ref.diag_A(kk))))(
            jnp.asarray(_x0(op)), k)
        return (np.asarray(rr.eigenvalues), int(rr.iterations),
                bool(np.all(rr.converged)))

    with ThreadPoolExecutor(max_workers=1) as pool:
        futures = {name: pool.submit(reference, *(cub if which == "cub"
                                                  else fcc), kw)
                   for name, (which, kw) in SOLVES.items()}
        out = {}
        for name, (which, kw) in SOLVES.items():
            lat, op, _ = cub if which == "cub" else fcc
            out[name] = op.make_solve_fn(**kw)(
                torch.as_tensor(_x0(op)), lat.k_cart(KFRAC), NEV, TOL,
                MAXITER)[0]
        return {name: (out[name], f.result()) for name, f in futures.items()}


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_matches_reference(solves, name):
    """The port's solve against the reference's with the same keywords,
    from the same block: eigenvalues within 1e-9, iterations within ±1."""
    r, (lam_r, its_r, conv_r) = solves[name]
    assert abs(int(r.iterations) - its_r) <= 1
    assert np.max(np.abs(r.eigenvalues.numpy() - lam_r)
                  / np.abs(lam_r)) < 1e-9
    assert bool(r.converged.all()) and conv_r


def test_batched_fastdiag_solve_equals_one_k(fcc, solves):
    """``deflation="fastdiag"`` with a table of two k (the generic k and X)
    from the shared block against each k's one-k solve."""
    lat, op, _ = fcc
    ks = np.stack([lat.k_cart(KFRAC), lat.point_cart("X")])
    solve = op.make_solve_fn(deflation="fastdiag")
    assert solve.batched
    X0 = torch.as_tensor(_x0(op))
    rb = solve(X0, ks, NEV, TOL, MAXITER)[0]
    assert rb.eigenvalues.shape == (2, NEV)
    for j, r in enumerate((solves["fastdiag"][0],
                           solve(X0, ks[1], NEV, TOL, MAXITER)[0])):
        assert abs(int(rb.iterations[j]) - int(r.iterations)) <= 1
        assert _rel(rb.eigenvalues[j], r.eigenvalues) < 1e-9


def test_fd_sigma_takes_the_block_rows(cub):
    """Under a fast-diagonal preconditioner the σ-shift is ``fd_sigma(m)``
    with m the start block's rows, also when X0 is k-batched
    (nk, m, ...) with nk ≠ m; ``sigma`` overrides it."""
    lat, op, _ = cub
    ks = np.stack([lat.k_cart(KFRAC), lat.point_cart("X")])
    seen = []
    orig = op.fd_sigma

    def spy(m):
        seen.append(m)
        return orig(m)

    op.fd_sigma = spy
    try:
        X0 = torch.as_tensor(_x0(op))
        Xk = torch.stack([X0, 2.0 * X0])               # (nk, m, ...), nk=2
        for pc, X, k in (("fastdiag", Xk, ks), ("fastdiag-cg", X0, ks),
                         ("fastdiag", X0, ks[0])):
            op.make_solve_fn(deflation="fastdiag", precond=pc)(
                X, k, NEV, TOL, 1)
        op.make_solve_fn(deflation="fastdiag", precond="fastdiag",
                         sigma=5.0)(Xk, ks, NEV, TOL, 1)
    finally:
        del op.fd_sigma
    assert seen == [M, M, M]
