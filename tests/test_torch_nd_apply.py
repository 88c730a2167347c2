"""The fused Nédélec element apply: the plain torch version of the CUDA
kernel against the JAX Pallas kernel (interpret mode) on identical
planes (the port's compact element layout padded to the kernel's), the
port's field-engine applies A, M, (A, M) against the JAX stacked
applies, and a torch model of the CUDA kernel's compile-time plan
(``csrc/nd_apply.cu``) against both and against ``work``'s count.
Tolerance 2e-5 relative (float32, sums in another order; the bound of
``test_pallas_kernel.py``), 1e-5 for the plan model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.operators.pallas.nd_apply import nedelec_block_apply
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import eval_coefficient
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.operators.nd_apply import (NdConsts, comp_shapes,
                                                  nedelec_apply_plain, work)
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

torch.set_num_threads(1)

TOL = 2e-5
ROWS = 2
CASES = [("FCC", 3, 2), ("CUB", 3, 1), ("HEX", 3, 3)]


def _eps(x):
    return 1 + 0.4 * x[..., 0] ** 2


def _mu_inv(x):
    return 1 + 0.2 * np.sum(x ** 2, axis=-1)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _padded(ue, p):
    """Compact element dofs (N, 3·p·l²) -> the Pallas kernel's (N, 3, l,
    l, l), a zero slot at the end of each component's open axis."""
    l = p + 1
    out = np.zeros((ue.shape[0], 3, l, l, l), ue.dtype)
    off = 0
    for c, ext in enumerate(comp_shapes(p)):
        size = int(np.prod(ext))
        out[(slice(None), c) + tuple(slice(0, e) for e in ext)] = \
            ue[:, off:off + size].reshape((-1,) + ext)
        off += size
    return out


def _compact(up, p):
    """Inverse of :func:`_padded` (pad slots dropped)."""
    return np.concatenate(
        [up[(slice(None), c) + tuple(slice(0, e) for e in ext)].reshape(
            up.shape[0], -1) for c, ext in enumerate(comp_shapes(p))], axis=1)


@pytest.mark.parametrize("lat,n,p", CASES)
def test_plain_matches_pallas_kernel(lat, n, p):
    """Two block rows of element dofs through the plain version and,
    padded and feature-major with the coefficient planes tiled per row,
    through the JAX kernel; the "A" and "M" halves equal the fused call's
    and the kernel's outputs are zero in the pad slots."""
    sp = NedelecSpace.make(PeriodicGrid.make(make_lattice(lat), n), p)
    xq = sp.qpoints_phys()
    c = NdConsts.from_space(sp, eval_coefficient(_eps, xq),
                            eval_coefficient(_mu_inv, xq), "cpu")
    l, E = p + 1, c.nelem
    ue = _cplx(np.random.default_rng(1), (ROWS * E, 3 * p * l * l))
    y, m = nedelec_apply_plain(torch.as_tensor(ue), c)
    ya, _ = nedelec_apply_plain(torch.as_tensor(ue), c, "A")
    _, mm = nedelec_apply_plain(torch.as_tensor(ue), c, "M")
    np.testing.assert_array_equal(ya.numpy(), y.numpy())
    np.testing.assert_array_equal(mm.numpy(), m.numpy())

    up = _padded(ue, p)
    np.testing.assert_array_equal(_compact(up, p), ue)
    fm = up.reshape(ROWS * E, -1).T                # (3·l³, rows·E)

    def plane(t):
        return jnp.asarray(np.tile(t.numpy().reshape(E, -1), (ROWS, 1)).T)

    embed = (lambda T: np.pad(T, ((0, 0), (0, 1))))
    yr, yi, mr, mi = nedelec_block_apply(
        jnp.asarray(fm.real), jnp.asarray(fm.imag), plane(c.muw),
        plane(c.epsw), Bc=sp.closed.B, Dc=sp.closed.D,
        Bo=embed(sp.open.B), Do=embed(sp.open.D), J=sp.grid.J.tolist(),
        Ginv=sp.grid.Ginv.tolist(), detJ=float(np.linalg.det(sp.grid.J)),
        interpret=True)
    y_ref = (np.asarray(yr) + 1j * np.asarray(yi)).T.reshape(up.shape)
    m_ref = (np.asarray(mr) + 1j * np.asarray(mi)).T.reshape(up.shape)
    for t in (y_ref, m_ref):
        np.testing.assert_array_equal(_padded(_compact(t, p), p), t)
    assert _rel(y.numpy(), _compact(y_ref, p)) < TOL
    assert _rel(m.numpy(), _compact(m_ref, p)) < TOL


@pytest.mark.parametrize("lat,n,p", CASES)
def test_applies_match_reference(lat, n, p):
    """apply_A, apply_M and apply_AM on a two-row block at k≠0 with
    varying ε and μ⁻¹ against the JAX stacked apply_A / apply_M of each
    row."""
    op = BlochCurlCurl(NedelecSpace.make(
        PeriodicGrid.make(make_lattice(lat), n), p), eps=_eps,
        mu_inv=_mu_inv, device="cpu")
    ref = CurlRef(NedRef.make(GridRef.make(make_lattice_ref(lat), n), p),
                  eps=_eps, mu_inv=_mu_inv, dtype=jnp.complex64)
    u = _cplx(np.random.default_rng(2), (ROWS,) + op.space.field_shape)
    k = np.asarray(make_lattice(lat).k_cart([0.3, 0.2, 0.1]), np.float32)
    ut = torch.as_tensor(u)
    y, m = op.apply_AM(ut, k)
    kj = jnp.asarray(k)
    y_ref = np.stack([np.asarray(ref.apply_A(jnp.asarray(x), kj)) for x in u])
    m_ref = np.stack([np.asarray(ref.apply_M(jnp.asarray(x), kj)) for x in u])
    assert y.shape == u.shape and m.shape == u.shape
    assert _rel(y.numpy(), y_ref) < TOL
    assert _rel(m.numpy(), m_ref) < TOL
    assert _rel(op.apply_A(ut, k).numpy(), y_ref) < TOL
    assert _rel(op.apply_M(ut, k).numpy(), m_ref) < TOL


PLAN_TOL = 1e-5
_CLOSED = ((1, 2), (0, 2), (0, 1))   # a component's closed axes, ascending


def _along(x, T, axis, transpose=False, count=None):
    """Contract local axis ``axis`` of x (N, n₀, n₁, n₂) with the table T
    (q, n): forward by T (n → q), transposed by Tᵀ (q → n). Adds the
    multiply-adds of one element-row to ``count[0]``."""
    y = torch.movedim(torch.tensordot(
        x, T, dims=([1 + axis], [0 if transpose else 1])), -1, 1 + axis)
    if count is not None:
        count[0] += y[0].numel() * x.shape[1 + axis]
    return y


def _plan_model(ue, c, want, count=None):
    """The kernel's plan in torch. Forward, per component t: its closed
    axes r1 < r2 first (B·u, D·u; then BB, BD, DB), its open axis last (the
    value and d_{r2}, d_{r1}); pointwise g = ε·w Ginv uₕ and cf = μ⁻¹·w K ĉ
    with K = JᵀJ/detJ²; transposed, per component c: its open axis first
    (q → p), then a2, then a1 (its closed axes, a1 < a2), the two curl terms
    summed in the last stage, signed −1 for c = 1. Returns (y, m) with
    None for the half not in ``want``."""
    Tab = c.tables.to(torch.complex64)
    Bc, Dc, Bo = Tab[0], Tab[1], Tab[2][:, :c.p]
    N, n, E = ue.shape[0], c.p * c.l * c.l, c.nelem
    wa, wm = "A" in want, "M" in want
    F = lambda x, T, ax: _along(x, T, ax, False, count)        # noqa: E731
    Tt = lambda x, T, ax: _along(x, T, ax, True, count)        # noqa: E731
    val, der = {}, {}
    for t, ext in enumerate(comp_shapes(c.p)):
        u = ue[:, t * n:(t + 1) * n].reshape((N,) + ext)
        r1, r2 = _CLOSED[t]
        B1 = F(u, Bc, r1)
        if wm:
            val[t] = F(F(B1, Bc, r2), Bo, t)
        if wa:
            der[r2, t] = F(F(B1, Dc, r2), Bo, t)
            der[r1, t] = F(F(F(u, Dc, r1), Bc, r2), Bo, t)
    rows = N // E
    muw = c.muw.repeat(rows, 1, 1, 1)
    epsw = c.epsw.repeat(rows, 1, 1, 1)
    K = c.J.T @ c.J / c.detJ ** 2
    if wm:
        g = [epsw * sum(float(c.Ginv[r, s]) * val[s] for s in range(3))
             for r in range(3)]
    if wa:
        ch = [der[(r + 1) % 3, (r + 2) % 3] - der[(r + 2) % 3, (r + 1) % 3]
              for r in range(3)]
        cf = [muw * sum(float(K[r, s]) * ch[s] for s in range(3))
              for r in range(3)]
    ys, ms = [], []
    for comp in range(3):
        a1, a2 = _CLOSED[comp]
        if wa:
            Y1 = Tt(Tt(cf[a2], Bo, comp), Bc, a2)
            Y2 = Tt(Tt(cf[a1], Bo, comp), Dc, a2)
            sign = -1.0 if comp == 1 else 1.0
            ys.append(sign * (Tt(Y2, Bc, a1) - Tt(Y1, Dc, a1)))
        if wm:
            ms.append(Tt(Tt(Tt(g[comp], Bo, comp), Bc, a2), Bc, a1))

    def flat(parts):
        return torch.cat([t.reshape(N, n) for t in parts], dim=1)

    return (flat(ys) if wa else None), (flat(ms) if wm else None)


def _random_consts(p, seed):
    """FCC n=2 tables and metric with random ε·w, μ⁻¹·w planes that vary
    by element and by quadrature point."""
    sp = NedelecSpace.make(PeriodicGrid.make(make_lattice("FCC"), 2), p)
    E, q = int(np.prod(sp.grid.shape)), sp.q
    rng = np.random.default_rng(seed)
    return sp, NdConsts(sp.closed.B, sp.closed.D, sp.open.B, sp.open.D,
                        rng.uniform(0.5, 2.0, (E, q, q, q)),
                        rng.uniform(1.0, 13.0, (E, q, q, q)), sp.grid.J,
                        sp.grid.Ginv, np.linalg.det(sp.grid.J), "cpu")


@pytest.mark.parametrize("p", [2, 3])
def test_plan_model_matches_plain_and_pallas(p):
    """Every half of the plan model against the plain version and against
    the Pallas kernel in interpret mode, on a non-orthogonal lattice with
    random per-element ε and μ⁻¹."""
    sp, c = _random_consts(p, 10 + p)
    E, l = c.nelem, p + 1
    ue = _cplx(np.random.default_rng(p), (ROWS * E, 3 * p * l * l))
    fm = _padded(ue, p).reshape(ROWS * E, -1).T

    def plane(t):
        return jnp.asarray(np.tile(t.numpy().reshape(E, -1), (ROWS, 1)).T)

    embed = (lambda T: np.pad(T, ((0, 0), (0, 1))))
    yr, yi, mr, mi = nedelec_block_apply(
        jnp.asarray(fm.real), jnp.asarray(fm.imag), plane(c.muw),
        plane(c.epsw), Bc=sp.closed.B, Dc=sp.closed.D,
        Bo=embed(sp.open.B), Do=embed(sp.open.D), J=sp.grid.J.tolist(),
        Ginv=sp.grid.Ginv.tolist(), detJ=float(np.linalg.det(sp.grid.J)),
        interpret=True)
    shape = (ROWS * E, 3, l, l, l)
    pallas = [_compact((np.asarray(re) + 1j * np.asarray(im)).T.reshape(
        shape), p) for re, im in ((yr, yi), (mr, mi))]
    ut = torch.as_tensor(ue)
    for want in ("AM", "A", "M"):
        out = _plan_model(ut, c, want)
        ref = nedelec_apply_plain(ut, c, want)
        for a, b, pl in zip(out, ref, pallas):
            assert (a is None) == (b is None), want
            if b is not None:
                assert _rel(a.numpy(), b.numpy()) < PLAN_TOL, want
                assert _rel(a.numpy(), pl) < PLAN_TOL, want


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_work_counts_the_plan(p):
    """``work`` counts the plan model's multiply-adds (4 flops each) and
    the kernel's pointwise flops (48 a point for the curl, K and μ⁻¹·w;
    42 for Ginv and ε·w), fewer than one unshared contraction chain per
    term in each direction."""
    _, c = _random_consts(p, 0)
    q, l = c.q, c.l
    ue = torch.zeros((c.nelem, c.ndof), dtype=torch.complex64)
    for want in ("AM", "A", "M"):
        count = [0]
        _plan_model(ue, c, want, count)
        wa, wm = "A" in want, "M" in want
        point = q ** 3 * (48 * wa + 42 * wm)
        nbytes, flops = work(5 * c.nelem, c, want)
        assert flops == 5 * c.nelem * (4 * count[0] + point), want
        assert nbytes == 5 * c.nelem * c.ndof * 8 * (1 + wa + wm) \
            + c.nelem * q ** 3 * 4 * (wa + wm)
        chain = sum(q * e0 * e1 * e2 + q * q * e1 * e2 + q ** 3 * e2
                    + q ** 3 * e0 + q * q * e0 * e1 + q * e0 * e1 * e2
                    for e0, e1, e2 in comp_shapes(c.p))
        assert count[0] < (wm + 2 * wa) * chain, want
