"""The fused Bloch H1 element apply: the plain torch version of the CUDA
kernel against the JAX Pallas kernel (interpret mode) at k≠0 in 2D and
3D, a torch model of the kernel's shared-stage plan (``csrc/
h1_apply.cu``) against the plain version, and the port's ``QPLaplace``
(the field engine's deflation Laplacian) against the JAX one. Tolerance
2e-6 relative (float32, sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.pallas.h1_apply import helmholtz_block_apply
from bravais_tpu.operators.qplaplace import QPLaplace as QPLRef
from bravais_tpu.spaces.h1 import H1Space as H1Ref
from bravais_tpu_torch.lattices import make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.coefficients import eval_coefficient
from bravais_tpu_torch.operators.h1_apply import (H1Consts,
                                                  helmholtz_apply_plain, work)
from bravais_tpu_torch.operators.qplaplace import QPLaplace
from bravais_tpu_torch.spaces.h1 import H1Space

torch.set_num_threads(1)

TOL = 2e-6
ROWS = 2


def _alpha(x):
    return 1 + 0.3 * x[..., 0] ** 2


def _beta(x):
    return 1 + np.sum(x ** 2, axis=-1)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("lat,shape,p", [
    ("SQR", (4, 4), 2), ("HEX2D", (3, 4), 3),
    ("FCC", (3, 3, 3), 2), ("CUB", (2, 2, 2), 3),
])
def test_plain_matches_pallas_kernel(lat, shape, p):
    """Two block rows at k≠0 through the plain version and, feature-major
    with the coefficients tiled per row, through the JAX kernel."""
    lattice = make_lattice(lat)
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p)
    d = sp.dim
    xq = sp.qpoints_phys()
    a64, b64 = eval_coefficient(_alpha, xq), eval_coefficient(_beta, xq)
    c = H1Consts.from_space(sp, a64, b64, "cpu")
    E, l = c.nelem, p + 1
    ue = _cplx(np.random.default_rng(0), (ROWS * E,) + (l,) * d)
    k = np.asarray(lattice.k_cart([0.3] * d), np.float32)
    y, m = helmholtz_apply_plain(torch.as_tensor(ue), c, k)

    perm = [2 * i for i in range(d)] + [2 * i + 1 for i in range(d)]

    def plane(a):
        e = a.transpose(perm).reshape(E, -1).astype(np.float32)
        return jnp.asarray(np.tile(e, (ROWS, 1)).T)

    fm = ue.reshape(ROWS * E, -1).T
    yr, yi, mr, mi = helmholtz_block_apply(
        jnp.asarray(fm.real), jnp.asarray(fm.imag), plane(a64), plane(b64),
        jnp.asarray(k), B=sp.basis.B.astype(np.float32),
        D=sp.basis.D.astype(np.float32), JinvT=sp.grid.Jinv.T.tolist(),
        Jinv=sp.grid.Jinv.tolist(),
        wq=sp.quad_weight().ravel().astype(np.float32), interpret=True)
    y_ref = (np.asarray(yr) + 1j * np.asarray(yi)).T.reshape(ue.shape)
    m_ref = (np.asarray(mr) + 1j * np.asarray(mi)).T.reshape(ue.shape)
    assert _rel(y.numpy(), y_ref) < TOL
    assert _rel(m.numpy(), m_ref) < TOL


@pytest.mark.parametrize("kfrac", [(0.3, 0.2, 0.1), (0.0, 0.0, 0.0)])
def test_qplaplace_matches_reference(kfrac):
    """The device apply on a two-row block (phases in the gather, the
    kernel's plain version at k = 0 inside) at k ≠ 0 and at Γ, and the
    f64 host twin, against the JAX QPLaplace (the deflation Laplacian)."""
    sp = H1Space.make(PeriodicGrid.make(make_lattice("FCC"), 4), 2)
    spr = H1Ref.make(GridRef.make(make_lattice_ref("FCC"), 4), 2)
    op = QPLaplace(sp, alpha=_beta, device="cpu")
    ref = QPLRef(spr, alpha=_beta, dtype=jnp.complex64)
    u = _cplx(np.random.default_rng(0), (ROWS,) + sp.dof_shape)
    k = np.asarray(make_lattice("FCC").k_cart(kfrac), np.float32)
    y = op.apply_A(torch.as_tensor(u), k).numpy()
    y_ref = np.stack([np.asarray(ref.apply_A(jnp.asarray(x), jnp.asarray(k)))
                      for x in u])
    assert y.shape == u.shape
    assert _rel(y, y_ref) < TOL
    u64 = u[0].astype(np.complex128)
    np.testing.assert_allclose(op.apply_A_np(u64), ref.apply_A_np(u64, None),
                               rtol=1e-12, atol=1e-12)


def _along(x, T, axis, transpose=False):
    """Contract local axis ``axis`` of x (R, n₀, ..., n_{d-1}) with the
    table T (q, l): forward by T, transposed by Tᵀ."""
    y = torch.tensordot(x, T, dims=([1 + axis], [0 if transpose else 1]))
    return torch.movedim(y, -1, 1 + axis)


def _plan_model(ue, c, k, want):
    """The kernel's compile-time plan in torch: forward B·u and D·u once,
    then BB, BD, DB (3D), then the value and the gradients (DB.., BD..,
    ..BD); pointwise h_r = (Jinv f)_r, s = −i k·f, β·w u_q; transposed,
    the terms that share their remaining tables summed before the next
    stage. Returns (y, m) with None for the half not in ``want``."""
    d, E = c.d, c.nelem
    B, D = (t.to(torch.complex64) for t in c.tables)
    R = ue.shape[0]
    wa, wm = "A" in want, "M" in want
    kz = not any(k)
    F = lambda x, T, ax: _along(x, T, ax)              # noqa: E731
    Tt = lambda x, T, ax: _along(x, T, ax, True)       # noqa: E731
    s0B, s0D = F(ue, B, 0), F(ue, D, 0)
    if d == 3:
        BB, BD, DB = F(s0B, B, 1), F(s0B, D, 1), F(s0D, B, 1)
        uq = F(BB, B, 2)
        g = [F(DB, B, 2), F(BD, B, 2), F(BB, D, 2)]
    else:
        uq = F(s0B, B, 1)
        g = [F(s0D, B, 1), F(s0B, D, 1)]
    rows = (R // E,) + (1,) * (d + 1)
    aw = c.alpha_w.repeat(rows).reshape(uq.shape)
    bw = c.beta_w.repeat(rows).reshape(uq.shape)
    y = m = None
    if wa:
        f = [aw * (sum(float(c.JinvT[r, t]) * g[t] for t in range(d))
                   + 1j * float(k[r]) * uq) for r in range(d)]
        h = [sum(float(c.Jinv[r, t]) * f[t] for t in range(d))
             for r in range(d)]
        last = Tt(h[d - 1], D, d - 1)
        if not kz:
            last = last + Tt(-1j * sum(float(k[r]) * f[r] for r in range(d)),
                             B, d - 1)
        if d == 3:
            A0, A1 = Tt(h[0], B, 2), Tt(h[1], B, 2)
            YD, YB = Tt(A0, B, 1), Tt(A1, D, 1) + Tt(last, B, 1)
            y = Tt(YD, D, 0) + Tt(YB, B, 0)
        else:
            y = Tt(Tt(h[0], B, 1), D, 0) + Tt(last, B, 0)
    if wm:
        m = bw * uq
        for ax in reversed(range(d)):
            m = Tt(m, B, ax)
    return y, m


@pytest.mark.parametrize("lat,shape,p,kfrac", [
    ("SQR", (3, 3), 3, 0.0), ("SQR", (3, 3), 3, 0.3),
    ("CUB", (2, 2, 2), 3, 0.0), ("FCC", (2, 2, 2), 2, 0.3)])
def test_kernel_plan_model_matches_plain(lat, shape, p, kfrac):
    """The shared-stage plan gives the plain version's (y, m) for every
    half at k = 0 and k ≠ 0; ``work`` counts no more multiply-adds than
    one contraction chain per term, and fewer where the 3D stiffness half
    shares stages."""
    lattice = make_lattice(lat)
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p)
    xq = sp.qpoints_phys()
    c = H1Consts.from_space(sp, eval_coefficient(_alpha, xq),
                            eval_coefficient(_beta, xq), "cpu")
    k = [float(v) for v in lattice.k_cart([kfrac] * sp.dim)]
    ue = torch.as_tensor(_cplx(np.random.default_rng(2),
                               (ROWS * c.nelem,) + (c.l,) * c.d))
    for want in ("AM", "A", "M"):
        out = _plan_model(ue, c, k, want)
        ref = helmholtz_apply_plain(ue, c, k, want)
        for a, b in zip(out, ref):
            assert (a is None) == (b is None), want
            if b is not None:
                assert _rel(a.numpy(), b.numpy()) < TOL, want
        q, l, d = c.q, c.l, c.d
        chains = (("M" in want or ("A" in want and any(k)))
                  + d * ("A" in want))
        chains += ("A" in want) * (d + any(k)) + ("M" in want)
        per_chain = sum(q ** (i + 1) * l ** (d - i) for i in range(d))
        unshared = 4 * chains * per_chain + q ** d * (
            ("A" in want) * (8 * d * d + 12 * d) + 2 * ("M" in want))
        flops = work(1, c, k, want)[1]
        assert flops <= unshared
        if d == 3 and "A" in want:
            assert flops < unshared


def _pallas_fn(sp, a64, b64, E, rows):
    """The JAX kernel (interpret mode) on ``rows`` block rows of ``E``
    elements, jitted once with k traced: ue ↦ (y, m) at k."""
    import jax
    d = sp.dim
    perm = [2 * i for i in range(d)] + [2 * i + 1 for i in range(d)]

    def plane(a):
        e = a.transpose(perm).reshape(E, -1).astype(np.float32)
        return jnp.asarray(np.tile(e, (rows, 1)).T)

    f = jax.jit(lambda ur, ui, k: helmholtz_block_apply(
        ur, ui, plane(a64), plane(b64), k, B=sp.basis.B.astype(np.float32),
        D=sp.basis.D.astype(np.float32), JinvT=sp.grid.Jinv.T.tolist(),
        Jinv=sp.grid.Jinv.tolist(),
        wq=sp.quad_weight().ravel().astype(np.float32), interpret=True))

    def apply(ue, k):
        fm = ue.reshape(rows * E, -1).T
        yr, yi, mr, mi = (np.asarray(o) for o in f(
            jnp.asarray(fm.real), jnp.asarray(fm.imag), jnp.asarray(k)))
        return ((yr + 1j * yi).T.reshape(ue.shape),
                (mr + 1j * mi).T.reshape(ue.shape))
    return apply


@pytest.mark.parametrize("lat,shape,p,pallas", [
    ("TRI", (2, 2, 2), 4, True), ("HEX2D", (3, 4), 3, False)])
def test_plain_k_table_matches_per_k_calls(lat, shape, p, pallas):
    """A table of 3 k-points, each component different, on 3 groups of
    ``ROWS`` rows: element-row b of the table call is the per-k call at
    k[(b // nelem) // rows_per_k] (the kernel's index map), for every
    half; in 3D at config 5's (l, q) = (5, 6) each group also equals the
    JAX kernel (interpret mode) at its k."""
    from bravais_tpu_torch.cli.config5_all14 import PARAMS
    lattice = make_lattice(lat, **PARAMS.get(lat, {}))
    sp = H1Space.make(PeriodicGrid.make(lattice, shape), p)
    d = sp.dim
    xq = sp.qpoints_phys()
    a64, b64 = eval_coefficient(_alpha, xq), eval_coefficient(_beta, xq)
    c = H1Consts.from_space(sp, a64, b64, "cpu")
    fr = np.array([[0.21, 0.13, 0.17], [0.11, 0.31, 0.07],
                   [0.41, 0.23, 0.11]])[:, :d]
    kt = np.asarray([lattice.k_cart(f) for f in fr], np.float32)
    nk, E = len(kt), c.nelem
    ue = _cplx(np.random.default_rng(4), (nk * ROWS * E,) + (c.l,) * d)
    kidx = (np.arange(ue.shape[0]) // E) // ROWS        # the kernel's map
    pal = _pallas_fn(sp, a64, b64, E, ROWS) if pallas else None
    for want in ("AM", "A", "M"):
        out = helmholtz_apply_plain(torch.as_tensor(ue), c, kt, want)
        for j, k in enumerate(kt):
            sel = kidx == j
            ref = helmholtz_apply_plain(torch.as_tensor(ue[sel]), c, k, want)
            for a, b in zip(out, ref):
                if b is not None:
                    assert _rel(a.numpy()[sel], b.numpy()) < 1e-6, (want, j)
            if pallas and want == "AM":
                y_p, m_p = pal(ue[sel], k)
                assert _rel(out[0].numpy()[sel], y_p) < TOL, j
                assert _rel(out[1].numpy()[sel], m_p) < TOL, j
    assert work(nk * ROWS * E, c, kt, "AM") == work(nk * ROWS * E, c,
                                                    kt[0], "AM")
