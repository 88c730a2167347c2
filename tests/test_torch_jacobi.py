"""The port's Jacobi eigensolver on the CPU: the plain torch version
against SciPy, the JAX ``jacobi_eigh`` and the Pallas kernel (interpret
mode), and a numpy model of the CUDA kernel's schedule (``csrc/
jacobi_eigh.cu``: thread items, one barrier per round, mirror writes, the
bye of odd n, the in-kernel rank sort) against the plain version. The
CUDA kernel's own tests are in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from bravais_tpu.eigen.jacobi_eigh import jacobi_eigh as jacobi_ref
from bravais_tpu.eigen.pallas_jacobi import jacobi_eigh_pallas
from bravais_tpu_torch.eigen.jacobi_cuda import (MAX_ITEMS, MAX_N,
                                                launch_shape)
from bravais_tpu_torch.eigen.jacobi_eigh import (jacobi_eigh,
                                                jacobi_eigh_plain,
                                                plain_sweeps_run,
                                                round_robin_pairs)

torch.set_num_threads(1)


def _rand_herm(n, seed, spectrum=None):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Q = np.linalg.qr(A)[0]
    if spectrum is None:
        spectrum = rng.standard_normal(n) * 10
    H = (Q * spectrum) @ Q.conj().T
    return 0.5 * (H + H.conj().T)


def _graded45():
    """The graded 45×45 matrix of the reference's
    ``test_graded_matrix_f32_low_accuracy``."""
    n = 45
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = np.eye(n) + 0.3 * (A + A.conj().T) / np.sqrt(n)
    d = np.sqrt(np.concatenate([np.linspace(1, 1.01, 10),
                                np.geomspace(10.0, 1e6, n - 10)]))
    H = d[:, None] * A * d[None, :]
    return 0.5 * (H + H.conj().T)


def _pallas_matrices():
    """Plain, graded and degenerate 48×48 matrices of the reference's
    ``test_pallas_fused_sweep_matches_xla``."""
    rng = np.random.default_rng(7)
    n = 48
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = 0.5 * (A + A.conj().T)
    d = np.logspace(0, 4, n)
    Hg = H * np.sqrt(d[:, None] * d[None, :]) / 1e4
    Q, _ = np.linalg.qr(A)
    w0 = np.sort(np.concatenate([np.repeat([1.0, 2.0], 6),
                                 rng.uniform(3, 40, n - 12)]))
    Hd = (Q * w0[None, :]) @ Q.conj().T
    return [H, Hg, 0.5 * (Hd + Hd.conj().T)]


def _check_c64(M, w, V, w_ref):
    """The f32-level gates of the reference's Pallas parity test."""
    n = M.shape[-1]
    scale = np.maximum(np.abs(w_ref), 1e-3 * np.abs(w_ref).max())
    assert np.max(np.abs(w - w_ref) / scale) < 5e-4
    R = M.astype(np.complex64) @ V - V * w[None, :]
    assert np.linalg.norm(R) / np.linalg.norm(M) < 2e-5
    assert np.linalg.norm(V.conj().T @ V - np.eye(n)) < 2e-4


def test_round_robin_pairs_cover_every_pair_once():
    for n in (2, 4, 16, 48):
        p, q = round_robin_pairs(n)
        assert p.shape == (n - 1, n // 2) and np.all(p < q)
        pairs = {(a, b) for r in range(n - 1) for a, b in zip(p[r], q[r])}
        assert len(pairs) == n * (n - 1) // 2
        for r in range(n - 1):   # disjoint within a round
            assert len(set(p[r]) | set(q[r])) == n


@pytest.mark.parametrize("n", [4, 5, 16, 33, 48])
def test_plain_matches_scipy_f64(n):
    H = _rand_herm(n, n)
    w, V = jacobi_eigh(torch.as_tensor(H))
    w, V = w.numpy(), V.numpy()
    wref = scipy.linalg.eigh(H, eigvals_only=True)
    np.testing.assert_allclose(w, wref, rtol=1e-12, atol=1e-11)
    np.testing.assert_allclose(H @ V, V * w[None, :], atol=1e-10)
    np.testing.assert_allclose(V.conj().T @ V, np.eye(n), atol=1e-12)


@pytest.mark.parametrize("n", [4, 5, 16, 33, 48])
def test_plain_c64_matches_reference(n):
    H = _rand_herm(n, 100 + n).astype(np.complex64)
    w, V = jacobi_eigh(torch.as_tensor(H))
    w_ref, _ = jacobi_ref(jnp.asarray(H))
    _check_c64(H.astype(np.complex128), w.numpy(), V.numpy(),
               np.asarray(w_ref, np.float64))


def test_graded_matrix_f32_low_accuracy():
    H = _graded45()
    wref = scipy.linalg.eigh(H, eigvals_only=True)
    w, _ = jacobi_eigh(torch.as_tensor(H.astype(np.complex64)), sweeps=12)
    rel = np.abs(w.numpy()[:10] - wref[:10]) / np.abs(wref[:10])
    assert rel.max() < 2e-5, rel.max()


@pytest.mark.parametrize("which", [0, 1, 2], ids=["plain", "graded",
                                                  "degenerate"])
def test_fixed_sweeps_match_pallas_interpret(which):
    """rel_tol=0 with 12 sweeps is the TPU kernel's contract."""
    M = _pallas_matrices()[which]
    w_p, V_p = jax.jit(lambda x: jacobi_eigh_pallas(x, interpret=True))(
        jnp.asarray(M, jnp.complex64))
    w, V = jacobi_eigh(torch.as_tensor(M.astype(np.complex64)), sweeps=12,
                       rel_tol=0.0)
    w, V = w.numpy(), V.numpy()
    _check_c64(M, w, V, scipy.linalg.eigh(M, eigvals_only=True))
    w_p = np.asarray(w_p)
    scale = np.maximum(np.abs(w_p), 1e-3 * np.abs(w_p).max())
    assert np.max(np.abs(w - w_p) / scale) < 5e-4


def test_batch_of_five():
    Hs = np.stack([_rand_herm(24, 10 + i) for i in range(5)])
    w, V = jacobi_eigh(torch.as_tensor(Hs))
    assert w.shape == (5, 24) and V.shape == (5, 24, 24)
    for i in range(5):
        wref = scipy.linalg.eigh(Hs[i], eigvals_only=True)
        np.testing.assert_allclose(w[i].numpy(), wref, rtol=1e-11,
                                   atol=1e-10)
        np.testing.assert_allclose(Hs[i] @ V[i].numpy(),
                                   V[i].numpy() * w[i].numpy(), atol=1e-9)


# -- a numpy model of the CUDA kernel's schedule -------------------------

def _kernel_items(n):
    """The kernel's item decode for every (thread, slot) of one matrix's
    group: the off-diagonal 2×2 H blocks (i < j) and the V rows (pair j,
    row k), each owned by exactly one slot of an item thread; the
    diagonal blocks (i, i) belong to the rotation warp."""
    ne = n + n % 2
    P = ne // 2
    Gi = launch_shape(n, 1)[0] - 32   # the item threads
    nblk = P * (P - 1) // 2
    nitems = nblk + n * P
    owners, blocks, vrows = set(), [], []
    for gt in range(Gi):
        for s in range(MAX_ITEMS):
            it = gt + s * Gi
            if it >= nitems:
                continue
            owners.add(it)
            if it < nblk:
                i, rem = 0, it
                while rem >= P - 1 - i:
                    rem -= P - 1 - i
                    i += 1
                blocks.append((i, i + 1 + rem))
            else:
                vrows.append(divmod(it - nblk, n))
    assert owners == set(range(nitems))
    return (np.asarray(blocks, int).reshape(-1, 2), np.arange(P),
            np.asarray(vrows, int).reshape(-1, 2))


def _rows(c, s, hp, hq):
    """Gᴴ from the left on rows (p, q)."""
    return c * hp - s * hq, s.conj() * hp + c * hq


def _cols(c, s, xp, xq):
    """G from the right on columns (p, q)."""
    return c * xp - s.conj() * xq, s * xp + c * xq


def _rank(w):
    """The kernel's rank: #{w_j < w_i} + #{j < i : w_j = w_i}, NaN last."""
    wi, wj = w[:, None], w[None, :]
    ni, nj = np.isnan(wi), np.isnan(wj)
    less = ~nj & (ni | (wj < wi))
    tie = np.where(nj, ni, wj == wi)
    before = np.arange(len(w))[None, :] < np.arange(len(w))[:, None]
    return (less | (tie & before)).sum(axis=1)


def _advance(a, ne):
    """The circle method's members one round on (0 stays)."""
    return np.where(a == 0, 0, np.where(a == ne - 1, 1, a + 1))


def _check_next_blocks(Hc, Hn, a, b, c, s, npp, nqq, off, ne):
    """The rotation warp's lookahead: each next-round pair's 2×2 block,
    recomputed from the current H and this round's rotations (member to
    pair map, the writer's orientation of the block, a conjugate for the
    mirror), equals to the bit what the round wrote in the model's numpy
    arithmetic. This checks the lookahead's indexing; the kernel's two
    copies may contract into FMAs differently and agree to rounding."""
    P = ne // 2
    p, q = np.minimum(a, b), np.maximum(a, b)
    slot, second = np.empty(ne, int), np.zeros(ne, bool)
    slot[p], slot[q], second[q] = np.arange(P), np.arange(P), True
    a2, b2 = _advance(a, ne), _advance(b, ne)
    p2, q2 = np.minimum(a2, b2), np.maximum(a2, b2)
    i, j = slot[p2], slot[q2]
    app = np.where(second[p2], nqq[i], npp[i])
    aqq = np.where(second[q2], nqq[j], npp[j])
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    xpr, xqr = _rows(c[lo], s[lo], Hc[p[lo], p[hi]], Hc[q[lo], p[hi]])
    xpt, xqt = _rows(c[lo], s[lo], Hc[p[lo], q[hi]], Hc[q[lo], q[hi]])
    y = np.stack([*_cols(c[hi], s[hi], xpr, xpt), *_cols(c[hi], s[hi], xqr,
                                                         xqt)])
    rs = np.where(i == lo, second[p2], second[q2]).astype(int)
    cs = np.where(i == lo, second[q2], second[p2]).astype(int)
    v = y[2 * rs + cs, np.arange(P)]
    apq = np.where(i == j, off[i], np.where(i == lo, v, v.conj()))
    assert np.array_equal(app, Hn[p2, p2].real)
    assert np.array_equal(aqq, Hn[q2, q2].real)
    assert np.array_equal(apq, Hn[p2, q2])


def _kernel_model(H, sweeps=24, rel_tol=None):
    """One matrix through the kernel's schedule in H's precision: every
    round reads the current H and writes the other buffer block by block
    (checking that each entry is written exactly once and that the
    rotation warp's lookahead sees the next round's blocks as written),
    the V rows are rotated in place, the Rutishauser test is taken from
    the entries the sweep's last round writes, and the eigenpairs leave
    by rank. Returns (w, V, sweeps run)."""
    n = H.shape[-1]
    ne, P = n + n % 2, (n + n % 2) // 2
    cdt, rdt = H.dtype.type, H.real.dtype.type
    fi = np.finfo(rdt)
    tiny, floor = rdt(fi.tiny * 100), rdt(fi.tiny * 1e6)
    eps2 = rdt(rel_tol if rel_tol is not None else fi.eps) ** 2
    bye = n if n % 2 else -1
    blocks, diags, vrows = _kernel_items(n)
    bi, bj = blocks[:, 0], blocks[:, 1]
    Hc = np.zeros((ne, ne), cdt)
    Hc[:n, :n] = rdt(0.5) * (H + H.conj().T)
    V = np.eye(n, ne, dtype=cdt)
    a, b = np.arange(P), ne - 1 - np.arange(P)

    def ratio(h, d1, d2):
        return (h.real ** 2 + h.imag ** 2) / np.maximum(
            np.abs(d1) * np.abs(d2), floor)

    def worst_of(H, p, q, d):
        pi, qi, pj, qj = p[bi], q[bi], p[bj], q[bj]
        r = [ratio(H[x, y], d[x], d[y])
             for x, y in ((pi, pj), (pi, qj), (qi, pj), (qi, qj))]
        r.append(ratio(H[p[diags], q[diags]], d[p[diags]], d[q[diags]]))
        return max(float(np.max(x, initial=0.0)) for x in r)

    worst = worst_of(Hc, np.minimum(a, b), np.maximum(a, b),
                     Hc.diagonal().real)
    sweep = 0
    while sweep < sweeps and worst > eps2:
        for rnd in range(ne - 1):
            p, q = np.minimum(a, b), np.maximum(a, b)
            app, aqq, apq = Hc[p, p].real, Hc[q, q].real, Hc[p, q]
            absa = np.sqrt(apq.real ** 2 + apq.imag ** 2)
            on = (absa > tiny) & (q != bye)
            safe = np.where(on, absa, rdt(1))
            phase = np.where(on, apq / safe, cdt(1))
            tau = (aqq - app) / (rdt(2) * safe)
            sgn = np.where(tau >= 0, rdt(1), rdt(-1))
            with np.errstate(over="ignore"):   # τ² = inf gives t = 0
                t = np.where(on, sgn / (np.abs(tau)
                                        + np.sqrt(rdt(1) + tau * tau)),
                             rdt(0))
            c = rdt(1) / np.sqrt(rdt(1) + t * t)
            s = (t * c) * phase
            rpp, rqp = _rows(c, s, app.astype(cdt), apq.conj())
            rpq, rqq = _rows(c, s, apq, aqq.astype(cdt))
            npp, npq = _cols(c, s, rpp, rpq)
            nqp, nqq = _cols(c, s, rqp, rqq)
            off = rdt(0.5) * (npq + nqp.conj())
            Hn = np.full((ne, ne), np.nan, cdt)
            count = np.zeros((ne, ne), int)

            def put(x, y, v):
                Hn[x, y] = v
                np.add.at(count, (x, y), 1)

            d, dp, dq = diags, p[diags], q[diags]
            put(dp, dp, npp.real[d])
            put(dq, dq, nqq.real[d])
            put(dp, dq, off[d])
            put(dq, dp, off[d].conj())
            pi, qi, pj, qj = p[bi], q[bi], p[bj], q[bj]
            xpr, xqr = _rows(c[bi], s[bi], Hc[pi, pj], Hc[qi, pj])
            xpt, xqt = _rows(c[bi], s[bi], Hc[pi, qj], Hc[qi, qj])
            for (x, y), v in zip(((pi, pj), (pi, qj), (qi, pj), (qi, qj)),
                                 (*_cols(c[bj], s[bj], xpr, xpt),
                                  *_cols(c[bj], s[bj], xqr, xqt))):
                put(x, y, v)
                put(y, x, v.conj())
            assert np.all(count == 1), "an entry is not owned exactly once"
            j, k = vrows[:, 0], vrows[:, 1]   # the bye's rotation is I
            V[k, p[j]], V[k, q[j]] = _cols(c[j], s[j], V[k, p[j]], V[k, q[j]])
            _check_next_blocks(Hc, Hn, a, b, c, s, npp.real, nqq.real, off, ne)
            Hc = Hn
            if rnd == ne - 2:   # the test rides on the sweep's last round
                dnew = np.zeros(ne, rdt)
                dnew[p], dnew[q] = npp.real, nqq.real
                worst = worst_of(Hc, p, q, dnew)
            a, b = _advance(a, ne), _advance(b, ne)
        sweep += 1
    w = Hc.diagonal()[:n].real.copy()
    rank = _rank(w)
    w_out, V_out = np.empty_like(w), np.empty((n, n), cdt)
    w_out[rank] = w
    V_out[:, rank] = V[:, :n]
    return w_out, V_out, sweep


@pytest.mark.parametrize("n", [5, 16, 27, 48])
def test_kernel_schedule_model_matches_plain(n):
    """In complex64 the model's eigenvalues agree with the plain version
    to 1e-5 of the scale, its sweeps with the plain version's within one,
    and it passes the chip's residual and orthogonality gates; in
    complex128 the two agree to rounding, eigenvectors to a phase."""
    H = _rand_herm(n, 500 + n)
    H64 = H.astype(np.complex64)
    w, V, nsw = _kernel_model(H64)
    w_pl, _ = jacobi_eigh_plain(torch.as_tensor(H64))
    w_pl = w_pl.numpy()
    assert 1 <= nsw < 24
    assert abs(nsw - int(plain_sweeps_run(torch.as_tensor(H64)))) <= 1
    assert np.all(np.diff(w) >= 0)
    assert np.max(np.abs(w - w_pl)) < 1e-5 * np.abs(w_pl).max()
    R = H @ V - V * w[None, :]
    assert np.linalg.norm(R) / np.linalg.norm(H) < 2e-5
    assert np.linalg.norm(V.conj().T @ V - np.eye(n)) < 2e-4

    w, V, _ = _kernel_model(H)
    w_pl, V_pl = (x.numpy() for x in jacobi_eigh_plain(torch.as_tensor(H)))
    np.testing.assert_allclose(w, w_pl, rtol=0,
                               atol=1e-12 * np.abs(w_pl).max())
    phase = np.sum(V_pl.conj() * V, axis=0)
    np.testing.assert_allclose(V, V_pl * (phase / np.abs(phase)), atol=1e-9)


def test_kernel_rank_sort_is_stable_sort():
    """The kernel's rank order equals ``torch.sort(stable=True)``, with
    ties, signed zeros and NaN."""
    rng = np.random.default_rng(1)
    for trial in range(20):
        w = rng.integers(-3, 4, size=rng.integers(1, 40)).astype(np.float32)
        w[rng.random(w.size) < 0.1] = np.nan
        w[rng.random(w.size) < 0.1] = -0.0
        order = np.empty(w.size, int)
        order[_rank(w)] = np.arange(w.size)
        _, idx = torch.sort(torch.as_tensor(w), stable=True)
        np.testing.assert_array_equal(order, idx.numpy())


def test_launch_shape_fits_kernel_limits():
    """Every n the kernel takes gets the rotation warp and item threads
    with at most ``MAX_ITEMS`` items each, whole warps, at most 512
    threads (the kernel's launch bound) and 15 named barriers a
    block."""
    for n in range(1, MAX_N + 1):
        ne = n + n % 2
        items = ne // 2 * (ne // 2 - 1) // 2 + n * ne // 2
        for batch in (1, 216):
            G, per = launch_shape(n, batch)
            assert G % 32 == 0 and 64 <= G and G * per <= 512
            assert (G - 32) * MAX_ITEMS >= items and per <= min(15, batch)
