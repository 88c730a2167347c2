"""The port's Jacobi eigensolver on the CPU: the plain torch version
against SciPy, the JAX ``jacobi_eigh`` and the Pallas kernel (interpret
mode). The CUDA kernel's tests are in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from bravais_tpu.eigen.jacobi_eigh import jacobi_eigh as jacobi_ref
from bravais_tpu.eigen.pallas_jacobi import jacobi_eigh_pallas
from bravais_tpu_torch.eigen.jacobi_eigh import (jacobi_eigh,
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
