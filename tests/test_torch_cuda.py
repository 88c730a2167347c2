"""The port on a CUDA device: the hand-written Jacobi kernel against its
plain torch version, and the warm spectral sweep on the card against the
same sweep on the CPU. Every test skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from bravais_tpu_torch.bands.sweep import BandSweep
from bravais_tpu_torch.eigen import jacobi_cuda
from bravais_tpu_torch.eigen.jacobi_eigh import (jacobi_eigh,
                                                jacobi_eigh_plain)
from bravais_tpu_torch.lattices import kpath, make_lattice
from bravais_tpu_torch.meshing.grid import PeriodicGrid
from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.spaces.nedelec import NedelecSpace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rand_herm(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Q = np.linalg.qr(A)[0]
    H = (Q * (rng.standard_normal(n) * 10)) @ Q.conj().T
    return 0.5 * (H + H.conj().T)


@pytest.mark.parametrize("n,batch", [(16, 1), (33, 8), (48, 1), (48, 8),
                                     (64, 1)])
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
