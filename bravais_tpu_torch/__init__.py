"""bravais_tpu_torch — the PyTorch/CUDA port of ``bravais_tpu``.

Computes photonic band structures on an NVIDIA GPU: for each k on a
Brillouin-zone path, the lowest bands of the Bloch Maxwell pencil
A(k)x = λMx by a complex LOBPCG, then a float64 host refine. Two
engines: the spectral one (element-invariant coefficients: LOBPCG in the
twisted-DFT block basis, exact refine of the blocks that carry the
bands) and the matrix-free field one (any ε: fused element applies,
Chebyshev gradient projector, host Rayleigh–Ritz refine). The JAX
package ``bravais_tpu`` is the reference; each module here names its
counterpart there. This package imports torch, numpy and scipy only.

Subpackages mirror the reference: ``lattices``, ``meshing``, ``spaces``
(host metadata, device gather/scatter and contractions), ``operators``
(host f64 twins, stencil extraction, the twisted-DFT block factory, the
curl-curl and QP-Laplace operators with their element kernels
``csrc/nd_apply.cu`` and ``csrc/h1_apply.cu``), ``eigen`` (LOBPCG, the
host refine and the Jacobi eigensolver with its kernel
``csrc/jacobi_eigh.cu``), ``bands`` (the warm-started sweep), ``utils``
(device timing, the kernel builder); ``convert`` carries reference state
across.
"""

__version__ = "0.1.0"

import os as _os

# The host f64 refine runs numpy's and scipy's LAPACK (OpenBLAS) on small
# dense matrices. A multi-threaded OpenBLAS thrashes on those on a shared
# host (measured on an H100 machine: 9 s against 0.4 s a refine of 35
# blocks), so cap it unless the caller set it. This must come before
# torch, which loads numpy: it takes effect in a process that has not
# loaded numpy yet, as ``python -m bravais_tpu_torch``. MKL is left alone:
# torch's own CPU thread count follows MKL_NUM_THREADS.
_os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import torch as _torch  # noqa: E402

# Reduced-precision contractions (TF32 keeps ~3 decimal digits) break the
# LOBPCG Gram matrices and the whitening; the counterpart of the JAX
# package's ``jax_default_matmul_precision="highest"``. allow_tf32 also
# covers the complex64 CGEMMs.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from bravais_tpu_torch.lattices import (  # noqa: F401,E402
    Lattice, kpath, make_lattice)
