"""Carry reference state across into the port.

The band solves have no weights. The spectral solve's state is the set
of k=0 stencils S_δ (plain f64 numpy arrays held by the reference's
``FastDiag.stencils``); the field solve's is the f64 quadrature planes of
ε and μ⁻¹ (``_eps_q64``, ``_mu_inv_q64``) plus the A, M stencils of its
(mean-twin) preconditioner and the L stencil of its projector; the
scalar spectral solve's is the f64 α and β planes and their A, M
stencils. The start block both packages draw from ``np.random.default_rng(seed)``. Building
the port's objects from these arrays lets the port run on exactly the
reference's state, independent of its own evaluation and extraction.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from bravais_tpu_torch.operators.curlcurl import BlochCurlCurl
from bravais_tpu_torch.operators.fastdiag import FastDiag
from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz

__all__ = ["fastdiag_from_reference", "curlcurl_field_from_reference",
           "helmholtz_from_reference"]


def fastdiag_from_reference(stencils: Mapping[str, np.ndarray],
                            shape: Sequence[int], p: int, ncomp: int,
                            A_rows: np.ndarray, device) -> FastDiag:
    """The port's FastDiag with the given stencils (e.g. the reference
    ``FastDiag.stencils`` dict: "A", "M" and the rectangular "G")."""
    fd = FastDiag(shape, p, ncomp, A_rows, device=device)
    for name, S in stencils.items():
        S = np.array(S)
        if S.ndim != 3 or S.shape[0] != 3 ** len(fd.shape) \
                or S.shape[1] != fd.D:
            raise ValueError(f"stencil {name!r} has shape {S.shape}, "
                             f"expected ({3 ** len(fd.shape)}, {fd.D}, *)")
        fd.stencils[name] = S
    return fd


def curlcurl_field_from_reference(space, eps_q64: np.ndarray,
                                  mu_inv_q64: np.ndarray,
                                  stencils: Mapping[str, np.ndarray],
                                  stencil_L: np.ndarray, device,
                                  dtype=torch.complex64) -> BlochCurlCurl:
    """The port's ``BlochCurlCurl`` on ``space`` (a port NedelecSpace)
    with the reference's field state: the ε and μ⁻¹ quadrature planes
    (n₁, q, n₂, q, n₃, q), its "A" and "M" stencils (``_fd.stencils``)
    and its "L" stencil (``_fdL.stencils["L"]``)."""
    qshape = space.qpoints_phys().shape[:-1]
    for name, a in (("eps", eps_q64), ("mu_inv", mu_inv_q64)):
        if np.shape(a) != qshape:
            raise ValueError(f"{name} plane has shape {np.shape(a)}, "
                             f"expected {qshape}")
    op = BlochCurlCurl(space, eps=np.array(eps_q64, np.float64),
                       mu_inv=np.array(mu_inv_q64, np.float64),
                       dtype=dtype, device=device)
    g = space.grid
    op.set_fastdiag(fastdiag_from_reference(
        {nm: stencils[nm] for nm in ("A", "M")}, g.shape, space.p, 3,
        op.A_rows, device))
    op.set_fastdiag_L(fastdiag_from_reference(
        {"L": stencil_L}, g.shape, space.p, 1, op.A_rows, device))
    return op


def helmholtz_from_reference(space, alpha_q64: np.ndarray,
                             beta_q64: np.ndarray,
                             stencils: Mapping[str, np.ndarray], device,
                             dtype=torch.complex64) -> BlochHelmholtz:
    """The port's ``BlochHelmholtz`` on ``space`` (a port H1Space) with the
    reference's state: its α and β quadrature planes (n₁, q, ..., n_d, q)
    and its ``qp_fastdiag().stencils`` ("A", "M"), for the spectral engine.
    Its coefficients are the planes, which a coarse grid cannot resample:
    build a multigrid's operator from the coefficients themselves."""
    qshape = space.qpoints_phys().shape[:-1]
    for name, a in (("alpha", alpha_q64), ("beta", beta_q64)):
        if np.shape(a) != qshape:
            raise ValueError(f"{name} plane has shape {np.shape(a)}, "
                             f"expected {qshape}")
    op = BlochHelmholtz(space, alpha=np.array(alpha_q64, np.float64),
                        beta=np.array(beta_q64, np.float64), dtype=dtype,
                        device=device)
    op.set_qp_fastdiag(fastdiag_from_reference(
        {nm: stencils[nm] for nm in ("A", "M")}, space.grid.shape, space.p,
        1, op.A_rows, device))
    return op
