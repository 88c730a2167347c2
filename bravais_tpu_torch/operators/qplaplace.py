"""Quasi-periodic scalar Laplacian  Λ φ = −∇·(α ∇φ) + shift·β φ  on H1_qp.

Port of ``bravais_tpu/operators/qplaplace.py``. The deflation operator
of the Maxwell field solve, L = Gᴴ M_ε G (``BlochCurlCurl.apply_Lk``),
equals this operator EXACTLY at matching quadrature:
⟨Gφ, M_ε Gψ⟩ = ∫ ε ∇φ·conj(∇ψ). k enters only through the wrap phases
e^{i k·a_i} of the element gather/scatter (torch); the element apply is
the stiffness half of the H1 kernel at k = 0 (``operators/h1_apply.py``,
on CUDA the hand-written ``csrc/h1_apply.cu``); with a mass shift the
kernel returns the β-mass half beside it. The shifted operator's first
caller is the mass stencil of ``BlochHelmholtz.qp_fastdiag``
(α = 0, shift = 1).

The device apply takes blocks (rows, N₁, ..., N_d); ``apply_A_np`` is the
f64 host twin (phases at k = 0) the stencil extraction probes;
``diag_A``/``diag0`` the operator diagonal (host, k-independent).
"""

from __future__ import annotations

import numpy as np
import torch

from bravais_tpu_torch.operators.coefficients import (CoefLike,
                                                      eval_coefficient)
from bravais_tpu_torch.operators.h1_apply import H1Consts, apply_global
from bravais_tpu_torch.spaces import tensor_np
from bravais_tpu_torch.spaces.h1 import H1Space

__all__ = ["QPLaplace"]


class QPLaplace:
    """Λ φ = −∇·(α∇φ) + shift·β φ on ``space``, device work on ``device``
    in ``dtype``."""

    def __init__(self, space: H1Space, alpha: CoefLike = 1.0,
                 beta: CoefLike = 1.0, shift: float = 0.0,
                 dtype=torch.complex64, device="cuda"):
        self.space = space
        self.dtype = dtype
        self.rdtype = dtype.to_real()
        self.device = torch.device(device)
        self.shift = float(shift)
        xq = space.qpoints_phys()
        self._alpha_q64 = eval_coefficient(alpha, xq)
        self._beta_q64 = eval_coefficient(beta, xq)
        self.A_rows = space.grid.lattice.A.astype(np.float64)
        self._consts = None

    def consts(self) -> H1Consts:
        """The h1 kernel's tables, metric and α·w, β·w planes on the
        device (built once)."""
        if self._consts is None:
            self._consts = H1Consts.from_space(
                self.space, self._alpha_q64, self._beta_q64, self.device,
                self.rdtype)
        return self._consts

    def phases(self, k) -> torch.Tensor:
        """φ_i = e^{i k·a_i}, computed in the working precision: (d,) at
        one k, (nk, d) for a k table (nk, d)."""
        A = torch.as_tensor(self.A_rows, dtype=self.rdtype,
                            device=self.device)
        kt = torch.as_tensor(np.asarray(k, np.float64), dtype=self.rdtype,
                             device=self.device)
        ka = A @ kt if kt.ndim == 1 else kt @ A.mT
        return torch.polar(torch.ones_like(ka), ka)

    def apply_A(self, u: torch.Tensor, k=None, *, ph=None) -> torch.Tensor:
        """Λ(k) u for a block u (rows, N₁, ..., N_d); pass ``k`` or the
        precomputed phases ``ph``. With a k table (or its phases (nk, d))
        the block is (nk, rows, N₁, ..., N_d): the per-k phases wrap the
        gather and the nk·rows rows go through one h1 launch at k = 0."""
        if ph is None:
            ph = self.phases(k)
        d = self.space.dim
        lead = tuple(u.shape[:u.ndim - d])
        if ph.ndim == 2 and (len(lead) != 2 or lead[0] != ph.shape[0]):
            raise ValueError(f"a k table of {ph.shape[0]} k takes blocks "
                             f"(nk, rows, *N) with nk = {ph.shape[0]}, got "
                             f"{tuple(u.shape)}")
        flat = u.reshape((-1,) + tuple(u.shape[len(lead):])).to(self.dtype)
        phs = [ph[..., i] for i in range(d)]
        k0 = [0.0] * d
        if self.shift:
            y, m = apply_global(self.space, flat, self.consts(), k0, "AM",
                                phs)
            y = y + self.shift * m
        else:
            y = apply_global(self.space, flat, self.consts(), k0, "A",
                             phs)[0]
        return y.reshape(u.shape)

    def diag_A(self, k=None) -> np.ndarray:
        """Real diagonal (N₁, ..., N_d), host; |phases| = 1, so it does
        not depend on k."""
        return self.diag0

    @property
    def diag0(self) -> np.ndarray:
        """diag_S + shift·diag_M of the Bloch operator on the same space
        and coefficients at k = 0 (its squared-table construction),
        floored at 1e-30 as the reference floors it."""
        if not hasattr(self, "_diag"):
            from bravais_tpu_torch.operators.helmholtz import BlochHelmholtz
            helm = BlochHelmholtz(self.space, alpha=self._alpha_q64,
                                  beta=self._beta_q64, dtype=self.dtype,
                                  device="cpu")
            self._diag = np.maximum(helm._diag_S + self.shift * helm._diag_M,
                                    1e-30)
        return self._diag

    def apply_A_np(self, u, k=None):
        """f64 host twin (phases at k = 0, as in the reference; the
        stencil extraction probes it at k = 0)."""
        sp = self.space
        d = sp.dim
        u = np.asarray(u, np.complex128)
        B64, D64 = sp.basis.B, sp.basis.D
        tabs = [[D64 if r == i else B64 for i in range(d)]
                for r in range(d)]
        args = (sp.grid.shape, (sp.p,) * d, (True,) * d)
        ue = tensor_np.gather_np(u, *args)
        ghat = np.stack([tensor_np.contract_np(ue, tabs[r])
                         for r in range(d)])
        z = (self._alpha_q64 * sp.quad_weight()) * np.einsum(
            "rs,s...->r...", sp.grid.Ginv, ghat)
        y = 0.0
        for r in range(d):
            y = y + tensor_np.contract_t_np(z[r], tabs[r])
        if self.shift != 0.0:
            uq = tensor_np.contract_np(ue, [B64] * d)
            y = y + self.shift * tensor_np.contract_t_np(
                self._beta_q64 * sp.quad_weight() * uq, [B64] * d)
        return tensor_np.scatter_add_np(y, *args)
