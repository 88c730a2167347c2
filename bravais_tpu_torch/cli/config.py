"""Typed run configuration of the band-structure CLI.

Port of ``bravais_tpu/cli/config.py``: one dataclass holds the lattice,
mesh and order, PDE family, coefficients, k-path, solver, precision,
execution and output settings, and serializes into the run manifest for
checkpoint/resume identity. The identity fields are the reference's, so
a run's identity hash is the same in both packages. One execution-only
field is added, ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["RunConfig"]


@dataclasses.dataclass
class RunConfig:
    # lattice
    lattice: str = "SQR"
    a: float = 1.0
    b: Optional[float] = None
    c: Optional[float] = None
    alpha_deg: Optional[float] = None
    beta_deg: Optional[float] = None
    gamma_deg: Optional[float] = None
    # discretization
    n: int = 16                      # elements per primitive direction
    p: int = 3                       # polynomial order
    quad: Optional[int] = None       # quadrature points/dim (default p+2)
    # PDE family: "tm" | "te" | "scalar" | "maxwell"
    problem: str = "tm"
    # material: periodic inclusion (rod in 2D / sphere in 3D)
    eps_in: float = 1.0
    eps_out: float = 1.0
    radius: float = 0.0              # 0 -> homogeneous (empty lattice)
    smooth_width: float = 0.0        # interface smoothing (MPB-style)
    #: subcell-average the coefficient on an N^d midpoint grid per
    #: quadrature subcell (0 = pointwise sampling)
    subcell: int = 0
    # k-path
    nk: int = 32
    path: Optional[List[List[str]]] = None   # None -> lattice default
    # eigensolver
    nev: int = 10
    block: Optional[int] = None
    tol: float = 1e-6
    #: explicit device-loop stopping residual when the f64 refine is
    #: active (see bench.py --device-tol rationale; applies to BOTH
    #: engines — spectral: accuracy-independent, field: quadratically
    #: bounded, measured unchanged at 1e-4). None keeps ``tol``
    #: semantics. Identity-affecting by design (a different device
    #: stop is a different convergence path).
    device_tol: Optional[float] = None
    maxiter: int = 400
    #: "auto" resolves per physics (BandSweep._make_precond): geometric
    #: MG for varying-coefficient scalar operators (plain Jacobi was
    #: measured to stagnate at production sizes — hex-holes TE stuck at
    #: residual 0.1, SQR TM rods at 0.23 — while GMG converges both in
    #: 7-13 iters/k), Jacobi elsewhere. Identity-affecting by design.
    precond: str = "auto"
    # precision: "f32" (the card) | "f64" (CPU oracle runs)
    precision: str = "f32"
    # execution
    mode: str = "warm"               # "warm" | "batched" | "warm-chain"
    chain: int = 4                   # warm-chain: k-points per chain
    #: warm-chain preconditioner build: "per-k" | "chain-mid" (one at the
    #: chain's middle k) | "batched" (every chain k's in one call) |
    #: "batched-setup" (every chain k's whole spectral setup in one call)
    pc_mode: str = "per-k"
    #: shard the k-points over the ranks of a torch.distributed group
    #: (one process and one device per rank, e.g. under ``torchrun``)
    shard: bool = False
    #: Maxwell solver engine: "auto" | "spectral" | "field" | "gmg"
    engine: str = "auto"
    seed: int = 0
    # output
    out: Optional[str] = None        # run directory (enables checkpointing)
    resume: bool = False
    plot: bool = False
    save_modes: bool = False         # dump eigenvector blocks per k
    #: torch device: "cuda" or "cpu"; None is "cuda", or "cpu" under
    #: ``precision="f64"`` (float64 runs on the host). The counterpart of
    #: the reference's JAX_PLATFORMS: execution-only.
    device: Optional[str] = None

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    #: fields that do not change the physics/results identity of a run.
    #: ``engine`` is NOT execution-only: for scalar problems the
    #: spectral engine solves the quasi-periodic twin discretization
    #: whose eigenvalues differ from the pointwise-ik path at
    #: discretization-error level, so a resume across engines would
    #: silently mix two discretizations in one band table (ADVICE r2 #2).
    _EXECUTION_FIELDS = ("out", "resume", "plot", "mode", "chain",
                         "pc_mode", "shard", "save_modes", "device")

    def identity_dict(self) -> Dict:
        """The config subset that identifies a run's RESULTS — used for
        the checkpoint manifest hash, so e.g. resuming with
        ``--resume`` or a different execution mode still matches."""
        d = self.to_dict()
        for f in self._EXECUTION_FIELDS:
            d.pop(f, None)
        return d

    @property
    def dtype(self):
        import torch
        return torch.complex64 if self.precision == "f32" else torch.complex128

    def lattice_kwargs(self) -> Dict:
        import numpy as np
        kw = dict(a=self.a)
        if self.b is not None:
            kw["b"] = self.b
        if self.c is not None:
            kw["c"] = self.c
        for name in ("alpha", "beta", "gamma"):
            v = getattr(self, f"{name}_deg")
            if v is not None:
                kw[name] = float(np.deg2rad(v))
        return kw

    @classmethod
    def add_cli_args(cls, ap) -> None:
        for f in dataclasses.fields(cls):
            name = "--" + f.name.replace("_", "-")
            if f.type == "bool" or isinstance(f.default, bool):
                ap.add_argument(name, action="store_true",
                                default=f.default)
            elif f.name == "path":
                ap.add_argument(name, type=str, default=None,
                                help="comma/semicolon path, e.g. 'G,X,W,L'")
            else:
                typ = {int: int, float: float}.get(type(f.default), str)
                if f.default is None:
                    typ = str if f.name not in (
                        "b", "c", "alpha_deg", "beta_deg", "gamma_deg",
                        "quad", "block", "device_tol") else float
                    if f.name in ("quad", "block"):
                        typ = int
                ap.add_argument(name, type=typ, default=f.default)

    @classmethod
    def from_cli_args(cls, ns) -> "RunConfig":
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(ns, f.name)
            if f.name == "path" and isinstance(v, str):
                v = [seg.split(",") for seg in v.split(";")]
            kw[f.name] = v
        return cls(**kw)
