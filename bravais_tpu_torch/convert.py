"""Carry reference state across into the port.

The spectral band solve has no weights: its state is the set of k=0
stencils S_δ (plain f64 numpy arrays held by the reference's
``FastDiag.stencils``) plus the start block, which both packages draw
from ``np.random.default_rng(seed)``. Building the port's FastDiag from
the reference's stencils lets the port's device half and solve run on
exactly the reference's S_δ, independent of the port's own extraction.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from bravais_tpu_torch.operators.fastdiag import FastDiag

__all__ = ["fastdiag_from_reference"]


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
