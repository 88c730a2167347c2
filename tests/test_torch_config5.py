"""Config 5 on the port, cut to n=4 p=4 (the reference's
``tests/test_config5.py::test_config5_p4_both_engines``), spectral
engine: FCC (cubic) and TRI (the most oblique family), the 8 generic k of
``KFRAC`` in one k-batched ``BandSweep.run`` through
``bravais_tpu_torch.cli.config5_all14.run_one``, against the analytic
|k+G|² at the reference's bar (< 2e-5; the n=4 p=4 discretization floor
is ≈7e-6). The matrix-free engine is in ``test_torch_config5_field.py``;
the reference's sharded and domain-decomposed cases wait for the
multi-GPU slice."""

import pytest
import torch

from bravais_tpu_torch.cli.config5_all14 import run_one

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["FCC", "TRI"])
def test_config5_p4_spectral(name):
    r = run_one(name, n=4, p=4, nev=4, tol=1e-8, maxiter=300,
                engine="spectral", device="cpu")
    assert r["max_rel_err"] < 2e-5, r
    assert len(r["iterations"]) == 8 and r["dofs"] == 4096
