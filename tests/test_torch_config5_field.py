"""Config 5 on the port, cut to n=4 p=4 (the reference's
``tests/test_config5.py::test_config5_p4_both_engines``), matrix-free
engine: the built-in LOBPCG with the Jacobi preconditioner and the fused
h1 element apply (its plain version here), FCC and TRI, the 8 generic k
of ``KFRAC`` in one k-batched ``BandSweep.run`` through
``bravais_tpu_torch.cli.config5_all14.run_one``, against the analytic
|k+G|² at the reference's bar (< 2e-5). 70–85 iterations per k."""

import pytest
import torch

from bravais_tpu_torch.cli.config5_all14 import run_one

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["FCC", "TRI"])
def test_config5_p4_field(name):
    r = run_one(name, n=4, p=4, nev=4, tol=1e-8, maxiter=300,
                engine="field", device="cpu")
    assert r["max_rel_err"] < 2e-5, r
    assert len(r["iterations"]) == 8 and max(r["iterations"]) < 300
