"""The spectral Maxwell engine's preconditioner hooks: ``pc_rep`` and the
per-k setup a solve is handed, and a ``BandSweep`` driven through several
``run_warm_chain`` settings (the problem of
``test_torch_sweep_modes_spectral.py``: FCC n=3 p=2, complex128):

* ``pc_rep="inv"`` (YcᴴYc, one GEMM an apply) against "factor" (Yc,
  applied as Ycᴴ(Yc·R)) and against the reference's "inv" ``run_warm``
  (``tests/test_sweep.py::test_spectral_pc_rep_factor_matches_inv``'s
  problem, Γ–X at 4 points, tol 1e-9): eigenvalues within 1e-9 relative,
  iterations equal to the reference's;
* a solve handed ``setup=`` builds no block, one handed ``pc=`` only TA,
  TM and TG, and both equal the solve that builds its own;
* one instance through chain-mid at chains of 3 and 2, then batched,
  against a fresh instance each time: iterations equal, eigenvalues
  bit for bit (the port keeps no per-mode state)."""

import numpy as np
import torch

from bravais_tpu.bands import BandSweep as SweepRef
from bravais_tpu_torch.bands.sweep import BandSweep
from tests.test_torch_sweep_modes_spectral import KW, fcc, fcc_ref, rel, sweep

torch.set_num_threads(1)


def test_pc_rep_inv_matches_factor_and_reference():
    kw = dict(KW, tol=1e-9)
    op, kc = fcc(npts=4, path=("G", "X"))
    res = {rep: BandSweep(op, op.make_spectral_solve_fn(pc_rep=rep),
                          **kw).run_warm(kc) for rep in ("inv", "factor")}
    assert rel(res["inv"].eigenvalues, res["factor"].eigenvalues) < 1e-9
    assert np.max(res["inv"].residuals) < 1e-8
    opr, kcr = fcc_ref(npts=4, path=("G", "X"))
    np.testing.assert_array_equal(kc, kcr)
    ref = SweepRef(opr, solve_fn=opr.make_solve_fn(engine="spectral",
                                                   pc_rep="inv"),
                   **kw).run_warm(kcr)
    np.testing.assert_array_equal(res["inv"].iterations, ref.iterations)
    assert rel(res["inv"].eigenvalues, ref.eigenvalues) < 1e-9
    # The inverse is the factor's YcᴴYc.
    Yc = op.make_spectral_solve_fn().build_pc(kc[1])
    inv = op.make_spectral_solve_fn(pc_rep="inv").build_pc(kc[1])
    torch.testing.assert_close(inv, Yc.mH @ Yc, rtol=1e-12, atol=1e-12)


def test_handed_setup_builds_nothing():
    op, kc = fcc(npts=4)
    solve = op.make_spectral_solve_fn()
    fd = op.fastdiag_G()
    X0 = BandSweep(op, solve, **KW)._x0()
    k = kc[1]
    built = []
    blocks = fd.blocks
    fd.blocks = lambda terms, kk: (built.append([t for t, _ in terms]),
                                   blocks(terms, kk))[1]
    try:
        setup = solve.build_setup(k)
        pc = solve.build_pc(k)
        assert built == [["A"], ["M"], ["G"], ["A", "M"]]
        runs = {}
        for name, kw in (("own", {}), ("pc", {"pc": setup[3]}),
                         ("setup", {"setup": setup})):
            built.clear()
            runs[name] = solve(X0, k, 4, 1e-8, 20, **kw)[0]
            assert built == {"own": [["A"], ["M"], ["G"]],
                             "pc": [["A"], ["M"], ["G"]],
                             "setup": []}[name]
    finally:
        del fd.blocks
    for name in ("pc", "setup"):
        assert runs[name].iterations == runs["own"].iterations
        torch.testing.assert_close(runs[name].eigenvalues,
                                   runs["own"].eigenvalues, rtol=0, atol=0)
    # build_pc's one stencil product of A + sM is the setup's to rounding.
    torch.testing.assert_close(pc, setup[3], rtol=1e-10, atol=1e-12)


def test_one_instance_through_chain_settings_matches_fresh():
    op, kc = fcc()
    sw = sweep(op)
    for chain, mode in ((3, "chain-mid"), (2, "chain-mid"), (3, "batched")):
        res = sw.run_warm_chain(kc, chain=chain, precond=mode)
        ref = sweep(op).run_warm_chain(kc, chain=chain, precond=mode)
        assert sw.chain_mode == mode
        np.testing.assert_array_equal(res.iterations, ref.iterations)
        np.testing.assert_array_equal(res.eigenvalues, ref.eigenvalues)
