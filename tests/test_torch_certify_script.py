"""``python -m bravais_tpu_torch.cli.certify_dielectric`` against the
reference's ``benchmarks/certify_dielectric.py`` at a small size: CUB
n=4 p=2 (1,536 dofs), nk=6, k indices 0, 1 and 5, on the CPU.

The reference's ``main()`` runs in this process (argv patched; its
stdout captured), in a thread beside the port's ``main`` (``--device
cpu``), whose complex128 oracle solves the three k in a pool of spawned
processes. Each thread's prints go to its own buffer. Held: the same JSON
keys, the oracle's band ends within 1e-9 relative, each k's scale-aware
error under the bar on both sides or over it on both, the same
``certified`` and exit status, and the pooled oracle equal to a
sequential solve bit for bit.
"""

import io
import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from bravais_tpu_torch.cli import certify_dielectric

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--n", "4", "--p", "2", "--nk", "6", "--k-indices", "0,1,5"]


class _PerThread(io.TextIOBase):
    """A stdout that keeps each thread's writes apart."""

    def __init__(self):
        self.bufs = {}

    def write(self, s):
        self.bufs.setdefault(threading.get_ident(), []).append(s)
        return len(s)

    def text(self, ident):
        return "".join(self.bufs.get(ident, []))


def _ref_main():
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    try:
        import certify_dielectric as ref
    finally:
        sys.path.pop(0)
    argv = sys.argv
    sys.argv = ["certify_dielectric.py"] + ARGS
    try:
        return ref.main(), threading.get_ident()
    finally:
        sys.argv = argv


def _lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def runs():
    """{"ref": (exit status, JSON lines), "port": (...)}."""
    out, saved = _PerThread(), sys.stdout
    sys.stdout = out
    try:
        with ThreadPoolExecutor(2) as pool:
            ref = pool.submit(_ref_main)
            seq = pool.submit(_sequential_k1)
            rc_port = certify_dielectric.main(ARGS + ["--device", "cpu"])
            rc_ref, ident = ref.result()
            k1 = seq.result()
    finally:
        sys.stdout = saved
    port_text = out.text(threading.get_ident())
    return {"ref": (rc_ref, _lines(out.text(ident))),
            "port": (rc_port, _lines(port_text)), "port_text": port_text,
            "sequential_k1": k1}


def _sequential_k1():
    """The port's oracle at k index 1, solved in this process."""
    args = certify_dielectric.parser().parse_args(ARGS)
    lat, _, _ = certify_dielectric.problem(args.n, args.p, args.eps_in,
                                           args.radius)
    k = certify_dielectric.kpoints(lat, args.nk)[1]
    return certify_dielectric.oracle_k(
        {"n": args.n, "p": args.p, "nev": args.nev, "eps_in": args.eps_in,
         "radius": args.radius, "f64_tol": args.f64_tol,
         "cheby_target": args.oracle_cheby_target}, k)


def test_same_keys_and_configuration(runs):
    (_, ref), (_, port) = runs["ref"], runs["port"]
    assert len(port) == len(ref) == 4
    for a, b in zip(port, ref):
        assert a.keys() == b.keys()
    for key in ("n", "p", "ndofs", "nev", "eps_in", "radius", "k_indices",
                "bar", "band_floor", "oracle_cheby_target"):
        assert port[-1][key] == ref[-1][key], key
    for a, b in zip(port[:-1], ref[:-1]):
        assert a["k_index"] == b["k_index"]
        np.testing.assert_allclose(a["k"], b["k"], rtol=0, atol=1e-15)


def test_oracle_matches_reference(runs):
    """The complex128 oracles agree: lam_lo, lam_hi within 1e-9
    relative, both converged."""
    (_, ref), (_, port) = runs["ref"], runs["port"]
    assert port[-1]["oracle_unconverged_k"] == ref[-1][
        "oracle_unconverged_k"] == []
    for a, b in zip(port[:-1], ref[:-1]):
        for key in ("lam_lo", "lam_hi"):
            assert abs(a[key] - b[key]) <= 1e-9 * abs(b[key]), (
                a["k_index"], key, a[key], b[key])
        assert a["f64_max_resid"] <= 100 * 1e-9


def test_verdicts_match_reference(runs):
    """Each k passes the scale-aware bar on both sides or misses it on
    both; the same ``certified`` and the same exit status."""
    (rc_ref, ref), (rc_port, port) = runs["ref"], runs["port"]
    for a, b in zip(port[:-1], ref[:-1]):
        assert ((a["max_rel_err_scaled"] < port[-1]["bar"])
                == (b["max_rel_err_scaled"] < ref[-1]["bar"])), a["k_index"]
    assert port[-1]["certified"] == ref[-1]["certified"]
    assert rc_port == rc_ref


def test_pooled_oracle_equals_sequential(runs):
    """The port's oracle ran in a pool of spawned processes (one per
    sampled k, as the cores allow); k index 1 solved in this process
    gives the same bands, iterations and residual bit for bit."""
    jobs = certify_dielectric.default_jobs(3)
    assert (f"oracle on the CPU in {jobs} process" in runs["port_text"])
    rec = next(r for r in runs["port"][1] if r.get("k_index") == 1)
    got = runs["sequential_k1"]
    assert got["lam"][0] == rec["lam_lo"]
    assert got["lam"][-1] == rec["lam_hi"]
    assert got["iters"] == rec["f64_iters"]
    assert got["res"] == rec["f64_max_resid"]
