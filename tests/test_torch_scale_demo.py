"""``python -m bravais_tpu_torch.cli.scale_demo`` on the CPU: part
single's footprint model against the reference's
(``benchmarks/scale_demo.py --part single``), the fits, the choice of
the dd part's n, and the dd part's step at FCC n=4 p=2 (one rank here;
four gloo ranks in ``tests/test_torch_parallel.py``) against the
reference's ``BlochCurlCurl.apply_A`` and the port's unsharded LOBPCG.
"""

import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bravais_tpu.lattices import make_lattice as make_lattice_ref
from bravais_tpu.meshing.grid import PeriodicGrid as GridRef
from bravais_tpu.operators.curlcurl import BlochCurlCurl as CurlRef
from bravais_tpu.spaces.nedelec import NedelecSpace as NedRef
from bravais_tpu_torch.cli import scale_demo
from bravais_tpu_torch.parallel.mesh import KMesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, P, M, NEV = 4, 2, 16, 10


def _ref_module():
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    try:
        import scale_demo as ref
    finally:
        sys.path.pop(0)
    return ref


def test_single_model_equals_reference():
    """Part single's model lines are the reference's, at its n list."""
    ref = _ref_module()
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["scale_demo.py", "--part", "single"]
    try:
        with contextlib.redirect_stdout(buf):
            assert ref.main() == 0
    finally:
        sys.argv = argv
    want = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    assert scale_demo.reference_model(4) == want
    assert scale_demo.array_bytes(8, 4) == 512 * 192 ** 2 * 8


def test_fit_count_recovers_the_array_count():
    """Peaks of exactly c arrays give c back; peaks off by a few percent
    give a count within those percent."""
    sizes = [scale_demo.array_bytes(n, 4) for n in scale_demo.SINGLE_NS]
    assert scale_demo.fit_count(sizes, [7.25 * s for s in sizes]) == \
        pytest.approx(7.25, rel=1e-14)
    noisy = [7.25 * s * f for s, f in zip(sizes, (1.03, 0.98, 1.01))]
    c = scale_demo.fit_count(sizes, noisy)
    assert abs(c / 7.25 - 1) < 0.03
    assert all(abs(c * s / y - 1) < 0.05 for s, y in zip(sizes, noisy))


def test_fit_linear_and_dd_choice():
    """The dd part's line y = a·ndofs + b is recovered from exact points,
    and its n is the smallest multiple of the group size beyond the card
    by 10% whose share fits 75% of it; ``--n`` overrides."""
    a, b = 331.5, 2.5e8
    xs = [3 * n ** 3 * 64 for n in scale_demo.DD_NS]
    ga, gb = scale_demo.fit_linear(xs, [a * x + b for x in xs])
    assert ga == pytest.approx(a, rel=1e-10)
    assert gb == pytest.approx(b, rel=1e-6)
    cap = 80 * 2 ** 30
    n = scale_demo.dd_choose(a, b, cap, 4, 4)

    def one(n):
        return a * 3 * n ** 3 * 64 + b
    assert n % 4 == 0 and one(n) >= 1.1 * cap and one(n - 4) < 1.1 * cap
    assert scale_demo.dd_predict(a, b, n, 4, 4) == pytest.approx(
        (one(n), a * 3 * n ** 3 * 64 * (1 / 4 + 1 / (4 * n)) + b))
    assert scale_demo.dd_predict(a, b, n, 4, 4)[1] < 0.75 * cap
    assert scale_demo.dd_choose(a, b, cap, 4, 4, n=12) == 12
    with pytest.raises(RuntimeError):
        scale_demo.dd_choose(a, 0.9 * cap, cap, 4, 4)


def test_largest_n():
    """The largest n whose fitted footprint fits 90% of the card: the fit
    measured on an H100 80GB (8.1284 arrays, 79.18 GiB) gives 31."""
    cap = int(79.1787109375 * 2 ** 30)
    n = scale_demo.largest_n(8.1284, 4, cap)
    assert n == 31
    assert 8.1284 * scale_demo.array_bytes(32, 4) > 0.9 * cap


def test_dd_start_planes_tile_the_block():
    """A rank's planes of the start block are those planes of the
    one-rank block."""
    sp = scale_demo.fcc_operator(N, P, torch.complex128, "cpu")[1].space
    whole = scale_demo.dd_start(sp, 3, slice(0, sp.field_shape[1]))
    assert whole.shape == (3,) + tuple(sp.field_shape)
    np.testing.assert_array_equal(scale_demo.dd_start(sp, 3, slice(2, 5)),
                                  whole[:, :, 2:5])


@pytest.fixture(scope="module")
def ref_norms():
    """The reference's apply_A norm of the seed-0 field at the reference's
    k, in complex64 (k in float32, as the reference script) and
    complex128."""
    lat = make_lattice_ref("FCC")
    out = {}
    for dtype, kdt in ((jnp.complex64, np.float32),
                       (jnp.complex128, np.float64)):
        op = CurlRef(NedRef.make(GridRef.make(lat, N), P), dtype=dtype)
        u = scale_demo.dd_field(op.space)[0]
        k = jnp.asarray(np.asarray(lat.k_cart(scale_demo.DD_KFRAC), kdt))
        y = np.asarray(jax.jit(op.apply_A)(jnp.asarray(u, dtype), k))
        out[dtype] = float(np.linalg.norm(y))
    return out


@pytest.mark.parametrize("dtype, bar", [(torch.complex64, 1e-6),
                                        (torch.complex128, 1e-12)])
def test_dd_step_one_rank(ref_norms, dtype, bar):
    """The dd step on one rank: the executed apply's norm equals the
    reference's, and the 2-iteration eigenvalues equal the unsharded
    LOBPCG's (1e-9 in complex128; complex64 to float32 rounding)."""
    mesh = KMesh(rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    got = scale_demo.dd_step(N, P, M, NEV, dtype, "cpu", mesh)
    whole = scale_demo.dd_step(N, P, M, NEV, dtype, "cpu")
    want = ref_norms[jnp.complex64 if dtype == torch.complex64
                     else jnp.complex128]
    assert got["finite"] and got["iterations"] == 2
    assert abs(got["norm"] - want) <= bar * want
    assert got["slab"] == [0, N * P] and got["peak"] is None
    np.testing.assert_allclose(got["eigenvalues"], whole["eigenvalues"],
                               rtol=1e-9 if dtype == torch.complex128
                               else 1e-5)
    assert got["eigenvalues"].shape == (NEV,)
