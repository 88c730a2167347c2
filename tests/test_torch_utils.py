"""The port's utility modules: the debug guards (``utils/debug.py``) and
the timers and trace (``utils/profiling.py``); the port of
``tests/test_utils.py`` less its reim case (the port has no real-valued
boundary)."""

import json
import os

import numpy as np
import pytest
import torch

from bravais_tpu_torch.utils.debug import (assert_all_finite, debug_nans,
                                           nan_check)
from bravais_tpu_torch.utils.profiling import PhaseTimer, bench_op, trace

torch.set_num_threads(1)


def test_assert_all_finite():
    assert_all_finite({"a": torch.ones(3), "b": [np.ones(2), 1.0]})
    with pytest.raises(FloatingPointError, match="non-finite"):
        assert_all_finite(torch.tensor([1.0, np.nan]))
    with pytest.raises(FloatingPointError, match="leaf 1 has 1"):
        assert_all_finite((np.ones(2), np.array([np.inf, 0.0])))


def test_nan_check_raises():
    g = nan_check(torch.log)  # NaN for negative input
    assert float(g(torch.tensor(2.0))) == pytest.approx(np.log(2.0))
    with pytest.raises(FloatingPointError):
        g(torch.tensor(-1.0))


def test_nan_check_sees_intermediates():
    """A NaN inside, with a finite output, still raises; complex too."""
    def f(x):
        return torch.nan_to_num(torch.sqrt(x))

    assert torch.isfinite(f(torch.tensor(-1.0)))
    with pytest.raises(FloatingPointError, match="sqrt"):
        nan_check(f)(torch.tensor(-1.0))
    with pytest.raises(FloatingPointError):
        nan_check(lambda z: (z / 0).abs() * 0)(torch.tensor(1 + 1j))
    assert nan_check(f)(torch.tensor(4.0)) == 2.0


def test_debug_nans_toggles_and_restores():
    assert not torch.is_anomaly_enabled()
    with debug_nans():
        assert torch.is_anomaly_enabled()
        with debug_nans(False):
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()


def test_phase_timer_and_bench():
    t = PhaseTimer()
    with t.phase("work", sync=False):
        sum(range(1000))
    with t.phase("work"):
        torch.ones(8).sum()
    rep = t.report()
    assert "work" in rep and t.counts["work"] == 2
    dt = bench_op(lambda x: (x + 1, {"y": x}), torch.ones(8), iters=3,
                  warmup=1)
    assert dt >= 0


def test_trace_exports_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as logdir:
        torch.ones(64).cumsum(0)
    path = os.path.join(logdir, "trace.json")
    events = json.loads(open(path).read())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
