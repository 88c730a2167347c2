"""Phase timers, op micro-benchmarks and profiler traces.

Port of ``bravais_tpu/utils/profiling.py``: wall-clock phase timers that
wait for the card, per-call timing of an operation, and a
``torch.profiler`` trace exported for Perfetto or chrome://tracing. Per-
call device times between CUDA events are ``utils/timing.py::cuda_ms``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

__all__ = ["PhaseTimer", "bench_op", "trace"]


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor in a (nested) tuple, list or dict output."""
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else ())
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _sync(t: Optional[torch.Tensor]) -> None:
    """Wait for the work that produced ``t`` when it lies on the card
    (CPU work is done when it returns)."""
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class PhaseTimer:
    """Accumulating phase timer.

    with timer.phase("assemble"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        """Time the block; with ``sync``, wait for the card's queued work
        first when the process has used the card."""
        t0 = time.perf_counter()
        yield
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["phase                      total_s   calls   per_call_ms"]
        for name, tot in sorted(self.totals.items(), key=lambda x: -x[1]):
            c = self.counts[name]
            lines.append(f"{name:<25} {tot:9.3f} {c:7d} "
                         f"{1e3 * tot / c:12.3f}")
        return "\n".join(lines)


def bench_op(fn: Callable, *args, iters: int = 50, warmup: int = 2,
             name: str = "") -> float:
    """Mean wall time per call of ``fn(*args)`` in seconds over ``iters``
    calls after ``warmup``, waiting for the card on the device of the
    output's first tensor. ``fn`` must return at least one tensor."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(_first_tensor(out))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(_first_tensor(out))
    dt = (time.perf_counter() - t0) / iters
    if name:
        print(f"{name:<30} {1e3 * dt:10.3f} ms")
    return dt


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` (the card's activity too
    when one is present) and export a Chrome trace to
    ``logdir/trace.json`` (default: a new temporary directory); yields
    ``logdir``."""
    logdir = logdir or tempfile.mkdtemp(prefix="torch-trace-")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
