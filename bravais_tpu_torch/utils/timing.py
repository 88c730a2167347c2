"""Device timing (the counterpart of ``bravais_tpu/utils/profiling.py``
for the port): per-call times from CUDA events, which measure the work
on the device rather than its enqueue on the host."""

from __future__ import annotations

import statistics
from typing import Callable

import torch

__all__ = ["cuda_ms"]


def cuda_ms(fn: Callable[[], object], reps: int = 50, warmup: int = 3
            ) -> float:
    """Median per-call time of ``fn`` in milliseconds, each call timed
    between two CUDA events on the current stream after ``warmup``
    untimed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times CUDA work; no CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
