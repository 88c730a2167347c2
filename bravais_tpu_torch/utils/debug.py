"""Numerical-debugging guards: NaN/Inf checks.

Port of ``bravais_tpu/utils/debug.py``. ``assert_all_finite`` checks
values on the host; ``nan_check`` wraps a function so that any torch call
inside it that yields a non-finite floating or complex tensor raises
(a forward hook on every torch call, through a
``torch.overrides.TorchFunctionMode``: autograd's anomaly mode checks
only the backward pass, and a module forward hook sees only
``nn.Module`` outputs); ``debug_nans`` switches autograd's anomaly
detection on for a block and restores it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

__all__ = ["nan_check", "assert_all_finite", "debug_nans"]


def _leaves(tree) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def assert_all_finite(tree, name: str = "value") -> None:
    """Raise ``FloatingPointError`` if a leaf of ``tree`` (tensors, arrays
    and numbers in nested dicts, tuples and lists) holds a non-finite
    entry."""
    for i, leaf in enumerate(_leaves(tree)):
        a = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
             else np.asarray(leaf))
        if not np.all(np.isfinite(a)):
            bad = int(np.sum(~np.isfinite(a)))
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite entries "
                f"(shape {a.shape})")


class _FiniteMode(TorchFunctionMode):
    """Checks the floating and complex tensors every torch call returns
    (the checks themselves run outside the mode)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _leaves(out):
            if (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"{getattr(func, '__name__', func)} produced a "
                    f"non-finite value (shape {tuple(t.shape)})")
        return out


def nan_check(fn: Callable) -> Callable:
    """``fn`` wrapped so that it raises ``FloatingPointError`` when an
    intermediate or its output holds a NaN or an infinity. Each check
    reads the value (a device sync per torch call on the card): a
    debugging aid, not for timed runs."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _FiniteMode():
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd's anomaly detection (a NaN in the backward pass raises,
    with the forward op's traceback) on, or off, for the block; the
    previous setting is restored."""
    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old)
