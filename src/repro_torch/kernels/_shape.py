"""The kernels' shape-only path, for a dry run's trace.

The C entries take raw device pointers, so they cannot run on fake
tensors (``torch._subclasses.FakeTensorMode``) or meta tensors. Each
wrapper therefore checks :func:`shape_only` first: when an input is fake
or meta it returns empty outputs of the right shapes and dtypes and hands
the kernel's work — the floating-point operations and the bytes it must
move, each input read once and each output written once, by the formulas
of the bound column of PERF.md's kernel table — to every sink installed by
:func:`recording` (``repro_torch.launch.counting`` installs one). A real
tensor, on the CPU or on the card, never takes this path, and this path
never counts as a launch.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Callable, List

import numpy as np

_SINKS: List[Callable] = []


def shape_only(*tensors) -> bool:
    """Whether any of ``tensors`` (None entries skipped) is a meta tensor
    or a fake one. A process that never imported the fake-tensor module
    holds no fake tensor, so the check costs a dict lookup there."""
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    for t in tensors:
        if t is None:
            continue
        if t.device.type == "meta" or (fake is not None
                                       and isinstance(t, fake.FakeTensor)):
            return True
    return False


def record(name: str, flops: float, nbytes: float) -> None:
    """One shape-only call of kernel ``name``: its work, to every sink."""
    for sink in _SINKS:
        sink(name, float(flops), float(nbytes))


@contextlib.contextmanager
def recording(sink: Callable):
    """Install ``sink(name, flops, nbytes)`` for the shape-only calls made
    inside the block."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def causal_pairs(S: int, T: int, q_offset: int = 0, window=None) -> int:
    """The (query, key) pairs a causal mask keeps: query i (of S) attends
    keys j < T with j <= q_offset + i and, with a ``window``, j > q_offset
    + i - window."""
    i = np.arange(S, dtype=np.int64) + q_offset
    hi = np.minimum(i, T - 1)
    lo = np.zeros_like(i) if window is None else np.maximum(0, i - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())
