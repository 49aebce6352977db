"""The frame's spans and counters, recorded only while a torch profiler
records.

``span(name)`` marks ``vkr.<name>`` on the profiler's host timeline, the
clock it shares with the CUDA runtime calls and the device's kernels, so
each idle gap and each synchronising call of a trace falls under the
innermost span open on the host.  ``count(name, n)`` adds ``n`` to a
counter that ``counters()`` returns and ``reset()`` clears.  With no
profiler recording both cost one check (``torch.autograd.
_profiler_enabled``) and record nothing: there is no switch besides
profiling.

A span is an op event (``torch._C._profiler._RecordFunctionFast``), not
a user annotation (``torch.profiler.record_function``): for a user
annotation Kineto adds a copy on the device's timeline, which a trace
reader that has no event kinds (torch 2.11 has none) takes for a kernel.
The op event costs about a twentieth of the annotation as well.

A counter takes only a value the host already holds (a length after a
``nonzero``, a loop index): reading a device value would wait for the
device and change what is measured.
"""

from __future__ import annotations

import contextlib
import functools

import torch
try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:     # a torch without op events: user annotations
    _RecordFunctionFast = torch.profiler.record_function

PREFIX = "vkr."
_OFF = contextlib.nullcontext()
_counts: dict[str, int] = {}


def span(name: str):
    """A context that marks ``vkr.<name>`` while a profiler records, the
    one shared null context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(PREFIX + name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return run
    return wrap


def count(name: str, n: int) -> None:
    """Add the host int ``n`` to counter ``name`` while a profiler
    records."""
    if torch.autograd._profiler_enabled():
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of the counters."""
    return dict(_counts)


def reset() -> None:
    """Clear the counters."""
    _counts.clear()
