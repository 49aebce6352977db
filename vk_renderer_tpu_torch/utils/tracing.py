"""The frame's spans and counters, recorded only while a torch profiler
records.

``span(name)`` marks ``vkr.<name>`` on the profiler's host timeline, the
clock it shares with the CUDA runtime calls and the device's kernels, so
each idle gap and each synchronising call of a trace falls under the
innermost span open on the host.  ``count(name, n)`` adds ``n`` to a
counter that ``counters()`` returns and ``reset()`` clears;
``device_counter(name, device)`` hands a kernel the counter's i64 scalar
on the device, into which the kernel adds.  With no profiler recording
all three cost one check (``torch.autograd._profiler_enabled``) and
record nothing (``device_counter`` returns None and the kernel counts
nothing): there is no switch besides profiling.

A span is an op event (``torch._C._profiler._RecordFunctionFast``), not
a user annotation (``torch.profiler.record_function``): for a user
annotation Kineto adds a copy on the device's timeline, which a trace
reader that has no event kinds (torch 2.11 has none) takes for a kernel.
The op event costs about a twentieth of the annotation as well.

A counter takes a value the host already holds (a length after a
``nonzero``, a loop index), or is fed on the device by the kernel that
does the work: reading a device value inside the frame would wait for
the device and change what is measured.  ``counters()`` reads the
device-fed ones once, after the profiled window, and adds them to the
host's under the same names.
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
# (name, device) -> the i64 scalar a kernel adds into
_device_counts: dict[tuple[str, str], torch.Tensor] = {}


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


def device_counter(name: str, device) -> torch.Tensor | None:
    """While a profiler records, counter ``name``'s i64 scalar on
    ``device`` (zeroed when first asked for), which a kernel adds into
    without the host waiting; None otherwise."""
    if not torch.autograd._profiler_enabled():
        return None
    key = (name, str(torch.device(device)))
    t = _device_counts.get(key)
    if t is None:
        t = _device_counts[key] = torch.zeros((), dtype=torch.int64,
                                              device=device)
    return t


def counters() -> dict[str, int]:
    """A copy of the counters, the device-fed ones read (a wait for the
    device: call it after the profiled window) and added in."""
    out = dict(_counts)
    for (name, _), t in _device_counts.items():
        out[name] = out.get(name, 0) + int(t)
    return out


def reset() -> None:
    """Clear the counters, the device-fed ones too."""
    _counts.clear()
    _device_counts.clear()
