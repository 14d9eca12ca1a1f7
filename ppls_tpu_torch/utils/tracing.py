"""Profiler tracing: ``trace(dir)`` captures any engine run with
``torch.profiler`` (CPU and, where a card is present, CUDA activity) and
writes a Chrome trace (``trace.json``, for Perfetto or
``chrome://tracing``) into ``dir``::

    with trace("/tmp/ppls-trace"):
        integrate_family_walker(...)

Exposed on the CLI as ``--trace DIR`` (every mode). ``annotate(name)``
names a span inside a trace. ``device_busy_us`` reads a profile's device
time.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

TRACE_FILE = "trace.json"


def _activities():
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a profiler trace into ``trace_dir`` (no-op for None or
    ""). The directory is created first, so a run never dies after the
    work because the capture directory's parent was missing."""
    if not trace_dir:
        yield
        return
    from torch import profiler

    os.makedirs(trace_dir, exist_ok=True)
    with profiler.profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


def annotate(name: str):
    """A named span inside a trace (``torch.profiler.record_function``)."""
    from torch import profiler

    return profiler.record_function(name)


def device_self_us(event) -> float:
    """A profiler entry's self device time in us."""
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def device_busy_us(events) -> float:
    """The device time of a profile's ``key_averages()``: the kernels,
    copies and fills themselves. A CPU op's self device time holds the
    kernels it launched, which appear again under their own names, so a
    sum over every entry counts each of them twice."""
    from torch.autograd import DeviceType
    return sum(device_self_us(e) for e in events
               if e.device_type != DeviceType.CPU)
