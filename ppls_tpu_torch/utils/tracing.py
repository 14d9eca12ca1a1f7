"""Profiler tracing: ``trace(dir)`` captures any engine run with
``torch.profiler`` (CPU and, where a card is present, CUDA activity) and
writes a Chrome trace (``trace.json``, for Perfetto or
``chrome://tracing``) into ``dir``::

    with trace("/tmp/ppls-trace"):
        integrate_family_walker(...)

Exposed on the CLI as ``--trace DIR`` (every mode). ``annotate(name)``
names a span inside a trace.
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
