"""The traced run: ``torch.profiler`` over the measured window, and its
reduction to device busy time, kernel time by name, the device ops that
took most time and the longest idle gaps by what the host was doing.

The window is the span of the ``WINDOW`` annotation the drivers open
around their measured loop. Busy time is the union of every device
activity (kernels, copies, fills) inside it; the idle gaps are its
complement there, each named by the outermost annotation and the
innermost host op that were open at the gap's midpoint. The reduction
reads the profiler's raw events, not its parsed ones, so it stays fast
on windows of a million events.
"""

from __future__ import annotations

import contextlib
import heapq
from collections import defaultdict

WINDOW = "benchmark_window"
TOP = 10
# the names of the harness's own annotations (``span``); the profiler of
# some torch versions does not mark user annotations on its raw events
SPANS = {WINDOW}


def profiler():
    """A profiler over host and device activity."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str):
    """A host annotation around a call into one layer."""
    from torch.profiler import record_function
    SPANS.add(name)
    return record_function(name)


@contextlib.contextmanager
def maybe(on: bool, make):
    """``make()`` as a context when ``on``; nothing otherwise."""
    if not on:
        yield None
        return
    with make() as ctx:
        yield ctx


def _is_annotation(ev) -> bool:
    marked = getattr(ev, "is_user_annotation", None)
    return (marked is not None and bool(marked())) or ev.name() in SPANS


def _union(intervals):
    """Merged, sorted (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, top: int = TOP) -> dict:
    """The window's device busy time and its breakdown (seconds).

    Returns ``{"busy_s", "window_s", "kernel_s": {name: s},
    "device_ops": [[name, s], ...], "idle_gaps": [[name, s], ...]}``;
    ``window_s`` is 0 when no window annotation was recorded."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW
           and e.device_type() == DeviceType.CPU]
    if not win:
        return {"busy_s": 0.0, "window_s": 0.0, "kernel_s": {},
                "device_ops": [], "idle_gaps": []}
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.end_ns() for e in win)
    device, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1:
            continue
        if e.device_type() == DeviceType.CPU:
            if e.name() != WINDOW:
                host.append((s, t, e.name(), _is_annotation(e)))
        elif not _is_annotation(e):
            device.append((max(s, w0), min(t, w1), e.name()))
    kernel_ns = defaultdict(int)
    for s, t, name in device:
        kernel_ns[name] += t - s
    busy = _union((s, t) for s, t, _ in device)
    busy_ns = sum(t - s for s, t in busy)
    gaps, edge = [], w0
    for s, t in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if w1 > edge:
        gaps.append((edge, w1))
    gap_ns = _name_gaps(gaps, host)
    ops = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gap_ns.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
        "device_ops": [[_short(k), v / 1e9] for k, v in ops],
        "idle_gaps": [[k, v / 1e9] for k, v in idle],
    }


def _short(name: str, width: int = 64) -> str:
    return name if len(name) <= width else name[:width]


def _name_gaps(gaps, host) -> dict:
    """Seconds of idle device time by the host activity open at each
    gap's midpoint: ``<outermost annotation>___<innermost op>``, or
    either alone, or ``host`` when nothing was open. One sweep over the
    host events in order of start."""
    ops = sorted((h for h in host if not h[3]), key=lambda h: h[0])
    anns = sorted((h for h in host if h[3]), key=lambda h: h[0])
    out = defaultdict(int)
    i = j = 0
    by_end, by_start, alive = [], [], set()
    open_anns = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while i < len(ops) and ops[i][0] <= mid:
            heapq.heappush(by_end, (ops[i][1], i))
            heapq.heappush(by_start, (-ops[i][0], i))
            alive.add(i)
            i += 1
        while by_end and by_end[0][0] < mid:
            alive.discard(heapq.heappop(by_end)[1])
        while by_start and by_start[0][1] not in alive:
            heapq.heappop(by_start)
        while j < len(anns) and anns[j][0] <= mid:
            open_anns.append(anns[j])
            j += 1
        open_anns = [a for a in open_anns if a[1] >= mid]
        inner = ops[by_start[0][1]][2] if by_start else None
        outer = open_anns[0][2] if open_anns else None
        if outer and inner:
            key = f"{outer}___{inner}"
        else:
            key = outer or inner or "host"
        out[_short(key)] += g1 - g0
    return out
