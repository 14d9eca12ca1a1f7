"""Host-side span tracing: a structured JSONL timeline of a run.

The port's copy of the JAX package's ``obs/spans.py`` (host-only
Python, imports changed, record format unchanged, so one set of
readers serves both packages). A device profiler answers "what did
the chip do"; this module answers "what did the ENGINE do" — run ->
cycle -> phase -> boundary spans plus admit/retire/reshard/checkpoint
events — as plain JSONL any script can replay after the fact.

One line per record, flushed as written (a crashed run keeps its
prefix; consumers tolerate unbalanced spans via
``validate_events_text(require_balanced=False)``):

* ``{"ev": "meta", "schema": "ppls-events-v1", "t": 0.0, "wall": ...,
  "attrs": {...}}`` — first line; ``wall`` is the one wall-clock
  anchor, every other ``t`` is monotonic seconds since it.
* ``{"ev": "span_open", "id": N, "parent": M|null, "name": ...,
  "t": ..., "attrs": {...}}`` / ``{"ev": "span_close", "id": N,
  "t": ..., "attrs": {...}}`` — hierarchical spans; close attrs carry
  the span's summary (e.g. a phase span closes with its device-counter
  delta row attached).
* ``{"ev": "event", "name": ..., "span": N|null, "t": ...,
  "attrs": {...}}`` — point events (admit/retire/checkpoint/...).

Timestamps are ``time.monotonic()`` deltas — monotone by construction
(the schema validator asserts non-decreasing ``t``), immune to wall
clock steps. DETERMINISM contract: timestamps and ``wall`` vary
between runs; every attr published from device-counted values (areas,
phase stats deltas, crounds, latency in phases) is bit-stable across
reruns and kill-and-resume — the comparison surface the acceptance
tests extract.

Two facilities serve REQUEST-SCOPED tracing:

* **Detached spans** (:meth:`SpanTracer.span_detached`) — spans that
  do NOT join the nesting stack: a request span opened at ingest ack
  stays open across many phase spans and closes at retirement, with
  point events linked to it explicitly (``event(..., span_id=sid)``).
  The schema validator already accepts them (it tracks the OPEN span
  set, not the stack), so a request span is just a span whose parent
  is null and whose lifetime straddles the phase spans'.
* **Size-capped segment rollover** (``max_bytes``) — a long serve must
  not grow ``--events`` without bound. When the file exceeds the cap
  at a SAFE point (every open stack span is a long-lived ``run``
  wrapper — a phase/chip span mid-flight defers the roll to its
  close, so the cap is soft by at most one phase's records), the
  tracer closes the open run + detached spans (``rolled: true``),
  renames the file to ``<path>.<n>`` (n = 1, 2, ...), and starts a
  fresh segment in a new file at ``path``: a fresh ``meta`` line
  (attrs carry ``rollover: n``) followed by the re-opened spans — the
  exact multi-meta-segment shape a resume-append already produces, so
  ``validate_events_text`` accepts every rolled file and the active
  file unchanged.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, IO, List, Optional


class SpanTracer:
    """JSONL span/event writer. ``path=None`` makes every call a cheap
    no-op, so engines can emit unconditionally."""

    def __init__(self, path: Optional[str] = None,
                 meta: Optional[dict] = None, append: bool = False,
                 max_bytes: Optional[int] = None):
        """``append=True`` continues an existing timeline (the serve
        resume path): a fresh ``meta`` line marks the new segment —
        its monotonic clock restarts, so the schema validator checks
        ``t`` monotonicity per segment, not globally.

        ``max_bytes`` arms size-capped rollover: when the
        active file grows past the cap the tracer rotates it to
        ``<path>.<n>`` and continues in a fresh segment at ``path``
        (see the module docstring)."""
        self.path = path
        self._fh: Optional[IO[str]] = None
        self._t0 = time.monotonic()
        self._next_id = 0
        self._stack: List[int] = []
        # detached spans: sid -> (handle, name, open attrs) — kept so a
        # rollover can re-open them in the fresh segment and the
        # caller's _Span handles stay valid across the rotation
        self._detached: Dict[int, tuple] = {}
        # same bookkeeping for open STACK spans: a rollover carries
        # the long-lived "run" wrapper span across the boundary (close
        # with rolled:true, re-open in the fresh segment) — without
        # it the cap could never fire while a run is in flight
        self._stack_info: Dict[int, tuple] = {}
        self._meta = dict(meta or {})
        self.max_bytes = int(max_bytes) if max_bytes else None
        self._bytes = 0
        self._rolled = 0
        self.segment = 0
        if path:
            if append:
                # a resumed timeline CONTINUES the rolled-segment
                # numbering — starting at .1 again would os.replace
                # over the previous lineage's oldest segment
                self._rolled = self._max_rolled_suffix(path)
            else:
                # a fresh run truncates the main file; its stale
                # rolled siblings are the SAME derived artifact and
                # would otherwise splice a previous run's segments
                # into this run's chain
                for n in range(1,
                               self._max_rolled_suffix(path) + 1):
                    try:
                        os.unlink(f"{path}.{n}")
                    except OSError:
                        pass
            self._fh = open(path, "a" if append else "w",
                            encoding="utf-8")
            if append:
                try:
                    self._bytes = self._fh.tell()
                except OSError:
                    self._bytes = 0
            self._write_meta(self._meta)

    @staticmethod
    def _max_rolled_suffix(path: str) -> int:
        import glob
        best = 0
        for s in glob.glob(f"{path}.*"):
            suffix = s[len(path) + 1:]
            if suffix.isdigit():
                best = max(best, int(suffix))
        return best

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def _write_meta(self, attrs: dict) -> None:
        self.segment += 1
        self._write({"ev": "meta", "schema": "ppls-events-v1",
                     "t": 0.0, "wall": time.time(), "attrs": attrs})

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec) + "\n"
        self._fh.write(line)
        self._fh.flush()
        self._bytes += len(line)

    def _maybe_roll(self) -> None:
        """Size-capped segment rollover — only at a SAFE point: every
        open stack span must be a long-lived ``run`` wrapper (a phase
        or chip span mid-flight defers the roll to its close — the
        cap is soft by at most one phase's records). Both the run
        spans and the detached request spans close in the rolled file
        (``rolled: true`` — it stays span-balanced) and re-open in
        the fresh segment, their handles re-pointed in place."""
        if self.max_bytes is None or self._bytes <= self.max_bytes \
                or self._fh is None:
            return
        if any(self._stack_info.get(sid, (None, ""))[1] != "run"
               for sid in self._stack):
            return
        cap, self.max_bytes = self.max_bytes, None   # no recursive roll
        try:
            carried_stack = [(sid,) + self._stack_info[sid]
                             for sid in self._stack]
            carried = sorted(self._detached.items())
            for sid, (_h, _name, _attrs) in carried:
                self._write({"ev": "span_close", "id": sid,
                             "t": self._now(),
                             "attrs": {"rolled": True}})
            for sid in reversed(self._stack):      # children first
                self._write({"ev": "span_close", "id": sid,
                             "t": self._now(),
                             "attrs": {"rolled": True}})
            self._detached.clear()
            self._stack_info.clear()
            self._stack = []
            self._fh.close()
            self._rolled += 1
            os.replace(self.path, f"{self.path}.{self._rolled}")
            self._fh = open(self.path, "w", encoding="utf-8")
            self._bytes = 0
            self._next_id = 0
            self._write_meta(dict(self._meta, rollover=self._rolled))
            for _sid, handle, name, attrs in carried_stack:
                nid = self._next_id
                self._next_id += 1
                parent = self._stack[-1] if self._stack else None
                self._write({"ev": "span_open", "id": nid,
                             "parent": parent, "name": name,
                             "t": self._now(), "attrs": attrs})
                handle._sid = nid
                self._stack.append(nid)
                self._stack_info[nid] = (handle, name, attrs)
            for _sid, (handle, name, attrs) in carried:
                nid = self._next_id
                self._next_id += 1
                self._write({"ev": "span_open", "id": nid,
                             "parent": None, "name": name,
                             "t": self._now(), "attrs": attrs})
                handle._sid = nid
                self._detached[nid] = (handle, name, attrs)
        finally:
            self.max_bytes = cap

    def _now(self) -> float:
        return round(time.monotonic() - self._t0, 6)

    def span(self, name: str, **attrs) -> "_Span":
        """Open a hierarchical span; use as a context manager, or call
        ``.close(**summary_attrs)`` explicitly to attach the span's
        summary (device-counter deltas) at close."""
        if self._fh is None:
            return _Span(self, None)
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1] if self._stack else None
        self._write({"ev": "span_open", "id": sid, "parent": parent,
                     "name": name, "t": self._now(), "attrs": attrs})
        self._stack.append(sid)
        handle = _Span(self, sid)
        self._stack_info[sid] = (handle, name, dict(attrs))
        return handle

    def span_detached(self, name: str, **attrs) -> "_Span":
        """Open a DETACHED span: allocated outside the
        nesting stack, parent null, closed only by its handle — the
        request-span shape whose lifetime straddles phase spans. The
        handle stays valid across a size-cap rollover (the tracer
        re-opens it in the fresh segment)."""
        if self._fh is None:
            return _Span(self, None)
        sid = self._next_id
        self._next_id += 1
        handle = _Span(self, sid, detached=True)
        self._detached[sid] = (handle, name, dict(attrs))
        self._write({"ev": "span_open", "id": sid, "parent": None,
                     "name": name, "t": self._now(), "attrs": attrs})
        return handle

    def event(self, name: str, span_id: Optional[int] = None,
              **attrs) -> None:
        """Point event; linked to the innermost open stack span, or —
        with ``span_id`` — to an explicit open span (the request-span
        linkage path)."""
        if self._fh is None:
            return
        span = span_id if span_id is not None else (
            self._stack[-1] if self._stack else None)
        self._write({"ev": "event", "name": name, "span": span,
                     "t": self._now(), "attrs": attrs})
        self._maybe_roll()

    def _close_span(self, sid: int, attrs: dict) -> None:
        if self._fh is None:
            return
        if sid in self._detached:
            # detached spans never sit on the stack: close directly
            self._detached.pop(sid)
            self._write({"ev": "span_close", "id": sid,
                         "t": self._now(), "attrs": attrs})
            self._maybe_roll()
            return
        # close any children left open (crash-robust nesting): a span
        # close implies its subtree is done
        while self._stack and self._stack[-1] != sid:
            dangling = self._stack.pop()
            self._stack_info.pop(dangling, None)
            self._write({"ev": "span_close", "id": dangling,
                         "t": self._now(), "attrs": {}})
        if self._stack and self._stack[-1] == sid:
            self._stack.pop()
        self._stack_info.pop(sid, None)
        self._write({"ev": "span_close", "id": sid, "t": self._now(),
                     "attrs": attrs})
        self._maybe_roll()

    def close(self) -> None:
        if self._fh is None:
            return
        while self._stack:
            self._close_span(self._stack[-1], {})
        for sid in sorted(self._detached):
            handle = self._detached[sid][0]
            handle._closed = True
            self._detached.pop(sid)
            self._fh.write(json.dumps(
                {"ev": "span_close", "id": sid, "t": self._now(),
                 "attrs": {}}) + "\n")
        self._fh.flush()
        self._fh.close()
        self._fh = None


class _Span:
    """Handle for one open span (no-op when the tracer is disabled)."""

    __slots__ = ("_tracer", "_sid", "_closed", "_detached")

    def __init__(self, tracer: SpanTracer, sid: Optional[int],
                 detached: bool = False):
        self._tracer = tracer
        self._sid = sid
        self._closed = sid is None
        self._detached = detached

    @property
    def sid(self) -> Optional[int]:
        """The span's CURRENT id (a rollover renumbers detached
        spans), or None when disabled/closed — the ``span_id`` to link
        events with."""
        return None if self._closed else self._sid

    def close(self, **attrs) -> None:
        if self._closed:
            return
        self._closed = True
        self._tracer._close_span(self._sid, attrs)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(**({"error": f"{exc_type.__name__}"} if exc_type
                      else {}))
