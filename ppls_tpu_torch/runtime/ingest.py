"""Async request ingest for ``python -m ppls_tpu_torch serve``.

The port's copy of the JAX package's ``runtime/ingest.py`` (host-only
Python, the protocol unchanged), with the pool dispatcher's routing
keys (``dispatch=True``: ``eps``, ``rule``) checked through the port's
``runtime/dispatch.canonical_key``.

The reference farmer reads its whole workload at startup; until round
16 this reproduction's serve loop did the same — a stdin JSONL list
materialized before the first phase. This module is the ASYNC half of
the multi-tenant front-end: a tiny stdlib HTTP server (the same
ThreadingHTTPServer shape as ``obs.server.MetricsServer``) that
accepts request records WHILE the phase loop runs, feeding the
engine's pending queue through a caller-supplied, lock-guarded submit
callback.

Protocol (deliberately minimal, curl-from-memory friendly):

* ``POST /submit`` — body is JSONL: one request record per line,
  ``{"theta": T | [T...], "bounds": [A, B], "tenant": "...",
  "priority": P, "deadline_phases": D}`` (tenant/priority/deadline
  optional). The response is JSONL too, one line per request line, in
  order: ``{"rid": N, "accepted": true}`` for an acknowledged
  admission-queue entry, ``{"rid": N, "accepted": false, "shed":
  true, "reason": ...}`` when the engine's shed policy refused it, or
  ``{"accepted": false, "error": ...}`` for a malformed line (bad
  JSON, bad domain, over-limit theta batch). A malformed line NEVER
  aborts the batch or the serve loop — every line gets its verdict.
* ``GET /`` (any path) — a JSON stats object from the caller's
  ``stats_fn`` (queue depth, resident count, phase), so a load
  balancer has a health/backpressure signal.

ACKNOWLEDGMENT CONTRACT: a ``{"accepted": true}`` response means the
request is in the engine's pending queue, which every checkpoint
snapshot includes — so a SIGTERM after the ack can never lose it (the
zero-lost-acks restart contract, BASELINE.md). The submit
callback runs under the serve loop's engine lock; the ack is written
only after it returns.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

# bound per-request body size: an over-limit submission gets an
# explicit rejection, never an OOM (1 MiB is ~10k request lines)
MAX_BODY_BYTES = 1 << 20


class EngineHandle:
    """Lock-guarded publication cell for the live engine.

    The serve loop and the ingest handler threads share exactly one
    piece of mutable state: WHICH engine attempt (if any) is alive and
    may receive submissions. An ingest ack must never land in a dead
    engine during the supervisor's backoff window, so the handle is
    cleared inside the lock that the submit path holds. This class
    makes that structural: ``_eng`` is touched ONLY inside ``with self._lock``
    blocks.

    The lock is REENTRANT and exposed via :meth:`lock`: the serve loop
    holds it across multi-operation critical sections (submit burst +
    phase step + clear-on-death) while the methods here re-acquire it
    harmlessly, so callers compose ``with handle.lock():`` around
    whatever sequence must be atomic against the handler threads.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._eng = None

    def lock(self):
        """The owning RLock, for caller-composed critical sections."""
        return self._lock

    def publish(self, eng) -> None:
        """Make ``eng`` the live engine the handler threads may use."""
        with self._lock:
            self._eng = eng

    def clear(self) -> None:
        """Un-publish (a failed attempt's engine is DEAD state: its
        resume restores the last snapshot, so an ack landing in it
        would be silently lost — callers must clear UNDER the same
        lock that guards the submit path, which this method does)."""
        with self._lock:
            self._eng = None

    def peek(self):
        """The live engine or None. The reference is only safe to USE
        while the caller still holds :meth:`lock` (reentrant, so
        calling this inside a ``with handle.lock():`` block is the
        intended shape); a bare peek is only for read-only stats."""
        with self._lock:
            return self._eng


def parse_request_record(d: dict, theta_block: int = 1,
                         dispatch: bool = False) -> dict:
    """Validate + normalize one ingest/JSONL request record into the
    ``StreamEngine.submit`` kwargs shape. Raises ``ValueError`` with a
    precise message on every malformed shape — the caller turns that
    into the per-line rejection record instead of crashing the loop.

    Accepted keys: ``theta`` (number, or list of <= theta_block
    numbers), ``bounds`` ([lo, hi] finite numbers), optional
    ``tenant`` (str), ``priority`` (int), ``deadline_phases``
    (int >= 1), ``arrival_phase`` (int >= 0, list-driven mode only).
    Domain checks beyond shape (integrand ds-domain, queue policy)
    stay with the engine.

    ``dispatch=True`` (the heterogeneous pool, ``runtime/dispatch.py``)
    additionally accepts the per-request ROUTING KEYS: ``eps`` (positive
    finite number inside the dispatchable band range) and ``rule`` (a
    :class:`~ppls_tpu_torch.config.Rule` member name), validated
    through the dispatcher's canonicalizer, so an out-of-band eps, an
    unknown rule, an over-cap theta batch, or a theta batch on a
    non-TRAPEZOID rule all yield the per-line rejection record here.
    On a single-engine serve (the default) those keys stay UNKNOWN and
    reject."""
    if not isinstance(d, dict):
        raise ValueError("request record must be a JSON object")
    unknown = set(d) - {"theta", "bounds", "tenant", "priority",
                        "deadline_phases", "arrival_phase"}
    if dispatch:
        unknown -= {"eps", "rule"}
    if unknown:
        raise ValueError(f"unknown request keys: {sorted(unknown)}")
    if "theta" not in d or "bounds" not in d:
        raise ValueError("request record needs 'theta' and 'bounds'")
    th = d["theta"]
    if isinstance(th, list):
        if not th or not all(isinstance(x, (int, float))
                             and not isinstance(x, bool) for x in th):
            raise ValueError("'theta' list must hold numbers")
        if len(th) > max(int(theta_block), 1):
            raise ValueError(
                f"theta batch of {len(th)} exceeds this engine's "
                f"theta_block={theta_block}")
        theta = tuple(float(x) for x in th)
    elif isinstance(th, (int, float)) and not isinstance(th, bool):
        theta = float(th)
    else:
        raise ValueError("'theta' must be a number or a list of "
                         "numbers")
    b = d["bounds"]
    if not isinstance(b, list) or len(b) != 2 \
            or not all(isinstance(x, (int, float))
                       and not isinstance(x, bool) for x in b):
        raise ValueError("'bounds' must be [lo, hi] numbers")
    out = {"theta": theta, "bounds": (float(b[0]), float(b[1]))}
    if "tenant" in d:
        if not isinstance(d["tenant"], str) or not d["tenant"]:
            raise ValueError("'tenant' must be a non-empty string")
        out["tenant"] = d["tenant"]
    if "priority" in d:
        p = d["priority"]
        if not isinstance(p, int) or isinstance(p, bool):
            raise ValueError("'priority' must be an integer")
        out["priority"] = p
    if "deadline_phases" in d and d["deadline_phases"] is not None:
        dp = d["deadline_phases"]
        if not isinstance(dp, int) or isinstance(dp, bool) or dp < 1:
            raise ValueError("'deadline_phases' must be an integer "
                             ">= 1")
        out["deadline_phases"] = dp
    if "arrival_phase" in d:
        ap = d["arrival_phase"]
        if not isinstance(ap, int) or isinstance(ap, bool) or ap < 0:
            raise ValueError("'arrival_phase' must be an integer >= 0")
        out["arrival_phase"] = ap
    if dispatch:
        eps = d.get("eps")
        rule = d.get("rule")
        if eps is not None and (not isinstance(eps, (int, float))
                                or isinstance(eps, bool)):
            raise ValueError("'eps' must be a number")
        if rule is not None and not isinstance(rule, str):
            raise ValueError("'rule' must be a string")
        # the full routing-key validation through the canonicalizer
        # (band range, rule membership, bucket cap, batch-rule cross
        # checks); absent keys validate against placeholder defaults so
        # a bad theta batch still rejects here, and the dispatcher's own
        # defaults apply at submit
        from ppls_tpu_torch.runtime.dispatch import canonical_key
        canonical_key(1e-6 if eps is None else eps,
                      "trapezoid" if rule is None else rule,
                      out["theta"])
        if eps is not None:
            out["eps"] = float(eps)
        if rule is not None:
            out["rule"] = str(rule).strip().lower()
    return out


def ingest_lines(text: str, submit_fn) -> list:
    """Feed a JSONL body through ``submit_fn`` line by line; returns
    one response record per non-empty line (see the module docstring
    for the shapes). A malformed line yields a rejection record and
    the remaining lines still process — the never-crash contract the
    serve loop's stdin path shares."""
    out = []
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError as e:
            out.append({"accepted": False, "line": i,
                        "error": f"unparseable JSON: {e}"[:200]})
            continue
        try:
            out.append(submit_fn(d))
        except ValueError as e:
            out.append({"accepted": False, "line": i,
                        "error": str(e)[:200]})
    return out


class IngestServer:
    """Threaded ingest endpoint over a caller-supplied submit
    callback. ``submit_fn(record_dict) -> response_dict`` must be
    thread-safe (the serve CLI wraps it in the engine lock) and raise
    ``ValueError`` for malformed records. ``stats_fn()`` (optional)
    backs the GET health/backpressure response."""

    def __init__(self, submit_fn, port: int = 0,
                 host: str = "127.0.0.1", stats_fn=None):
        self.submit_fn = submit_fn
        self.stats_fn = stats_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):      # noqa: N802 — stdlib API name
                n = int(self.headers.get("Content-Length") or 0)
                if n > MAX_BODY_BYTES:
                    self._reply(413, json.dumps(
                        {"accepted": False,
                         "error": f"body over {MAX_BODY_BYTES} "
                                  f"bytes"}).encode() + b"\n")
                    return
                body = self.rfile.read(n).decode("utf-8", "replace")
                responses = ingest_lines(body, outer.submit_fn)
                self._reply(200, ("\n".join(
                    json.dumps(r) for r in responses)
                    + "\n").encode("utf-8"),
                    ctype="application/jsonl")

            def do_GET(self):       # noqa: N802 — stdlib API name
                stats = outer.stats_fn() if outer.stats_fn else {}
                self._reply(200, (json.dumps(stats) + "\n").encode())

            def log_message(self, *args):   # keep stderr clean
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ppls-ingest",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/submit"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
