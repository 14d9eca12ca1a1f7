"""Metrics registry: counters / gauges / histograms with labels.

The port's copy of the JAX package's ``obs/registry.py`` (host-only
Python, unchanged): the metric names and bucket tables are the ones the
bench, serve and the tests read.

The reference's entire metrics surface is one task-count histogram
printed at exit (``aquadPartA.c:109-118``). This registry is the
process-wide sink the engines publish their device-counted signals
into at PHASE BOUNDARIES only — the host already holds the values
(every stream phase pulls exactly one stats row; every batch run pulls
its counter pytree once at collect), so publishing is pure host dict
arithmetic: no extra device fetch (the publish sites live in
boundary hooks, never inside the device cycle).

Design notes:

* **Counters** are monotonic f64/i64 accumulators; **gauges** are
  last-write-wins (plus ``set_max`` for running maxima like
  ``max_depth``); **histograms** are fixed exponential-bucket
  cumulative histograms (2 buckets/octave) with a deterministic
  quantile.
* **Labels** follow the Prometheus child model:
  ``registry.counter("ppls_tasks_total", labelnames=("engine",))
  .labels(engine="walker").inc(n)``. Metrics with no labelnames are
  their own single child.
* **Quantile contract** (the bench/serve tie-break fix): ``quantile(q)``
  returns the upper edge of the first bucket whose cumulative count
  reaches ``ceil(q * n)`` (the overflow bucket reports the tracked
  max). Equal observations land in equal buckets, so runs with tied
  phase counts report identical percentiles regardless of the order
  retirements were appended — unlike ``np.percentile`` over a sorted
  list, which interpolates across ties. ``bench.py stream`` and the
  ``serve`` summary both read quantiles through this one code path.
* **Exposition**: ``exposition()`` renders Prometheus text format
  0.0.4 (``# HELP``/``# TYPE``, ``_bucket{le=...}``/``_sum``/
  ``_count`` for histograms); served live by ``obs.server`` and
  consumable by any Prometheus scraper.

Thread-safety: a lock guards registration and child creation (the
metrics server thread renders while the engine publishes); individual
float adds are GIL-atomic enough for a monitoring surface.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def exp_buckets(start: float, octaves: int,
                per_octave: int = 2) -> Tuple[float, ...]:
    """Exponential bucket upper edges: ``per_octave`` geometric steps
    per doubling, starting at ``start`` — e.g. ``exp_buckets(1, 3)``
    -> (1, 1.5, 2, 3, 4, 6, 8). Integerish edges stay exact (1.5x and
    2x of a power of two are exact f64)."""
    out: List[float] = []
    base = float(start)
    for _ in range(octaves):
        out.append(base)
        if per_octave == 2:
            out.append(base * 1.5)
        else:
            for k in range(1, per_octave):
                out.append(base * 2.0 ** (k / per_octave))
        base *= 2.0
    out.append(base)
    return tuple(out)


# The shared latency bucket tables: phases are
# small integers — 1..2^12 at 2/octave; seconds span 100 us..~2000 s.
PHASE_BUCKETS = exp_buckets(1.0, 12)          # 1, 1.5, 2, 3, ... 4096
SECONDS_BUCKETS = exp_buckets(1e-4, 24)       # 1e-4 ... ~1677 s


def _fmt(v: float) -> str:
    """Prometheus-style number rendering: integers without the .0."""
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and line feed must be escaped (in that order — escaping the
    backslash first keeps the other two escapes unambiguous). A label
    value carrying any of them used to produce an unparseable
    exposition line that silently broke every scraper."""
    return v.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-line escaping per the text format: backslash and line feed
    only (quotes are legal in HELP text)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str]
               ) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class Counter:
    """Monotonic accumulator."""

    __slots__ = ("_v",)

    def __init__(self):
        self._v = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got "
                             f"{amount}")
        self._v += amount

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Last-write-wins value (plus a running-max helper)."""

    __slots__ = ("_v",)

    def __init__(self):
        self._v = 0.0

    def set(self, value: float) -> None:
        self._v = float(value)

    def set_max(self, value: float) -> None:
        self._v = max(self._v, float(value))

    def inc(self, amount: float = 1.0) -> None:
        self._v += amount

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed-bucket cumulative histogram with a deterministic quantile.

    ``buckets`` are the finite upper edges (ascending); an implicit
    +Inf overflow bucket is appended. ``observe`` is O(log buckets).
    """

    __slots__ = ("edges", "counts", "_sum", "_count", "_max")

    def __init__(self, buckets: Sequence[float]):
        edges = [float(b) for b in buckets]
        if not edges or any(nxt <= prev
                            for prev, nxt in zip(edges, edges[1:])):
            raise ValueError(f"bucket edges must be ascending, got "
                             f"{buckets}")
        self.edges: Tuple[float, ...] = tuple(edges) + (math.inf,)
        self.counts = [0] * len(self.edges)
        self._sum = 0.0
        self._count = 0
        self._max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        lo, hi = 0, len(self.edges) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self._sum += v
        self._count += 1
        self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def merge_counts(self, counts: Sequence[int], sum_: float,
                     count: int, max_: float) -> None:
        """Fold another histogram's (delta) bucket counts into this
        one — the federation merge path: the coordinator
        adds each worker's shipped per-bucket deltas so the merged
        histogram's quantiles are computed over the cluster-wide
        sample set. ``counts`` must match this histogram's bucket
        table (the shared PHASE/SECONDS tables guarantee it)."""
        if len(counts) != len(self.counts):
            raise ValueError(
                f"histogram merge: {len(counts)} buckets vs "
                f"{len(self.counts)}")
        for i, c in enumerate(counts):
            self.counts[i] += int(c)
        self._sum += float(sum_)
        self._count += int(count)
        if count:
            self._max = max(self._max, float(max_))

    def quantile(self, q: float) -> Optional[float]:
        """Deterministic bucket-edge quantile (see module docstring).
        Returns None on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        n = self._count
        if n == 0:
            return None
        rank = max(1, math.ceil(q * n))
        cum = 0
        for edge, c in zip(self.edges, self.counts):
            cum += c
            if cum >= rank:
                # the overflow bucket has no finite edge: report the
                # tracked max so p99 is never +Inf
                return self._max if edge == math.inf else edge
        return self._max      # unreachable (cum == n >= rank)


class _Family:
    """One registered metric name: a map of label-value tuples to
    children. A label-less family proxies its single child."""

    def __init__(self, kind: str, name: str, help: str,
                 labelnames: Tuple[str, ...], make, lock):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._make = make
        self._lock = lock
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labelnames:
            self._children[()] = make()

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(sorted(labelvalues))}")
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make())
        return child

    # label-less ergonomic proxies
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}"
                             f"; use .labels(...)")
        return self._children[()]

    def solo(self):
        """The single child of a label-less family."""
        return self._solo()

    def inc(self, amount: float = 1.0):
        return self._solo().inc(amount)

    def set(self, value: float):
        return self._solo().set(value)

    def set_max(self, value: float):
        return self._solo().set_max(value)

    def observe(self, value: float):
        return self._solo().observe(value)

    @property
    def value(self) -> float:
        return self._solo().value

    def quantile(self, q: float):
        return self._solo().quantile(q)

    def items(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        # snapshot under the lock: the metrics-server thread renders
        # while engines create label children via labels()
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Named metric families + Prometheus text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _register(self, kind: str, name: str, help: str,
                  labelnames: Sequence[str], make) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{tuple(labelnames)} but exists as {fam.kind}"
                        f"{fam.labelnames}")
                return fam
            fam = _Family(kind, name, help, tuple(labelnames), make,
                          self._lock)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._register("counter", name, help, labelnames, Counter)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._register("gauge", name, help, labelnames, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = PHASE_BUCKETS,
                  labelnames: Sequence[str] = ()) -> _Family:
        edges = tuple(buckets)
        return self._register("histogram", name, help, labelnames,
                              lambda: Histogram(edges))

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Convenience read: the child's value (counters/gauges), or
        ``default`` when the metric/child was never touched."""
        fam = self._families.get(name)
        if fam is None:
            return default
        try:
            child = fam.labels(**labels) if labels else fam._solo()
        except ValueError:
            return default
        return child.value

    def dump(self) -> dict:
        """JSON-serializable snapshot of every family and child — the
        federation wire format: workers ship this in their
        step/snapshot replies and the coordinator merges the deltas
        into one registry with a ``process`` label
        (``obs.federation``). Deterministically ordered; values are
        CUMULATIVE (the receiver owns delta computation, so a
        retransmit or a skipped phase cannot double-count)."""
        out: Dict[str, dict] = {}
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            children = []
            for key, child in fam.items():
                if fam.kind == "histogram":
                    children.append({
                        "labels": list(key),
                        "counts": list(child.counts),
                        "sum": child.sum, "count": child.count,
                        "max": (child._max if child.count else 0.0)})
                else:
                    children.append({"labels": list(key),
                                     "value": child.value})
            out[name] = {"kind": fam.kind, "help": fam.help,
                         "labelnames": list(fam.labelnames),
                         "children": children}
        return out

    def exposition(self) -> str:
        """Prometheus text format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in fam.items():
                ls = _label_str(fam.labelnames, key)
                if fam.kind == "histogram":
                    cum = 0
                    for edge, c in zip(child.edges, child.counts):
                        cum += c
                        le = _label_str(
                            fam.labelnames + ("le",),
                            key + (_fmt(edge),))
                        lines.append(f"{name}_bucket{le} {cum}")
                    lines.append(f"{name}_sum{ls} {_fmt(child.sum)}")
                    lines.append(f"{name}_count{ls} {child.count}")
                else:
                    lines.append(f"{name}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"
