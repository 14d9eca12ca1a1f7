"""The port's copy of the JAX package's ``obs/telemetry.py`` (host-only
Python, imports changed).

The unified ``Telemetry`` handle the engines thread through their
boundary hooks: one metrics registry + one span tracer behind a single
object, so ``serve``, the benches, and the batch CLIs all publish and
read through the same surface.

Publication sites are HOST boundary hooks only (stream ``step()``,
batch-engine result assembly, checkpoint leg loops): the device values
they publish are the ones the boundary already fetched — one device
pull per boundary, no telemetry-added syncs.

Two usage modes:

* **Per-engine handle** (the stream engine): ``Telemetry()`` owns a
  fresh registry, so per-run totals read back exactly (the stream's
  ``result()`` sources its totals from it).
* **Process default** (batch engines, benches):
  ``default_telemetry()`` — a process-wide handle whose counters are
  cumulative across runs, Prometheus-style. ``set_default()`` lets the
  CLI point it at an events file / shared registry for a run.
"""

from __future__ import annotations

import threading
from typing import Optional

from ppls_tpu_torch.obs.registry import (MetricsRegistry, PHASE_BUCKETS,
                                   SECONDS_BUCKETS)
from ppls_tpu_torch.obs.spans import SpanTracer

# run-level counter stats every batch engine shares (RunMetrics names)
_RUN_COUNTERS = ("tasks", "splits", "leaves", "rounds",
                 "integrand_evals")

# lane-waste attribution buckets (walker.WASTE_FIELDS order;
# spelled locally so the pure-Python obs layer imports no engine);
# theta_overwalk counts live lane-steps spent on already-accepted
# thetas in union-refinement (theta_block > 1) mode; 0 otherwise.
WASTE_BUCKETS = ("eval_active", "masked_dead", "refill_stall",
                 "drain_tail", "theta_overwalk")


def build_attribution(buckets: dict, lane_cycles: int) -> dict:
    """THE attribution record: one builder for every reader —
    ``WalkerResult.attribution()``, ``StreamResult.occupancy_summary``,
    and the analyze-occupancy printers — so the dominant-bucket rule
    and the reconciliation definition can never diverge between bench,
    serve, and the offline tools."""
    lane_cycles = int(lane_cycles)
    buckets = {k: int(buckets.get(k, 0)) for k in WASTE_BUCKETS}
    wasted = {k: buckets[k] for k in WASTE_BUCKETS[1:]}
    return {
        "lane_cycles": lane_cycles,
        "buckets": buckets,
        "fractions": {k: (round(v / lane_cycles, 4) if lane_cycles
                          else 0.0) for k, v in buckets.items()},
        "reconciles": sum(buckets.values()) == lane_cycles,
        "dominant_waste": (max(wasted, key=wasted.get)
                           if any(wasted.values()) else None),
    }


class Telemetry:
    """Registry + tracer behind one handle (see module docstring)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 events_path: Optional[str] = None,
                 meta: Optional[dict] = None, append: bool = False,
                 events_max_bytes: Optional[int] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = SpanTracer(events_path, meta=meta, append=append,
                                 max_bytes=events_max_bytes)
        # compile observability: last-seen pjit cache entry
        # count per engine, so growth — a recompile under the
        # compile-once invariant — surfaces as an event + counter
        # instead of only failing the conftest guard
        self._compile_seen: dict = {}
        self._compile_lock = threading.Lock()

    # -- tracer passthroughs ------------------------------------------------

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def event(self, name: str, **attrs) -> None:
        self.tracer.event(name, **attrs)

    def close(self) -> None:
        self.tracer.close()

    # -- request-scoped tracing ----------------------------------

    def request_span(self, rid: int, **attrs):
        """Open the DETACHED per-request span: the root of one rid's
        causal trace, opened at ingest ack, closed at the terminal
        disposition (retire/shed). Stays open across phase spans; its
        child events link by ``request_event``. No-op without an
        events file, like every tracer call."""
        return self.tracer.span_detached("request", rid=int(rid),
                                         **attrs)

    def request_event(self, span, name: str, **attrs) -> None:
        """Emit one child event of a request span (``span`` is the
        handle ``request_span`` returned; a disabled/closed handle
        degrades to an unlinked event so emit sites stay
        unconditional). Routes through :meth:`event` so spies and
        proxies that wrap it observe the request-trace emits too
        (``span_id`` passes through to the tracer)."""
        sid = span.sid if span is not None else None
        self.event(name, span_id=sid, **attrs)

    # -- boundary-hook publishers -------------------------------------------
    # (host-only; each consumes values its caller already holds)

    def publish_run(self, engine: str, metrics, *, cycles: int = 0,
                    crounds: int = 0, lane_efficiency: float = 0.0,
                    walker_fraction: float = 0.0,
                    waste=None, tasks_per_chip=None) -> None:
        """Run-completion boundary: fold one finished batch run's
        ``RunMetrics`` into the registry (labeled by engine).

        ``waste`` is the 4-vector of device-counted
        lane-waste buckets (WASTE_BUCKETS order); ``tasks_per_chip``
        feeds the chip-balance gauges on multi-chip runs."""
        reg = self.registry
        lab = ("engine",)
        reg.counter("ppls_runs_total",
                    "completed integration runs", lab) \
            .labels(engine=engine).inc()
        for k in _RUN_COUNTERS:
            reg.counter(f"ppls_{k}_total",
                        f"device-counted {k} across runs", lab) \
                .labels(engine=engine).inc(float(getattr(metrics, k)))
        if cycles:
            reg.counter("ppls_cycles_total", "engine cycles", lab) \
                .labels(engine=engine).inc(float(cycles))
        if crounds:
            reg.counter("ppls_crounds_total",
                        "lockstep collective boundaries", lab) \
                .labels(engine=engine).inc(float(crounds))
        reg.gauge("ppls_max_depth", "max refinement depth seen", lab) \
            .labels(engine=engine).set_max(float(metrics.max_depth))
        reg.gauge("ppls_lane_efficiency",
                  "walker tasks / kernel lane-steps (last run)", lab) \
            .labels(engine=engine).set(float(lane_efficiency))
        reg.gauge("ppls_walker_fraction",
                  "share of tasks done by the Pallas kernel "
                  "(last run)", lab) \
            .labels(engine=engine).set(float(walker_fraction))
        if waste is not None:
            fam = reg.counter(
                "ppls_lane_cycles_total",
                "kernel lane-cycles by attribution bucket "
                "(eval_active + masked_dead + refill_stall + "
                "drain_tail + theta_overwalk = lanes x kernel steps)",
                ("engine", "bucket"))
            for k, v in zip(WASTE_BUCKETS, waste):
                fam.labels(engine=engine, bucket=k).inc(float(v))
        if tasks_per_chip is not None and len(tasks_per_chip) > 1:
            self.publish_chip_balance(engine, tasks_per_chip)

    def publish_chip_balance(self, engine: str, per_chip) -> None:
        """Chip-balance gauges (flight recorder): max/min/
        spread of a per-chip work vector — the registry face of the
        per-chip spans the dd stream writes to the events file."""
        vals = [float(v) for v in per_chip]
        mx, mn = max(vals), min(vals)
        lab = ("engine",)
        g = self.registry.gauge
        g("ppls_chip_share_max", "largest per-chip work share "
          "(last run/phase)", lab).labels(engine=engine) \
            .set(mx / max(sum(vals), 1.0))
        g("ppls_chip_share_min", "smallest per-chip work share "
          "(last run/phase)", lab).labels(engine=engine) \
            .set(mn / max(sum(vals), 1.0))
        g("ppls_chip_spread", "per-chip work max/min ratio "
          "(1.0 = perfectly balanced)", lab).labels(engine=engine) \
            .set(mx / max(mn, 1.0))

    def publish_compile_cache(self, engine: str, entries: int) -> None:
        self.registry.gauge(
            "ppls_compile_cache_entries",
            "pjit cache entries of the engine's cycle program "
            "(compile-once invariant: stays at 1)",
            ("engine",)).labels(engine=engine).set(float(entries))

    def publish_compile(self, engine: str, entries: int,
                        wall_s: float = 0.0) -> None:
        """Compile observability, wired through the
        compile-once guard surface (``fn._cache_size()``): publish the
        engine's pjit cache entry count, and when it GREW since this
        handle last looked, emit a ``jit_cache_entry`` event and count
        it — entries beyond the engine's first observation are
        recompiles under the compile-once invariant, so any recompile
        shows up in the events file and on /metrics instead of only
        failing a test. ``wall_s`` is the caller's wall clock for the
        step/run that grew the cache (the stream attributes its phase
        wall; batch engines pass 0 — their compile happens inside one
        opaque run call)."""
        entries = int(entries)
        with self._compile_lock:
            prev = self._compile_seen.get(engine)
            self._compile_seen[engine] = entries
        self.publish_compile_cache(engine, entries)
        if prev is not None and entries > prev:
            delta = entries - prev
            lab = ("engine",)
            self.registry.counter(
                "ppls_recompiles_total",
                "pjit cache growth events after the engine's first "
                "observation (compile-once invariant violations)",
                lab).labels(engine=engine).inc(delta)
            if wall_s:
                self.registry.counter(
                    "ppls_compile_wall_seconds_total",
                    "wall seconds of steps that grew the pjit cache "
                    "(compile + retrace time, attributed per engine)",
                    lab).labels(engine=engine).inc(float(wall_s))
            self.event("jit_cache_entry", engine=engine,
                       entries=entries, new_entries=delta,
                       wall_s=round(float(wall_s), 6))
        elif prev is None:
            # first observation: baseline, not a recompile — but the
            # cache-entry count still lands in the timeline so a
            # TPU-attached round's compile cadence is reconstructable
            self.event("jit_cache_entry", engine=engine,
                       entries=entries, new_entries=0,
                       wall_s=round(float(wall_s), 6))

    # stream-specific registration helpers (the stream engine owns the
    # calls; centralizing the names/buckets here keeps bench + serve +
    # analyze reading the same metric names)

    def stream_counter(self, stat: str):
        return self.registry.counter(
            f"ppls_stream_{stat}_total",
            f"device-counted per-phase {stat}, summed over phases")

    def stream_gauge(self, name: str, help: str = ""):
        return self.registry.gauge(f"ppls_stream_{name}", help)

    def latency_phases_histogram(self):
        return self.registry.histogram(
            "ppls_stream_retire_latency_phases",
            "request latency submit->retire in device phases",
            buckets=PHASE_BUCKETS)

    def latency_seconds_histogram(self):
        return self.registry.histogram(
            "ppls_stream_retire_latency_seconds",
            "request latency submit->retire in seconds",
            buckets=SECONDS_BUCKETS)

    # multi-tenant SLO surface: one registration site so the
    # stream engine, the serve summary, bench.py stream, and
    # analyze_occupancy all read the same labeled metric names

    def shed_counter(self):
        return self.registry.counter(
            "ppls_requests_shed_total",
            "requests shed by admission control, by tenant and reason",
            ("tenant", "reason"))

    def class_latency_histogram(self):
        return self.registry.histogram(
            "ppls_stream_class_retire_latency_phases",
            "request latency submit->retire in phases, by priority "
            "class", buckets=PHASE_BUCKETS, labelnames=("priority",))

    def tenant_latency_histogram(self):
        return self.registry.histogram(
            "ppls_stream_tenant_retire_latency_phases",
            "request latency submit->retire in phases, by tenant",
            buckets=PHASE_BUCKETS, labelnames=("tenant",))

    # heterogeneous-dispatch surface: engine-labeled pool
    # metrics, registered here for the same reason as above — the
    # dispatcher, the serve summary, bench.py stream --hetero, and
    # analyze_occupancy must all read identical names

    def dispatch_engines_gauge(self):
        return self.registry.gauge(
            "ppls_dispatch_engines",
            "pooled stream engines by state (live / parked)",
            ("state",))

    def dispatch_phase_counter(self):
        return self.registry.counter(
            "ppls_dispatch_phases_total",
            "engine phases run by the work-conserving dispatcher "
            "schedule, by engine key", ("engine",))

    def dispatch_routed_counter(self):
        return self.registry.counter(
            "ppls_dispatch_routed_total",
            "requests dealt from the pool backlog to an engine, by "
            "engine key", ("engine",))

    def dispatch_latency_histogram(self):
        return self.registry.histogram(
            "ppls_dispatch_retire_latency_turns",
            "pool-scope request latency submit->retire in dispatcher "
            "turns, by engine key", buckets=PHASE_BUCKETS,
            labelnames=("engine",))


_default_lock = threading.Lock()
_default: Optional[Telemetry] = None


def default_telemetry() -> Telemetry:
    """The process-wide handle (registry only, no events file unless
    ``set_default`` installed one). Batch engines publish here."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Telemetry()
        return _default


def set_default(tel: Optional[Telemetry]) -> Optional[Telemetry]:
    """Install (or with None: reset) the process default; returns the
    previous handle so callers can restore it."""
    global _default
    with _default_lock:
        prev = _default
        _default = tel
        return prev
