"""Continuous-batching streaming walker: phase-boundary admission and
retirement of concurrent integration requests (the reference's
``runtime/stream.py``, engine ``"walker"``, on one card).

One phase is one cycle of the family walker
(:func:`~ppls_tpu_torch.parallel.walker.run_stream_cycle`). Between
phases the host:

* admits queued requests into free FAMILY SLOTS: one contiguous push of
  seed rows onto the bag top plus a clear of the recycled slots'
  accumulators (:func:`_admit_program`), before the cycle, so new seeds
  breed and deal in the same phase;
* retires every slot whose live-row count reached zero: lane state folds
  back into the bag at every cycle edge, so its Neumaier-compensated
  running area is final;
* applies the overload policy: per-tenant token buckets, admission by
  (-priority, rid), a bounded queue that sheds the lowest-priority
  oldest request, and deadlines (a queued request that can no longer
  meet its deadline is shed; an in-flight one retires failed and its
  live rows are compacted out of the bag by a stable partition,
  :func:`_cancel_program`).

The cycle runs K1 with in-kernel refill (``refill_slots`` > 0, the
default 8) and K2 with boundary refill (``refill_slots=0``); the float64
mode (``f64_rounds`` > 0) runs bag rounds only. Every decision is a
function of the schedule and of device-counted state, so reruns repeat
exactly.

With ``checkpoint_path`` the engine snapshots its whole state every
``checkpoint_every`` phases, at the phase close
(:meth:`StreamEngine.snapshot`: the live bag prefix, the ``(acc,
acc_c)`` pair and the host bookkeeping, in the reference's container
and keys, so either package resumes the other's snapshot), and
:meth:`StreamEngine.resume` rebuilds the engine from it; the continued
stream replays the identical phases.
``client_state`` is the caller's own JSON-serialisable record, carried
by every snapshot.

A ``fault_injector`` (``runtime/faults.py``) fires its plan at the
engine's boundaries: phase open (before admission), admission (a
``nan_poison`` request's theta turns NaN after validation), phase close
(after the snapshot) and checkpoint write (after the rename).

With ``spillover=True`` a queue-overflow victim without a deadline runs
to completion as float64 bag rounds on the host CPU
(``backends/spillover.py``, the reference's design) instead of being
shed: up to ``spillover_limit`` of them at each phase boundary, busy or
idle, each retiring with ``spillover=True``. The spill queue and the
executor's totals ride every snapshot.

``slo_config`` arms the SLO burn-rate evaluator (``obs/slo.py``) at
every phase close, over the registry the boundary already published;
``slo_health`` is its ``/health`` verdict. ``adapt=True`` moves the
admission budget and the spillover batch limit within their safe bands
at every phase close (``runtime/tune.py`` ``OnlineAdapter``, from the
stats row the phase already read); its state rides every snapshot.

``engine="walker-dd"`` is the multi-chip stream: the demand-driven
walker (``parallel/sharded_walker.py``) over ``n_devices`` ranks that
live as long as the engine (``mesh.World``: rank 0 in this process, the
others spawned once, when the store is built). Each phase the host deals
the admitted requests round-robin over the ranks; every rank pushes its
block onto its own queue top, clears its recycled slots' partial areas
and runs one cycle (``build_dd_walker_run(admit_window=)``), and rank 0
reads ONE gather of every rank's counters, live counts and partial
areas. A request's area is the sum of the ranks' partials in rank
order. ``obs/flight.py`` publishes each phase's per-rank attribution.
Deadline expiry compacts every rank's queue; snapshots gather every
rank's live prefix in rank order, and ``resume(mesh_resize=True)``
re-deals a snapshot of another world size (``mesh.host_strided_redeal``).
:meth:`StreamEngine.close` (or the context manager) stops the ranks.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import (check_ds_domain, get_family,
                                              get_family_ds)
from ppls_tpu_torch.obs.flight import ChipFlightRecorder
from ppls_tpu_torch.obs.registry import (PHASE_BUCKETS, SECONDS_BUCKETS,
                                         Histogram)
from ppls_tpu_torch.obs.telemetry import Telemetry, build_attribution
from ppls_tpu_torch.parallel.bag_engine import (DEPTH_BITS, DEPTH_MASK,
                                                BagState, _pull_prefix,
                                                _restore_bag)
from ppls_tpu_torch.parallel.mesh import (World, default_world,
                                          host_strided_redeal)
from ppls_tpu_torch.parallel.sharded_walker import (CTR64, _CTR64_MAX,
                                                    DDStreamRank, _dd_sizing,
                                                    dd_row_layout)
from ppls_tpu_torch.parallel.walker import (
    DEFAULT_LANES, N_WASTE, SORT_SKIP_RATIO, STREAM_STAT_FIELDS,
    WASTE_FIELDS,
    _is_reduced_twin, pull_stream_cycle, resolve_cadence,
    resolve_scout_dtype, run_stream_cycle, validate_double_buffer,
    validate_theta_block, walker_sizing)
from ppls_tpu_torch.runtime.checkpoint import (
    background_writer, engine_name, flush_background_writer,
    load_family_checkpoint, save_family_checkpoint)
from ppls_tpu_torch.runtime.tune import (ADAPT_WASTE_FRAC, OnlineAdapter,
                                         last_resolution, workload_signature)
from ppls_tpu_torch.utils.device import HostSyncs, resolve_device
from ppls_tpu_torch.utils.metrics import round_stats_from_rows

# STREAM_STAT_FIELDS columns that accumulate as registry counters (all
# but the running max)
_COUNTER_STATS = tuple(k for k in STREAM_STAT_FIELDS if k != "maxd")


@dataclasses.dataclass
class StreamRequest:
    """One pending request: one 1D integral (scalar ``theta``), or on a
    ``theta_block`` = T > 1 engine a THETA BATCH of up to T thetas
    scored over one shared union-refinement frontier (a tuple).
    ``deadline_phases`` is the request's phase budget: it retires by
    ``submit_phase + deadline_phases`` or fails."""

    rid: int
    theta: object                 # float, or tuple of floats (batch)
    bounds: Tuple[float, float]
    submit_phase: int
    submit_t: float
    tenant: str = "default"
    priority: int = 1
    deadline_phases: Optional[int] = None

    @property
    def thetas(self) -> Tuple[float, ...]:
        t = self.theta
        return tuple(t) if isinstance(t, (tuple, list)) else (float(t),)

    @property
    def deadline_phase(self) -> Optional[int]:
        """Last phase index at which this request may retire."""
        if self.deadline_phases is None:
            return None
        return self.submit_phase + int(self.deadline_phases)


@dataclasses.dataclass
class ShedRecord:
    """A request refused by admission control. Shed requests consume a
    rid, so rids stay aligned with the submission order."""

    rid: int
    theta: object
    bounds: Tuple[float, float]
    tenant: str
    priority: int
    reason: str                   # "queue_full" | "deadline_exceeded"
    phase: int                    # phase index the shed happened at
    submit_phase: int


@dataclasses.dataclass
class CompletedRequest:
    """A retired request: its area and latency accounting.

    ``phases_in_flight`` counts phases from admission through retirement
    inclusive; ``latency_phases`` adds the queue wait (submit -> retire).
    ``last_credited_phase`` is -1 for a request that never credited.
    ``failed`` marks a quarantined (non-finite) or deadline-expired
    retirement (``failure`` "nan" or "deadline_exceeded"): its area
    fields carry no answer."""

    rid: int
    theta: object
    bounds: Tuple[float, float]
    area: float               # scalar requests; first theta on batches
    submit_phase: int
    admit_phase: int
    retire_phase: int
    latency_s: float
    first_seeded_phase: int
    last_credited_phase: int
    areas: Optional[List[float]] = None   # theta batches: per-theta areas
    failed: bool = False
    tenant: str = "default"
    priority: int = 1
    failure: Optional[str] = None
    # completed on the CPU spillover backend instead of the engine
    spillover: bool = False

    @property
    def phases_in_flight(self) -> int:
        return self.retire_phase - self.admit_phase + 1

    @property
    def latency_phases(self) -> int:
        return self.retire_phase - self.submit_phase + 1


@dataclasses.dataclass
class StreamResult:
    """Aggregate result of a stream (``StreamEngine.run``/``result``)."""

    completed: List[CompletedRequest]
    phases: int
    wall_s: float
    totals: dict                 # registry-sourced STREAM_STAT_FIELDS sums
    phase_stats: np.ndarray      # (phases, len(STREAM_STAT_FIELDS)) i64
    fam_done: Optional[np.ndarray] = None         # (slots,) bool
    fam_first_phase: Optional[np.ndarray] = None  # (slots,) i32, -1=never
    fam_last_phase: Optional[np.ndarray] = None   # (slots,) i32, -1=never
    # the registry's latency histograms: the one quantile path; None on
    # hand-assembled results (rebuilt from ``completed``)
    latency_hist_phases: Optional[object] = None
    latency_hist_seconds: Optional[object] = None
    per_round: List = dataclasses.field(default_factory=list)
    # every request refused by admission control: completed + shed ==
    # requests submitted
    shed: List = dataclasses.field(default_factory=list)
    # device reads by the host loop, in all and per non-idle phase
    host_syncs: int = 0
    host_syncs_per_phase: List[int] = dataclasses.field(
        default_factory=list)
    # walker-dd: the transport and every rank's host syncs, collective
    # calls by kind and K1 / K2 launches, as of the last phase's gather
    mesh: Optional[dict] = None

    @property
    def areas(self) -> np.ndarray:
        """Areas in request-id order."""
        done = sorted(self.completed, key=lambda c: c.rid)
        return np.array([c.area for c in done])

    @property
    def requests_per_sec(self) -> float:
        return len(self.completed) / self.wall_s if self.wall_s else 0.0

    def latency_percentiles(self) -> dict:
        """p50/p99 request latency (submit -> retire, queue wait
        included) in phases and seconds, through the registry
        histograms' bucket-edge quantile."""
        if not self.completed:
            return {}
        hp, hs = self.latency_hist_phases, self.latency_hist_seconds
        if hp is None or hs is None or hp.count != len(self.completed):
            hp = Histogram(PHASE_BUCKETS)
            hs = Histogram(SECONDS_BUCKETS)
            for c in self.completed:
                hp.observe(c.latency_phases)
                hs.observe(c.latency_s)
        return {
            "p50_phases": float(hp.quantile(0.5)),
            "p99_phases": float(hp.quantile(0.99)),
            "p50_s": float(hs.quantile(0.5)),
            "p99_s": float(hs.quantile(0.99)),
        }

    def spillover_summary(self) -> dict:
        """How much of the completed work ran on the CPU spillover
        backend instead of the engine."""
        done = [c for c in self.completed if c.spillover]
        return {
            "spillover_completed": len(done),
            "spillover_fraction": (len(done) / len(self.completed)
                                   if self.completed else 0.0),
        }

    def class_latency_percentiles(self) -> dict:
        """p50/p99 retire latency in phases per priority class, failed
        retirements included."""
        by_class: dict = {}
        for c in self.completed:
            h = by_class.setdefault(int(c.priority),
                                    Histogram(PHASE_BUCKETS))
            h.observe(c.latency_phases)
        return {
            str(p): {
                "count": h.count,
                "p50_phases": float(h.quantile(0.5)),
                "p99_phases": float(h.quantile(0.99)),
            } for p, h in sorted(by_class.items())}

    def tenant_summary(self) -> dict:
        """Per-tenant retired / failed / shed counts and shed reasons."""
        out: dict = {}

        def row(tenant):
            return out.setdefault(str(tenant), {
                "completed": 0, "failed": 0, "shed": 0,
                "shed_reasons": {}})

        for c in self.completed:
            r = row(c.tenant)
            r["completed"] += 1
            if c.failed:
                r["failed"] += 1
        for s in self.shed:
            r = row(s.tenant)
            r["shed"] += 1
            r["shed_reasons"][s.reason] = \
                r["shed_reasons"].get(s.reason, 0) + 1
        return out

    def occupancy_summary(self, lanes: int) -> dict:
        """Steady-state occupancy from the phase rows."""
        t = self.totals
        wsteps = int(t.get("wsteps", 0))
        out = {
            "lane_efficiency": (int(t["wtasks"]) / (wsteps * lanes)
                                if wsteps else 0.0),
            "walker_fraction": (int(t["wtasks"]) / int(t["tasks"])
                                if t.get("tasks") else 0.0),
        }
        buckets = {k: int(t.get(k, 0)) for k in WASTE_FIELDS}
        if any(buckets.values()):
            out["attribution"] = build_attribution(buckets, wsteps * lanes)
        ps = self.phase_stats
        if ps is not None and len(ps):
            j = STREAM_STAT_FIELDS.index("live_families")
            k = STREAM_STAT_FIELDS.index("live_tasks")
            out["mean_live_families"] = float(ps[:, j].mean())
            out["mean_live_tasks"] = float(ps[:, k].mean())
        return out


def _admit_program(bag: BagState, acc: torch.Tensor, acc_c: torch.Tensor,
                   fam_last: torch.Tensor, seeds_l: torch.Tensor,
                   seeds_r: torch.Tensor, seeds_th: torch.Tensor,
                   seeds_meta: torch.Tensor, n_new: int,
                   clear: torch.Tensor, *, capacity: int):
    """Push the ``n_new`` seed rows (the dense prefix of the fixed-width
    seed arrays; pad rows carry in-domain fill) onto the bag top, in
    place, and clear the recycled slots' accumulators and last-credit
    marks. The whole window is written: ``count + window`` past the
    store raises (the reference's update clamps its start there; the
    engine's admit window keeps clear of it). Returns ``(bag, acc,
    acc_c, fam_last)``."""
    start = bag.count
    window = seeds_l.shape[0]
    store = bag.bag_l.shape[0]
    if start + window > store:
        raise ValueError(
            f"admit window of {window} rows at count {start} overruns the "
            f"bag store ({store} rows)")
    for col, seeds in ((bag.bag_l, seeds_l), (bag.bag_r, seeds_r),
                       (bag.bag_th, seeds_th), (bag.bag_meta, seeds_meta)):
        col[start:start + window] = seeds
    count = start + int(n_new)
    # theta mode: the accumulator pair is (slots * T,) and the clear mask
    # per slot
    clear_acc = (clear.repeat_interleave(acc.shape[0] // clear.shape[0])
                 if acc.shape[0] != clear.shape[0] else clear)
    bag = dataclasses.replace(bag, count=count,
                              overflow=bag.overflow or count > capacity)
    return (bag, torch.where(clear_acc, 0.0, acc),
            torch.where(clear_acc, 0.0, acc_c),
            torch.where(clear, torch.full_like(fam_last, -1), fam_last))


def _cancel_program(bag: BagState, kill: torch.Tensor,
                    syncs: HostSyncs) -> BagState:
    """Compact the live prefix, dropping every row whose family slot is
    in the ``kill`` mask. A STABLE partition: surviving rows keep their
    bag order, so the continued schedule is a function of state alone.
    Dropped rows become in-domain fill past the new count. Reads the new
    count (one sync)."""
    n = bag.bag_l.shape[0]
    dev = bag.bag_l.device
    live = torch.arange(n, dtype=torch.int32, device=dev) < bag.count
    slot = torch.clamp(bag.bag_meta >> DEPTH_BITS, 0, kill.shape[0] - 1)
    keep = live & ~(kill[slot.to(torch.int64)] & live)
    order = torch.argsort(torch.where(keep, 0, 1).to(torch.int32),
                          stable=True)
    return dataclasses.replace(
        bag, bag_l=bag.bag_l[order], bag_r=bag.bag_r[order],
        bag_th=bag.bag_th[order], bag_meta=bag.bag_meta[order],
        count=int(syncs.pull(keep.sum(dtype=torch.int64))))


def _stream_identity(engine: str, family: str, eps: float, rule: Rule,
                     slots: int, lanes: int, chunk: int, capacity: int,
                     roots_per_lane: int, refill_slots: int,
                     n_dev: int = 1) -> dict:
    return {"engine": engine_name(engine, rule), "fname": family,
            "eps": float(eps), "m": int(slots), "lanes": int(lanes),
            "chunk": int(chunk), "capacity": int(capacity),
            "roots_per_lane": int(roots_per_lane),
            "refill_slots": int(refill_slots), "n_dev": int(n_dev)}


class StreamEngine:
    """Long-lived streaming integration service over the walker, on one
    card (or on the CPU with ``device="cpu"``).

    ``family`` names the integrand (its float64 form and ds twin).
    ``eps``/``rule`` are per engine; ``slots`` bounds the requests
    resident at once; the pending queue is unbounded unless
    ``queue_limit`` is set.

    Typical driving loop::

        eng = StreamEngine("sin_recip_scaled", eps=1e-8, slots=32)
        eng.submit(theta=1.25, bounds=(1e-3, 1.0))
        done = eng.step()        # one phase: admit -> cycle -> retire
        rest = eng.drain()       # phases until everything retires

    or the one-shot ``run(requests, arrival_phase=...)``.

    The reference's parameters and defaults, with ``device`` in place of
    ``interpret``. ``spillover`` runs queue-overflow victims on the host
    CPU (``spillover_limit`` per phase). ``engine="walker-dd"`` runs the
    stream over ``n_devices`` ranks (default: every card, one rank on
    the CPU; ``mesh``, a ``mesh.Mesh`` or ``mesh.World`` or an int, is
    read for its size), which live until :meth:`close`; the walker
    engine runs on one card and refuses ``n_devices`` > 1.
    ``reduced_integrands`` walks the family's
    range-reduced ds twin where it has one. Unless ``exit_frac`` and
    ``suspend_frac`` are given the cadence resolves through the tuning
    table's rows for this device; the ``ppls_tuning_resolution`` gauge
    names the tier.

    ``checkpoint_path`` snapshots the engine every ``checkpoint_every``
    phases (:meth:`snapshot`; :meth:`resume` continues it);
    ``checkpoint_background`` moves the file writes to the background
    writer (write mechanics, not identity).
    """

    def __init__(self, family: str, eps: float,
                 rule: Rule = Rule.TRAPEZOID,
                 slots: int = 64,
                 chunk: int = 1 << 13,
                 capacity: int = 1 << 20,
                 lanes: int = DEFAULT_LANES,
                 roots_per_lane: int = 12,
                 refill_slots: int = 8,
                 seg_iters: int = 2048,
                 max_segments: int = 1 << 18,
                 min_active_frac: float = 0.1,
                 exit_frac: Optional[float] = None,
                 suspend_frac: Optional[float] = None,
                 sort_roots: bool = True,
                 sort_skip_ratio: float = SORT_SKIP_RATIO,
                 f64_rounds: int = 0,
                 scout_dtype: Optional[str] = None,
                 double_buffer: bool = False,
                 reduced_integrands: bool = False,
                 theta_block: int = 1,
                 admit_window: Optional[int] = None,
                 device="cuda",
                 engine: str = "walker",
                 mesh=None, n_devices: Optional[int] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 8,
                 telemetry: Optional[Telemetry] = None,
                 quarantine: bool = False,
                 fault_injector=None,
                 queue_limit: Optional[int] = None,
                 tenant_quotas: Optional[dict] = None,
                 default_deadline_phases: Optional[int] = None,
                 on_shed=None,
                 spillover: bool = False,
                 spillover_limit: int = 4,
                 slo_config=None,
                 adapt: bool = False,
                 checkpoint_background: bool = False):
        self._world = None
        if engine not in ("walker", "walker-dd"):
            raise ValueError(f"unknown stream engine {engine!r}")
        self.device = resolve_device(device)
        if lanes % 128:
            raise ValueError(
                f"lanes must be a multiple of 128, got {lanes}")
        if refill_slots < 0 or refill_slots > roots_per_lane:
            raise ValueError(
                f"refill_slots must be in [0, roots_per_lane="
                f"{roots_per_lane}], got {refill_slots}")
        if engine == "walker-dd":
            if refill_slots <= 0:
                raise ValueError(
                    "walker-dd streaming requires refill_slots > 0 "
                    "(admission rides the refill mode's phase reshard)")
            n_dev = (int(getattr(mesh, "size", mesh)) if mesh is not None
                     else int(n_devices) if n_devices
                     else default_world(self.device))
            if n_dev < 1:
                raise ValueError(f"n_devices must be >= 1, got {n_dev}")
        elif mesh is not None or (n_devices and int(n_devices) != 1):
            raise ValueError(
                "mesh / n_devices > 1 apply to engine='walker-dd'; the "
                "walker engine runs on one card")
        else:
            n_dev = 1
        self._n_dev = n_dev
        if scout_dtype == "f32" and f64_rounds:
            raise ValueError(
                "scout_dtype='f32' is meaningless with f64_rounds > 0 "
                "(the float64 streaming mode runs no walk kernel)")
        self._scout = bool(resolve_scout_dtype(scout_dtype, Rule(rule))
                           and not f64_rounds)
        validate_double_buffer(double_buffer, refill_slots)
        self._double_buffer = bool(double_buffer)
        exit_frac, suspend_frac = resolve_cadence(
            exit_frac, suspend_frac, self._scout, refill_slots,
            signature=workload_signature(
                family, eps, Rule(rule), theta_block=int(theta_block),
                mesh_shape=n_dev, scout=self._scout,
                refill_slots=int(refill_slots)),
            device=self.device)
        tier = last_resolution()["tier"]
        self._theta_block = validate_theta_block(
            theta_block, lanes=int(lanes), refill_slots=refill_slots,
            rule=rule, m=slots)
        self.family = family
        self.f_theta = get_family(family)
        self.f_ds = get_family_ds(family, reduced=bool(reduced_integrands))
        # a family without a reduced twin walks its ds twin: not reduced
        self._reduced = _is_reduced_twin(self.f_ds)
        self.eps = float(eps)
        self.rule = Rule(rule)
        self.slots = int(slots)
        self.engine = engine
        self.lanes = int(lanes)
        target, breed_chunk, slack_chunk = walker_sizing(
            lanes, roots_per_lane, capacity, chunk, self._theta_block)
        self._store = capacity + 2 * slack_chunk
        self._capacity = int(capacity)
        self._chunk = int(chunk)
        self._roots_per_lane = int(roots_per_lane)
        self._refill_slots = int(refill_slots)
        self._syncs = HostSyncs()
        self._cycle_kw = dict(
            f_theta=self.f_theta, f_ds=self.f_ds, eps=self.eps,
            m=self.slots, seg_iters=int(seg_iters),
            max_segments=int(max_segments),
            min_active_frac=float(min_active_frac),
            exit_frac=float(exit_frac), suspend_frac=float(suspend_frac),
            lanes=self.lanes, capacity=int(capacity),
            breed_chunk=int(breed_chunk), target=int(target),
            rule=self.rule, refill_slots=int(refill_slots),
            f64_rounds=int(f64_rounds), scout=self._scout,
            double_buffer=self._double_buffer,
            theta_block=self._theta_block, sort_roots=bool(sort_roots),
            sort_skip_ratio=float(sort_skip_ratio), syncs=self._syncs)
        # admit window: the fixed seed-array width, capped by the store's
        # slack so the push always fits
        aw = slots if admit_window is None else int(admit_window)
        self._admit_window = max(1, min(aw, 2 * slack_chunk))

        # telemetry: a per-engine handle by default, so the registry's
        # totals are this run's. Every publish below consumes host values
        # the phase boundary already read.
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry()
        tel = self.telemetry
        self._stat_counters = {k: tel.stream_counter(k)
                               for k in _COUNTER_STATS}
        self._g_maxd = tel.stream_gauge(
            "max_depth", "max refinement depth seen across phases")
        self._g_queue = tel.stream_gauge(
            "queue_depth", "pending (not yet admitted) requests")
        self._g_resident = tel.stream_gauge(
            "resident", "requests holding a family slot")
        self._g_free = tel.stream_gauge("free_slots", "free family slots")
        self._g_phase = tel.stream_gauge("phase", "current phase index")
        self._g_live_tasks = tel.stream_gauge(
            "live_tasks_now", "live bag rows after the last phase")
        self._c_admitted = tel.registry.counter(
            "ppls_stream_admitted_total", "requests admitted to slots")
        self._c_retired = tel.registry.counter(
            "ppls_stream_retired_total", "requests retired with areas")
        self._h_lat_phases = tel.latency_phases_histogram()
        self._h_lat_seconds = tel.latency_seconds_histogram()
        self._g_lat = {
            (q, unit): tel.stream_gauge(
                f"retire_latency_{unit}_p{int(q * 100)}",
                f"rolling p{int(q * 100)} retire latency ({unit}; "
                f"bucket-edge quantile)")
            for q in (0.5, 0.99) for unit in ("phases", "seconds")}
        self._g_tuning = tel.registry.gauge(
            "ppls_tuning_resolution",
            "cadence resolution tier for this engine (1 = the tier "
            "that resolved)", ("tier",))
        self._g_tuning.labels(tier=tier).set(1.0)

        # admission control, load shedding and deadlines: host policy
        self.queue_limit = (None if queue_limit is None
                            else int(queue_limit))
        if self.queue_limit is not None and self.queue_limit < 1:
            raise ValueError(
                f"queue_limit must be >= 1, got {queue_limit}")
        self.tenant_quotas = None
        if tenant_quotas:
            self.tenant_quotas = {}
            for name, q in tenant_quotas.items():
                rate = float(q.get("rate", 1.0))
                burst = float(q.get("burst", max(rate, 1.0)))
                if rate <= 0 or burst < 1.0:
                    # rate 0 would starve the tenant forever and the
                    # drain would never end: refusal is the queue
                    # bound's job
                    raise ValueError(
                        f"tenant quota {name!r}: rate must be > 0 "
                        f"and burst >= 1, got rate={rate} "
                        f"burst={burst}")
                self.tenant_quotas[str(name)] = {"rate": rate,
                                                 "burst": burst}
        self.default_deadline_phases = (
            None if default_deadline_phases is None
            else int(default_deadline_phases))
        if self.default_deadline_phases is not None \
                and self.default_deadline_phases < 1:
            raise ValueError(
                f"default_deadline_phases must be >= 1, got "
                f"{default_deadline_phases}")
        self.on_shed = on_shed
        self.shed: List[ShedRecord] = []
        self._tokens: dict = {}
        # CPU spillover: queue-overflow victims without a deadline run as
        # float64 bag rounds on the host CPU instead of being shed. Host
        # boundary policy, off the snapshot identity; the spill queue
        # rides every snapshot. The queue is bounded: beyond ~8 phases of
        # backlog a victim sheds ("spill_queue_full")
        self.spillover_limit = int(spillover_limit)
        self._spill_cap = 8 * max(self.spillover_limit, 1)
        self._spill = None
        if spillover:
            from ppls_tpu_torch.backends.spillover import SpilloverExecutor
            self._spill = SpilloverExecutor(
                family, self.eps, rule=self.rule, chunk=int(chunk),
                capacity=int(capacity), telemetry=tel)
        self._spill_queue: List[StreamRequest] = []
        self._c_spillover = tel.registry.counter(
            "ppls_stream_spillover_total",
            "requests completed on the CPU spillover backend "
            "instead of being shed")
        # online adaptation of the host knobs: the admission budget starts
        # at half the admit window and opens toward it under backlog with
        # underfed lanes; the spillover batch limit grows under spill
        # backlog; both decay back when the pressure clears
        self._adapt = None
        self._g_adapt = {}
        if adapt:
            defaults = {
                "admit_budget": max(1, self._admit_window // 2),
                "spillover_limit": self.spillover_limit,
            }
            bands = {
                "admit_budget": (1, self._admit_window),
                "spillover_limit": (1, max(1, self._spill_cap // 2)),
            }
            self._adapt = OnlineAdapter(defaults, bands)
            self._g_adapt = {
                k: tel.stream_gauge(
                    f"adapt_{k}", f"online-adapted value of the {k} knob")
                for k in sorted(defaults)}
            for k, g in self._g_adapt.items():
                g.set(float(self._adapt.values[k]))

        # host bookkeeping
        self._pending: List[StreamRequest] = []
        self._free = list(range(self.slots))
        self._slot_req = {}          # slot -> StreamRequest
        self._records = {}           # rid -> dict(slot, admit_phase)
        self.completed: List[CompletedRequest] = []
        self._next_rid = 0
        self.phase = 0
        self._count = 0              # live bag rows after the last phase
        self._phase_rows: List[np.ndarray] = []
        self._phase_syncs: List[int] = []
        self._fam_first = np.full(self.slots, -1, dtype=np.int32)
        self._last_fam_live = np.zeros(self.slots, dtype=np.int32)
        self._last_fam_last = np.full(self.slots, -1, dtype=np.int32)

        # device state, built on the first admission so the dead-slot
        # fill is an in-domain point of a real request
        self._dev = None
        self._fill = None            # (fill_x, fill_th)
        self._theta_dev = None       # (slots, T) f64 theta table (T > 1)

        # a non-finite area retires as a FAILED record with quarantine on;
        # off (the default), it raises
        self.quarantine = bool(quarantine)
        self.fault_injector = fault_injector
        self._c_quarantined = tel.registry.counter(
            "ppls_stream_quarantined_total",
            "requests retired as failed through the NaN quarantine")
        self._c_shed = tel.shed_counter()
        self._c_deadline = tel.registry.counter(
            "ppls_stream_deadline_exceeded_total",
            "in-flight requests retired failed at their phase "
            "deadline", ("tenant",))
        self._c_tenant_retired = tel.registry.counter(
            "ppls_stream_tenant_retired_total",
            "requests retired, by tenant", ("tenant",))
        self._h_class_lat = tel.class_latency_histogram()
        self._h_tenant_lat = tel.tenant_latency_histogram()
        # SLO burn-rate evaluation over the registry the phase close
        # publishes
        self._slo = None
        if slo_config is not None:
            from ppls_tpu_torch.obs.slo import SloEvaluator
            self._slo = SloEvaluator(slo_config, tel)
        # per-rid request spans (open at submit, closed at retire/shed)
        self._rid_spans: dict = {}
        self._token_waits: dict = {}

        # snapshots: every checkpoint_every phases at the phase close;
        # client_state is the caller's JSON-serialisable scratch record
        # (a serve loop's cursors), carried by every snapshot
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.checkpoint_background = bool(checkpoint_background)
        self.client_state: dict = {}

    # ------------------------------------------------------------------
    # identity
    # ------------------------------------------------------------------

    def _identity(self) -> dict:
        ident = _stream_identity(
            f"{self.engine}-stream", self.family, self.eps, self.rule,
            self.slots, self.lanes, self._chunk, self._capacity,
            self._roots_per_lane, self._refill_slots, self._n_dev)
        if self._scout:
            ident["scout"] = True
        if self._double_buffer:
            ident["double_buffer"] = True
        if self._reduced:
            ident["reduced"] = True
        if self._theta_block > 1:
            ident["theta_block"] = int(self._theta_block)
        # online adaptation changes the admission and spillover schedule
        if self._adapt is not None:
            ident["adapt"] = True
        return ident

    def snapshot(self):
        """Atomically write the queue, the slots, the records and the
        device state to ``checkpoint_path``: the live bag prefix, the
        ``(acc, acc_c)`` pair and ``fam_last`` (one device read), and the
        host bookkeeping under the reference's keys (the spill queue and
        the spillover totals among them), so the reference's ``resume``
        reads it too."""
        if not self.checkpoint_path:
            raise ValueError("no checkpoint_path configured")
        m_eff = self.slots * self._theta_block
        extra = {}
        if self._dev is None:
            bag_cols, count = {}, 0
            acc_pair = np.zeros((2, m_eff))
            fam_last = [-1] * self.slots
        elif self.engine == "walker-dd":
            bag_cols, count, acc_pair, fam_last, extra = \
                self._snapshot_dd_state()
        else:
            d = self._dev
            count = d["bag"].count
            bag_cols, (acc, acc_c, fl) = _pull_prefix(
                d["bag"], self._syncs, d["acc"], d["acc_c"], d["fam_last"])
            acc_pair = np.stack([acc, acc_c])
            fam_last = fl.tolist()
        totals = {
            "phase": self.phase,
            "next_rid": self._next_rid,
            "fill": self._fill,
            "fam_first": self._fam_first.tolist(),
            "fam_last": fam_last,
            "phase_rows": [r.tolist() for r in self._phase_rows],
            "pending": [dataclasses.asdict(r) for r in self._pending],
            "resident": {
                str(slot): dict(dataclasses.asdict(req),
                                **self._records[req.rid])
                for slot, req in self._slot_req.items()},
            "completed": [dataclasses.asdict(c) for c in self.completed],
            "shed": [dataclasses.asdict(s) for s in self.shed],
            "spill_queue": [dataclasses.asdict(r)
                            for r in self._spill_queue],
            "spill_requests_total": int(
                self._spill.requests_total if self._spill else 0),
            "spill_tasks_total": int(
                self._spill.tasks_total if self._spill else 0),
            "tokens": dict(self._tokens),
            "token_waits": {str(k): int(v)
                            for k, v in self._token_waits.items()},
            "client_state": dict(self.client_state),
        }
        if self._adapt is not None:
            # the adapted values and pressure streaks: the resumed
            # boundary continues the same trajectory mid-hysteresis
            totals["adapt"] = self._adapt.state()
        if self._theta_block > 1 and self._fill is not None:
            totals["theta_table"] = self._theta_table.tolist()
        totals.update(extra)
        writer = (background_writer() if self.checkpoint_background
                  else None)
        save_family_checkpoint(
            self.checkpoint_path, identity=self._identity(),
            bag_cols=bag_cols, count=count, acc=acc_pair, totals=totals,
            writer=writer)
        self.telemetry.event(
            "checkpoint", phase=self.phase, count=count,
            pending=len(self._pending), resident=len(self._slot_req),
            completed=len(self.completed))
        if self.fault_injector is not None:
            # checkpoint-write fault boundary: ckpt_truncate/ckpt_corrupt
            # damage the file just renamed into place, so a background
            # write lands first
            if writer is not None:
                writer.flush()
            self.fault_injector.on_checkpoint_write(self.checkpoint_path)

    def _snapshot_dd_state(self):
        """Every rank's device state for a snapshot, gathered in rank
        order: live bag prefixes ((n, b) columns and the (n,) counts, as
        the batch dd engine's leg snapshot), the (n, slots * T) partial
        areas, the cumulative counters, and the host delta trackers the
        phase loop needs to keep producing exact deltas after a
        resume."""
        st = self._world.call("snapshot_rows")
        bag_cols = dict(st["cols"], counts=st["counts"])
        extra = {"dd": {
            "ctr": [np.asarray(v).tolist() for v in st["ctr"]],
            "waste": np.asarray(st["waste"]).tolist(),
            "evals": np.asarray(st["evals"]).tolist(),
            "maxd": np.asarray(st["maxd"]).tolist(),
            "ovf": np.asarray(st["ovf"]).tolist(),
            "prev": self._dd_prev.tolist(),
            "prev_waste": self._dd_prev_waste.tolist(),
            "prev_evals": self._dd_prev_evals.tolist(),
            "prev_acc": self._dd_prev_acc.tolist(),
            "prev_chip": {k: v.tolist()
                          for k, v in self._dd_prev_chip.items()},
            "prev_count": self._dd_prev_count.tolist(),
            "rr": self._dd_rr,
            # the straggler streaks: a resume neither forgets nor
            # re-fires a streak in progress
            "flight_streak": list(self._flight._streak),
        }}
        return (bag_cols, int(np.sum(st["counts"])), np.asarray(st["acc"]),
                self._dd_fam_last.tolist(), extra)

    @classmethod
    def resume(cls, checkpoint_path: str, family: str, eps: float,
               mesh_resize: bool = False, **kwargs) -> "StreamEngine":
        """Rebuild an engine from its last snapshot, on the device of
        ``kwargs`` (CUDA by default). The configuration must match the
        snapshotted run's (identity-checked); the continued stream
        replays the identical phases. ``mesh_resize=True`` is the
        reference's elastic rule (a no-op at equal mesh sizes): a
        walker-dd snapshot of another world size resumes on this
        engine's ranks, its queues re-dealt depth-stratified
        (``mesh.host_strided_redeal``) and its counters resharded
        sum-preserving. A snapshot with a non-empty spill queue is
        refused unless ``spillover=True``, one with online-adaptation
        state unless ``adapt=True``. The SLO evaluator's windows re-base
        at the resumed phase."""
        eng = cls(family, eps, checkpoint_path=checkpoint_path, **kwargs)
        try:
            eng._resume_from(checkpoint_path, mesh_resize)
        except BaseException:
            eng.close()
            raise
        return eng

    def _resume_from(self, checkpoint_path: str, mesh_resize: bool) -> None:
        eng = self
        bag_cols, count, acc_pair, totals = load_family_checkpoint(
            checkpoint_path, eng._identity(), mesh_resize=mesh_resize)
        eng.phase = int(totals["phase"])
        eng._next_rid = int(totals["next_rid"])
        eng._fam_first = np.asarray(totals["fam_first"], dtype=np.int32)
        eng._last_fam_last = np.asarray(totals["fam_last"], dtype=np.int32)

        def _pad_row(r):
            # rows of snapshots older than a tail column pad with zeros
            row = np.asarray(r, dtype=np.int64)
            return np.concatenate([row, np.zeros(
                len(STREAM_STAT_FIELDS) - row.shape[0], np.int64)])

        eng._phase_rows = [_pad_row(r) for r in totals["phase_rows"]]

        def _theta_in(v):
            # JSON carries theta batches as lists
            return tuple(v) if isinstance(v, list) else v

        def _req_in(d):
            return StreamRequest(
                rid=d["rid"], theta=_theta_in(d["theta"]),
                bounds=tuple(d["bounds"]),
                submit_phase=d["submit_phase"],
                submit_t=time.perf_counter(),
                tenant=d.get("tenant", "default"),
                priority=int(d.get("priority", 1)),
                deadline_phases=d.get("deadline_phases"))

        def _record_in(kind, d):
            return kind(**{k: (tuple(v) if k == "bounds"
                               else _theta_in(v) if k == "theta" else v)
                           for k, v in d.items()})

        eng._pending = [_req_in(d) for d in totals["pending"]]
        eng._spill_queue = [_req_in(d)
                            for d in totals.get("spill_queue", [])]
        if eng._spill_queue and eng._spill is None:
            # without the backend the spill queue never drains: refuse
            # rather than strand acknowledged requests
            raise ValueError(
                f"snapshot carries {len(eng._spill_queue)} "
                f"spillover-queued request(s) but spillover is not "
                f"armed on this resume; pass spillover=True")
        if eng._spill is not None:
            # the pre-crash engagement totals, and their registry
            # counters, so the exposition matches them
            eng._spill.requests_total = int(
                totals.get("spill_requests_total", 0))
            eng._spill.tasks_total = int(
                totals.get("spill_tasks_total", 0))
            if eng._spill.requests_total:
                eng._spill._c_req.inc(eng._spill.requests_total)
            if eng._spill.tasks_total:
                eng._spill._c_tasks.inc(eng._spill.tasks_total)
        eng.completed = [_record_in(CompletedRequest, d)
                         for d in totals["completed"]]
        eng.shed = [_record_in(ShedRecord, d)
                    for d in totals.get("shed", [])]
        eng._tokens = {str(k): float(v)
                       for k, v in totals.get("tokens", {}).items()}
        eng._token_waits = {int(k): int(v) for k, v in
                            totals.get("token_waits", {}).items()}
        eng.client_state = dict(totals.get("client_state", {}))
        adapt_state = totals.get("adapt")
        if adapt_state is not None:
            if eng._adapt is None:
                # the adapt key of the identity refuses this first; a
                # hand-edited snapshot must not replay un-adapted either
                raise ValueError(
                    "snapshot carries online-adaptation state but adapt "
                    "is not armed on this resume; pass adapt=True")
            eng._adapt.restore(adapt_state)
            for k, g in eng._g_adapt.items():
                g.set(float(eng._adapt.values[k]))
        for slot_s, d in totals["resident"].items():
            slot = int(slot_s)
            req = _req_in(d)
            eng._slot_req[slot] = req
            eng._records[req.rid] = dict(slot=slot,
                                         admit_phase=d["admit_phase"])
            eng._free.remove(slot)
        eng._count = int(count)
        if totals["fill"] is not None:
            eng._fill = tuple(totals["fill"])
            eng._theta_table = (
                np.asarray(totals["theta_table"], dtype=np.float64)
                if "theta_table" in totals else
                np.full((eng.slots, eng._theta_block), eng._fill[1],
                        dtype=np.float64))
            eng._build_store()
            if eng.engine == "walker-dd":
                eng._restore_device_dd(bag_cols, totals,
                                       np.asarray(acc_pair))
            else:
                eng._restore_device(bag_cols, count, acc_pair,
                                    totals["fam_last"])
        eng._replay_registry()
        if eng._slo is not None:
            # the burn windows re-base at the resume point: the replayed
            # cumulative counters must not read as one window
            eng._slo.seed_base(eng.phase)
        # the live rids reopen their request spans
        for req in list(eng._pending) + list(eng._slot_req.values()):
            eng._rid_spans[req.rid] = eng.telemetry.request_span(
                req.rid, tenant=req.tenant, priority=req.priority,
                submit_phase=req.submit_phase)
        eng.telemetry.event(
            "resume", phase=eng.phase, count=eng._count,
            pending=len(eng._pending), resident=len(eng._slot_req),
            completed=len(eng.completed))

    def _restore_device(self, bag_cols, count, acc_pair, fam_last):
        """Overlay the snapshot's live prefix on the fresh store and
        restore the accumulator pair and the last-credit marks."""
        dev, f64 = self.device, torch.float64
        m_eff = self.slots * self._theta_block
        d = self._dev
        bag = _restore_bag(d["bag"], bag_cols, count, np.zeros(m_eff),
                           {"tasks": 0, "splits": 0, "iters": 0,
                            "max_depth": 0})
        acc_pair = np.asarray(acc_pair, dtype=np.float64)
        self._dev = dict(
            bag=bag,
            acc=torch.tensor(acc_pair[0], dtype=f64, device=dev),
            acc_c=torch.tensor(acc_pair[1], dtype=f64, device=dev),
            fam_last=torch.tensor(fam_last, dtype=torch.int32, device=dev))
        if self._theta_block > 1:
            self._theta_dev = torch.as_tensor(self._theta_table, dtype=f64,
                                              device=dev)

    def _restore_device_dd(self, bag_cols, totals, acc):
        """Rebuild every rank's store around its saved live prefix and
        restore the cumulative counters and the host delta trackers, so
        the continued stream's phase rows and flight-recorder deltas
        equal the undisturbed run's. A snapshot of another world size
        (``mesh_resize``) is re-dealt first."""
        n_dev = self._n_dev
        dd = totals["dd"]
        counts = np.asarray(bag_cols.get("counts", np.zeros(n_dev)),
                            dtype=np.int32)
        n_old = counts.shape[0]
        if n_old != n_dev:
            bag_cols, counts, acc, dd = self._resize_dd_snapshot(
                bag_cols, counts, acc, dd, n_old)
        m_eff = self.slots * self._theta_block
        w_in = np.asarray(dd["waste"], dtype=np.int64).reshape(n_dev, -1)
        waste = np.zeros((n_dev, N_WASTE), dtype=np.int64)
        waste[:, :w_in.shape[1]] = w_in       # snapshots with 4 buckets
        empty = np.zeros((n_dev, 0))
        st = dict(
            cols={k: (np.asarray(bag_cols[k]) if "l" in bag_cols
                      else empty) for k in ("l", "r", "th", "meta")},
            counts=counts,
            acc=np.asarray(acc, dtype=np.float64).reshape(n_dev, m_eff),
            ctr=[np.asarray(v, dtype=np.int64) for v in dd["ctr"]],
            waste=waste,
            evals=np.asarray(dd.get("evals", np.zeros((n_dev, 2))),
                             dtype=np.int64).reshape(n_dev, 2),
            maxd=np.asarray(dd["maxd"], dtype=np.int64),
            ovf=np.asarray(dd["ovf"], dtype=bool))
        self._world.call("restore", st)
        self._dd_prev = np.asarray(dd["prev"], dtype=np.int64)
        pw = np.asarray(dd["prev_waste"], dtype=np.int64)
        self._dd_prev_waste = np.concatenate(
            [pw, np.zeros(N_WASTE - pw.shape[0], np.int64)])
        self._dd_prev_evals = np.asarray(dd.get("prev_evals", np.zeros(2)),
                                         dtype=np.int64)
        self._dd_prev_acc = np.asarray(dd["prev_acc"], dtype=np.float64)
        self._dd_prev_chip = {k: np.asarray(v, dtype=np.int64)
                              for k, v in dd["prev_chip"].items()}
        pcw = self._dd_prev_chip["waste"].reshape(n_dev, -1)
        if pcw.shape[1] < N_WASTE:
            pad = np.zeros((n_dev, N_WASTE), dtype=np.int64)
            pad[:, :pcw.shape[1]] = pcw
            self._dd_prev_chip["waste"] = pad
        self._dd_prev_count = np.asarray(dd["prev_count"], dtype=np.int64)
        self._dd_fam_last = np.asarray(totals["fam_last"], dtype=np.int32)
        self._dd_rr = int(dd["rr"])
        if "flight_streak" in dd:
            self._flight._streak = [int(v) for v in dd["flight_streak"]]

    def _resize_dd_snapshot(self, bag_cols, counts, acc, dd, n_old: int):
        """Re-target an ``n_old``-rank snapshot at this engine's world
        (elastic resume): the queues re-dealt depth-stratified (the key
        the phase reshard deals by), the counters resharded
        sum-preserving (the replicated ones, crounds and maxd, take
        their maximum), and the host delta trackers rebuilt from the new
        layout so the first phase after the resize reports exact deltas.
        The straggler streaks reset: per-rank history does not carry
        across a change of world size."""
        n_dev, store = self._n_dev, self._dd_store
        fill_x, fill_th = self._fill
        m_eff = self.slots * self._theta_block
        if "l" in bag_cols:
            cols = {k: np.asarray(bag_cols[k])
                    for k in ("l", "r", "th", "meta")}
            dealt, counts = host_strided_redeal(
                cols, counts, n_dev,
                fills={"l": fill_x, "r": fill_x, "th": fill_th, "meta": 0},
                sort_key=np.asarray(bag_cols["meta"]) & DEPTH_MASK)
            b_new = dealt["l"].shape[1]
            if b_new > store or int(counts.max(initial=0)) > store:
                raise ValueError(
                    f"mesh-resize resume: the re-dealt per-chip queue "
                    f"({b_new} rows) does not fit the {store}-row store "
                    f"of the {n_dev}-chip engine; raise capacity (or "
                    f"resume onto more chips)")
            bag_cols = dict(dealt, counts=counts)
        else:
            counts = np.zeros(n_dev, np.int32)

        def place_sum(vec, dtype):
            v = np.asarray(vec, dtype=dtype).reshape(n_old, -1)
            res = np.zeros((n_dev, v.shape[1]), dtype=dtype)
            res[0] = v.sum(axis=0)
            return res

        ctr_new = [np.full(n_dev, np.asarray(v, np.int64).max(initial=0),
                           np.int64) if k in _CTR64_MAX
                   else place_sum(v, np.int64)[:, 0]
                   for k, v in zip(CTR64, dd["ctr"])]
        waste_new = place_sum(dd["waste"], np.int64)
        evals_new = place_sum(dd.get("evals", np.zeros((n_old, 2))),
                              np.int64)
        acc = np.asarray(acc, np.float64).reshape(n_old, m_eff)
        acc_new = np.zeros((n_dev, m_eff), np.float64)
        # re-associating the cross-rank sum: exact (dyadic) workloads
        # stay bit-identical, ds workloads move within the walker's
        # contract
        acc_new[0] = acc.sum(axis=0)
        idx = {k: i for i, k in enumerate(CTR64)}
        dd = dict(
            dd, ctr=[c.tolist() for c in ctr_new],
            waste=waste_new.tolist(), evals=evals_new.tolist(),
            maxd=np.full(n_dev, np.asarray(dd["maxd"], np.int32)
                         .max(initial=0), np.int32).tolist(),
            ovf=np.full(n_dev, bool(np.any(np.asarray(dd["ovf"]))),
                        dtype=bool).tolist(),
            # the stored trackers describe the old world: crounds' rank
            # sum changes with the rank count though its value did not
            prev=[int(c.sum()) for c in ctr_new],
            prev_waste=waste_new.sum(axis=0).tolist(),
            prev_evals=evals_new.sum(axis=0).tolist(),
            prev_acc=acc_new.sum(axis=0).tolist(),
            prev_chip={
                "wsteps": ctr_new[idx["wsteps"]].tolist(),
                "tasks": ctr_new[idx["tasks"]].tolist(),
                "crounds": ctr_new[idx["crounds"]].tolist(),
                "waste": waste_new.tolist()},
            prev_count=counts.astype(np.int64).tolist(),
            flight_streak=[0] * n_dev)
        self.telemetry.event("mesh_resize", n_old=n_old, n_new=n_dev,
                             rows=int(counts.sum()))
        return bag_cols, counts, acc_new, dd

    def close(self) -> None:
        """Stop the walker-dd stream's ranks (idempotent; a no-op on the
        walker engine). The engine takes no further phase."""
        if self._world is not None:
            self._world.close()

    def __enter__(self) -> "StreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _replay_registry(self) -> None:
        """Rebuild the registry from the restored record (the
        device-counted phase rows, the completed and shed records), so a
        resumed run's registry totals and latency quantiles in phases
        equal the uninterrupted run's."""
        for row in self._phase_rows:
            self._publish_phase_row(np.asarray(row, dtype=np.int64))
        # spillover completions never held a slot
        n_admitted = sum(1 for c in self.completed if not c.spillover) \
            + len(self._slot_req)
        if n_admitted:
            self._c_admitted.inc(n_admitted)
        for c in self.completed:
            self._c_retired.inc()
            self._c_tenant_retired.labels(tenant=c.tenant).inc()
            if c.spillover:
                self._c_spillover.inc()
            if c.failed:
                if c.failure == "deadline_exceeded":
                    self._c_deadline.labels(tenant=c.tenant).inc()
                else:
                    self._c_quarantined.inc()
            self._h_lat_phases.observe(c.latency_phases)
            self._h_lat_seconds.observe(c.latency_s)
            self._h_class_lat.labels(priority=str(c.priority)) \
                .observe(c.latency_phases)
            self._h_tenant_lat.labels(tenant=c.tenant) \
                .observe(c.latency_phases)
        for s in self.shed:
            self._c_shed.labels(tenant=s.tenant, reason=s.reason).inc()
        self._publish_gauges()

    def clear_snapshot(self) -> None:
        """Delete this engine's snapshot (after any queued write)."""
        if self.checkpoint_background:
            flush_background_writer()
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            os.unlink(self.checkpoint_path)

    def _maybe_snapshot(self) -> None:
        """The phase close's snapshot, every ``checkpoint_every`` phases."""
        if self.checkpoint_path and \
                self.phase % self.checkpoint_every == 0:
            self.snapshot()

    def _phase_closed(self) -> None:
        """The phase-close fault boundary, after the snapshot (a close-keyed
        crash resumes from this phase's state), keyed on the phase that
        just closed."""
        if self.fault_injector is not None:
            self.fault_injector.on_phase_close(self.phase - 1,
                                               n_dev=self._n_dev)

    def slo_health(self) -> dict:
        """The ``/health`` verdict: the SLO evaluator's burning set, or
        a green default when no SLO config is armed."""
        if self._slo is None:
            return {"ok": True, "burning": [], "phase": self.phase}
        return self._slo.health()

    def spillover_summary(self) -> dict:
        """The serve summary's spillover block: the completed records
        that ran on the CPU spillover backend, and its task total."""
        done = [c for c in self.completed if c.spillover]
        total = len(self.completed)
        tasks = self._spill.tasks_total if self._spill is not None else 0
        return {
            "spillover_completed": len(done),
            "spillover_fraction": (len(done) / total if total else 0.0),
            "spillover_tasks": int(tasks),
        }

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------

    def submit(self, theta, bounds, tenant: str = "default",
               priority: int = 1,
               deadline_phases: Optional[int] = None) -> int:
        """Queue one request; returns its request id.

        On a ``theta_block`` = T > 1 engine ``theta`` may be a sequence
        of up to T thetas (a theta batch, retiring with per-theta
        ``areas``). A malformed submission (ds domain, oversized batch,
        bad tenant or deadline) raises ``ValueError`` before a rid is
        consumed. Under a full ``queue_limit`` the shed policy refuses
        the lowest-priority oldest queued request, or this one when it
        does not strictly outrank that one (see ``self.shed``)."""
        bounds = (float(bounds[0]), float(bounds[1]))
        if isinstance(theta, (tuple, list, np.ndarray)):
            thetas = tuple(float(t) for t in np.asarray(theta).reshape(-1))
            if not thetas:
                raise ValueError("empty theta batch")
            if len(thetas) > self._theta_block:
                raise ValueError(
                    f"theta batch of {len(thetas)} exceeds this "
                    f"engine's theta_block={self._theta_block}")
            theta_store = thetas if self._theta_block > 1 \
                else thetas[0]
        else:
            thetas = (float(theta),)
            theta_store = float(theta)
        check_ds_domain(self.f_ds,
                        np.tile(np.array([bounds]), (len(thetas), 1)),
                        np.array(thetas))
        tenant = str(tenant)
        if not tenant or len(tenant) > 128:
            raise ValueError(
                f"tenant must be a non-empty string of <= 128 chars, "
                f"got {tenant!r}")
        priority = int(priority)
        if deadline_phases is None:
            deadline_phases = self.default_deadline_phases
        if deadline_phases is not None:
            deadline_phases = int(deadline_phases)
            if deadline_phases < 1:
                raise ValueError(
                    f"deadline_phases must be >= 1, got "
                    f"{deadline_phases}")
        rid = self._next_rid
        self._next_rid += 1
        req = StreamRequest(
            rid=rid, theta=theta_store, bounds=bounds,
            submit_phase=self.phase, submit_t=time.perf_counter(),
            tenant=tenant, priority=priority,
            deadline_phases=deadline_phases)
        self._rid_spans[rid] = self.telemetry.request_span(
            rid, tenant=tenant, priority=priority,
            submit_phase=req.submit_phase)
        if self.queue_limit is not None \
                and len(self._pending) >= self.queue_limit:
            # the victim is the lowest-priority OLDEST queued request;
            # the arrival must strictly outrank it to displace it
            victim = min(self._pending,
                         key=lambda r: (r.priority, r.rid))
            if victim.priority < req.priority:
                self._pending.remove(victim)
                self._shed_or_spill(victim)
            else:
                self._shed_or_spill(req)
                return rid
        self._pending.append(req)
        return rid

    def _shed_or_spill(self, req: StreamRequest) -> None:
        """Queue-overflow policy: a victim without a deadline goes to the
        CPU spillover queue when spillover is armed and the queue has
        room (slower capacity cannot bound a deadline); otherwise it
        sheds with its record."""
        spillable = self._spill is not None and req.deadline_phases is None
        if spillable and len(self._spill_queue) < self._spill_cap:
            self._spill_queue.append(req)
            self.telemetry.request_event(
                self._rid_spans.get(req.rid), "spillover_enqueued",
                rid=req.rid, tenant=req.tenant, phase=self.phase,
                submit_phase=req.submit_phase)
            return
        self._shed(req, "spill_queue_full" if spillable else "queue_full")

    def _quota_for(self, tenant: str) -> Optional[dict]:
        if self.tenant_quotas is None:
            return None
        return self.tenant_quotas.get(tenant,
                                      self.tenant_quotas.get("*"))

    def _shed(self, req: StreamRequest, reason: str) -> ShedRecord:
        rec = ShedRecord(
            rid=req.rid, theta=req.theta, bounds=req.bounds,
            tenant=req.tenant, priority=req.priority, reason=reason,
            phase=self.phase, submit_phase=req.submit_phase)
        self.shed.append(rec)
        self._c_shed.labels(tenant=req.tenant, reason=reason).inc()
        self._token_waits.pop(req.rid, None)
        span = self._rid_spans.pop(req.rid, None)
        self.telemetry.request_event(
            span, "request_shed", rid=req.rid, tenant=req.tenant,
            priority=req.priority, reason=reason, phase=self.phase,
            submit_phase=req.submit_phase)
        if span is not None:
            span.close(disposition="shed", reason=reason,
                       phase=self.phase)
        if self.on_shed is not None:
            self.on_shed(rec)
        return rec

    @property
    def next_rid(self) -> int:
        """Request ids follow the submission order."""
        return self._next_rid

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def resident(self) -> int:
        return len(self._slot_req)

    @property
    def free_capacity(self) -> int:
        """Slot headroom not already spoken for by queued admissions:
        the pool dispatcher's routing gate (``runtime/dispatch.py``)
        deals a request here only when a seat is, or will next phase
        be, free."""
        return max(0, self.slots - self.resident - self.pending)

    @property
    def idle(self) -> bool:
        """Nothing queued, resident, live on the device or waiting for
        the spillover backend."""
        return not self._pending and not self._slot_req \
            and self._count == 0 and not self._spill_queue

    # ------------------------------------------------------------------
    # device state
    # ------------------------------------------------------------------

    def _ensure_state(self, first: StreamRequest):
        if self._dev is not None:
            return
        fill_x = 0.5 * (first.bounds[0] + first.bounds[1])
        fill_th = float(first.thetas[0])
        self._fill = (float(fill_x), fill_th)
        # per-slot theta rows: admissions overwrite theirs, the others
        # keep the in-domain fill theta
        self._theta_table = np.full(
            (self.slots, self._theta_block), fill_th, dtype=np.float64)
        self._build_store()

    def _build_dd_store(self):
        """The walker-dd stream's world: ``n_devices`` ranks, each holding
        its store and the phase program (``build_dd_walker_run`` with one
        cycle per call and the admit window per rank), spawned here
        once; plus rank 0's host trackers (the previous phase's totals,
        per-rank counters and live rows, so each phase row and chip span
        carries deltas) and the flight recorder."""
        n_dev = self._n_dev
        ck = self._cycle_kw
        _tl, _bc, store, _rw = _dd_sizing(self.lanes, self._capacity,
                                          self._chunk, self._roots_per_lane)
        slack = store - self._capacity
        aw = max(1, min(-(-self._admit_window // n_dev), slack))
        self._dd_aw = aw
        self._admit_window = min(self._admit_window, aw * n_dev)
        self._dd_store = store
        cfg = dict(
            family=self.family, eps=self.eps, rule=self.rule.value,
            slots=self.slots, lanes=self.lanes, capacity=self._capacity,
            chunk=self._chunk, roots_per_lane=self._roots_per_lane,
            refill_slots=self._refill_slots,
            **{k: ck[k] for k in ("seg_iters", "max_segments",
                                  "min_active_frac", "exit_frac",
                                  "suspend_frac", "sort_roots",
                                  "sort_skip_ratio")},
            scout=self._scout, double_buffer=self._double_buffer,
            reduced=self._reduced, theta_block=self._theta_block,
            fill=tuple(self._fill), admit_window=aw)
        self._world = World(n_dev, self.device, DDStreamRank, (cfg,),
                            syncs=self._syncs)
        m_eff = self.slots * self._theta_block
        self._dd_layout = dd_row_layout(self.slots, m_eff)
        self._dd_prev = np.zeros(len(CTR64), dtype=np.int64)
        self._dd_prev_waste = np.zeros(N_WASTE, dtype=np.int64)
        self._dd_prev_evals = np.zeros(2, dtype=np.int64)
        self._dd_prev_acc = np.zeros(m_eff)
        self._dd_fam_last = np.full(self.slots, -1, np.int32)
        self._dd_rr = 0
        self._dd_admit = None
        self._dd_prev_chip = {
            "wsteps": np.zeros(n_dev, np.int64),
            "tasks": np.zeros(n_dev, np.int64),
            "crounds": np.zeros(n_dev, np.int64),
            "waste": np.zeros((n_dev, N_WASTE), np.int64),
        }
        self._dd_prev_count = np.zeros(n_dev, np.int64)
        self._dd_mesh_rows = None
        self._flight = ChipFlightRecorder(
            self.telemetry, n_dev, engine=f"{self.engine}-stream")
        self._dev = True            # the state is built

    def _build_store(self):
        fill_x, fill_th = self._fill
        if self.engine == "walker-dd":
            self._build_dd_store()
            return
        dev, f64 = self.device, torch.float64
        store = self._store
        m_eff = self.slots * self._theta_block
        bag = BagState(
            bag_l=torch.full((store,), fill_x, dtype=f64, device=dev),
            bag_r=torch.full((store,), fill_x, dtype=f64, device=dev),
            bag_th=torch.full((store,), fill_th, dtype=f64, device=dev),
            bag_meta=torch.zeros(store, dtype=torch.int32, device=dev),
            count=0, acc=torch.zeros(m_eff, dtype=f64, device=dev),
            max_depth=torch.zeros((), dtype=torch.int32, device=dev))
        self._dev = dict(
            bag=bag,
            acc=torch.zeros(m_eff, dtype=f64, device=dev),
            acc_c=torch.zeros(m_eff, dtype=f64, device=dev),
            fam_last=torch.full((self.slots,), -1, dtype=torch.int32,
                                device=dev))

    # ------------------------------------------------------------------
    # the phase loop
    # ------------------------------------------------------------------

    def _refill_tokens(self) -> None:
        """Phase-open token-bucket refill: rate tokens per phase up to
        burst, for every tenant seen so far."""
        if self.tenant_quotas is None:
            return
        for tenant in self._tokens:
            q = self._quota_for(tenant)
            if q is not None:
                self._tokens[tenant] = min(
                    q["burst"], self._tokens[tenant] + q["rate"])

    def _shed_unmeetable(self) -> None:
        """Shed queued requests whose deadline phase is already past."""
        victims = [r for r in self._pending
                   if r.deadline_phase is not None
                   and r.deadline_phase < self.phase]
        for req in victims:
            self._pending.remove(req)
            self._shed(req, "deadline_exceeded")

    def _select_for_admission(self) -> List[StreamRequest]:
        """This phase's admissions: budget = min(free slots, admit
        window, bag headroom), order (-priority, rid), gated by the
        tenant token buckets (an out-of-tokens tenant's requests wait in
        place). Removes the chosen requests from the queue and takes one
        token per admission."""
        # walker-dd: capacity is per rank
        room = self._capacity * self._n_dev - self._count
        budget = max(0, min(len(self._free), self._admit_window, room))
        if self._adapt is not None:
            # the online budget narrows the admit window within its band
            budget = min(budget, self._adapt.values["admit_budget"])
        if not budget or not self._pending:
            return []
        chosen: List[StreamRequest] = []
        if self.tenant_quotas is None:
            chosen = heapq.nsmallest(
                budget, self._pending,
                key=lambda r: (-r.priority, r.rid))
        else:
            for req in sorted(self._pending,
                              key=lambda r: (-r.priority, r.rid)):
                if len(chosen) >= budget:
                    break
                q = self._quota_for(req.tenant)
                if q is not None:
                    if req.tenant not in self._tokens:
                        self._tokens[req.tenant] = q["burst"]
                    if self._tokens[req.tenant] < 1.0:
                        self._token_waits[req.rid] = \
                            self._token_waits.get(req.rid, 0) + 1
                        self.telemetry.request_event(
                            self._rid_spans.get(req.rid),
                            "token_wait", rid=req.rid,
                            tenant=req.tenant, phase=self.phase)
                        continue
                    self._tokens[req.tenant] -= 1.0
                chosen.append(req)
        if chosen:
            taken = {r.rid for r in chosen}
            self._pending = [r for r in self._pending
                             if r.rid not in taken]
        return chosen

    def _admit(self) -> List[StreamRequest]:
        chosen = self._select_for_admission()
        if not chosen:
            return []
        self._ensure_state(chosen[0])
        n_new = len(chosen)
        A = self._admit_window
        fill_x, fill_th = self._fill
        sl = np.full(A, fill_x)
        sr = np.full(A, fill_x)
        sth = np.full(A, fill_th)
        sm = np.zeros(A, dtype=np.int32)
        clear = np.zeros(self.slots, dtype=bool)
        for i, req in enumerate(chosen):
            slot = self._free.pop(0)
            sl[i], sr[i] = req.bounds
            row = req.thetas
            # frontier rows carry the batch's first theta for the work
            # sort; a short batch pads the slot's theta row with it
            # (the pads vote and credit like the rest, and are dropped
            # at retirement)
            sth[i] = row[0]
            if self._theta_block > 1:
                pad = row + (row[0],) * (self._theta_block - len(row))
                self._theta_table[slot] = pad
            if self.fault_injector is not None \
                    and self.fault_injector.on_admit(req.rid):
                # nan_poison: the admitted theta turns NaN after
                # submit-time validation; the engine computes with it and
                # the slot's area goes non-finite at retirement
                sth[i] = float("nan")
                if self._theta_block > 1:
                    self._theta_table[slot] = float("nan")
            sm[i] = np.int32(slot << DEPTH_BITS)
            clear[slot] = True       # recycle: zero the slot's acc pair
            self._slot_req[slot] = req
            self._records[req.rid] = dict(slot=slot,
                                          admit_phase=self.phase)
            self._fam_first[slot] = self.phase
            self.telemetry.request_event(
                self._rid_spans.get(req.rid),
                "admit", rid=req.rid, slot=slot, phase=self.phase,
                theta=(list(row) if self._theta_block > 1
                       else req.theta),
                bounds=list(req.bounds),
                submit_phase=req.submit_phase,
                queue_wait_phases=self.phase - req.submit_phase,
                token_wait_phases=self._token_waits.pop(req.rid, 0),
                tenant=req.tenant, priority=req.priority)
        self._c_admitted.inc(n_new)
        self._apply_admit(sl, sr, sth, sm, n_new, clear)
        self._count += n_new
        return chosen

    def _apply_admit(self, sl, sr, sth, sm, n_new, clear):
        if self.engine == "walker-dd":
            # stage the ranks' blocks for the next phase: the requests
            # dealt round-robin over the ranks, each rank's block a dense
            # prefix with in-domain fill past it
            n_dev, aw = self._n_dev, self._dd_aw
            fill_x, fill_th = self._fill
            bl = np.full((n_dev, aw), fill_x)
            br = np.full((n_dev, aw), fill_x)
            bth = np.full((n_dev, aw), fill_th)
            bm = np.zeros((n_dev, aw), dtype=np.int32)
            cnt = np.zeros(n_dev, dtype=np.int32)
            for i in range(n_new):
                chip = self._dd_rr % n_dev
                self._dd_rr += 1
                k = cnt[chip]
                bl[chip, k], br[chip, k] = sl[i], sr[i]
                bth[chip, k] = sth[i]
                bm[chip, k] = sm[i]
                cnt[chip] = k + 1
            self._dd_admit = (bl, br, bth, bm, cnt, clear)
            return
        dev, f64 = self.device, torch.float64
        d = self._dev
        bag, acc, acc_c, fam_last = _admit_program(
            d["bag"], d["acc"], d["acc_c"], d["fam_last"],
            torch.as_tensor(sl, dtype=f64, device=dev),
            torch.as_tensor(sr, dtype=f64, device=dev),
            torch.as_tensor(sth, dtype=f64, device=dev),
            torch.as_tensor(sm, dtype=torch.int32, device=dev), n_new,
            torch.as_tensor(clear, dtype=torch.bool, device=dev),
            capacity=self._capacity)
        self._dev = dict(bag=bag, acc=acc, acc_c=acc_c, fam_last=fam_last)
        if self._theta_block > 1:
            self._theta_dev = torch.as_tensor(self._theta_table,
                                              dtype=f64, device=dev)

    def _cycle_launch(self):
        """Run the phase's cycle and install its carry. The returned
        token goes to :meth:`_cycle_pull` on this engine before any other
        launch."""
        if self.engine == "walker-dd":
            return self._dd_cycle_launch()
        d = self._dev
        out = run_stream_cycle(d["bag"], d["acc"], d["acc_c"],
                               d["fam_last"], self.phase, self._theta_dev,
                               **self._cycle_kw)
        self._dev = dict(bag=out.bag, acc=out.acc, acc_c=out.acc_c,
                         fam_last=out.fam_last)
        return out

    def _cycle_pull(self, out):
        """The phase's one read of its results: (fam_live, acc, acc_c,
        fam_last, count, overflow, stats) as host values."""
        if self.engine == "walker-dd":
            return self._dd_cycle_pull(out)
        return pull_stream_cycle(out, self._syncs)

    def _dd_cycle_launch(self):
        """Send the phase to every rank (the whole (n, AW) admitted block
        once; each rank takes its row) and run rank 0's cycle."""
        n_dev, aw = self._n_dev, self._dd_aw
        if self._dd_admit is None:
            # no admissions this phase: empty blocks, no clears
            fill_x, fill_th = self._fill
            self._dd_admit = (
                np.full((n_dev, aw), fill_x), np.full((n_dev, aw), fill_x),
                np.full((n_dev, aw), fill_th),
                np.zeros((n_dev, aw), np.int32), np.zeros(n_dev, np.int32),
                np.zeros(self.slots, dtype=bool))
        bl, br, bth, bm, cnt, clear = self._dd_admit
        self._dd_admit = None
        cmd = dict(block=(bl, br, bth, bm), counts=cnt, clear=clear,
                   theta=(self._theta_table if self._theta_block > 1
                          else None))
        self._world.begin("phase_all", cmd)
        self._world.run_local("phase", cmd)
        return "dd"

    def _dd_cycle_pull(self, _token):
        """Rank 0's one gather of every rank's cumulative counters, live
        counts and partial areas, folded into this phase's deltas (the
        stats row), the per-rank flight-recorder deltas, the summed
        areas (in rank order) and the last-credit marks."""
        rows = self._world.run_local("phase_rows")
        self._world.finish()
        L = self._dd_layout
        ctr_h = rows[:, L["ctr"]].astype(np.int64)
        chip = {k: ctr_h[:, j] for j, k in enumerate(CTR64)}
        chip["waste"] = rows[:, L["waste"]].astype(np.int64)
        totals = ctr_h.sum(axis=0)
        delta = totals - self._dd_prev
        self._dd_prev = totals
        waste_tot = chip["waste"].sum(axis=0)
        waste_delta = waste_tot - self._dd_prev_waste
        self._dd_prev_waste = waste_tot
        evals_tot = rows[:, L["evals"]].astype(np.int64).sum(axis=0)
        evals_delta = evals_tot - self._dd_prev_evals
        self._dd_prev_evals = evals_tot
        count_pc = rows[:, L["count"]][:, 0].astype(np.int64)
        self._chip_phase_rec = {
            "wsteps": chip["wsteps"] - self._dd_prev_chip["wsteps"],
            "tasks": chip["tasks"] - self._dd_prev_chip["tasks"],
            "waste": chip["waste"] - self._dd_prev_chip["waste"],
            "live_rows": count_pc,
            "bank_delta": count_pc - self._dd_prev_count,
            # crounds is the same on every rank: the phase's delta
            "crounds": int(chip["crounds"].max(initial=0)
                           - self._dd_prev_chip["crounds"].max(initial=0)),
        }
        self._dd_prev_chip = {k: chip[k].copy() for k in
                              ("wsteps", "tasks", "crounds", "waste")}
        self._dd_prev_count = count_pc
        self._dd_mesh_rows = rows[:, L["syncs"].start:L["k2_launches"].stop]
        acc = np.sum(rows[:, L["acc"]], axis=0)        # fixed rank order
        credited = acc != self._dd_prev_acc
        if self._theta_block > 1:
            # a slot is credited when any of its T thetas is
            credited = credited.reshape(
                self.slots, self._theta_block).any(axis=1)
        self._dd_fam_last = np.where(credited, self.phase,
                                     self._dd_fam_last).astype(np.int32)
        self._dd_prev_acc = acc
        fam_live = rows[:, L["fam_live"]].astype(np.int64).sum(axis=0)
        count = int(count_pc.sum())
        maxd = int(rows[:, L["maxd"]].max())
        # CTR64 order -> STREAM_STAT_FIELDS (splits and crounds in the
        # tail columns, then the lane-waste and eval deltas)
        stats = np.concatenate([np.array([
            delta[0], delta[2], delta[3], delta[4], delta[5], delta[6],
            delta[7], delta[8], delta[9], maxd, count,
            int(np.sum(fam_live > 0)), delta[1], delta[10]],
            dtype=np.int64), waste_delta, evals_delta])
        return (fam_live, acc, np.zeros_like(acc), self._dd_fam_last,
                count, bool(np.any(rows[:, L["overflow"]])), stats)

    def mesh_record(self) -> Optional[dict]:
        """walker-dd: the transport, and every rank's host syncs,
        collective calls by kind and K1 / K2 launches as of the last
        phase's gather (that gather excluded); None on the walker
        engine or before the first phase."""
        if self._world is None or self._dd_mesh_rows is None:
            return None
        m = self._dd_mesh_rows.astype(np.int64)
        return {"backend": self._world.backend, "world": self._n_dev,
                "host_staged": (self._world.backend == "gloo"
                                and self.device.type == "cuda"),
                "host_syncs": m[:, 0].tolist(),
                "collective_calls": {"sum": m[:, 1].tolist(),
                                     "gather": m[:, 2].tolist(),
                                     "rank": m[:, 3].tolist()},
                "launches": {"run_segment_rf": m[:, 4].tolist(),
                             "run_segment_ee": m[:, 5].tolist()}}

    def _publish_phase_row(self, row: np.ndarray) -> dict:
        """Fold one phase row into the registry."""
        vals = {k: int(v) for k, v in zip(STREAM_STAT_FIELDS, row)}
        for k, c in self._stat_counters.items():
            c.inc(vals[k])
        self._g_maxd.set_max(vals["maxd"])
        self._g_live_tasks.set(vals["live_tasks"])
        return vals

    def _publish_gauges(self) -> None:
        self._g_queue.set(len(self._pending))
        self._g_resident.set(len(self._slot_req))
        self._g_free.set(len(self._free))
        self._g_phase.set(self.phase)
        for (q, unit), g in self._g_lat.items():
            h = (self._h_lat_phases if unit == "phases"
                 else self._h_lat_seconds)
            v = h.quantile(q)
            if v is not None:
                g.set(v)

    def _account_retirement(self, c: CompletedRequest,
                            slot: int) -> None:
        """Registry and event accounting shared by every retirement
        (normal, quarantine, deadline expiry)."""
        self._c_retired.inc()
        self._c_tenant_retired.labels(tenant=c.tenant).inc()
        self._h_lat_phases.observe(c.latency_phases)
        self._h_lat_seconds.observe(c.latency_s)
        self._h_class_lat.labels(priority=str(c.priority)) \
            .observe(c.latency_phases)
        self._h_tenant_lat.labels(tenant=c.tenant) \
            .observe(c.latency_phases)
        ok = not c.failed
        span = self._rid_spans.pop(c.rid, None)
        self.telemetry.request_event(
            span, "retire", rid=c.rid, slot=slot,
            area=(c.area if ok else None),
            **({"areas": c.areas}
               if c.areas is not None and ok else {}),
            failed=c.failed,
            **({"failure": c.failure} if c.failure else {}),
            **({"spillover": True} if c.spillover else {}),
            submit_phase=c.submit_phase,
            admit_phase=c.admit_phase,
            retire_phase=c.retire_phase,
            latency_phases=c.latency_phases,
            first_seeded_phase=c.first_seeded_phase,
            last_credited_phase=c.last_credited_phase,
            latency_s=round(c.latency_s, 6),
            tenant=c.tenant, priority=c.priority)
        if span is not None:
            span.close(
                disposition=("failed" if c.failed else "retired"),
                **({"failure": c.failure} if c.failure else {}),
                retire_phase=c.retire_phase,
                latency_phases=c.latency_phases)

    def _cancel_slots(self, kill: np.ndarray) -> None:
        """Compact the cancelled slots' live rows out of the bag. Between
        phases all walk state lives in the bag, so after the compaction
        nothing can credit the freed slots again."""
        if self.engine == "walker-dd":
            # every rank compacts its own queue; one gather of the counts
            self._count = int(np.sum(self._world.call("cancel", kill)))
            self._last_fam_live = np.where(kill, 0, self._last_fam_live)
            return
        k = torch.as_tensor(kill, dtype=torch.bool, device=self.device)
        d = self._dev
        bag = _cancel_program(d["bag"], k, self._syncs)
        self._dev = dict(d, bag=bag)
        self._count = bag.count
        self._last_fam_live = np.where(kill, 0, self._last_fam_live)

    def step(self) -> List[CompletedRequest]:
        """One phase: admit -> cycle -> retire. Returns the requests
        retired this phase (empty when idle)."""
        return self.step_finish(self.step_begin())

    def step_begin(self):
        """First half of one phase: the phase span, the admission policy
        and the cycle. Returns the token for :meth:`step_finish`;
        nothing else may drive this engine in between."""
        if self.fault_injector is not None:
            # phase-open fault boundary, before the phase span and the
            # admissions: a crash here replays this phase's admissions
            self.fault_injector.on_phase_open(self.phase,
                                              n_dev=self._n_dev)
        n0 = self._syncs.n
        span = self.telemetry.span("phase", phase=self.phase)
        self._refill_tokens()
        self._shed_unmeetable()
        self._admit()
        if self._count == 0 and not self._slot_req:
            return ("idle", span, n0, None)
        return ("cycle", span, n0, self._cycle_launch())

    def step_finish(self, token) -> List[CompletedRequest]:
        """Second half of one phase: read the cycle's results, then
        retire and account. ``step() == step_finish(step_begin())``."""
        kind, span, n0, launch = token
        tel = self.telemetry
        if kind == "idle":
            # nothing live and nothing admissible: no device work (a
            # queued spillover batch still runs on the CPU), and the
            # phase counter advances so arrival gaps make progress
            spilled = self._run_spillover_phase()
            self.completed.extend(spilled)
            # idle phases adapt too, on the queue-depth pressures alone
            self._maybe_adapt(None)
            self.phase += 1
            self._publish_gauges()
            if self._slo is not None:
                self._slo.evaluate_slo(self.phase)
            span.close(idle=not spilled, retired=len(spilled))
            self._maybe_snapshot()
            self._phase_closed()
            return spilled
        (fam_live, acc, acc_c, fam_last, count, overflow,
         stats) = self._cycle_pull(launch)
        if self.engine == "walker-dd":
            # the per-rank flight record under the still-open phase span,
            # from the deltas the pull computed
            rec = self._chip_phase_rec
            self._flight.record_phase(
                self.phase, wsteps=rec["wsteps"], tasks=rec["tasks"],
                live_rows=rec["live_rows"], bank_delta=rec["bank_delta"],
                waste=rec["waste"], crounds=rec["crounds"])
        self._last_fam_live = fam_live
        self._last_fam_last = np.asarray(fam_last, dtype=np.int32)
        if overflow:
            tel.event("overflow", phase=self.phase, count=int(count))
            span.close(error="overflow")
            raise RuntimeError(
                "stream walker bag overflowed; raise capacity or lower "
                "the offered load / admit window")
        self._count = count
        row = stats.astype(np.int64)
        self._phase_rows.append(row)
        vals = self._publish_phase_row(row)
        if tel.tracer.enabled:
            # per-rid phase residency, linked to this phase's span
            for slot in sorted(self._slot_req):
                req = self._slot_req[slot]
                tel.request_event(
                    self._rid_spans.get(req.rid), "request_phase",
                    rid=req.rid, slot=slot, phase=self.phase,
                    phase_span=span.sid)
        retired = []
        now = time.perf_counter()
        for slot in sorted(self._slot_req):
            if fam_live[slot] != 0:
                continue
            req = self._slot_req.pop(slot)
            rec = self._records.pop(req.rid)
            T = self._theta_block
            if T > 1:
                seg = (acc.reshape(self.slots, T)[slot]
                       + acc_c.reshape(self.slots, T)[slot])
                areas = [float(v) for v in seg[:len(req.thetas)]]
                area = areas[0]
                finite = np.all(np.isfinite(areas))
            else:
                areas = None
                area = float(acc[slot] + acc_c[slot])
                finite = np.isfinite(area)
            if not finite and not self.quarantine:
                tel.event("nan_retire", rid=req.rid, slot=slot,
                          phase=self.phase)
                span.close(error="nan_retire")
                raise FloatingPointError(
                    f"stream request {req.rid} produced a non-finite "
                    f"area — refusing to report garbage")
            if not finite:
                # quarantine: the poison stays in this slot's
                # accumulators, which its next admission clears
                tel.request_event(self._rid_spans.get(req.rid),
                                  "quarantine", rid=req.rid,
                                  slot=slot, phase=self.phase)
                self._c_quarantined.inc()
            c = CompletedRequest(
                rid=req.rid, theta=req.theta, bounds=req.bounds,
                area=area, areas=areas,
                submit_phase=req.submit_phase,
                admit_phase=rec["admit_phase"],
                retire_phase=self.phase,
                latency_s=now - req.submit_t,
                first_seeded_phase=int(self._fam_first[slot]),
                last_credited_phase=int(fam_last[slot]),
                failed=not finite,
                tenant=req.tenant, priority=req.priority,
                failure=(None if finite else "nan"))
            retired.append(c)
            self._free.append(slot)
            self._account_retirement(c, slot)
        # deadline expiry: a resident request at or past its deadline
        # phase retires FAILED and its live rows are compacted out; the
        # slot is reusable at once
        kill = None
        for slot in sorted(self._slot_req):
            req = self._slot_req[slot]
            dp = req.deadline_phase
            if dp is None or self.phase < dp:
                continue
            self._slot_req.pop(slot)
            rec = self._records.pop(req.rid)
            c = CompletedRequest(
                rid=req.rid, theta=req.theta, bounds=req.bounds,
                area=float("nan"), areas=None,
                submit_phase=req.submit_phase,
                admit_phase=rec["admit_phase"],
                retire_phase=self.phase,
                latency_s=now - req.submit_t,
                first_seeded_phase=int(self._fam_first[slot]),
                last_credited_phase=int(fam_last[slot]),
                failed=True, tenant=req.tenant,
                priority=req.priority, failure="deadline_exceeded")
            tel.request_event(self._rid_spans.get(req.rid),
                              "deadline_exceeded", rid=req.rid,
                              slot=slot, phase=self.phase,
                              deadline_phase=dp, tenant=req.tenant)
            self._c_deadline.labels(tenant=req.tenant).inc()
            retired.append(c)
            self._free.append(slot)
            if kill is None:
                kill = np.zeros(self.slots, dtype=bool)
            kill[slot] = True
            self._account_retirement(c, slot)
        if kill is not None:
            self._cancel_slots(kill)
        self._free.sort()
        retired.extend(self._run_spillover_phase())
        self.completed.extend(retired)
        self._phase_syncs.append(self._syncs.n - n0)
        # this phase's stats row feeds the adapter (effective next phase)
        self._maybe_adapt(vals)
        self.phase += 1
        self._publish_gauges()
        if self._slo is not None:
            self._slo.evaluate_slo(self.phase)
        span.close(retired=len(retired), **vals)
        self._maybe_snapshot()
        self._phase_closed()
        return retired

    def last_phase_row(self) -> Optional[dict]:
        """The newest device-counted phase row as a field dict (None
        before the first non-idle phase). The cluster worker protocol
        reads its per-phase deltas here: host values the boundary
        already read, no device work."""
        if not self._phase_rows:
            return None
        return {k: int(v) for k, v in
                zip(STREAM_STAT_FIELDS, self._phase_rows[-1])}

    def phase_rows_len(self) -> int:
        """How many non-idle phase rows exist (the cluster worker pairs
        this with :meth:`last_phase_row` to tell a fresh row from a
        stale one across an idle phase)."""
        return len(self._phase_rows)

    def _run_spillover_phase(self) -> List[CompletedRequest]:
        """The phase boundary's spillover batch: up to
        ``spillover_limit`` queued victims, in queue order, run to
        completion on the CPU backend and retire with
        ``spillover=True``."""
        if self._spill is None or not self._spill_queue:
            return []
        out = []
        limit = (self.spillover_limit if self._adapt is None
                 else self._adapt.values["spillover_limit"])
        while self._spill_queue and len(out) < limit:
            req = self._spill_queue.pop(0)
            failed = False
            areas = None
            try:
                areas, _tasks, _wall = self._spill.run(req.theta,
                                                       req.bounds)
            except FloatingPointError:
                # the quarantine covers the spillover path too: a
                # poisoned request retires failed, healthy work goes on
                if not self.quarantine:
                    raise
                failed = True
                self.telemetry.request_event(
                    self._rid_spans.get(req.rid), "quarantine",
                    rid=req.rid, phase=self.phase, spillover=True)
                self._c_quarantined.inc()
            batched = isinstance(req.theta, (tuple, list))
            c = CompletedRequest(
                rid=req.rid, theta=req.theta, bounds=req.bounds,
                area=(float("nan") if failed else areas[0]),
                areas=(list(areas) if batched and not failed else None),
                submit_phase=req.submit_phase,
                admit_phase=self.phase, retire_phase=self.phase,
                latency_s=time.perf_counter() - req.submit_t,
                first_seeded_phase=-1, last_credited_phase=-1,
                failed=failed, failure=("nan" if failed else None),
                tenant=req.tenant, priority=req.priority,
                spillover=True)
            out.append(c)
            self._c_spillover.inc()
            self._account_retirement(c, slot=-1)
        return out

    def _maybe_adapt(self, vals: Optional[dict]) -> None:
        """Online adaptation at the phase close: per-knob pressures from
        this phase's stats row (``vals``; None on an idle phase) and the
        host queue depths, folded through the adapter (hysteresis, one
        step per phase, safe bands), one ``knob_adapt`` event per change.
        Host arithmetic on values already read: no device read."""
        if self._adapt is None:
            return
        a = self._adapt
        pressures = {}
        pending = len(self._pending)
        lazy = 0.0
        if vals is not None:
            denom = max(1, int(vals.get("wsteps", 0)) * self.lanes)
            lazy = (int(vals.get("drain_tail", 0))
                    + int(vals.get("masked_dead", 0))) / denom
        if pending > 0 and (vals is None or lazy >= ADAPT_WASTE_FRAC):
            # backlog with underfed lanes: open the admission budget
            pressures["admit_budget"] = 1
        elif pending == 0 and a.values["admit_budget"] \
                > a.defaults["admit_budget"]:
            pressures["admit_budget"] = -1
        backlog = len(self._spill_queue)
        if backlog > a.values["spillover_limit"]:
            pressures["spillover_limit"] = 1
        elif backlog == 0 and a.values["spillover_limit"] \
                > a.defaults["spillover_limit"]:
            pressures["spillover_limit"] = -1
        for ch in a.observe(pressures):
            self.telemetry.event("knob_adapt", phase=self.phase, **ch)
        for k, g in self._g_adapt.items():
            g.set(float(a.values[k]))

    def drain(self, max_phases: int = 1 << 14,
              _crash_after_phases: Optional[int] = None
              ) -> List[CompletedRequest]:
        """Run phases until the engine is idle; returns everything
        retired during the drain. ``_crash_after_phases`` is a test hook
        that raises after that many phases."""
        done: List[CompletedRequest] = []
        phases = 0
        while not self.idle:
            done.extend(self.step())
            phases += 1
            if _crash_after_phases is not None \
                    and phases >= _crash_after_phases:
                raise RuntimeError(
                    f"simulated crash after {phases} phases (test hook)")
            if phases >= max_phases:
                raise RuntimeError(
                    f"stream did not drain in {max_phases} phases "
                    f"({self._count} tasks, {self.resident} resident, "
                    f"{self.pending} pending)")
        return done

    def run(self, requests: Sequence[Tuple[float, Tuple[float, float]]],
            arrival_phase: Optional[Sequence[int]] = None,
            _crash_after_phases: Optional[int] = None) -> StreamResult:
        """Submit ``requests`` — (theta, bounds) pairs, or (theta,
        bounds, kwargs) triples carrying tenant/priority/deadline_phases
        — all at once or on the open-loop ``arrival_phase`` schedule
        (one phase per request, counted from this call), and run phases
        until every request has retired or been shed.
        ``_crash_after_phases`` is a test hook that raises after that
        many phases."""
        t0 = time.perf_counter()
        sched = ([0] * len(requests) if arrival_phase is None
                 else [int(p) for p in arrival_phase])
        if len(sched) != len(requests):
            raise ValueError("arrival_phase length != requests length")
        order = sorted(range(len(requests)), key=lambda i: sched[i])
        queue = [(sched[i], requests[i]) for i in order]
        phases0 = self.phase
        run_span = self.telemetry.span(
            "run", engine=f"{self.engine}-stream", requests=len(queue))
        k = 0
        phases = 0
        while k < len(queue) or not self.idle:
            while k < len(queue) and \
                    queue[k][0] <= self.phase - phases0:
                r = queue[k][1]
                kw2 = r[2] if len(r) > 2 else {}
                self.submit(r[0], r[1], **kw2)
                k += 1
            self.step()
            phases += 1
            if _crash_after_phases is not None \
                    and phases >= _crash_after_phases:
                raise RuntimeError(
                    f"simulated crash after {phases} phases (test hook)")
            if phases > (1 << 14):
                raise RuntimeError("stream did not converge")
        run_span.close(phases=phases, completed=len(self.completed))
        return self.result(wall_s=time.perf_counter() - t0)

    def result(self, wall_s: float = 0.0) -> StreamResult:
        rows = (np.stack(self._phase_rows) if self._phase_rows
                else np.zeros((0, len(STREAM_STAT_FIELDS)), np.int64))
        # totals come from the registry, the counters every reader uses
        reg = self.telemetry.registry
        totals = {k: int(reg.value(f"ppls_stream_{k}_total"))
                  for k in _COUNTER_STATS}
        totals["maxd"] = int(reg.value("ppls_stream_max_depth"))
        return StreamResult(
            completed=list(self.completed), phases=self.phase,
            wall_s=wall_s, totals=totals, phase_stats=rows,
            fam_done=np.asarray(self._last_fam_live) == 0,
            fam_first_phase=self._fam_first.copy(),
            fam_last_phase=self._last_fam_last.copy(),
            latency_hist_phases=self._h_lat_phases.solo(),
            latency_hist_seconds=self._h_lat_seconds.solo(),
            per_round=round_stats_from_rows(rows, STREAM_STAT_FIELDS),
            shed=list(self.shed), host_syncs=self._syncs.n,
            host_syncs_per_phase=list(self._phase_syncs),
            mesh=self.mesh_record())
