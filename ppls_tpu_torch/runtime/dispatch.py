"""Heterogeneous-shape dispatcher: a pool of StreamEngines behind one
serving surface, so shape-heterogeneous traffic never rebuilds a kernel
(the reference's ``runtime/dispatch.py``, on one card).

Each stream engine runs ONE static configuration (eps, rule,
theta_block, ...), so a mixed-shape request stream needs one engine per
shape. The :class:`EngineDispatcher` keeps that pool: requests carry
per-request ``eps``/``rule``/``theta`` routing keys, a deterministic
canonicalizer quantizes them onto a BOUNDED key lattice, and each
lattice point gets its own StreamEngine. On the card every pooled engine
runs K1 (``csrc/walk_rf.cu``, ``refill_slots`` > 0) or K2
(``csrc/walk_ee.cu``, ``refill_slots=0``) from the one build of each
kernel library.

Canonicalization (the key lattice)
    * ``eps`` quantizes to its tuning-table eps BAND
      (``tune.eps_band``: the nearest power of ten); the engine runs
      at the band edge ``10**band``. Bands outside ``[1e-12, 1e-1]`` are
      rejected.
    * ``rule`` must name a member of :class:`~ppls_tpu_torch.config.Rule`.
    * theta batches pad up to the next power-of-two ``theta_block``
      bucket (1, 2, 4, ... ``MAX_THETA_BUCKET``); batches keep their
      true length inside the engine (the pad is the BUCKET, not fake
      thetas). Batches >1 require TRAPEZOID (union refinement).

Work-conserving schedule
    Each dispatcher ``step()`` is one TURN: route the shared backlog,
    then run ONE phase on every live engine that has work, in
    round-robin order rotated by the turn index; drained engines are
    skipped. Admission control, token buckets, the shed policy and the
    SLO evaluator lift from per-engine to POOL scope: one shared
    backlog with the per-engine free capacity
    (``StreamEngine.free_capacity``) as the routing gate.

Park / unpark (the pool stays bounded)
    At most ``max_engines`` engines are live. When a new key needs a
    slot, the LRU victim (idle engines first) snapshots through
    ``runtime/checkpoint`` and is PARKED: the engine is closed after its
    snapshot (a walker-dd engine's ranks stop with it); when its shape
    returns, a new engine resumes from that snapshot bit-identically
    (a walker-dd engine starts a new world of ranks). Park files are
    sequence-numbered and immutable.

Slot-credit leasing and overlapped boundaries
    With ``lease`` engines with idle slots donate their turn's phase
    credit to the deepest-backlog engines (:meth:`_lease_schedule`).
    With ``overlap_boundaries`` each round launches every due engine's
    phase (``StreamEngine.step_begin``) before the first boundary
    (``step_finish``) runs, last launched first. The port's cycle reads
    the device inside ``step_begin`` (its host loop's syncs), so little
    device work is still in flight when a boundary runs: the tallies
    (``boundaries``, ``overlapped``, ``overlap_fraction``) follow the
    schedule, and ``boundary_wall_s``/``overlap_wall_s`` are measured.

Coordinated snapshot cut
    ``snapshot()`` writes one immutable per-engine snapshot per live
    engine under a CUT number, then the pool manifest (routing ledger,
    grid maps, backlog, accounting) LAST via the checkpoint module's
    atomic rename; superseded files are removed only after the new
    manifest lands. Every engine file carries the pool id in its
    ``client_state``; resume refuses a manifest whose configuration or
    engine-key set differs, and an engine file from a different pool.

Compile accounting across the pool
    The port builds each kernel library once per process
    (``utils/cuda_build.py``); ``cuda_build.builds_done()`` counts the
    libraries this process compiled. The dispatcher reads it around
    each engine's ``step_begin`` and ``step_finish`` and gives any
    growth to the engine that was stepping. An engine's first phase is
    its baseline (a first phase may build the kernel it needs); growth
    in any later phase is a recompile, forwarded to the pool's
    ``ppls_recompiles_total{engine=...}``. A walker-dd engine's ranks
    1..N-1 build in their own processes and are not counted here.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import check_ds_domain, get_family_ds
from ppls_tpu_torch.obs.registry import MetricsRegistry
from ppls_tpu_torch.obs.telemetry import Telemetry
from ppls_tpu_torch.parallel.walker import DEFAULT_LANES
from ppls_tpu_torch.runtime.checkpoint import (background_writer,
                                               flush_background_writer,
                                               load_family_checkpoint,
                                               peek_checkpoint_identity,
                                               save_family_checkpoint)
from ppls_tpu_torch.runtime.stream import (_COUNTER_STATS,
                                           STREAM_STAT_FIELDS,
                                           CompletedRequest, ShedRecord,
                                           StreamEngine, StreamResult)
from ppls_tpu_torch.runtime.tune import eps_band
from ppls_tpu_torch.utils import cuda_build
from ppls_tpu_torch.utils.device import resolve_device
from ppls_tpu_torch.utils.metrics import round_stats_from_rows

# the canonical eps lattice: tuning-table bands, one engine per band.
# Outside this range a request is malformed (the tables stop there and
# an engine at 1e-13 would never retire within any sane deadline).
EPS_BAND_MIN = -12
EPS_BAND_MAX = -1

# theta batches bucket to powers of two up to this cap — the bucket is
# a compile static (``theta_block``), so the cap bounds the lattice;
# it also has to divide the engine's lane count, which every pow2 up
# to 64 does for the default lanes=256.
MAX_THETA_BUCKET = 64

DISPATCH_CKPT_VERSION = 1

_FS_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _theta_bucket(n: int) -> int:
    """Next power-of-two bucket for a theta batch of length ``n``."""
    return 1 << max(0, int(math.ceil(math.log2(max(1, int(n))))))


@dataclasses.dataclass(frozen=True, order=True)
class EngineKey:
    """One point on the canonical key lattice = one pooled engine.

    The string form ``e{band}:{rule}:t{block}`` is the pool's stable
    engine label — it keys the manifest, the metric labels, and the
    park files, so it must stay deterministic and parseable."""

    eps_band: int
    rule: str
    theta_block: int

    @property
    def eps(self) -> float:
        return 10.0 ** self.eps_band

    def __str__(self) -> str:
        return f"e{self.eps_band}:{self.rule}:t{self.theta_block}"

    @classmethod
    def parse(cls, s: str) -> "EngineKey":
        m = re.fullmatch(r"e(-?\d+):([a-z_]+):t(\d+)", s)
        if m is None:
            raise ValueError(f"malformed engine key {s!r}")
        return cls(int(m.group(1)), m.group(2), int(m.group(3)))


def canonical_key(eps, rule, theta) -> EngineKey:
    """Quantize a request's routing keys onto the engine-key lattice.

    Raises ``ValueError`` on anything malformed or out of band —
    BEFORE any pool state is consumed, so the caller owns the
    rejection record exactly like a malformed ``StreamEngine.submit``.
    """
    try:
        eps = float(eps)
    except (TypeError, ValueError):
        raise ValueError(f"eps must be a number, got {eps!r}")
    if not math.isfinite(eps) or eps <= 0.0:
        raise ValueError(f"eps must be finite and > 0, got {eps!r}")
    band = eps_band(eps)
    if not EPS_BAND_MIN <= band <= EPS_BAND_MAX:
        raise ValueError(
            f"eps {eps!r} quantizes to band 1e{band}, outside the "
            f"dispatchable range [1e{EPS_BAND_MIN}, 1e{EPS_BAND_MAX}]")
    if isinstance(rule, Rule):
        r = rule
    else:
        try:
            r = Rule(str(rule).strip().lower())
        except ValueError:
            raise ValueError(
                f"unknown rule {rule!r} (want one of "
                f"{[m.value for m in Rule]})")
    if isinstance(theta, (tuple, list, np.ndarray)):
        n = int(np.asarray(theta).reshape(-1).shape[0])
        if n == 0:
            raise ValueError("empty theta batch")
    else:
        n = 1
    bucket = _theta_bucket(n)
    if bucket > MAX_THETA_BUCKET:
        raise ValueError(
            f"theta batch of {n} exceeds the dispatcher's bucket cap "
            f"({MAX_THETA_BUCKET})")
    if bucket > 1 and r is not Rule.TRAPEZOID:
        raise ValueError(
            "theta batches run union-refinement, which is TRAPEZOID "
            f"only; got rule={r.value!r} with a batch of {n}")
    return EngineKey(band, r.value, bucket)


@dataclasses.dataclass
class PoolRequest:
    """One request in POOL time: rids, phases, and deadlines here are
    all pool-scoped (``grid`` = global rid, turns = dispatcher
    phases); the engine-local twins live behind the routing maps."""

    grid: int
    key: str
    theta: object
    bounds: Tuple[float, float]
    submit_turn: int
    submit_t: float
    tenant: str = "default"
    priority: int = 1
    deadline_turns: Optional[int] = None
    routed_turn: Optional[int] = None

    @property
    def deadline_turn(self) -> Optional[int]:
        if self.deadline_turns is None:
            return None
        return self.submit_turn + self.deadline_turns


class _EngineTelemetry(Telemetry):
    """The per-engine telemetry handle the dispatcher threads into
    each pooled StreamEngine.

    * **Registry:** PRIVATE per engine. ``StreamEngine.resume``
      replays its whole deterministic record into its registry — on a
      shared registry every unpark would double-count the pool totals.
      The pool reads engine totals from these private registries and
      publishes pool-scope accounting on its own registry.
    * **Tracer:** SHARED with the pool — one timeline. Every span and
      event gains an ``engine`` label, and request-scoped ``rid``
      attrs translate from engine-local rids to pool grids so the
      rid-linkage contract holds on the single events file.
    * **Compile attribution:** see the module docstring: library
      builds are attributed to this engine only while it is the one
      stepping, and only the attributed count is forwarded to the
      pool telemetry (this engine's first phase = its baseline)."""

    def __init__(self, pool: "EngineDispatcher", label: str):
        super().__init__(registry=MetricsRegistry())
        self._pool = pool
        self._label = label
        self._rid_map: Dict[int, int] = {}   # engine rid -> pool grid
        self._local_entries = 0              # attributed library builds
        self._observed = False               # first phase seen (baseline)
        # set by the turn loop around a LEASED phase launch
        # so the phase span records it ran on a donated credit (the
        # occupancy tool reconciles these against the lease grants)
        self._lease_phase = False
        # one timeline: the pool's tracer replaces the private one the
        # base constructor made (which is disabled and writes nowhere)
        self.tracer = pool.telemetry.tracer

    def fresh_registry(self) -> None:
        """Swap in an empty registry before an unpark resume — the
        resumed engine re-registers and replays everything it needs;
        keeping the old registry would double every replayed value."""
        self.registry = MetricsRegistry()
        self._compile_seen = {}

    # -- tracer face: engine label + rid translation --------------------

    def span(self, name: str, **attrs):
        attrs.setdefault("engine", self._label)
        if name == "phase" and self._lease_phase:
            attrs.setdefault("leased", True)
        return self.tracer.span(name, **attrs)

    def event(self, name: str, **attrs) -> None:
        rid = attrs.get("rid")
        if rid is not None:
            attrs["rid"] = self._rid_map.get(int(rid), int(rid))
        attrs.setdefault("engine", self._label)
        self.tracer.event(name, **attrs)

    def request_span(self, rid: int, **attrs):
        """The engine's request span IS the pool's grid span: submit
        (and resume replay) return the already-open pool span so the
        rid's causal trace stays one unbroken timeline across routing,
        park/unpark, and retirement."""
        grid = self._rid_map.get(int(rid), int(rid))
        span = self._pool._grid_spans.get(grid)
        if span is None:
            span = self._pool.telemetry.request_span(
                grid, engine=self._label, **attrs)
            self._pool._grid_spans[grid] = span
        return span

    # -- compile attribution --------------------------------------------

    def publish_builds(self, engine: str, grew: int,
                       wall_s: float = 0.0) -> None:
        """Account the kernel libraries this process built while this
        engine ran one phase (``grew``, the growth of
        ``cuda_build.builds_done()`` around its ``step_begin`` and
        ``step_finish``). The engine's first phase is its baseline;
        growth in a later one adds to the attributed count, whose growth
        the pool telemetry counts as a recompile."""
        grew = int(grew)
        if self._observed:
            self._local_entries += grew
        else:
            grew = 0
        self._observed = True
        # the private gauge keeps the raw process count (debuggability);
        # the POOL series gets the attributed per-engine count
        self.publish_compile_cache(engine, cuda_build.builds_done())
        self._pool.telemetry.publish_compile(
            f"{engine}[{self._label}]", self._local_entries,
            wall_s=wall_s if grew else 0.0)


class EngineDispatcher:
    """A pool of StreamEngines keyed by canonicalized compile statics,
    one serving surface (see module docstring).

    The public face deliberately mirrors :class:`StreamEngine` —
    ``submit`` / ``step`` / ``drain`` / ``run`` / ``result`` /
    ``snapshot`` / ``resume`` / ``idle`` / ``slo_health`` — so the
    serve CLI, the benches, and the artifact tooling treat a pool and
    a single engine interchangeably. ``submit`` additionally takes the
    per-request ``eps``/``rule`` routing keys."""

    def __init__(self, family: str, *,
                 slots: int = 64,
                 max_engines: int = 4,
                 default_eps: float = 1e-6,
                 default_rule: Rule = Rule.TRAPEZOID,
                 queue_limit: Optional[int] = None,
                 tenant_quotas: Optional[dict] = None,
                 default_deadline_phases: Optional[int] = None,
                 park_patience: int = 2,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 8,
                 telemetry: Optional[Telemetry] = None,
                 slo_config=None,
                 fault_injector=None,
                 quarantine: bool = False,
                 on_shed=None,
                 device="cuda",
                 lease: bool = False,
                 lease_cap: int = 3,
                 lease_patience: int = 1,
                 overlap_boundaries: bool = False,
                 checkpoint_background: Optional[bool] = None,
                 engine_kw: Optional[dict] = None):
        self.family = family
        self.slots = int(slots)
        self.max_engines = max(1, int(max_engines))
        self.default_eps = float(default_eps)
        self.default_rule = (default_rule if isinstance(default_rule,
                                                       Rule)
                             else Rule(str(default_rule)))
        self.queue_limit = queue_limit
        self.tenant_quotas = tenant_quotas
        self.default_deadline_phases = default_deadline_phases
        self.park_patience = max(1, int(park_patience))
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(int(checkpoint_every), 1)
        # slot-credit leasing + overlapped phase boundaries. Both are
        # host-side BOUNDARY policy that never touch an engine's static
        # configuration. Neither is manifest identity: like
        # queue_limit/quotas, a resume must be driven with the same
        # flags for the schedule to replay.
        self.lease = bool(lease)
        self.lease_cap = max(1, int(lease_cap))
        self.lease_patience = max(1, int(lease_patience))
        self.overlap_boundaries = bool(overlap_boundaries)
        # background checkpoint serialization rides the overlap flag
        # by default (it IS the boundary-overlap story for the cut),
        # but stays independently controllable
        self.checkpoint_background = bool(
            overlap_boundaries if checkpoint_background is None
            else checkpoint_background)
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry()
        self.fault_injector = fault_injector
        self.quarantine = bool(quarantine)
        self.on_shed = on_shed
        # every pooled engine runs on this device (CUDA by default: a
        # pool without a card raises here, before any engine exists)
        self.device = resolve_device(device)
        self.engine_kw = dict(engine_kw or {})
        self._f_ds = get_family_ds(family)

        # pool identity: minted once, stamped into every engine
        # snapshot's client_state — the cross-pool blend refusal
        self.pool_id = os.urandom(8).hex()

        # engine pool state
        self._engines: Dict[str, StreamEngine] = {}
        self._wrappers: Dict[str, _EngineTelemetry] = {}
        self._parked: Dict[str, dict] = {}
        self._order: List[str] = []          # live round-robin order
        self._last_used: Dict[str, int] = {}
        self._park_seq = 0
        self._pool_dir: Optional[str] = None

        # routing state (pool time)
        self.turn = 0
        self._next_grid = 0
        self._backlog: List[PoolRequest] = []
        self._inflight: Dict[int, PoolRequest] = {}
        self._gmap: Dict[int, Tuple[str, int]] = {}  # grid->(key,lrid)
        self._taken: Dict[str, List[int]] = {}   # key->[ncomp, nshed]
        self._grid_spans: dict = {}
        self._tokens: Dict[str, float] = {}
        self._token_waits: Dict[int, int] = {}
        self.completed: List[CompletedRequest] = []
        self.shed: List[ShedRecord] = []
        self.client_state: dict = {}

        # the lease ledger: per-engine idle streaks (the
        # donor hysteresis), cumulative donated/received credits, and
        # the boundary/overlap tallies. All of it rides the
        # coordinated snapshot so a resumed pool replays the identical
        # lease decisions.
        self._idle_streak: Dict[str, int] = {}
        self._lease_given: Dict[str, int] = {}
        self._lease_recv: Dict[str, int] = {}
        self._boundaries = 0
        self._overlapped = 0
        self._boundary_wall = 0.0
        self._overlap_wall = 0.0
        # device reads by the pooled engines' phases (this process)
        self._host_syncs = 0

        # coordinated snapshot cut bookkeeping
        self._cut = 0
        self._cut_files: set = set()

        # pool-scope accounting: the same metric names the single
        # engine publishes, so the serve summary, /metrics, and the
        # SLO evaluator read one surface regardless of tier — plus the
        # dispatch-specific families (engine-labeled)
        tel = self.telemetry
        reg = tel.registry
        self._c_retired = tel.stream_counter("retired")
        self._c_tenant_retired = reg.counter(
            "ppls_stream_tenant_retired_total",
            "requests retired, by tenant", ("tenant",))
        self._c_deadline = reg.counter(
            "ppls_stream_deadline_exceeded_total",
            "in-flight requests retired failed at their phase "
            "deadline", ("tenant",))
        self._c_quarantined = reg.counter(
            "ppls_stream_quarantined_total",
            "requests retired as failed through the NaN quarantine")
        self._c_shed = tel.shed_counter()
        self._h_lat_phases = tel.latency_phases_histogram()
        self._h_lat_seconds = tel.latency_seconds_histogram()
        self._h_class_lat = tel.class_latency_histogram()
        self._h_tenant_lat = tel.tenant_latency_histogram()
        self._h_engine_lat = tel.dispatch_latency_histogram()
        self._g_engines = tel.dispatch_engines_gauge()
        self._c_phases = tel.dispatch_phase_counter()
        self._c_routed = tel.dispatch_routed_counter()
        self._c_spinup = reg.counter(
            "ppls_dispatch_engine_spinups_total",
            "engine spin-ups (cold or unpark), by engine key",
            ("engine",))
        self._c_park = reg.counter(
            "ppls_dispatch_engine_parks_total",
            "LRU engine parks (checkpoint + evict), by engine key",
            ("engine",))
        self._c_lease_donated = reg.counter(
            "ppls_dispatch_lease_donated_total",
            "phase credits donated to the lease pool, by donor "
            "engine key", ("engine",))
        self._c_lease_recv = reg.counter(
            "ppls_dispatch_lease_received_total",
            "leased phase credits received, by borrower engine key",
            ("engine",))
        self._c_boundary = reg.counter(
            "ppls_dispatch_boundaries_total",
            "engine phase boundaries the turn loop ran (host "
            "fetch + retire bookkeeping)")
        self._c_boundary_overlap = reg.counter(
            "ppls_dispatch_boundaries_overlapped_total",
            "phase boundaries whose host work ran while another "
            "engine's launched cycle was still in flight")
        self._g_backlog = reg.gauge(
            "ppls_dispatch_backlog",
            "pool-scope shared backlog depth (unrouted requests)")
        self._g_inflight = reg.gauge(
            "ppls_dispatch_inflight",
            "requests routed to an engine and not yet terminal")
        self._g_occ = reg.gauge(
            "ppls_dispatch_slot_occupancy",
            "per-engine resident slots / total slots", ("engine",))
        self._g_turn = reg.gauge(
            "ppls_dispatch_turn", "dispatcher turn counter")
        # registered here with the exact telemetry-module text so
        # recompiles() can sum the family without re-registering a
        # conflicting twin
        self._c_recompiles = reg.counter(
            "ppls_recompiles_total",
            "pjit cache growth events after the engine's first "
            "observation (compile-once invariant violations)",
            ("engine",))
        self._slo = None
        if slo_config is not None:
            from ppls_tpu_torch.obs.slo import SloEvaluator
            self._slo = SloEvaluator(slo_config, tel, scope="pool")
        self._g_engines.labels(state="live").set(0.0)
        self._g_engines.labels(state="parked").set(0.0)

    # ------------------------------------------------------------------
    # request intake (pool scope)
    # ------------------------------------------------------------------

    def submit(self, theta, bounds, tenant: str = "default",
               priority: int = 1,
               deadline_phases: Optional[int] = None,
               eps: Optional[float] = None,
               rule=None) -> int:
        """Queue one request with its routing keys; returns the pool
        grid (the pool-scope rid). A malformed submission — bad
        eps/rule/theta shape, bad domain, bad tenancy fields — raises
        ``ValueError`` BEFORE a grid is consumed (the caller owns the
        rejection record, same contract as ``StreamEngine.submit``).
        A well-formed submission always consumes a grid; under a full
        ``queue_limit`` the engine's deterministic shed policy applies
        at POOL scope (lowest-priority-oldest vs the arrival)."""
        key = canonical_key(self.default_eps if eps is None else eps,
                            self.default_rule if rule is None
                            else rule, theta)
        bounds = (float(bounds[0]), float(bounds[1]))
        if isinstance(theta, (tuple, list, np.ndarray)):
            thetas = tuple(float(t)
                           for t in np.asarray(theta).reshape(-1))
            theta_store = thetas if key.theta_block > 1 else thetas[0]
        else:
            thetas = (float(theta),)
            theta_store = float(theta)
        check_ds_domain(self._f_ds,
                        np.tile(np.array([bounds]),
                                (len(thetas), 1)),
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
        grid = self._next_grid
        self._next_grid += 1
        preq = PoolRequest(
            grid=grid, key=str(key), theta=theta_store,
            bounds=bounds, submit_turn=self.turn,
            submit_t=time.perf_counter(), tenant=tenant,
            priority=priority, deadline_turns=deadline_phases)
        self._grid_spans[grid] = self.telemetry.request_span(
            grid, tenant=tenant, priority=priority,
            submit_phase=self.turn, engine=preq.key)
        if self.queue_limit is not None \
                and len(self._backlog) >= self.queue_limit:
            victim = min(self._backlog,
                         key=lambda r: (r.priority, r.grid))
            if victim.priority < preq.priority:
                self._backlog.remove(victim)
                self._shed_pool(victim, "queue_full")
            else:
                self._shed_pool(preq, "queue_full")
                return grid
        self._backlog.append(preq)
        return grid

    def _shed_pool(self, preq: PoolRequest, reason: str) -> ShedRecord:
        rec = ShedRecord(
            rid=preq.grid, theta=preq.theta, bounds=preq.bounds,
            tenant=preq.tenant, priority=preq.priority, reason=reason,
            phase=self.turn, submit_phase=preq.submit_turn)
        self.shed.append(rec)
        self._c_shed.labels(tenant=preq.tenant, reason=reason).inc()
        self._token_waits.pop(preq.grid, None)
        span = self._grid_spans.pop(preq.grid, None)
        self.telemetry.request_event(
            span, "request_shed", rid=preq.grid, tenant=preq.tenant,
            priority=preq.priority, reason=reason, phase=self.turn,
            submit_phase=preq.submit_turn, engine=preq.key)
        if span is not None:
            span.close(disposition="shed", reason=reason,
                       phase=self.turn)
        if self.on_shed is not None:
            self.on_shed(rec)
        return rec

    def _quota_for(self, tenant: str) -> Optional[dict]:
        if self.tenant_quotas is None:
            return None
        return self.tenant_quotas.get(tenant,
                                      self.tenant_quotas.get("*"))

    def _refill_tokens(self) -> None:
        if self.tenant_quotas is None:
            return
        for tenant in self._tokens:
            q = self._quota_for(tenant)
            if q is not None:
                self._tokens[tenant] = min(
                    q["burst"], self._tokens[tenant] + q["rate"])

    def _shed_unmeetable(self) -> None:
        victims = [r for r in self._backlog
                   if r.deadline_turn is not None
                   and r.deadline_turn < self.turn]
        for preq in victims:
            self._backlog.remove(preq)
            self._shed_pool(preq, "deadline_exceeded")

    # ------------------------------------------------------------------
    # engine pool: spin-up / park / unpark
    # ------------------------------------------------------------------

    def _pool_path(self) -> str:
        """Directory for park files: the checkpoint dir when one is
        configured, else a lazily created temp dir (parking must work
        on an un-checkpointed pool — it is an eviction, not a durable
        cut)."""
        if self._pool_dir is None:
            if self.checkpoint_path:
                self._pool_dir = (os.path.dirname(
                    os.path.abspath(self.checkpoint_path)) or ".")
                os.makedirs(self._pool_dir, exist_ok=True)
            else:
                self._pool_dir = tempfile.mkdtemp(
                    prefix="ppls-dispatch-")
        return self._pool_dir

    @staticmethod
    def _fs_key(keystr: str) -> str:
        return _FS_SAFE.sub("-", keystr)

    def _engine_kwargs(self, key: EngineKey) -> dict:
        kw = dict(self.engine_kw)
        kw.update(slots=self.slots, rule=Rule(key.rule),
                  theta_block=key.theta_block,
                  device=self.device,
                  quarantine=self.quarantine,
                  checkpoint_background=self.checkpoint_background)
        return kw

    def _register_live(self, keystr: str, eng: StreamEngine) -> None:
        self._engines[keystr] = eng
        self._order.append(keystr)
        self._last_used[keystr] = self.turn
        self._taken.setdefault(keystr, [0, 0])

    def _spinup(self, keystr: str) -> StreamEngine:
        key = EngineKey.parse(keystr)
        wrapper = self._wrappers.get(keystr)
        if wrapper is None:
            wrapper = _EngineTelemetry(self, keystr)
            self._wrappers[keystr] = wrapper
        # each engine resolves its own tuned cadence signature and
        # owns its own compile-once guard from here on
        eng = StreamEngine(self.family, key.eps, telemetry=wrapper,
                           **self._engine_kwargs(key))
        self._register_live(keystr, eng)
        self._c_spinup.labels(engine=keystr).inc()
        self.telemetry.event(
            "engine_spinup", engine=keystr, turn=self.turn,
            resumed=False, live=len(self._engines),
            parked=len(self._parked))
        return eng

    def _park(self, keystr: str) -> None:
        """Checkpoint + evict one live engine. The park file is a new
        immutable sequence-numbered snapshot (re-parks never overwrite
        an older generation), stamped with the pool id. The engine is
        closed after its snapshot: a walker-dd engine's ranks stop with
        it (its unpark starts a new world)."""
        eng = self._engines.pop(keystr)
        self._order.remove(keystr)
        self._park_seq += 1
        path = os.path.join(
            self._pool_path(),
            f"park.{self._park_seq:05d}.{self._fs_key(keystr)}.ckpt")
        eng.client_state["pool_id"] = self.pool_id
        eng.client_state["engine_key"] = keystr
        eng.checkpoint_path = path
        try:
            eng.snapshot()
        finally:
            eng.close()
        eng.checkpoint_path = None
        self._parked[keystr] = {
            "path": path, "seq": self._park_seq, "idle": eng.idle,
            "phase": eng.phase, "pending": eng.pending,
            "resident": eng.resident,
            "totals": self._wrapper_totals(self._wrappers[keystr]),
        }
        self._c_park.labels(engine=keystr).inc()
        self._g_occ.labels(engine=keystr).set(0.0)
        self.telemetry.event(
            "engine_park", engine=keystr, turn=self.turn,
            phase=eng.phase, idle=eng.idle, pending=eng.pending,
            resident=eng.resident, live=len(self._engines),
            parked=len(self._parked))

    def _unpark(self, keystr: str) -> StreamEngine:
        info = self._parked.pop(keystr)
        key = EngineKey.parse(keystr)
        wrapper = self._wrappers[keystr]
        # fresh registry: the resume replay below rebuilds the
        # engine's whole deterministic record into it (the old one
        # already holds those values — keeping it would double-count)
        wrapper.fresh_registry()
        eng = StreamEngine.resume(info["path"], self.family, key.eps,
                                  telemetry=wrapper,
                                  **self._engine_kwargs(key))
        if eng.client_state.get("pool_id") != self.pool_id:
            eng.close()
            raise ValueError(
                f"park file {info['path']!r} belongs to a different "
                f"pool (stored {eng.client_state.get('pool_id')!r}, "
                f"this pool {self.pool_id!r}); refusing to blend")
        # resume() armed auto-snapshots onto the park file — the pool
        # owns the snapshot cadence, and park files are immutable
        eng.checkpoint_path = None
        self._register_live(keystr, eng)
        self._c_spinup.labels(engine=keystr).inc()
        self.telemetry.event(
            "engine_spinup", engine=keystr, turn=self.turn,
            resumed=True, phase=eng.phase, live=len(self._engines),
            parked=len(self._parked))
        return eng

    def _pick_victim(self, exclude: str) -> Optional[str]:
        """LRU park victim: idle engines first; a busy engine only
        when it has not been routed to for ``park_patience`` turns
        (anti-thrash — under key pressure a busy shape holds its
        engine for at least that long)."""
        cands = [k for k in self._order if k != exclude]
        if not cands:
            return None
        idle = [k for k in cands if self._engines[k].idle]
        if idle:
            return min(idle,
                       key=lambda k: (self._last_used.get(k, -1), k))
        stale = [k for k in cands
                 if self._last_used.get(k, -1)
                 <= self.turn - self.park_patience]
        if stale:
            return min(stale,
                       key=lambda k: (self._last_used.get(k, -1), k))
        return None

    def _ensure_engine(self, keystr: str) -> Optional[StreamEngine]:
        """Live engine for ``keystr``, spinning up / unparking (and
        LRU-evicting) as needed; ``None`` when the cap is reached and
        no victim is eligible yet (the request stays in the backlog).
        """
        eng = self._engines.get(keystr)
        if eng is not None:
            return eng
        if len(self._engines) >= self.max_engines:
            victim = self._pick_victim(keystr)
            if victim is None:
                return None
            self._park(victim)
        if keystr in self._parked:
            return self._unpark(keystr)
        return self._spinup(keystr)

    # ------------------------------------------------------------------
    # routing + the work-conserving turn
    # ------------------------------------------------------------------

    def _route(self) -> None:
        """Deal backlog requests to their engines: order is
        (-priority, grid) — higher classes first, FIFO within a class
        — gated by the pool token buckets and each engine's free
        capacity (slots not already spoken for), so admission control
        stays pool-scope and an engine's pending queue never grows
        beyond what it can seat."""
        if not self._backlog:
            return
        routed: set = set()
        for preq in sorted(self._backlog,
                           key=lambda r: (-r.priority, r.grid)):
            dt = preq.deadline_turn
            remaining = None if dt is None else dt - self.turn
            if remaining is not None and remaining < 1:
                continue    # next turn's unmeetable shed takes it
            q = self._quota_for(preq.tenant)
            if q is not None:
                if preq.tenant not in self._tokens:
                    self._tokens[preq.tenant] = q["burst"]
                if self._tokens[preq.tenant] < 1.0:
                    self._token_waits[preq.grid] = \
                        self._token_waits.get(preq.grid, 0) + 1
                    self.telemetry.request_event(
                        self._grid_spans.get(preq.grid),
                        "token_wait", rid=preq.grid,
                        tenant=preq.tenant, phase=self.turn)
                    continue
            eng = self._engines.get(preq.key)
            if eng is None:
                eng = self._ensure_engine(preq.key)
                if eng is None:
                    continue            # pool at cap, victims fresh
            if eng.free_capacity <= 0:
                continue
            wrapper = self._wrappers[preq.key]
            lrid = eng.next_rid
            # the map entry must exist BEFORE submit: the engine opens
            # its request span during submit and the wrapper resolves
            # it to the pool grid span through this map
            wrapper._rid_map[lrid] = preq.grid
            eng.submit(preq.theta, preq.bounds, tenant=preq.tenant,
                       priority=preq.priority,
                       deadline_phases=remaining)
            if q is not None:
                self._tokens[preq.tenant] -= 1.0
            preq.routed_turn = self.turn
            self._gmap[preq.grid] = (preq.key, lrid)
            self._inflight[preq.grid] = preq
            self._last_used[preq.key] = self.turn
            self._c_routed.labels(engine=preq.key).inc()
            self.telemetry.request_event(
                self._grid_spans.get(preq.grid), "request_dealt",
                rid=preq.grid, engine=preq.key, phase=self.turn,
                engine_rid=lrid, engine_phase=eng.phase)
            routed.add(preq.grid)
        if routed:
            self._backlog = [r for r in self._backlog
                             if r.grid not in routed]

    def _unpark_stranded(self) -> None:
        """Progress guarantee: when every live engine is drained but
        parked work exists, unpark it (deterministically: smallest
        key) — otherwise the pool would idle forever on turns."""
        if not self._inflight and not self._backlog:
            return
        if any(not e.idle for e in self._engines.values()):
            return
        cands = sorted(k for k, i in self._parked.items()
                       if not i["idle"])
        if cands:
            self._ensure_engine(cands[0])

    def _update_idle_streaks(self) -> None:
        """Donor hysteresis state: consecutive turns each LIVE engine
        has been drained (routing for this turn already ran, so a
        just-fed engine resets here). Parked engines carry no streak —
        they donate unconditionally."""
        for keystr in self._order:
            if self._engines[keystr].idle:
                self._idle_streak[keystr] = \
                    self._idle_streak.get(keystr, 0) + 1
            else:
                self._idle_streak[keystr] = 0

    def _lease_schedule(self) -> Dict[str, int]:
        """Deal this turn's phase credits. Base schedule: one credit
        per live engine with work (the work-conserving turn).
        With leasing on, engines with idle slots DONATE their turn
        budget to the deepest-backlog engines:

        * donors — every parked engine (infinitely idle, so they rank
          first; their whole budget is the one phase they would run if
          live), then live drained engines whose idle streak has
          reached ``lease_patience`` (hysteresis: a one-turn gap never
          thrashes credits), deepest streak first, key order breaking
          ties;
        * borrowers — live busy engines ranked by backlog depth
          (pending + resident), key order breaking ties; credits deal
          one at a time round-robin down that ranking, capped at
          ``lease_cap`` extra credits per borrower per turn;
        * undealt credits lapse (they are phase slots, not tokens).

        Every input is host state the boundary already owns — the
        policy is deterministic, and the grants it emits replay
        bit-identically from the snapshot's lease ledger."""
        credits = {k: (0 if self._engines[k].idle else 1)
                   for k in self._order}
        if not self.lease:
            return credits
        borrowers = sorted(
            (k for k in self._order if not self._engines[k].idle),
            key=lambda k: (-(self._engines[k].pending
                             + self._engines[k].resident), k))
        if not borrowers:
            return credits
        donors = sorted(self._parked) + sorted(
            (k for k in self._order
             if self._engines[k].idle
             and self._idle_streak.get(k, 0) >= self.lease_patience),
            key=lambda k: (-self._idle_streak.get(k, 0), k))
        extra = {k: 0 for k in borrowers}
        grants: Dict[Tuple[str, str], int] = {}
        bi = 0
        for donor in donors:
            placed = False
            for _ in range(len(borrowers)):
                b = borrowers[bi % len(borrowers)]
                bi += 1
                if extra[b] < self.lease_cap:
                    extra[b] += 1
                    credits[b] += 1
                    grants[(donor, b)] = grants.get((donor, b), 0) + 1
                    placed = True
                    break
            if not placed:
                break           # every borrower at cap: the rest lapse
        for (donor, b), n in sorted(grants.items()):
            self._lease_given[donor] = \
                self._lease_given.get(donor, 0) + n
            self._lease_recv[b] = self._lease_recv.get(b, 0) + n
            self._c_lease_donated.labels(engine=donor).inc(n)
            self._c_lease_recv.labels(engine=b).inc(n)
            self.telemetry.event(
                "lease_grant", turn=self.turn, donor=donor,
                borrower=b, credits=n,
                donor_parked=donor in self._parked)
        return credits

    def _note_phase(self, keystr: str) -> None:
        self._last_used[keystr] = self.turn
        self._c_phases.labels(engine=keystr).inc()

    def _begin_phase(self, keystr: str, eng, leased: bool) -> tuple:
        """Run one engine's ``step_begin`` (the LAUNCH half): the
        admission and the cycle. Returns the launch record
        :meth:`_finish_phase` takes: the token, and the library builds,
        wall and host syncs of this half."""
        wrapper = self._wrappers[keystr]
        wrapper._lease_phase = leased
        b0, n0 = cuda_build.builds_done(), eng._syncs.n
        t0 = time.perf_counter()
        try:
            token = eng.step_begin()
        finally:
            wrapper._lease_phase = False
        return (keystr, eng, token, cuda_build.builds_done() - b0,
                time.perf_counter() - t0, eng._syncs.n - n0)

    def _finish_phase(self, launch: tuple, in_flight: int) -> None:
        """Run one engine's boundary (the PULL half) and tally it:
        every finish is a boundary; a finish with other launched
        phases still unfinished is an OVERLAPPED boundary. The phase's
        library builds go to this engine (:meth:`_EngineTelemetry.
        publish_builds`)."""
        keystr, eng, token, grew, wall, syncs = launch
        b0, n0 = cuda_build.builds_done(), eng._syncs.n
        t0 = time.perf_counter()
        eng.step_finish(token)
        dt = time.perf_counter() - t0
        self._host_syncs += syncs + eng._syncs.n - n0
        self._wrappers[keystr].publish_builds(
            f"{eng.engine}-stream", grew + cuda_build.builds_done() - b0,
            wall_s=wall + dt)
        self._boundaries += 1
        self._c_boundary.inc()
        self._boundary_wall += dt
        if in_flight > 0:
            self._overlapped += 1
            self._c_boundary_overlap.inc()
            self._overlap_wall += dt
        self._note_phase(keystr)

    def _run_turn_phases(self, credits: Dict[str, int]) -> int:
        """Run this turn's phases per the credit schedule. Credits run
        in ROUNDS: round r steps every engine holding more than r
        credits, rotated by the turn index over the ELIGIBLE engines
        only (a drained/parked engine never occupies a rotation slot,
        so it cannot burn a turn credit that a busy engine would have
        used). An engine that drains mid-turn forfeits its remaining
        credits: they are phase slots, not carryover tokens.

        With ``overlap_boundaries`` each round launches every eligible
        engine's phase back-to-back, then runs the boundaries LIFO
        (innermost launch first, so the tracer's span nesting stays
        clean). The port's cycle reads the device inside
        ``step_begin``, so a boundary overlaps only what device work
        its peers' launches left in flight."""
        eligible = [k for k in self._order
                    if credits.get(k, 0) > 0]
        if not eligible:
            return 0
        start = self.turn % len(eligible)
        rotated = eligible[start:] + eligible[:start]
        stepped = 0
        max_c = max(credits.values())
        for r in range(max_c):
            batch = []
            for keystr in rotated:
                if credits.get(keystr, 0) <= r:
                    continue
                eng = self._engines.get(keystr)
                if eng is None or eng.idle:
                    continue    # drained mid-turn: credits lapse
                batch.append((keystr, eng))
            if not batch:
                break
            if self.overlap_boundaries:
                launched = [self._begin_phase(keystr, eng, r > 0)
                            for keystr, eng in batch]
                for i in range(len(launched) - 1, -1, -1):
                    self._finish_phase(launched[i], in_flight=i)
                stepped += len(launched)
            else:
                for keystr, eng in batch:
                    self._finish_phase(
                        self._begin_phase(keystr, eng, r > 0),
                        in_flight=0)
                    stepped += 1
        return stepped

    def step(self) -> List[CompletedRequest]:
        """One pool TURN: route, then run the credit schedule — one
        phase per live engine with work, plus any leased credits
        (round-robin rotated by the turn index over the eligible
        engines), then collect retirements into the pool ledger."""
        t0 = time.perf_counter()
        n_dev = max(1, len(self._engines))
        if self.fault_injector is not None:
            self.fault_injector.on_phase_open(self.turn, n_dev=n_dev)
        span = self.telemetry.span(
            "turn", turn=self.turn, live=len(self._engines),
            parked=len(self._parked), backlog=len(self._backlog))
        self._refill_tokens()
        self._shed_unmeetable()
        self._route()
        self._unpark_stranded()
        self._update_idle_streaks()
        credits = self._lease_schedule()
        stepped = self._run_turn_phases(credits)
        retired = self._collect()
        self.turn += 1
        self._publish_gauges(step_wall_s=time.perf_counter() - t0)
        if self._slo is not None:
            self._slo.evaluate_slo(self.turn)
        span.close(stepped=stepped,
                   leased=sum(max(0, c - 1)
                              for c in credits.values()),
                   retired=len(retired), backlog=len(self._backlog))
        if self.checkpoint_path and \
                self.turn % self.checkpoint_every == 0:
            self.snapshot()
        if self.fault_injector is not None:
            self.fault_injector.on_phase_close(self.turn - 1,
                                               n_dev=n_dev)
        return retired

    def _collect(self) -> List[CompletedRequest]:
        out: List[CompletedRequest] = []
        for keystr in list(self._order):
            eng = self._engines[keystr]
            taken = self._taken[keystr]
            for c in eng.completed[taken[0]:]:
                out.append(self._pool_complete(keystr, c))
            taken[0] = len(eng.completed)
            for s in eng.shed[taken[1]:]:
                self._pool_shed_from_engine(keystr, s)
            taken[1] = len(eng.shed)
        return out

    def _pool_complete(self, keystr: str,
                       c: CompletedRequest) -> CompletedRequest:
        """Translate one engine retirement into the pool ledger:
        pool grid, pool turns, pool latency — the engine already
        emitted the retire event and closed the (shared) request span
        through its telemetry wrapper."""
        wrapper = self._wrappers[keystr]
        grid = wrapper._rid_map.get(c.rid, c.rid)
        preq = self._inflight.pop(grid, None)
        now = time.perf_counter()
        g = dataclasses.replace(
            c, rid=grid,
            submit_phase=(preq.submit_turn if preq is not None
                          else c.submit_phase),
            admit_phase=(preq.routed_turn if preq is not None
                         and preq.routed_turn is not None
                         else c.admit_phase),
            retire_phase=self.turn,
            latency_s=(now - preq.submit_t if preq is not None
                       else c.latency_s))
        self._grid_spans.pop(grid, None)
        self._token_waits.pop(grid, None)
        self._account_pool_retirement(g, keystr)
        self.completed.append(g)
        return g

    def _account_pool_retirement(self, g: CompletedRequest,
                                 keystr: Optional[str]) -> None:
        self._c_retired.inc()
        self._c_tenant_retired.labels(tenant=g.tenant).inc()
        lat = g.latency_phases
        self._h_lat_phases.observe(lat)
        self._h_lat_seconds.observe(g.latency_s)
        self._h_class_lat.labels(priority=str(g.priority)) \
            .observe(lat)
        self._h_tenant_lat.labels(tenant=g.tenant).observe(lat)
        if keystr is not None:
            self._h_engine_lat.labels(engine=keystr).observe(lat)
        if g.failed:
            if g.failure == "deadline_exceeded":
                self._c_deadline.labels(tenant=g.tenant).inc()
            else:
                self._c_quarantined.inc()

    def _pool_shed_from_engine(self, keystr: str,
                               s: ShedRecord) -> None:
        wrapper = self._wrappers[keystr]
        grid = wrapper._rid_map.get(s.rid, s.rid)
        preq = self._inflight.pop(grid, None)
        rec = ShedRecord(
            rid=grid, theta=s.theta, bounds=s.bounds, tenant=s.tenant,
            priority=s.priority, reason=s.reason, phase=self.turn,
            submit_phase=(preq.submit_turn if preq is not None
                          else s.submit_phase))
        self.shed.append(rec)
        self._c_shed.labels(tenant=s.tenant, reason=s.reason).inc()
        # the engine already emitted request_shed and closed the
        # shared span through its wrapper — only the ledger + pool
        # counters live here
        self._grid_spans.pop(grid, None)
        self._token_waits.pop(grid, None)
        if self.on_shed is not None:
            self.on_shed(rec)

    def _publish_gauges(self, step_wall_s: float = 0.0) -> None:
        self._g_engines.labels(state="live") \
            .set(float(len(self._engines)))
        self._g_engines.labels(state="parked") \
            .set(float(len(self._parked)))
        self._g_backlog.set(float(len(self._backlog)))
        self._g_inflight.set(float(len(self._inflight)))
        self._g_turn.set(float(self.turn))
        for keystr, eng in self._engines.items():
            self._g_occ.labels(engine=keystr).set(
                eng.resident / max(1, eng.slots))

    # ------------------------------------------------------------------
    # drive surface (mirrors StreamEngine)
    # ------------------------------------------------------------------

    @property
    def idle(self) -> bool:
        """Nothing backlogged, nothing in flight (live OR parked),
        every live engine drained."""
        return (not self._backlog and not self._inflight
                and all(e.idle for e in self._engines.values()))

    # serve-CLI compatibility face: the single-engine names, in pool
    # units, so the serve loop / ingest stats / summary path drives a
    # pool and an engine through one code path
    @property
    def phase(self) -> int:
        return self.turn

    @property
    def next_rid(self) -> int:
        return self._next_grid

    @property
    def pending(self) -> int:
        """Everything admitted and not yet seated: the shared backlog
        plus every engine's own pending queue (parked included)."""
        n = len(self._backlog)
        n += sum(e.pending for e in self._engines.values())
        n += sum(int(i["pending"]) for i in self._parked.values())
        return n

    @property
    def resident(self) -> int:
        n = sum(e.resident for e in self._engines.values())
        n += sum(int(i["resident"]) for i in self._parked.values())
        return n

    @property
    def lanes(self) -> int:
        """Per-engine lane count (uniform across the pool — lanes ride
        ``engine_kw``), for the occupancy summary's normalization."""
        for eng in self._engines.values():
            return eng.lanes
        return int(self.engine_kw.get("lanes", DEFAULT_LANES))

    def spillover_summary(self) -> dict:
        """Engine-shape spillover block from the pool ledger (pooled
        engines run without a spillover executor, so tasks is the sum
        of whatever the completed records carried)."""
        done = [c for c in self.completed
                if getattr(c, "spillover", False)]
        total = len(self.completed)
        return {
            "spillover_completed": len(done),
            "spillover_fraction": (len(done) / total if total
                                   else 0.0),
            "spillover_tasks": 0,
        }

    def clear_snapshot(self) -> None:
        """Drop the whole coordinated cut: manifest first (no resume
        can see a half-deleted cut), then the per-engine files."""
        if self.checkpoint_background:
            flush_background_writer()
        if self.checkpoint_path \
                and os.path.exists(self.checkpoint_path):
            os.unlink(self.checkpoint_path)
        for p in self._cut_files:
            try:
                os.unlink(p)
            except OSError:
                pass
        self._cut_files = set()

    def drain(self, max_turns: int = 1 << 14,
              _crash_after_turns: Optional[int] = None
              ) -> List[CompletedRequest]:
        done: List[CompletedRequest] = []
        turns = 0
        while not self.idle:
            done.extend(self.step())
            turns += 1
            if _crash_after_turns is not None \
                    and turns >= _crash_after_turns:
                raise RuntimeError(
                    f"simulated crash after {turns} turns (test hook)")
            if turns >= max_turns:
                raise RuntimeError(
                    f"dispatcher did not drain in {max_turns} turns "
                    f"({len(self._backlog)} backlogged, "
                    f"{len(self._inflight)} in flight)")
        return done

    def run(self, requests: Sequence[tuple],
            arrival_phase: Optional[Sequence[int]] = None,
            _crash_after_turns: Optional[int] = None) -> StreamResult:
        """Convenience driver, the engine-run twin: ``requests`` are
        (theta, bounds) pairs or (theta, bounds, kwargs) triples —
        kwargs may carry the routing keys (``eps``/``rule``) plus the
        tenancy fields — submitted up front or on the open-loop
        ``arrival_phase`` schedule (pool turns)."""
        t0 = time.perf_counter()
        sched = ([0] * len(requests) if arrival_phase is None
                 else [int(p) for p in arrival_phase])
        if len(sched) != len(requests):
            raise ValueError("arrival_phase length != requests length")
        order = sorted(range(len(requests)), key=lambda i: sched[i])
        queue = [(sched[i], requests[i]) for i in order]
        turn0 = self.turn
        run_span = self.telemetry.span(
            "run", engine="dispatch-pool", requests=len(queue))
        k = 0
        turns = 0
        while k < len(queue) or not self.idle:
            while k < len(queue) and queue[k][0] <= self.turn - turn0:
                r = queue[k][1]
                kw2 = r[2] if len(r) > 2 else {}
                self.submit(r[0], r[1], **kw2)
                k += 1
            self.step()
            turns += 1
            if _crash_after_turns is not None \
                    and turns >= _crash_after_turns:
                raise RuntimeError(
                    f"simulated crash after {turns} turns (test hook)")
            if turns > (1 << 14):
                raise RuntimeError("dispatcher did not converge")
        run_span.close(turns=turns, completed=len(self.completed))
        return self.result(wall_s=time.perf_counter() - t0)

    def result(self, wall_s: float = 0.0) -> StreamResult:
        """Pool-scope result on the StreamResult shape: the completed
        ledger in pool rids/turns, totals summed across the pool's
        per-engine registries (parked engines contribute their
        park-time capture), the pool latency histograms. Per-phase
        stats rows stay per-engine (they interleave meaninglessly
        across shapes) — timeline consumers read the events file.
        ``host_syncs`` counts the device reads of the pooled engines'
        phases in this process."""
        rows = np.zeros((0, len(STREAM_STAT_FIELDS)), np.int64)
        return StreamResult(
            completed=list(self.completed), phases=self.turn,
            wall_s=wall_s, totals=self.pool_totals(),
            phase_stats=rows,
            fam_done=np.zeros(0, dtype=bool),
            fam_first_phase=np.zeros(0, dtype=np.int32),
            fam_last_phase=np.zeros(0, dtype=np.int32),
            latency_hist_phases=self._h_lat_phases.solo(),
            latency_hist_seconds=self._h_lat_seconds.solo(),
            per_round=round_stats_from_rows(rows, STREAM_STAT_FIELDS),
            shed=list(self.shed), host_syncs=self._host_syncs)

    def close(self) -> None:
        """Close every live engine (a walker-dd engine's ranks stop;
        parked engines are closed already). Idempotent; the pool takes
        no further turn."""
        for eng in self._engines.values():
            eng.close()

    def _wrapper_totals(self, wrapper: _EngineTelemetry) -> dict:
        reg = wrapper.registry
        vals = {k: int(reg.value(f"ppls_stream_{k}_total"))
                for k in _COUNTER_STATS}
        vals["maxd"] = int(reg.value("ppls_stream_max_depth"))
        return vals

    def pool_totals(self) -> dict:
        """Device-counter totals summed across the pool: live engines
        from their private registries, parked engines from the totals
        captured at park time (their registries are replayed fresh at
        unpark, so the capture is the only live copy meanwhile)."""
        vals = {k: 0 for k in _COUNTER_STATS}
        maxd = 0
        for keystr in self._engines:
            t = self._wrapper_totals(self._wrappers[keystr])
            for k in _COUNTER_STATS:
                vals[k] += t[k]
            maxd = max(maxd, t["maxd"])
        for info in self._parked.values():
            t = info.get("totals") or {}
            for k in _COUNTER_STATS:
                vals[k] += int(t.get(k, 0))
            maxd = max(maxd, int(t.get("maxd", 0)))
        vals["maxd"] = maxd
        return vals

    def recompiles(self) -> int:
        """Pool-wide ``ppls_recompiles_total`` — THE invariant this
        tier exists to hold at zero on mixed-shape traffic."""
        return int(sum(child.value
                       for _, child in self._c_recompiles.items()))

    def engines_summary(self) -> dict:
        """Per-engine decomposition for the serve summary / bench
        record: state, phases, occupancy, routed/completed counts,
        and the pool-latency p99 of requests that retired there."""
        reg = self.telemetry.registry
        out: dict = {}
        for keystr in self._order:
            eng = self._engines[keystr]
            p99 = self._h_engine_lat.labels(engine=keystr) \
                .quantile(0.99)
            out[keystr] = {
                "state": "live", "phases": int(eng.phase),
                "pending": int(eng.pending),
                "resident": int(eng.resident),
                "completed": len(eng.completed),
                "shed": len(eng.shed),
                "routed": int(reg.value("ppls_dispatch_routed_total",
                                        engine=keystr)),
                "p99_latency_turns": p99,
                "lease_donated": int(
                    self._lease_given.get(keystr, 0)),
                "lease_received": int(
                    self._lease_recv.get(keystr, 0)),
            }
        for keystr, info in sorted(self._parked.items()):
            p99 = self._h_engine_lat.labels(engine=keystr) \
                .quantile(0.99)
            out[keystr] = {
                "state": "parked", "phases": int(info["phase"]),
                "pending": int(info["pending"]),
                "resident": int(info["resident"]),
                "completed": self._taken.get(keystr, [0, 0])[0],
                "shed": self._taken.get(keystr, [0, 0])[1],
                "routed": int(reg.value("ppls_dispatch_routed_total",
                                        engine=keystr)),
                "p99_latency_turns": p99,
                "lease_donated": int(
                    self._lease_given.get(keystr, 0)),
                "lease_received": int(
                    self._lease_recv.get(keystr, 0)),
            }
        return out

    def lease_summary(self) -> dict:
        """The lease/overlap block for the serve summary and the
        bench record: cumulative donated/received credits (which must
        balance — every grant is one donor credit landing on one
        borrower), the boundary tallies, and the overlap fractions
        (count-weighted and wall-weighted)."""
        donated = sum(self._lease_given.values())
        received = sum(self._lease_recv.values())
        return {
            "enabled": bool(self.lease),
            "overlap_boundaries": bool(self.overlap_boundaries),
            "donated": int(donated),
            "received": int(received),
            "balanced": donated == received,
            "by_donor": {k: int(v) for k, v in
                         sorted(self._lease_given.items())},
            "by_borrower": {k: int(v) for k, v in
                            sorted(self._lease_recv.items())},
            "boundaries": int(self._boundaries),
            "overlapped": int(self._overlapped),
            "overlap_fraction": (self._overlapped / self._boundaries
                                 if self._boundaries else 0.0),
            "boundary_wall_s": float(self._boundary_wall),
            "overlap_wall_s": float(self._overlap_wall),
            "overlap_wall_frac": (
                self._overlap_wall / self._boundary_wall
                if self._boundary_wall > 0 else 0.0),
        }

    def slo_health(self) -> dict:
        if self._slo is None:
            return {"ok": True, "burning": [], "phase": self.turn}
        return self._slo.health()

    # ------------------------------------------------------------------
    # coordinated snapshot cut / resume
    # ------------------------------------------------------------------

    def _manifest_identity_base(self) -> dict:
        return {
            "engine": "dispatch-pool",
            "version": DISPATCH_CKPT_VERSION,
            "family": self.family,
            "slots": self.slots,
            "max_engines": self.max_engines,
        }

    def _manifest_identity(self, keys) -> dict:
        ident = self._manifest_identity_base()
        ident["keys"] = ",".join(sorted(keys))
        return ident

    def snapshot(self) -> None:
        """One coordinated cut: every live engine snapshots to an
        immutable cut-numbered file, then the manifest (identity =
        pool config + the engine-key set) lands LAST via the atomic
        rename — see the module docstring for the crash story.
        Superseded cut files are GC'd only after the new manifest is
        durable."""
        if not self.checkpoint_path:
            raise ValueError("no checkpoint_path configured")
        self._cut += 1
        cut = self._cut
        d = self._pool_path()
        base = os.path.basename(self.checkpoint_path)
        new_files: set = set()
        engines_meta: dict = {}
        for keystr in list(self._order):
            eng = self._engines[keystr]
            path = os.path.join(
                d, f"{base}.c{cut:05d}.{self._fs_key(keystr)}")
            eng.client_state["pool_id"] = self.pool_id
            eng.client_state["engine_key"] = keystr
            eng.checkpoint_path = path
            eng.snapshot()
            eng.checkpoint_path = None
            new_files.add(path)
            engines_meta[keystr] = {
                "state": "live", "path": os.path.basename(path),
                "phase": int(eng.phase), "idle": eng.idle,
                "pending": int(eng.pending),
                "resident": int(eng.resident),
                "totals": self._wrapper_totals(
                    self._wrappers[keystr]),
            }
        for keystr, info in self._parked.items():
            engines_meta[keystr] = {
                "state": "parked",
                "path": os.path.basename(info["path"]),
                "phase": int(info["phase"]), "idle": info["idle"],
                "pending": int(info["pending"]),
                "resident": int(info["resident"]),
                "totals": info["totals"], "seq": info["seq"],
            }
            new_files.add(info["path"])
        totals = {
            "turn": self.turn,
            "next_grid": self._next_grid,
            "cut": cut,
            "pool_id": self.pool_id,
            "park_seq": self._park_seq,
            "order": list(self._order),
            "last_used": {k: int(v)
                          for k, v in self._last_used.items()},
            "engines": engines_meta,
            "rid_maps": {k: {str(l): int(g)
                             for l, g in w._rid_map.items()}
                         for k, w in self._wrappers.items()},
            "local_entries": {k: int(w._local_entries)
                              for k, w in self._wrappers.items()},
            "taken": {k: [int(v[0]), int(v[1])]
                      for k, v in self._taken.items()},
            "backlog": [dataclasses.asdict(r) for r in self._backlog],
            "inflight": {str(g): dataclasses.asdict(r)
                         for g, r in self._inflight.items()},
            "gmap": {str(g): [k, int(l)]
                     for g, (k, l) in self._gmap.items()},
            "completed": [dataclasses.asdict(c)
                          for c in self.completed],
            "shed": [dataclasses.asdict(s) for s in self.shed],
            "tokens": dict(self._tokens),
            "token_waits": {str(k): int(v)
                            for k, v in self._token_waits.items()},
            "client_state": dict(self.client_state),
            # the lease ledger rides the cut: a resumed
            # pool replays the identical lease decisions (streaks are
            # the hysteresis state; given/recv replay the counters)
            "lease": {
                "idle_streak": {k: int(v) for k, v in
                                self._idle_streak.items()},
                "given": {k: int(v) for k, v in
                          self._lease_given.items()},
                "recv": {k: int(v) for k, v in
                         self._lease_recv.items()},
                "boundaries": int(self._boundaries),
                "overlapped": int(self._overlapped),
                "boundary_wall": float(self._boundary_wall),
                "overlap_wall": float(self._overlap_wall),
            },
        }
        writer = None
        if self.checkpoint_background:
            writer = background_writer()
        # manifest-LAST discipline in background mode: the per-engine
        # cut files above were submitted to the same single-thread
        # FIFO writer (each engine was built with
        # checkpoint_background), so the manifest job below cannot
        # land before them — and the GC job after it cannot run
        # before the manifest is durable
        save_family_checkpoint(
            self.checkpoint_path,
            identity=self._manifest_identity(engines_meta),
            bag_cols={}, count=0, acc=np.zeros((2, 1)),
            totals=totals, writer=writer)
        stale = self._cut_files - new_files

        def _gc(paths=frozenset(stale)):
            for p in paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass

        if writer is not None:
            writer.submit(_gc)
        else:
            _gc()
        self._cut_files = new_files
        self.telemetry.event(
            "dispatch_checkpoint", turn=self.turn, cut=cut,
            engines=len(engines_meta), backlog=len(self._backlog),
            inflight=len(self._inflight),
            completed=len(self.completed))
        if self.fault_injector is not None:
            # the injector mutates the manifest FILE — a background
            # cut must be fully durable before the hook fires
            if writer is not None:
                writer.flush()
            self.fault_injector.on_checkpoint_write(
                self.checkpoint_path)

    @classmethod
    def resume(cls, checkpoint_path: str, family: str,
               **kwargs) -> "EngineDispatcher":
        """Rebuild the whole pool from its last coordinated cut: the
        manifest's engine-key set must match the per-engine files
        (each checked against its own checkpoint identity AND the
        stamped pool id), the routing ledger and grid maps restore,
        live engines resume in their stored round-robin order, and
        the continued mixed stream replays bit-identically. A
        manifest from a different pool configuration — or one whose
        engine-key set differs from its per-engine snapshots —
        refuses with the checkpoint module's refusing-to-blend
        contract."""
        disp = cls(family, checkpoint_path=checkpoint_path, **kwargs)
        stored = peek_checkpoint_identity(checkpoint_path)
        want = disp._manifest_identity_base()
        got_base = {k: v for k, v in stored.items() if k != "keys"}
        if got_base != want:
            diff = {k: (got_base.get(k), want.get(k))
                    for k in set(got_base) | set(want)
                    if got_base.get(k) != want.get(k)}
            raise ValueError(
                f"dispatch manifest {checkpoint_path!r} belongs to a "
                f"different pool configuration; refusing to blend "
                f"(stored vs requested): {diff}")
        ident = dict(want, keys=stored.get("keys", ""))
        _, _, _, totals = load_family_checkpoint(checkpoint_path,
                                                 ident)
        engines_meta = totals["engines"]
        listed = ",".join(sorted(engines_meta))
        if listed != ident["keys"]:
            raise ValueError(
                f"dispatch manifest {checkpoint_path!r} engine-key "
                f"set differs from its per-engine snapshot list "
                f"({ident['keys']!r} vs {listed!r}); refusing to "
                f"blend")
        disp.pool_id = totals["pool_id"]
        disp.turn = int(totals["turn"])
        disp._next_grid = int(totals["next_grid"])
        disp._cut = int(totals["cut"])
        disp._park_seq = int(totals["park_seq"])
        disp._last_used = {k: int(v)
                           for k, v in totals["last_used"].items()}
        disp._taken = {k: [int(v[0]), int(v[1])]
                       for k, v in totals["taken"].items()}
        disp._gmap = {int(g): (v[0], int(v[1]))
                      for g, v in totals["gmap"].items()}
        disp._tokens = {str(k): float(v)
                        for k, v in totals["tokens"].items()}
        disp._token_waits = {int(k): int(v)
                             for k, v in totals["token_waits"]
                             .items()}
        disp.client_state = dict(totals.get("client_state", {}))
        # lease ledger (absent in manifests written before leasing:
        # an empty ledger is exactly the pre-lease state). Cumulative
        # counters replay like the retirement ledger below.
        lease = totals.get("lease") or {}
        disp._idle_streak = {k: int(v) for k, v in
                             lease.get("idle_streak", {}).items()}
        disp._lease_given = {k: int(v) for k, v in
                             lease.get("given", {}).items()}
        disp._lease_recv = {k: int(v) for k, v in
                            lease.get("recv", {}).items()}
        disp._boundaries = int(lease.get("boundaries", 0))
        disp._overlapped = int(lease.get("overlapped", 0))
        disp._boundary_wall = float(lease.get("boundary_wall", 0.0))
        disp._overlap_wall = float(lease.get("overlap_wall", 0.0))
        for k, v in disp._lease_given.items():
            disp._c_lease_donated.labels(engine=k).inc(v)
        for k, v in disp._lease_recv.items():
            disp._c_lease_recv.labels(engine=k).inc(v)
        disp._c_boundary.inc(disp._boundaries)
        disp._c_boundary_overlap.inc(disp._overlapped)

        def _theta_in(v):
            return tuple(v) if isinstance(v, list) else v

        def _preq_in(d):
            return PoolRequest(
                grid=int(d["grid"]), key=d["key"],
                theta=_theta_in(d["theta"]),
                bounds=tuple(d["bounds"]),
                submit_turn=int(d["submit_turn"]),
                submit_t=time.perf_counter(),
                tenant=d.get("tenant", "default"),
                priority=int(d.get("priority", 1)),
                deadline_turns=d.get("deadline_turns"),
                routed_turn=d.get("routed_turn"))

        disp._backlog = [_preq_in(d) for d in totals["backlog"]]
        disp._inflight = {int(g): _preq_in(d)
                          for g, d in totals["inflight"].items()}
        disp.completed = [CompletedRequest(
            **{k: (tuple(v) if k == "bounds"
                   else _theta_in(v) if k == "theta" else v)
               for k, v in d.items()}) for d in totals["completed"]]
        disp.shed = [ShedRecord(
            **{k: (tuple(v) if k == "bounds"
                   else _theta_in(v) if k == "theta" else v)
               for k, v in d.items()}) for d in totals["shed"]]
        # pool registry replay: the deterministic ledger rebuilds the
        # pool-scope counters/histograms exactly (same discipline as
        # the engine's _replay_registry)
        for g in disp.completed:
            keystr = disp._gmap.get(g.rid, (None,))[0]
            disp._account_pool_retirement(g, keystr)
        for s in disp.shed:
            disp._c_shed.labels(tenant=s.tenant,
                                reason=s.reason).inc()
        # wrappers + rid maps BEFORE engine resumes (the engines
        # re-open their request spans through the maps)
        for keystr, m in totals["rid_maps"].items():
            wrapper = _EngineTelemetry(disp, keystr)
            wrapper._rid_map = {int(l): int(g) for l, g in m.items()}
            wrapper._local_entries = int(
                totals.get("local_entries", {}).get(keystr, 0))
            disp._wrappers[keystr] = wrapper
        # live rids re-open their pool grid spans in the appended
        # segment — backlog here, inflight through the engine resumes
        # below (the wrapper routes them to the same grid spans)
        for preq in (disp._backlog + sorted(
                disp._inflight.values(), key=lambda r: r.grid)):
            disp._grid_spans[preq.grid] = \
                disp.telemetry.request_span(
                    preq.grid, tenant=preq.tenant,
                    priority=preq.priority,
                    submit_phase=preq.submit_turn, engine=preq.key)
        d = disp._pool_path()
        try:
            for keystr in totals["order"]:
                info = engines_meta[keystr]
                key = EngineKey.parse(keystr)
                wrapper = disp._wrappers[keystr]
                eng = StreamEngine.resume(
                    os.path.join(d, info["path"]), family, key.eps,
                    telemetry=wrapper, **disp._engine_kwargs(key))
                disp._engines[keystr] = eng
                if eng.client_state.get("pool_id") != disp.pool_id:
                    raise ValueError(
                        f"engine snapshot {info['path']!r} belongs to a "
                        f"different pool (stored "
                        f"{eng.client_state.get('pool_id')!r}, manifest "
                        f"{disp.pool_id!r}); refusing to blend")
                eng.checkpoint_path = None
                disp._order.append(keystr)
                disp._taken.setdefault(keystr, [0, 0])
        except BaseException:
            disp.close()        # the engines resumed so far
            raise
        for keystr, info in engines_meta.items():
            if info["state"] != "parked":
                continue
            disp._parked[keystr] = {
                "path": os.path.join(d, info["path"]),
                "seq": int(info.get("seq", 0)),
                "idle": bool(info["idle"]),
                "phase": int(info["phase"]),
                "pending": int(info["pending"]),
                "resident": int(info["resident"]),
                "totals": info["totals"],
            }
        disp._cut_files = {
            os.path.join(d, info["path"])
            for info in engines_meta.values()}
        if disp._slo is not None:
            disp._slo.seed_base(disp.turn)
        disp._publish_gauges()
        disp.telemetry.event(
            "dispatch_resume", turn=disp.turn,
            live=len(disp._engines), parked=len(disp._parked),
            backlog=len(disp._backlog),
            inflight=len(disp._inflight),
            completed=len(disp.completed))
        return disp
