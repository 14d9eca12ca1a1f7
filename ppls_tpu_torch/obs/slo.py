"""SLO burn-rate alerting: the port's copy of the JAX package's
``obs/slo.py`` (host-only Python, stdlib imports).

The per-tenant/per-class SLO accounting (labeled latency histograms,
shed and deadline counters) is a post-hoc summary: nothing watches the
registry during the run and says "tenant pro is burning its latency
budget now". This module is that live signal, in the classic
multiwindow burn-rate shape (fast window catches a cliff, slow window
filters blips):

* **Config** (:func:`parse_slo_config`): declarative per-tenant /
  per-class targets —

  .. code-block:: json

     {"windows": {"fast": 8, "slow": 64},
      "burn_thresholds": {"fast": 8.0, "slow": 2.0},
      "slos": [
        {"slo": "p99_latency_phases", "target": 12,
         "objective": 0.99, "class": "2"},
        {"slo": "deadline_miss_rate", "objective": 0.999,
         "tenant": "pro"},
        {"slo": "shed_fraction", "objective": 0.95}]}

  Windows are device PHASES (the engine's causal clock — wall time is
  nondeterministic and the whole evaluator must be replayable);
  ``tenant``/``class`` scope a target (omitted = all).
* **Evaluator** (:class:`SloEvaluator.evaluate_slo`): a PHASE-BOUNDARY
  hook. It reads ONLY registry values the boundary already published —
  histogram bucket counts and labeled counters — so it adds ZERO
  device fetches. Per SLO it keeps a
  ring of cumulative (bad, total) samples keyed by phase; the burn
  rate over window W at phase p is::

      burn_W = (bad(p) - bad(p-W)) / max(total(p) - total(p-W), 1)
               / (1 - objective)

  i.e. error-rate over the window divided by the error budget rate —
  burn 1.0 consumes the budget exactly at the objective's pace.
* **Alerting**: when BOTH windows exceed their thresholds the SLO is
  BURNING — entering that state emits one ``slo_burn`` event (rate
  attrs rounded, deterministic) and bumps
  ``ppls_slo_burn_total{tenant,class,slo}``; the current burn rates
  are exported as ``ppls_slo_burn_rate{tenant,class,slo,window}``
  gauges every evaluation. Leaving the state re-arms the event.
* **Health verdict** (:meth:`health`): ``{"ok": bool, "burning":
  [...], "phase": p}`` — served by ``obs.server.MetricsServer`` on
  ``GET /health`` so a load balancer gets a yes/no without PromQL.

How "bad" is counted per SLO kind (all from cumulative registry
state, so kill-and-resume replays produce identical series):

* ``p99_latency_phases`` (target = phase budget): bad = histogram
  observations ABOVE the smallest bucket edge >= target (bucket-edge
  semantics, same as the registry quantile), total = observations.
  Scoped by class -> ``ppls_stream_class_retire_latency_phases``,
  by tenant -> the tenant-labeled histogram, unscoped -> the global
  one.
* ``deadline_miss_rate``: bad = ``ppls_stream_deadline_exceeded_total``
  (per tenant or summed), total = retired.
* ``shed_fraction``: bad = ``ppls_requests_shed_total`` (all reasons),
  total = retired + shed (the offered set that got a verdict).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

SLO_KINDS = ("p99_latency_phases", "deadline_miss_rate",
             "shed_fraction")

DEFAULT_WINDOWS = {"fast": 8, "slow": 64}
# conservative defaults in the SRE-multiwindow spirit, scaled to phase
# windows: the fast window must burn hard AND the slow window must
# corroborate before the alert fires
DEFAULT_THRESHOLDS = {"fast": 8.0, "slow": 2.0}


def parse_slo_config(spec) -> dict:
    """Validate/normalize an SLO config (dict, JSON string, or
    ``@file.json``). Raises ``ValueError`` with the offending field —
    the CLI turns that into a usage error before the first phase.
    Idempotent: a normalized config parses to itself (the JAX
    package's re-parse turns an unscoped target's null tenant and class
    into the scope ``"None"``, which matches no request)."""
    if isinstance(spec, str):
        s = spec.strip()
        if s.startswith("@"):
            with open(s[1:], encoding="utf-8") as fh:
                spec = json.load(fh)
        else:
            try:
                spec = json.loads(s)
            except json.JSONDecodeError as e:
                raise ValueError(f"SLO config is not JSON: {e}")
    if not isinstance(spec, dict):
        raise ValueError("SLO config must be a JSON object")
    windows = dict(DEFAULT_WINDOWS, **(spec.get("windows") or {}))
    thresholds = dict(DEFAULT_THRESHOLDS,
                      **(spec.get("burn_thresholds") or {}))
    for k in ("fast", "slow"):
        if not isinstance(windows.get(k), int) or windows[k] < 1:
            raise ValueError(f"windows.{k} must be an int >= 1")
        if not isinstance(thresholds.get(k), (int, float)) \
                or thresholds[k] <= 0:
            raise ValueError(f"burn_thresholds.{k} must be > 0")
    if windows["fast"] > windows["slow"]:
        raise ValueError("windows.fast must be <= windows.slow")
    slos = spec.get("slos")
    if not isinstance(slos, list) or not slos:
        raise ValueError("SLO config needs a non-empty 'slos' list")
    out = []
    for i, s in enumerate(slos):
        if not isinstance(s, dict):
            raise ValueError(f"slos[{i}]: not an object")
        kind = s.get("slo")
        if kind not in SLO_KINDS:
            raise ValueError(
                f"slos[{i}].slo must be one of {SLO_KINDS}, got "
                f"{kind!r}")
        obj = s.get("objective")
        if not isinstance(obj, (int, float)) or not 0 < obj < 1:
            raise ValueError(
                f"slos[{i}].objective must be in (0, 1), got {obj!r}")
        # a null scope is no scope, so a normalized config parses to
        # itself (the serve command validates its flag here and the
        # engine parses the result again)
        norm = {"slo": kind, "objective": float(obj),
                "tenant": (str(s["tenant"])
                           if s.get("tenant") is not None else None),
                "class": (str(s["class"])
                          if s.get("class") is not None else None)}
        if kind != "p99_latency_phases" and norm["class"] is not None:
            # the deadline/shed counters are tenant-labeled only —
            # accepting a class scope here would silently monitor the
            # GLOBAL value while exporting class-labeled gauges
            raise ValueError(
                f"slos[{i}]: {kind} cannot be scoped by class (the "
                f"underlying counters carry no class label); scope "
                f"by tenant or drop the class field")
        if kind == "p99_latency_phases":
            tgt = s.get("target")
            if not isinstance(tgt, (int, float)) or tgt <= 0:
                raise ValueError(
                    f"slos[{i}].target must be a positive phase "
                    f"budget, got {tgt!r}")
            norm["target"] = float(tgt)
        out.append(norm)
    return {"windows": windows, "burn_thresholds": thresholds,
            "slos": out}


def _slo_key(s: dict) -> str:
    return (f"{s['slo']}|tenant={s['tenant'] or '*'}"
            f"|class={s['class'] or '*'}")


class SloEvaluator:
    """Phase-boundary burn-rate evaluator over an engine registry
    (see module docstring). One instance per engine/coordinator;
    ``evaluate_slo(phase)`` at every phase close; ``health()`` for
    the /health verdict.

    ``scope`` names the accounting tier the evaluator
    watches: ``"engine"`` (the default — one StreamEngine's registry)
    or ``"pool"`` (the heterogeneous dispatcher's pool-scope registry,
    where "phase" means dispatcher TURN and the counters/histograms
    aggregate the whole engine pool). The math is identical — the
    dispatcher publishes the same metric names at pool scope — but the
    scope rides every burn event and the health verdict so an alert
    names the tier it fired at."""

    def __init__(self, config: dict, telemetry,
                 scope: str = "engine"):
        self.config = parse_slo_config(config)
        self.telemetry = telemetry
        self.scope = str(scope)
        self.windows = self.config["windows"]
        self.thresholds = self.config["burn_thresholds"]
        # per-slo ring of (phase, bad_cum, total_cum) samples; bounded
        # by the slow window (+1 for the base sample)
        self._rings: Dict[str, List[tuple]] = {
            _slo_key(s): [] for s in self.config["slos"]}
        self._burning: Dict[str, bool] = {
            _slo_key(s): False for s in self.config["slos"]}
        reg = telemetry.registry
        lab = ("tenant", "class", "slo")
        self._c_burn = reg.counter(
            "ppls_slo_burn_total",
            "SLO burn alerts: both burn-rate windows exceeded their "
            "thresholds (one increment per entry into the burning "
            "state)", lab)
        self._g_rate = reg.gauge(
            "ppls_slo_burn_rate",
            "current error-budget burn rate per SLO and window "
            "(1.0 = consuming the budget exactly at the objective's "
            "pace)", lab + ("window",))

    # -- cumulative (bad, total) readers ---------------------------------

    def _hist_children(self, s: dict):
        reg = self.telemetry.registry
        if s["class"] is not None:
            fam = reg.get("ppls_stream_class_retire_latency_phases")
            want = (s["class"],)
        elif s["tenant"] is not None:
            fam = reg.get("ppls_stream_tenant_retire_latency_phases")
            want = (s["tenant"],)
        else:
            fam = reg.get("ppls_stream_retire_latency_phases")
            want = ()
        if fam is None:
            return []
        return [child for key, child in fam.items()
                if not want or key == want]

    def _counter_sum(self, name: str, tenant: Optional[str]) -> float:
        fam = self.telemetry.registry.get(name)
        if fam is None:
            return 0.0
        total = 0.0
        for key, child in fam.items():
            kv = dict(zip(fam.labelnames, key))
            if tenant is not None and kv.get("tenant") != tenant:
                continue
            total += child.value
        return total

    def _sample(self, s: dict):
        """Cumulative (bad, total) for one SLO from registry state."""
        kind = s["slo"]
        if kind == "p99_latency_phases":
            bad = total = 0
            for h in self._hist_children(s):
                total += h.count
                cum_le = 0
                for edge, c in zip(h.edges, h.counts):
                    if edge <= s["target"]:
                        cum_le += c
                    else:
                        break
                bad += h.count - cum_le
            return bad, total
        if kind == "deadline_miss_rate":
            bad = self._counter_sum(
                "ppls_stream_deadline_exceeded_total", s["tenant"])
            total = self._counter_sum(
                "ppls_stream_tenant_retired_total", s["tenant"])
            return bad, total
        # shed_fraction: offered = retired + shed
        bad = self._counter_sum("ppls_requests_shed_total",
                                s["tenant"])
        total = bad + self._counter_sum(
            "ppls_stream_tenant_retired_total", s["tenant"])
        return bad, total

    def seed_base(self, phase: int) -> None:
        """Resume re-base: a resumed engine's registry holds the
        REPLAYED cumulative counts but the evaluator's window ring is
        empty — without a base sample the first evaluations would
        report the ALL-TIME error rate as the windowed burn and fire
        spurious alerts on a healthy service. Seeding one sample at
        the restored phase makes post-resume windows measure deltas
        since the resume point (windows re-base at resume; the
        cumulative registry state itself stays bit-identical)."""
        for s in self.config["slos"]:
            ring = self._rings[_slo_key(s)]
            if not ring:
                bad, total = self._sample(s)
                ring.append((int(phase), float(bad), float(total)))

    # -- the boundary hook ------------------------------------------------

    def _burn(self, ring: List[tuple], phase: int, window: int
              ) -> float:
        """Burn rate over the trailing ``window`` phases from the
        cumulative ring (newest sample last). When the ring is
        younger than the window, the OLDEST sample is the base — a
        fresh run's explicit zero base, or a resumed run's
        ``seed_base`` sample (never an implicit (0, 0), which would
        report the ALL-TIME rate as a windowed burn after a resume
        replayed the cumulative registry)."""
        bad_now, tot_now = ring[-1][1], ring[-1][2]
        base_bad, base_tot = ring[0][1], ring[0][2]
        floor = phase - window
        for p, b, t in ring:
            if p <= floor:
                base_bad, base_tot = b, t
            else:
                break
        dbad = bad_now - base_bad
        dtot = tot_now - base_tot
        return dbad / max(dtot, 1.0)

    def evaluate_slo(self, phase: int) -> List[dict]:
        """One phase-boundary evaluation: sample every SLO, update the
        burn-rate gauges, and emit ``slo_burn`` on entry into the
        burning state. Returns the currently-burning SLO descriptors
        (the health verdict's payload). Pure host arithmetic on
        registry values already published this boundary."""
        burning: List[dict] = []
        for s in self.config["slos"]:
            key = _slo_key(s)
            ring = self._rings[key]
            bad, total = self._sample(s)
            if not ring:
                # fresh-run cold start: the cumulative state really
                # was zero before the first observed phase (resumed
                # engines re-based already via seed_base)
                ring.append((int(phase) - 1, 0.0, 0.0))
            ring.append((int(phase), float(bad), float(total)))
            # keep one sample at/below the slow-window floor as the
            # delta base; drop everything older
            floor = int(phase) - self.windows["slow"]
            while len(ring) > 1 and ring[1][0] <= floor:
                ring.pop(0)
            budget = 1.0 - s["objective"]
            rates = {}
            for w in ("fast", "slow"):
                err = self._burn(ring, int(phase), self.windows[w])
                rates[w] = err / budget
            labels = dict(tenant=s["tenant"] or "*",
                          **{"class": s["class"] or "*"},
                          slo=s["slo"])
            for w, r in rates.items():
                self._g_rate.labels(window=w, **labels).set(r)
            is_burning = all(rates[w] >= self.thresholds[w]
                             for w in ("fast", "slow"))
            if is_burning:
                desc = dict(labels, phase=int(phase),
                            scope=self.scope,
                            fast_burn=round(rates["fast"], 6),
                            slow_burn=round(rates["slow"], 6))
                burning.append(desc)
                if not self._burning[key]:
                    self._c_burn.labels(**labels).inc()
                    self.telemetry.event("slo_burn", **desc)
            self._burning[key] = is_burning
        self._last_phase = int(phase)
        self._last_burning = burning
        return burning

    def health(self) -> dict:
        """The /health verdict: ok iff nothing is burning, with the
        burning SLO descriptors attached."""
        burning = getattr(self, "_last_burning", [])
        return {"ok": not burning, "burning": burning,
                "phase": getattr(self, "_last_phase", -1),
                "scope": self.scope}
