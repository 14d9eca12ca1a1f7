"""Per-chip flight recorder: the port's copy of the JAX package's
``obs/flight.py`` (host-only Python).

The walker-dd stream's phase span closes with the mesh's summed counter
deltas; a straggling rank would be invisible there. This module turns
the per-rank values the phase boundary already read (the one gather of
every rank's counters) into:

* one ``chip`` child span per rank under the open ``phase`` span,
  closing with that rank's deltas (kernel steps, tasks, lane-waste
  buckets), its bank occupancy (live rows) and the phase's occupancy
  delta;
* a ``collective_boundary`` event when the phase paid lockstep
  collective rounds (the ``crounds`` delta);
* registry gauges for the ranks' bank-occupancy max/min/spread and work
  share max/min (``Telemetry.publish_chip_balance``);
* a straggler detector: a rank whose share of the phase's kernel steps
  exceeds ``straggler_share`` for ``straggler_phases`` consecutive
  phases emits a ``straggler`` event and bumps
  ``ppls_straggler_events_total``; the streak then restarts.

Every attribute but the timestamps comes from device counts, so the
timeline is bit-stable across reruns and kill-and-resume.
"""

from __future__ import annotations

from typing import Optional

from ppls_tpu_torch.obs.telemetry import WASTE_BUCKETS, Telemetry


class ChipFlightRecorder:
    """Boundary-hook publisher of per-rank phase attribution.

    ``record_phase`` is called while the phase span is open (the chip
    spans nest under the innermost open span) and only with host values
    the boundary already holds: it does no device work of its own.
    ``labels`` maps a positional index to the reported unit id."""

    def __init__(self, telemetry: Telemetry, n_dev: int,
                 engine: str = "walker-dd-stream",
                 straggler_share: Optional[float] = None,
                 straggler_phases: int = 3,
                 span_name: str = "chip",
                 labels=None):
        self.tel = telemetry
        self.n_dev = int(n_dev)
        self.engine = engine
        self.span_name = str(span_name)
        self.labels = (list(labels) if labels is not None
                       else list(range(self.n_dev)))
        if len(self.labels) != self.n_dev:
            raise ValueError(
                f"labels must have one entry per unit: "
                f"{len(self.labels)} != {self.n_dev}")
        # default threshold: 2x the fair share, capped below 1 so a
        # 2-rank mesh can still trip it
        self.straggler_share = (float(straggler_share)
                                if straggler_share is not None
                                else min(0.9, 2.0 / max(n_dev, 1)))
        self.straggler_phases = max(int(straggler_phases), 1)
        self._streak = [0] * self.n_dev
        lab = ("engine",)
        reg = telemetry.registry
        self._c_straggler = reg.counter(
            "ppls_straggler_events_total",
            "chips whose kernel-step share exceeded the straggler "
            "threshold for the configured number of consecutive "
            "phases", lab).labels(engine=engine)
        self._g_occ_max = reg.gauge(
            "ppls_chip_occupancy_max",
            "largest per-chip live-row (bank occupancy) count after "
            "the last phase", lab).labels(engine=engine)
        self._g_occ_min = reg.gauge(
            "ppls_chip_occupancy_min",
            "smallest per-chip live-row (bank occupancy) count after "
            "the last phase", lab).labels(engine=engine)
        self._g_occ_spread = reg.gauge(
            "ppls_chip_occupancy_spread",
            "per-chip live-row max/min ratio after the last phase "
            "(1.0 = perfectly balanced)", lab).labels(engine=engine)

    def record_phase(self, phase: int, *, wsteps, tasks, live_rows,
                     bank_delta, waste=None, crounds: int = 0,
                     rids=None) -> None:
        """One phase's per-rank attribution: host sequences of per-rank
        values (deltas for ``wsteps``/``tasks``/``waste``, absolutes for
        ``live_rows``). ``rids``, when given, holds one list of request
        ids per unit, stamped on its span."""
        tel = self.tel
        n = self.n_dev
        wsteps = [int(v) for v in wsteps]
        total_steps = sum(wsteps)
        for chip in range(n):
            attrs = dict(wsteps=wsteps[chip], tasks=int(tasks[chip]),
                         live_rows=int(live_rows[chip]),
                         bank_delta=int(bank_delta[chip]))
            if rids is not None and chip < len(rids):
                attrs["rids"] = [int(r) for r in rids[chip]]
            if waste is not None:
                for k, v in zip(WASTE_BUCKETS, waste[chip]):
                    attrs[k] = int(v)
            # opened and closed back to back: the span carries the
            # attribution in a shape timeline viewers nest; a rank's
            # duration is not measured on the host
            tel.span(self.span_name,
                     **{self.span_name: self.labels[chip]}).close(**attrs)
        if crounds:
            tel.event("collective_boundary", phase=int(phase),
                      crounds=int(crounds))

        rows = [int(v) for v in live_rows]
        mx, mn = max(rows), min(rows)
        self._g_occ_max.set(mx)
        self._g_occ_min.set(mn)
        self._g_occ_spread.set(mx / max(mn, 1))
        if total_steps > 0:
            tel.publish_chip_balance(self.engine, wsteps)

        # the straggler detector is undefined on one rank (its share is
        # always 1.0)
        if n < 2:
            return
        for chip in range(n):
            share = (wsteps[chip] / total_steps) if total_steps else 0.0
            if total_steps and share > self.straggler_share:
                self._streak[chip] += 1
            else:
                self._streak[chip] = 0
            if self._streak[chip] >= self.straggler_phases:
                self._c_straggler.inc()
                tel.event("straggler", chip=self.labels[chip],
                          phase=int(phase), share=round(share, 4),
                          phases=self._streak[chip],
                          threshold=round(self.straggler_share, 4))
                self._streak[chip] = 0
