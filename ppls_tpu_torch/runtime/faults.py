"""Seeded fault injection: deterministic chaos for the recovery stack.

The port's copy of the JAX package's ``runtime/faults.py`` (host-only
Python, imports changed): the same kinds, the same spec forms and the
same seeded draws, so one seed names one schedule in both packages.

The reference program has exactly one failure story — any rank dying
hangs the farmer's blocking recv forever (``aquadPartA.c:145``). This
module makes failure a FIRST-
CLASS, REPRODUCIBLE input: a :class:`FaultPlan` is a seeded schedule
of fault events, and a :class:`FaultInjector` fires them at the
boundaries the engines already own — phase open/close, checkpoint
write, stream admission — so every recovery path can be exercised
end-to-end, deterministically, in CI.

Fault taxonomy (``FAULT_KINDS``):

* ``chip_loss``     — raise :class:`guard.ChipLossError` at a phase
  boundary: the supervisor resize-resumes the latest snapshot onto the
  surviving mesh (the elastic ``mesh_resize`` checkpoint rule);
* ``crash``         — raise :class:`guard.InjectedCrash` at a phase
  boundary: classified transient, recovered by backoff + resume;
* ``hang``          — block the engine thread at a phase boundary (a
  wedged device): the watchdog deadline fires and the supervisor
  resumes. Default ``seconds`` is effectively forever — the hung
  attempt's daemonized thread must NOT wake up mid-recovery and race
  the resumed run (guard.py's deadline-sizing contract);
* ``straggler``     — sleep ``seconds`` at a phase boundary and
  continue: a slow chip/host, visible as wall time without any state
  damage;
* ``nan_poison``    — corrupt one admitted request's theta payload to
  NaN AFTER submit-time validation (poison that slipped past the
  gate): the engine genuinely computes with it, the slot's area goes
  non-finite, and the quarantine retire path must contain it while
  healthy co-resident requests retire normally;
* ``sigterm``       — deliver SIGTERM to this process at a phase
  boundary: the deterministic spelling of the orchestrator
  kill the zero-downtime-restart contract is tested against — the
  serve loop's GracefulShutdown must final-checkpoint, close the span
  timeline balanced, and exit 0, and the ``serve --checkpoint``
  restart must resume with zero lost acknowledged requests;
* ``host_loss``     — SIGKILL a chosen WORKER PROCESS at a phase
  boundary: the cluster coordinator installs
  ``host_kill_fn`` so the event kills a real process (the loss then
  surfaces at the next RPC, like a real dead host); without the hook
  (single-process engines) it raises :class:`guard.HostLossError`
  directly. Opt-in like ``sigterm`` — deliberately excluded from the
  seeded-schedule pool so existing seeds keep their schedules;
* ``ckpt_truncate`` — truncate the snapshot file just written (a
  crash mid-upload / out-of-disk shape);
* ``ckpt_corrupt``  — flip one byte in the middle of the snapshot
  just written (bit rot): both must surface as
  :class:`runtime.checkpoint.CheckpointCorruptError` at resume, never
  as unpickled garbage.

Every injected fault emits a ``fault_injected`` telemetry event and
counts into ``ppls_faults_injected_total{kind}``, so a chaos run's
recovery timeline is attribution-backed: each recovery in the events
file pairs with the fault that caused it.

Arming: ``python -m ppls_tpu_torch serve --fault-plan SPEC`` or
``PPLS_FAULT_PLAN`` (CLI wins). SPEC is inline JSON (a list of event
objects), ``@file`` holding the same, or ``seed:<n>[:<k>]`` for a
generated schedule of ``k`` events drawn deterministically from seed
``n`` (:meth:`FaultPlan.seeded`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import List, Optional

import numpy as np

from ppls_tpu_torch.runtime.guard import (ChipLossError, HostLossError,
                                          InjectedCrash)

FAULT_KINDS = ("chip_loss", "crash", "hang", "straggler", "nan_poison",
               "ckpt_truncate", "ckpt_corrupt", "sigterm",
               "host_loss")

# kinds keyed on the PHASE index (fire at a phase boundary); the
# others key on the request rid (nan_poison) or the checkpoint-write
# index (ckpt_*). NOTE: sigterm and host_loss are
# phase-keyed too but deliberately NOT in PHASE_KINDS — seeded
# schedule generation draws from PHASE_KINDS, and appending there
# would silently change every existing seed's schedule (the
# same-seed-same-schedule contract, regression-pinned in
# tests/test_faults.py).
PHASE_KINDS = ("chip_loss", "crash", "hang", "straggler")
_EDGE_KINDS = PHASE_KINDS + ("sigterm", "host_loss")

# an injected hang must outlive any plausible watchdog deadline: the
# wedged thread is daemonized and must sleep until process exit, never
# wake mid-recovery and race the resumed run on the snapshot path
HANG_FOREVER_S = 1 << 20

ENV_FAULT_PLAN = "PPLS_FAULT_PLAN"


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault. ``at`` is the phase index for
    :data:`PHASE_KINDS`, the request rid for ``nan_poison``, and the
    checkpoint-write ordinal for ``ckpt_truncate``/``ckpt_corrupt``.
    ``edge`` picks the phase-open or phase-close boundary for
    phase-keyed kinds. Each event fires exactly once."""

    kind: str
    at: int
    chip: Optional[int] = None        # chip_loss: which chip dies
    #                                   (default: the highest index)
    seconds: float = 0.0              # hang/straggler duration
    edge: str = "open"                # "open" | "close"
    fired: bool = False

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if self.edge not in ("open", "close"):
            raise ValueError(
                f"fault edge must be 'open' or 'close', got "
                f"{self.edge!r}")
        self.at = int(self.at)
        if self.kind == "hang" and not self.seconds:
            self.seconds = float(HANG_FOREVER_S)

    def describe(self) -> dict:
        d = {"kind": self.kind, "at": self.at}
        if self.chip is not None:
            d["chip"] = int(self.chip)
        if self.seconds:
            d["seconds"] = float(self.seconds)
        if self.edge != "open":
            d["edge"] = self.edge
        return d


class FaultPlan:
    """An ordered, seeded schedule of :class:`FaultEvent`."""

    def __init__(self, events: List[FaultEvent], seed: Optional[int] = None):
        self.events = list(events)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.events)

    def to_json(self) -> str:
        return json.dumps([e.describe() for e in self.events])

    @classmethod
    def from_events(cls, specs, seed: Optional[int] = None
                    ) -> "FaultPlan":
        return cls([FaultEvent(**d) for d in specs], seed=seed)

    @classmethod
    def seeded(cls, seed: int, n_events: int = 4, horizon: int = 12,
               kinds=PHASE_KINDS + ("nan_poison",)) -> "FaultPlan":
        """Deterministic schedule generation: ``n_events`` faults drawn
        from ``kinds`` with phases/rids in ``[1, horizon)``. The same
        seed always yields the same schedule (``np.random.default_rng``
        is sequence-stable), which is the whole point: a chaos failure
        reproduces from its seed."""
        rng = np.random.default_rng(int(seed))
        events = []
        for _ in range(int(n_events)):
            kind = str(rng.choice(list(kinds)))
            at = int(rng.integers(1, max(int(horizon), 2)))
            ev = FaultEvent(kind=kind, at=at)
            if kind == "straggler":
                ev.seconds = float(rng.integers(1, 4)) * 0.05
            events.append(ev)
        events.sort(key=lambda e: (e.at, e.kind))
        return cls(events, seed=int(seed))

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> Optional["FaultPlan"]:
        """Parse a ``--fault-plan`` / ``PPLS_FAULT_PLAN`` spec: inline
        JSON list, ``@file.json``, or ``seed:<n>[:<k>]``. None/empty
        disarms (returns None)."""
        if not spec:
            return None
        spec = spec.strip()
        if spec.startswith("seed:"):
            parts = spec.split(":")
            seed = int(parts[1])
            n = int(parts[2]) if len(parts) > 2 else 4
            return cls.seeded(seed, n_events=n)
        if spec.startswith("@"):
            with open(spec[1:], encoding="utf-8") as fh:
                data = json.load(fh)
        else:
            data = json.loads(spec)
        if isinstance(data, dict):
            data = data.get("events", [])
        return cls.from_events(data)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        return cls.from_spec(os.environ.get(ENV_FAULT_PLAN))


class FaultInjector:
    """Consults a :class:`FaultPlan` at the engine boundaries and fires
    matching events (once each), emitting the attribution trail.

    The injector OUTLIVES engine attempts: the serve CLI builds one per
    run and threads it through every engine it constructs, so an event
    consumed before a crash does not re-fire in the resumed attempt.
    """

    def __init__(self, plan: FaultPlan, telemetry=None):
        self.plan = plan
        self.telemetry = telemetry
        self.ckpt_writes = 0
        self._lock = threading.Lock()
        # the cluster coordinator installs its real-process
        # killer here so host_loss events SIGKILL a worker; None (the
        # single-process engines) raises HostLossError directly
        self.host_kill_fn = None

    # -- internals ---------------------------------------------------------

    def _take(self, kinds, at: int, edge: Optional[str] = None
              ) -> List[FaultEvent]:
        """Atomically claim the unfired events matching (kinds, at,
        edge). Claiming before firing keeps a fault one-shot even when
        a wedged attempt's daemon thread later reaches the same
        boundary as the recovered run."""
        with self._lock:
            out = []
            for ev in self.plan.events:
                if ev.fired or ev.kind not in kinds or ev.at != at:
                    continue
                if edge is not None and ev.kind in _EDGE_KINDS \
                        and ev.edge != edge:
                    continue
                ev.fired = True
                out.append(ev)
            return out

    def _emit(self, ev: FaultEvent, **ctx) -> None:
        if self.telemetry is not None:
            self.telemetry.event("fault_injected", **ev.describe(),
                                 **ctx)
            self.telemetry.registry.counter(
                "ppls_faults_injected_total",
                "fault-plan events fired, by kind",
                ("kind",)).labels(kind=ev.kind).inc()

    # -- engine hooks ------------------------------------------------------

    def _phase_edge(self, phase: int, edge: str, n_dev: int) -> None:
        for ev in self._take(_EDGE_KINDS, int(phase), edge=edge):
            self._emit(ev, phase=int(phase))
            if ev.kind == "sigterm":
                # the orchestrator-kill shape: deliver the real signal
                # so the serve loop's GracefulShutdown machinery (not
                # a test double) handles it at the next boundary
                import signal as _signal
                os.kill(os.getpid(), _signal.SIGTERM)
            elif ev.kind == "straggler":
                time.sleep(ev.seconds)
            elif ev.kind == "hang":
                # a wedged device: block this (daemonizable) thread
                # until past any watchdog; Event.wait, not time.sleep,
                # so no-op sleep monkeypatches in tests cannot defuse it
                threading.Event().wait(ev.seconds)
            elif ev.kind == "crash":
                raise InjectedCrash(
                    f"fault plan: phase-boundary crash at phase "
                    f"{phase}")
            elif ev.kind == "chip_loss":
                chip = ev.chip if ev.chip is not None else n_dev - 1
                raise ChipLossError(chip, n_dev,
                                    detail="fault plan injection")
            elif ev.kind == "host_loss":
                if self.host_kill_fn is not None:
                    # kill a REAL worker process: the loss surfaces
                    # at the coordinator's next RPC to it, exactly
                    # like an un-injected dead host
                    self.host_kill_fn(ev.chip)
                else:
                    proc = ev.chip if ev.chip is not None \
                        else n_dev - 1
                    raise HostLossError(proc, n_dev,
                                        detail="fault plan injection")

    def on_phase_open(self, phase: int, n_dev: int = 1) -> None:
        """Phase-open boundary (before admission): crashes here model
        the worst resume point — admissions scheduled for this phase
        replay in the recovered run."""
        self._phase_edge(phase, "open", n_dev)

    def on_phase_close(self, phase: int, n_dev: int = 1) -> None:
        self._phase_edge(phase, "close", n_dev)

    def on_admit(self, rid: int) -> bool:
        """Stream-admission boundary: True = poison this request's
        theta payload to NaN (post-validation — poison that slipped the
        gate)."""
        evs = self._take(("nan_poison",), int(rid))
        for ev in evs:
            self._emit(ev, rid=int(rid))
        return bool(evs)

    def on_checkpoint_write(self, path: str) -> None:
        """Checkpoint-write boundary: damage the snapshot JUST written
        (after its atomic rename — the damage models later media rot /
        mid-upload truncation, not a torn write)."""
        with self._lock:
            idx = self.ckpt_writes
            self.ckpt_writes += 1
        for ev in self._take(("ckpt_truncate", "ckpt_corrupt"), idx):
            self._emit(ev, path=path, write_index=idx)
            size = os.path.getsize(path)
            if ev.kind == "ckpt_truncate":
                with open(path, "r+b") as fh:
                    fh.truncate(max(size // 2, 1))
            else:
                with open(path, "r+b") as fh:
                    fh.seek(size // 2)
                    b = fh.read(1)
                    fh.seek(size // 2)
                    fh.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
