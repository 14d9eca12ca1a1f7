"""The port's serve-side host modules against the reference's, on the CPU.

* ``runtime/guard.py``: deterministic backoff, the retry budget and its
  counter, watchdog-resume provenance, the failure taxonomy (a CUDA
  error is ``fatal``: no transient marker occurs in PyTorch's CUDA
  error text or in the port's launch errors), the supervisor's
  recoveries and the cooperative SIGTERM flag (tests/test_faults.py,
  tests/test_guard.py);
* ``runtime/faults.py``: the same seeded schedules as the reference for
  the same seeds, the spec forms, each event firing once with its
  attribution, checkpoint damage refused by the port's loader;
* the engine's fault boundaries: ``nan_poison`` retired as a failed
  record beside healthy requests through the float64 rounds, K1 and K2
  (plain segments here), held against the reference engine under the
  same plan; a chip loss on one card gives up; ``mesh_resize`` at equal
  sizes resumes, another mesh size is refused;
* ``runtime/ingest.py`` and ``obs/server.py``: request-record parsing,
  the ingest endpoint's per-line verdicts, ``/metrics`` and ``/health``;
* ``utils/artifact_schema.py``: the serve-ledger and events validators
  return the reference's problem lists on valid and broken texts;
* ``utils/cuda_build.py``: concurrent first uses build a library once.
"""

import http.client
import json
import os
import signal
import threading
import urllib.request

import numpy as np
import pytest
import torch

from ppls_tpu.runtime import faults as RF
from ppls_tpu.runtime import guard as RG
from ppls_tpu.runtime import ingest as RIn
from ppls_tpu.runtime.stream import StreamEngine as RefEngine
from ppls_tpu.utils import artifact_schema as RA
from ppls_tpu_torch.obs.registry import MetricsRegistry
from ppls_tpu_torch.obs.server import MetricsServer
from ppls_tpu_torch.obs.telemetry import Telemetry, default_telemetry, \
    set_default
from ppls_tpu_torch.parallel import walker as TW
from ppls_tpu_torch.runtime import faults as TF
from ppls_tpu_torch.runtime import guard as TG
from ppls_tpu_torch.runtime import ingest as TIn
from ppls_tpu_torch.runtime.checkpoint import (CheckpointCorruptError,
                                               load_family_checkpoint,
                                               save_family_checkpoint)
from ppls_tpu_torch.runtime.stream import StreamEngine
from ppls_tpu_torch.utils import artifact_schema as TA
from ppls_tpu_torch.utils import cuda_build

FAM = "sin_recip_scaled"
BOUNDS = (1e-2, 1.0)
EPS = 1e-6
# tests/test_faults.py's stream configuration
KW = dict(slots=8, chunk=1 << 10, capacity=1 << 16, lanes=256,
          roots_per_lane=2, refill_slots=2, seg_iters=32,
          min_active_frac=0.05)
THETA4 = [1.0, 1.25, 1.5, 2.0]


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


def _quiet(_msg):
    pass


# ---------------------------------------------------------------------------
# guard
# ---------------------------------------------------------------------------


def test_backoff_schedule_is_the_reference_schedule():
    for base, cap in ((1.0, 60.0), (0.25, 30.0), (10.0, 120.0)):
        got = [TG.backoff_seconds(a, base, cap) for a in range(0, 12)]
        assert got == [RG.backoff_seconds(a, base, cap)
                       for a in range(0, 12)]
    assert [TG.backoff_seconds(a, base=1.0, cap=60.0)
            for a in range(1, 6)] == [1.0, 2.0, 4.0, 8.0, 16.0]
    assert TG.TRANSIENT_MARKERS == RG.TRANSIENT_MARKERS
    assert TG.MAX_ATTEMPTS == RG.MAX_ATTEMPTS


def test_with_retry_budget_and_counter(monkeypatch):
    prev = set_default(Telemetry())
    try:
        calls = []

        def flaky():
            calls.append(1)
            raise RuntimeError("Connection reset by peer")

        with pytest.raises(TG.RetryBudgetExhausted,
                           match="total retry deadline"):
            TG.with_retry(flaky, [], deadline=5.0, total_deadline=1.0,
                          log=_quiet)
        assert len(calls) == 1
        monkeypatch.setattr(TG.time, "sleep", lambda s: None)
        seen = []

        def flaky2():
            seen.append(1)
            if len(seen) < 3:
                raise RuntimeError("Connection reset by peer")
            return "ok"

        log = []
        assert TG.with_retry(flaky2, log, deadline=5.0, log=_quiet) == "ok"
        assert len(log) == 2
        assert default_telemetry().registry.value(
            "ppls_retries_total", reason="transient") == 2
        with pytest.raises(FloatingPointError):
            TG.with_retry(lambda: (_ for _ in ()).throw(
                FloatingPointError("nan")), [], deadline=5.0, log=_quiet)
    finally:
        set_default(prev)


def test_run_with_watchdog_records_resume_provenance():
    tel = Telemetry()
    events = []
    orig = tel.event
    tel.event = lambda name, **a: (events.append((name, a)),
                                   orig(name, **a))
    out = TG.run_with_watchdog(
        lambda: threading.Event().wait(5), 0.2,
        resume_fn=lambda: "recovered", log=_quiet, telemetry=tel,
        checkpoint_path="/x.ckpt")
    assert out == "recovered"
    names = [n for n, _ in events]
    attrs = dict(events[names.index("watchdog_resume")][1])
    assert attrs["checkpoint"] == "/x.ckpt" and attrs["attempt"] == 2
    with pytest.raises(TG.HangTimeout, match="watchdog deadline"):
        TG.run_with_watchdog(lambda: threading.Event().wait(5), 0.1,
                             log=_quiet)


TAXONOMY = [
    (lambda G: G.ChipLossError(1, 8), "chip_loss"),
    (lambda G: G.HostLossError(1, 2), "host_loss"),
    (lambda G: FloatingPointError("nan"), "poison"),
    (lambda G: G.HangTimeout("watchdog deadline"), "transient"),
    (lambda G: G.InjectedCrash("x"), "transient"),
    (lambda G: RuntimeError("Connection reset"), "transient"),
    (lambda G: RuntimeError("sizing mismatch"), "fatal"),
    (lambda G: G.RetryBudgetExhausted(
        "total retry deadline 1s ... last failure: INTERNAL: tunnel "
        "drop"), "fatal"),
]


@pytest.mark.parametrize("case", range(len(TAXONOMY)))
def test_classify_failure_taxonomy_matches_reference(case):
    make, kind = TAXONOMY[case]
    assert TG.classify_failure(make(TG)) == kind
    assert RG.classify_failure(make(RG)) == kind


def _port_launch_errors():
    """The texts ``parallel/walker.py``'s ``_launch`` raises for each of
    the kernels' return codes, and for a CUDA error code."""
    return [f"walk_rf segment launch failed: {v}"
            for v in TW._KERNEL_ERRORS.values()] + [
        "walk_ee segment launch failed: cudaError 700",
        "walk_rf: the occupancy query failed"]


# PyTorch's CUDA error texts (c10/cuda/CUDAException, the caching
# allocator), as a failed launch or an illegal access surfaces them
TORCH_CUDA_ERRORS = [
    "CUDA error: an illegal memory access was encountered\nCUDA kernel "
    "errors might be asynchronously reported at some other API call, so "
    "the stacktrace below might be incorrect.\nFor debugging consider "
    "passing CUDA_LAUNCH_BLOCKING=1\nCompile with `TORCH_USE_CUDA_DSA` to "
    "enable device-side assertions.",
    "CUDA error: unspecified launch failure",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: misaligned address",
    "CUDA error: device-side assert triggered",
    "CUDA error: the launch timed out and was terminated",
    "CUDA error: too many resources requested for launch",
    "CUDA error: no kernel image is available for execution on the device",
    "CUDA driver error: unknown error",
    "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
    "capacity of 79.11 GiB of which 1.06 GiB is free.",
    "NCCL error: unhandled cuda error",
]


@pytest.mark.parametrize("msg", TORCH_CUDA_ERRORS + _port_launch_errors())
def test_cuda_errors_classify_fatal(msg):
    """An illegal access or a failed launch leaves the CUDA context
    unusable: a same-process resume would fail again, so the supervisor
    must propagate it, never back off and retry."""
    assert not TG.is_transient(f"RuntimeError: {msg}")
    assert TG.classify_failure(RuntimeError(msg)) == "fatal"
    assert TG.classify_failure(torch.cuda.OutOfMemoryError(msg)) == "fatal"


def test_supervisor_recoveries():
    sleeps, calls = [], []

    def run():
        calls.append(1)
        if len(calls) < 3:
            raise TG.InjectedCrash("phase-boundary crash")
        return "done"

    sup = TG.Supervisor(run, backoff_base=0.5, backoff_cap=60.0,
                        telemetry=Telemetry(), log=_quiet,
                        sleep=sleeps.append)
    assert sup.run() == "done"
    assert sleeps == [0.5, 1.0]
    assert sup.recoveries == [("transient", "backoff_resume")] * 2

    resized = []

    def lossy():
        if not resized:
            raise TG.ChipLossError(7, 8)
        return "resized-done"

    def resize_fn(exc):
        resized.append(exc.surviving)
        return lossy

    sup = TG.Supervisor(lossy, resize_fn=resize_fn, log=_quiet,
                        sleep=lambda s: None)
    assert sup.run() == "resized-done" and resized == [7]
    assert sup.recoveries == [("chip_loss", "resize_resume")]
    for exc in (TG.ChipLossError(0, 1), FloatingPointError("nan"),
                RuntimeError("CUDA error: unspecified launch failure")):
        sup = TG.Supervisor(lambda e=exc: (_ for _ in ()).throw(e),
                            resize_fn=lambda e: None, log=_quiet,
                            sleep=lambda s: None)
        with pytest.raises(type(exc)):
            sup.run()
        assert sup.recoveries == [] and sup.attempts == 1


def test_graceful_shutdown_flag_and_restore():
    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGTERM)
    with TG.GracefulShutdown() as stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if stop.requested:
                break
        assert stop.requested and stop.signal_name == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is before
    # off the main thread it is a flag holder that installs nothing
    box = {}

    def worker():
        with TG.GracefulShutdown() as s:
            box["installed"] = s._installed

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and box == {"installed": False}


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_events", [1, 4, 7])
def test_fault_plan_seeded_equals_reference(n_events):
    """One seed names one schedule in both packages (the same numpy
    draws in the same order)."""
    for seed in range(12):
        got = TF.FaultPlan.seeded(seed, n_events=n_events)
        assert got.to_json() == RF.FaultPlan.seeded(
            seed, n_events=n_events).to_json()
        assert got.seed == seed
    assert TF.FAULT_KINDS == RF.FAULT_KINDS
    assert TF.PHASE_KINDS == RF.PHASE_KINDS


def test_fault_plan_spec_forms(tmp_path, monkeypatch):
    inline = '[{"kind": "crash", "at": 2}, {"kind": "nan_poison", "at": 1}]'
    p = TF.FaultPlan.from_spec(inline)
    assert [e.kind for e in p.events] == ["crash", "nan_poison"]
    f = tmp_path / "plan.json"
    f.write_text(json.dumps({"events": json.loads(inline)}))
    assert TF.FaultPlan.from_spec(f"@{f}").to_json() == p.to_json()
    assert TF.FaultPlan.from_spec("seed:3:2").to_json() == \
        RF.FaultPlan.from_spec("seed:3:2").to_json()
    assert TF.FaultPlan.from_spec(None) is None
    assert TF.FaultPlan.from_spec("") is None
    monkeypatch.setenv("PPLS_FAULT_PLAN", inline)
    assert TF.FaultPlan.from_env().to_json() == p.to_json()
    with pytest.raises(ValueError, match="unknown fault kind"):
        TF.FaultPlan.from_spec('[{"kind": "meteor", "at": 1}]')
    with pytest.raises(ValueError, match="edge"):
        TF.FaultEvent(kind="crash", at=1, edge="middle")
    assert TF.FaultEvent(kind="hang", at=1).seconds == TF.HANG_FOREVER_S


def test_injector_fires_each_event_once_with_attribution():
    tel = Telemetry()
    plan = TF.FaultPlan.from_events([
        {"kind": "crash", "at": 2},
        {"kind": "nan_poison", "at": 1},
        {"kind": "straggler", "at": 3, "seconds": 0.0},
        {"kind": "crash", "at": 4, "edge": "close"}])
    inj = TF.FaultInjector(plan, telemetry=tel)
    inj.on_phase_open(0)
    assert inj.on_admit(0) is False
    assert inj.on_admit(1) is True
    assert inj.on_admit(1) is False
    with pytest.raises(TG.InjectedCrash):
        inj.on_phase_open(2, n_dev=8)
    inj.on_phase_open(2, n_dev=8)
    inj.on_phase_open(3)
    inj.on_phase_open(4)                      # a close-edge event: no
    with pytest.raises(TG.InjectedCrash):
        inj.on_phase_close(4)
    for kind, n in (("crash", 2), ("nan_poison", 1), ("straggler", 1)):
        assert tel.registry.value("ppls_faults_injected_total",
                                  kind=kind) == n
    assert all(e.fired for e in plan.events)
    with pytest.raises(TG.ChipLossError) as ei:
        TF.FaultInjector(TF.FaultPlan.from_events(
            [{"kind": "chip_loss", "at": 5, "chip": 3}])).on_phase_open(
                5, n_dev=8)
    assert (ei.value.chip, ei.value.n_dev, ei.value.surviving) == (3, 8, 7)
    with pytest.raises(TG.HostLossError):
        TF.FaultInjector(TF.FaultPlan.from_events(
            [{"kind": "host_loss", "at": 1}])).on_phase_open(1, n_dev=2)


def test_injector_checkpoint_damage_is_detected(tmp_path):
    ident = {"engine": "walker", "fname": "f", "eps": 1e-7}

    def write(path):
        save_family_checkpoint(
            path, identity=ident,
            bag_cols={"l": np.linspace(0, 1, 64),
                      "meta": np.arange(64, dtype=np.int32)},
            count=64, acc=np.array([1.5, 2.5]), totals={"tasks": 3})

    for kind in ("ckpt_truncate", "ckpt_corrupt"):
        path = str(tmp_path / f"{kind}.ckpt")
        inj = TF.FaultInjector(TF.FaultPlan.from_events(
            [{"kind": kind, "at": 1}]))
        write(path)
        inj.on_checkpoint_write(path)         # write 0: not keyed
        assert load_family_checkpoint(path, ident)[1] == 64
        write(path)
        inj.on_checkpoint_write(path)         # write 1: damage fires
        with pytest.raises(CheckpointCorruptError) as ei:
            load_family_checkpoint(path, ident)
        assert ei.value.path == path


# ---------------------------------------------------------------------------
# the engine's fault boundaries
# ---------------------------------------------------------------------------


def _by_rid(res):
    return {c.rid: c for c in res.completed}


def _both(plan, *, family=FAM, eps=EPS, theta=THETA4, **over):
    """The same requests through both engines, each with its own
    injector of ``plan``."""
    kw = dict(KW, **over)
    reqs = [(t, BOUNDS) for t in theta]
    ref = RefEngine(family, eps, quarantine=True,
                    fault_injector=RF.FaultInjector(
                        RF.FaultPlan.from_events(plan)), **kw).run(reqs)
    inj = TF.FaultInjector(TF.FaultPlan.from_events(plan))
    got = StreamEngine(family, eps, quarantine=True, fault_injector=inj,
                       device="cpu", **kw).run(reqs)
    return ref, got, inj


@pytest.mark.parametrize("mode", ["k1", "k2", "f64"])
def test_stream_nan_poison_quarantined_as_the_reference(mode):
    """nan_poison turns rid 1's theta NaN after validation: it retires
    failed while the others retire healthy, with the reference's phases
    under the same plan; on the dyadic float64 mode the healthy areas are
    bit-equal to a run with no fault."""
    over = {"k1": {}, "k2": dict(refill_slots=0, roots_per_lane=1),
            "f64": dict(f64_rounds=4)}[mode]
    fam, eps = (("quad_scaled", 1e-9) if mode == "f64" else (FAM, EPS))
    theta = [1.0, 1.25, 1.5, 2.0, 0.75] if mode == "f64" else THETA4
    plan = [{"kind": "nan_poison", "at": 1}]
    before = (TW.run_segment_rf.launches, TW.run_segment_ee.launches)
    ref, got, inj = _both(plan, family=fam, eps=eps, theta=theta, **over)
    assert (TW.run_segment_rf.launches,
            TW.run_segment_ee.launches) == before    # plain segments here
    assert inj.plan.events[0].fired
    r, g = _by_rid(ref), _by_rid(got)
    assert g[1].failed and g[1].failure == "nan"
    assert not np.isfinite(g[1].area)
    assert sorted(k for k in g if not g[k].failed) == [0, 2, 3] + (
        [4] if mode == "f64" else [])
    assert {k: (c.admit_phase, c.retire_phase, c.failed)
            for k, c in g.items()} == {
        k: (c.admit_phase, c.retire_phase, c.failed) for k, c in r.items()}
    healthy = [k for k in g if not g[k].failed]
    d = max(abs(g[k].area - r[k].area) for k in healthy)
    if mode != "f64":
        assert d < 3e-9
    else:
        assert d == 0.0
        clean = StreamEngine(fam, eps, device="cpu",
                             **dict(KW, **over)).run(
            [(t, BOUNDS) for t in theta])
        assert all(g[k].area == _by_rid(clean)[k].area for k in healthy)
    assert got.totals == ref.totals


def test_stream_nan_poison_theta_batch_as_the_reference():
    """On a theta_block = 8 engine the poison turns rid 1's seed theta
    and its whole theta-table row NaN. The reference does not contain it
    there: rid 1 retires with zero areas, not failed, and the NaN lands in
    rid 0's second theta, which retires failed (ROADMAP.md Queue 3). The
    port walks the same schedule to the same records, NaN for NaN, the
    other areas within 3e-9 (tests/test_theta_walker.py's stream
    configuration)."""
    kw = dict(slots=4, chunk=1 << 9, capacity=1 << 16, lanes=256,
              roots_per_lane=2, refill_slots=2, seg_iters=2048,
              min_active_frac=0.05, theta_block=8, quarantine=True)
    plan = [{"kind": "nan_poison", "at": 1}]
    batches = [[1.0, 2.0, 3.0], list(np.linspace(1.0, 4.0, 8)), [1.5]]

    def run(eng):
        for th in batches:
            eng.submit(th, (0.0, 1.0))
        return {c.rid: c for c in eng.drain()}

    got = run(StreamEngine("sin_scaled", 1e-6, device="cpu",
                           fault_injector=TF.FaultInjector(
                               TF.FaultPlan.from_events(plan)), **kw))
    ref = run(RefEngine("sin_scaled", 1e-6, fault_injector=RF.FaultInjector(
        RF.FaultPlan.from_events(plan)), **kw))
    assert {r: (c.admit_phase, c.retire_phase, c.failed, c.failure)
            for r, c in got.items()} == {
        r: (c.admit_phase, c.retire_phase, c.failed, c.failure)
        for r, c in ref.items()}
    assert [r for r, c in got.items() if c.failed] == [0]
    assert np.isnan(got[0].areas[1]) and got[1].areas == [0.0] * 8
    for r in got:
        np.testing.assert_allclose(got[r].areas, ref[r].areas, rtol=0,
                                   atol=3e-9, equal_nan=True)


def test_stream_phase_edges_and_checkpoint_write(tmp_path):
    """A crash at a phase's open or close edge and a damaged snapshot at
    a write ordinal fire where the reference fires them."""
    path = str(tmp_path / "e.ckpt")
    inj = TF.FaultInjector(TF.FaultPlan.from_events(
        [{"kind": "ckpt_corrupt", "at": 1},
         {"kind": "crash", "at": 1, "edge": "close"}]))
    eng = StreamEngine(FAM, EPS, checkpoint_path=path, checkpoint_every=1,
                       fault_injector=inj, device="cpu", **KW)
    with pytest.raises(TG.InjectedCrash):
        eng.run([(t, BOUNDS) for t in THETA4], arrival_phase=[0, 0, 1, 2])
    assert eng.phase == 2 and inj.ckpt_writes == 2
    with pytest.raises(CheckpointCorruptError):
        StreamEngine.resume(path, FAM, EPS, device="cpu", **KW)
    inj = TF.FaultInjector(TF.FaultPlan.from_events(
        [{"kind": "crash", "at": 2}]))
    eng = StreamEngine(FAM, EPS, fault_injector=inj, device="cpu", **KW)
    with pytest.raises(TG.InjectedCrash):
        eng.run([(t, BOUNDS) for t in THETA4], arrival_phase=[0, 0, 1, 2])
    # the open edge fires before admission: rid 3 (arrival 2) stays
    # queued
    assert eng.phase == 2 and [r.rid for r in eng._pending] == [3]


def test_chip_loss_on_one_card_gives_up():
    """One card: a chip loss leaves nothing to resume onto, so the
    supervised run propagates it, as the reference's does."""
    for G, F, Eng, dev in ((TG, TF, StreamEngine, {"device": "cpu"}),
                           (RG, RF, RefEngine, {})):
        inj = F.FaultInjector(F.FaultPlan.from_events(
            [{"kind": "chip_loss", "at": 1}]))

        def loop():
            return Eng(FAM, EPS, fault_injector=inj, quarantine=True,
                       **dict(KW, **dev)).run([(t, BOUNDS)
                                               for t in THETA4])

        sup = G.Supervisor(loop, resize_fn=lambda e: loop, log=_quiet,
                           sleep=lambda s: None)
        with pytest.raises(G.ChipLossError) as ei:
            sup.run()
        assert ei.value.surviving == 0 and sup.recoveries == []


def test_resume_mesh_resize_at_equal_size(tmp_path):
    """mesh_resize=True is a no-op at equal mesh sizes (the reference's
    elastic rule); without it a snapshot of another mesh size is
    refused. With it the walker engine reads its own state, as the
    reference's does, and a walker-dd snapshot of one rank resumes onto
    two, bit-identical on the dyadic family."""
    path = str(tmp_path / "m.ckpt")
    reqs = [(t, BOUNDS) for t in THETA4]
    base = StreamEngine(FAM, EPS, device="cpu", **KW).run(
        reqs, arrival_phase=[0, 0, 1, 2])
    eng = StreamEngine(FAM, EPS, checkpoint_path=path, checkpoint_every=1,
                       device="cpu", **KW)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run(reqs, arrival_phase=[0, 0, 1, 2], _crash_after_phases=2)
    eng2 = StreamEngine.resume(path, FAM, EPS, mesh_resize=True,
                               device="cpu", **KW)
    while eng2.next_rid < len(reqs):
        eng2.submit(*reqs[eng2.next_rid])
    res = eng2.run([])
    assert np.array_equal(res.areas, base.areas)
    cols, count, acc, totals = load_family_checkpoint(path,
                                                      eng2._identity())
    save_family_checkpoint(path, identity=dict(eng2._identity(), n_dev=2),
                           bag_cols=cols, count=count, acc=acc,
                           totals=totals)
    with pytest.raises(ValueError, match="different run"):
        StreamEngine.resume(path, FAM, EPS, device="cpu", **KW)
    eng3 = StreamEngine.resume(path, FAM, EPS, mesh_resize=True,
                               device="cpu", **KW)
    while eng3.next_rid < len(reqs):
        eng3.submit(*reqs[eng3.next_rid])
    assert np.array_equal(eng3.run([]).areas, base.areas)

    dkw = dict(KW, engine="walker-dd", device="cpu")
    dya = [(t, (0.0, 1.0)) for t in THETA4]
    with StreamEngine("quad_scaled", 1e-9, n_devices=1, **dkw) as e:
        dbase = e.run(dya, arrival_phase=[0, 0, 1, 2])
    dpath = str(tmp_path / "dd.ckpt")
    e = StreamEngine("quad_scaled", 1e-9, checkpoint_path=dpath,
                     checkpoint_every=1, n_devices=1, **dkw)
    with pytest.raises(RuntimeError, match="simulated crash"):
        e.run(dya, arrival_phase=[0, 0, 1, 2], _crash_after_phases=2)
    e.close()
    with StreamEngine.resume(dpath, "quad_scaled", 1e-9, mesh_resize=True,
                             n_devices=2, **dkw) as e2:
        assert e2.phase == 2
        while e2.next_rid < len(dya):
            e2.submit(*dya[e2.next_rid])
        res = e2.run([])
    assert np.array_equal(res.areas, dbase.areas)
    assert res.mesh["world"] == 2


def test_slo_health_and_spillover_summary_shapes():
    eng = StreamEngine(FAM, EPS, device="cpu", **KW)
    ref = RefEngine(FAM, EPS, **KW)
    assert eng.slo_health() == ref.slo_health() == {
        "ok": True, "burning": [], "phase": 0}
    assert eng.spillover_summary() == ref.spillover_summary()
    eng.run([(1.0, BOUNDS)])
    assert eng.slo_health()["phase"] == eng.phase > 0


# ---------------------------------------------------------------------------
# ingest and the metrics endpoint
# ---------------------------------------------------------------------------

GOOD_RECORD = {"theta": 1.5, "bounds": [0.0, 1.0], "tenant": "x",
               "priority": 2, "deadline_phases": 9, "arrival_phase": 3}
BAD_RECORDS = [
    {"bounds": [0, 1]}, {"theta": "x", "bounds": [0, 1]},
    {"theta": 1.0, "bounds": [0]}, {"theta": [], "bounds": [0, 1]},
    {"theta": [1, 2], "bounds": [0, 1]},
    {"theta": 1.0, "bounds": [0, 1], "priority": 1.5},
    {"theta": 1.0, "bounds": [0, 1], "deadline_phases": 0},
    {"theta": 1.0, "bounds": [0, 1], "arrival_phase": -1},
    {"theta": 1.0, "bounds": [0, 1], "tenant": ""},
    {"theta": True, "bounds": [0, 1]},
    {"theta": 1.0, "bounds": [0, 1], "nope": 1}, [1, 2]]


def test_parse_request_record_matches_reference():
    assert TIn.parse_request_record(GOOD_RECORD) == \
        RIn.parse_request_record(GOOD_RECORD) == {
            "theta": 1.5, "bounds": (0.0, 1.0), "tenant": "x",
            "priority": 2, "deadline_phases": 9, "arrival_phase": 3}
    batch = {"theta": [1, 2, 3], "bounds": [0, 1]}
    assert TIn.parse_request_record(batch, theta_block=4) == \
        RIn.parse_request_record(batch, theta_block=4)
    for bad in BAD_RECORDS:
        with pytest.raises(ValueError) as ep:
            TIn.parse_request_record(bad, theta_block=1)
        with pytest.raises(ValueError) as er:
            RIn.parse_request_record(bad, theta_block=1)
        assert str(ep.value) == str(er.value)
    # the pool dispatcher's routing keys (dispatch=True): good records
    # parse as the reference's, bad eps/rule/batch records give its
    # messages, and without dispatch the keys stay unknown
    routed = [GOOD_RECORD,
              dict(GOOD_RECORD, eps=1e-7),
              dict(GOOD_RECORD, rule=" Simpson "),
              {"theta": [1, 2, 3], "bounds": [0, 1], "eps": 3e-9}]
    for good in routed:
        assert TIn.parse_request_record(good, theta_block=64,
                                        dispatch=True) == \
            RIn.parse_request_record(good, theta_block=64, dispatch=True)
    for bad in ({"theta": 1.0, "bounds": [0, 1], "eps": 1e-20},
                {"theta": 1.0, "bounds": [0, 1], "eps": "x"},
                {"theta": 1.0, "bounds": [0, 1], "eps": True},
                {"theta": 1.0, "bounds": [0, 1], "eps": 0},
                {"theta": 1.0, "bounds": [0, 1], "rule": "simpsonish"},
                {"theta": 1.0, "bounds": [0, 1], "rule": 3},
                {"theta": [1, 2], "bounds": [0, 1], "rule": "simpson"},
                {"theta": list(range(65)), "bounds": [0, 1]},
                {"theta": 1.0, "bounds": [0, 1], "nope": 1}):
        with pytest.raises(ValueError) as ep:
            TIn.parse_request_record(bad, theta_block=64, dispatch=True)
        with pytest.raises(ValueError) as er:
            RIn.parse_request_record(bad, theta_block=64, dispatch=True)
        assert str(ep.value) == str(er.value)
    with pytest.raises(ValueError, match="unknown request keys"):
        TIn.parse_request_record(dict(GOOD_RECORD, eps=1e-7))


def test_ingest_server_roundtrip():
    seen = []

    def submit(d):
        rec = TIn.parse_request_record(d, theta_block=1)
        seen.append(rec)
        return {"rid": len(seen) - 1, "accepted": True}

    srv = TIn.IngestServer(submit, stats_fn=lambda: {"pending": len(seen)})
    try:
        body = (b'{"theta": 1.0, "bounds": [0.0, 1.0]}\n'
                b'garbage\n'
                b'{"theta": 1.0}\n'
                b'{"theta": 2.0, "bounds": [0.0, 1.0], "tenant": "t"}\n')
        resp = urllib.request.urlopen(urllib.request.Request(
            srv.url, data=body, method="POST"), timeout=10)
        recs = [json.loads(ln) for ln in
                resp.read().decode().strip().splitlines()]
        assert [r.get("accepted") for r in recs] == [True, False, False,
                                                      True]
        assert "unparseable" in recs[1]["error"]
        assert "bounds" in recs[2]["error"]
        assert len(seen) == 2 and seen[1]["tenant"] == "t"
        stats = json.loads(urllib.request.urlopen(
            f"http://{srv.host}:{srv.port}/", timeout=10).read())
        assert stats == {"pending": 2}
        # an over-limit Content-Length is refused before the body is read
        # (sent without its body, so the early reply cannot race it)
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=10)
        try:
            conn.putrequest("POST", "/submit")
            conn.putheader("Content-Length", str(TIn.MAX_BODY_BYTES + 1))
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 413
            assert "over" in json.loads(resp.read())["error"]
        finally:
            conn.close()
    finally:
        srv.close()
    assert TIn.ingest_lines('{"theta": 1}\n\nnot json\n',
                            lambda d: {"ok": 1}) == RIn.ingest_lines(
        '{"theta": 1}\n\nnot json\n', lambda d: {"ok": 1})


def test_engine_handle_publish_clear():
    h = TIn.EngineHandle()
    assert h.peek() is None
    with h.lock():
        h.publish("eng")
        with h.lock():                       # reentrant
            assert h.peek() == "eng"
    h.clear()
    assert h.peek() is None


def test_metrics_server_serves_exposition_and_health():
    reg = MetricsRegistry()
    reg.counter("ppls_x_total", "a counter").inc(3)
    verdict = {"ok": True, "burning": [], "phase": 4}
    srv = MetricsServer(lambda: reg, port=0, health_fn=lambda: verdict)
    try:
        text = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        assert text == reg.exposition() and "ppls_x_total 3" in text
        base = f"http://{srv.host}:{srv.port}"
        assert json.loads(urllib.request.urlopen(
            base + "/health", timeout=10).read()) == verdict
        verdict["ok"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/health", timeout=10)
        assert ei.value.code == 503
    finally:
        srv.close()
    plain = MetricsServer(reg, port=0)       # no health_fn: metrics
    try:
        assert "ppls_x_total" in urllib.request.urlopen(
            f"http://{plain.host}:{plain.port}/health",
            timeout=10).read().decode()
    finally:
        plain.close()


# ---------------------------------------------------------------------------
# artifact schema
# ---------------------------------------------------------------------------

_RET = {"rid": 0, "area": 0.5, "tenant": "default", "priority": 1}
_SUM = {"summary": True, "completed": 2, "phases": 3, "totals": {},
        "latency": {}, "shed": 1}
SERVE_TEXTS = {
    "valid": [_RET, dict(_RET, rid=1), {"rid": 2, "shed": True,
              "tenant": "t", "reason": "queue_full"},
              {"rejected": True, "line": 3, "error": "bad"}, _SUM],
    "replayed": [_RET, _RET, dict(_RET, rid=1),
                 {"rid": 2, "shed": True, "tenant": "t",
                  "reason": "queue_full"}, _SUM],
    "no_summary": [_RET],
    "two_summaries": [_RET, dict(_RET, rid=1), _SUM, _SUM],
    "failed_with_area": [dict(_RET, failed=True), dict(_RET, rid=1),
                         dict(_SUM, shed=0, failed=1)],
    "nonfinite": ['{"rid": 0, "area": NaN}', dict(_RET, rid=1),
                  dict(_SUM, shed=0)],
    "shed_no_tenant": [{"rid": 5, "shed": True, "reason": "x"}, _RET],
    "reject_no_error": [{"rejected": True}, dict(_SUM, completed=0,
                                                 shed=0)],
    "unknown_shape": [{"hello": 1}, dict(_SUM, completed=0, shed=0)],
    "counts_off": [_RET, dict(_SUM, completed=3, shed=2)],
    "retired_and_shed": [_RET, {"rid": 0, "shed": True, "tenant": "t",
                                "reason": "r"}, dict(_SUM, completed=1)],
    "missing_keys": [_RET, {"summary": True, "completed": 1}],
    "garbled": ['{"rid": 0, "area"', _RET, dict(_SUM, completed=1,
                                                 shed=0)],
}


def _text(lines):
    return "\n".join(x if isinstance(x, str) else json.dumps(x)
                     for x in lines) + "\nplain log line\n"


@pytest.mark.parametrize("name", list(SERVE_TEXTS))
def test_validate_serve_output_matches_reference(name):
    text = _text(SERVE_TEXTS[name])
    got = TA.validate_serve_output_text(text)
    assert got == RA.validate_serve_output_text(text)
    assert (got == []) == (name in ("valid", "replayed"))


def _ev(ev, t=None, **kw):
    d = {"ev": ev, **kw}
    if t is not None:
        d["t"] = t
    return d


_META = _ev("meta", schema="ppls-events-v1")
EVENT_TEXTS = {
    "valid": [_META, _ev("span_open", 0.0, id=0, name="run", parent=None),
              _ev("span_open", 0.1, id=1, name="request", parent=0,
                  attrs={"rid": 4}),
              _ev("event", 0.2, name="admit", attrs={"rid": 4}),
              _ev("event", 0.3, name="retire", attrs={"rid": 4}),
              _ev("span_close", 0.4, id=1), _ev("span_close", 0.5, id=0)],
    "resumed": [_META, _ev("span_open", 1.0, id=0, name="run",
                           parent=None), _META,
                _ev("span_open", 0.0, id=0, name="run", parent=None),
                _ev("span_close", 0.1, id=0)],
    "unbalanced": [_META, _ev("span_open", 0.0, id=0, name="run",
                              parent=None)],
    "backwards": [_META, _ev("event", 1.0, name="a"),
                  _ev("event", 0.5, name="b")],
    "bad_kind": [_META, _ev("nope", 0.0)],
    "bad_parent": [_META, _ev("span_open", 0.0, id=0, name="x", parent=9),
                   _ev("span_close", 0.1, id=0)],
    "reopened": [_META, _ev("span_open", 0.0, id=0, name="x", parent=None),
                 _ev("span_open", 0.1, id=0, name="x", parent=None),
                 _ev("span_close", 0.2, id=0)],
    "close_unopened": [_META, _ev("span_close", 0.0, id=3)],
    "nameless": [_META, _ev("event", 0.0), _ev("span_open", 0.1, id=0,
                                               parent=None),
                 _ev("span_close", 0.2, id=0)],
    "no_schema": [_ev("meta"), _ev("event", 0.0, name="a")],
    "bad_attrs": [_META, _ev("event", 0.0, name="a", attrs=[1])],
    "no_time": [_META, _ev("event", name="a")],
    "orphan_hop": [_META, _ev("event", 0.0, name="admit",
                              attrs={"rid": 1})],
    "empty": [],
    "garbled": [_META, '{"ev": "event"', "[1, 2]"],
}


@pytest.mark.parametrize("name", list(EVENT_TEXTS))
def test_validate_events_matches_reference(name):
    text = _text(EVENT_TEXTS[name]).replace("plain log line\n", "")
    for kw in ({}, {"require_balanced": False},
               {"check_rid_linkage": True}):
        got = TA.validate_events_text(text, **kw)
        assert got == RA.validate_events_text(text, **kw)
    assert (TA.validate_events_text(text) == []) == (name in (
        "valid", "orphan_hop"))


def test_dedup_by_rid_matches_reference():
    recs = [{"rid": 1, "a": 1}, {"rid": 2}, {"rid": 1, "a": 2},
            {"x": 0}, {"x": 0}, {"rid": 2}]
    assert TA.dedup_by_rid(recs) == RA.dedup_by_rid(recs) == [
        {"rid": 1, "a": 1}, {"rid": 2}, {"x": 0}, {"x": 0}]
    assert TA.dedup_replayed(recs, lambda r: r.get("x")) == \
        RA.dedup_replayed(recs, lambda r: r.get("x"))


# ---------------------------------------------------------------------------
# the kernel build under concurrent first use
# ---------------------------------------------------------------------------


def test_concurrent_first_use_builds_once(tmp_path):
    """Eight threads reach the first use of one library at once (a serve
    attempt under a watchdog and its retry): one builds, the others wait
    on the file lock and load its result."""
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int tiny_answer() { return 42; }\n')
    out, errors = [], []
    barrier = threading.Barrier(8)

    def build():
        try:
            barrier.wait(timeout=30)
            out.append(cuda_build.build_library(
                "tiny", "g++", cuda_build.HOST_FLAGS, [src], [],
                tmp_path / "build"))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sum(b.build_seconds > 0 for b in out) == 1
    assert {b.path for b in out} == {out[0].path}
    assert all(b.lib.tiny_answer() == 42 for b in out)
    assert not list(out[0].path.parent.glob("*.tmp"))
