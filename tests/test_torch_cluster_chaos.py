"""The port's cluster under overload and faults, on the CPU, against the
reference's single stream engine (bit-equal on the dyadic workload):

* the reference bench's multihost leg (tools/bench_history.py
  ``MULTIHOST_*``: 8 ``quad_scaled`` requests, 2 processes, queue limit
  2, spillover limit 2, worker 1 SIGKILLed at phase 1): its booleans
  (accounting, bit-identity), spillover engaged before any shed;
* a worker death surfacing during the deal: the unsent batches roll
  back and the run completes on the survivor;
* worker-side deadline sheds adopted by the coordinator, and the
  mirrored pre-rid validation;
* the chaos federation trace (tests/test_request_trace.py:579): host
  loss + overload; ``federation_reconcile() == []``; coordinator retired
  = sum over workers + spillover; the per-rid trace with its redeal hop,
  validated by the port's and the reference's schema checks and
  decomposed exactly by the reference's ``tools/analyze_request.py``;
* the per-rid trace surviving kill-and-resume equal to the undisturbed
  run's.
"""

import json
import os
import sys

import numpy as np
import pytest

from ppls_tpu.runtime.stream import StreamEngine as RefStream
from ppls_tpu.utils.artifact_schema import \
    validate_events_text as ref_validate_events
from ppls_tpu_torch.obs.telemetry import Telemetry
from ppls_tpu_torch.runtime import guard
from ppls_tpu_torch.runtime.cluster import ClusterStreamEngine
from ppls_tpu_torch.runtime.faults import FaultInjector, FaultPlan
from ppls_tpu_torch.utils.artifact_schema import validate_events_text

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools import bench_history as BH  # noqa: E402
from tools.analyze_request import analyze  # noqa: E402

# tests/test_cluster.py:46-59 (= tests/test_request_trace.py's KW)
WKW = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
           roots_per_lane=2, refill_slots=2, seg_iters=32,
           min_active_frac=0.05, f64_rounds=2)
THETA6 = [1.0, 1.25, 1.5, 2.0, 0.75, 3.0]
REQS6 = [(t, (0.0, 1.0)) for t in THETA6]
ARR6 = [0, 0, 1, 2, 3, 4]
# tests/test_request_trace.py:590
CHAOS_REQS = REQS6 + [(1.75, (0.0, 1.0)), (2.5, (0.0, 1.0))]


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


def _ref_areas(reqs, arr=None, **kw):
    return RefStream("quad_scaled", 1e-9, **dict(WKW, **kw)).run(
        reqs, arrival_phase=arr).areas


def _cluster(n=2, family="quad_scaled", eps=1e-9, wkw=WKW, **kw):
    return ClusterStreamEngine(family, eps, n_processes=n,
                               worker_kw=wkw, device="cpu", **kw)


def _supervised(eng, loop):
    def resize_fn(exc):
        eng.recover_host_loss(exc)
        return loop

    return guard.Supervisor(loop, resize_fn=resize_fn,
                            log=lambda m: None, sleep=lambda s: None)


def _recs(path):
    with open(path, encoding="utf-8") as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def _rid_trace(paths):
    """tests/test_request_trace.py's ``_rid_trace``: the deterministic
    per-rid trace surface (terminal and admit-edge events with their
    schedule-determined attrs, plus the (rid, phase) residency set),
    deduped across segments; a replayed event must not diverge."""
    keep = {
        "admit": ("rid", "slot", "phase", "submit_phase",
                  "queue_wait_phases", "token_wait_phases", "tenant",
                  "priority"),
        "request_dealt": ("rid", "phase", "submit_phase",
                          "queue_wait_phases"),
        "retire": ("rid", "area", "failed", "submit_phase",
                   "admit_phase", "retire_phase", "latency_phases",
                   "tenant", "priority"),
        "request_shed": ("rid", "tenant", "priority", "reason",
                         "phase", "submit_phase"),
    }
    out, residency = {}, set()
    for p in paths:
        for r in _recs(p):
            if r.get("ev") != "event":
                continue
            a = r.get("attrs") or {}
            if r["name"] == "request_phase":
                residency.add((a["rid"], a["phase"]))
            elif r["name"] in keep:
                key = (a["rid"], r["name"])
                val = {k: a.get(k) for k in keep[r["name"]]}
                assert out.setdefault(key, val) == val, key
    return out, residency


def test_multihost_leg_spillover_under_overload_and_host_loss():
    """The reference bench's multihost leg (tools/bench_history.py
    run_multihost_proxies) on the port's cluster: the survivors spill to
    the CPU backend before shedding, every area equals the undisturbed
    single engine's bit for bit, 0 lost."""
    thetas = [1.0 + i / 4.0 for i in range(BH.MULTIHOST_K)]
    reqs = [(t, (0.0, 1.0)) for t in thetas]
    base = RefStream(BH.MULTIHOST_FAMILY, BH.MULTIHOST_EPS,
                     **BH.MULTIHOST_WKW).run(reqs)
    inj = FaultInjector(FaultPlan.from_events(
        [dict(e) for e in BH.MULTIHOST_FAULTS]))
    eng = _cluster(BH.MULTIHOST_PROCESSES, BH.MULTIHOST_FAMILY,
                   BH.MULTIHOST_EPS, BH.MULTIHOST_WKW,
                   fault_injector=inj,
                   queue_limit=BH.MULTIHOST_QUEUE_LIMIT, spillover=True,
                   spillover_limit=BH.MULTIHOST_SPILL_LIMIT)

    def loop():
        k = eng.next_rid
        while not eng.idle or k < len(reqs):
            while k < len(reqs):
                eng.submit(*reqs[k])
                k += 1
            eng.step()
        return eng.result()

    sup = _supervised(eng, loop)
    try:
        res = sup.run()
        spill = eng.spillover_summary()
        rec = {
            "recoveries": [{"kind": k, "action": a}
                           for k, a in sup.recoveries],
            "processes_surviving": eng.manifest.identity()["processes"],
            "accounting_ok": (len(res.completed) + len(res.shed)
                              == BH.MULTIHOST_K),
            "areas_bit_identical": bool(
                np.array_equal(res.areas, base.areas)),
        }
        assert rec == {"recoveries": [{"kind": "host_loss",
                                       "action": "resize_resume"}],
                       "processes_surviving": 1, "accounting_ok": True,
                       "areas_bit_identical": True}
        assert not res.shed                 # spillover, not rejection
        assert spill["spillover_completed"] > 0
        assert spill["spillover_tasks"] > 0
        assert 0.0 < spill["spillover_fraction"] <= 1.0
        assert eng.redeal_walls \
            and eng.redeal_walls[0] < BH.GATE_REDEAL_WALL_BUDGET_S
    finally:
        eng.close()


def test_deal_partial_failure_preserves_survivor_batches():
    """A worker death surfacing DURING the deal must not strand the
    batches for later, live workers: unsent batches roll back to pending
    and the run completes on the survivor."""
    base = _ref_areas(REQS6)
    eng = _cluster(2)
    try:
        for t in THETA6:
            eng.submit(t, (0.0, 1.0))
        eng.kill_process(0)             # dies before the next deal
        with pytest.raises(guard.HostLossError):
            eng.step()
        assert eng.pending > 0          # worker 1's batch rolled back
        assert eng.recover_host_loss() == 1
        while not eng.idle:
            eng.step()
        res = eng.result()
        assert sorted(c.rid for c in res.completed) == list(range(6))
        assert np.array_equal(res.areas, base)
    finally:
        eng.close()


def test_worker_deadline_sheds_reach_coordinator():
    """A worker-side deadline shed is a terminal outcome the coordinator
    adopts (else the cluster never goes idle); the coordinator mirrors
    the single engine's pre-rid validation."""
    eng = _cluster(1)
    try:
        with pytest.raises(ValueError, match="deadline_phases"):
            eng.submit(1.0, (0.0, 1.0), deadline_phases=0)
        with pytest.raises(ValueError, match="theta_block"):
            eng.submit([1.0, 2.0], (0.0, 1.0))
        with pytest.raises(ValueError, match="tenant"):
            eng.submit(1.0, (0.0, 1.0), tenant="")
        for t in THETA6:
            eng.submit(t, (0.0, 1.0), deadline_phases=1)
        for _ in range(60):
            eng.step()
            if eng.idle:
                break
        assert eng.idle
        res = eng.result()
        rids = sorted([c.rid for c in res.completed]
                      + [s.rid for s in res.shed])
        assert rids == list(range(len(THETA6)))
        assert res.shed
    finally:
        eng.close()


def test_chaos_federation_trace_and_decomposition(tmp_path):
    """A 2-process chaos run (host_loss + overload): one federated
    metrics surface whose totals reconcile exactly, a per-rid trace for
    every acknowledged request with its redeal hop, and decompositions
    that sum to each recorded retire latency."""
    ev_path = str(tmp_path / "chaos.jsonl")
    tel = Telemetry(events_path=ev_path, meta={"mode": "chaos"})
    inj = FaultInjector(FaultPlan.from_events(
        [{"kind": "host_loss", "at": 2, "chip": 1}]), telemetry=tel)
    eng = _cluster(2, fault_injector=inj, telemetry=tel, queue_limit=3,
                   spillover=True, spillover_limit=2,
                   slo_config={"slos": [{"slo": "shed_fraction",
                                         "objective": 0.95}]})
    reqs = CHAOS_REQS

    def loop():
        k = eng.next_rid
        while not eng.idle or k < len(reqs):
            while k < len(reqs):
                eng.submit(*reqs[k])
                k += 1
            eng.step()
        return eng.result()

    sup = _supervised(eng, loop)
    base = _ref_areas(reqs)
    try:
        res = sup.run()
        assert sup.recoveries == [("host_loss", "resize_resume")]
        assert len(res.completed) == len(reqs)
        assert np.array_equal(res.areas, base)
        # the federation reconciles exactly
        assert eng.federation_reconcile() == []
        spill = eng.spillover_summary()["spillover_completed"]
        worker_retired = eng._federation.sum_over_workers(
            "ppls_stream_retired_total")
        coord = eng.federated_registry.get(
            "ppls_stream_retired_total").labels(
            process="coordinator").value
        assert coord == len(res.completed)
        assert worker_retired + spill == coord
        expo = eng.federated_registry.exposition()
        assert 'process="coordinator"' in expo
        assert 'process="0"' in expo
        assert eng.slo_health()["ok"] in (True, False)
    finally:
        eng.close()
        tel.close()

    text = open(ev_path).read()
    assert validate_events_text(text, check_rid_linkage=True) == []
    assert ref_validate_events(text, check_rid_linkage=True) == []
    recs = _recs(ev_path)
    names = [r["name"] for r in recs if r.get("ev") == "event"]
    assert {"host_killed", "host_loss_discovery", "cluster_redeal",
            "request_redeal"} <= set(names)
    trace, _ = _rid_trace([ev_path])
    for rid in range(len(reqs)):
        assert (rid, "retire") in trace, f"rid {rid} has no trace"
    # process spans carry the rid linkage the workers shipped back
    assert [r for r in recs if r.get("ev") == "span_close"
            and "rids" in (r.get("attrs") or {})]
    rep = analyze([ev_path])
    assert rep["exact"] and not rep["incomplete"]
    assert len(rep["requests"]) == len(reqs)
    assert any(d["redeals"] > 0 for d in rep["requests"])


def test_trace_survives_kill_and_resume(tmp_path):
    base_ev = str(tmp_path / "b.jsonl")
    tel0 = Telemetry(events_path=base_ev)
    e0 = _cluster(2, telemetry=tel0)
    try:
        e0.run(REQS6, arrival_phase=ARR6)
    finally:
        e0.close()
        tel0.close()

    ck = str(tmp_path / "c.ckpt")
    kill_ev = str(tmp_path / "k.jsonl")
    tel1 = Telemetry(events_path=kill_ev)
    e1 = _cluster(2, telemetry=tel1, checkpoint_path=ck,
                  checkpoint_every=1)
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            e1.run(REQS6, arrival_phase=ARR6, _crash_after_phases=3)
    finally:
        e1.close()
        tel1.close()
    assert validate_events_text(open(kill_ev).read(),
                                require_balanced=False,
                                check_rid_linkage=True) == []

    tel2 = Telemetry(events_path=kill_ev, append=True)
    e2 = ClusterStreamEngine.resume(ck, "quad_scaled", 1e-9,
                                    n_processes=2, worker_kw=WKW,
                                    telemetry=tel2, checkpoint_every=1,
                                    device="cpu")
    try:
        k = e2.next_rid
        while not e2.idle or k < len(REQS6):
            while k < len(REQS6) and ARR6[k] <= e2.phase:
                e2.submit(*REQS6[k])
                k += 1
            e2.step()
        assert len(e2.result().completed) == len(REQS6)
    finally:
        e2.close()
        tel2.close()

    base_tr, base_res = _rid_trace([base_ev])
    kill_tr, kill_res = _rid_trace([kill_ev])
    assert kill_tr == base_tr and kill_res == base_res
    rep = analyze([kill_ev])
    assert rep["exact"] and not rep["incomplete"]
    assert len(rep["requests"]) == len(REQS6)
