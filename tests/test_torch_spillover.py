"""CPU spillover in the port's streaming engine against the reference's,
on the CPU: the single-engine cases of tests/test_cluster.py (:213, :238,
:250, :782, :896, :931, :966, :983; its :272 and :289, the executor and
the single-integral arm, are in tests/test_torch_backends.py), each run
through both engines on the same requests.

Their configuration: the dyadic ``quad_scaled`` family on [0, 1] at eps
1e-9, 4 slots, 256 lanes, in the float64 streaming mode
(``f64_rounds=2``) and, once more, through the walk (``f64_rounds=0``,
K1's plain segment). Dyadic credits make every area exact, so records
are held equal field by field, areas bit for bit.
"""

import numpy as np
import pytest

from ppls_tpu.runtime import stream as RS
from ppls_tpu_torch.obs.telemetry import Telemetry
from ppls_tpu_torch.runtime import stream as TS

FAM, EPS = "quad_scaled", 1e-9
WKW = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
           roots_per_lane=2, refill_slots=2, seg_iters=32,
           min_active_frac=0.05, f64_rounds=2)
THETA8 = [1.0, 1.25, 1.5, 2.0, 0.75, 3.0, 1.75, 2.5]
REQS8 = [(t, (0.0, 1.0)) for t in THETA8]
SPILL = dict(queue_limit=2, spillover=True, spillover_limit=1)


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


def _ref(**kw):
    return RS.StreamEngine(FAM, EPS, **dict(WKW, **kw))


def _port(**kw):
    return TS.StreamEngine(FAM, EPS, device="cpu", **dict(WKW, **kw))


def _records(completed):
    # a failed record's area is NaN: compared as None
    return sorted((c.rid, None if c.failed else c.area, c.areas,
                   c.admit_phase, c.retire_phase,
                   c.submit_phase, c.spillover, c.failed, c.failure,
                   c.first_seeded_phase, c.last_credited_phase)
                  for c in completed)


def _sheds(shed):
    return [(s.rid, s.reason, s.phase, s.submit_phase) for s in shed]


def _drive(eng, reqs, arr):
    k = eng.next_rid
    while not eng.idle or k < len(reqs):
        while k < len(reqs) and arr[k] <= eng.phase:
            eng.submit(*reqs[k])
            k += 1
        eng.step()
    return eng.result()


@pytest.mark.parametrize("f64_rounds", [2, 0])
def test_spillover_engages_under_overload_and_matches_reference(f64_rounds):
    events = []

    class Tel(Telemetry):
        def request_event(self, span, name, **attrs):
            events.append(name)
            return super().request_event(span, name, **attrs)

    tel = Tel()
    kw = dict(queue_limit=2, spillover=True, spillover_limit=2,
              f64_rounds=f64_rounds)
    ref = _ref(**kw).run(REQS8, arrival_phase=[0] * 8)
    eng = _port(telemetry=tel, **kw)
    got = eng.run(REQS8, arrival_phase=[0] * 8)
    base = _port(f64_rounds=f64_rounds).run(REQS8)
    assert _records(got.completed) == _records(ref.completed)
    assert got.phases == ref.phases
    assert np.array_equal(got.areas, base.areas)
    assert not got.shed and len(got.completed) == 8
    s = got.spillover_summary()
    assert s == ref.spillover_summary() and s["spillover_completed"] > 0
    assert eng.spillover_summary()["spillover_tasks"] > 0
    assert "spillover_enqueued" in events
    assert tel.registry.value("ppls_spillover_tasks_total") \
        == eng.spillover_summary()["spillover_tasks"]
    assert tel.registry.value("ppls_stream_spillover_total") \
        == s["spillover_completed"]
    assert got.totals == {k: ref.totals[k] for k in got.totals}


def test_spillover_deadline_requests_still_shed():
    out = []
    for make in (_ref, _port):
        eng = make(queue_limit=1, spillover=True)
        for t in [1.0, 1.25, 1.5]:
            eng.submit(t, (0.0, 1.0), deadline_phases=2)
        assert len(eng.shed) == 2
        assert all(s.reason == "queue_full" for s in eng.shed)
        eng.drain()
        out.append((_sheds(eng.shed), _records(eng.completed)))
    assert out[0] == out[1]


def _crashed(tmp_path, make, name, phases=2):
    ck = str(tmp_path / name)
    eng = make(checkpoint_path=ck, checkpoint_every=1, **SPILL)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run(REQS8, arrival_phase=[0] * 8, _crash_after_phases=phases)
    return ck, eng


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("port", "reference"), ("reference", "port")])
def test_spillover_queue_survives_kill_and_resume(tmp_path, writer,
                                                  reader):
    """The spill queue rides the snapshot: a crash with spillover work
    queued resumes (in either package, from either package's snapshot)
    and completes every request with the uninterrupted run's records."""
    full = _port(**SPILL).run(REQS8, arrival_phase=[0] * 8)
    make_w = _port if writer == "port" else _ref
    ck, _ = _crashed(tmp_path, make_w, "spill.ckpt")
    if reader == "port":
        eng2 = TS.StreamEngine.resume(ck, FAM, EPS, device="cpu",
                                      checkpoint_every=1,
                                      **dict(WKW, **SPILL))
    else:
        eng2 = RS.StreamEngine.resume(ck, FAM, EPS, checkpoint_every=1,
                                      **dict(WKW, **SPILL))
    assert eng2._spill_queue                    # acknowledged work kept
    res = _drive(eng2, REQS8, [0] * 8)
    assert np.array_equal(res.areas, full.areas)
    assert _records(res.completed) == _records(full.completed)


def test_spillover_resume_without_backend_refuses(tmp_path):
    ck, _ = _crashed(tmp_path, _port, "nospill.ckpt")
    with pytest.raises(ValueError, match="spillover"):
        TS.StreamEngine.resume(ck, FAM, EPS, device="cpu",
                               checkpoint_every=1,
                               **dict(WKW, queue_limit=2))


def test_spillover_idle_tail_phases_checkpoint(tmp_path):
    """An idle phase (device drained, spill queue busy) runs one spillover
    batch and keeps the snapshot cadence: the resumed queue is the live
    one's, in both engines alike."""
    reqs = [(t, (0.0, 1.0)) for t in THETA8 + [0.5, 1.125, 2.25, 2.75]]
    out = []
    for make, cls, kw in ((_ref, RS.StreamEngine, {}),
                          (_port, TS.StreamEngine, dict(device="cpu"))):
        ck = str(tmp_path / f"tail{len(out)}.ckpt")
        eng = make(checkpoint_path=ck, checkpoint_every=1, **SPILL)
        for r in reqs:
            eng.submit(*r)
        for _ in range(64):
            if eng._count == 0 and not eng.pending and eng._spill_queue:
                break
            eng.step()
        qlen = len(eng._spill_queue)
        assert qlen >= 1
        done = eng.step()                 # one idle phase: one spill
        assert len(eng._spill_queue) == qlen - 1
        assert [c.spillover for c in done] == [True]
        eng2 = cls.resume(ck, FAM, EPS, checkpoint_every=1,
                          **dict(WKW, **SPILL, **kw))
        assert len(eng2._spill_queue) == len(eng._spill_queue)
        assert eng2.phase == eng.phase
        out.append((eng.phase, qlen, _sheds(eng.shed),
                    _records(eng.completed)))
    assert out[0] == out[1]


def test_spillover_engagement_totals_survive_kill_and_resume(tmp_path):
    ck, eng = _crashed(tmp_path, _port, "spilltot.ckpt", phases=3)
    pre_req, pre_tasks = eng._spill.requests_total, eng._spill.tasks_total
    assert pre_req > 0 and pre_tasks > 0
    eng2 = TS.StreamEngine.resume(ck, FAM, EPS, device="cpu",
                                  checkpoint_every=1, **dict(WKW, **SPILL))
    ref2 = RS.StreamEngine.resume(ck, FAM, EPS, checkpoint_every=1,
                                  **dict(WKW, **SPILL))
    assert 0 < eng2._spill.requests_total <= pre_req
    assert 0 < eng2._spill.tasks_total <= pre_tasks
    assert (eng2._spill.requests_total, eng2._spill.tasks_total) \
        == (ref2._spill.requests_total, ref2._spill.tasks_total)
    reg = eng2.telemetry.registry
    assert reg.value("ppls_spillover_requests_total") \
        == eng2._spill.requests_total
    assert reg.value("ppls_stream_spillover_total") \
        == ref2.telemetry.registry.value("ppls_stream_spillover_total")
    restored = eng2._spill.tasks_total
    res = _drive(eng2, REQS8, [0] * 8)
    assert len(res.completed) == 8
    assert eng2._spill.tasks_total > restored


def test_spillover_queue_is_bounded_then_sheds():
    out = []
    for make in (_ref, _port):
        eng = make(queue_limit=1, spillover=True, spillover_limit=1)
        for k in range(12):
            eng.submit(1.0 + 0.25 * k, (0.0, 1.0))
        assert len(eng._spill_queue) == 8          # 8 x spillover_limit
        assert len(eng.shed) == 3                  # 12 - 1 pending - 8
        assert all(s.reason == "spill_queue_full" for s in eng.shed)
        res = _drive(eng, [], [])
        assert len(res.completed) == 9
        assert not any(c.failed for c in res.completed)
        out.append((_sheds(eng.shed), _records(res.completed)))
    assert out[0] == out[1]


def test_spillover_quarantines_poisoned_request():
    out = []
    for make in (_ref, _port):
        eng = make(queue_limit=1, spillover=True, spillover_limit=2,
                   quarantine=True)
        eng.submit(2.0, (0.0, 1.0))                # engine path
        eng.submit(3.0, (0.0, 1.0))                # healthy spill
        eng.submit(1.5, (0.0, 1.0))                # to be poisoned
        assert len(eng._spill_queue) == 2
        eng._spill_queue[1].theta = float("nan")
        res = _drive(eng, [], [])
        by_rid = {c.rid: c for c in res.completed}
        assert by_rid[2].failed and by_rid[2].failure == "nan"
        assert by_rid[2].spillover
        assert not by_rid[0].failed and not by_rid[1].failed
        out.append([(c.rid, None if c.failed else c.area, c.spillover,
                     c.failure, c.admit_phase, c.retire_phase)
                    for c in sorted(res.completed, key=lambda c: c.rid)])
    assert out[0] == out[1]
