"""The walker-dd stream of the port (``StreamEngine(engine="walker-dd")``,
``ppls_tpu_torch/runtime/stream.py`` over ``mesh.World``) against the
reference's, on the CPU, at the reference tests' sizes
(tests/test_stream.py, tests/test_faults.py, tests/test_multitenant.py,
tests/test_theta_walker.py: slots 8, chunk 2^8, capacity 2^16, 256
lanes, roots_per_lane 2, R = 2, seg_iters 32, the arrivals [0, 0, 1, 2,
3, 4]).

The port's ranks are gloo processes of a world that lives as long as
the engine (rank 0 in this process); the reference runs on its host
devices at the same world size, in a thread beside the port. Held:

* on the dyadic ``quad_scaled`` family (every credit and cross-rank sum
  exact), worlds of 2 and 4: the retire records, the phase rows and the
  flight recorder's chip spans (per-rank kernel steps, tasks, waste,
  live rows) equal to the reference's, item for item;
* on sin(theta / x) at eps 1e-9 (tests/test_stream.py's parity case),
  world 2: every request retires, areas within 1e-9 of the float64 bag
  and of the reference's. The reference's ds walk runs in interpret mode
  through XLA on the CPU, which contracts its float32 multiply-adds
  (tests/test_torch_walk_segment.py): it flips a few splits, and the
  phase reshard carries the flips into every later deal, so its phases
  are not the port's there (they are on one rank, and on the dyadic
  family);
* kill-and-resume bit-identical with the flight recorder, the reference
  resuming the port's snapshot; the resize 2 -> 1 bit-identical, refused
  without ``mesh_resize``; the supervisor's chip-loss loop; the NaN
  quarantine; the theta-batch snapshot; the admit program against the
  reference's on the same operands; deadline expiry (the contract of
  tests/test_multitenant.py::test_deadline_expiry_dd_engine, which fails
  on the reference under jax 0.9, held here on the port alone, its solo
  run held against the reference's);
* the world: no follower outlives ``close()`` or a raise, a killed
  follower fails the next phase naming its rank.
"""

import concurrent.futures
import json
import os
import shutil
import signal
import time

import numpy as np
import pytest

from ppls_tpu.models.integrands import get_family as ref_family
from ppls_tpu.obs import Telemetry as RefTelemetry
from ppls_tpu.parallel.bag_engine import integrate_family as ref_bag
from ppls_tpu.runtime import stream as RS
from ppls_tpu_torch.obs.telemetry import Telemetry
from ppls_tpu_torch.parallel.mesh import World
from ppls_tpu_torch.runtime import guard
from ppls_tpu_torch.runtime import stream as TS
from ppls_tpu_torch.runtime.faults import FaultInjector, FaultPlan
from ppls_tpu_torch.utils.artifact_schema import validate_events_text

FAM = "sin_recip_scaled"
DYA = "quad_scaled"
EPS = 1e-9
KW = dict(slots=8, chunk=1 << 8, capacity=1 << 16, lanes=256,
          roots_per_lane=2, refill_slots=2, seg_iters=32,
          min_active_frac=0.05, engine="walker-dd")
THETA = 1.0 + np.arange(6) / 6.0
BOUNDS = (1e-3, 1.0)
REQS = [(float(t), BOUNDS) for t in THETA]
ARR = [0, 0, 1, 2, 3, 4]
# tests/test_faults.py's dyadic workload
REQS6 = [(t, (0.0, 1.0)) for t in [1.0, 1.25, 1.5, 2.0, 0.75, 3.0]]
BAG_TOL = 1e-9


def _port(fam, n, **kw):
    return TS.StreamEngine(fam, EPS, n_devices=n, device="cpu",
                           **dict(KW, **kw))


def _ref(fam, n, **kw):
    return RS.StreamEngine(fam, EPS, n_devices=n, **dict(KW, **kw))


def _drive(eng, reqs, arr):
    """Submit on the arrival schedule (from ``eng.next_rid`` on) and run
    phases until everything retired."""
    k = eng.next_rid
    while not eng.idle or k < len(reqs):
        while k < len(reqs) and arr[k] <= eng.phase:
            eng.submit(*reqs[k])
            k += 1
        eng.step()
    return eng.result()


def _surface(path):
    """tests/test_stream.py's deterministic timeline surface: retire
    records without the wall latency, phase spans, per-rank chip spans."""
    retires, phases, chips = [], [], []
    for ln in open(path):
        r = json.loads(ln)
        if r["ev"] == "event" and r.get("name") == "retire":
            a = dict(r["attrs"])
            a.pop("latency_s", None)
            retires.append(a)
        elif r["ev"] == "span_close":
            a = r.get("attrs") or {}
            if "wsteps" in a and "live_rows" in a:
                chips.append(a)
            elif a.get("tasks") is not None:
                phases.append(a)
    return sorted(retires, key=lambda a: a["rid"]), phases, chips


def _timed(tel_cls, path, make, run):
    tel = tel_cls(events_path=path)
    try:
        res = run(make(tel))
    finally:
        tel.close()
    return res, _surface(path)


def _reference_runs(tmp) -> dict:
    out = {"parity": _ref(FAM, 2).run(REQS, arrival_phase=ARR)}
    for n in (2, 4):
        out[f"dyadic{n}"] = _timed(
            RefTelemetry, str(tmp / f"ref{n}.jsonl"),
            lambda tel, n=n: _ref(DYA, n, telemetry=tel),
            lambda e: e.run(REQS6, arrival_phase=ARR))
    out["solo"] = _ref(FAM, 2).run([(1.5, BOUNDS)])
    return out


@pytest.fixture(scope="module", autouse=True)
def _table_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs in a thread; the port's beside them."""
    tmp = tmp_path_factory.mktemp("dd_stream")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ref = ex.submit(_reference_runs, tmp)
        port = {}
        with _port(FAM, 2) as e:
            port["parity"] = e.run(REQS, arrival_phase=ARR)
        for n in (2, 4):
            port[f"dyadic{n}"] = _timed(
                Telemetry, str(tmp / f"port{n}.jsonl"),
                lambda tel, n=n: _port(DYA, n, telemetry=tel),
                lambda e: _close_after(e, e.run, REQS6, arrival_phase=ARR))
        # kill after 3 phases, resume on the same world, with the recorder
        ck = str(tmp / "dd.ckpt")
        tel = Telemetry(events_path=str(tmp / "crash.jsonl"))
        eng = _port(DYA, 2, telemetry=tel, checkpoint_path=ck,
                    checkpoint_every=1)
        try:
            eng.run(REQS6, arrival_phase=ARR, _crash_after_phases=3)
        except RuntimeError as e:
            port["crash"] = e
        finally:
            eng.close()
            tel.close()
        port["crash_surface"] = _surface(str(tmp / "crash.jsonl"))
        port["events"] = [str(tmp / f) for f in ("crash.jsonl",
                                                  "resume.jsonl")]
        port["snapshot"] = str(tmp / "dd_phase3.ckpt")
        shutil.copy(ck, port["snapshot"])
        port["resumed"] = _timed(
            Telemetry, str(tmp / "resume.jsonl"),
            lambda tel: TS.StreamEngine.resume(
                ck, DYA, EPS, telemetry=tel, checkpoint_every=1,
                n_devices=2, device="cpu", **KW),
            lambda e: _close_after(e, _drive, e, REQS6, ARR))
        port["bag"] = ref_bag(ref_family(FAM), THETA, BOUNDS, EPS,
                              chunk=1 << 10, capacity=1 << 17)
        return port, ref.result()


def _close_after(eng, fn, *args, **kw):
    try:
        return fn(*args, **kw)
    finally:
        eng.close()


def test_dyadic_stream_equals_the_reference_on_two_and_four_ranks(runs):
    """Retire records, phase rows and per-rank chip spans equal to the
    reference's, item for item, at worlds of 2 and 4."""
    port, ref = runs
    for n in (2, 4):
        (p_res, p_surf), (r_res, r_surf) = port[f"dyadic{n}"], \
            ref[f"dyadic{n}"]
        assert np.array_equal(p_res.areas, r_res.areas)
        assert p_res.phases == r_res.phases
        assert np.array_equal(p_res.phase_stats, r_res.phase_stats)
        assert p_res.totals == r_res.totals
        assert p_surf == r_surf
        assert p_surf[2] and len(p_surf[2]) == n * p_res.phases
        assert p_res.mesh["world"] == n and p_res.mesh["backend"] == "gloo"


def test_phase_rows_per_rank(runs):
    """Each phase row's tasks, splits and crounds, and each rank's
    kernel steps (the chip spans), sum to the mesh totals; crounds is
    nonzero (the phase reshard runs)."""
    port, _ = runs
    res, (_r, phases, chips) = port["dyadic2"]
    f = TS.STREAM_STAT_FIELDS.index
    ws = res.phase_stats[:, f("wsteps")]
    per_rank = np.array([c["wsteps"] for c in chips]).reshape(-1, 2)
    assert np.array_equal(per_rank.sum(axis=1), ws)
    assert [p["tasks"] for p in phases] == \
        res.phase_stats[:, f("tasks")].tolist()
    assert [p["splits"] for p in phases] == \
        res.phase_stats[:, f("splits")].tolist()
    assert res.totals["crounds"] == int(res.phase_stats[:, f("crounds")]
                                        .sum()) > 0


def test_stream_dd_parity_on_mesh(runs):
    """tests/test_stream.py's parity case at world 2: every request
    retires, areas within 1e-9 of the float64 bag and of the reference's
    areas; the walker does most of the work."""
    port, ref = runs
    res, r_res = port["parity"], ref["parity"]
    assert sorted(c.rid for c in res.completed) == list(range(len(REQS)))
    assert np.max(np.abs(res.areas - port["bag"].areas)) < BAG_TOL
    assert np.max(np.abs(res.areas - r_res.areas)) < BAG_TOL
    assert res.occupancy_summary(KW["lanes"])["walker_fraction"] > 0.3
    # one gather per phase on rank 0's host syncs: at most the walker's
    # own reads plus one
    assert len(res.host_syncs_per_phase) == res.phases


def test_stream_dd_requires_refill():
    for eng in (TS.StreamEngine, RS.StreamEngine):
        extra = {"device": "cpu"} if eng is TS.StreamEngine else {}
        with pytest.raises(ValueError, match="refill_slots"):
            eng(FAM, EPS, n_devices=2, **dict(KW, refill_slots=0),
                **extra)


def test_stream_dd_kill_and_resume_with_flight_recorder(runs, tmp_path):
    """Kill after 3 phases, resume on the same world: areas, totals and
    phases equal the uninterrupted run's; the timeline union (retires,
    phase spans, chip spans) equals the uninterrupted run's and the
    reference's; both files validate. The reference resumes the port's
    snapshot and ends with the same areas."""
    port, ref = runs
    base, base_surf = port["dyadic2"]
    assert "simulated crash" in str(port["crash"])
    res, res_surf = port["resumed"]
    assert np.array_equal(res.areas, base.areas)
    assert res.totals == base.totals and res.phases == base.phases
    crash_r, crash_p, crash_c = port["crash_surface"]
    assert sorted(crash_r + res_surf[0], key=lambda a: a["rid"]) \
        == base_surf[0] == ref["dyadic2"][1][0]
    assert crash_p + res_surf[1] == base_surf[1]
    assert crash_c + res_surf[2] == base_surf[2] == ref["dyadic2"][1][2]
    for path in port["events"]:
        assert validate_events_text(open(path).read(),
                                    require_balanced=False) == []
    path = str(tmp_path / "for_ref.ckpt")
    shutil.copy(port["snapshot"], path)
    eng = RS.StreamEngine.resume(path, DYA, EPS, checkpoint_every=1,
                                 n_devices=2, **KW)
    assert eng.phase == 3
    assert np.array_equal(_drive(eng, REQS6, ARR).areas, base.areas)


def test_stream_dd_resize_resume_bit_identical_on_dyadic(runs, tmp_path):
    """The snapshot of 2 ranks resumes on 1 with ``mesh_resize``: areas
    bit-identical to the undisturbed run; without the flag refused."""
    port, _ = runs
    base = port["dyadic2"][0]
    path = str(tmp_path / "resize.ckpt")
    shutil.copy(port["snapshot"], path)
    with pytest.raises(ValueError, match="different run"):
        TS.StreamEngine.resume(path, DYA, EPS, checkpoint_every=1,
                               n_devices=1, device="cpu", **KW)
    with TS.StreamEngine.resume(path, DYA, EPS, mesh_resize=True,
                                checkpoint_every=1, n_devices=1,
                                device="cpu", **KW) as eng:
        assert eng.phase == 3
        res = _drive(eng, REQS6, ARR)
    assert np.array_equal(res.areas, base.areas)
    assert res.phases == base.phases and len(res.completed) == 6


def test_supervisor_chip_loss_resize_resume_end_to_end(runs, tmp_path):
    """A ``chip_loss`` fault at phase 3 on 2 ranks: the Supervisor
    resize-resumes onto the survivor and the drained areas equal the
    undisturbed run's, bit for bit."""
    port, _ = runs
    base = port["dyadic2"][0]
    ck = str(tmp_path / "sup.ckpt")
    inj = FaultInjector(FaultPlan.from_events(
        [{"kind": "chip_loss", "at": 3}]))
    state = {"n": 2}
    engines = []

    def loop():
        kw = dict(checkpoint_every=1, fault_injector=inj, quarantine=True)
        if os.path.exists(ck):
            eng = TS.StreamEngine.resume(ck, DYA, EPS, mesh_resize=True,
                                         n_devices=state["n"],
                                         device="cpu", **kw, **KW)
        else:
            eng = _port(DYA, state["n"], checkpoint_path=ck, **kw)
        engines.append(eng)
        try:
            return _drive(eng, REQS6, ARR)
        finally:
            eng.close()

    def resize_fn(exc):
        state["n"] = exc.surviving
        return loop

    sup = guard.Supervisor(loop, resize_fn=resize_fn, telemetry=Telemetry(),
                           log=lambda m: None, sleep=lambda s: None)
    res = sup.run()
    assert sup.recoveries == [("chip_loss", "resize_resume")]
    assert state["n"] == 1 and len(engines) == 2
    assert np.array_equal(res.areas, base.areas)
    assert len(res.completed) == len(REQS6)


@pytest.mark.nan_injection
def test_dd_stream_quarantine_contains_poisoned_request():
    """``nan_poison`` turns one admitted theta NaN: with quarantine that
    request retires failed, every other area bit-equal to the run
    without the fault, and the recycled slot's next tenant is clean."""
    reqs = REQS6[:4]
    with _port(DYA, 1) as e:
        base = e.run(reqs)
    inj = FaultInjector(FaultPlan.from_events(
        [{"kind": "nan_poison", "at": 1}]))
    with _port(DYA, 1, quarantine=True, fault_injector=inj) as e:
        res = e.run(reqs)
        by_rid = {c.rid: c for c in res.completed}
        assert by_rid[1].failed and by_rid[1].failure == "nan"
        assert [r for r in by_rid if not by_rid[r].failed] == [0, 2, 3]
        want = {c.rid: c.area for c in base.completed}
        for r in (0, 2, 3):
            assert by_rid[r].area == want[r]
        # the poisoned slot's next tenant starts from a cleared partial
        e.submit(*reqs[1])
        again = e.drain()
        assert not again[0].failed and again[0].area == want[1]
    with _port(DYA, 1, fault_injector=FaultInjector(FaultPlan.from_events(
            [{"kind": "nan_poison", "at": 1}]))) as e:
        with pytest.raises(FloatingPointError, match="non-finite"):
            e.run(reqs)


def test_dd_stream_theta_snapshot_resume_state_roundtrip(tmp_path):
    """tests/test_theta_walker.py's state-only round trip (no phase):
    the (n, slots * T) accumulator and the theta table come back, in the
    port and in the reference resuming the port's snapshot."""
    T = 8
    kw = dict(KW, slots=4, chunk=1 << 9, seg_iters=2048, theta_block=T)
    path = str(tmp_path / "ddst.ckpt")
    eng = TS.StreamEngine("sin_scaled", 1e-6, n_devices=2, device="cpu",
                          checkpoint_path=path, **kw)
    try:
        eng.submit([1.0, 2.0], (0.0, 1.0))
        eng._ensure_state(eng._pending[0])       # ranks and stores, no phase
        eng._theta_table[1] = 7.0
        eng.snapshot()
    finally:
        eng.close()
    with TS.StreamEngine.resume(path, "sin_scaled", 1e-6, n_devices=2,
                                device="cpu", **kw) as eng2:
        st = eng2._world.call("snapshot_rows")
        assert st["acc"].shape == (2, kw["slots"] * T)
        assert np.array_equal(eng2._theta_table, eng._theta_table)
        assert eng2.pending == 1
    ref = RS.StreamEngine.resume(path, "sin_scaled", 1e-6, n_devices=2,
                                 **kw)
    assert ref._dd_state[5].shape == (2, kw["slots"] * T)
    assert np.array_equal(ref._theta_table, eng._theta_table)


def test_admit_program_matches_the_reference():
    """``build_dd_walker_run(admit_window=)`` on one rank against the
    reference's compiled program on a mesh of one device, over two
    phases from the same operands (seeds admitted into an empty store,
    then a recycled slot cleared and two more admitted): the same live
    prefix, count, partial areas, counters and family live counts."""
    import jax.numpy as jnp
    import torch

    from ppls_tpu.parallel import sharded_walker as RSW
    from ppls_tpu.parallel.mesh import make_mesh as ref_mesh
    from ppls_tpu_torch.parallel import sharded_walker as TSW
    m, aw, fill_x, fill_th = 4, 4, 0.5, 1.0
    tl, bc, store, rw = TSW._dd_sizing(256, 1 << 16, 1 << 8, 2)
    args = (DYA, EPS, bc, 1 << 16, m, 256, 32, 8, 0.05, 0.8, 0.5, tl)
    tail = (1, fill_x, fill_th)
    kw = dict(refill_slots=2, reshard_window=rw, admit_window=aw)
    rrun = RSW.build_dd_walker_run(ref_mesh(1), *args, True, *tail, **kw)
    world = World(1, "cpu", lambda mesh: mesh)
    try:
        prun = TSW.build_dd_walker_run(world.mesh, *args, *tail, **kw)
        c = TSW._DDCarry(
            bag_l=torch.full((store,), fill_x, dtype=torch.float64),
            bag_r=torch.full((store,), fill_x, dtype=torch.float64),
            bag_th=torch.full((store,), fill_th, dtype=torch.float64),
            bag_meta=torch.zeros(store, dtype=torch.int32), count=0,
            acc=torch.zeros(m, dtype=torch.float64),
            ctr=dict.fromkeys(TSW.CTR64, 0),
            waste=np.zeros(5, dtype=np.int64),
            evals=np.zeros(2, dtype=np.int64), maxd=0, overflow=False)
        z = np.zeros(1, np.int64)
        rstate = (jnp.full(store, fill_x), jnp.full(store, fill_x),
                  jnp.full(store, fill_th), jnp.zeros(store, jnp.int32),
                  jnp.zeros(1, jnp.int32), jnp.zeros((1, m)))
        rctr = tuple(jnp.asarray(z) for _ in range(11)) + (
            jnp.zeros((1, 5), jnp.int64), jnp.zeros((1, 2), jnp.int64),
            jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32),
            jnp.zeros(1, bool))
        phases = [([1.0, 1.5, 2.0], [0, 1, 2], []),
                  ([0.75, 3.0], [1, 3], [1])]
        for thetas, slots, cleared in phases:
            blk = np.array([[0.0] * aw, [1.0] * aw,
                            thetas + [fill_th] * (aw - len(thetas)),
                            [s << 14 for s in slots]
                            + [0] * (aw - len(slots))])
            blk[0, len(thetas):] = fill_x
            blk[1, len(thetas):] = fill_x
            clear = np.isin(np.arange(m), cleared)
            c, _cyc, _left, fam = prun(
                c, (blk[0], blk[1], blk[2], blk[3].astype(np.int32),
                    len(thetas), clear))
            out = rrun(*rstate, *rctr, jnp.asarray(blk[0]),
                       jnp.asarray(blk[1]), jnp.asarray(blk[2]),
                       jnp.asarray(blk[3].astype(np.int32)),
                       jnp.asarray([len(thetas)], jnp.int32),
                       jnp.asarray(clear[None]))
            rstate = out[:6]
            rctr = out[6:20] + (jnp.zeros(1, jnp.int32), out[21])
            n = int(out[4][0])
            assert c.count == n
            for col, j in ((c.bag_l, 0), (c.bag_r, 1), (c.bag_th, 2),
                           (c.bag_meta, 3)):
                assert np.array_equal(col[:n].numpy(),
                                      np.asarray(out[j])[:n])
            assert np.array_equal(c.acc.numpy(), np.asarray(out[5])[0])
            assert [c.ctr[k] for k in TSW.CTR64] == \
                [int(np.asarray(v)[0]) for v in out[6:17]]
            assert np.array_equal(fam.numpy(), np.asarray(out[22])[0])
    finally:
        world.close()


def test_deadline_expiry_dd_engine(runs):
    """tests/test_multitenant.py's dd contract, held on the port: rid 0
    retires ``deadline_exceeded``, rid 1's area is finite and within
    1e-9 of the float64 bag, and a later fresh request's area equals a
    solo dd-stream run's bit for bit; the solo run is within 1e-9 of the
    reference's solo run."""
    _port_, ref = runs
    with _port(FAM, 2) as eng:
        eng.submit(1.0, BOUNDS, deadline_phases=1)
        eng.submit(1.9, BOUNDS)
        done = {c.rid: c for c in eng.drain()}
        assert done[0].failed and done[0].failure == "deadline_exceeded"
        bag = ref_bag(ref_family(FAM), [1.9, 1.5], BOUNDS, EPS,
                      chunk=1 << 10, capacity=1 << 17).areas
        assert np.isfinite(done[1].area)
        assert abs(done[1].area - bag[0]) < BAG_TOL
        reg = eng.telemetry.registry
        assert reg.value("ppls_stream_quarantined_total") == 0
        eng.submit(1.5, BOUNDS)
        d2 = eng.drain()
    with _port(FAM, 2) as solo:
        s2 = solo.run([(1.5, BOUNDS)])
    assert d2[0].area == s2.completed[0].area
    assert abs(s2.completed[0].area - bag[1]) < BAG_TOL
    assert abs(s2.completed[0].area - ref["solo"].completed[0].area) \
        < BAG_TOL


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    with open(f"/proc/{pid}/stat") as fh:
        return fh.read().split()[2] != "Z"


def test_no_follower_outlives_close_or_a_raise():
    eng = _port(DYA, 2)
    eng.run(REQS6[:1])
    pids = eng._world.pids
    assert pids and all(_alive(p) for p in pids)
    eng.close()
    eng.close()                                 # idempotent
    assert not any(_alive(p) for p in pids)
    with pytest.raises(RuntimeError, match="this world of ranks is closed"):
        eng.submit(*REQS6[0])
        eng.step()
    with pytest.raises(ZeroDivisionError):
        with _port(DYA, 2) as e:
            e.run(REQS6[:1])
            pids = e._world.pids
            1 / 0
    assert not any(_alive(p) for p in pids)


def test_a_killed_follower_fails_the_next_phase_naming_its_rank():
    with _port(DYA, 2) as eng:
        eng.run(REQS6[:1])
        pid = eng._world.pids[0]
        os.kill(pid, signal.SIGKILL)
        time.sleep(0.2)
        eng.submit(*REQS6[1])
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1 of 2"):
            eng.step()
        assert time.monotonic() - t0 < 30
        assert not eng._world.open


def test_walker_dd_needs_the_card_unless_told(monkeypatch):
    """Without a card the dd stream refuses unless ``device="cpu"``; the
    walker engine refuses ``n_devices`` > 1."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.StreamEngine(FAM, EPS, n_devices=2, **KW)
    with pytest.raises(ValueError, match="walker-dd"):
        TS.StreamEngine(FAM, EPS, n_devices=2, device="cpu",
                        **dict(KW, engine="walker"))


def test_flight_recorder_matches_reference(tmp_path):
    """``obs/flight.py`` against the reference's on the same seeded
    per-rank values (one rank skewed, so the straggler detector fires):
    the same registry exposition and the same events and spans, apart
    from the timestamps; a one-rank recorder never reports a straggler."""
    from ppls_tpu.obs.flight import ChipFlightRecorder as RefRecorder
    from ppls_tpu_torch.obs.flight import ChipFlightRecorder
    rng = np.random.default_rng(11)
    phases = []
    for p in range(7):
        ws = rng.integers(10, 20, 3)
        ws[2] *= 8                                  # rank 2 straggles
        phases.append(dict(wsteps=ws, tasks=rng.integers(0, 99, 3),
                           live_rows=rng.integers(1, 50, 3),
                           bank_delta=rng.integers(-5, 5, 3),
                           waste=rng.integers(0, 9, (3, 5)),
                           crounds=int(p % 2)))
    out = []
    for tel_cls, rec_cls, tag in ((RefTelemetry, RefRecorder, "ref"),
                                  (Telemetry, ChipFlightRecorder, "port")):
        path = str(tmp_path / f"{tag}.jsonl")
        tel = tel_cls(events_path=path)
        rec = rec_cls(tel, 3)
        for p, kw in enumerate(phases):
            span = tel.span("phase", phase=p)
            rec.record_phase(p, **kw)
            span.close()
        one = rec_cls(tel, 1)
        one.record_phase(0, wsteps=[5], tasks=[1], live_rows=[2],
                         bank_delta=[0])
        text = tel.registry.exposition()
        tel.close()
        events = []
        for ln in open(path):
            r = json.loads(ln)
            r.pop("t", None)
            events.append(r)
        out.append((text, events[1:], rec._streak))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    assert out[0][2] == out[1][2]
    assert "ppls_straggler_events_total" in out[1][0]
    assert sum(1 for e in out[1][1] if e.get("name") == "straggler") == 2
