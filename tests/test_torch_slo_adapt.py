"""SLO evaluation and online adaptation: the port's ``obs/slo.py``,
``runtime/tune.py`` ``OnlineAdapter`` and their ``StreamEngine`` and
``serve`` wiring, against the reference on the same inputs (CPU, the
reference tests' sizes).

* SLO (tests/test_request_trace.py:381-509): config validation with the
  reference's messages; burn, one alert per entry, re-arm; the resume
  re-base (no spurious burn on replayed counters); the engine emitting
  ``slo_burn`` events, its ``slo_health`` verdict and registry equal to
  the reference engine's, across a kill-and-resume too.
* Online adaptation (tests/test_tune.py:293-409): hysteresis and band
  clamps, the state round trip and its band check; an adapting stream
  equal to the reference's (knob trajectory, ``knob_adapt`` events,
  stats rows), deterministic on a rerun; kill-and-resume bit-identical
  to the uninterrupted run, from a snapshot of either package; a
  snapshot with adapter state refused without ``adapt=True``; the
  spillover limit adapting under a spill backlog.
* ``serve --adapt --slo-config`` with ``--device cpu``: records and
  ``knob_adapt``/``slo_burn`` events equal to the same configuration run
  through ``StreamEngine`` in this process, and its ledger and
  ``knob_adapt`` events equal to the reference CLI's; a bad SLO config
  exits as the reference's does. The port's ``parse_slo_config`` is
  idempotent where the reference's is not, so the reference's ``serve``
  never burns on an unscoped target and the port's does (pinned).
"""

import contextlib
import io
import json

import numpy as np
import pytest

from ppls_tpu import __main__ as RCLI
from ppls_tpu.obs.slo import SloEvaluator as RefSlo
from ppls_tpu.obs.slo import parse_slo_config as ref_parse
from ppls_tpu.obs.telemetry import Telemetry as RefTelemetry
from ppls_tpu.runtime import tune as rt
from ppls_tpu.runtime.stream import StreamEngine as RefStream
from ppls_tpu_torch import __main__ as CLI
from ppls_tpu_torch.obs.slo import SloEvaluator, parse_slo_config
from ppls_tpu_torch.obs.telemetry import Telemetry
from ppls_tpu_torch.runtime import tune as pt
from ppls_tpu_torch.runtime.stream import StreamEngine

AREA_TOL = 3e-9
# tests/test_request_trace.py:54-59
KW = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
          roots_per_lane=2, refill_slots=2, seg_iters=32,
          min_active_frac=0.05, f64_rounds=2)
REQS6 = [(t, (0.0, 1.0)) for t in [1.0, 1.25, 1.5, 2.0, 0.75, 3.0]]
ARR6 = [0, 0, 1, 2, 3, 4]
SLO_TIGHT = {"windows": {"fast": 2, "slow": 4},
             "burn_thresholds": {"fast": 1.0, "slow": 1.0},
             "slos": [{"slo": "p99_latency_phases", "target": 1,
                       "objective": 0.99}]}
# tests/test_tune.py:338-342
ADAPT_KW = dict(slots=2, chunk=1 << 10, capacity=1 << 16, lanes=256,
                roots_per_lane=2, refill_slots=2, seg_iters=32,
                min_active_frac=0.05, adapt=True)
ADAPT_EPS = 1e-7
ADAPT_REQS = [(float(t), (1e-2, 1.0)) for t in 1.0 + np.arange(8) / 8.0]
ADAPT_ARR = [0, 0, 0, 0, 1, 2, 3, 5]


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


def _events(path, *names):
    with open(path, encoding="utf-8") as fh:
        recs = [json.loads(ln) for ln in fh if ln.strip()]
    return [(r["name"], r["attrs"]) for r in recs
            if r.get("ev") == "event" and r.get("name") in names]


def _port_eng(family, eps, tel=None, **kw):
    return StreamEngine(family, eps, device="cpu", telemetry=tel, **kw)


# ---------------------------------------------------------------------------
# SLO evaluation
# ---------------------------------------------------------------------------

SLO_SPECS = {
    "good": '{"slos": [{"slo": "shed_fraction", "objective": 0.95}]}',
    "empty": '{"slos": []}',
    "kind": '{"slos": [{"slo": "nope", "objective": 0.9}]}',
    "objective": '{"slos": [{"slo": "shed_fraction", "objective": 2}]}',
    "target": '{"slos": [{"slo": "p99_latency_phases", "objective": 0.9}]}',
    "windows": ('{"windows": {"fast": 9, "slow": 4}, "slos": '
                '[{"slo": "shed_fraction", "objective": 0.9}]}'),
    "class_on_counter": ('{"slos": [{"slo": "shed_fraction", '
                         '"objective": 0.9, "class": "2"}]}'),
    "not_json": "{slos",
}


@pytest.mark.parametrize("name", list(SLO_SPECS))
def test_slo_config_validation_as_the_reference(name, tmp_path):
    spec = SLO_SPECS[name]
    if name == "good":
        path = tmp_path / "slo.json"
        path.write_text(spec)
        assert parse_slo_config(spec) == ref_parse(spec)
        assert parse_slo_config(f"@{path}") == ref_parse(spec)
        assert parse_slo_config(spec)["windows"]["fast"] == 8
        return
    with pytest.raises(ValueError) as got:
        parse_slo_config(spec)
    with pytest.raises(ValueError) as ref:
        ref_parse(spec)
    assert str(got.value) == str(ref.value)


SCOPES = {"unscoped": {},
          "tenant": {"tenant": "pro"},
          "class": {"class": "2"}}


@pytest.mark.parametrize("scope", list(SCOPES))
def test_parse_slo_config_is_idempotent(scope):
    """The serve command validates --slo-config and the engine parses
    the normalized result again. The port's parse is idempotent; the
    reference's re-parse turns a null scope into the scope "None", so
    its serve never burns on an unscoped target (a deliberate
    divergence, pinned here)."""
    spec = {"slos": [dict({"slo": "p99_latency_phases", "target": 4,
                           "objective": 0.9}, **SCOPES[scope])]}
    once = parse_slo_config(spec)
    assert once == ref_parse(spec)
    assert parse_slo_config(once) == once
    again = ref_parse(ref_parse(spec))["slos"][0]
    for k in ("tenant", "class"):
        want = SCOPES[scope].get(k)
        assert once["slos"][0][k] == want
        assert again[k] == (want if want is not None else "None")


def _slo_pair(config):
    tel, rtel = Telemetry(), RefTelemetry()
    return (tel, SloEvaluator(config, tel)), (rtel, RefSlo(config, rtel))


def test_slo_burn_fires_and_rearms_as_the_reference():
    cfg = {"windows": {"fast": 2, "slow": 4},
           "burn_thresholds": {"fast": 2.0, "slow": 2.0},
           "slos": [{"slo": "p99_latency_phases", "target": 4,
                     "objective": 0.9, "class": "1"}]}
    (tel, ev), (rtel, rev) = _slo_pair(cfg)
    hists = [t.class_latency_histogram() for t in (tel, rtel)]
    # breaching, then quiet windows, then a fresh breach
    plan = [20] * 5 + [1] * 10 + [20] * 6
    counts = []
    for ph, v in enumerate(plan, start=1):
        for h in hists:
            h.labels(priority="1").observe(v)
        got, ref = ev.evaluate_slo(ph), rev.evaluate_slo(ph)
        assert got == ref, ph
        assert ev.health() == rev.health()
        counts.append(tel.registry.value(
            "ppls_slo_burn_total", tenant="*", slo="p99_latency_phases",
            **{"class": "1"}))
    # one increment per entry into the burning state: 1, then 2
    assert counts[4] == counts[14] == 1 and counts[-1] == 2
    assert ev.health()["ok"] is False
    assert tel.registry.exposition() == rtel.registry.exposition()


def test_slo_resume_rebase_no_spurious_burn():
    cfg = {"windows": {"fast": 2, "slow": 4},
           "burn_thresholds": {"fast": 2.0, "slow": 2.0},
           "slos": [{"slo": "shed_fraction", "objective": 0.9}]}
    (tel, ev), (rtel, rev) = _slo_pair(cfg)
    for t in (tel, rtel):
        t.shed_counter().labels(tenant="a", reason="queue_full").inc(50)
        t.registry.counter("ppls_stream_tenant_retired_total", "t",
                           ("tenant",)).labels(tenant="a").inc(50)
    ev.seed_base(100)
    rev.seed_base(100)
    for ph in range(101, 107):
        for t in (tel, rtel):
            t.registry.counter("ppls_stream_tenant_retired_total", "t",
                               ("tenant",)).labels(tenant="a").inc(3)
        assert ev.evaluate_slo(ph) == rev.evaluate_slo(ph) == []
    assert ev.health() == rev.health()
    assert ev.health()["ok"]


@pytest.mark.parametrize("mode", ["f64", "walker"])
def test_slo_engine_emits_burn_events_as_the_reference(tmp_path, mode):
    kw = dict(KW, slo_config=SLO_TIGHT)
    if mode == "walker":
        kw["f64_rounds"] = 0
    paths = [str(tmp_path / f"{k}.jsonl") for k in ("port", "ref")]
    tel, rtel = Telemetry(events_path=paths[0]), \
        RefTelemetry(events_path=paths[1])
    eng = _port_eng("quad_scaled", 1e-9, tel, **kw)
    ref = RefStream("quad_scaled", 1e-9, telemetry=rtel, **kw)
    got, want = eng.run(REQS6, arrival_phase=ARR6), \
        ref.run(REQS6, arrival_phase=ARR6)
    tel.close()
    rtel.close()
    assert not eng.slo_health()["ok"]
    assert eng.slo_health() == ref.slo_health()
    burns = _events(paths[0], "slo_burn")
    assert burns and burns == _events(paths[1], "slo_burn")
    assert burns[0][1]["fast_burn"] >= 1.0
    assert tel.registry.value("ppls_slo_burn_total", tenant="*",
                              slo="p99_latency_phases",
                              **{"class": "*"}) \
        == rtel.registry.value("ppls_slo_burn_total", tenant="*",
                               slo="p99_latency_phases", **{"class": "*"})
    assert np.array_equal(got.phase_stats, want.phase_stats)
    assert np.max(np.abs(got.areas - want.areas)) < AREA_TOL


def test_slo_engine_resume_rebases_as_the_reference(tmp_path):
    kw = dict(KW, slo_config=SLO_TIGHT, checkpoint_every=1)
    out = []
    for cls, tag in ((StreamEngine, "port"), (RefStream, "ref")):
        extra = {"device": "cpu"} if tag == "port" else {}
        path = str(tmp_path / f"{tag}.ckpt")
        eng = cls("quad_scaled", 1e-9, checkpoint_path=path, **kw, **extra)
        with pytest.raises(RuntimeError, match="simulated crash"):
            eng.run(REQS6, arrival_phase=ARR6, _crash_after_phases=3)
        eng2 = cls.resume(path, "quad_scaled", 1e-9, **kw, **extra)
        k = eng2.next_rid
        while not eng2.idle or k < len(REQS6):
            while k < len(REQS6) and ARR6[k] <= eng2.phase:
                eng2.submit(*REQS6[k])
                k += 1
            eng2.step()
        out.append((eng2.slo_health(), eng2.telemetry.registry.value(
            "ppls_slo_burn_total", tenant="*", slo="p99_latency_phases",
            **{"class": "*"}), eng2.result().phase_stats))
    (h, n, rows), (rh, rn, rrows) = out
    assert h == rh and n == rn
    assert np.array_equal(rows, rrows)


# ---------------------------------------------------------------------------
# online adaptation
# ---------------------------------------------------------------------------


def test_online_adapter_hysteresis_and_clamps_as_the_reference():
    a = pt.OnlineAdapter({"admit_budget": 4}, {"admit_budget": (1, 8)})
    r = rt.OnlineAdapter({"admit_budget": 4}, {"admit_budget": (1, 8)})
    plan = [1, 1, -1, 1, 1] + [1] * 20 + [-1] * 40 + [0, 1, 0, -1, -1]
    moves = []
    for p in plan:
        got = a.observe({"admit_budget": p})
        assert got == r.observe({"admit_budget": p})
        assert a.state() == r.state()
        moves += got
    assert moves[0] == {"knob": "admit_budget", "from": 4, "to": 5}
    assert max(m["to"] for m in moves) == 8
    assert min(m["to"] for m in moves) == 1
    assert pt.ADAPT_HYSTERESIS == rt.ADAPT_HYSTERESIS
    assert pt.ADAPT_WASTE_FRAC == rt.ADAPT_WASTE_FRAC


@pytest.mark.parametrize("defaults", [{"admit_budget": 4},
                                      {"spillover_limit": 3},
                                      {"admit_budget": 1,
                                       "spillover_limit": 1}])
def test_online_safe_bands_as_the_reference(defaults):
    assert pt.online_safe_bands(defaults) == rt.online_safe_bands(defaults)
    assert pt.OnlineAdapter(defaults).bands \
        == rt.OnlineAdapter(defaults).bands


def test_online_adapter_state_roundtrip_and_band_check():
    a = pt.OnlineAdapter({"admit_budget": 4}, {"admit_budget": (1, 8)})
    a.observe({"admit_budget": 1})
    st = a.state()
    b = pt.OnlineAdapter({"admit_budget": 4}, {"admit_budget": (1, 8)})
    b.restore(st)
    assert b.state() == st
    r = rt.OnlineAdapter({"admit_budget": 4}, {"admit_budget": (1, 8)})
    for bad in ({"values": {"admit_budget": 99}},):
        with pytest.raises(ValueError, match="safe band") as got:
            b.restore(bad)
        with pytest.raises(ValueError) as ref:
            r.restore(bad)
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="safe band") as got:
        pt.OnlineAdapter({"admit_budget": 16}, {"admit_budget": (1, 8)})
    with pytest.raises(ValueError) as ref:
        rt.OnlineAdapter({"admit_budget": 16}, {"admit_budget": (1, 8)})
    assert str(got.value) == str(ref.value)


def _drive(eng, reqs, arr, k=0, hist=None):
    """tests/test_tune.py's loop: submit on arrival, step to idle,
    the adapter's values after every phase."""
    while not eng.idle or k < len(reqs):
        while k < len(reqs) and arr[k] <= eng.phase:
            eng.submit(*reqs[k])
            k += 1
        eng.step()
        if hist is not None:
            hist.append(dict(eng._adapt.values))
    return eng.result()


@pytest.fixture(scope="module")
def ref_adapt(tmp_path_factory):
    """The reference's adapting stream on the burst, with its events."""
    path = str(tmp_path_factory.mktemp("adapt") / "ref.jsonl")
    tel = RefTelemetry(events_path=path)
    eng = RefStream("sin_recip_scaled", ADAPT_EPS, telemetry=tel,
                    **ADAPT_KW)
    hist = []
    res = _drive(eng, ADAPT_REQS, [0] * len(ADAPT_REQS), hist=hist)
    tel.close()
    return eng, res, hist, _events(path, "knob_adapt")


def test_stream_adaptation_as_the_reference_and_deterministic(tmp_path,
                                                              ref_adapt):
    r_eng, r_res, r_hist, r_events = ref_adapt
    runs = []
    for i in range(2):
        path = str(tmp_path / f"p{i}.jsonl")
        tel = Telemetry(events_path=path)
        eng = _port_eng("sin_recip_scaled", ADAPT_EPS, tel, **ADAPT_KW)
        hist = []
        res = _drive(eng, ADAPT_REQS, [0] * len(ADAPT_REQS), hist=hist)
        tel.close()
        runs.append((eng, res, hist, _events(path, "knob_adapt")))
    (eng, res, hist, events), (eng2, res2, hist2, events2) = runs
    # the backlog moved a knob, on the reference's trajectory
    assert any(h != hist[0] for h in hist), hist
    assert hist == r_hist and events == r_events and events
    assert eng._adapt.state() == r_eng._adapt.state()
    assert eng._identity() == r_eng._identity()
    assert eng._identity()["adapt"] is True
    assert np.array_equal(res.phase_stats, r_res.phase_stats)
    assert np.max(np.abs(res.areas - r_res.areas)) < AREA_TOL
    # a rerun repeats it exactly
    assert hist2 == hist and events2 == events
    assert np.array_equal(res2.areas, res.areas)
    for k in ("admit_budget", "spillover_limit"):
        assert eng.telemetry.registry.value(f"ppls_stream_adapt_{k}") \
            == eng._adapt.values[k]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stream_adapt_kill_and_resume_bit_identity(tmp_path, writer):
    base_eng = _port_eng("sin_recip_scaled", ADAPT_EPS, **ADAPT_KW)
    base = _drive(base_eng, ADAPT_REQS, ADAPT_ARR)
    path = str(tmp_path / "adapt.ckpt")
    cls, extra = ((StreamEngine, {"device": "cpu"}) if writer == "port"
                  else (RefStream, {}))
    eng = cls("sin_recip_scaled", ADAPT_EPS, checkpoint_path=path,
              checkpoint_every=1, **ADAPT_KW, **extra)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run(ADAPT_REQS, arrival_phase=ADAPT_ARR, _crash_after_phases=3)
    eng2 = StreamEngine.resume(path, "sin_recip_scaled", ADAPT_EPS,
                               checkpoint_every=1, device="cpu", **ADAPT_KW)
    assert eng2.phase == 3
    # the kill landed mid-adaptation: the snapshot carried live state
    assert eng2._adapt.state() == eng._adapt.state()
    res = _drive(eng2, ADAPT_REQS, ADAPT_ARR, k=eng2.next_rid)
    assert res.phases == base.phases
    assert eng2._adapt.state() == base_eng._adapt.state()
    if writer == "port":
        assert np.array_equal(res.areas, base.areas)       # bit for bit
        assert np.array_equal(res.phase_stats, base.phase_stats)
    else:
        assert np.max(np.abs(res.areas - base.areas)) < AREA_TOL


def test_stream_adapt_resume_requires_armed_adapter(tmp_path):
    path = str(tmp_path / "adapt2.ckpt")
    eng = _port_eng("sin_recip_scaled", ADAPT_EPS, checkpoint_path=path,
                    checkpoint_every=1, **ADAPT_KW)
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run(ADAPT_REQS, _crash_after_phases=2)
    kw = dict(ADAPT_KW, adapt=False)
    with pytest.raises(ValueError):
        StreamEngine.resume(path, "sin_recip_scaled", ADAPT_EPS,
                            checkpoint_every=1, device="cpu", **kw)
    with pytest.raises(ValueError):
        RefStream.resume(path, "sin_recip_scaled", ADAPT_EPS,
                         checkpoint_every=1, **kw)


def test_spillover_limit_adapts_as_the_reference():
    """A spill backlog longer than the limit: the spillover knob grows
    on the reference's trajectory, records equal."""
    kw = dict(KW, f64_rounds=0, slots=2, queue_limit=1, spillover=True,
              spillover_limit=1, adapt=True)
    reqs = [(1.0 + i / 8, (0.0, 1.0)) for i in range(10)]
    arr = [0] * 10
    eng = _port_eng("quad_scaled", 1e-9, **kw)
    ref = RefStream("quad_scaled", 1e-9, **kw)
    h, rh = [], []
    got = _drive(eng, reqs, arr, hist=h)
    want = _drive(ref, reqs, arr, hist=rh)
    assert h == rh
    assert max(x["spillover_limit"] for x in h) > 1
    assert [(c.rid, c.spillover, c.retire_phase) for c in got.completed] \
        == [(c.rid, c.spillover, c.retire_phase) for c in want.completed]
    assert np.array_equal(got.areas, want.areas)


# ---------------------------------------------------------------------------
# serve --adapt --slo-config
# ---------------------------------------------------------------------------

SERVE = ["--slots", "2", "--chunk", "1024", "--capacity", "65536",
         "--lanes", "256", "--refill-slots", "2", "--eps", "1e-7",
         "-a", "1e-2", "-b", "1.0", "--synthetic", "8",
         "--arrival-rate", "4", "--seed", "5", "--adapt",
         "--slo-config", json.dumps(SLO_TIGHT)]


def _cli(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]


def test_serve_adapt_slo_equals_the_engine_and_the_reference(tmp_path):
    ev = [str(tmp_path / f"{k}.jsonl") for k in ("cli", "eng", "ref")]
    rc, recs = _cli(CLI, ["serve"] + SERVE + ["--device", "cpu",
                                              "--events", ev[0]])
    rrc, rrecs = _cli(RCLI, ["serve"] + SERVE + ["--events", ev[2]])
    assert rc == rrc == 0
    # the same configuration through the engine in this process
    rng = np.random.default_rng(5)
    gaps = rng.exponential(1.0 / 4, 8)
    arr = [int(p) for p in np.floor(np.cumsum(gaps) - gaps[0]).astype(int)]
    thetas = np.linspace(1.0, 2.0, 8, endpoint=False)
    reqs = [(float(t), (1e-2, 1.0), {"tenant": "default", "priority": 1})
            for t in thetas]
    tel = Telemetry(events_path=ev[1])
    eng = _port_eng("sin_recip_scaled", 1e-7, tel, slots=2, chunk=1024,
                    capacity=65536, lanes=256, refill_slots=2,
                    adapt=True, slo_config=SLO_TIGHT)
    res = eng.run(reqs, arrival_phase=arr)
    tel.close()
    retires = {r["rid"]: r for r in recs if "rid" in r and "area" in r}
    assert sorted(retires) == list(range(8))
    for c in res.completed:
        r = retires[c.rid]
        assert (r["area"], r["admit_phase"], r["retire_phase"]) \
            == (c.area, c.admit_phase, c.retire_phase)
    names = ("knob_adapt", "slo_burn")
    got_ev = _events(ev[0], *names)
    assert got_ev == _events(ev[1], *names)
    assert {n for n, _ in got_ev} == set(names)
    assert recs[-1]["phases"] == res.phases
    assert recs[-1]["totals"] == res.totals
    # and the reference CLI's ledger and adaptation; its slo_burn events
    # are missing (test_parse_slo_config_is_idempotent)
    r_ret = {r["rid"]: r for r in rrecs if "rid" in r and "area" in r}
    assert sorted(r_ret) == sorted(retires)
    for rid, r in r_ret.items():
        g = retires[rid]
        assert (g["admit_phase"], g["retire_phase"]) \
            == (r["admit_phase"], r["retire_phase"])
        assert abs(g["area"] - r["area"]) < AREA_TOL
    assert _events(ev[0], "knob_adapt") == _events(ev[2], "knob_adapt")
    assert _events(ev[2], "slo_burn") == []


def test_serve_bad_slo_config_exits_as_the_reference(capsys):
    argv = ["serve", "--slo-config", '{"slos": []}']
    codes = []
    for cli, extra in ((CLI, ["--device", "cpu"]), (RCLI, [])):
        with pytest.raises(SystemExit) as ei:
            cli.main(argv + extra)
        codes.append(ei.value.code)
        err = capsys.readouterr().err
        assert "bad SLO config" in err and "non-empty" in err
    assert codes[0] == codes[1] == 2
