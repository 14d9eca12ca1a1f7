"""``python -m ppls_tpu_torch serve`` against ``python -m ppls_tpu serve``,
on the CPU (``--device cpu``).

At the reference tests' sizes (tests/test_multitenant.py's
``SERVE_ARGS``: 4 slots, 256 lanes, R = 2, eps 1e-6 on [1e-2, 1]):

* the same argv through both CLIs in-process: per rid the same admit,
  retire and phase fields, areas within 3e-9 (the walker contract, see
  tests/test_torch_stream.py), the same shed and rejection records, and
  the same summary apart from walls and rates; with the plain synthetic
  load, the overload policy (queue limit, tenants) and a fault plan
  (a NaN-poisoned request and a crash, recovered by the supervisor from
  the snapshot: tests/test_faults.py:659);
* malformed JSONL lines rejected one by one (tests/test_multitenant.py:
  409); the events timeline and the metrics endpoint (tests/
  test_stream.py:338, :444); a hang under ``--watchdog`` resumed from
  the snapshot (the serve form of tests/test_guard.py:159);
* the real entry point in two subprocesses: a run ended by a fault-plan
  SIGTERM (balanced events, ``/metrics`` and ``/health`` scraped while
  it is live, its snapshot kept) and its restart, whose ledgers together
  equal the undisturbed run's, every acknowledged rid once
  (tests/test_multitenant.py:487, :506); requests posted to
  ``--ingest-port`` acknowledged and retired across a SIGTERM restart;
* every option not ported exits non-zero naming its ROADMAP.md item;
  ``serve --dispatch [--lease]`` runs (the reference CLI's ledger;
  tests/test_torch_dispatch.py holds the pool itself);
  ``serve --engine walker-dd`` runs (one rank, the reference CLI's
  ledger at ``--n-devices 1``; and ``--n-devices 2``, two gloo ranks),
  and ``2d`` and ``qmc`` with ``--n-devices 2`` run on 2 gloo ranks;
  without ``--device cpu`` and without a card, ``serve`` exits non-zero
  before it runs.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from ppls_tpu import __main__ as RCLI
from ppls_tpu.utils import artifact_schema as RA
from ppls_tpu_torch import __main__ as CLI
from ppls_tpu_torch.runtime import ingest as TIn
from ppls_tpu_torch.utils import artifact_schema as TA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_multitenant.py:449-452
SERVE_ARGS = ["--slots", "4", "--chunk", "512", "--capacity", "65536",
              "--lanes", "256", "--refill-slots", "2",
              "--eps", "1e-6", "-a", "1e-2", "-b", "1.0",
              "--arrival-rate", "2", "--seed", "5"]
OVERLOAD = ["--synthetic", "8", "--queue-limit", "3",
            "--tenants", "free:1:0,pro:1:2"]
# tests/test_faults.py:659-670
FAULT_ARGS = ["--synthetic", "6", "--arrival-rate", "2", "--seed", "0",
              "--eps", "1e-6", "-a", "1e-2", "-b", "1.0", "--slots", "8",
              "--chunk", "512", "--capacity", "65536", "--lanes", "256",
              "--refill-slots", "2", "--checkpoint-every", "1",
              "--watchdog", "60", "--fault-plan",
              '[{"kind": "nan_poison", "at": 1}, {"kind": "crash", "at": 3}]']
AREA_TOL = 3e-9
# summary values that are walls or rates
_UNTIMED = ("wall_s", "requests_per_sec")


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


def _main(cli, argv):
    """``cli.main(argv)`` with stdout captured: (rc, JSON records)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, _records(buf.getvalue())


def _records(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def _port(argv):
    return _main(CLI, ["serve"] + argv + ["--device", "cpu"])


def _ref(argv):
    return _main(RCLI, ["serve"] + argv)


def _split(recs):
    """(retires by rid, last write wins; sheds by rid; rejections;
    summary) of one ledger."""
    retires, sheds, rejects, summary = {}, {}, [], None
    for r in recs:
        if r.get("summary"):
            summary = r
        elif r.get("rejected"):
            rejects.append(r)
        elif r.get("shed"):
            sheds[r["rid"]] = r
        else:
            retires[r["rid"]] = r
    return retires, sheds, rejects, summary


def _untimed(rec):
    return {k: v for k, v in rec.items() if k not in ("area", "areas",
                                                      "latency_s")}


def _summary_untimed(s):
    out = {k: v for k, v in s.items() if k not in _UNTIMED}
    out["latency"] = {k: v for k, v in s["latency"].items()
                      if k.endswith("_phases")}
    return out


def _assert_same_ledger(got, ref):
    g_ret, g_shed, g_rej, g_sum = _split(got)
    r_ret, r_shed, r_rej, r_sum = _split(ref)
    assert sorted(g_ret) == sorted(r_ret)
    for rid, r in r_ret.items():
        g = g_ret[rid]
        assert _untimed(g) == _untimed(r), rid
        if r["area"] is None:
            assert g["area"] is None
        else:
            assert abs(g["area"] - r["area"]) < AREA_TOL, rid
    assert g_shed == r_shed and g_rej == r_rej
    assert set(g_sum) == set(r_sum)
    assert _summary_untimed(g_sum) == _summary_untimed(r_sum)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each configuration once through each CLI."""
    tmp = tmp_path_factory.mktemp("serve")
    out = {}
    for name, argv in (("plain", SERVE_ARGS + ["--synthetic", "8"]),
                       ("overload", SERVE_ARGS + OVERLOAD)):
        out[name] = (_port(argv), _ref(argv))
    out["faults"] = (
        _port(FAULT_ARGS + ["--checkpoint", str(tmp / "p.ckpt")]),
        _ref(FAULT_ARGS + ["--checkpoint", str(tmp / "r.ckpt")]))
    return out


@pytest.mark.parametrize("name", ["plain", "overload", "faults"])
def test_serve_matches_reference_cli(runs, name):
    (rc, got), (rrc, ref) = runs[name]
    assert rc == rrc == 0
    _assert_same_ledger(got, ref)
    assert TA.validate_serve_output_text(
        "\n".join(json.dumps(r) for r in got)) == []


def test_serve_cli_fault_plan_drains_green(runs):
    """The auto-armed supervisor recovers the crash from the snapshot,
    the poison retires as a failed record, and the summary tells the
    recovery story."""
    (rc, lines), _ = runs["faults"]
    summary = lines[-1]
    assert summary["summary"] and summary["supervised"]
    assert summary["completed"] == 6 and summary["failed"] == 1
    assert {r["action"] for r in summary["recoveries"]} \
        == {"backoff_resume"}
    assert {e["kind"] for e in summary["faults_injected"]} \
        == {"nan_poison", "crash"}
    by_rid = {d["rid"]: d for d in lines[:-1]}
    assert by_rid[1]["failed"] and by_rid[1]["area"] is None
    assert by_rid[1]["failure"] == "nan"
    assert all(isinstance(by_rid[r]["area"], float)
               for r in by_rid if r != 1)


# chip_smoke.py phase 14c's two plans, at the CPU tests' size
CHAOS_ARGS = ["--family", "sin_recip_scaled", "--eps", "1e-6", "-a", "1e-2",
              "-b", "1.0", "--synthetic", "8", "--slots", "4", "--chunk",
              "512", "--capacity", "65536", "--lanes", "256",
              "--refill-slots", "2", "--arrival-rate", "2", "--seed", "17",
              "--checkpoint-every", "1", "--supervise", "--watchdog", "300"]
CHAOS_PLANS = {
    "corrupt": "@" + os.path.join(REPO, "tools", "chaos_plan_ckpt.json"),
    "poison": '[{"kind": "nan_poison", "at": 2}, {"kind": "crash", "at": 4}]'}


@pytest.mark.parametrize("plan", list(CHAOS_PLANS))
def test_serve_chaos_plans_match_reference(plan, tmp_path):
    """A corrupt snapshot then a crash (the resume starts fresh), and a
    NaN-poisoned rid then a crash, under --supervise --watchdog: the
    reference's ledger, recoveries and fired faults."""
    argv = CHAOS_ARGS + ["--fault-plan", CHAOS_PLANS[plan]]
    rc, got = _port(argv + ["--checkpoint", str(tmp_path / "p.ckpt")])
    rrc, ref = _ref(argv + ["--checkpoint", str(tmp_path / "r.ckpt")])
    assert rc == rrc == 0
    _assert_same_ledger(got, ref)
    summary = got[-1]
    assert summary["recoveries"] == [{"kind": "transient",
                                      "action": "backoff_resume"}]
    assert len(summary["faults_injected"]) == 2
    retires = _split(got)[0]
    assert [r for r, x in retires.items() if x.get("failed")] == (
        [2] if plan == "poison" else [])
    assert not os.path.exists(tmp_path / "p.ckpt")


def test_serve_cli_synthetic(runs):
    (rc, recs), _ = runs["plain"]
    retires, _, _, summary = _split(recs)
    assert len(retires) == 8 and summary["completed"] == 8
    assert summary["requests_per_sec"] > 0
    assert {"p50_phases", "p99_phases"} <= set(summary["latency"])
    assert summary["spillover"] == {"spillover_completed": 0,
                                    "spillover_fraction": 0.0,
                                    "spillover_tasks": 0}
    for r in retires.values():
        assert np.isfinite(r["area"]) and r["phases_in_flight"] >= 1


def test_serve_cli_malformed_jsonl_lines_continue(tmp_path):
    req_file = tmp_path / "reqs.jsonl"
    req_file.write_text(
        '{"theta": 1.0, "bounds": [0.01, 1.0]}\n'
        'this is not json\n'
        '{"theta": "NaN-ish", "bounds": [0.01, 1.0]}\n'
        '{"theta": 1.5, "bounds": [0.01, 1.0], "tenant": "t2", '
        '"priority": 2}\n'
        '{"bounds": [0.01, 1.0]}\n'
        '{"theta": 1.25, "bounds": [0.01, 1.0], "arrival_phase": 1}\n')
    argv = ["--slots", "4", "--chunk", "512", "--capacity", "65536",
            "--lanes", "256", "--refill-slots", "2", "--eps", "1e-6",
            "--requests", str(req_file)]
    rc, got = _port(argv)
    rrc, ref = _ref(argv)
    assert rc == rrc == 0
    _assert_same_ledger(got, ref)
    retires, _, rejects, summary = _split(got)
    assert [r["line"] for r in rejects] == [2, 3, 5]
    assert len(retires) == 3 and summary["completed"] == 3
    assert {r["tenant"] for r in retires.values()} == {"default", "t2"}
    assert TA.validate_serve_output_text(
        "\n".join(json.dumps(r) for r in got)) == []


def _events_surface(path):
    retires, deltas = [], []
    for ln in open(path):
        r = json.loads(ln)
        if r["ev"] == "event" and r.get("name") == "retire":
            a = dict(r["attrs"])
            a.pop("latency_s", None)
            retires.append(a)
        elif r["ev"] == "span_close" \
                and r.get("attrs", {}).get("tasks") is not None:
            deltas.append(r["attrs"])
    return sorted(retires, key=lambda a: a["rid"]), deltas


def test_serve_cli_events_and_metrics_port(tmp_path):
    """A seeded run with --events leaves a schema-valid timeline whose
    retire records and per-phase counter deltas repeat exactly on a
    rerun, hold the reference's phases and counters, and match the
    stdout ledger; --metrics-port 0 binds an ephemeral endpoint."""
    argv = ["--slots", "8", "--chunk", "512", "--capacity", "65536",
            "--lanes", "256", "--refill-slots", "2", "--synthetic", "4",
            "--arrival-rate", "2", "--seed", "7", "--eps", "1e-6",
            "-a", "1e-2", "-b", "1.0", "--metrics-port", "0"]
    paths = [str(tmp_path / f"{k}.jsonl") for k in ("a", "b", "ref")]
    recs = [_port(argv + ["--events", p])[1] for p in paths[:2]]
    _ref(argv + ["--events", paths[2]])
    for p in paths:
        text = open(p).read()
        assert TA.validate_events_text(text) == []
        assert TA.validate_events_text(text, check_rid_linkage=True) \
            == RA.validate_events_text(text, check_rid_linkage=True) == []
    s_a, s_b, s_ref = (_events_surface(p) for p in paths)
    assert s_a == s_b and len(s_a[0]) == 4
    strip = ("area",)
    assert [{k: v for k, v in a.items() if k not in strip}
            for a in s_a[0]] == [{k: v for k, v in a.items()
                                  if k not in strip} for a in s_ref[0]]
    assert s_a[1] == s_ref[1]                 # the per-phase deltas
    summaries = [r[-1] for r in recs]
    assert summaries[0]["totals"] == summaries[1]["totals"]
    assert summaries[0]["metrics_port"] > 0
    assert summaries[0]["metrics_url"].endswith("/metrics")
    assert {r["rid"]: r["area"] for r in recs[0][:-1]} == {
        a["rid"]: a["area"] for a in s_a[0]}


def test_serve_cli_watchdog_hang_resumes_from_checkpoint(runs, tmp_path):
    """A hang at phase 2 (a wedged device) under --watchdog: the
    deadline expires, the supervisor resumes from the last snapshot,
    and the deduplicated ledger equals the uninterrupted run's bit for
    bit (the hung attempt's thread stays parked)."""
    ck = str(tmp_path / "h.ckpt")
    argv = SERVE_ARGS + ["--synthetic", "8", "--checkpoint", ck,
                         "--checkpoint-every", "1", "--watchdog", "5",
                         "--fault-plan", '[{"kind": "hang", "at": 2}]']
    rc, got = _port(argv)
    assert rc == 0
    retires, _, _, summary = _split(got)
    base, _, _, base_sum = _split(runs["plain"][0][1])
    assert {r: _untimed(x) for r, x in retires.items()} == {
        r: _untimed(x) for r, x in base.items()}
    assert {r: x["area"] for r, x in retires.items()} == {
        r: x["area"] for r, x in base.items()}
    assert summary["recoveries"] == [{"kind": "transient",
                                      "action": "backoff_resume"}]
    assert summary["totals"] == base_sum["totals"]
    assert not os.path.exists(ck)


# ---------------------------------------------------------------------------
# the real entry point
# ---------------------------------------------------------------------------


def _run_serve(argv, on_stderr_line=None, timeout=300):
    """A ``python -m ppls_tpu_torch serve --device cpu`` subprocess;
    stdout read line by line to EOF, stderr on a thread that hands each
    line to ``on_stderr_line``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ppls_tpu_torch", "serve", "--device",
         "cpu"] + SERVE_ARGS + argv, cwd=REPO,
        env=dict(os.environ, PPLS_TUNING_TABLE="off"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    err = []

    def drain():
        for ln in proc.stderr:
            err.append(ln)
            if on_stderr_line is not None:
                on_stderr_line(ln)

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    try:
        out = list(proc.stdout)
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t.join(timeout=10)
    return rc, "".join(out), "".join(err)


def test_serve_sigterm_restart_zero_lost_acks(runs, tmp_path):
    """A fault-plan SIGTERM at the close of phase 2 (a straggler keeps
    the first process alive while ``/metrics`` and ``/health`` are
    scraped): exit 0, balanced events, the snapshot kept; the same
    command restarted drains the rest, and the union of the two ledgers
    equals the undisturbed run's, every rid once, areas bit-equal."""
    ck = str(tmp_path / "zd.ckpt")
    ev = str(tmp_path / "zd.jsonl")
    argv = OVERLOAD + ["--checkpoint", ck, "--checkpoint-every", "1",
                       "--events", ev, "--metrics-port", "0",
                       "--fault-plan",
                       '[{"kind": "straggler", "at": 1, "seconds": 2.0}, '
                       '{"kind": "sigterm", "at": 2, "edge": "close"}]']
    scraped = {}

    def scrape(line):
        m = re.search(r"metrics on (http://127\.0\.0\.1:(\d+)/metrics)",
                      line)
        if m:
            scraped["metrics"] = urllib.request.urlopen(
                m.group(1), timeout=10).read().decode()
            health = f"http://127.0.0.1:{m.group(2)}/health"
            try:
                scraped["health"] = json.loads(urllib.request.urlopen(
                    health, timeout=10).read())
            except urllib.error.HTTPError as e:     # no engine yet: 503
                scraped["health"] = json.loads(e.read())

    rc1, out1, err1 = _run_serve(argv, on_stderr_line=scrape)
    assert rc1 == 0, err1
    s1 = _records(out1)[-1]
    assert s1["terminated"] == "SIGTERM"
    assert os.path.exists(ck)
    assert TA.validate_events_text(open(ev).read()) == []
    assert scraped["metrics"].endswith("\n")
    assert "burning" in scraped["health"]

    rc2, out2, err2 = _run_serve(argv)
    assert rc2 == 0, err2
    assert not os.path.exists(ck)
    events = open(ev).read()
    assert TA.validate_events_text(events) == \
        RA.validate_events_text(events) == []
    assert events.count('"ev": "meta"') == 2

    base_r, base_s, _, _ = _split(runs["overload"][0][1])
    r1, s1_, _, _ = _split(_records(out1))
    r2, s2_, _, s2sum = _split(_records(out2))
    union_r = {**r1, **r2}
    union_s = {**s1_, **s2_}
    assert {k: (v["area"], _untimed(v)) for k, v in union_r.items()} == {
        k: (v["area"], _untimed(v)) for k, v in base_r.items()}
    assert union_s == base_s
    assert set(union_r) | set(union_s) == set(range(8))
    assert s2sum["completed"] == len(union_r)
    assert s2sum["shed"] == len(union_s)
    ledger = "\n".join(ln for ln in (out1 + out2).splitlines()
                       if '"summary": true' not in ln) + "\n" \
        + json.dumps(s2sum)
    assert TA.validate_serve_output_text(ledger) == \
        RA.validate_serve_output_text(ledger) == []


def test_serve_ingest_acks_survive_a_sigterm_restart(runs, tmp_path,
                                                     monkeypatch):
    """Two requests posted to --ingest-port while the batch load runs
    are acknowledged with rids; a SIGTERM right after the acks keeps them
    in the final snapshot, and the restarted service (same command)
    retires them: every acknowledged rid retires across the two runs."""
    assert threading.current_thread() is threading.main_thread()
    servers = []
    real = TIn.IngestServer

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(TIn, "IngestServer", Recording)
    ck = str(tmp_path / "in.ckpt")
    argv = SERVE_ARGS + ["--synthetic", "8", "--checkpoint", ck,
                         "--checkpoint-every", "1", "--ingest-port", "0"]
    body = (b'{"theta": 1.3, "bounds": [0.01, 1.0], "tenant": "live"}\n'
            b'{"theta": 1.7, "bounds": [0.01, 1.0], "tenant": "live"}\n')
    acks = []

    def stats(srv):
        return json.loads(urllib.request.urlopen(
            f"http://{srv.host}:{srv.port}/", timeout=10).read())

    def client(first_run):
        deadline = time.monotonic() + 120
        while len(servers) < (1 if first_run else 2):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        srv = servers[-1]
        if first_run:
            while not acks:
                resp = urllib.request.urlopen(urllib.request.Request(
                    srv.url, data=body, method="POST"), timeout=10)
                recs = [json.loads(ln) for ln in
                        resp.read().decode().splitlines()]
                if all(r.get("accepted") for r in recs):
                    acks.extend(recs)
                else:                        # not published yet: retry
                    time.sleep(0.01)
        else:
            while stats(srv).get("completed") != 10:
                assert time.monotonic() < deadline
                time.sleep(0.02)
        os.kill(os.getpid(), signal.SIGTERM)

    outs = []
    for first_run in (True, False):
        t = threading.Thread(target=client, args=(first_run,),
                             daemon=True)
        t.start()
        outs.append(_port(argv))
        t.join(timeout=60)
        assert not t.is_alive()
    (rc1, recs1), (rc2, recs2) = outs
    assert rc1 == rc2 == 0
    assert recs1[-1]["terminated"] == recs2[-1]["terminated"] == "SIGTERM"
    assert recs1[-1]["ingest_port"] > 0
    acked = {a["rid"] for a in acks}
    assert len(acked) == 2 and all(a["accepted"] for a in acks)
    r1, _, _, _ = _split(recs1)
    r2, _, _, s2 = _split(recs2)
    union = {**r1, **r2}
    assert set(union) == set(range(10)) and acked <= set(union)
    assert {union[r]["tenant"] for r in acked} == {"live"}
    assert s2["completed"] == 10
    base, _, _, _ = _split(runs["plain"][0][1])
    # the batch load's areas do not depend on when the live requests came
    assert all(np.isfinite(union[r]["area"]) for r in union)
    assert set(base) <= set(union)


# ---------------------------------------------------------------------------
# refusals and the device
# ---------------------------------------------------------------------------

REFUSED = {
    # once refused with item 9: the multi-process cluster runs (None)
    "processes": (["serve", "--processes", "2"], None),
    "processes_zero": (["serve", "--processes", "0"], "must be >= 1"),
    # once refused with item 9: the pool dispatcher runs (None)
    "dispatch": (["serve", "--dispatch"], None),
    "lease": (["serve", "--dispatch", "--lease"], None),
    "lease_alone": (["serve", "--lease"], "require --dispatch"),
    "overlap": (["serve", "--overlap-boundaries"], "require --dispatch"),
    # once refused with item 7: the walker-dd stream runs (None)
    "walker_dd": (["serve", "--engine", "walker-dd"], None),
    "n_devices": (["serve", "--engine", "walker-dd", "--n-devices", "2"],
                  None),
}


def _walker_dd_serve_runs(argv, capsys):
    """The walker-dd ``serve``: on one rank (``--n-devices`` unset on the
    CPU) the reference CLI's ledger at ``--n-devices 1``; on two ranks
    every request retires within the walker contract of the one-rank
    ledger and the summary names the world. ``--n-devices 2`` on the
    walker engine still exits non-zero."""
    load = SERVE_ARGS + ["--synthetic", "4"]
    rc, got = _port(argv[1:] + load)
    assert rc == 0
    g_ret, _s, _r, g_sum = _split(got)
    if "--n-devices" not in argv:
        rrc, ref = _ref(argv[1:] + load + ["--n-devices", "1"])
        assert rrc == 0
        g_sum.pop("mesh")
        _assert_same_ledger([*g_ret.values(), g_sum], ref)
        return
    assert g_sum["completed"] == 4 and g_sum["mesh"]["world"] == 2
    rc1, one = _port(["--engine", "walker-dd"] + load)
    o_ret = _split(one)[0]
    assert sorted(g_ret) == sorted(o_ret) == [0, 1, 2, 3]
    for rid, r in o_ret.items():
        assert abs(g_ret[rid]["area"] - r["area"]) < AREA_TOL
    with pytest.raises(SystemExit) as ei:
        CLI.main(["serve", "--n-devices", "2", "--device", "cpu"] + load)
    assert "--engine walker-dd" in str(ei.value.code)
    capsys.readouterr()


def _dispatch_serve_runs(argv, capsys):
    """``serve --dispatch [--lease]`` on the synthetic load: the
    reference CLI's ledger (areas within 3e-9), and the pool's summary
    blocks apart from their walls."""
    load = SERVE_ARGS + ["--synthetic", "6", "--max-engines", "2"]
    rc, got = _port(argv[1:] + load)
    rrc, ref = _ref(argv[1:] + load)
    assert rc == rrc == 0
    g_sum, r_sum = got[-1], ref[-1]
    assert g_sum["dispatch"] is True and g_sum["recompiles"] == 0
    assert g_sum["completed"] == 6
    assert g_sum["leases"]["enabled"] == ("--lease" in argv)
    walls = ("boundary_wall_s", "overlap_wall_s", "overlap_wall_frac")
    for s in (g_sum, r_sum):
        s["leases"] = {k: v for k, v in s["leases"].items()
                       if k not in walls}
    _assert_same_ledger(got, ref)
    capsys.readouterr()


def _processes_serve_runs(argv, capsys):
    """``serve --processes 2`` on the synthetic load: two worker
    processes on the CPU; every request retires within the walker
    contract of the reference CLI's single-engine ledger, and the
    summary names the manifest and each worker's launches."""
    load = SERVE_ARGS + ["--synthetic", "4"]
    rc, got = _port(argv[1:] + load)
    rrc, ref = _ref(load)
    assert rc == rrc == 0
    g_ret, g_shed, _r, g_sum = _split(got)
    r_ret = _split(ref)[0]
    assert not g_shed and sorted(g_ret) == sorted(r_ret) == [0, 1, 2, 3]
    for rid, r in r_ret.items():
        assert abs(g_ret[rid]["area"] - r["area"]) < AREA_TOL, rid
    assert g_sum["completed"] == 4 and g_sum["processes"] == 2
    assert g_sum["manifest"] == {"processes": 2, "devices": [1, 1]}
    assert sorted(g_sum["launches"]) == ["0", "1"]
    capsys.readouterr()


@pytest.mark.parametrize("name", list(REFUSED))
def test_unported_options_and_modes_exit_nonzero(name, capsys):
    argv, what = REFUSED[name]
    if what is None and "--processes" in argv:
        _processes_serve_runs(argv, capsys)
        return
    if what is None and "--dispatch" in argv:
        _dispatch_serve_runs(argv, capsys)
        return
    if what is None:
        _walker_dd_serve_runs(argv, capsys)
        return
    with pytest.raises(SystemExit) as ei:
        CLI.main(argv + (["--device", "cpu"] if argv[:1] == ["serve"]
                         else []))
    assert ei.value.code not in (0, None)
    assert what in str(ei.value.code)
    if "item" in what:
        assert "ROADMAP.md Queue 1" in str(ei.value.code)
    assert capsys.readouterr().out == ""


ACROSS = {"2d": ["2d", "--n-devices", "2", "--json"],
          "qmc": ["qmc", "--n-devices", "2", "--json", "--n", "65536",
                  "--genz", "gaussian"]}


@pytest.fixture(scope="module")
def across():
    """``2d`` and ``qmc`` with ``--n-devices 2`` in one spawned world of 2
    gloo ranks."""
    import torch_mesh_jobs as J

    from ppls_tpu_torch.parallel.mesh import launch, run_calls
    calls = [(J.cli_output, (argv + ["--device", "cpu"],), {})
             for argv in ACROSS.values()]
    return dict(zip(ACROSS, launch(run_calls, 2, "cpu", (calls,),
                                   timeout=600)))


@pytest.mark.parametrize("name", sorted(ACROSS))
def test_modes_across_devices_run(name, across):
    rc, out = across[name]
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    if name == "2d":
        assert rec["tasks"] == 213 and rec["max_depth"] == 6
    else:
        assert np.isfinite(rec["families"]["gaussian"]["value"])


def test_serve_without_a_card_exits_before_running(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["serve"] + SERVE_ARGS + ["--synthetic", "2"]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit) as ei:
            CLI.main(argv + extra)
        assert "CUDA is not available" in str(ei.value.code)
        assert "device='cpu'" in str(ei.value.code)
    assert capsys.readouterr().out == ""
    # the root parser's --device reaches serve's engines
    rc, recs = _main(CLI, ["--device", "cpu"] + argv)
    assert rc == 0 and recs[-1]["completed"] == 2


def test_parser_matches_reference_flag_for_flag():
    """Every flag of the reference's root parser and serve subparser
    exists in the port's with the same default; the port adds only
    --device."""
    def flags(parser):
        out = {}
        for a in parser._actions:
            if a.option_strings:
                out[a.option_strings[-1]] = a.default
        return out

    def modes(parser):
        return next(a for a in parser._actions if a.dest == "mode").choices

    rp, tp = RCLI.build_parser(), CLI.build_parser()
    r_root, t_root = flags(rp), flags(tp)
    assert t_root.pop("--device") == "cuda"
    assert t_root == r_root
    r_srv, t_srv = flags(modes(rp)["serve"]), flags(modes(tp)["serve"])
    t_srv.pop("--device")
    assert t_srv == r_srv
    assert set(modes(tp)) == set(modes(rp))
