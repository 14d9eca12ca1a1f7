"""``serve --processes 2`` restarts and recoveries (the reference's
serve-cluster cases, tests/test_cluster.py:533-720), on the CPU,
against the reference's single stream engine on the same dyadic
requests (bit-equal):

* kill one HOST mid-stream under ``--supervise``: recoveries
  ``[host_loss]``, the survivor's manifest, 0 lost, areas bit-equal; the
  ledger and the events timeline validate, with per-process spans;
* restart through the CLI from an engine-level crash's snapshot;
* a fault-plan SIGTERM: flag at the boundary, snapshot kept, summary
  ``terminated``, exit 0; the same command then completes with 0 lost
  and both timelines keep their rid linkage;
* a corrupt COORDINATOR snapshot starts clean, its per-process
  siblings removed.

The reference's watchdog-hang case (tests/test_cluster.py:680) has no
twin here: its 15 s watchdog expires under a loaded parallel run
(ROADMAP.md, Standing constraints), and a watchdog long enough to be
safe there would hold the file far past its time budget.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from ppls_tpu.runtime.stream import StreamEngine as RefStream
from ppls_tpu_torch import __main__ as CLI
from ppls_tpu_torch.runtime.cluster import ClusterStreamEngine
from ppls_tpu_torch.utils.artifact_schema import (validate_events_text,
                                                  validate_serve_output_text)

# tests/test_cluster.py:46-59
WKW = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
           roots_per_lane=2, refill_slots=2, seg_iters=32,
           min_active_frac=0.05, f64_rounds=2)
THETA6 = [1.0, 1.25, 1.5, 2.0, 0.75, 3.0]
REQS6 = [(t, (0.0, 1.0)) for t in THETA6]
ARR6 = [0, 0, 1, 2, 3, 4]


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


@pytest.fixture(scope="module")
def base6():
    return RefStream("quad_scaled", 1e-9, **WKW).run(
        REQS6, arrival_phase=ARR6)


def _cli_wkw() -> dict:
    """tests/test_cluster.py's ``_cli_wkw``: the worker kwargs the serve
    CLI sends, so an engine-level crash leaves per-worker snapshots the
    CLI's workers resume."""
    kw = dict(WKW, theta_block=1)
    for k in ("roots_per_lane", "seg_iters", "min_active_frac"):
        kw.pop(k, None)
    return kw


def _serve_cluster_args(tmp_path, tag, extra):
    ev = str(tmp_path / f"{tag}.events.jsonl")
    return [
        "serve", "--processes", "2", "--f64-rounds", "2",
        "--family", "quad_scaled",
        "--theta", "1.0,1.25,1.5,2.0,0.75,3.0",
        "--arrival-rate", "2", "--seed", "0", "--eps", "1e-9",
        "-a", "0.0", "-b", "1.0", "--slots", "4",
        "--chunk", "1024", "--capacity", "65536",
        "--lanes", "256", "--refill-slots", "2",
        "--events", ev, "--device", "cpu"] + extra, ev


def _serve(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = CLI.main(argv)
    text = buf.getvalue()
    return rc, text, [json.loads(ln) for ln in text.splitlines()
                      if ln.startswith("{")]


def _areas(lines):
    got = {d["rid"]: d["area"] for d in lines
           if "rid" in d and not d.get("summary")}
    return got, np.array([got[r] for r in sorted(got)])


def _crashed_cluster(ck):
    eng = ClusterStreamEngine("quad_scaled", 1e-9, n_processes=2,
                              worker_kw=_cli_wkw(), checkpoint_path=ck,
                              checkpoint_every=1, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            eng.run(REQS6, arrival_phase=ARR6, _crash_after_phases=3)
    finally:
        eng.close()


def test_serve_kill_one_host_under_supervise(base6, tmp_path):
    argv, ev = _serve_cluster_args(
        tmp_path, "kill",
        ["--supervise", "--fault-plan",
         '[{"kind": "host_loss", "at": 2, "chip": 1}]'])
    rc, text, lines = _serve(argv)
    assert rc == 0
    s = lines[-1]
    assert s["summary"] and s["supervised"]
    assert s["completed"] == 6                      # zero lost acks
    assert s["manifest"]["processes"] == 1          # survivor only
    assert [r["kind"] for r in s["recoveries"]] == ["host_loss"]
    assert s["redeal_walls_s"]
    assert sorted(s["launches"]) == ["0", "1"]
    got, areas = _areas(lines[:-1])
    assert sorted(got) == list(range(6))
    assert np.array_equal(areas, base6.areas)
    assert validate_serve_output_text(text) == []
    ev_text = open(ev).read()
    assert validate_events_text(ev_text) == []
    recs = [json.loads(ln) for ln in ev_text.splitlines() if ln.strip()]
    assert any(d.get("ev") == "span_open" and d.get("name") == "process"
               for d in recs)
    names = {d.get("name") for d in recs if d.get("ev") == "event"}
    assert {"cluster_bootstrap", "host_killed", "host_loss_discovery",
            "cluster_redeal"} <= names


def test_serve_cluster_checkpoint_restart(base6, tmp_path):
    ck = str(tmp_path / "cli.ckpt")
    _crashed_cluster(ck)
    assert os.path.exists(ck)
    argv, _ev = _serve_cluster_args(tmp_path, "restart",
                                    ["--checkpoint", ck])
    rc, _text, lines = _serve(argv)
    assert rc == 0
    assert lines[-1]["summary"] and lines[-1]["completed"] == 6
    got, areas = _areas(lines[:-1])
    assert sorted(got) == list(range(6))
    assert np.array_equal(areas, base6.areas)
    assert not os.path.exists(ck)       # drained runs clean up
    assert not [p for p in os.listdir(tmp_path) if ".ckpt.p" in p]


def test_serve_cluster_sigterm_graceful_restart(base6, tmp_path):
    ck = str(tmp_path / "sig.ckpt")
    argv, ev1 = _serve_cluster_args(
        tmp_path, "sig",
        ["--checkpoint", ck, "--checkpoint-every", "1",
         "--fault-plan",
         '[{"kind": "sigterm", "at": 2, "edge": "close"}]'])
    rc, _text, lines1 = _serve(argv)
    assert rc == 0
    s1 = lines1[-1]
    assert s1["summary"] and s1.get("terminated") == "SIGTERM"
    assert os.path.exists(ck)       # the snapshot IS the restart state
    argv, ev2 = _serve_cluster_args(tmp_path, "sig2",
                                    ["--checkpoint", ck])
    rc, _text, lines2 = _serve(argv)
    assert rc == 0
    assert lines2[-1]["summary"] and lines2[-1]["completed"] == 6
    got, areas = _areas(lines1[:-1] + lines2[:-1])
    assert sorted(got) == list(range(6))
    assert np.array_equal(areas, base6.areas)
    # both lineage segments keep the rid linkage; the union carries the
    # restart trail and one retire per acknowledged rid
    names, retires = set(), {}
    for p in (ev1, ev2):
        assert validate_events_text(open(p).read(),
                                    check_rid_linkage=True) == [], p
        for ln in open(p):
            r = json.loads(ln)
            if r.get("ev") == "event":
                names.add(r["name"])
                if r["name"] == "retire":
                    retires[r["attrs"]["rid"]] = r["attrs"]
    assert {"graceful_shutdown", "cluster_resume"} <= names
    assert sorted(retires) == list(range(6))


def test_serve_cluster_corrupt_coordinator_starts_clean(base6, tmp_path,
                                                         capsys):
    ck = str(tmp_path / "corrupt.ckpt")
    _crashed_cluster(ck)
    assert os.path.exists(ck + ".p0")
    with open(ck, "r+b") as fh:
        fh.truncate(os.path.getsize(ck) // 2)
    argv, _ev = _serve_cluster_args(tmp_path, "fresh",
                                    ["--checkpoint", ck])
    rc, _text, lines = _serve(argv)
    assert rc == 0
    assert "starting fresh" in capsys.readouterr().err
    assert lines[-1]["summary"] and lines[-1]["completed"] == 6
    got, areas = _areas(lines[:-1])
    assert sorted(got) == list(range(6))
    assert np.array_equal(areas, base6.areas)
