"""``python -m ppls_tpu_torch serve --processes N`` (the multi-process
cluster behind the serve CLI) against the reference CLI, on the CPU
(``--device cpu``; the workers inherit it).

tools/ci.sh leg 5d's flags (six dyadic ``quad_scaled`` thetas, arrival
rate 2, seed 0, eps 1e-9, slots 4, 256 lanes, R = 2, ``--f64-rounds 2``):

* the port's ``--processes 2`` ledger equals the reference CLI's
  ``serve --processes 2`` ledger record for record (areas bit-equal),
  apart from walls, rates, the port's ``launches`` block and the
  manifest's per-process device counts (the reference's workers report
  their JAX devices, the port's the ranks their engines drive: 1);
* the sweep ``--processes 1, 2, 4`` gives bit-identical areas (ci.sh
  :426-441), each run's manifest naming its process count;
* ``--metrics-port 0`` scraped live from a subprocess with
  ``PPLS_SERVE_METRICS_HOLD``: coordinator retired = sum over worker
  processes = summary completed (ci.sh :443-...);
* the reference's refusals in its words: ``--tenant-quotas``,
  ``--ingest-port``, ``--processes 0`` / ``-1``, ``--dispatch``;
* without a card (the default device) it exits non-zero before any
  worker starts.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest

from ppls_tpu import __main__ as RCLI
from ppls_tpu_torch import __main__ as CLI
from ppls_tpu_torch.utils.artifact_schema import validate_serve_output_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tools/ci.sh:410-416 (leg 5d)
LEG_5D = ["--f64-rounds", "2", "--family", "quad_scaled",
          "--theta", "1.0,1.25,1.5,2.0,0.75,3.0",
          "--arrival-rate", "2", "--seed", "0", "--eps", "1e-9",
          "-a", "0.0", "-b", "1.0", "--slots", "4",
          "--chunk", "1024", "--capacity", "65536",
          "--lanes", "256", "--refill-slots", "2"]
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
    text = buf.getvalue()
    return rc, text, [json.loads(ln) for ln in text.splitlines()
                      if ln.startswith("{")]


def _port(p, extra=()):
    return _main(CLI, ["serve", "--processes", str(p)] + LEG_5D
                 + list(extra) + ["--device", "cpu"])


@pytest.fixture(scope="module")
def runs():
    """The port's ledger at 1, 2 and 4 processes, and the reference
    CLI's at 2 (the one reference cluster of this file)."""
    out = {p: _port(p) for p in (1, 2, 4)}
    out["ref"] = _main(RCLI, ["serve", "--processes", "2"] + LEG_5D)
    return out


def _untimed(rec):
    rec = dict(rec)
    rec.pop("latency_s", None)
    for k in _UNTIMED + ("launches",):
        rec.pop(k, None)
    if "latency" in rec:
        rec["latency"] = {k: v for k, v in rec["latency"].items()
                          if not k.endswith("_s")}
    if "manifest" in rec:
        # the reference reports its workers' JAX device count, the port
        # the ranks each worker's engine drives
        rec["manifest"] = rec["manifest"]["processes"]
    return rec


def test_ledger_equals_the_reference_cli(runs):
    rc, text, got = runs[2]
    rrc, _rtext, ref = runs["ref"]
    assert rc == rrc == 0
    assert validate_serve_output_text(text) == []
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        assert _untimed(g) == _untimed(r)
        if "area" in r:
            assert g["area"] == r["area"]       # bit-equal (dyadic)
    s = got[-1]
    assert s["manifest"] == {"processes": 2, "devices": [1, 1]}
    assert sorted(s["launches"]) == ["0", "1"]


@pytest.mark.parametrize("p", [1, 2, 4])
def test_process_sweep_areas_bit_identical(runs, p):
    rc, _text, recs = runs[p]
    assert rc == 0
    s = recs[-1]
    assert s["summary"] and s["completed"] == 6
    assert s["processes"] == p and s["manifest"]["processes"] == p
    areas = {r["rid"]: r["area"] for r in recs if "rid" in r}
    ref = {r["rid"]: r["area"] for r in runs["ref"][2] if "rid" in r}
    assert len(areas) == 6 and areas == ref


def test_metrics_port_serves_the_federated_surface(tmp_path):
    """The federated /metrics surface scraped live from a serve process;
    the final sample (inside the PPLS_SERVE_METRICS_HOLD window) holds
    the reconciliation invariant."""
    out_p, err_p = tmp_path / "m.out", tmp_path / "m.err"
    env = dict(os.environ, PPLS_SERVE_METRICS_HOLD="5",
               PPLS_TUNING_TABLE="off",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + ([os.environ["PYTHONPATH"]]
                             if os.environ.get("PYTHONPATH") else [])))
    cmd = [sys.executable, "-m", "ppls_tpu_torch", "serve",
           "--processes", "2"] + LEG_5D + ["--metrics-port", "0",
                                           "--device", "cpu"]
    with open(out_p, "w") as fo, open(err_p, "w") as fe:
        proc = subprocess.Popen(cmd, stdout=fo, stderr=fe, env=env,
                                cwd=str(tmp_path))
        try:
            url, summary, deadline = None, None, time.monotonic() + 120
            while url is None and time.monotonic() < deadline:
                m = re.search(r"metrics on (http://\S+)",
                              err_p.read_text())
                if m:
                    url = m.group(1)
                elif proc.poll() is not None:
                    raise AssertionError(
                        f"serve exited rc={proc.returncode}: "
                        f"{err_p.read_text()}")
                else:
                    time.sleep(0.1)
            samples = 0
            while summary is None and time.monotonic() < deadline:
                with urllib.request.urlopen(url, timeout=10) as r:
                    r.read()
                samples += 1
                for ln in out_p.read_text().splitlines():
                    if ln.startswith("{") and json.loads(ln).get("summary"):
                        summary = json.loads(ln)
                time.sleep(0.1)
            assert summary is not None and samples >= 1
            with urllib.request.urlopen(url, timeout=10) as r:
                expo = r.read().decode()
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    assert summary["metrics_url"] == url
    vals = {}
    for ln in expo.splitlines():
        m = re.match(r'ppls_stream_retired_total\{process="([^"]+)"\}'
                     r' (\S+)', ln)
        if m:
            vals[m.group(1)] = float(m.group(2))
    workers = sum(v for k, v in vals.items() if k != "coordinator")
    assert set(vals) == {"0", "1", "coordinator"}
    assert vals["coordinator"] == summary["completed"] == 6
    assert workers == summary["completed"]


@pytest.mark.parametrize("extra", [
    ["--tenant-quotas", '{"a": {"rate": 1, "burst": 1}}'],
    ["--ingest-port", "0"],
    ["--processes", "0"],
    ["--processes", "-1"],
    ["--dispatch"],
], ids=["tenant_quotas", "ingest_port", "zero", "negative", "dispatch"])
def test_refusals_in_the_reference_words(extra, capsys):
    argv = ["serve", "--processes", "2"] + LEG_5D + extra
    with pytest.raises(SystemExit) as ep:
        CLI.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as er:
        RCLI.main(argv)
    assert str(ep.value.code) == str(er.value.code)
    assert ep.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_without_a_card_exits_before_any_worker(monkeypatch, capsys):
    """``serve --processes`` defaults to the card: without one it exits
    non-zero with ``resolve_device``'s message before a worker starts."""
    import torch

    from ppls_tpu_torch.runtime import cluster as C
    spawned = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(C.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(SystemExit) as ei:
        CLI.main(["serve", "--processes", "2"] + LEG_5D)
    assert "CUDA is not available" in str(ei.value.code)
    assert spawned == [] and capsys.readouterr().out == ""
