"""The port's diagnosis and post-mortem tools (``ppls_tpu_torch/tools/``)
against the JAX package's (``tools/``), on the CPU:

* ``check_artifacts``: the same exit codes and the same printed problems
  as the reference's on a serve ledger and an events timeline written by
  the port's ``serve`` on the CPU (tests/test_torch_serve.py's size),
  the same with one line corrupted, the committed tuning table, graftlint
  ledgers, the repo's bench artifacts (the default scan) and a flag
  without its FILE.
* ``analyze_request``: ``analyze()`` gives equal dicts in both packages
  (imported in-process, as tests/test_request_trace.py does), and
  ``--check``, ``--json`` and the text report the same exit codes and
  output.
* ``analyze_occupancy --from-events``: the port's output text equals the
  reference's, run as a subprocess as tests/test_obs.py runs it (one per
  timeline: a multi-tenant serve with sheds, and a leased dispatch pool
  of two engine keys).
* ``analyze_occupancy --attribution`` with ``--device cpu`` at the
  reference tests' shapes (256 lanes, seg_iters 32, 8 thetas): the
  buckets reconcile in every mode; the two ds modes (refill_slots 0 and
  8) walk the reference walker's tasks, kernel steps and buckets; the
  scouting mode equals the port's own ``integrate_family_walker`` call.
  The tuning table is off on both sides (hand-tier cadence).
* The device tools refuse to run without a card unless ``--device cpu``
  is passed (``resolve_device``'s message, exit 2); the dd mode and
  ``characterize_dd`` run on the CPU at small sizes.
* ``integrate_bag``: the reference problem at %.6f and its task count;
  bit-equal to the reference's on a second configuration; no card and
  no ``device="cpu"`` raises.
* ``korobov_search``: the criterion and the search equal the reference's
  at small lattice sizes.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ppls_tpu_torch import __main__ as CLI
from ppls_tpu_torch.config import OSC_CONFIG, REFERENCE_CONFIG
from ppls_tpu_torch.models.integrands import get_family, get_family_ds
from ppls_tpu_torch.parallel.bag_engine import integrate_bag
from ppls_tpu_torch.parallel.walker import integrate_family_walker
from ppls_tpu_torch.tools import analyze_occupancy as AO
from ppls_tpu_torch.tools import analyze_request as AR
from ppls_tpu_torch.tools import characterize_dd as CD
from ppls_tpu_torch.tools import check_artifacts as CA
from ppls_tpu_torch.tools import korobov_search as KS
from ppls_tpu_torch.tools import profile_bag as PB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import analyze_request as RAR  # noqa: E402
from tools import check_artifacts as RCA  # noqa: E402
from tools import korobov_search as RKS  # noqa: E402

SERVE = ["serve", "--device", "cpu", "--slots", "4", "--chunk", "512",
         "--capacity", "65536", "--lanes", "256", "--refill-slots", "2",
         "--eps", "1e-6", "-a", "1e-2", "-b", "1.0"]
# tests/test_torch_serve.py's overload leg: 8 requests, two tenants,
# a queue limit that sheds
TENANTS = ["--synthetic", "8", "--arrival-rate", "2", "--seed", "5",
           "--queue-limit", "3", "--tenants", "free:1:0,pro:1:2"]
POOL_REQS = [(1.0, 1e-6, 0), (1.25, 1e-7, 0), (1.5, 1e-6, 1),
             (1.75, 1e-7, 1), (1.1, 1e-6, 2), (1.3, 1e-7, 3)]
POOL = ["--dispatch", "--lease", "--overlap-boundaries", "--max-engines",
        "1", "--chunk", "1024"]


def _serve(argv, ledger):
    """The port's ``serve`` in this process; its stdout into ``ledger``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert CLI.main(argv) == 0
    with open(ledger, "w") as fh:
        fh.write(buf.getvalue())


def _corrupt(src, dst, match):
    """``src`` with its first line holding ``match`` cut in half."""
    lines = open(src).read().splitlines()
    i = next(j for j, ln in enumerate(lines) if match in ln)
    lines[i] = lines[i][:len(lines[i]) // 2]
    with open(dst, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return dst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two CPU serve runs with their ledgers and timelines: the tenants'
    overload leg, and a leased dispatch pool over two eps keys; broken
    copies of the first run's ledger and timeline."""
    tmp = tmp_path_factory.mktemp("tools")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        ev, led = str(tmp / "tenants.jsonl"), str(tmp / "tenants_out.jsonl")
        _serve(SERVE + TENANTS + ["--events", ev], led)
        out["tenants"] = (ev, led)
        reqs = tmp / "reqs.jsonl"
        reqs.write_text("".join(json.dumps(
            {"theta": t, "bounds": [0.01, 1.0], "eps": e,
             "arrival_phase": a}) + "\n" for t, e, a in POOL_REQS))
        ev, led = str(tmp / "pool.jsonl"), str(tmp / "pool_out.jsonl")
        _serve(SERVE + POOL + ["--requests", str(reqs), "--events", ev],
               led)
        out["pool"] = (ev, led)
    ev, led = out["tenants"]
    out["bad_ledger"] = _corrupt(led, str(tmp / "bad_out.jsonl"),
                                 '"rid"')
    out["bad_events"] = _corrupt(ev, str(tmp / "bad_events.jsonl"),
                                 '"retire"')
    lint = {"schema": "graftlint-v1", "target": "ppls_tpu", "deep": False,
            "violations": [], "stale": [],
            "counts": {"total": 0, "new": 0, "grandfathered": 0,
                       "stale": 0}, "ok": True}
    out["lint"] = str(tmp / "lint.json")
    with open(out["lint"], "w") as fh:
        json.dump(lint, fh)
    out["bad_lint"] = str(tmp / "bad_lint.json")
    with open(out["bad_lint"], "w") as fh:
        json.dump(dict(lint, ok=False, counts={"total": 3}), fh)
    return out


def _capture(fn, *args):
    """(return code, stdout, stderr) of ``fn(*args)``."""
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        try:
            rc = fn(*args)
        except SystemExit as ex:
            rc = ex.code
    return rc, o.getvalue(), e.getvalue()


# (arguments, expected exit code); paths are names in ``runs``
CHECKS = {
    "serve": (["--serve", "tenants_out"], 0),
    "serve_pool": (["--serve", "pool_out"], 0),
    "serve_corrupt": (["--serve", "bad_ledger"], 1),
    "events_rid_linkage": (["--events", "tenants", "--rid-linkage"], 0),
    "events_pool": (["--events", "pool", "--rid-linkage"], 0),
    "events_corrupt": (["--events", "bad_events", "--rid-linkage"], 1),
    "events_corrupt_unbalanced_ok": (["--unbalanced-ok", "--events",
                                      "bad_events"], 1),
    "tuning": (["--tuning", "@tools/tuning_table.json"], 0),
    "graftlint": (["--graftlint", "lint"], 0),
    "graftlint_broken": (["--graftlint", "bad_lint"], 1),
    "all_at_once": (["--serve", "tenants_out", "--events", "tenants",
                     "--tuning", "@tools/tuning_table.json"], 0),
    "bench_default_scan": ([], 0),
    "missing_file": (["--serve"], 2),
}


def _path(runs, name):
    if name.startswith("@"):
        return os.path.join(REPO, name[1:])
    if name in ("tenants", "pool"):
        return runs[name][0]
    if name.endswith("_out"):
        return runs[name[:-4]][1]
    return runs[name]


@pytest.mark.parametrize("case", list(CHECKS))
def test_check_artifacts_same_as_reference(runs, case):
    args, want = CHECKS[case]
    args = [a if a.startswith("--") else _path(runs, a) for a in args]
    port = _capture(CA.main, list(args))
    ref = _capture(RCA.main, ["tools/check_artifacts.py"] + list(args))
    assert port == ref
    assert port[0] == want, port


def test_analyze_request_same_as_reference(runs):
    for name in ("tenants", "pool"):
        paths = AR.expand_paths([runs[name][0]])
        assert paths == RAR.expand_paths([runs[name][0]])
        got, want = AR.analyze(paths, top=3), RAR.analyze(paths, top=3)
        assert got == want
        assert got["exact"] and got["requests"]
    assert AR.analyze([runs["tenants"][0]])["shed"]
    ev = runs["tenants"][0]
    for args in ([ev, "--check"], [ev, "--json"], [ev, "--top", "2"],
                 [ev, "--tenant", "pro", "--check"],
                 [runs["bad_events"], "--check"],
                 [ev + ".missing"]):
        port, ref = _capture(AR.main, args), _capture(RAR.main, args)
        assert port == ref, args
    assert _capture(AR.main, [ev, "--check"])[0] == 0
    assert _capture(AR.main, [ev + ".missing"])[0] == 2


def test_analyze_request_check_fails_a_broken_decomposition(tmp_path,
                                                            runs):
    # a retire whose recorded latency disagrees with its phases
    lines = open(runs["tenants"][0]).read().splitlines()
    i = next(j for j, ln in enumerate(lines) if '"retire"' in ln)
    rec = json.loads(lines[i])
    rec["attrs"]["latency_phases"] += 5
    lines[i] = json.dumps(rec)
    bad = tmp_path / "bad.jsonl"
    bad.write_text("\n".join(lines) + "\n")
    port = _capture(AR.main, [str(bad), "--check"])
    assert port == _capture(RAR.main, [str(bad), "--check"])
    assert port[0] == 1 and "does not sum" in port[2]


@pytest.mark.parametrize("name", ["tenants", "pool"])
def test_from_events_same_text_as_reference(runs, name):
    ev = runs[name][0]
    rc, text, err = _capture(AO.main, ["--from-events", ev])
    ref = subprocess.run(
        [sys.executable, "tools/analyze_occupancy.py", "--from-events",
         ev], capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert rc == ref.returncode == 0, ref.stderr
    assert text == ref.stdout
    assert "reconciliation: sum=" in text and "-> OK" in text
    if name == "pool":
        assert "lease reconciliation:" in text
    else:
        assert "=== multi-tenant SLO ===" in text


def test_from_events_flags_a_broken_timeline(runs):
    rc, text, _ = _capture(AO.main, ["--from-events", runs["bad_events"],
                                     "--lanes", "256"])
    assert rc == 1 and "WARNING schema:" in text


# --- --attribution on the CPU ---------------------------------------------------

ATTR = dict(m=8, eps=1e-7, bounds=(1e-2, 1.0),
            kw=dict(capacity=1 << 16, lanes=256, roots_per_lane=8,
                    seg_iters=32, min_active_frac=0.05))


@pytest.fixture(scope="module")
def attribution():
    """The three modes through the tool, the reference walker on the two
    ds modes, and the port's own scouting run."""
    from ppls_tpu.models.integrands import get_family as ref_family
    from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
    from ppls_tpu.parallel.walker import integrate_family_walker as ref
    theta = 1.0 + np.arange(ATTR["m"]) / ATTR["m"]
    args = (theta, ATTR["bounds"], ATTR["eps"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        box = {}

        def run():
            box["recs"] = AO.attribution("cpu", **ATTR)
            return 0
        text = _capture(run)[1]
        recs = box["recs"]
        refs = [ref(ref_family(AO.FAMILY), ref_family_ds(AO.FAMILY), *args,
                    **mode, **ATTR["kw"])
                for mode, _ in AO.ATTRIBUTION_MODES[:2]]
        own = integrate_family_walker(
            get_family(AO.FAMILY), get_family_ds(AO.FAMILY), *args,
            device="cpu", **AO.ATTRIBUTION_MODES[2][0], **ATTR["kw"])
    return dict(text=text, recs=recs, refs=refs, own=own)


def test_attribution_reconciles_in_every_mode(attribution):
    recs, text = attribution["recs"], attribution["text"]
    assert [r["label"] for r in recs] == [m[1] for m in
                                          AO.ATTRIBUTION_MODES]
    for r in recs:
        res, a = r["result"], r["attribution"]
        assert a["reconciles"]
        assert sum(a["buckets"].values()) == res.kernel_steps * 256
        assert r["launches"] == {"run_segment_rf": 0, "run_segment_ee": 0,
                                 "run_segment": 0}   # plain segments
    assert text.count("-> OK") == 3
    assert "eval split: scout_evals=" in text


def test_attribution_ds_modes_walk_the_reference_schedule(attribution):
    for r, ref in zip(attribution["recs"][:2], attribution["refs"]):
        res = r["result"]
        assert res.metrics.tasks == ref.metrics.tasks
        assert res.kernel_steps == ref.kernel_steps
        assert list(res.waste) == list(ref.waste)
        assert np.max(np.abs(res.areas - ref.areas)) < 3e-9


def test_attribution_scout_mode_is_the_walker_call(attribution):
    r, own = attribution["recs"][2], attribution["own"]
    assert r["attribution"] == own.attribution()
    assert r["result"].metrics.tasks == own.metrics.tasks
    assert np.array_equal(r["result"].areas, own.areas)
    assert r["result"].scout_evals == own.scout_evals > 0


# --- no card: the device tools refuse -----------------------------------------

@pytest.mark.parametrize("tool,argv", [
    (AO.main, []), (AO.main, ["dd"]), (AO.main, ["--attribution"]),
    (PB.main, ["3"]), (CD.main, [])])
def test_device_tools_refuse_without_a_card(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _capture(tool, argv)
    assert rc == 2
    assert "CUDA is not available; pass device='cpu'" in err


@pytest.mark.parametrize("fn", [AO.decompose, AO.dd, AO.attribution,
                                PB.profile, CD.characterize])
def test_device_functions_raise_without_a_card(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()


def test_dd_and_characterize_run_on_the_cpu(monkeypatch):
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    monkeypatch.setenv("PPLS_ANALYZE_DD_M", "4")
    monkeypatch.setattr(AO, "BOUNDS", (1e-2, 1.0))
    monkeypatch.setattr(AO, "EPS", 1e-7)
    kw = dict(chunk=1 << 8, capacity=1 << 16, lanes=256, roots_per_lane=8,
              seg_iters=32)
    box = {}

    def run():
        box["out"] = AO.dd("cpu", kw=kw)
        return 0
    text = _capture(run)[1]
    out = box["out"]
    assert out["world"] == 1 and out["ceiling"] == 0.0
    assert out["refill"].metrics.tasks == out["legacy"].metrics.tasks
    assert "no ceiling" in text and "collectives" in text
    monkeypatch.setattr(CD, "BOUNDS", (1e-2, 1.0))
    monkeypatch.setattr(CD, "EPS", 1e-7)
    small = dict(capacity=1 << 16, lanes=256, roots_per_lane=2,
                 seg_iters=32)
    rows = CD.characterize("cpu", m=4, repeats=1, configs=(
        ("single", "single", small),
        ("dd matched", "dd", dict(small, chunk=1 << 8))))
    assert rows[0]["tasks"] == rows[1]["tasks"] > 0


def test_headroom_ceiling_sources(monkeypatch):
    # the override, else the probe on a card, else no split
    monkeypatch.delenv("PPLS_CEILING_GSTEPS", raising=False)
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert AO._ceiling(card, lambda: 5e9) == 5e9
    assert AO._ceiling(cpu, lambda: 5e9) == 0.0
    monkeypatch.setenv("PPLS_CEILING_GSTEPS", "2.5")
    assert AO._ceiling(cpu, lambda: 5e9) == 2.5e9


# --- integrate_bag and korobov_search ---------------------------------------

def test_integrate_bag_reference_problem():
    from ppls_tpu.parallel.bag_engine import integrate_bag as ref_bag
    cfg = REFERENCE_CONFIG.replace(capacity=1 << 16)
    r = integrate_bag(cfg, chunk=1024, device="cpu")
    assert f"{r.areas[0]:.6f}" == "7583461.801486"
    ref = ref_bag(_ref_config(cfg), chunk=1024)
    assert r.metrics.tasks == ref.metrics.tasks == 6567
    assert r.metrics.splits == ref.metrics.splits


def _ref_config(cfg):
    from ppls_tpu.config import QuadConfig
    return QuadConfig(integrand=cfg.integrand, a=cfg.a, b=cfg.b,
                      eps=cfg.eps, capacity=cfg.capacity)


def test_integrate_bag_bit_equal_to_reference():
    from ppls_tpu.parallel.bag_engine import integrate_bag as ref_bag
    cfg = OSC_CONFIG.replace(capacity=1 << 18)
    r = integrate_bag(cfg, chunk=1 << 12, device="cpu")
    ref = ref_bag(_ref_config(cfg), chunk=1 << 12)
    assert r.metrics.tasks == ref.metrics.tasks
    assert r.areas[0] == ref.areas[0]


def test_integrate_bag_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        integrate_bag(REFERENCE_CONFIG.replace(capacity=1 << 16),
                      chunk=1024)


def test_korobov_search_equals_the_reference():
    for a in (3, 7, 1191):
        assert KS.p2_criterion(a, 1 << 12) == RKS.p2_criterion(a, 1 << 12)
    got = KS.search(1 << 10, n_candidates=16)
    want = RKS.search(1 << 10, n_candidates=16)
    assert got[:2] == want[:2]
