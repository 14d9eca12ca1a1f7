"""The port's pool dispatcher (``ppls_tpu_torch/runtime/dispatch.py``)
against the reference's (``ppls_tpu/runtime/dispatch.py``), on the CPU
with the tuning table off, at the reference tests' sizes
(tests/test_dispatch.py: ``EKW``, ``DKW``, ``MIXED``, ``ARR``).

Held against the reference:

* the key lattice: equal keys and, for every malformed request, the
  same message;
* the pool on the mixed-shape stream (four engine keys), uncapped and
  capped at two engines, with leasing and overlapped boundaries off and
  on: the same turns, per-engine phases, routed and completed counts,
  parks, lease ledger and per-request submit/admit/retire turns, areas
  within 3e-9 (the walker contract: the reference's interpret-mode walk
  flips its last bits, tests/test_torch_stream.py), and zero recompiles
  in both;
* ``serve --dispatch`` through both CLIs in-process on tools/ci.sh's
  legs 5e and 5f (their request list with its malformed line, their
  flags and chaos plans): the same ledgers within 3e-9, the same
  rejection text, and ci.sh's summary assertions; the reference's
  refusals of ``--dispatch --spillover`` and ``--dispatch --processes``
  in its words.

Held on the port alone, bit for bit: reruns; overlapped boundaries
against serialized ones; kill-and-resume from the coordinated cut
(leasing off and on, capped) against the undisturbed run; a parked
lease donor reconciling its grants; the capped pool's own replay. A
capped pool is NOT bit-equal to the uncapped one: parking moves the
turn a request reaches its engine, so the walk may stop on another
eps-valid grid (the reference's contract, tests/test_dispatch.py:135,
which the port keeps at the same 5e-5). Also: the reference bench's
hetero stream (tools/bench_history.py) drains in 9 turns with leasing
off and 6 with leasing and overlap (the reference's pins); the
reference's ``tools/analyze_occupancy.py --from-events`` reconciles the
port pool's events file; compile accounting counts a library build in
an engine's second phase as one recompile and one in its first as none;
a walker-dd pool (two ranks per engine, parked and unparked) gives the
walker pool's records item for item on the dyadic family and leaves no
rank alive; and without a card the pool raises ``resolve_device``'s
error.
"""

import contextlib
import glob
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ppls_tpu import __main__ as RCLI
from ppls_tpu.runtime import dispatch as RD
from ppls_tpu_torch import __main__ as CLI
from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.obs.telemetry import Telemetry
from ppls_tpu_torch.runtime import dispatch as TD
from ppls_tpu_torch.runtime import stream as TS
from ppls_tpu_torch.utils import cuda_build
from ppls_tpu_torch.utils.artifact_schema import validate_events_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAM = "sin_recip_scaled"
BOUNDS = (1e-2, 1.0)
# tests/test_dispatch.py:36-59
EKW = dict(chunk=1 << 10, capacity=1 << 16, lanes=256,
           roots_per_lane=2, refill_slots=2, seg_iters=32,
           min_active_frac=0.05)
DKW = dict(slots=8, max_engines=4, default_eps=1e-6, engine_kw=EKW)
MIXED = [
    (1.0, BOUNDS, {}),
    (1.05, BOUNDS, {"eps": 1e-7}),
    (1.1, BOUNDS, {"rule": "simpson"}),
    ((1.15, 1.2), BOUNDS, {}),
    (1.25, BOUNDS, {}),
    (1.3, BOUNDS, {"eps": 1e-7}),
    (1.35, BOUNDS, {"rule": "simpson"}),
    ((1.4, 1.45), BOUNDS, {}),
]
ARR = [0, 0, 0, 1, 1, 2, 2, 3]
MIXED_KEYS = {"e-6:trapezoid:t1", "e-7:trapezoid:t1",
              "e-6:simpson:t1", "e-6:trapezoid:t2"}
AREA_TOL = 3e-9
CAPPED_TOL = 5e-5              # tests/test_dispatch.py:135
POOLS = {
    "plain": {},
    "capped": dict(max_engines=2),
    "lease": dict(lease=True, overlap_boundaries=True),
    "lease_capped": dict(lease=True, overlap_boundaries=True,
                         max_engines=2),
}


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


def _port(family=FAM, **kw):
    return TD.EngineDispatcher(family, device="cpu", **dict(DKW, **kw))


def _parks(disp):
    return sum(child.value for _, child in disp._c_park.items())


def _turns(res):
    return sorted((c.rid, c.submit_phase, c.admit_phase, c.retire_phase)
                  for c in res.completed)


def _engines(disp):
    """The schedule-defined part of the per-engine summary."""
    return {k: {f: v[f] for f in ("state", "phases", "pending",
                                  "resident", "completed", "shed",
                                  "routed", "lease_donated",
                                  "lease_received")}
            for k, v in disp.engines_summary().items()}


def _ledger(disp):
    ls = disp.lease_summary()
    return {k: ls[k] for k in ("enabled", "overlap_boundaries", "donated",
                               "received", "balanced", "by_donor",
                               "by_borrower", "boundaries", "overlapped")}


def _drive_to_drain(disp, reqs, arr):
    """tests/test_dispatch.py's resume driver: the unconsumed suffix of
    the arrival schedule, then turns until idle."""
    k = disp.next_rid
    while not disp.idle or k < len(reqs):
        while k < len(reqs) and arr[k] <= disp.phase:
            r = reqs[k]
            disp.submit(r[0], r[1], **(r[2] if len(r) > 2 else {}))
            k += 1
        disp.step()
    return disp.result()


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Each pool configuration once through each package; the port's
    with an events file."""
    tmp = tmp_path_factory.mktemp("pools")
    out = {}
    for name, over in POOLS.items():
        r_disp = RD.EngineDispatcher(FAM, **dict(DKW, **over))
        r_res = r_disp.run(MIXED, arrival_phase=ARR)
        ev = str(tmp / f"{name}.jsonl")
        tel = Telemetry(events_path=ev)
        p_disp = _port(telemetry=tel, **over)
        p_res = p_disp.run(MIXED, arrival_phase=ARR)
        tel.close()
        out[name] = (r_disp, r_res, p_disp, p_res, ev)
    return out


# ---------------------------------------------------------------------------
# the key lattice
# ---------------------------------------------------------------------------


def test_canonical_key_lattice_matches_reference():
    cases = [(1e-7, "trapezoid", 1.0), (2e-7, "trapezoid", 1.0),
             (9e-7, "trapezoid", 1.0), (1e-6, "trapezoid", (1.0, 1.1)),
             (1e-6, "trapezoid", (1.0, 1.1, 1.2)),
             (1e-6, "trapezoid",
              tuple(1.0 + i / 64 for i in range(TD.MAX_THETA_BUCKET))),
             (1e-6, " Simpson ", 1.0), (1e-12, "trapezoid", 1.0),
             (0.1, "simpson", np.array([2.0]))]
    for eps, rule, theta in cases:
        got = TD.canonical_key(eps, rule, theta)
        ref = RD.canonical_key(eps, rule, theta)
        assert str(got) == str(ref)
        assert (got.eps_band, got.rule, got.theta_block, got.eps) == \
            (ref.eps_band, ref.rule, ref.theta_block, ref.eps)
        assert TD.EngineKey.parse(str(got)) == got
    assert TD.canonical_key(1e-6, Rule.SIMPSON, 1.0).rule == "simpson"
    assert (TD.EPS_BAND_MIN, TD.EPS_BAND_MAX, TD.MAX_THETA_BUCKET) == \
        (RD.EPS_BAND_MIN, RD.EPS_BAND_MAX, RD.MAX_THETA_BUCKET)
    with pytest.raises(ValueError, match="malformed engine key"):
        TD.EngineKey.parse("e-6:trapezoid")


# tests/test_dispatch.py:97-111
@pytest.mark.parametrize("eps,rule,theta", [
    (0.0, "trapezoid", 1.0),
    (float("nan"), "trapezoid", 1.0),
    ("x", "trapezoid", 1.0),
    (1e-20, "trapezoid", 1.0),
    (1.0, "trapezoid", 1.0),
    (1e-6, "simpsonish", 1.0),
    (1e-6, "trapezoid", ()),
    (1e-6, "trapezoid", tuple(range(TD.MAX_THETA_BUCKET + 1))),
    (1e-6, "simpson", (1.0, 1.1)),
])
def test_canonical_key_rejects_as_the_reference(eps, rule, theta):
    with pytest.raises(ValueError) as ep:
        TD.canonical_key(eps, rule, theta)
    with pytest.raises(ValueError) as er:
        RD.canonical_key(eps, rule, theta)
    assert str(ep.value) == str(er.value)


# ---------------------------------------------------------------------------
# the pool against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(POOLS))
def test_pool_matches_reference(pools, name):
    r_disp, r_res, p_disp, p_res, _ev = pools[name]
    assert len(p_res.completed) == len(MIXED)
    assert p_res.phases == r_res.phases
    assert _turns(p_res) == _turns(r_res)
    assert np.max(np.abs(p_res.areas - r_res.areas)) < AREA_TOL
    assert _engines(p_disp) == _engines(r_disp)
    assert set(_engines(p_disp)) == MIXED_KEYS
    assert _parks(p_disp) == _parks(r_disp)
    assert _ledger(p_disp) == _ledger(r_disp)
    assert p_disp.recompiles() == r_disp.recompiles() == 0
    assert p_res.totals["tasks"] > 0 and p_res.host_syncs > 0


def test_pool_replays_bit_for_bit(pools):
    for name in ("plain", "lease_capped"):
        res = _port(**POOLS[name]).run(MIXED, arrival_phase=ARR)
        assert np.array_equal(res.areas, pools[name][3].areas), name
        assert _turns(res) == _turns(pools[name][3]), name


def test_capped_pool_parks_within_the_reference_contract(pools):
    """max_engines=2 parks (as often as the reference's pool) and
    unparks bit-identically (the kill-and-resume cases below pin the park
    files bit for bit); against the uncapped pool the areas move within
    the reference's tolerance, because parking moves the turn a request
    reaches its engine."""
    for name, base in (("capped", "plain"), ("lease_capped", "lease")):
        _r, _rr, p_disp, p_res, _ev = pools[name]
        assert _parks(p_disp) >= 2
        states = {e["state"] for e in p_disp.engines_summary().values()}
        assert "parked" in states
        d = np.max(np.abs(p_res.areas - pools[base][3].areas))
        assert d < CAPPED_TOL, (name, d)


def test_overlap_matches_sync_bit_identical(pools):
    d_sync = _port(lease=True)
    r_sync = d_sync.run(MIXED, arrival_phase=ARR)
    d_ov, r_ov = pools["lease"][2], pools["lease"][3]
    assert np.array_equal(r_sync.areas, r_ov.areas)
    assert _turns(r_sync) == _turns(r_ov)
    ls_s, ls_o = d_sync.lease_summary(), d_ov.lease_summary()
    for k in ("by_donor", "by_borrower", "boundaries"):
        assert ls_s[k] == ls_o[k]
    assert ls_s["overlapped"] == 0 and ls_o["overlapped"] >= 1
    assert d_sync.recompiles() == d_ov.recompiles() == 0


def test_parked_lease_donor_reconciles(pools):
    """tests/test_dispatch.py:339-386 on the port: a parked engine
    donates its credit, comes back and completes its routed requests;
    the grants in the timeline sum to the ledger."""
    _r, _rr, disp, res, ev = pools["lease_capped"]
    ls = disp.lease_summary()
    assert ls["donated"] == ls["received"] >= 1 and ls["balanced"]
    grants = [r for r in (json.loads(ln) for ln in open(ev) if ln.strip())
              if r.get("ev") == "event" and r.get("name") == "lease_grant"]
    assert sum(g["attrs"]["credits"] for g in grants) == ls["received"]
    parked = {g["attrs"]["donor"] for g in grants
              if g["attrs"]["donor_parked"]}
    assert parked
    summary = disp.engines_summary()
    for k in parked:
        assert summary[k]["completed"] >= 1, (k, summary[k])
    assert sum(e["completed"] for e in summary.values()) == len(MIXED)
    assert validate_events_text(open(ev).read(),
                                check_rid_linkage=True) == []


@pytest.mark.parametrize("lease", [False, True], ids=["capped",
                                                      "lease_capped"])
def test_kill_and_resume_bit_identical(pools, tmp_path, lease):
    """Capped pool (the cut carries parked engines too), crashed after
    turn 3 and resumed from the coordinated cut: the continued run,
    unparks and lease ledger included, is the undisturbed one bit for
    bit; the timelines keep the rid linkage."""
    name = "lease_capped" if lease else "capped"
    over = POOLS[name]
    base_d, base = pools[name][2], pools[name][3]
    path = str(tmp_path / "pool.ckpt")
    crash_ev = str(tmp_path / "crash.jsonl")
    tel = Telemetry(events_path=crash_ev)
    disp = _port(telemetry=tel, checkpoint_path=path, checkpoint_every=1,
                 **over)
    assert disp.checkpoint_background == lease   # overlap => background
    with pytest.raises(RuntimeError, match="simulated crash"):
        disp.run(MIXED, arrival_phase=ARR, _crash_after_turns=3)
    tel.close()
    resume_ev = str(tmp_path / "resume.jsonl")
    tel = Telemetry(events_path=resume_ev)
    disp2 = TD.EngineDispatcher.resume(path, FAM, telemetry=tel,
                                       device="cpu", checkpoint_every=1,
                                       **dict(DKW, **over))
    assert disp2.phase == 3 and disp2.recompiles() == 0
    mid = disp2.lease_summary()
    assert mid["donated"] == mid["received"]
    res = _drive_to_drain(disp2, MIXED, ARR)
    tel.close()
    assert np.array_equal(res.areas, base.areas)
    assert res.phases == base.phases and _turns(res) == _turns(base)
    assert _ledger(disp2) == _ledger(base_d)
    assert disp2.recompiles() == 0
    assert set(disp2.engines_summary()) == MIXED_KEYS
    for ev in (crash_ev, resume_ev):
        assert validate_events_text(open(ev).read(), require_balanced=False,
                                    check_rid_linkage=True) == []


def test_resume_refuses_other_config_and_pool(tmp_path):
    """tests/test_dispatch.py:190-230: a manifest of another pool
    configuration, and a cut blended with another pool's engine file,
    refuse in the reference's words."""
    reqs = [(1.0 + i / 8, BOUNDS) for i in range(3)]
    paths = {}
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        paths[name] = str(tmp_path / name / "pool.ckpt")
        disp = _port(checkpoint_path=paths[name], checkpoint_every=1)
        with pytest.raises(RuntimeError, match="simulated crash"):
            disp.run(reqs, _crash_after_turns=1)
    with pytest.raises(ValueError) as ei:
        TD.EngineDispatcher.resume(paths["a"], FAM, device="cpu",
                                   **dict(DKW, slots=4))
    assert str(ei.value) == (
        f"dispatch manifest {paths['a']!r} belongs to a different pool "
        f"configuration; refusing to blend (stored vs requested): "
        f"{{'slots': (8, 4)}}")
    a_cuts = sorted(glob.glob(paths["a"] + ".c*"))
    b_cuts = sorted(glob.glob(paths["b"] + ".c*"))
    assert a_cuts and [os.path.basename(p) for p in a_cuts] == \
        [os.path.basename(p) for p in b_cuts]
    for src, dst in zip(b_cuts, a_cuts):
        shutil.copyfile(src, dst)
    with pytest.raises(ValueError,
                       match=r"^engine snapshot 'pool\.ckpt\.c00001\.e-6-"
                             r"trapezoid-t1' belongs to a different pool "
                             r"\(stored '[0-9a-f]{16}', manifest "
                             r"'[0-9a-f]{16}'\); refusing to blend$"):
        TD.EngineDispatcher.resume(paths["a"], FAM, device="cpu",
                                   checkpoint_every=1, **DKW)


# ---------------------------------------------------------------------------
# the reference bench's hetero stream, the occupancy tool, compiles
# ---------------------------------------------------------------------------


def test_hetero_stream_lease_pins():
    """tests/test_dispatch.py:263-313's pins on the port: lease off 9
    turns at a mean latency of 1.5 turns; lease and overlap 6 turns, >=
    1.2x better, a balanced ledger, at least one overlapped boundary."""
    from tools.bench_history import (HETERO_EKW, HETERO_FAMILY,
                                     HETERO_MAX_ENGINES, HETERO_SLOTS,
                                     _hetero_requests)
    reqs, arr = _hetero_requests()
    kw = dict(slots=HETERO_SLOTS, max_engines=HETERO_MAX_ENGINES,
              engine_kw=dict(HETERO_EKW), device="cpu")
    d0 = TD.EngineDispatcher(HETERO_FAMILY, **kw)
    r0 = d0.run(reqs, arrival_phase=arr)
    lat0 = [c.retire_phase - c.submit_phase for c in r0.completed]
    assert r0.phases == 9 and float(np.mean(lat0)) == pytest.approx(1.5)
    assert d0.recompiles() == 0
    ls0 = d0.lease_summary()
    assert ls0["enabled"] is False and ls0["donated"] == 0
    d1 = TD.EngineDispatcher(HETERO_FAMILY, lease=True,
                             overlap_boundaries=True, **kw)
    r1 = d1.run(reqs, arrival_phase=arr)
    lat1 = [c.retire_phase - c.submit_phase for c in r1.completed]
    assert len(r1.completed) == len(reqs) and r1.phases == 6
    assert np.all(np.isfinite(r1.areas)) and d1.recompiles() == 0
    assert float(np.mean(lat0)) / float(np.mean(lat1)) >= 1.2
    ls = d1.lease_summary()
    assert ls["donated"] == ls["received"] >= 1 and ls["balanced"]
    assert ls["overlapped"] >= 1 and 0.0 < ls["overlap_fraction"] <= 1.0


def test_analyze_occupancy_reconciles_the_port_events(pools):
    """The reference's offline tool over the port pool's events file:
    the per-engine and the lease reconciliations both OK."""
    ev = pools["lease"][4]
    r = subprocess.run(
        [sys.executable, "tools/analyze_occupancy.py", "--from-events", ev,
         "--lanes", str(EKW["lanes"])],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "per-engine decomposition" in r.stdout
    assert "donated=" in r.stdout and "borrowed=" in r.stdout
    assert "leased_phases=" in r.stdout
    assert "lease reconciliation:" in r.stdout
    lines = [ln for ln in r.stdout.splitlines() if "reconciliation:" in ln]
    assert len(lines) >= 2 and all("OK" in ln for ln in lines), lines


@pytest.mark.parametrize("phase,want", [(1, 0), (2, 1)])
def test_compile_accounting_counts_builds_after_the_first_phase(
        monkeypatch, phase, want):
    """A library build while an engine runs its first phase is its
    baseline; one in a later phase is a recompile, on its label."""
    builds = {"n": 0}
    calls = {}
    monkeypatch.setattr(cuda_build, "builds_done", lambda: builds["n"])
    orig = TS.StreamEngine.step_begin

    def step_begin(self):
        calls[self.eps] = calls.get(self.eps, 0) + 1
        if self.eps == 1e-7 and calls[self.eps] == phase:
            builds["n"] += 1
        return orig(self)

    monkeypatch.setattr(TS.StreamEngine, "step_begin", step_begin)
    disp = _port()
    disp.run(MIXED[:2] + MIXED[5:6], arrival_phase=[0, 0, 1])
    assert calls[1e-7] >= 2
    assert disp.recompiles() == want
    reg = disp.telemetry.registry
    assert reg.value("ppls_recompiles_total",
                     engine="walker-stream[e-7:trapezoid:t1]") == want


def test_pool_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available; pass "
                                           "device='cpu'"):
        TD.EngineDispatcher(FAM)


# ---------------------------------------------------------------------------
# a walker-dd pool
# ---------------------------------------------------------------------------

DD_KW = dict(chunk=1 << 8, capacity=1 << 16, lanes=256, roots_per_lane=2,
             refill_slots=2, seg_iters=32, min_active_frac=0.05)
DYADIC = [(1.0, (0.0, 1.0), {}), (1.25, (0.0, 1.0), {}),
          (1.5, (0.0, 1.0), {"eps": 1e-8}), (2.0, (0.0, 1.0), {"eps": 1e-8}),
          (0.75, (0.0, 1.0), {}), (3.0, (0.0, 1.0), {})]
DYADIC_ARR = [0, 0, 1, 1, 2, 3]


def _records(res):
    return sorted((c.rid, c.area, c.failed, c.submit_phase, c.admit_phase,
                   c.retire_phase, c.last_credited_phase,
                   c.first_seeded_phase) for c in res.completed)


def test_walker_dd_pool_parks_its_worlds():
    """Two engine keys through one live engine (max_engines=1), each a
    walker-dd stream of two gloo ranks: the dyadic quad_scaled records
    equal the walker pool's item for item; every parked engine's world
    is closed, and ``close()`` stops the live one."""
    kw = dict(slots=8, max_engines=1, default_eps=1e-9, device="cpu")
    base = TD.EngineDispatcher("quad_scaled", engine_kw=DD_KW, **kw).run(
        DYADIC, arrival_phase=DYADIC_ARR)
    disp = TD.EngineDispatcher(
        "quad_scaled", engine_kw=dict(DD_KW, engine="walker-dd",
                                      n_devices=2), **kw)
    worlds = []
    park = disp._park

    def park_and_keep(keystr):
        worlds.append(disp._engines[keystr]._world)
        park(keystr)

    disp._park = park_and_keep
    try:
        res = disp.run(DYADIC, arrival_phase=DYADIC_ARR)
        assert _records(res) == _records(base)
        assert res.phases == base.phases and disp.recompiles() == 0
        spinups = {k[0]: c.value for k, c in disp._c_spinup.items()}
        assert spinups == {"e-9:trapezoid:t1": 2, "e-8:trapezoid:t1": 1}
        assert _parks(disp) == 2 and len(worlds) == 2
        assert all(not p.is_alive() for w in worlds for p in w._procs)
        live = [e._world for e in disp._engines.values()]
        assert len(live) == 1 and all(p.is_alive() for p in live[0]._procs)
    finally:
        disp.close()
    assert not any(p.is_alive() for p in live[0]._procs)


# ---------------------------------------------------------------------------
# serve --dispatch through both CLIs
# ---------------------------------------------------------------------------

# tools/ci.sh legs 5e and 5f (:530-540, :587-612)
CI_REQS = [
    {"theta": 1.0, "bounds": [1e-2, 1.0], "arrival_phase": 0},
    {"theta": 1.05, "bounds": [1e-2, 1.0], "eps": 1e-7, "arrival_phase": 0},
    {"theta": 1.1, "bounds": [1e-2, 1.0], "rule": "simpson",
     "arrival_phase": 0},
    {"theta": [1.15, 1.2], "bounds": [1e-2, 1.0], "arrival_phase": 1},
    {"theta": 1.25, "bounds": [1e-2, 1.0], "arrival_phase": 1},
    {"theta": 1.3, "bounds": [1e-2, 1.0], "eps": 1e-7, "arrival_phase": 2},
    {"theta": 1.35, "bounds": [1e-2, 1.0], "rule": "simpson",
     "arrival_phase": 2},
    {"theta": [1.4, 1.45], "bounds": [1e-2, 1.0], "arrival_phase": 3},
]
CI_MALFORMED = {"theta": 1.5, "bounds": [1e-2, 1.0], "eps": 1e-20}
CI_ARGS = ["--dispatch", "--max-engines", "4", "--supervise", "--eps",
           "1e-6", "-a", "1e-2", "-b", "1.0", "--slots", "4", "--chunk",
           "512", "--capacity", "65536", "--lanes", "256", "--refill-slots",
           "2", "--checkpoint-every", "1", "--watchdog", "120"]
CI_LEGS = {
    "5e": ([], "chaos_plan_dispatch.json", True),
    "5f": (["--lease", "--overlap-boundaries"],
           "chaos_plan_dispatch_lease.json", False),
}


def _cli(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["serve"] + argv)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.fixture(scope="module")
def ci_legs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ci")
    out = {}
    for leg, (extra, plan, malformed) in CI_LEGS.items():
        reqs = tmp / f"{leg}.jsonl"
        reqs.write_text("".join(json.dumps(r) + "\n" for r in CI_REQS
                                + ([CI_MALFORMED] if malformed else [])))
        runs = {}
        for pkg, cli, dev in (("port", CLI, ["--device", "cpu"]),
                              ("ref", RCLI, [])):
            argv = CI_ARGS + extra + [
                "--requests", str(reqs),
                "--checkpoint", str(tmp / f"{leg}_{pkg}.ckpt"),
                "--events", str(tmp / f"{leg}_{pkg}.jsonl"),
                "--fault-plan", "@" + os.path.join(REPO, "tools", plan)] + dev
            runs[pkg] = _cli(cli, argv)
        out[leg] = runs
    return out


def _split(recs):
    retires, rejects = {}, []
    for r in recs[:-1]:
        if r.get("rejected"):
            rejects.append(r)
        else:
            retires[r["rid"]] = r
    return retires, rejects, recs[-1]


@pytest.mark.parametrize("leg", list(CI_LEGS))
def test_serve_dispatch_matches_reference_cli(ci_legs, leg):
    (rc, got), (rrc, ref) = ci_legs[leg]["port"], ci_legs[leg]["ref"]
    assert rc == rrc == 0
    g_ret, g_rej, g_sum = _split(got)
    r_ret, r_rej, r_sum = _split(ref)
    assert g_rej == r_rej
    assert sorted(g_ret) == sorted(r_ret) == list(range(8))
    for rid, r in r_ret.items():
        g = g_ret[rid]
        for k in ("theta", "bounds", "admit_phase", "retire_phase",
                  "phases_in_flight", "latency_phases", "tenant",
                  "priority"):
            assert g[k] == r[k], (rid, k)
        assert abs(g["area"] - r["area"]) < AREA_TOL, rid
        if "areas" in r:
            assert np.max(np.abs(np.subtract(g["areas"], r["areas"]))) \
                < AREA_TOL
    for k in ("completed", "phases", "shed", "dispatch", "max_engines",
              "recompiles", "attempts", "recoveries", "faults_injected",
              "totals"):
        assert g_sum[k] == r_sum[k], k
    for k, e in r_sum["engines"].items():
        assert {f: v for f, v in g_sum["engines"][k].items()} == e, k
    for k in ("enabled", "overlap_boundaries", "donated", "received",
              "balanced", "by_donor", "by_borrower", "boundaries",
              "overlapped", "overlap_fraction"):
        assert g_sum["leases"][k] == r_sum["leases"][k], k


@pytest.mark.parametrize("leg", list(CI_LEGS))
def test_serve_dispatch_holds_the_ci_assertions(ci_legs, leg):
    """tools/ci.sh:552-569 and :620-645 on the port's ledger."""
    _rc, lines = ci_legs[leg]["port"]
    s = lines[-1]
    assert s["summary"] and s["supervised"] and s["dispatch"] is True
    assert s["recompiles"] == 0 and s["completed"] == 8
    assert len(s["engines"]) >= 3
    assert sum(e["completed"] for e in s["engines"].values()) == 8
    assert s["attempts"] >= 2
    assert {e["kind"] for e in s["faults_injected"]} == {"crash"}
    rej = [r for r in lines if r.get("rejected")]
    if leg == "5e":
        assert len(rej) == 1 and "eps" in rej[0]["error"]
        assert rej[0]["error"].startswith(
            "eps 1e-20 quantizes to band 1e-20, outside the dispatchable "
            "range")
        return
    L = s["leases"]
    assert L["enabled"] and L["overlap_boundaries"]
    assert L["donated"] == L["received"] >= 1 and L["balanced"]
    assert L["overlapped"] >= 1 and L["overlap_fraction"] > 0.0


@pytest.mark.parametrize("argv", [
    ["--dispatch", "--spillover"],
    ["--dispatch", "--processes", "2"],
], ids=["spillover", "processes"])
def test_serve_dispatch_refusals_in_the_reference_words(argv, capsys):
    load = ["--synthetic", "2", "--slots", "4", "--lanes", "256"]
    with pytest.raises(SystemExit) as ep:
        CLI.main(["serve"] + argv + load + ["--device", "cpu"])
    with pytest.raises(SystemExit) as er:
        RCLI.main(["serve"] + argv + load)
    assert str(ep.value.code) == str(er.value.code)
    assert "--dispatch" in str(ep.value.code)
    capsys.readouterr()
