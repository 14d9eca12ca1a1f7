"""``python -m ppls_tpu_torch`` (the root command and ``family``) against
``python -m ppls_tpu``, on the CPU (``--device cpu``), in-process.

* The same argv through both CLIs: the root command through the host
  and device engines, the spillover backend, Simpson, an overflowing
  device frontier and ``--checkpoint``; ``family`` through the float64
  bag, the walker with boundary refill (K2's plain segment) and with
  in-kernel refill (K1's), an explicit ``--theta`` and ``--theta-block``.
  The JSON lines are equal key for key except the walls
  (``wall_time_s`` and the rates derived from it); areas are held to
  1e-14 relative on the float64 engines (the libraries' reduction
  orders and transcendentals differ in the last ulps) and to 3e-9 on the
  walker (the walker contract, tests/test_torch_walker.py). The walker
  runs at 256 lanes in both packages (the CLI has no lanes flag; at the
  default 16384 lanes these sizes never leave the breed), so the walk
  kernels' plain segments run.
* ``serve --spillover`` on the reference's spillover case (the dyadic
  ``quad_scaled`` family, queue limit 2): the reference's records,
  spillover flags, sheds and summary; a run killed by an injected crash
  and recovered from its snapshot equals the uninterrupted one.
* ``family --watchdog`` with ``PPLS_CLI_INJECT_HANG`` resumes from the
  leg snapshot (tests/test_guard.py:159).
* ``--trace`` on a recorder and for real on the CPU (tests/
  test_tracing.py's cases), for the root command and ``serve``.
* ``family --engine sharded-bag|sharded-walker|sharded-walker-dd`` at
  ``--n-devices 4`` (gloo ranks on the CPU; the reference on 4 of its 8
  host devices), with the walker patched to 256 lanes in both packages
  as above; the JSON lines as for ``family``.
* ``--engine sharded``, ``2d --n-devices 2`` and ``qmc --n-devices 2``
  run on 2 gloo ranks (one spawned world runs the three commands): the
  golden area with a two-rank histogram, the 2D default problem's cells
  and the lattice's estimates of the one-device run; without a card and
  without ``--device cpu`` both commands exit non-zero before they run.
"""

import contextlib
import functools
import io
import json
import os

import numpy as np
import pytest
import torch

from ppls_tpu import __main__ as RCLI
from ppls_tpu.parallel import sharded_walker as RSW
from ppls_tpu.parallel import walker as RW
from ppls_tpu_torch import __main__ as CLI
from ppls_tpu_torch.parallel import sharded_walker as TSW
from ppls_tpu_torch.parallel.mesh import launch, run_calls
from ppls_tpu_torch.parallel import walker as TW
from ppls_tpu_torch.utils import tracing

AREA_REL = 1e-14
WALK_TOL = 3e-9
# walls and the rates derived from them
_WALLS = ("wall_time_s", "tasks_per_sec", "evals_per_sec_per_chip")
WALK_KW = dict(lanes=256, roots_per_lane=8, seg_iters=32,
               min_active_frac=0.05)


@pytest.fixture(scope="module", autouse=True)
def _env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        for mod, names in (
                (RW, ("integrate_family_walker", "resume_family_walker")),
                (TW, ("integrate_family_walker", "resume_family_walker")),
                (RSW, ("integrate_family_walker_dd",
                       "resume_family_walker_dd")),
                (TSW, ("integrate_family_walker_dd",
                       "resume_family_walker_dd"))):
            for name in names:
                mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                        **WALK_KW))
        yield


def _run(cli, argv):
    """``cli.main(argv)`` with stdout captured: (rc, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _both(argv):
    """The JSON line of the port (``--device cpu``) and of the
    reference for one argv."""
    rc, out = _run(CLI, argv + ["--device", "cpu"])
    rrc, rout = _run(RCLI, argv)
    assert rc == rrc == 0
    return (json.loads(out.strip().splitlines()[-1]),
            json.loads(rout.strip().splitlines()[-1]))


def _assert_same(got, ref, areas, atol):
    """Equal key for key except the walls; ``areas`` (keys of floats or
    lists of floats: the areas and the errors that follow them) within
    the absolute ``atol``."""
    assert set(got) == set(ref)
    for k in ref:
        if k in _WALLS:
            continue
        if k in areas and ref[k] is not None:
            g, r = np.asarray(got[k]), np.asarray(ref[k])
            assert np.all(np.abs(g - r) <= atol), (k, got[k], ref[k])
        else:
            assert got[k] == ref[k], (k, got[k], ref[k])


ROOT = {
    "host": [],
    "device": ["--engine", "device"],
    "spillover": ["--backend", "spillover"],
    "simpson": ["--rule", "simpson"],
    "device_overflow": ["--engine", "device", "--capacity", "64"],
    "sin": ["--integrand", "sin", "-a", "0", "-b", "1", "--eps", "1e-6",
            "--engine", "device"],
}


@pytest.mark.parametrize("name", list(ROOT))
def test_root_command_matches_reference(name):
    got, ref = _both(ROOT[name] + ["--json"])
    _assert_same(got, ref, ("area", "global_error"),
                 AREA_REL * abs(ref["area"]))
    if name in ("host", "device", "spillover", "device_overflow"):
        assert f"{got['area']:.6f}" == "7583461.801486"
        assert (got["tasks"], got["splits"], got["leaves"]) \
            == (6567, 3283, 3284)
        assert (got["rounds"], got["max_depth"]) == (15, 14)


def test_root_table_matches_reference():
    rc, out = _run(CLI, ["--device", "cpu"])
    rrc, rout = _run(RCLI, [])
    assert rc == rrc == 0
    lines, rlines = out.splitlines(), rout.splitlines()
    assert lines[0] == rlines[0] == "Area=7583461.801486"
    # the last line carries the wall; the global error's last digits
    # follow the area's last bits
    assert lines[1:6] + lines[7:-1] == rlines[1:6] + rlines[7:-1]
    assert lines[6].startswith("Global error: 4.39989")
    assert lines[-1].startswith("Integrand evals: 19701 (")


def test_root_checkpoint_runs_and_resumes_either_snapshot(tmp_path):
    """``--checkpoint``: a fresh run equals the plain one; a snapshot left
    by an interrupted run of either package resumes in the port's CLI to
    the port's uninterrupted area."""
    from ppls_tpu.config import REFERENCE_CONFIG as RREF
    from ppls_tpu.runtime import checkpoint as RC
    from ppls_tpu.runtime.host_frontier import integrate as rint
    from ppls_tpu_torch.config import REFERENCE_CONFIG
    from ppls_tpu_torch.runtime import checkpoint as TC
    from ppls_tpu_torch.runtime.host_frontier import integrate

    plain, _ = _both(["--json"])
    path = str(tmp_path / "p.ckpt")
    rc, out = _run(CLI, ["--checkpoint", path, "--json", "--device", "cpu"])
    rrc, rout = _run(RCLI, ["--checkpoint", str(tmp_path / "r.ckpt"),
                            "--json"])
    fresh, ref = json.loads(out), json.loads(rout)
    assert rc == rrc == 0
    _assert_same(fresh, ref, ("area", "global_error"),
                 AREA_REL * abs(ref["area"]))
    assert fresh["area"] == plain["area"]

    class Stop(Exception):
        pass

    for ck, run, cfg, kw in ((TC, integrate, REFERENCE_CONFIG,
                              {"device": "cpu"}),
                             (RC, rint, RREF, {})):
        os.unlink(path)
        writer = ck.Checkpointer(path, config=cfg)

        def hook(i, f, a, m):
            writer.hook(i, f, a, m)
            if i == 6:
                raise Stop

        with pytest.raises(Stop):
            run(cfg, on_round=hook, **kw)
        rc, out = _run(CLI, ["--checkpoint", path, "--device", "cpu",
                             "--json"])
        res = json.loads(out)
        assert rc == 0 and res["area"] == plain["area"]
        assert res["tasks"] == 6567 and res["rounds"] == 15


FAMILY = {
    "bag": ["family", "--m", "4", "--eps", "1e-5", "--chunk", "512",
            "--capacity", "32768", "-a", "1e-2"],
    "bag_theta": ["family", "--theta", "1.0,1.5,2.0", "--eps", "1e-6",
                  "--chunk", "512", "--capacity", "32768", "-a", "1e-2"],
    "walker_k2": ["family", "--engine", "walker", "--m", "8", "--eps",
                  "1e-7", "-a", "1e-2", "--chunk", "1024", "--capacity",
                  "65536"],
    "walker_k1": ["family", "--engine", "walker", "--m", "8", "--eps",
                  "1e-7", "-a", "1e-2", "--chunk", "1024", "--capacity",
                  "65536", "--refill-slots", "8", "--scout-dtype", "f32",
                  "--double-buffer"],
    "walker_theta_block": ["family", "--engine", "walker", "--family",
                           "sin_scaled", "--m", "16", "--theta-block", "8",
                           "--refill-slots", "2", "-a", "0", "-b", "1",
                           "--eps", "1e-6", "--capacity", "65536",
                           "--chunk", "1024"],
}


@pytest.mark.parametrize("name", list(FAMILY))
def test_family_command_matches_reference(name):
    got, ref = _both(FAMILY[name] + ["--json"])
    walker = "walker" in name
    _assert_same(got, ref, ("areas_head", "abs_error"),
                 WALK_TOL if walker else AREA_REL)   # areas are <= 1
    assert got["abs_error"] < 1e-3
    if walker:
        # the walk ran: the kernels' plain segments did part of the work
        assert got["walker_fraction"] > 0.0


# the family engines across devices, at --n-devices 4: gloo ranks on the
# CPU in the port, 4 of the reference's 8 host devices
SHARDED = {
    "sharded_bag": ["family", "--engine", "sharded-bag", "--m", "4",
                    "--eps", "1e-5", "--chunk", "512", "--capacity",
                    "32768", "-a", "1e-2"],
    "sharded_walker": ["family", "--engine", "sharded-walker", "--m", "8",
                       "--eps", "1e-7", "-a", "1e-2", "--chunk", "1024",
                       "--capacity", "65536", "--refill-slots", "8"],
    "sharded_walker_dd": ["family", "--engine", "sharded-walker-dd",
                          "--m", "8", "--eps", "1e-7", "-a", "1e-2",
                          "--chunk", "1024", "--capacity", "65536"],
}


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_family_engines_match_reference(name):
    got, ref = _both(SHARDED[name] + ["--n-devices", "4", "--json"])
    walker = "walker" in name
    _assert_same(got, ref, ("areas_head", "abs_error"),
                 WALK_TOL if walker else AREA_REL)
    assert len(got["tasks_per_chip"]) == 4 and min(got["tasks_per_chip"]) > 0
    assert got["abs_error"] < 1e-3
    if walker:
        assert got["walker_fraction"] > 0.0


def test_family_table_matches_reference():
    argv = FAMILY["bag"]
    rc, out = _run(CLI, argv + ["--device", "cpu"])
    rrc, rout = _run(RCLI, argv)
    assert rc == rrc == 0
    lines, rlines = out.splitlines(), rout.splitlines()
    # the areas and the error print rounded: equal; the last line has the
    # wall
    assert lines[:-1] == rlines[:-1]
    assert lines[-1].split(",")[0] == rlines[-1].split(",")[0]


def test_family_watchdog_hang_resumes_from_checkpoint(tmp_path,
                                                      monkeypatch):
    """A checkpointed family run whose first attempt hangs times out
    under ``--watchdog``, resumes from the leg snapshot and prints the
    uninterrupted run's result."""
    from ppls_tpu_torch.models.integrands import get_family
    from ppls_tpu_torch.parallel.bag_engine import integrate_family

    theta = np.linspace(1.0, 2.0, 4, endpoint=False)
    kw = dict(chunk=1 << 8, capacity=1 << 14, device="cpu")
    f = get_family("sin_recip_scaled")
    base = integrate_family(f, theta, (1e-2, 1.0), 1e-6, **kw)
    path = str(tmp_path / "cli.ckpt")
    with pytest.raises(RuntimeError, match="simulated crash"):
        integrate_family(f, theta, (1e-2, 1.0), 1e-6, checkpoint_path=path,
                         checkpoint_every=2, _crash_after_legs=1, **kw)
    assert os.path.exists(path)
    monkeypatch.setenv("PPLS_CLI_INJECT_HANG", "1")
    rc, out = _run(CLI, [
        "family", "--family", "sin_recip_scaled", "--engine", "bag",
        "--m", "4", "-a", "1e-2", "-b", "1.0", "--eps", "1e-6",
        "--chunk", str(1 << 8), "--capacity", str(1 << 14),
        "--checkpoint", path, "--watchdog", "4", "--json",
        "--device", "cpu"])
    assert rc == 0
    assert "PPLS_CLI_INJECT_HANG" not in os.environ
    res = json.loads(out.strip().splitlines()[-1])
    assert res["areas_head"] == [float(v) for v in base.areas]
    assert res["tasks"] == base.metrics.tasks
    assert not os.path.exists(path)         # a finished run clears it


# ---------------------------------------------------------------------------
# serve --spillover
# ---------------------------------------------------------------------------

SPILL_SERVE = ["serve", "--family", "quad_scaled", "--eps", "1e-9",
               "-a", "0", "-b", "1", "--theta0", "0.75", "--theta1", "3",
               "--synthetic", "8", "--arrival-rate", "8", "--seed", "3",
               "--slots", "4", "--chunk", "1024", "--capacity", "65536",
               "--lanes", "256", "--refill-slots", "2", "--f64-rounds", "2",
               "--queue-limit", "2", "--spillover", "--spillover-limit", "1"]


def _ledger(text):
    recs = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    body = {(r["rid"], bool(r.get("shed"))):
            {k: v for k, v in r.items() if k != "latency_s"}
            for r in recs if "rid" in r}
    return body, recs[-1]


def _summary(s):
    out = {k: v for k, v in s.items()
           if k not in ("wall_s", "requests_per_sec")}
    out["latency"] = {k: v for k, v in s["latency"].items()
                      if k.endswith("_phases")}
    return out


def test_serve_spillover_matches_reference_and_resumes(tmp_path):
    rc, out = _run(CLI, SPILL_SERVE + ["--device", "cpu"])
    rrc, rout = _run(RCLI, SPILL_SERVE)
    assert rc == rrc == 0
    got, g_sum = _ledger(out)
    ref, r_sum = _ledger(rout)
    assert got == ref
    assert _summary(g_sum) == _summary(r_sum)
    spilled = [r for r in got.values() if r.get("spillover")]
    assert spilled and g_sum["spillover"]["spillover_completed"] \
        == len(spilled)
    assert g_sum["spillover"]["spillover_tasks"] > 0
    # killed by an injected crash with spillover work queued, recovered
    # from the snapshot by the supervisor: the same ledger
    path = str(tmp_path / "s.ckpt")
    rc, out = _run(CLI, SPILL_SERVE + [
        "--device", "cpu", "--checkpoint", path, "--checkpoint-every", "1",
        "--fault-plan", '[{"kind": "crash", "at": 2}]'])
    again, a_sum = _ledger(out)
    assert rc == 0 and a_sum["recoveries"]
    assert again == got
    assert a_sum["spillover"] == g_sum["spillover"]


# ---------------------------------------------------------------------------
# --trace
# ---------------------------------------------------------------------------

class _Recorder:
    """Stand-in for ``torch.profiler.profile``: records entry, exit and
    the export path."""

    def __init__(self):
        self.active = 0
        self.exported = []

    def __call__(self, activities=None):
        rec = self

        class _Prof:
            def __enter__(self):
                rec.active += 1
                return self

            def __exit__(self, *a):
                rec.active -= 1

            def export_chrome_trace(self, path):
                rec.exported.append(path)

        return _Prof()


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.profiler, "profile", rec)
    return rec


def test_trace_none_is_noop(recorder):
    with tracing.trace(None):
        pass
    with tracing.trace(""):
        pass
    assert recorder.exported == []


def test_trace_creates_directory_and_wraps(tmp_path, recorder):
    d = str(tmp_path / "deep" / "trace-out")
    with tracing.trace(d):
        assert os.path.isdir(d) and recorder.active == 1
    assert recorder.active == 0
    assert recorder.exported == [os.path.join(d, tracing.TRACE_FILE)]
    with tracing.annotate("span"):
        pass


def test_cli_trace_wraps_the_run(tmp_path, recorder, capsys):
    d = str(tmp_path / "cli-trace")
    assert CLI.main(["--trace", d, "--eps", "1e-1", "--max-rounds", "64",
                     "--device", "cpu"]) == 0
    assert recorder.exported == [os.path.join(d, tracing.TRACE_FILE)]
    assert "Area=" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--json"],
    ["serve", "--synthetic", "2", "--slots", "2", "--chunk", "512",
     "--capacity", "65536", "--lanes", "256", "--refill-slots", "2",
     "--eps", "1e-5", "-a", "1e-2", "-b", "1.0"],
])
def test_trace_real_capture(tmp_path, argv):
    """A real ``torch.profiler`` capture on the CPU: a Chrome trace
    whose events include the engine's PyTorch operators."""
    d = str(tmp_path / "real")
    rc, _ = _run(CLI, ["--trace", d, "--device", "cpu"] + argv)
    assert rc == 0
    with open(os.path.join(d, tracing.TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


# ---------------------------------------------------------------------------
# refusals and the device
# ---------------------------------------------------------------------------

ACROSS = {
    "sharded": ["--engine", "sharded", "--n-devices", "2"],
    "2d": ["2d", "--n-devices", "2"],
    "qmc": ["qmc", "--n-devices", "2", "--n", "65536", "--genz",
            "gaussian", "--json"],
}


@pytest.fixture(scope="module")
def across():
    """The three commands in one spawned world of 2 gloo ranks."""
    import torch_mesh_jobs as J
    calls = [(J.cli_output, (argv + ["--device", "cpu"],), {})
             for argv in ACROSS.values()]
    return dict(zip(ACROSS, launch(run_calls, 2, "cpu", (calls,),
                                   timeout=600)))


@pytest.mark.parametrize("name", list(ACROSS))
def test_sharded_engines_and_modes_run(name, across):
    rc, out = across[name]
    assert rc == 0
    if name == "sharded":
        assert out.startswith("Area=7583461.801486\n")
        assert "Tasks Per Chip\n0\t1\n3284\t3283\n" in out
        assert "Tasks: 6567 (3283 splits, 3284 leaves) in 15 rounds" in out
    elif name == "2d":
        assert "Cells: 213 (53 splits) in 7 rounds, depth 6" in out
    else:
        _, one = _run(CLI, ACROSS["qmc"][:1] + ACROSS["qmc"][3:]
                      + ["--device", "cpu"])
        got = json.loads(out.strip().splitlines()[-1])["families"]
        want = json.loads(one.strip().splitlines()[-1])["families"]
        assert abs(got["gaussian"]["value"] - want["gaussian"]["value"]) \
            <= 1e-12 * abs(want["gaussian"]["value"])


def test_theta_block_needs_the_walker():
    with pytest.raises(SystemExit, match="requires the walker"):
        CLI.main(["family", "--theta-block", "2", "--device", "cpu"])


@pytest.mark.parametrize("argv", [[], ["family"], ["--engine", "device"],
                                  ["family", "--engine", "walker"]])
def test_without_a_card_the_commands_exit_before_running(argv, monkeypatch,
                                                         capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit) as ei:
            CLI.main(argv + extra)
        assert "CUDA is not available" in str(ei.value.code)
    assert capsys.readouterr().out == ""
