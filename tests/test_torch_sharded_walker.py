"""The port's demand-driven walker across devices
(``ppls_tpu_torch/parallel/sharded_walker.py``) against the reference's
``integrate_family_walker_dd``, on the CPU, at tests/test_sharded_walker.py's
shapes (sin(theta / x) on [1e-3, 1], eps 1e-9, chunk 2^8, capacity 2^16,
256 lanes, roots_per_lane 2, seg_iters 32, min_active_frac 0.05).

One spawned gloo world of 4 ranks runs every port call (the plain K1 and
K2 segments on every rank); the reference runs at ``n_devices=4`` on its
host devices, in a thread beside it, with the tuning table off on both
sides. Held, per run:

* the schedule: tasks, splits, cycles, kernel steps, ``collective_rounds``
  and ``tasks_per_chip`` equal to the reference's, in both refill modes on
  the one-deep-family workload, with Simpson, with scouting and the double
  buffer, and with ``theta_block`` = 8 (tests/test_theta_walker.py's dd
  configuration); the refill mode's collective rounds per cycle strictly
  below the legacy mode's;
* the areas: within 1e-12 of the reference float64 bag, whose tasks the
  port's equal. Against the reference's areas only at the reference's own
  contract with the bag (1e-9; 3e-9 in theta mode, as
  tests/test_torch_theta_walker.py): its ds walk runs in interpret mode
  through XLA on the CPU, which contracts the kernel's float32
  multiply-adds (tests/test_torch_walk_segment.py), and lands 1e-11 to
  1e-9 off the bag at these shapes where the port lands below 1e-14;
* kill-and-resume bit-equal in both modes; a snapshot of 4 ranks resumed
  on 2 with ``mesh_resize`` equal to the reference's resume of the same
  snapshot; a snapshot of another eps, of the other mode or of another
  world size (without ``mesh_resize``) refused;
* the collective calls by kind: one rank read per collective round (a
  deal), one sum per cycle plus one per leg (recorded per run).
"""

import concurrent.futures
import shutil

import numpy as np
import pytest

from ppls_tpu.config import Rule as RRule
from ppls_tpu.models.integrands import get_family as ref_family
from ppls_tpu.parallel.bag_engine import integrate_family as ref_bag
from ppls_tpu.parallel.sharded_walker import (
    integrate_family_walker_dd as ref_dd,
    resume_family_walker_dd as ref_resume)
from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.parallel.mesh import launch, run_calls
from ppls_tpu_torch.parallel.sharded_walker import (
    build_dd_walker_run, integrate_family_walker_dd, resume_family_walker_dd)

FAM = "sin_recip_scaled"
BOUNDS = (1e-3, 1.0)
EPS = 1e-9
KW = dict(chunk=1 << 8, capacity=1 << 16, lanes=256, roots_per_lane=2,
          seg_iters=32, min_active_frac=0.05)
N = 4
TH4 = 1.0 + np.arange(4) / 4.0
# tests/test_theta_walker.py's dd configuration
T = 8
THETA_ARGS = ("sin_scaled", np.linspace(1.0, 4.0, T).reshape(1, T),
              (0.0, 1.0), 1e-6)
THETA_KW = dict(chunk=1 << 8, capacity=1 << 16, lanes=256,
                roots_per_lane=2, refill_slots=2, min_active_frac=0.05,
                theta_block=T)
BAG_TOL = 1e-12
REF_TOL = 1e-9
REF_TOL_THETA = 3e-9

# name -> (args, port kwargs, reference kwargs or None)
RUNS = {
    "legacy": ((FAM, [1.0], BOUNDS, EPS), KW, KW),
    "refill": ((FAM, [1.0], BOUNDS, EPS), dict(KW, refill_slots=2),
               dict(KW, refill_slots=2)),
    "simpson": ((FAM, TH4, BOUNDS, EPS), dict(KW, rule=Rule.SIMPSON),
                dict(KW, rule=RRule.SIMPSON)),
    "scout_db": ((FAM, [1.0], BOUNDS, EPS),
                 dict(KW, refill_slots=2, scout_dtype="f32",
                      double_buffer=True),
                 dict(KW, refill_slots=2, scout_dtype="f32",
                      double_buffer=True)),
    "theta": (THETA_ARGS, THETA_KW, THETA_KW),
    "refill2": ((FAM, [1.0, 1.5], BOUNDS, EPS), dict(KW, refill_slots=2),
                None),
}
SCHEDULE = ("tasks", "splits", "leaves", "max_depth", "n_chips",
            "tasks_per_chip")


@pytest.fixture(scope="module", autouse=True)
def _table_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


def _port_calls(paths):
    kw = dict(n_devices=N, device="cpu")
    calls = {name: (integrate_family_walker_dd, args, dict(pkw, **kw))
             for name, (args, pkw, _r) in RUNS.items()}
    one = (FAM, [1.0], BOUNDS, EPS)
    two = (FAM, [1.0, 1.5], BOUNDS, EPS)
    rf1, rf2 = dict(KW, refill_slots=2, **kw), dict(KW, refill_slots=2, **kw)
    leg = dict(KW, **kw)

    def crash(path, legs, base):
        return dict(base, checkpoint_path=path, checkpoint_every=1,
                    _crash_after_legs=legs)
    calls.update({
        "crash_refill": (integrate_family_walker_dd, two,
                         crash(paths["refill"], 2, rf2)),
        "resume_refill": (resume_family_walker_dd, (paths["refill"], *two),
                          dict(rf2, checkpoint_every=1)),
        "crash_legacy": (integrate_family_walker_dd, one,
                         crash(paths["legacy"], 2, leg)),
        "resume_legacy": (resume_family_walker_dd, (paths["legacy"], *one),
                          dict(leg, checkpoint_every=1)),
        "crash_resize": (integrate_family_walker_dd, one,
                         crash(paths["resize"], 2, rf1)),
        "crash_ident": (integrate_family_walker_dd, one,
                        crash(paths["ident"], 1, rf1)),
        "wrong_eps": (resume_family_walker_dd,
                      (paths["ident"], FAM, [1.0], BOUNDS, 1e-8), rf1),
        "wrong_mode": (resume_family_walker_dd, (paths["ident"], *one),
                       leg),
    })
    return calls


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port run (two launches: 4 ranks, then the resize onto 2) and
    the reference's, computed beside the first launch."""
    d = tmp_path_factory.mktemp("dd")
    paths = {k: str(d / f"{k}.ckpt")
             for k in ("refill", "legacy", "resize", "ident")}
    calls = _port_calls(paths)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(launch, run_calls, N, "cpu", (list(calls.values()),),
                        timeout=900)
        ref = {name: ref_dd(*args, n_devices=N, **rkw)
               for name, (args, _p, rkw) in RUNS.items() if rkw is not None}
        bags = {
            "one": ref_bag(ref_family(FAM), [1.0], BOUNDS, EPS,
                           chunk=1 << 10, capacity=1 << 17),
            "two": ref_bag(ref_family(FAM), [1.0, 1.5], BOUNDS, EPS,
                           chunk=1 << 10, capacity=1 << 17),
            "simpson": ref_bag(ref_family(FAM), TH4, BOUNDS, EPS,
                               rule=RRule.SIMPSON, chunk=1 << 10,
                               capacity=1 << 17)}
        port = dict(zip(calls, fut.result()))
    # the 4-rank snapshot onto 2 ranks, in both packages
    rkw = dict(KW, refill_slots=2)
    for k in ("strict", "ref"):
        shutil.copy(paths["resize"], paths["resize"] + "." + k)
    args = (FAM, [1.0], BOUNDS, EPS)
    two = launch(run_calls, 2, "cpu", ([
        (resume_family_walker_dd, (paths["resize"], *args),
         dict(rkw, mesh_resize=True, checkpoint_every=1, n_devices=2,
              device="cpu")),
        (resume_family_walker_dd, (paths["resize"] + ".strict", *args),
         dict(rkw, checkpoint_every=1, n_devices=2, device="cpu"))],),
        timeout=600)
    port["resized"], port["resize_refused"] = two
    ref["resized"] = ref_resume(paths["resize"] + ".ref", *args,
                                mesh_resize=True, checkpoint_every=1,
                                n_devices=2, **rkw)
    return port, ref, bags


def _same_schedule(got, ref):
    for k in SCHEDULE:
        assert getattr(got.metrics, k) == getattr(ref.metrics, k), k
    assert got.cycles == ref.cycles
    assert got.kernel_steps == ref.kernel_steps
    assert got.collective_rounds == ref.collective_rounds
    np.testing.assert_array_equal(got.waste_per_chip, ref.waste_per_chip)


@pytest.mark.parametrize("name", ["legacy", "refill", "simpson", "scout_db",
                                  "theta"])
def test_dd_matches_reference(runs, name, record_property):
    port, ref, bags = runs
    got, want = port[name], ref[name]
    _same_schedule(got, want)
    assert got.refill_slots == want.refill_slots
    assert got.attribution()["reconciles"]
    assert got.metrics.tasks == got.metrics.splits + got.metrics.leaves
    assert got.areas.shape == want.areas.shape
    tol = REF_TOL_THETA if name == "theta" else REF_TOL
    assert np.max(np.abs(got.areas - want.areas)) < tol
    bag = {"legacy": "one", "refill": "one", "scout_db": "one",
           "simpson": "simpson"}.get(name)
    if bag is not None and name != "scout_db":
        assert got.metrics.tasks == bags[bag].metrics.tasks
        assert np.max(np.abs(got.areas - bags[bag].areas)) < BAG_TOL
    calls = got.mesh["collective_calls"]
    record_property("collective_calls", calls)
    assert calls["rank"] == got.collective_rounds
    assert calls["sum"] == got.cycles + 1
    assert got.mesh["backend"] == "gloo" and not got.mesh["host_staged"]
    assert got.mesh["world"] == N and len(got.mesh["host_syncs"]) == N


def test_dd_one_deep_family_balances_with_fewer_collectives(runs):
    port, ref, _ = runs
    rf, leg = port["refill"], port["legacy"]
    assert max(leg.metrics.tasks_per_chip) \
        / min(leg.metrics.tasks_per_chip) < 2.0
    assert max(rf.metrics.tasks_per_chip) \
        / min(rf.metrics.tasks_per_chip) < 4.0
    assert rf.collective_rounds > 0 and leg.collective_rounds > 0
    assert rf.collective_rounds_per_cycle < leg.collective_rounds_per_cycle
    assert (ref["refill"].collective_rounds_per_cycle
            == rf.collective_rounds_per_cycle)


def test_dd_two_families_hold_the_float64_bag(runs):
    port, _, bags = runs
    got = port["refill2"]
    assert got.metrics.tasks == bags["two"].metrics.tasks
    assert np.max(np.abs(got.areas - bags["two"].areas)) < BAG_TOL


@pytest.mark.parametrize("mode", ["refill", "legacy"])
def test_dd_kill_and_resume_bit_identical(runs, mode):
    port, _, _ = runs
    assert isinstance(port[f"crash_{mode}"], RuntimeError)
    assert "simulated crash after 2 legs" in str(port[f"crash_{mode}"])
    base = port["refill2" if mode == "refill" else "legacy"]
    res = port[f"resume_{mode}"]
    assert np.array_equal(res.areas, base.areas)
    _same_schedule(res, base)


def test_dd_mesh_resize_matches_reference(runs):
    port, ref, bags = runs
    got, want = port["resized"], ref["resized"]
    assert got.metrics.n_chips == 2
    _same_schedule(got, want)
    assert np.max(np.abs(got.areas - want.areas)) < REF_TOL
    assert got.metrics.tasks == bags["one"].metrics.tasks
    assert np.max(np.abs(got.areas - bags["one"].areas)) < BAG_TOL


@pytest.mark.parametrize("name", ["wrong_eps", "wrong_mode",
                                  "resize_refused"])
def test_dd_resume_refuses_another_run(runs, name):
    port, _, _ = runs
    assert isinstance(port["crash_ident"], RuntimeError)
    assert isinstance(port[name], ValueError)
    assert "different run" in str(port[name])


def test_dd_stream_admission_is_refused():
    """The admit window (the walker-dd stream's phase body, once refused
    with ROADMAP Queue 1 item 7) builds; the reference's two refusals
    keep its words: one cycle per call, and the refill mode."""
    from ppls_tpu_torch.parallel.mesh import World
    args = (FAM, EPS, 256, 1 << 16, 1, 256, 32, 8, 0.05, 0.8, 0.5, 512)
    with pytest.raises(ValueError, match="max_cycles == 1"):
        build_dd_walker_run(None, *args, 2, 0.5, 1.0, refill_slots=2,
                            admit_window=64)
    with pytest.raises(ValueError, match="refill_slots > 0"):
        build_dd_walker_run(None, *args, 1, 0.5, 1.0, admit_window=64)
    with World(1, "cpu", lambda mesh: mesh) as world:
        run = build_dd_walker_run(world.mesh, *args, 1, 0.5, 1.0,
                                  refill_slots=2, admit_window=64)
        assert callable(run)
