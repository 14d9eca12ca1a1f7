"""Checkpoint and kill-and-resume of the port (``ppls_tpu_torch``)
against the reference, on the CPU, at the reference tests' sizes
(tests/test_device_checkpoint.py: 4 thetas of sin(theta / x) on
[1e-2, 1], eps 1e-7; the bag at chunk 2^8, the walker at 256 lanes with
one segment of 8 steps per cycle, so there are cycle boundaries to
snapshot at).

* The container (``runtime/checkpoint.py``): a round trip, truncation,
  bit flips and missing files, format version and checksums, the
  identity refusal, ``mesh_resize``, the chaos lane and the background
  writer, as tests/test_faults.py holds the reference's; a snapshot that
  either package writes, the other loads to equal meta and arrays.
* The bag: kill-and-resume bit-identical, a checkpointed run equal to the
  plain one, a finished run clears its snapshot, a mismatched eps is
  refused, and the snapshot equal to the reference's at the same leg.
* The walker: kill-and-resume bit-identical in both refill modes, with
  scouting and double-buffered banks, and in theta mode; a snapshot of
  one schedule mode refused by another; the snapshot equal to the
  reference's at the same leg (identity, integer totals, bag columns;
  ``acc`` within 3e-9, the reference's interpret mode degrading its ds
  arithmetic); each package resuming the other's snapshot to within
  3e-9 of the reference's uninterrupted areas, with equal tasks.
Kill-and-resume through K1 and K2 on the card is in
tests/test_torch_kernel_host.py (``cuda`` marker), which imports no JAX.
"""

import json
import os
import threading

import numpy as np
import pytest

from ppls_tpu.models.integrands import get_family as ref_family
from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
from ppls_tpu.parallel.bag_engine import integrate_family as ref_bag
from ppls_tpu.parallel.walker import integrate_family_walker as ref_walker
from ppls_tpu.parallel.walker import resume_family_walker as ref_resume
from ppls_tpu.runtime import checkpoint as RC
from ppls_tpu_torch.models.integrands import get_family, get_family_ds
from ppls_tpu_torch.parallel.bag_engine import integrate_family, resume_family
from ppls_tpu_torch.parallel.walker import (integrate_family_walker,
                                            resume_family_walker)
from ppls_tpu_torch.runtime import checkpoint as TC

FAM = "sin_recip_scaled"
F, F_DS = get_family(FAM), get_family_ds(FAM)
THETA = 1.0 + np.arange(4) / 4.0
BOUNDS = (1e-2, 1.0)
EPS = 1e-7
BAG_KW = dict(chunk=1 << 8, capacity=1 << 16)
WALK_KW = dict(capacity=1 << 16, lanes=256, roots_per_lane=1,
               seg_iters=8, max_segments=1, max_cycles=256,
               min_active_frac=0.05)
IDENT = {"engine": "walker", "fname": "f", "eps": 1e-7}
# the walker's schedule modes: (family, theta, bounds, eps, keywords);
# theta mode at tests/test_theta_walker.py's configuration with three
# slots, whose breed overshoots one deal, so the run takes two cycles
MODES = {
    "boundary-refill": (FAM, THETA, BOUNDS, EPS, WALK_KW),
    "in-kernel-refill": (FAM, THETA, BOUNDS, EPS,
                         dict(WALK_KW, refill_slots=1)),
    "scout-double-buffer": (FAM, THETA, BOUNDS, EPS, dict(
        WALK_KW, roots_per_lane=2, refill_slots=2, scout_dtype="f32",
        double_buffer=True)),
    "theta-block": ("sin_scaled", np.linspace(1.0, 4.0, 24).reshape(3, 8),
                    (0.0, 1.0), 1e-6, dict(
                        capacity=1 << 16, lanes=256, roots_per_lane=2,
                        refill_slots=2, seg_iters=2048,
                        min_active_frac=0.05, theta_block=8)),
}


def _write(path, save=TC.save_family_checkpoint, **kw):
    save(path, identity=IDENT,
         bag_cols={"l": np.linspace(0, 1, 64),
                   "meta": np.arange(64, dtype=np.int32)},
         count=64, acc=np.array([1.5, 2.5]), totals={"tasks": 3}, **kw)


def _meta(path):
    with np.load(path) as z:
        return (json.loads(bytes(z["meta"]).decode()),
                {k: np.asarray(z[k]) for k in z.files if k != "meta"})


def _crash(fn, *args, **kw):
    with pytest.raises(RuntimeError, match="simulated crash"):
        fn(*args, **kw)


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------


def test_container_round_trip(tmp_path):
    path = str(tmp_path / "r.ckpt")
    _write(path)
    cols, count, acc, totals = TC.load_family_checkpoint(path, IDENT)
    assert count == 64 and totals == {"tasks": 3}
    assert np.array_equal(acc, [1.5, 2.5]) and acc.dtype == np.float64
    assert np.array_equal(cols["l"], np.linspace(0, 1, 64))
    assert cols["meta"].dtype == np.int32
    assert TC.peek_checkpoint_identity(path) == IDENT


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_damaged_container_is_refused_with_its_path(tmp_path, damage):
    path = str(tmp_path / "d.ckpt")
    _write(path)
    data = bytearray(open(path, "rb").read())
    if damage == "truncate":
        data = data[:len(data) // 2]
    else:
        data[len(data) // 2] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(data))
    with pytest.raises(TC.CheckpointCorruptError, match="corrupt") as ei:
        TC.load_family_checkpoint(path, IDENT)
    assert ei.value.path == path


def test_missing_snapshot_is_not_reported_corrupt(tmp_path):
    missing = str(tmp_path / "never_written.ckpt")
    with pytest.raises(FileNotFoundError):
        TC.load_family_checkpoint(missing, IDENT)
    with pytest.raises(FileNotFoundError):
        TC.peek_checkpoint_identity(missing)


def test_format_version_checksums_and_identity(tmp_path):
    path = str(tmp_path / "v.ckpt")
    _write(path)
    meta, _ = _meta(path)
    assert meta["format_version"] == TC.CKPT_FORMAT_VERSION == 1
    assert set(meta["checksums"]) == {"acc", "bag_l", "bag_meta"}
    # a mismatched identity is the different-run refusal, not corruption
    with pytest.raises(ValueError, match="different run") as ei:
        TC.load_family_checkpoint(path, dict(IDENT, eps=1e-6))
    assert not isinstance(ei.value, TC.CheckpointCorruptError)
    # mesh_resize admits a different n_dev and nothing else
    TC.save_family_checkpoint(
        path, identity=dict(IDENT, n_dev=8), bag_cols={}, count=0,
        acc=np.zeros(1), totals={})
    TC.load_family_checkpoint(path, dict(IDENT, n_dev=4), mesh_resize=True)
    with pytest.raises(ValueError, match="different run"):
        TC.load_family_checkpoint(path, dict(IDENT, n_dev=4))
    with pytest.raises(ValueError, match="different run"):
        TC.load_family_checkpoint(path, dict(IDENT, n_dev=4, eps=1.0),
                                  mesh_resize=True)


def test_chaos_lane_verifies_on_write(tmp_path, monkeypatch):
    monkeypatch.setenv("PPLS_CHAOS", "1")
    called = []
    real = TC._verify_payload
    monkeypatch.setattr(TC, "_verify_payload",
                        lambda *a: called.append(a[0]) or real(*a))
    path = str(tmp_path / "c.ckpt")
    _write(path)
    assert called == [path]


def test_background_writer_order_flush_and_errors(tmp_path):
    w = TC.CheckpointWriter()
    gate, order = threading.Event(), []
    w.submit(lambda: (gate.wait(5), order.append(1)))
    w.submit(lambda: order.append(2))
    path = str(tmp_path / "bg.ckpt")
    _write(path, writer=w)
    assert not os.path.exists(path)        # queued behind the gate
    gate.set()
    w.flush()
    assert order == [1, 2] and os.path.exists(path)
    # a failed job surfaces at the next submit, or at the next flush
    w.submit(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="background checkpoint") as ei:
        w.flush()
    assert isinstance(ei.value.__cause__, ZeroDivisionError)
    w.submit(lambda: 1 / 0)
    with w._cv:                             # wait for the job to fail
        assert w._cv.wait_for(lambda: not w._q and not w._busy, timeout=10)
    with pytest.raises(RuntimeError, match="background checkpoint"):
        w.submit(lambda: None)
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(lambda: None)
    # the process-wide writer: one instance, drained by every read
    assert TC.background_writer() is TC.background_writer()
    _write(path, writer=TC.background_writer())
    assert TC.load_family_checkpoint(path, IDENT)[1] == 64


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_container_crosses_packages(tmp_path, direction):
    save, load = ((RC.save_family_checkpoint, TC.load_family_checkpoint)
                  if direction == "reference-to-port" else
                  (TC.save_family_checkpoint, RC.load_family_checkpoint))
    path = str(tmp_path / "x.ckpt")
    _write(path, save=save)
    cols, count, acc, totals = load(path, IDENT)
    assert count == 64 and totals == {"tasks": 3}
    assert np.array_equal(acc, [1.5, 2.5])
    assert np.array_equal(cols["meta"], np.arange(64, dtype=np.int32))
    # the bytes each package writes for the same snapshot are the same
    other = str(tmp_path / "y.ckpt")
    _write(other, save=(TC.save_family_checkpoint
                        if save is RC.save_family_checkpoint
                        else RC.save_family_checkpoint))
    (m1, a1), (m2, a2) = _meta(path), _meta(other)
    assert m1 == m2
    assert all(np.array_equal(a1[k], a2[k]) and a1[k].dtype == a2[k].dtype
               for k in a1)


# ---------------------------------------------------------------------------
# the bag
# ---------------------------------------------------------------------------


def _bag(**kw):
    return integrate_family(F, THETA, BOUNDS, EPS, device="cpu",
                            **BAG_KW, **kw)


@pytest.fixture(scope="module")
def bag_base():
    return _bag()


def test_bag_kill_and_resume_bit_identical(tmp_path, bag_base):
    path = str(tmp_path / "bag.ckpt")
    _crash(_bag, checkpoint_path=path, checkpoint_every=8,
           _crash_after_legs=2)
    res = resume_family(path, F, THETA, BOUNDS, EPS, device="cpu",
                        checkpoint_every=8, **BAG_KW)
    assert np.array_equal(res.areas, bag_base.areas)
    assert (res.metrics.tasks, res.metrics.splits, res.metrics.max_depth,
            res.metrics.rounds) == (
        bag_base.metrics.tasks, bag_base.metrics.splits,
        bag_base.metrics.max_depth, bag_base.metrics.rounds)
    assert not os.path.exists(path)


def test_bag_checkpointed_uninterrupted_matches(tmp_path, bag_base):
    res = _bag(checkpoint_path=str(tmp_path / "c.ckpt"), checkpoint_every=16)
    assert np.array_equal(res.areas, bag_base.areas)
    assert res.metrics.tasks == bag_base.metrics.tasks


def test_completed_run_clears_snapshot(tmp_path):
    path = str(tmp_path / "done.ckpt")
    assert _bag(checkpoint_path=path, checkpoint_every=8).metrics.tasks
    assert not os.path.exists(path)
    wpath = str(tmp_path / "done_w.ckpt")
    res = integrate_family_walker(F, F_DS, THETA, BOUNDS, EPS, device="cpu",
                                  checkpoint_path=wpath, checkpoint_every=2,
                                  **WALK_KW)
    assert res.metrics.tasks > 0 and not os.path.exists(wpath)


def test_bag_resume_rejects_mismatched_identity(tmp_path):
    path = str(tmp_path / "bag.ckpt")
    _crash(_bag, checkpoint_path=path, checkpoint_every=8,
           _crash_after_legs=1)
    with pytest.raises(ValueError, match="different run"):
        resume_family(path, F, THETA, BOUNDS, 1e-6, device="cpu", **BAG_KW)


def test_bag_snapshot_matches_reference_at_the_same_leg(tmp_path):
    paths = [str(tmp_path / f"{k}.ckpt") for k in ("ref", "port")]
    kw = dict(checkpoint_every=8, _crash_after_legs=2)
    _crash(ref_bag, ref_family(FAM), THETA, BOUNDS, EPS,
           checkpoint_path=paths[0], **BAG_KW, **kw)
    _crash(_bag, checkpoint_path=paths[1], **kw)
    (mr, ar), (mp, ap) = (_meta(p) for p in paths)
    assert mr["identity"] == mp["identity"]
    assert (mr["count"], mr["totals"]) == (mp["count"], mp["totals"])
    for k in ("bag_l", "bag_r", "bag_th", "bag_meta"):
        assert ap[k].dtype == ar[k].dtype and np.array_equal(ap[k], ar[k])
    assert np.max(np.abs(ap["acc"] - ar["acc"])) < 1e-13


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------


def _walk(mode, walker=integrate_family_walker, **over):
    fam, theta, bounds, eps, kw = MODES[mode]
    return walker(get_family(fam), get_family_ds(fam), theta, bounds, eps,
                  device="cpu", **dict(kw, **over))


def _same_run(a, b):
    assert np.array_equal(a.areas, b.areas)               # bit for bit
    assert (a.metrics.tasks, a.metrics.splits, a.cycles, a.kernel_steps,
            a.metrics.max_depth, a.metrics.integrand_evals) == (
        b.metrics.tasks, b.metrics.splits, b.cycles, b.kernel_steps,
        b.metrics.max_depth, b.metrics.integrand_evals)
    assert np.array_equal(a.waste, b.waste)


@pytest.mark.parametrize("mode", list(MODES))
def test_walker_kill_and_resume_bit_identical(tmp_path, mode):
    base = _walk(mode)
    legs = 1 if mode == "theta-block" else 2
    assert base.cycles > legs
    path = str(tmp_path / "w.ckpt")
    _same_run(_walk(mode, checkpoint_path=path, checkpoint_every=1), base)
    assert not os.path.exists(path)
    _crash(_walk, mode, checkpoint_path=path, checkpoint_every=1,
           _crash_after_legs=legs)
    res = _walk(mode, walker=lambda *a, **kw: resume_family_walker(
        path, *a, **kw), checkpoint_every=1)
    _same_run(res, base)
    assert not os.path.exists(path)
    # the resumed process reports its own segments and cycles
    assert len(res.cycle_stats) == base.cycles - legs
    assert not res.metrics.per_round


@pytest.mark.parametrize("taken,resumed", [
    (dict(scout_dtype="f32"), {}),
    ({}, dict(roots_per_lane=2, refill_slots=2, double_buffer=True)),
    ({}, dict(reduced=True)),
])
def test_walker_snapshot_refused_in_another_mode(tmp_path, taken, resumed):
    path = str(tmp_path / "m.ckpt")
    _crash(integrate_family_walker, F, F_DS, THETA, BOUNDS, EPS,
           device="cpu", checkpoint_path=path, _crash_after_legs=1,
           **dict(WALK_KW, **taken))
    kw = dict(WALK_KW, **resumed)
    f_ds = get_family_ds(FAM, reduced=kw.pop("reduced", False))
    with pytest.raises(ValueError, match="different run"):
        resume_family_walker(path, F, f_ds, THETA, BOUNDS, EPS,
                             device="cpu", **kw)


@pytest.fixture(scope="module")
def walker_pair(tmp_path_factory):
    """The reference's uninterrupted run, and each package's snapshot
    after 2 legs of 2 cycles (boundary refill)."""
    d = tmp_path_factory.mktemp("walker_pair")
    paths = {k: str(d / f"{k}.ckpt") for k in ("reference", "port")}
    rf, rd = ref_family(FAM), ref_family_ds(FAM)
    kw = dict(checkpoint_every=2, _crash_after_legs=2)
    base = ref_walker(rf, rd, THETA, BOUNDS, EPS, **WALK_KW)
    _crash(ref_walker, rf, rd, THETA, BOUNDS, EPS,
           checkpoint_path=paths["reference"], **WALK_KW, **kw)
    _crash(_walk, "boundary-refill", checkpoint_path=paths["port"], **kw)
    return base, paths


def test_walker_snapshot_matches_reference_at_the_same_leg(walker_pair):
    _, paths = walker_pair
    (mr, ar), (mp, ap) = _meta(paths["reference"]), _meta(paths["port"])
    assert mr["identity"] == mp["identity"]
    assert mr["count"] == mp["count"] and mr["totals"] == mp["totals"]
    assert set(mp["totals"]) == {
        "tasks", "splits", "btasks", "wtasks", "wsplits", "roots",
        "rounds", "segs", "wsteps", "srows", "max_depth", "cycles",
        "waste", "sevals", "cevals"}
    for k in ("bag_l", "bag_r", "bag_th", "bag_meta"):
        assert ap[k].dtype == ar[k].dtype and np.array_equal(ap[k], ar[k])
    assert ap["acc"].shape == ar["acc"].shape
    assert np.max(np.abs(ap["acc"] - ar["acc"])) < 3e-9


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_walker_resumes_across_packages(walker_pair, direction, tmp_path):
    base, paths = walker_pair
    path = str(tmp_path / "x.ckpt")
    if direction == "reference-to-port":
        with open(paths["reference"], "rb") as src, open(path, "wb") as dst:
            dst.write(src.read())
        res = resume_family_walker(path, F, F_DS, THETA, BOUNDS, EPS,
                                   device="cpu", checkpoint_every=2,
                                   **WALK_KW)
    else:
        with open(paths["port"], "rb") as src, open(path, "wb") as dst:
            dst.write(src.read())
        res = ref_resume(path, ref_family(FAM), ref_family_ds(FAM), THETA,
                         BOUNDS, EPS, checkpoint_every=2, **WALK_KW)
    assert res.metrics.tasks == base.metrics.tasks
    assert res.cycles == base.cycles
    assert np.max(np.abs(np.asarray(res.areas) - base.areas)) < 3e-9
    assert not os.path.exists(path)


def test_walker_resumes_a_snapshot_older_than_its_counters(walker_pair,
                                                          tmp_path):
    """A snapshot written before the device counters existed (no wsteps,
    srows, waste or scout counts) resumes with the reference's defaults:
    the same areas and tasks, the pre-resume kernel evals estimated."""
    base, paths = walker_pair
    cols, count, acc, totals = TC.load_family_checkpoint(
        paths["port"], TC.peek_checkpoint_identity(paths["port"]))
    old = {k: v for k, v in totals.items()
           if k not in ("wsteps", "srows", "waste", "sevals", "cevals")}
    path = str(tmp_path / "legacy.ckpt")
    TC.save_family_checkpoint(
        path, identity=TC.peek_checkpoint_identity(paths["port"]),
        bag_cols=cols, count=count, acc=acc, totals=old)
    res = resume_family_walker(path, F, F_DS, THETA, BOUNDS, EPS,
                               device="cpu", checkpoint_every=2, **WALK_KW)
    assert res.metrics.tasks == base.metrics.tasks
    assert np.max(np.abs(res.areas - base.areas)) < 3e-9
    assert res.evals_estimated

