"""The port's family bag across devices
(``ppls_tpu_torch/parallel/sharded_bag.py``) against the reference's
``integrate_family_sharded``, on the CPU, at tests/test_sharded_bag.py's
shapes (12 thetas of sin(theta / x) on [1e-2, 1], eps 1e-7, chunk 2^8,
capacity 2^15 per rank).

One spawned gloo world of 4 ranks runs every port call; the reference
runs at ``n_devices=4`` on its host devices. Both are float64 throughout,
so tasks, splits, rounds, depth and ``tasks_per_chip`` are equal and the
areas within 1e-12 (torch's and XLA's float64 sin differ in the last
ulps). Kill-and-resume is bit-equal to the uninterrupted run, a snapshot
of another run is refused, the reference resumes the port's snapshot
(the same container) to its own uninterrupted result, and an overflow
of the per-rank capacity raises.
"""

import numpy as np
import pytest

from ppls_tpu.parallel.sharded_bag import integrate_family_sharded as ref_run
from ppls_tpu.parallel.sharded_bag import resume_family_sharded as ref_resume
from ppls_tpu_torch.parallel.mesh import launch, run_calls
from ppls_tpu_torch.parallel.sharded_bag import (integrate_family_sharded,
                                                 resume_family_sharded)

FAM = "sin_recip_scaled"
THETA = 1.0 + np.arange(12) / 12.0
BOUNDS = (1e-2, 1.0)
EPS = 1e-7
KW = dict(chunk=1 << 8, capacity=1 << 15)
N = 4
AREA_TOL = 1e-12
ARGS = (FAM, THETA, BOUNDS, EPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_bag")
    paths = {k: str(d / f"{k}.ckpt") for k in ("resume", "ident", "ref")}
    kw = dict(KW, n_devices=N, device="cpu")
    crash = dict(kw, checkpoint_every=4, _crash_after_legs=2)
    calls = {
        "base": (integrate_family_sharded, ARGS, kw),
        "crash": (integrate_family_sharded, ARGS,
                  dict(crash, checkpoint_path=paths["resume"])),
        "resume": (resume_family_sharded, (paths["resume"], *ARGS),
                   dict(kw, checkpoint_every=4)),
        "crash_ident": (integrate_family_sharded, ARGS,
                        dict(crash, checkpoint_path=paths["ident"])),
        "wrong_eps": (resume_family_sharded,
                      (paths["ident"], FAM, THETA, BOUNDS, 1e-8), kw),
        "crash_ref": (integrate_family_sharded, ARGS,
                      dict(crash, checkpoint_path=paths["ref"])),
        "overflow": (integrate_family_sharded, (FAM, THETA, BOUNDS, 1e-9),
                     dict(kw, chunk=1 << 6, capacity=1 << 7)),
    }
    outs = launch(run_calls, N, "cpu", (list(calls.values()),), timeout=600)
    return dict(zip(calls, outs)), paths


@pytest.fixture(scope="module")
def ref_base():
    return ref_run(*ARGS, n_devices=N, **KW)


def test_sharded_bag_matches_reference(runs, ref_base):
    got = runs[0]["base"]
    ref = ref_base
    for k in ("tasks", "splits", "leaves", "rounds", "max_depth",
              "integrand_evals", "n_chips", "tasks_per_chip"):
        assert getattr(got.metrics, k) == getattr(ref.metrics, k), k
    assert np.max(np.abs(got.areas - ref.areas)) < AREA_TOL
    assert got.lane_efficiency == ref.lane_efficiency
    assert got.mesh["backend"] == "gloo" and got.mesh["world"] == N
    assert not got.mesh["host_staged"]
    # one deal per round: a header gather, a data gather, a rank read
    calls = got.mesh["collective_calls"]
    assert calls["rank"] == got.metrics.rounds


def test_sharded_bag_kill_and_resume_bit_identical(runs):
    outs, paths = runs
    assert isinstance(outs["crash"], RuntimeError)
    assert "simulated crash after 2 legs" in str(outs["crash"])
    res, base = outs["resume"], outs["base"]
    assert np.array_equal(res.areas, base.areas)
    assert res.metrics.tasks == base.metrics.tasks
    assert res.metrics.splits == base.metrics.splits
    assert res.metrics.tasks_per_chip == base.metrics.tasks_per_chip
    import os
    assert not os.path.exists(paths["resume"])


def test_sharded_bag_resume_rejects_mismatched_identity(runs):
    outs, _ = runs
    assert isinstance(outs["crash_ident"], RuntimeError)
    assert isinstance(outs["wrong_eps"], ValueError)
    assert "different run" in str(outs["wrong_eps"])


def test_reference_resumes_the_port_snapshot(runs, ref_base):
    outs, paths = runs
    assert isinstance(outs["crash_ref"], RuntimeError)
    res = ref_resume(paths["ref"], *ARGS, checkpoint_every=4, n_devices=N,
                     **KW)
    assert res.metrics.tasks_per_chip == ref_base.metrics.tasks_per_chip
    assert np.max(np.abs(res.areas - ref_base.areas)) < AREA_TOL


def test_sharded_bag_overflow_detected(runs):
    outs, _ = runs
    assert isinstance(outs["overflow"], RuntimeError)
    assert "overflow" in str(outs["overflow"])
