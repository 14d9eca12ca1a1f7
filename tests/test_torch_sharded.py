"""The port's single-integral wavefront across devices
(``ppls_tpu_torch/parallel/sharded.py``) against the reference's
``sharded_integrate``, on the CPU, at tests/test_sharded.py's shapes (the
reference problem at capacity 2^14; runge by Simpson at eps 1e-10;
capacity 128 to overflow).

Every port call of a world size runs in one spawned gloo world (2 ranks,
and 4 for the histogram and a second kill-and-resume); the reference
runs on 2 and 4 of its host devices. Both are float64 throughout, so
tasks, splits, rounds and ``tasks_per_chip`` are equal at the same world
size and the areas within 1e-12 relative (per-round leaf sums are
``torch.sum`` against XLA's, and torch's ``cosh`` differs from XLA's by a
few ulps). The area prints 7583461.801486 at every world size;
kill-and-resume is bit-equal to the uninterrupted run; a snapshot of
another run is refused; the root command's ``--engine sharded --json``
equals the in-process call.
"""

import json
import os

import numpy as np
import pytest

from ppls_tpu import sharded_integrate as ref_sharded
from ppls_tpu.config import REFERENCE_CONFIG as REF_CONFIG
from ppls_tpu.config import QuadConfig as RefConfig
from ppls_tpu.config import Rule as RefRule
from ppls_tpu.parallel.mesh import make_mesh
from ppls_tpu_torch.config import REFERENCE_CONFIG, QuadConfig, Rule
from ppls_tpu_torch.parallel.mesh import launch, run_calls
from ppls_tpu_torch.parallel.sharded import resume_sharded, sharded_integrate

import torch_mesh_jobs as J

GOLDEN = "7583461.801486"
AREA_REL = 1e-12
CFG = REFERENCE_CONFIG.replace(capacity=1 << 14)
DEEP = QuadConfig(integrand="runge", a=-1.0, b=1.0, eps=1e-10,
                  rule=Rule.SIMPSON, capacity=1 << 14, max_rounds=64)
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every port call, one spawned world per world size."""
    d = tmp_path_factory.mktemp("sharded")
    out = {}
    for n in WORLDS:
        p = {k: str(d / f"{k}{n}.ckpt") for k in ("resume", "ident")}
        kw = dict(n_devices=n, device="cpu")
        crash = dict(kw, checkpoint_every=4, _crash_after_legs=2)
        calls = {
            "base": (sharded_integrate, (CFG,), kw),
            "crash": (sharded_integrate, (CFG,),
                      dict(crash, checkpoint_path=p["resume"])),
            "resume": (resume_sharded, (p["resume"], CFG),
                       dict(kw, checkpoint_every=4)),
        }
        if n == 2:
            calls.update({
                "deep": (sharded_integrate, (DEEP,), kw),
                "overflow": (sharded_integrate,
                             (REFERENCE_CONFIG.replace(capacity=128),), kw),
                "crash_ident": (sharded_integrate, (CFG,),
                                dict(crash, _crash_after_legs=1,
                                     checkpoint_path=p["ident"])),
                "wrong_eps": (resume_sharded,
                              (p["ident"], CFG.replace(eps=1e-4)), kw),
                "cli": (J.cli_output, (["--engine", "sharded", "--json",
                                        "--capacity", str(CFG.capacity),
                                        "--n-devices", "2", "--device",
                                        "cpu"],), {}),
            })
        got = launch(run_calls, n, "cpu", (list(calls.values()),),
                     timeout=600)
        out[n] = dict(zip(calls, got)), p
    out[1] = sharded_integrate(CFG, n_devices=1, device="cpu")
    return out


@pytest.fixture(scope="module")
def ref():
    return {n: ref_sharded(REF_CONFIG.replace(capacity=1 << 14),
                           mesh=make_mesh(n)) for n in WORLDS}


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_golden_area_and_reference_counts(port, ref, n):
    got, want = port[n][0]["base"], ref[n]
    assert f"{got.area:.6f}" == GOLDEN
    for k in ("tasks", "splits", "leaves", "rounds", "max_depth",
              "integrand_evals", "n_chips", "tasks_per_chip"):
        assert getattr(got.metrics, k) == getattr(want.metrics, k), k
    assert got.metrics.tasks == 6567 and got.metrics.rounds == 15
    assert abs(got.area - want.area) <= AREA_REL * abs(want.area)
    assert got.exact == pytest.approx(want.exact, rel=1e-15)
    # one deal per round: a header gather, a data gather (none in the last
    # round, which deals no children) and a rank read; two sums a leg
    calls = got.mesh["collective_calls"]
    assert calls["rank"] == got.metrics.rounds
    assert calls["gather"] == 2 * got.metrics.rounds - 1 + 2
    assert calls["sum"] == 2
    assert got.mesh["world"] == n and got.mesh["backend"] == "gloo"


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_tasks_histogram_balanced(port, n):
    counts = port[n][0]["base"].metrics.tasks_per_chip
    assert len(counts) == n and sum(counts) == 6567
    assert max(counts) <= 2 * max(min(counts), 1)


def test_sharded_matches_mesh_sizes(port):
    areas = [port[1].area] + [port[n][0]["base"].area for n in WORLDS]
    for a in areas:
        assert abs(a - areas[0]) <= AREA_REL * abs(areas[0])
        assert f"{a:.6f}" == GOLDEN
    assert port[1].metrics.tasks_per_chip == [6567]


def test_sharded_deep_simpson(port):
    got = port[2][0]["deep"]
    want = ref_sharded(RefConfig(integrand="runge", a=-1.0, b=1.0,
                                 eps=1e-10, rule=RefRule.SIMPSON,
                                 capacity=1 << 14, max_rounds=64),
                       mesh=make_mesh(2))
    assert got.global_error < 1e-8
    assert got.metrics.tasks_per_chip == want.metrics.tasks_per_chip
    assert got.metrics.rounds == want.metrics.rounds
    assert abs(got.area - want.area) <= AREA_REL * abs(want.area)


def test_sharded_overflow_raises(port):
    err = port[2][0]["overflow"]
    assert isinstance(err, RuntimeError)
    assert "overflow" in str(err)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_kill_and_resume_bit_identical(port, n):
    outs, paths = port[n]
    assert isinstance(outs["crash"], RuntimeError)
    assert "simulated crash after 2 legs" in str(outs["crash"])
    res, base = outs["resume"], outs["base"]
    assert res.area == base.area                       # bit for bit
    assert res.metrics.tasks == base.metrics.tasks
    assert res.metrics.rounds == base.metrics.rounds
    assert res.metrics.tasks_per_chip == base.metrics.tasks_per_chip
    assert not os.path.exists(paths["resume"])


def test_sharded_resume_rejects_mismatched_identity(port):
    outs, _ = port[2]
    assert isinstance(outs["crash_ident"], RuntimeError)
    assert isinstance(outs["wrong_eps"], ValueError)
    assert "different run" in str(outs["wrong_eps"])


def test_cli_engine_sharded_equals_in_process(port):
    rc, out = port[2][0]["cli"]
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    base = port[2][0]["base"]
    assert rec["area"] == base.area
    assert rec["tasks_per_chip"] == base.metrics.tasks_per_chip
    for k in ("tasks", "splits", "leaves", "rounds", "max_depth",
              "integrand_evals"):
        assert rec[k] == getattr(base.metrics, k), k
    assert rec["global_error"] == base.global_error
    assert np.isfinite(rec["evals_per_sec_per_chip"])
