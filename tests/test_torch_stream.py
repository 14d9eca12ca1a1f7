"""The streaming engine of the port (``ppls_tpu_torch.runtime.stream``)
against the reference's, on the CPU.

One phase is one walker cycle (``run_stream_cycle``): K1 with in-kernel
refill, K2 with ``refill_slots=0``, float64 bag rounds with
``f64_rounds``. Held here, at the reference tests' own sizes
(tests/test_stream.py, tests/test_multitenant.py,
tests/test_theta_walker.py):

* parity with the reference engine on tests/test_stream.py's
  configuration (6 requests of sin(theta / x) on [1e-2, 1], eps 1e-7,
  256 lanes, arrivals [0, 0, 1, 2, 3, 5]) for trapezoid, scouting with
  double-buffered banks, and boundary refill: each request's admit,
  retire and last-credited phases, every registry counter, and areas
  within 3e-9 (the walker contract; the reference's interpret mode
  degrades its ds arithmetic, see tests/test_torch_walker.py);
* the reference's own stream contracts held on the port: against the
  port's batch walker, arrival-schedule parity, float64-mode bit
  identity on a dyadic family, the boundary proxy against cold calls,
  submit-time validation;
* the overload policy through both engines on the same inputs: equal
  shed records and equal completed records;
* theta-batch requests (T = 8), pads dropped at retirement;
* the admit, cancel and live-count programs bit-equal to the
  reference's on numpy-seeded bag columns;
* the host-only obs copies: equal quantiles and exposition;
* kill-and-resume (tests/test_stream.py's own cases, synchronous and
  background writer) bit-identical to the run with no crash; the port's
  snapshot at a phase equal to the reference's (every totals key, the
  bag columns, the (acc, acc_c) pair within 3e-9), each package resuming
  the other's; ``client_state`` and the ``checkpoint_every`` cadence;
* every unported option refused with its ROADMAP item.

The reference resolves its cadence with the tuning table off, so both
engines use the hand-tuned tier.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu.models import integrands as RI
from ppls_tpu.obs.registry import MetricsRegistry as RefRegistry
from ppls_tpu.parallel import walker as RW
from ppls_tpu.parallel.bag_engine import BagState as RefBag
from ppls_tpu.runtime import stream as RS
from ppls_tpu_torch import interop
from ppls_tpu_torch.models import integrands as TI
from ppls_tpu_torch.obs.registry import PHASE_BUCKETS, MetricsRegistry
from ppls_tpu_torch.parallel import walker as TW
from ppls_tpu_torch.runtime import stream as TS

FAM = "sin_recip_scaled"
BOUNDS = (1e-2, 1.0)
EPS = 1e-7
# tests/test_stream.py's configuration
KW = dict(slots=8, chunk=1 << 10, capacity=1 << 16, lanes=256,
          roots_per_lane=2, refill_slots=2, seg_iters=32,
          min_active_frac=0.05)
WKW = dict(capacity=1 << 16, lanes=256, roots_per_lane=2,
           refill_slots=2, seg_iters=32, min_active_frac=0.05)
THETA = 1.0 + np.arange(6) / 6.0
REQS = [(float(t), BOUNDS) for t in THETA]
ARRIVALS = [0, 0, 1, 2, 3, 5]
MODES = {"trapezoid": {},
         "scout-double-buffer": dict(scout_dtype="f32", double_buffer=True),
         "boundary-refill": dict(refill_slots=0, roots_per_lane=1)}
# tests/test_multitenant.py's configuration
MT_EPS = 1e-6
MT_KW = dict(KW, slots=4)
# tests/test_theta_walker.py's stream configuration
T = 8
SKW = dict(slots=4, chunk=1 << 9, capacity=1 << 16, lanes=256,
           roots_per_lane=2, refill_slots=2, seg_iters=2048,
           min_active_frac=0.05)


# the reference bench's multihost leg (tools/bench_history.py:124-142):
# the single-engine run of the dyadic quad_scaled workload
MULTIHOST_EPS = 1e-9
MULTIHOST_WKW = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
                     roots_per_lane=2, refill_slots=2, seg_iters=32,
                     min_active_frac=0.05, f64_rounds=2)
MULTIHOST_THETA = [1.0 + i / 4.0 for i in range(8)]


@pytest.fixture
def quad_family():
    """The dyadic-exact quadratic family tests/test_stream.py registers
    for itself: theta x^2, in both packages as quad_scaled."""
    return "quad_scaled"


def _ref(*args, **kw):
    return RS.StreamEngine(*args, **kw)


def _port(*args, **kw):
    return TS.StreamEngine(*args, device="cpu", **kw)


def _phases(res):
    return {c.rid: (c.submit_phase, c.admit_phase, c.retire_phase,
                    c.last_credited_phase, c.first_seeded_phase)
            for c in res.completed}


def _records(done):
    return sorted((c.rid, c.failed, c.failure, c.submit_phase,
                   c.admit_phase, c.retire_phase, c.last_credited_phase)
                  for c in done)


def _sheds(sheds):
    return [dataclasses.astuple(s) for s in sheds]


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


@pytest.fixture(scope="module")
def parity_runs():
    """Both engines once per mode, on the arrival schedule."""
    out = {}
    for mode, over in MODES.items():
        kw = dict(KW, **over)
        r_eng = _ref(FAM, EPS, **kw)
        p_eng = _port(FAM, EPS, **kw)
        out[mode] = (r_eng, r_eng.run(REQS, arrival_phase=ARRIVALS),
                     p_eng, p_eng.run(REQS, arrival_phase=ARRIVALS))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_matches_reference_engine(parity_runs, mode):
    _, ref, _, got = parity_runs[mode]
    assert len(got.completed) == len(REQS)
    assert _phases(got) == _phases(ref)
    assert got.totals["tasks"] == ref.totals["tasks"]
    assert np.max(np.abs(got.areas - ref.areas)) < 3e-9
    assert got.phases == ref.phases
    assert np.array_equal(got.phase_stats, ref.phase_stats)
    # one read per phase on top of the cycle's own
    assert got.host_syncs == sum(got.host_syncs_per_phase)
    assert len(got.host_syncs_per_phase) == len(got.phase_stats)


@pytest.mark.parametrize("mode", list(MODES))
def test_registry_counters_match_reference(parity_runs, mode):
    r_eng, ref, p_eng, got = parity_runs[mode]
    names = [f"ppls_stream_{k}_total" for k in TS._COUNTER_STATS] + [
        "ppls_stream_admitted_total", "ppls_stream_retired_total",
        "ppls_stream_max_depth", "ppls_stream_phase",
        "ppls_stream_live_tasks_now"]
    rr, pr = r_eng.telemetry.registry, p_eng.telemetry.registry
    assert {n: pr.value(n) for n in names} == {n: rr.value(n)
                                               for n in names}
    assert got.totals == ref.totals
    assert p_eng._identity() == r_eng._identity()
    assert pr.value("ppls_tuning_resolution", tier="default") == 1.0
    assert got.latency_percentiles()["p50_phases"] \
        == ref.latency_percentiles()["p50_phases"]
    assert got.occupancy_summary(KW["lanes"]) \
        == ref.occupancy_summary(KW["lanes"])


def test_stream_matches_batch_walker():
    res = _port(FAM, EPS, **KW).run(REQS)
    b = TW.integrate_family_walker(TI.get_family(FAM), TI.get_family_ds(FAM),
                                   THETA, BOUNDS, EPS, device="cpu", **WKW)
    assert len(res.completed) == len(REQS)
    assert np.max(np.abs(res.areas - b.areas)) < 3e-9
    drift = abs(res.totals["tasks"] - b.metrics.tasks) / b.metrics.tasks
    assert drift < 0.02, (res.totals["tasks"], b.metrics.tasks)
    occ = res.occupancy_summary(KW["lanes"])
    assert occ["walker_fraction"] > 0.5, occ
    assert occ["attribution"]["reconciles"]
    for c in res.completed:
        assert c.retire_phase >= c.admit_phase >= c.submit_phase
        assert c.phases_in_flight >= 1
        assert c.last_credited_phase <= c.retire_phase


def test_stream_arrival_schedule_parity(parity_runs):
    r1 = _port(FAM, EPS, **KW).run(REQS)
    r2 = parity_runs["trapezoid"][3]
    assert np.max(np.abs(r1.areas - r2.areas)) < 3e-9
    assert len(r2.completed) == len(REQS)
    admits = {c.rid: c.admit_phase for c in r2.completed}
    assert admits[5] >= 5


def test_stream_f64_mode_bit_identity(quad_family):
    """One-batch admission against six arrival phases in the float64
    mode on a dyadic workload: bit-identical areas and equal tasks, and
    the reference's areas bit for bit."""
    kw = dict(KW, f64_rounds=4)
    theta = [1.0, 1.25, 1.5, 2.0, 0.75, 3.0]
    reqs = [(t, (0.0, 1.0)) for t in theta]
    arr = [0, 1, 2, 3, 5, 8]
    r1 = _port(quad_family, 1e-9, **kw).run(reqs)
    r2 = _port(quad_family, 1e-9, **kw).run(reqs, arrival_phase=arr)
    assert len(r1.completed) == len(r2.completed) == len(reqs)
    assert np.array_equal(r1.areas, r2.areas)
    assert r1.totals["tasks"] == r2.totals["tasks"]
    assert np.max(np.abs(r1.areas - np.asarray(theta) / 3.0)) < 1e-6
    ref = _ref(quad_family, 1e-9, **kw).run(reqs, arrival_phase=arr)
    assert np.array_equal(r2.areas, ref.areas)
    assert _phases(r2) == _phases(ref)
    assert r2.totals == ref.totals


def test_stream_f64_mode_theta_batches_match_reference():
    kw = dict(SKW, f64_rounds=4, theta_block=T)
    reqs = [((1.0, 1.5, 2.0), (0.0, 1.0)),
            (tuple(np.linspace(1.0, 4.0, T)), (0.0, 1.0))]
    got = _port("sin_scaled", 1e-6, **kw).run(reqs, arrival_phase=[0, 1])
    ref = _ref("sin_scaled", 1e-6, **kw).run(reqs, arrival_phase=[0, 1])
    assert _phases(got) == _phases(ref)
    assert got.totals == ref.totals
    for a, b in zip(sorted(got.completed, key=lambda c: c.rid),
                    sorted(ref.completed, key=lambda c: c.rid)):
        assert np.max(np.abs(np.subtract(a.areas, b.areas))) < 1e-13


def test_stream_beats_cold_calls_device_proxies():
    K = 8
    theta = 1.0 + np.arange(K) / K
    f, fds = TI.get_family(FAM), TI.get_family_ds(FAM)
    cold_boundaries = 0
    cold_areas = np.empty(K)
    for i, t in enumerate(theta):
        r1 = TW.integrate_family_walker(f, fds, [float(t)], BOUNDS, EPS,
                                        device="cpu", **WKW)
        cold_areas[i] = r1.areas[0]
        cold_boundaries += r1.metrics.rounds
    res = _port(FAM, EPS, **KW).run([(float(t), BOUNDS) for t in theta])
    stream_boundaries = int(res.totals["rounds"] + res.totals["segs"])
    assert np.max(np.abs(res.areas - cold_areas)) < 3e-9
    assert stream_boundaries > 0
    assert cold_boundaries / stream_boundaries >= 3.0, (
        cold_boundaries, stream_boundaries)


def test_explicit_cadence_is_published_as_the_reference_does():
    kw = dict(KW, exit_frac=0.9, suspend_frac=0.6)
    regs = [e.telemetry.registry
            for e in (_ref(FAM, EPS, **kw), _port(FAM, EPS, **kw))]
    for reg in regs:
        assert reg.value("ppls_tuning_resolution", tier="explicit") == 1.0
        assert reg.value("ppls_tuning_resolution", tier="default") == 0.0


def test_stream_request_validation():
    eng = _port(FAM, EPS, **KW)
    with pytest.raises(ValueError, match="Cody-Waite"):
        eng.submit(2.0, (1e-7, 1.0))
    assert eng.pending == 0 and eng.next_rid == 0
    with pytest.raises(ValueError, match="deadline_phases"):
        eng.submit(1.0, BOUNDS, deadline_phases=0)
    with pytest.raises(ValueError, match="tenant"):
        eng.submit(1.0, BOUNDS, tenant="")
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit([1.0, 1.5], BOUNDS)
    with pytest.raises(ValueError, match="rate must be > 0"):
        _port(FAM, EPS, tenant_quotas={"a": {"rate": 0}}, **KW)


# ---------------------------------------------------------------------------
# the overload policy, through both engines (tests/test_multitenant.py)
# ---------------------------------------------------------------------------


def _shed_policy(make):
    eng = make(FAM, MT_EPS, queue_limit=2, **MT_KW)
    sheds = []
    eng.on_shed = sheds.append
    eng.submit(1.0, BOUNDS, priority=0)
    eng.submit(1.1, BOUNDS, priority=0)
    eng.submit(1.2, BOUNDS, priority=0)     # equal class: itself shed
    eng.submit(1.3, BOUNDS, priority=2)     # displaces rid 0
    assert [s.rid for s in sheds] == [2, 0]
    assert eng.pending == 2 and eng.next_rid == 4
    assert eng.telemetry.registry.value(
        "ppls_requests_shed_total", tenant="default",
        reason="queue_full") == 2
    done = eng.drain()
    assert sorted(c.rid for c in done) == [1, 3]
    return eng


def _priority(make):
    eng = make(FAM, MT_EPS, **dict(MT_KW, slots=1, admit_window=1))
    eng.submit(1.0, BOUNDS, priority=0)
    eng.submit(1.1, BOUNDS, priority=0)
    eng.submit(1.2, BOUNDS, priority=2)
    eng.drain()
    admit = {c.rid: c.admit_phase for c in eng.completed}
    assert admit[2] < admit[0] < admit[1]
    return eng


def _token_bucket(make):
    eng = make(FAM, MT_EPS,
               tenant_quotas={"slow": {"rate": 1, "burst": 1}}, **MT_KW)
    for i in range(3):
        eng.submit(1.0 + i / 10, BOUNDS, tenant="slow")
    eng.submit(1.5, BOUNDS, tenant="fast")
    eng.drain()
    assert not eng.shed
    admit = {c.rid: c.admit_phase for c in eng.completed}
    assert admit[0] < admit[1] < admit[2]
    assert admit[3] == admit[0]
    return eng


def _unmeetable_deadline(make):
    eng = make(FAM, MT_EPS, **dict(MT_KW, slots=1, admit_window=1))
    eng.submit(1.0, BOUNDS)
    eng.submit(1.1, BOUNDS, deadline_phases=1)
    eng.drain()
    assert [(s.rid, s.reason) for s in eng.shed] == [
        (1, "deadline_exceeded")]
    assert [c.rid for c in eng.completed] == [0]
    return eng


def _deadline_expiry(make):
    solo = make(FAM, 1e-7, **MT_KW).run([(1.5, BOUNDS)]).completed[0].area
    eng = make(FAM, 1e-7, **MT_KW)
    eng.submit(1.0, BOUNDS, deadline_phases=2, tenant="impatient")
    eng.submit(1.9, BOUNDS)
    done = {c.rid: c for c in eng.drain()}
    assert done[0].failed and done[0].failure == "deadline_exceeded"
    assert not np.isfinite(done[0].area) and np.isfinite(done[1].area)
    reg = eng.telemetry.registry
    assert reg.value("ppls_stream_deadline_exceeded_total",
                     tenant="impatient") == 1
    assert reg.value("ppls_stream_quarantined_total") == 0
    # the cancelled slot computes a later request bit-equal to a solo run
    eng.submit(1.5, BOUNDS)
    assert eng.drain()[0].area == solo
    return eng


POLICIES = {"shed_lowest_priority_oldest": _shed_policy,
            "priority_admits_first": _priority,
            "token_bucket_paces_admission": _token_bucket,
            "unmeetable_deadline_is_shed": _unmeetable_deadline,
            "deadline_expiry_and_slot_reuse": _deadline_expiry}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_overload_policy_matches_reference(policy):
    got = POLICIES[policy](_port)
    ref = POLICIES[policy](_ref)
    assert _sheds(got.shed) == _sheds(ref.shed)
    assert _records(got.completed) == _records(ref.completed)
    ok = {c.rid: c.area for c in ref.completed if not c.failed}
    for c in got.completed:
        if not c.failed:
            assert abs(c.area - ok[c.rid]) < 3e-9
    assert got.result().tenant_summary() == ref.result().tenant_summary()
    assert got.result().class_latency_percentiles() \
        == ref.result().class_latency_percentiles()


def test_quarantine_retires_non_finite_area_as_failed():
    """A NaN theta slipped past validation poisons only its own slot:
    with quarantine on it retires failed ("nan") and its co-resident
    retires normally; with quarantine off the engine raises."""
    def poisoned(quarantine):
        eng = _port(FAM, MT_EPS, quarantine=quarantine, **MT_KW)
        eng.submit(1.0, BOUNDS)
        eng.submit(1.5, BOUNDS)
        eng._pending[0].theta = float("nan")
        return eng

    done = {c.rid: c for c in poisoned(True).drain()}
    assert done[0].failed and done[0].failure == "nan"
    assert not done[1].failed and np.isfinite(done[1].area)
    with pytest.raises(FloatingPointError, match="non-finite"):
        poisoned(False).drain()


# ---------------------------------------------------------------------------
# theta-batch requests (tests/test_theta_walker.py)
# ---------------------------------------------------------------------------


def _theta_batches(make):
    eng = make("sin_scaled", 1e-6, theta_block=T, **SKW)
    r0 = eng.submit([1.0, 2.0, 3.0], (0.0, 1.0))     # short: padded
    r1 = eng.submit(list(np.linspace(1.0, 4.0, T)), (0.0, 1.0))
    r2 = eng.submit(1.5, (0.0, 1.0))
    return eng, {c.rid: c for c in eng.drain()}, (r0, r1, r2)


def test_stream_theta_batch_requests_retire_with_areas():
    eng, done, (r0, r1, r2) = _theta_batches(_port)
    assert set(done) == {r0, r1, r2}
    assert [len(done[r].areas) for r in (r0, r1, r2)] == [3, T, 1]
    for c in done.values():
        ths = np.asarray(c.theta if isinstance(c.theta, tuple)
                         else [c.theta])
        exact = TI.family_exact("sin_scaled", 0.0, 1.0, ths)
        assert np.all(np.abs(np.asarray(c.areas) - exact) <= 60 * 1e-6)
        assert c.area == c.areas[0]
    res = eng.result()
    assert res.occupancy_summary(SKW["lanes"])["attribution"]["reconciles"]
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(list(np.linspace(1.0, 2.0, T + 1)), (0.0, 1.0))
    ref_eng, ref_done, _ = _theta_batches(_ref)
    assert _records(done.values()) == _records(ref_done.values())
    assert res.totals == ref_eng.result().totals
    for r in (r0, r1, r2):
        assert np.max(np.abs(np.subtract(done[r].areas,
                                          ref_done[r].areas))) < 3e-9


# ---------------------------------------------------------------------------
# the programs carried across
# ---------------------------------------------------------------------------


def _seeded_bag(rng, n, m, count):
    """Reference-layout bag columns: random intervals, slot ids < m with
    random depths, a random accumulator."""
    left = rng.uniform(0.01, 0.5, n)
    return dict(
        bag_l=left, bag_r=left + rng.uniform(0.01, 0.5, n),
        bag_th=rng.uniform(1.0, 2.0, n),
        bag_meta=((rng.integers(0, m, n) << 14)
                  + rng.integers(0, 20, n)).astype(np.int32),
        count=count, acc=rng.standard_normal(m), tasks=5, splits=2,
        iters=3, max_depth=7, overflow=False)


def _ref_bag(cols):
    return RefBag(**{k: (jnp.asarray(v) if k != "overflow"
                         else jnp.asarray(v, bool))
                     for k, v in cols.items()})


@pytest.mark.parametrize("theta_block", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_admit_program_matches_reference(seed, theta_block):
    rng = np.random.default_rng(seed)
    n, m, A, count = 96, 8, 16, 40
    m_eff = m * theta_block
    cols = _seeded_bag(rng, n, m, count)
    acc, acc_c = rng.standard_normal(m_eff), rng.standard_normal(m_eff)
    fam_last = rng.integers(-1, 9, m).astype(np.int32)
    seeds = (rng.uniform(0.01, 0.5, A), rng.uniform(0.5, 1.0, A),
             rng.uniform(1.0, 2.0, A),
             (rng.integers(0, m, A) << 14).astype(np.int32))
    clear = rng.integers(0, 2, m).astype(bool)
    n_new = 11
    for capacity in (64, 48):          # the second overflows
        ref = jax.device_get(RS._admit_program(
            _ref_bag(cols), jnp.asarray(acc), jnp.asarray(acc_c),
            jnp.asarray(fam_last), *(jnp.asarray(s) for s in seeds),
            jnp.asarray(n_new, jnp.int32), jnp.asarray(clear),
            capacity=capacity))
        got = TS._admit_program(
            interop.bag_state_from_numpy(cols), torch.tensor(acc),
            torch.tensor(acc_c), torch.tensor(fam_last),
            *(torch.tensor(s) for s in seeds), n_new, torch.tensor(clear),
            capacity=capacity)
        gb = interop.bag_state_to_numpy(got[0])
        for k in ("bag_l", "bag_r", "bag_th", "bag_meta"):
            assert np.array_equal(gb[k], np.asarray(getattr(ref[0], k))), k
        assert gb["count"] == int(ref[0].count)
        assert gb["overflow"] == bool(ref[0].overflow)
        for g, r in zip(got[1:], ref[1:]):
            assert np.array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="overruns the bag store"):
        TS._admit_program(
            interop.bag_state_from_numpy(dict(cols, count=n - A + 1)),
            torch.tensor(acc), torch.tensor(acc_c), torch.tensor(fam_last),
            *(torch.tensor(s) for s in seeds), 1, torch.tensor(clear),
            capacity=1 << 10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cancel_program_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, m, count = 128, 8, 90
    cols = _seeded_bag(rng, n, m, count)
    kill = rng.integers(0, 2, m).astype(bool)
    ref = jax.device_get(RS._cancel_program(_ref_bag(cols),
                                            jnp.asarray(kill)))
    syncs = TW.HostSyncs()
    got = interop.bag_state_to_numpy(TS._cancel_program(
        interop.bag_state_from_numpy(cols), torch.tensor(kill), syncs))
    for k in ("bag_l", "bag_r", "bag_th", "bag_meta"):
        assert np.array_equal(got[k], np.asarray(getattr(ref, k))), k
    assert got["count"] == int(ref.count) and syncs.n == 1


@pytest.mark.parametrize("m", [8, 300])
@pytest.mark.parametrize("count", [0, 1, 77, 128])
def test_family_live_counts_match_reference(m, count):
    rng = np.random.default_rng(count + m)
    cols = _seeded_bag(rng, 128, m, count)
    ref = np.asarray(RW.family_live_counts(_ref_bag(cols), m))
    got = TW.family_live_counts(interop.bag_state_from_numpy(cols), m)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


def test_obs_copies_match_reference():
    """The same observations give the same quantiles and exposition in
    the port's registry copy as in the reference's."""
    rng = np.random.default_rng(5)
    obs = rng.integers(1, 40, 200)
    out = []
    for reg in (RefRegistry(), MetricsRegistry()):
        h = reg.histogram("lat", "latency", buckets=PHASE_BUCKETS,
                          labelnames=("priority",))
        c = reg.counter("n_total", "count", ("tenant",))
        for i, v in enumerate(obs):
            h.labels(priority=str(i % 3)).observe(float(v))
            c.labels(tenant=f"t{i % 2}").inc()
        out.append((reg.exposition(),
                    [h.labels(priority=str(p)).quantile(q)
                     for p in range(3) for q in (0.5, 0.99)]))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


# once refused with ROADMAP Queue 1 item 7: (options, the world they run)
REFUSED = {
    "walker-dd": (dict(engine="walker-dd"), 1),
    "mesh": (dict(engine="walker-dd", n_devices=2), 2),
}


def test_reduced_stream_matches_reference_engine():
    """reduced_integrands=True walks the family's range-reduced twin:
    the reference engine's schedule on the CPU, with every stats row,
    registry counter and request record equal, areas within 3e-9, and
    ``reduced`` in the identity as the reference keys it."""
    kw = dict(KW, reduced_integrands=True, scout_dtype="f32",
              double_buffer=True)
    r_eng, p_eng = _ref(FAM, EPS, **kw), _port(FAM, EPS, **kw)
    ref = r_eng.run(REQS, arrival_phase=ARRIVALS)
    got = p_eng.run(REQS, arrival_phase=ARRIVALS)
    assert p_eng.f_ds is TI.get_family_ds(FAM, reduced=True)
    assert p_eng._identity() == r_eng._identity()
    assert p_eng._identity()["reduced"] is True
    assert _phases(got) == _phases(ref)
    assert np.array_equal(got.phase_stats, ref.phase_stats)
    assert got.totals == ref.totals
    assert np.max(np.abs(got.areas - ref.areas)) < 3e-9
    # a family without a reduced twin walks its ds twin, not reduced
    eng = _port("quad_scaled", 1e-9, **dict(KW, reduced_integrands=True))
    assert eng.f_ds is TI.get_family_ds("quad_scaled")
    assert "reduced" not in eng._identity()


@pytest.mark.parametrize("f64_rounds", [2, 0])
def test_multihost_single_engine_quad_matches_reference(f64_rounds):
    """The reference bench's multihost single-engine run: quad_scaled
    over theta = 1 + i/4, i < 8, on [0, 1]. As the bench configures it
    (f64_rounds=2) every phase runs float64 bag rounds and no walk
    kernel; with f64_rounds=0 the same requests walk K1 at R = 2. The
    workload is dyadic, so the areas are the reference's bit for bit, in
    both modes alike."""
    kw = dict(MULTIHOST_WKW, f64_rounds=f64_rounds)
    reqs = [(t, (0.0, 1.0)) for t in MULTIHOST_THETA]
    before = TW.run_segment_rf.launches
    got = _port("quad_scaled", MULTIHOST_EPS, **kw).run(reqs)
    ref = _ref("quad_scaled", MULTIHOST_EPS, **kw).run(reqs)
    assert TW.run_segment_rf.launches == before   # plain segments here
    assert len(got.completed) == len(reqs)
    assert np.array_equal(got.areas, ref.areas)
    assert got.totals == ref.totals and _phases(got) == _phases(ref)
    assert (got.totals["wtasks"] > 0) == (f64_rounds == 0)
    other = _port("quad_scaled", MULTIHOST_EPS,
                  **dict(kw, f64_rounds=2 - f64_rounds)).run(reqs)
    assert np.array_equal(got.areas, other.areas)
    assert np.max(np.abs(got.areas - np.asarray(MULTIHOST_THETA) / 3.0)) \
        < 1e-6


@pytest.mark.parametrize("arg", list(REFUSED))
def test_unported_options_raise(arg):
    """The walker-dd stream, once refused, runs on the world asked for
    (one rank by default on the CPU): every request retires within the
    walker contract (3e-9) of the float64 bag. The walker engine refuses
    ``n_devices`` > 1 (it runs on one card)."""
    from ppls_tpu_torch.parallel.bag_engine import integrate_family
    over, world = REFUSED[arg]
    with _port(FAM, EPS, **dict(KW, **over)) as eng:
        res = eng.run(REQS, arrival_phase=ARRIVALS)
    assert res.mesh["world"] == world and len(res.completed) == len(REQS)
    bag = integrate_family(TI.get_family(FAM), THETA, BOUNDS, EPS,
                           chunk=1 << 10, capacity=1 << 17, device="cpu")
    assert np.max(np.abs(res.areas - bag.areas)) < 3e-9
    with pytest.raises(ValueError, match="engine='walker-dd'"):
        _port(FAM, EPS, **dict(KW, n_devices=2))


def test_cuda_is_the_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.StreamEngine(FAM, EPS, **KW)
    # a resume restores onto the caller's device, CUDA by default
    path = str(tmp_path / "s.ckpt")
    _port(FAM, EPS, checkpoint_path=path, checkpoint_every=1,
          **KW).run(REQS[:1])
    assert os.path.exists(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.StreamEngine.resume(path, FAM, EPS, **KW)


# ---------------------------------------------------------------------------
# snapshot and resume
# ---------------------------------------------------------------------------


def _crash_run(make, path, crash=3, **over):
    eng = make(FAM, EPS, checkpoint_path=path, checkpoint_every=1,
               **dict(KW, **over))
    with pytest.raises(RuntimeError, match="simulated crash"):
        eng.run(REQS, arrival_phase=ARRIVALS, _crash_after_phases=crash)
    return eng


def _replay(eng):
    """Run the rest of the arrival schedule on a resumed engine: rids
    follow the submission order, so the replay skips the submitted
    prefix (tests/test_stream.py:135-143)."""
    k = eng.next_rid
    while not eng.idle or k < len(REQS):
        while k < len(REQS) and ARRIVALS[k] <= eng.phase:
            eng.submit(*REQS[k])
            k += 1
        eng.step()
    return eng.result()


def _same_stream(res, base):
    assert np.array_equal(res.areas, base.areas)          # bit for bit
    assert res.phases == base.phases
    assert _records(res.completed) == _records(base.completed)
    assert np.array_equal(res.phase_stats, base.phase_stats)
    assert _sheds(res.shed) == _sheds(base.shed)
    assert res.totals == base.totals


@pytest.fixture(scope="module")
def stream_base():
    return _port(FAM, EPS, **KW).run(REQS, arrival_phase=ARRIVALS)


@pytest.mark.parametrize("background", [False, True])
def test_stream_kill_and_resume_matches_uninterrupted(tmp_path, stream_base,
                                                      background):
    """tests/test_stream.py:123 and :152 on the port: killed after 3
    phases, resumed and replayed, bit-identical to the run with no
    crash, with the synchronous and the background writer (write
    mechanics, not identity: either mode resumes the other's file)."""
    path = str(tmp_path / "stream.ckpt")
    _crash_run(_port, path, checkpoint_background=background)
    eng = TS.StreamEngine.resume(path, FAM, EPS, checkpoint_every=1,
                                 checkpoint_background=not background,
                                 device="cpu", **KW)
    assert eng.phase == 3
    _same_stream(_replay(eng), stream_base)


def test_stream_resume_rejects_mismatched_identity(tmp_path):
    path = str(tmp_path / "stream.ckpt")
    _crash_run(_port, path, crash=1)
    with pytest.raises(ValueError, match="different run"):
        TS.StreamEngine.resume(path, FAM, 1e-8, device="cpu", **KW)
    with pytest.raises(ValueError, match="different run"):
        TS.StreamEngine.resume(path, FAM, EPS, device="cpu",
                               **dict(KW, scout_dtype="f32"))


@pytest.fixture(scope="module")
def stream_pair(tmp_path_factory):
    """Each package's snapshot after 3 phases of the same stream, and the
    reference's uninterrupted run."""
    d = tmp_path_factory.mktemp("stream_pair")
    paths = {k: str(d / f"{k}.ckpt") for k in ("reference", "port")}
    _crash_run(_ref, paths["reference"])
    _crash_run(_port, paths["port"])
    return _ref(FAM, EPS, **KW).run(REQS, arrival_phase=ARRIVALS), paths


def _container(path):
    with np.load(path) as z:
        return (json.loads(bytes(z["meta"]).decode()),
                {k: np.asarray(z[k]) for k in z.files if k != "meta"})


def test_stream_snapshot_matches_reference_at_the_same_phase(stream_pair):
    _, paths = stream_pair
    (mr, ar), (mp, ap) = (_container(paths[k])
                          for k in ("reference", "port"))
    assert mp["identity"] == mr["identity"]
    assert mp["count"] == mr["count"]
    tr, tp = mr["totals"], mp["totals"]
    assert set(tp) == set(tr)
    # every key but the host clock (submit_t, latency_s) and the areas,
    # which the reference's interpret mode holds within 3e-9
    for k in tr:
        if k in ("pending", "resident", "completed"):
            continue
        assert tp[k] == tr[k], k

    def strip(d):
        return {k: v for k, v in d.items()
                if k not in ("submit_t", "latency_s", "area", "areas")}

    for k in ("pending", "completed"):
        assert [strip(d) for d in tp[k]] == [strip(d) for d in tr[k]], k
    assert {s: strip(d) for s, d in tp["resident"].items()} ==         {s: strip(d) for s, d in tr["resident"].items()}
    for k in ("bag_l", "bag_r", "bag_th", "bag_meta"):
        assert ap[k].dtype == ar[k].dtype and np.array_equal(ap[k], ar[k])
    assert ap["acc"].shape == ar["acc"].shape == (2, KW["slots"])
    assert np.max(np.abs(ap["acc"] - ar["acc"])) < 3e-9


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_stream_resumes_across_packages(stream_pair, direction, tmp_path):
    base, paths = stream_pair
    src = paths["reference" if direction == "reference-to-port"
                else "port"]
    path = str(tmp_path / "x.ckpt")
    with open(src, "rb") as fh_in, open(path, "wb") as fh_out:
        fh_out.write(fh_in.read())
    if direction == "reference-to-port":
        eng = TS.StreamEngine.resume(path, FAM, EPS, checkpoint_every=1,
                                     device="cpu", **KW)
    else:
        eng = RS.StreamEngine.resume(path, FAM, EPS, checkpoint_every=1,
                                     **KW)
    res = _replay(eng)
    assert res.phases == base.phases
    assert _phases(res) == _phases(base)
    assert np.max(np.abs(res.areas - base.areas)) < 3e-9


def test_client_state_rides_the_snapshot(tmp_path):
    path = str(tmp_path / "c.ckpt")
    eng = _port(FAM, EPS, checkpoint_path=path, checkpoint_every=1, **KW)
    eng.client_state["cursor"] = {"batch": 4, "acked": [0, 1, 2]}
    eng.submit(*REQS[0])
    eng.step()
    back = TS.StreamEngine.resume(path, FAM, EPS, device="cpu", **KW)
    assert back.client_state == {"cursor": {"batch": 4,
                                            "acked": [0, 1, 2]}}
    assert back.phase == 1 and back.next_rid == 1
    assert _container(path)[0]["totals"]["client_state"] ==         back.client_state


def test_checkpoint_every_sets_the_cadence(tmp_path, monkeypatch):
    written = []
    eng = _port(FAM, EPS, checkpoint_path=str(tmp_path / "e.ckpt"),
                checkpoint_every=3, **KW)
    monkeypatch.setattr(eng, "snapshot", lambda: written.append(eng.phase))
    res = eng.run(REQS, arrival_phase=ARRIVALS)
    assert written == list(range(3, res.phases + 1, 3)) and written
    assert TS.StreamEngine(FAM, EPS, device="cpu", **KW).checkpoint_every \
        == 8                                    # the reference's default
    with pytest.raises(ValueError, match="no checkpoint_path"):
        _port(FAM, EPS, **KW).snapshot()


@pytest.mark.parametrize("extra,pattern", [
    # None: resumes (the walker engine reads its own state, as the
    # reference's does; a walker-dd snapshot resumes on the walker-dd
    # engine, tests/test_torch_dd_stream.py)
    pytest.param({"dd": {}}, None, id="extra0-item 7, behind item 8"),
    pytest.param({"adapt": {}}, "snapshot carries online-adaptation state "
                 "but adapt is not armed on this resume; pass adapt=True",
                 id="extra1-adapt is not armed"),
])
def test_resume_refuses_unported_state(tmp_path, extra, pattern):
    """A walker snapshot that also carries a ``dd`` key (once refused
    with ROADMAP item 7) resumes as the reference's engine does, bit
    equal to the run without a crash; one carrying online-adaptation
    state onto an engine without ``adapt`` is refused with the
    reference's words."""
    from ppls_tpu_torch.runtime.checkpoint import (load_family_checkpoint,
                                                   save_family_checkpoint)
    path = str(tmp_path / "u.ckpt")
    eng = _port(FAM, EPS, checkpoint_path=path, checkpoint_every=1, **KW)
    eng.submit(*REQS[0])
    eng.step()
    cols, count, acc, totals = load_family_checkpoint(path, eng._identity())
    save_family_checkpoint(path, identity=eng._identity(), bag_cols=cols,
                           count=count, acc=acc, totals=dict(totals, **extra))
    if pattern is None:
        eng2 = TS.StreamEngine.resume(path, FAM, EPS, device="cpu", **KW)
        assert eng2.phase == 1
        assert np.array_equal(eng2.run([]).areas,
                              _port(FAM, EPS, **KW).run(REQS[:1]).areas)
        return
    with pytest.raises(ValueError, match=pattern):
        TS.StreamEngine.resume(path, FAM, EPS, device="cpu", **KW)


def test_scout_stream_areas_move_with_the_schedule_as_the_reference():
    """The reference bench gates |stream - cold| <= 1e-8 (bench.py:1166),
    where the streamed requests and K cold per-request walker calls walk
    different schedules. In the flagship regime (|theta / x| ~ 1e4, eps
    1e-10) the scout's float32 error exceeds its guard band, so its
    decisive splits follow rounding noise and the areas move with the
    schedule: the reference's own stream misses that gate against its
    own cold calls, and the port's misses it the same way, its areas
    within 3e-9 of the reference's. (Scouting off, the ds walk holds it:
    ``chip_smoke.py`` phase 11 at full width.)"""
    theta = (1.0 + np.arange(1024) / 1024.0)[::256][:2]
    bounds, eps = (1e-4, 1.0), 1e-10
    wkw = dict(capacity=1 << 22, lanes=1024, roots_per_lane=12,
               refill_slots=8, double_buffer=True)
    ekw = dict(wkw, slots=8, chunk=1 << 13)
    reqs = [(float(t), bounds) for t in theta]

    def cold(walker, fams, **kw):
        return np.array([walker(fams.get_family(FAM), fams.get_family_ds(FAM),
                                [t], bounds, eps, **kw).areas[0]
                         for t in theta])

    ref_s = _ref(FAM, eps, scout_dtype="f32", **ekw).run(reqs).areas
    ref_c = cold(RW.integrate_family_walker, RI, scout_dtype="f32", **wkw)
    got_s = _port(FAM, eps, scout_dtype="f32", **ekw).run(reqs).areas
    got_c = cold(TW.integrate_family_walker, TI, scout_dtype="f32",
                 device="cpu", **wkw)
    print(f"|stream - cold| reference {np.abs(ref_s - ref_c)}, port "
          f"{np.abs(got_s - got_c)}")
    assert np.max(np.abs(ref_s - ref_c)) > 10 * 1e-8
    assert np.max(np.abs(got_s - got_c)) > 10 * 1e-8
    assert np.max(np.abs(got_s - ref_s)) < 3e-9
    assert np.max(np.abs(got_c - ref_c)) < 3e-9
