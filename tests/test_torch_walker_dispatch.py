"""The walker surface of the reference bench's timed pipeline
(bench.py:290-293, :416-441) and its options, the port against the
reference on the same seeded inputs, at tests/test_torch_walker.py's
shapes (8 thetas of sin(theta / x) on [1e-2, 1], eps 1e-7, 256 lanes):

* ``seed_family_walker_state``: the seed bag's columns equal the
  reference's exactly;
* ``dispatch_family_walker`` on one seed, several times, then
  ``collect_family_walker``: each run bit-equal to a fresh
  ``integrate_family_walker`` call (the seed is pure input), and the
  pipeline equal to the reference's (tasks, cycles, kernel steps, stats
  rows; areas within 3e-9); the reference's refusals, word for word;
* ``nan_policy`` (tests/test_faults.py:425-448): a family whose float64
  integrand turns NaN where theta > 8 and x > 0.5, beside healthy ones:
  quarantine marks exactly that family and the healthy areas are
  bit-equal to the unpoisoned run's, "raise" raises, another policy is
  refused, each with the reference's wording and mask;
* ``sort_roots=False`` and ``sort_skip_ratio`` 0 and 2.0 on the walker
  and the stream: the reference's stats rows and tasks, areas within
  3e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu.models import integrands as RI
from ppls_tpu.parallel import walker as RW
from ppls_tpu.runtime.stream import StreamEngine as RefStream
from ppls_tpu_torch.models import integrands as TI
from ppls_tpu_torch.obs.telemetry import default_telemetry
from ppls_tpu_torch.parallel import walker as TW
from ppls_tpu_torch.runtime.stream import StreamEngine

FAM = "sin_recip_scaled"
THETA = 1.0 + np.arange(8) / 8.0
BOUNDS = (1e-2, 1.0)
EPS = 1e-7
SIZING = dict(capacity=1 << 16, lanes=256, roots_per_lane=2)
KW = dict(SIZING, seg_iters=32, min_active_frac=0.05)
MODES = {
    # in-kernel refill (K1), the bench's main leg's modes
    "in-kernel": dict(refill_slots=2, scout_dtype="f32",
                      double_buffer=True),
    # boundary refill (K2), the bench's fallback leg
    "boundary": dict(refill_slots=0, scout_dtype="f64"),
}
N_QUEUED = 3
AREA_TOL = 3e-9


@pytest.fixture(scope="module", autouse=True)
def _no_tuning_table():
    # the cadence tier is tests/test_torch_tune.py's; here both packages
    # walk the hand tier
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPLS_TUNING_TABLE", "off")
        yield


def _port_fam(name=FAM):
    return TI.get_family(name), TI.get_family_ds(name)


def _ref_fam(name=FAM):
    return RI.get_family(name), RI.get_family_ds(name)


def _same_run(a, b) -> None:
    """Bit-equal walker results."""
    assert np.array_equal(a.areas, b.areas)
    assert a.metrics.tasks == b.metrics.tasks
    assert a.metrics.splits == b.metrics.splits
    assert a.cycles == b.cycles
    assert a.kernel_steps == b.kernel_steps
    assert np.array_equal(a.waste, b.waste)
    assert np.array_equal(a.seg_stats, b.seg_stats)
    assert np.array_equal(a.cycle_stats, b.cycle_stats)


def _near_reference(got, ref) -> None:
    """The reference's schedule, areas within the walker tolerance."""
    assert got.metrics.tasks == ref.metrics.tasks
    assert got.cycles == ref.cycles
    assert got.kernel_steps == ref.kernel_steps
    assert np.array_equal(got.cycle_stats, ref.cycle_stats)
    assert np.array_equal(got.seg_stats, ref.seg_stats)
    assert np.max(np.abs(got.areas - ref.areas)) < AREA_TOL


# ---------------------------------------------------------------------------
# seed, dispatch, collect
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta_block", [1, 8])
def test_seed_state_columns_equal_reference(theta_block):
    theta = (THETA if theta_block == 1
             else np.linspace(1.0, 4.0, 16).reshape(2, 8))
    got = TW.seed_family_walker_state(theta, BOUNDS, chunk=1 << 10,
                                      theta_block=theta_block, device="cpu",
                                      **SIZING)
    ref = RW.seed_family_walker_state(theta, BOUNDS, chunk=1 << 10,
                                      theta_block=theta_block, **SIZING)
    for col in ("bag_l", "bag_r", "bag_th", "bag_meta", "acc"):
        g = getattr(got, col).numpy()
        r = np.asarray(getattr(ref, col))
        assert g.dtype == r.dtype and np.array_equal(g, r), col
    assert got.count == int(ref.count)


@pytest.fixture(scope="module")
def ref_pipeline():
    """The reference bench's pipeline once per mode: one seed, queued
    dispatches, collected in order."""
    out = {}
    f, fd = _ref_fam()
    for mode, over in MODES.items():
        seed = RW.seed_family_walker_state(THETA, BOUNDS, **SIZING)
        ds = [RW.dispatch_family_walker(f, fd, THETA, BOUNDS, EPS,
                                        _state_override=seed, **KW, **over)
              for _ in range(2)]
        out[mode] = [RW.collect_family_walker(d) for d in ds]
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_queued_dispatches_on_one_seed_equal_integrate(ref_pipeline, mode):
    f, fd = _port_fam()
    kw = dict(KW, **MODES[mode], device="cpu")
    fresh = TW.integrate_family_walker(f, fd, THETA, BOUNDS, EPS, **kw)
    seed = TW.seed_family_walker_state(THETA, BOUNDS, device="cpu",
                                       **SIZING)
    cols = [c.clone() for c in (seed.bag_l, seed.bag_r, seed.bag_th,
                                seed.bag_meta)]
    queued = [TW.dispatch_family_walker(f, fd, THETA, BOUNDS, EPS,
                                        _state_override=seed, **kw)
              for _ in range(N_QUEUED)]
    assert all(isinstance(d, TW.WalkerDispatch) for d in queued)
    runs = [TW.collect_family_walker(d) for d in queued]
    for r in runs:
        _same_run(r, fresh)
        assert r.failed is None
    # the seed is pure input: its store is untouched
    for a, b in zip(cols, (seed.bag_l, seed.bag_r, seed.bag_th,
                           seed.bag_meta)):
        assert torch.equal(a, b)
    # a queued run's wall spans every run collected before it
    walls = [r.metrics.wall_time_s for r in runs]
    assert walls == sorted(walls)
    for ref in ref_pipeline[mode]:
        _near_reference(runs[0], ref)


@pytest.mark.parametrize("bad", ["checkpoint_path", "checkpoint_every",
                                 "seed_sizing"])
def test_dispatch_refusals_equal_reference(tmp_path, bad):
    over = {"checkpoint_path": dict(checkpoint_path=str(tmp_path / "c")),
            "checkpoint_every": dict(checkpoint_every=2),
            "seed_sizing": {}}[bad]
    seed_kw = dict(SIZING, capacity=1 << 15) if bad == "seed_sizing" \
        else SIZING
    p_seed = TW.seed_family_walker_state(THETA, BOUNDS, device="cpu",
                                         **seed_kw)
    r_seed = RW.seed_family_walker_state(THETA, BOUNDS, **seed_kw)
    with pytest.raises(ValueError) as got:
        TW.dispatch_family_walker(*_port_fam(), THETA, BOUNDS, EPS,
                                  _state_override=p_seed, device="cpu",
                                  **KW, **over)
    with pytest.raises(ValueError) as ref:
        RW.dispatch_family_walker(*_ref_fam(), THETA, BOUNDS, EPS,
                                  _state_override=r_seed, **KW, **over)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# nan_policy (tests/test_faults.py:425-448)
# ---------------------------------------------------------------------------

POISON = "poison_dispatch_test"
THETA_H = np.array([1.0, 1.25, 1.5, 2.0])
THETA_P = np.array([1.0, 1.25, 9.0, 2.0])      # family 2 poisoned
HEALTHY = [0, 1, 3]


def _ref_poison(x, th):
    return jnp.where((th > 8.0) & (x > 0.5), jnp.nan, th * x * x)


def _port_poison(x, th):
    return torch.where((th > 8.0) & (x > 0.5), torch.nan, th * x * x)


@pytest.fixture(scope="module")
def poison_family():
    """theta > 8 poisons the right half of the float64 domain with NaN;
    the ds twin (quad_scaled's) stays clean. Registered with both
    packages' registries, as the reference test registers it, for this
    module only."""
    RI.register_family(POISON, _ref_poison)
    RI.register_family_ds(POISON, RI.get_family_ds("quad_scaled"))
    TI.register_family(POISON, _port_poison)
    TI.register_family_ds(POISON, TI.get_family_ds("quad_scaled"))
    yield POISON
    for mod in (RI, TI):
        mod.FAMILIES.pop(POISON)
        mod.DS_FAMILIES.pop(POISON)


def _quarantine_kw(mode):
    return dict(KW, refill_slots=MODES[mode]["refill_slots"])


@pytest.fixture(scope="module")
def ref_quarantine(poison_family):
    out = {}
    f, fd = _ref_fam(POISON)
    for mode in MODES:
        out[mode] = RW.integrate_family_walker(
            f, fd, THETA_P, (0.0, 1.0), 1e-9, nan_policy="quarantine",
            **_quarantine_kw(mode))
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("policy", ["quarantine", "raise", "ignore"])
def test_nan_policy_as_the_reference(ref_quarantine, poison_family, mode,
                                    policy):
    f, fd = _port_fam(POISON)
    kw = dict(_quarantine_kw(mode), device="cpu")
    if policy == "quarantine":
        reg = default_telemetry().registry
        before = reg.value("ppls_quarantined_total", engine="walker")
        base = TW.integrate_family_walker(f, fd, THETA_H, (0.0, 1.0), 1e-9,
                                          **kw)
        assert base.failed is None
        res = TW.integrate_family_walker(f, fd, THETA_P, (0.0, 1.0), 1e-9,
                                         nan_policy="quarantine", **kw)
        assert list(res.failed) == [False, False, True, False]
        assert np.array_equal(res.areas[HEALTHY], base.areas[HEALTHY])
        ref = ref_quarantine[mode]
        assert np.array_equal(res.failed, ref.failed)
        assert np.array_equal(res.areas[HEALTHY], ref.areas[HEALTHY])
        assert reg.value("ppls_quarantined_total",
                         engine="walker") == before + 1
        return
    want = FloatingPointError if policy == "raise" else ValueError
    rf, rfd = _ref_fam(POISON)
    with pytest.raises(want) as got:
        TW.integrate_family_walker(f, fd, THETA_P, (0.0, 1.0), 1e-9,
                                   nan_policy=policy, **kw)
    with pytest.raises(want) as ref:
        RW.integrate_family_walker(rf, rfd, THETA_P, (0.0, 1.0), 1e-9,
                                   nan_policy=policy,
                                   **_quarantine_kw(mode))
    assert str(got.value) == str(ref.value)
    assert ("non-finite" if policy == "raise" else "nan_policy") \
        in str(got.value)


def test_quarantine_past_the_exact_sum_tier(poison_family):
    """Past 256 families the credit is the exact digit-plane segment sum
    (ops/reduction.py), where the reference's one NaN reaches every
    family; the port's keeps it in its own (its quarantine contract at
    the flagship's 1024 families, chip_smoke.py phase 16c)."""
    f, fd = _port_fam(POISON)
    m = 512                 # dyadic thetas: every credit is exact
    theta = 1.0 + np.arange(m) / m
    poisoned = theta.copy()
    poisoned[100] = 9.0
    # a breed target above m, so the float64 breed meets the poison
    kw = dict(_quarantine_kw("in-kernel"), roots_per_lane=4, device="cpu")
    base = TW.integrate_family_walker(f, fd, theta, (0.0, 1.0), 1e-7, **kw)
    res = TW.integrate_family_walker(f, fd, poisoned, (0.0, 1.0), 1e-7,
                                     nan_policy="quarantine", **kw)
    assert base.failed is None
    assert list(np.flatnonzero(res.failed)) == [100]
    healthy = np.arange(m) != 100
    assert np.array_equal(res.areas[healthy], base.areas[healthy])


def test_resume_keeps_the_nan_policy(tmp_path, poison_family):
    f, fd = _port_fam(POISON)
    kw = dict(_quarantine_kw("in-kernel"), device="cpu", max_cycles=64)
    whole = TW.integrate_family_walker(f, fd, THETA_P, (0.0, 1.0), 1e-9,
                                       nan_policy="quarantine", **kw)
    path = str(tmp_path / "q.ckpt")
    with pytest.raises(RuntimeError, match="simulated crash"):
        TW.integrate_family_walker(f, fd, THETA_P, (0.0, 1.0), 1e-9,
                                   nan_policy="quarantine",
                                   checkpoint_path=path, _crash_after_legs=1,
                                   **kw)
    res = TW.resume_family_walker(path, f, fd, THETA_P, (0.0, 1.0), 1e-9,
                                  nan_policy="quarantine", **kw)
    assert np.array_equal(res.failed, whole.failed)
    assert np.array_equal(res.areas[HEALTHY], whole.areas[HEALTHY])


# ---------------------------------------------------------------------------
# sort_roots, sort_skip_ratio
# ---------------------------------------------------------------------------

SORTS = {"unsorted": dict(sort_roots=False),
         "always_sort": dict(sort_skip_ratio=0.0),
         "ratio_2": dict(sort_skip_ratio=2.0)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sort", list(SORTS))
def test_walker_sort_options_match_reference(mode, sort):
    over = dict(KW, **MODES[mode], **SORTS[sort])
    ref = RW.integrate_family_walker(*_ref_fam(), THETA, BOUNDS, EPS, **over)
    got = TW.integrate_family_walker(*_port_fam(), THETA, BOUNDS, EPS,
                                     device="cpu", **over)
    _near_reference(got, ref)
    srows = got.cycle_stats[:, TW.CYCLE_STAT_FIELDS.index("sort_rows")]
    # without the sort no row is scored
    assert srows.any() == (sort != "unsorted")


@pytest.mark.parametrize("sort", list(SORTS))
def test_stream_sort_options_match_reference(sort):
    kw = dict(KW, slots=8, chunk=1 << 10, refill_slots=2, **SORTS[sort])
    reqs = [(float(t), BOUNDS) for t in THETA]
    arr = [0, 0, 1, 2, 3, 5, 5, 6]
    ref = RefStream(FAM, EPS, **kw).run(reqs, arrival_phase=arr)
    got = StreamEngine(FAM, EPS, device="cpu", **kw).run(reqs,
                                                         arrival_phase=arr)
    assert got.phases == ref.phases
    assert np.array_equal(got.phase_stats, ref.phase_stats)
    assert got.totals == ref.totals
    assert np.max(np.abs(got.areas - ref.areas)) < AREA_TOL
