"""The whole slice: the port's ``integrate_family_walker`` against the
reference walker and the reference float64 bag engine, at the small
shapes of tests/test_scout_double_buffer.py (8 thetas of
sin(theta / x) on [1e-2, 1], eps 1e-7, 256 lanes, R = 2) for in-kernel
refill and of tests/test_walker.py (``KW0``: roots_per_lane 1,
refill_slots 0) for boundary refill.

The reference's own walker contract, held for the port in every refill,
scout and double-buffer mode: areas within 3e-9 of the float64 bag and
of the reference walker, task drift below 1e-3, tasks == splits +
leaves, the waste buckets reconciling to lanes x kernel steps, and a
rerun bit-identical. The reference resolves its cadence with the tuning
table off, so both sides use the hand-tuned defaults. One test runs four
members at the flagship's own bounds and eps, where the scout schedule
over-refines in the reference as in the port.

The other integrand bodies run end to end at the reference tests'
configurations: the reference problem through the range-reduced cosh^4
twin, gauss_center, and quad_scaled (bit for bit).

The Simpson walker is held to the port's float64 Simpson bag at
tests/test_tpu_lane.py's real-chip configuration (equal tasks, areas
within 1e-12): the port performs the float32 arithmetic exactly, as the
chip does. Against the reference Simpson walker, whose interpret mode
degrades ds toward float32, only at tests/test_walker.py's
interpret-mode tolerances.
"""

import numpy as np
import pytest
import torch

from ppls_tpu.models.integrands import get_family as ref_family
from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
from ppls_tpu.parallel.bag_engine import integrate_family as ref_bag
from ppls_tpu.parallel.walker import integrate_family_walker as ref_walker
from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import (family_exact, get_family,
                                              get_family_ds)
from ppls_tpu_torch.parallel.bag_engine import integrate_family
from ppls_tpu_torch.parallel.walker import CYCLE_STAT_FIELDS as W_FIELDS
from ppls_tpu_torch.parallel.walker import integrate_family_walker

FAM = "sin_recip_scaled"
THETA = 1.0 + np.arange(8) / 8.0
BOUNDS = (1e-2, 1.0)
EPS = 1e-7
KW = dict(capacity=1 << 16, lanes=256, roots_per_lane=2, refill_slots=2,
          seg_iters=32, min_active_frac=0.05)
# boundary refill at tests/test_walker.py's shapes
KW0 = dict(KW, roots_per_lane=1, refill_slots=0)
REFILL = {"in-kernel": {}, "boundary": dict(roots_per_lane=1,
                                            refill_slots=0)}


def _port(**over):
    kw = dict(KW, **over)
    return integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                   THETA, BOUNDS, EPS, device="cpu", **kw)


@pytest.fixture(scope="module")
def bag_areas():
    b = ref_bag(ref_family(FAM), THETA, BOUNDS, EPS, chunk=1 << 10,
                capacity=1 << 16)
    return b.areas, b.metrics.tasks


@pytest.mark.parametrize("scout", ["f64", "f32"])
@pytest.mark.parametrize("double_buffer", [False, True])
def test_walker_slice_matches_reference(monkeypatch, bag_areas, scout,
                                        double_buffer):
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    mode = dict(scout_dtype=scout, double_buffer=double_buffer)
    got = _port(**mode)
    ref = ref_walker(ref_family(FAM), ref_family_ds(FAM), THETA, BOUNDS,
                     EPS, **KW, **mode)
    b_areas, b_tasks = bag_areas

    assert np.max(np.abs(got.areas - b_areas)) < 3e-9
    assert np.max(np.abs(got.areas - ref.areas)) < 3e-9
    assert abs(got.metrics.tasks - b_tasks) / b_tasks < 1e-3
    assert abs(got.metrics.tasks - ref.metrics.tasks) \
        / ref.metrics.tasks < 1e-3
    assert got.metrics.tasks == got.metrics.splits + got.metrics.leaves
    att = got.attribution()
    assert att["reconciles"], att
    assert sum(att["buckets"].values()) == got.kernel_steps * got.lanes
    assert got.walker_fraction > 0.5
    if scout == "f32":
        assert got.scout_evals > 0 and got.confirm_evals > 0
    else:
        assert got.scout_evals == 0
        assert got.confirm_evals == int(got.waste[0])
    assert got.host_syncs == sum(got.host_syncs_per_cycle) + 1

    again = _port(**mode)
    assert np.array_equal(again.areas, got.areas)
    assert again.metrics.tasks == got.metrics.tasks
    assert np.array_equal(again.waste, got.waste)


@pytest.mark.parametrize("scout", ["f64", "f32"])
def test_boundary_refill_walker_matches_reference(monkeypatch, bag_areas,
                                                  scout):
    # refill_slots=0: K2 segments with the host banking and refilling at
    # every boundary. Here the port also walks the reference's exact
    # schedule: the same kernel steps, waste buckets and per-segment rows.
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    got = _port(refill_slots=0, roots_per_lane=1, scout_dtype=scout)
    ref = ref_walker(ref_family(FAM), ref_family_ds(FAM), THETA, BOUNDS,
                     EPS, scout_dtype=scout, **KW0)
    b_areas, b_tasks = bag_areas

    assert np.max(np.abs(got.areas - b_areas)) < 3e-9
    assert np.max(np.abs(got.areas - ref.areas)) < 3e-9
    assert abs(got.metrics.tasks - b_tasks) / b_tasks < 1e-3
    assert abs(got.metrics.tasks - ref.metrics.tasks) \
        / ref.metrics.tasks < 1e-3
    assert got.metrics.tasks == got.metrics.splits + got.metrics.leaves
    att = got.attribution()
    assert att["reconciles"], att
    assert got.walker_fraction > 0.5
    assert got.refill_slots == 0 and got.kernel_steps > 0
    assert got.kernel_steps == ref.kernel_steps
    assert np.array_equal(got.waste, ref.waste)
    assert np.array_equal(got.seg_stats, ref.seg_stats)
    occ, r_occ = got.occupancy_summary(), ref.occupancy_summary()
    assert occ["mode"] == "boundary-refill" and occ["est_occupancy"] > 0
    assert {k: v for k, v in occ.items() if k != "mode"} \
        == {k: v for k, v in r_occ.items() if k != "mode"}
    # one host sync per segment plus one per phase seeding, beside the
    # bag's own
    assert got.host_syncs == sum(got.host_syncs_per_cycle) + 1

    again = _port(refill_slots=0, roots_per_lane=1, scout_dtype=scout)
    assert np.array_equal(again.areas, got.areas)
    assert again.metrics.tasks == got.metrics.tasks
    assert np.array_equal(again.waste, got.waste)


def test_occupancy_estimate_only_for_boundary_refill():
    assert _port().occupancy_summary()["est_occupancy"] is None
    occ = _port(**REFILL["boundary"]).occupancy_summary()
    assert occ["mode"] == "boundary-refill"
    assert 0.0 < occ["est_occupancy"] <= 1.0


def test_walker_flagship_regime_matches_reference(monkeypatch):
    # every 256th theta of the flagship on its bounds [1e-4, 1] at its eps.
    # At |theta / x| ~ 1e4 the scout's float32 error (~1e-3) exceeds the
    # guard band, so decisive splits follow rounding noise and over-refine
    # nodes the float64 test accepts: the reference walker's own areas
    # move off the float64 bag by far more than 3e-9 (9.2e-7 on theta = 1,
    # measured). The port reproduces that schedule: the reference
    # walker's tasks and areas within 3e-9. Scouting off, the port holds
    # the bag to 3e-9 here too. (``pytest -s`` prints the measurements.)
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    theta = (1.0 + np.arange(1024) / 1024.0)[::256]
    bounds, eps = (1e-4, 1.0), 1e-10
    kw = dict(capacity=1 << 22, lanes=1024, roots_per_lane=12,
              refill_slots=8, double_buffer=True)
    bag = ref_bag(ref_family(FAM), theta, bounds, eps, capacity=1 << 22)
    ref = ref_walker(ref_family(FAM), ref_family_ds(FAM), theta, bounds,
                     eps, scout_dtype="f32", **kw)
    got = integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                  theta, bounds, eps, device="cpu",
                                  scout_dtype="f32", **kw)
    ds = integrate_family_walker(get_family(FAM), get_family_ds(FAM), theta,
                                 bounds, eps, device="cpu",
                                 scout_dtype="f64", **kw)
    print(f"flagship regime: bag {bag.metrics.tasks} tasks, scouting "
          f"reference {ref.metrics.tasks - bag.metrics.tasks:+d}, port "
          f"{got.metrics.tasks - bag.metrics.tasks:+d}; |reference - bag| "
          f"{np.abs(ref.areas - bag.areas)}, max |port - reference| "
          f"{np.max(np.abs(got.areas - ref.areas)):.3e}, max |port ds - bag| "
          f"{np.max(np.abs(ds.areas - bag.areas)):.3e}")
    assert ref.metrics.tasks > bag.metrics.tasks
    assert np.max(np.abs(ref.areas - bag.areas)) > 100 * 3e-9
    assert np.max(np.abs(got.areas - ref.areas)) < 3e-9
    assert abs(got.metrics.tasks - ref.metrics.tasks) \
        / ref.metrics.tasks < 1e-3
    assert got.attribution()["reconciles"]
    assert np.max(np.abs(ds.areas - bag.areas)) < 3e-9


def test_walker_reference_problem_family():
    # cosh^4 (the reference C problem's family) through the walker and
    # ds_exp: areas at the float64 bag's within the ds contract
    theta = 0.5 + np.arange(4) / 4.0
    kw = dict(capacity=1 << 16, lanes=256, roots_per_lane=2,
              refill_slots=2, seg_iters=32, min_active_frac=0.05)
    got = integrate_family_walker(get_family("cosh4_scaled"),
                                  get_family_ds("cosh4_scaled"), theta,
                                  (0.0, 3.0), 1e-6, device="cpu",
                                  scout_dtype="f32", double_buffer=True,
                                  **kw)
    bag = integrate_family(get_family("cosh4_scaled"), theta, (0.0, 3.0),
                           1e-6, chunk=1 << 10, capacity=1 << 16,
                           device="cpu")
    assert got.walker_fraction > 0.5
    assert np.max(np.abs(got.areas - bag.areas) / bag.areas) < 3e-9
    assert got.attribution()["reconciles"]


def test_walker_reduced_cosh4_reference_problem(monkeypatch):
    # tests/test_reduced_integrands.py:160-176: the reference problem
    # (cosh^4 on [0, 5]) through the range-reduced twin, scouting and
    # double buffer on, within 1e-6 of the closed form, in both packages.
    # The reference's interpret mode contracts multiply-adds (5.3e-8 off
    # the closed form, measured; the port 5.5e-10), so the two are held
    # to each other at that contract and to 1e-2 task drift.
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    kw = dict(capacity=1 << 16, lanes=256, roots_per_lane=2,
              refill_slots=2, seg_iters=32, min_active_frac=0.05,
              scout_dtype="f32", double_buffer=True)
    theta = np.array([1.0])
    exact = family_exact("cosh4_scaled", 0.0, 5.0, theta)[0]
    got = integrate_family_walker(
        get_family("cosh4_scaled"), get_family_ds("cosh4_scaled",
                                                  reduced=True),
        theta, (0.0, 5.0), 1e-6, device="cpu", **kw)
    ref = ref_walker(ref_family("cosh4_scaled"),
                     ref_family_ds("cosh4_scaled", reduced=True), theta,
                     (0.0, 5.0), 1e-6, **kw)
    assert abs(got.areas[0] - exact) / exact < 1e-6
    assert abs(got.areas[0] - ref.areas[0]) / exact < 1e-6
    assert abs(got.metrics.tasks - ref.metrics.tasks) \
        / ref.metrics.tasks < 1e-2
    assert got.scout_evals > 0 and got.attribution()["reconciles"]


def test_walker_gauss_family_matches_reference(monkeypatch):
    # tests/test_walker.py:150-168: three Gaussians of width 1e-3 near
    # the dyadic points, through ds_exp. Every peak resolved, the walker
    # within 3e-9 of the float64 bag of both packages (torch.exp and
    # XLA's exp may differ by an ulp: the two bags are 8.7e-19 apart,
    # measured) and of the reference walker, task drift below 1e-2
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    kw = dict(capacity=1 << 16, lanes=256, roots_per_lane=1, seg_iters=32,
              min_active_frac=0.05)
    theta = np.array([0.4995, 0.5, 0.5005])
    bounds, eps = (0.4, 0.6), 1e-9
    got = integrate_family_walker(get_family("gauss_center"),
                                  get_family_ds("gauss_center"), theta,
                                  bounds, eps, device="cpu", **kw)
    bag = integrate_family(get_family("gauss_center"), theta, bounds, eps,
                           chunk=1 << 10, capacity=1 << 16, device="cpu")
    rbag = ref_bag(ref_family("gauss_center"), theta, bounds, eps,
                   chunk=1 << 10, capacity=1 << 16)
    ref = ref_walker(ref_family("gauss_center"),
                     ref_family_ds("gauss_center"), theta, bounds, eps,
                     **kw)
    assert np.all(bag.areas > 1e-3)
    for other in (bag, rbag, ref):
        assert np.max(np.abs(got.areas - other.areas)) < 3e-9
        assert abs(got.metrics.tasks - other.metrics.tasks) \
            / other.metrics.tasks < 1e-2
    assert got.walker_fraction > 0.2
    assert np.max(np.abs(got.areas - family_exact(
        "gauss_center", *bounds, theta))) < 1e-6


@pytest.mark.parametrize("refill", list(REFILL))
def test_walker_quad_scaled_is_exact_as_the_reference(monkeypatch, refill):
    # the dyadic-exact family: every credit and sum is exact, so the
    # port's walker, the port's float64 bag and the reference walker
    # give the same areas bit for bit
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    theta = 1.0 + np.arange(8) / 4.0
    bounds, eps = (0.0, 1.0), 1e-9
    kw = dict(KW, **REFILL[refill])
    got = integrate_family_walker(get_family("quad_scaled"),
                                  get_family_ds("quad_scaled"), theta,
                                  bounds, eps, device="cpu", **kw)
    bag = integrate_family(get_family("quad_scaled"), theta, bounds, eps,
                           chunk=1 << 10, capacity=1 << 16, device="cpu")
    ref = ref_walker(ref_family("quad_scaled"), ref_family_ds("quad_scaled"),
                     theta, bounds, eps, **kw)
    assert np.array_equal(got.areas, bag.areas)
    assert np.array_equal(got.areas, ref.areas)
    assert got.metrics.tasks == bag.metrics.tasks == ref.metrics.tasks
    assert got.walker_fraction > 0.5 and got.attribution()["reconciles"]
    assert np.max(np.abs(got.areas - theta / 3.0)) < 1e-6


def _port_bag(eps):
    return integrate_family(get_family(FAM), THETA, BOUNDS, eps,
                            chunk=1 << 10, capacity=1 << 16, device="cpu")


@pytest.mark.parametrize("refill", list(REFILL))
def test_walker_tiny_workload_is_the_bag(refill):
    # eps = 10: the seeds accept in the first breed round, nothing is
    # dealt, and the result is the float64 bag's exactly; eps = 1e-3:
    # breeding peak-stops early, the walker takes part, and the areas
    # hold the ds contract
    kw = dict(KW, **REFILL[refill])
    got = _port(scout_dtype="f32", **REFILL[refill])
    tiny = integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                   THETA, BOUNDS, 10.0, device="cpu", **kw)
    bag = _port_bag(10.0)
    assert tiny.walker_fraction == 0.0 and tiny.kernel_steps == 0
    assert tiny.metrics.tasks == bag.metrics.tasks
    assert np.max(np.abs(tiny.areas - bag.areas)) < 1e-15
    assert got.walker_fraction > 0.5
    shallow = integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                      THETA, BOUNDS, 1e-3, device="cpu",
                                      **kw)
    assert np.max(np.abs(shallow.areas - _port_bag(1e-3).areas)) < 3e-9


@pytest.mark.parametrize("refill", list(REFILL))
def test_walker_mopup_via_forced_suspension(refill):
    # a one-segment step budget suspends nearly every lane mid-walk; the
    # suspended (i, d) sets go back to the bag through _expand_pending
    # over many cycles
    kw = dict(KW, seg_iters=8, max_segments=1, max_cycles=256,
              **REFILL[refill])
    got = integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                  THETA, BOUNDS, EPS, device="cpu", **kw)
    bag = _port_bag(EPS)
    assert got.cycles > 3
    assert np.max(np.abs(got.areas - bag.areas)) < 3e-9
    assert abs(got.metrics.tasks - bag.metrics.tasks) \
        / bag.metrics.tasks < 1e-3


@pytest.mark.parametrize("refill", list(REFILL))
def test_walker_depth_overflow_mopup(monkeypatch, refill):
    # lanes deeper than MAX_REL_DEPTH park as overflowed; their pending
    # nodes are re-derived from (i, d) in float64 and finished by the bag
    # (the reference's tolerance: coordinate rounding flips borderline
    # decisions, so task drift is held to 5%)
    from ppls_tpu_torch.parallel import walker as W
    monkeypatch.setattr(W, "MAX_REL_DEPTH", 4)
    got = integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                  THETA, BOUNDS, EPS, device="cpu",
                                  max_cycles=256,
                                  **dict(KW, **REFILL[refill]))
    bag = _port_bag(EPS)
    assert np.max(np.abs(got.areas - bag.areas)) < 3e-9
    assert abs(got.metrics.tasks - bag.metrics.tasks) \
        / bag.metrics.tasks < 0.05


@pytest.mark.parametrize("over,match", [
    (dict(theta_block=2, refill_slots=0, roots_per_lane=1), "refill_slots"),
    (dict(theta_block=2, rule=Rule.SIMPSON), "TRAPEZOID"),
])
def test_unported_modes_name_their_roadmap_item(over, match):
    # theta blocks are ported; the port refuses what the reference
    # refuses, with the reference's own error
    from ppls_tpu.config import Rule as RefRule
    kw = dict(KW, **over)
    rule = Rule(kw.pop("rule", Rule.TRAPEZOID))
    with pytest.raises(ValueError, match=match) as got:
        integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                THETA[:2], BOUNDS, EPS, rule=rule,
                                device="cpu", **kw)
    with pytest.raises(ValueError, match=match) as ref:
        ref_walker(ref_family(FAM), ref_family_ds(FAM), THETA[:2], BOUNDS,
                   EPS, rule=RefRule(rule.value), **kw)
    assert str(got.value) == str(ref.value)


def test_walker_entry_point_requires_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        integrate_family_walker(get_family(FAM), get_family_ds(FAM), THETA,
                                BOUNDS, EPS, **KW)


def test_walker_refuses_out_of_domain_ds():
    # theta / x = 1e8 is beyond ds_sin's Cody-Waite range
    with pytest.raises(ValueError, match="Cody-Waite"):
        integrate_family_walker(get_family(FAM), get_family_ds(FAM), [1e4],
                                (1e-4, 1.0), EPS, device="cpu", **KW)


# tests/test_tpu_lane.py's real-chip Simpson configuration
S_THETA = 1.0 + np.arange(4) / 4.0
S_EPS = 1e-12
S_KW = dict(capacity=1 << 16, lanes=256, roots_per_lane=1, seg_iters=32,
            min_active_frac=0.05)
S_REFILL = {"boundary": {}, "in-kernel": dict(refill_slots=2,
                                              roots_per_lane=2)}


@pytest.fixture(scope="module")
def simpson_bag():
    return integrate_family(get_family(FAM), S_THETA, BOUNDS, S_EPS,
                            rule=Rule.SIMPSON, chunk=1 << 10,
                            capacity=1 << 16, device="cpu")


def _simpson_walker(refill):
    return integrate_family_walker(
        get_family(FAM), get_family_ds(FAM), S_THETA, BOUNDS, S_EPS,
        rule=Rule.SIMPSON, device="cpu", **dict(S_KW, **S_REFILL[refill]))


@pytest.mark.parametrize("refill", list(S_REFILL))
def test_simpson_walker_matches_simpson_bag(simpson_bag, refill):
    # K1 and K2 in Simpson mode: the float64 Simpson bag's decisions
    # exactly (equal tasks) and its areas within 1e-12, on both refill
    # paths; the walker's evals are the device-counted live lane-steps
    # plus 5 per float64 bag task and per scored root
    got = _simpson_walker(refill)
    assert got.metrics.tasks == simpson_bag.metrics.tasks
    assert np.max(np.abs(got.areas - simpson_bag.areas)) < 1e-12
    assert got.walker_fraction > 0.3
    assert got.attribution()["reconciles"]
    cs = got.cycle_stats
    col = W_FIELDS.index
    btasks = int(cs[:, col("tasks")].sum() - cs[:, col("walker_tasks")].sum())
    srows = int(cs[:, col("sort_rows")].sum())
    assert got.metrics.integrand_evals \
        == 5 * btasks + int(got.waste[0]) + 5 * srows
    assert got.metrics.integrand_evals / got.metrics.tasks < 4.5


def test_simpson_walker_near_reference_walker(monkeypatch, simpson_bag):
    # the reference Simpson walker in interpret mode, at its own test's
    # tolerances (tests/test_walker.py::test_walker_simpson_matches_bag_
    # simpson: the degraded ds flips borderline Simpson decisions)
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    from ppls_tpu.config import Rule as RefRule
    got = _simpson_walker("boundary")
    ref = ref_walker(ref_family(FAM), ref_family_ds(FAM), S_THETA, BOUNDS,
                     S_EPS, rule=RefRule.SIMPSON, **S_KW)
    exact = family_exact(FAM, *BOUNDS, S_THETA)
    assert np.max(np.abs(got.areas - exact)) < 1e-8
    assert np.max(np.abs(got.areas - ref.areas)) < 1e-7
    assert abs(got.metrics.tasks - ref.metrics.tasks) \
        / ref.metrics.tasks < 0.3


def test_simpson_walker_refuses_scouting():
    with pytest.raises(ValueError, match="TRAPEZOID only"):
        _port(rule=Rule.SIMPSON, scout_dtype="f32")
