"""The whole slice: the port's ``integrate_family_walker`` against the
reference walker and the reference float64 bag engine, at the small
shapes of tests/test_scout_double_buffer.py (8 thetas of
sin(theta / x) on [1e-2, 1], eps 1e-7, 256 lanes, R = 2).

The reference's own walker contract, held for the port in every
scout / double-buffer mode: areas within 3e-9 of the float64 bag and of
the reference walker, task drift below 1e-3, tasks == splits + leaves,
the waste buckets reconciling to lanes x kernel steps, and a rerun
bit-identical. The reference resolves its cadence with the tuning table
off, so both sides use the hand-tuned defaults. One test runs four
members at the flagship's own bounds and eps, where the scout schedule
over-refines in the reference as in the port.
"""

import numpy as np
import pytest
import torch

from ppls_tpu.models.integrands import get_family as ref_family
from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
from ppls_tpu.parallel.bag_engine import integrate_family as ref_bag
from ppls_tpu.parallel.walker import integrate_family_walker as ref_walker
from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import get_family, get_family_ds
from ppls_tpu_torch.parallel.bag_engine import integrate_family
from ppls_tpu_torch.parallel.walker import integrate_family_walker

FAM = "sin_recip_scaled"
THETA = 1.0 + np.arange(8) / 8.0
BOUNDS = (1e-2, 1.0)
EPS = 1e-7
KW = dict(capacity=1 << 16, lanes=256, roots_per_lane=2, refill_slots=2,
          seg_iters=32, min_active_frac=0.05)


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


def _port_bag(eps):
    return integrate_family(get_family(FAM), THETA, BOUNDS, eps,
                            chunk=1 << 10, capacity=1 << 16, device="cpu")


def test_walker_tiny_workload_is_the_bag():
    # eps = 10: the seeds accept in the first breed round, nothing is
    # dealt, and the result is the float64 bag's exactly
    got = _port(scout_dtype="f32")
    tiny = integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                   THETA, BOUNDS, 10.0, device="cpu", **KW)
    bag = _port_bag(10.0)
    assert tiny.walker_fraction == 0.0 and tiny.kernel_steps == 0
    assert tiny.metrics.tasks == bag.metrics.tasks
    assert np.max(np.abs(tiny.areas - bag.areas)) < 1e-15
    assert got.walker_fraction > 0.5


def test_walker_mopup_via_forced_suspension():
    # a one-segment step budget suspends nearly every lane mid-walk; the
    # suspended (i, d) sets go back to the bag through _expand_pending
    # over many cycles
    kw = dict(KW, seg_iters=8, max_segments=1, max_cycles=256)
    got = integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                  THETA, BOUNDS, EPS, device="cpu", **kw)
    bag = _port_bag(EPS)
    assert got.cycles > 3
    assert np.max(np.abs(got.areas - bag.areas)) < 3e-9
    assert abs(got.metrics.tasks - bag.metrics.tasks) \
        / bag.metrics.tasks < 1e-3


def test_walker_depth_overflow_mopup(monkeypatch):
    # lanes deeper than MAX_REL_DEPTH park as overflowed; their pending
    # nodes are re-derived from (i, d) in float64 and finished by the bag
    # (the reference's tolerance: coordinate rounding flips borderline
    # decisions, so task drift is held to 5%)
    from ppls_tpu_torch.parallel import walker as W
    monkeypatch.setattr(W, "MAX_REL_DEPTH", 4)
    got = integrate_family_walker(get_family(FAM), get_family_ds(FAM),
                                  THETA, BOUNDS, EPS, device="cpu",
                                  max_cycles=256, **KW)
    bag = _port_bag(EPS)
    assert np.max(np.abs(got.areas - bag.areas)) < 3e-9
    assert abs(got.metrics.tasks - bag.metrics.tasks) \
        / bag.metrics.tasks < 0.05


@pytest.mark.parametrize("over,match", [
    (dict(rule=Rule.SIMPSON), "Simpson"),
    (dict(theta_block=2), "theta_block"),
    (dict(refill_slots=0), "refill_slots=0"),
])
def test_unported_modes_name_their_roadmap_item(over, match):
    with pytest.raises(NotImplementedError, match=match) as e:
        _port(**over)
    assert "ROADMAP" in str(e.value)


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
