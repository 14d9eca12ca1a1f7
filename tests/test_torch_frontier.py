"""The single-integral engines of the port against the reference's, on
the CPU: the host-driven wavefront (``runtime/host_frontier.py``), the
device-resident wavefront (``parallel/device_engine.py``), the
single-integral checkpoint container and the integrand registry.

Tolerances: tasks, splits, leaves, rounds, depth, evals and every
per-round record equal the reference's exactly. Areas agree to 1e-14
relative (a few float64 ulps): a round's leaf sum is a ``torch.sum``,
whose order is not XLA's. Within the port (reruns, resumes, host against
device engine) areas are bit-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ppls_tpu import config as RCfg
from ppls_tpu.models import integrands as RI
from ppls_tpu.ops import reduction as RRed
from ppls_tpu.ops import rules as RR
from ppls_tpu.parallel import device_engine as RD
from ppls_tpu.runtime import checkpoint as RC
from ppls_tpu.runtime import host_frontier as RH
from ppls_tpu_torch import config as TCfg
from ppls_tpu_torch.models import integrands as TI
from ppls_tpu_torch.ops import reduction as TRed
from ppls_tpu_torch.ops import rules as TR
from ppls_tpu_torch.parallel import device_engine as TD
from ppls_tpu_torch.runtime import checkpoint as TC
from ppls_tpu_torch.runtime import host_frontier as TH

AREA_REL = 1e-14
CPU = dict(device="cpu")


def _cfgs(name, **over):
    """The same named configuration in both packages."""
    r = getattr(RCfg, name).replace(**over)
    t = getattr(TCfg, name).replace(**over)
    return r, t


def _same_counts(a, b):
    ma, mb = a.metrics, b.metrics
    for k in ("tasks", "splits", "leaves", "rounds", "max_depth",
              "integrand_evals", "tasks_per_chip"):
        assert getattr(ma, k) == getattr(mb, k), k


def _close(a, b):
    assert abs(a - b) <= AREA_REL * abs(b), (a, b)


@pytest.fixture(scope="module")
def golden():
    return RH.integrate(RCfg.REFERENCE_CONFIG), TH.integrate(
        TCfg.REFERENCE_CONFIG, **CPU)


def test_golden_run_matches_reference(golden):
    ref, got = golden
    m = got.metrics
    assert f"{got.area:.6f}" == "7583461.801486"
    assert (m.tasks, m.splits, m.leaves) == (6567, 3283, 3284)
    assert (m.rounds, m.max_depth) == (15, 14)
    assert max(s.frontier_width for s in m.per_round) == 1642
    assert abs(got.global_error - 0.439990) < 1e-5
    assert m.integrand_evals == 6567 * 3
    _same_counts(ref, got)
    _close(got.area, ref.area)
    assert got.exact == ref.exact
    # one device read per round
    assert got.host_syncs == 15


def test_per_round_stats_equal_reference(golden):
    ref, got = golden
    assert [vars(s) for s in got.metrics.per_round] \
        == [vars(s) for s in ref.metrics.per_round]
    assert [s.accept_rate for s in got.metrics.per_round] \
        == [s.accept_rate for s in ref.metrics.per_round]
    assert got.metrics.histogram_str() == ref.metrics.histogram_str()


@pytest.mark.parametrize("name,over", [
    ("REFERENCE_CONFIG", dict(rule=TCfg.Rule.SIMPSON)),
    ("SIN_CONFIG", {}),
    ("OSC_CONFIG", {}),
])
def test_configs_match_reference(name, over):
    r, t = _cfgs(name, **{k: getattr(RCfg.Rule, v.name)
                          for k, v in over.items()})
    t = t.replace(**over)
    ref, got = RH.integrate(r), TH.integrate(t, **CPU)
    _same_counts(ref, got)
    assert [vars(s) for s in got.metrics.per_round] \
        == [vars(s) for s in ref.metrics.per_round]
    _close(got.area, ref.area)
    if name == "SIN_CONFIG":
        assert abs(got.area - got.exact) < 1e-4


def test_simpson_beats_trapezoid_globally(golden):
    _ref, trap = golden
    simp = TH.integrate(TCfg.REFERENCE_CONFIG.replace(
        rule=TCfg.Rule.SIMPSON), **CPU)
    assert simp.global_error < trap.global_error
    assert simp.metrics.tasks < trap.metrics.tasks


def test_runge_adaptive_matches_reference():
    ref = RH.integrate(RCfg.QuadConfig(integrand="runge", a=-1.0, b=1.0,
                                       eps=1e-8, rule=RCfg.Rule.SIMPSON))
    got = TH.integrate(TCfg.QuadConfig(integrand="runge", a=-1.0, b=1.0,
                                       eps=1e-8, rule=TCfg.Rule.SIMPSON),
                       **CPU)
    assert got.global_error < 1e-6
    _same_counts(ref, got)
    _close(got.area, ref.area)


def test_deterministic_and_resumable_midway(golden):
    _ref, full = golden
    again = TH.integrate(TCfg.REFERENCE_CONFIG, **CPU)
    assert again.area == full.area
    saved = {}

    class Stop(Exception):
        pass

    def hook(i, frontier, acc, metrics):
        if i == 5:
            saved.update(frontier=frontier.copy(), acc=acc)
            raise Stop

    with pytest.raises(Stop):
        TH.integrate(TCfg.REFERENCE_CONFIG, on_round=hook, **CPU)
    resumed = TH.integrate(TCfg.REFERENCE_CONFIG, frontier=saved["frontier"],
                           area_acc=saved["acc"], **CPU)
    assert resumed.area == full.area


def test_max_rounds_and_no_card():
    with pytest.raises(RuntimeError, match="max_rounds=3 exceeded"):
        TH.integrate(TCfg.REFERENCE_CONFIG.replace(max_rounds=3), **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TH.integrate(TCfg.REFERENCE_CONFIG)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TD.device_integrate(TCfg.REFERENCE_CONFIG)


# ---------------------------------------------------------------------------
# the device-resident engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,capacity", [(0, 64), (1, 24), (2, 16)])
def test_compact_children_equal_reference(seed, capacity):
    """The scatter-compaction on numpy-seeded lanes, with and without
    dropped children (2 * splits > capacity), equal to the reference's
    bit for bit."""
    rng = np.random.default_rng(seed)
    n = 32
    l = np.sort(rng.uniform(0.0, 1.0, n))
    r = l + rng.uniform(1e-3, 1e-1, n)
    split = rng.random(n) < 0.6
    ref = RD.compact_children(jnp.asarray(l), jnp.asarray(r),
                              jnp.asarray(split), capacity=capacity,
                              fill=0.5)
    got = TD.compact_children(torch.from_numpy(l), torch.from_numpy(r),
                              torch.from_numpy(split), capacity=capacity,
                              fill=0.5)
    assert int(got[3]) == int(ref[3]) == 2 * int(split.sum())
    for a, b in zip(got[:3], ref[:3]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if 2 * split.sum() > capacity:
        assert int(got[2].sum()) == capacity     # the mask stops there


def test_device_engine_matches_reference_and_host(golden):
    _ref, host = golden
    cfg_r, cfg_t = _cfgs("REFERENCE_CONFIG", capacity=4096)
    ref = RD.device_integrate(cfg_r)
    got = TD.device_integrate(cfg_t, **CPU)
    _same_counts(ref, got)
    _close(got.area, ref.area)
    assert got.area == host.area       # the port's two engines, bit-equal
    # 15 rounds: one read of the loop condition (16 rounds per read)
    assert got.host_syncs == 1 and TD.READ_EVERY == 16
    assert got.state is not None and int(got.state.rounds) == 15


def test_device_engine_simpson_sin_matches_reference():
    kw = dict(integrand="sin", a=0.0, b=1.0, eps=1e-8, capacity=1024)
    ref = RD.device_integrate(RCfg.QuadConfig(rule=RCfg.Rule.SIMPSON, **kw))
    got = TD.device_integrate(TCfg.QuadConfig(rule=TCfg.Rule.SIMPSON, **kw),
                              **CPU)
    assert got.global_error < 1e-7
    _same_counts(ref, got)
    _close(got.area, ref.area)


def test_device_engine_overflow_reruns_on_host_or_raises(golden):
    _ref, host = golden
    cfg = TCfg.REFERENCE_CONFIG.replace(capacity=64)
    res = TD.device_integrate(cfg, fallback=True, **CPU)
    assert res.state is None
    assert res.area == host.area and res.metrics.tasks == 6567
    # the device attempt's read plus the host rerun's 15
    assert res.host_syncs == 1 + 15
    with pytest.raises(RuntimeError, match="overflow"):
        TD.device_integrate(cfg, fallback=False, **CPU)


def test_device_engine_deep_overflow_equals_host():
    """OSC_DEEP_CONFIG (peak frontier 13926) overflows 2^12 slots and
    comes back equal to the host engine; OSC_CONFIG's peak (2508) fits
    and runs on the device engine alone."""
    deep = TCfg.OSC_DEEP_CONFIG.replace(capacity=1 << 12)
    host = TH.integrate(deep, **CPU)
    res = TD.device_integrate(deep, **CPU)
    assert res.state is None and res.area == host.area
    assert res.metrics.tasks == host.metrics.tasks == 124539
    osc = TCfg.OSC_CONFIG.replace(capacity=1 << 12)
    dev = TD.device_integrate(osc, **CPU)
    assert dev.state is not None
    assert dev.area == TH.integrate(osc, **CPU).area


def test_initial_state_and_round_body_equal_reference():
    """The seeded frontier and three rounds of ``round_body`` on it, field
    for field against the reference's (the accumulator through
    ``kahan_init`` and ``masked_sum``); CUDA is the default device."""
    f_r = RI.get_integrand("cosh4").fn
    f_t = TI.get_integrand("cosh4").fn
    ref = RD.initial_state(0.0, 5.0, 64)
    got = TD.initial_state(0.0, 5.0, 64, **CPU)
    for _ in range(4):
        for k in TD.DeviceState.__dataclass_fields__:
            a, b = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
            if k in ("acc_s", "acc_c"):
                assert abs(float(a) - float(b)) <= AREA_REL * abs(float(b))
            else:
                assert np.array_equal(a, b), k
        ref = RD.round_body(ref, f_r, 1e-3, RCfg.Rule.TRAPEZOID, 64, 2.5)
        got = TD.round_body(got, f_t, 1e-3, TCfg.Rule.TRAPEZOID, 64, 2.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TD.initial_state(0.0, 5.0, 64)


@pytest.mark.parametrize("rule", ["trapezoid", "simpson"])
@pytest.mark.parametrize("name,l,r,eps", [
    ("cosh4", 0.0, 5.0, 1e-3), ("cosh4", 2.5, 2.5 + 2.0 ** -12, 1e-3),
    ("sin_recip", 1e-4, 1e-3, 1e-10), ("runge", -1.0, 0.25, 1e-6)])
def test_eval_interval_matches_reference(rule, name, l, r, eps):
    """One interval scored by both packages: value and error within
    1e-14 relative (the same float64 operations in the same order; the
    integrands' libm calls may differ in the last bit), the split
    decision equal. CUDA is the default device."""
    rv, re, rs = RR.eval_interval(l, r, RI.get_integrand(name).fn, eps,
                                  RCfg.Rule(rule))
    tv, te, ts = TR.eval_interval(l, r, TI.get_integrand(name).fn, eps,
                                  TCfg.Rule(rule), **CPU)
    assert tv.dtype == torch.float64 and tv.shape == ()
    assert abs(float(tv) - float(rv)) <= AREA_REL * abs(float(rv))
    assert abs(float(te) - float(re)) <= AREA_REL * abs(float(rv))
    assert bool(ts) == bool(rs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TR.eval_interval(l, r, TI.get_integrand(name).fn, eps)


@pytest.mark.parametrize("seed", [0, 1])
def test_reduction_helpers_match_reference(seed):
    """``masked_sum``, and ``kahan_init``/``kahan_add``/``kahan_sum``
    over 64 numpy-seeded rounds of mixed magnitude, against the
    reference's: the masked sums within 1e-15 relative (torch.sum and
    XLA's sum order their additions differently), the compensated
    totals within 1e-15 of each other and of math.fsum."""
    import math
    rng = np.random.default_rng(seed)
    rs, ts = RRed.kahan_init(), TRed.kahan_init(**CPU)
    assert float(ts[0]) == float(ts[1]) == 0.0
    total = []
    for _ in range(64):
        v = rng.standard_normal(256) * 10.0 ** rng.integers(-8, 9, 256)
        m = rng.random(256) < 0.5
        ref = RRed.masked_sum(jnp.asarray(v), jnp.asarray(m))
        got = TRed.masked_sum(torch.from_numpy(v), torch.from_numpy(m))
        exact = math.fsum(v[m])
        assert abs(float(got) - float(ref)) <= 1e-15 * np.abs(v[m]).sum()
        rs = RRed.kahan_add(rs, jnp.asarray(exact))
        ts = TRed.kahan_add(ts, torch.tensor(exact, dtype=torch.float64))
        total.append(exact)
    assert float(TRed.kahan_sum(ts)) == float(RRed.kahan_sum(rs))
    assert abs(float(TRed.kahan_sum(ts)) - math.fsum(total)) <= \
        1e-15 * abs(math.fsum(total))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TRed.kahan_init()


def test_run_metrics_json_matches_reference(golden):
    """``RunMetrics.to_json`` of the golden run: the reference's keys and
    values, apart from the wall clock and the rate derived from it."""
    import json
    ref, got = golden
    a, b = json.loads(ref.metrics.to_json()), json.loads(
        got.metrics.to_json())
    assert set(a) == set(b)
    for k in set(a) - {"wall_time_s", "evals_per_sec_per_chip"}:
        assert a[k] == b[k], k
    assert b["evals_per_sec_per_chip"] == \
        got.metrics.evals_per_sec_per_chip


def test_device_rounds_stop_at_max_rounds():
    with pytest.raises(RuntimeError, match="max_rounds=5 exceeded"):
        TD.device_integrate(TCfg.REFERENCE_CONFIG.replace(
            max_rounds=5, capacity=4096), **CPU)


# ---------------------------------------------------------------------------
# the single-integral checkpoint (tests/test_checkpoint.py's cases)
# ---------------------------------------------------------------------------

def test_save_load_roundtrip_and_reference_reads_it(tmp_path):
    from ppls_tpu_torch.utils.metrics import RoundStats, RunMetrics
    path = str(tmp_path / "run.ckpt")
    frontier = np.array([[0.0, 1.0], [1.0, 2.5]])
    m = RunMetrics()
    m.record_round(RoundStats(round_index=0, frontier_width=1, splits=1,
                              leaves=0, padded_width=256))
    TC.save_checkpoint(path, frontier, (1.5, -2e-17), m)
    for load in (TC.load_checkpoint, RC.load_checkpoint):
        f2, (s, c), m2, cfg2 = load(path)
        np.testing.assert_array_equal(f2, frontier)
        assert (s, c) == (1.5, -2e-17)
        assert m2.tasks == m.tasks and m2.rounds == m.rounds
        assert m2.per_round[0].frontier_width == 1
        assert cfg2 is None


def _interrupted(tmp_path, integrate, ck, cfg, **kw):
    path = str(tmp_path / "run.ckpt")

    class Interrupt(Exception):
        pass

    ckpt = ck.Checkpointer(path, config=cfg)

    def hook(i, frontier, acc, metrics):
        ckpt.hook(i, frontier, acc, metrics)
        if i == 7:
            raise Interrupt

    with pytest.raises(Interrupt):
        integrate(cfg, on_round=hook, **kw)
    return path


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_interrupt_and_resume_exact_across_packages(tmp_path, golden,
                                                    writer):
    """A snapshot after round 7, written by either package, resumed by
    both: each resume is bit-equal to its own package's uninterrupted
    run (the frontier is the same, and the accumulator pair carries
    over)."""
    ref_full, port_full = golden
    if writer == "port":
        path = _interrupted(tmp_path, TH.integrate, TC,
                            TCfg.REFERENCE_CONFIG, **CPU)
    else:
        path = _interrupted(tmp_path, RH.integrate, RC,
                            RCfg.REFERENCE_CONFIG)
    got = TC.resume(path, TCfg.REFERENCE_CONFIG, **CPU)
    ref = RC.resume(path, RCfg.REFERENCE_CONFIG)
    assert got.area == port_full.area and ref.area == ref_full.area
    for r in (got, ref):
        assert r.metrics.tasks == 6567 and r.metrics.rounds == 15


def test_resume_rejects_mismatched_config(tmp_path):
    path = str(tmp_path / "run.ckpt")
    ckpt = TC.Checkpointer(path, config=TCfg.REFERENCE_CONFIG)
    TH.integrate(TCfg.REFERENCE_CONFIG, on_round=ckpt.hook, **CPU)
    with pytest.raises(ValueError, match="different problem"):
        TC.resume(path, TCfg.REFERENCE_CONFIG.replace(eps=1e-6), **CPU)
    with pytest.raises(ValueError, match="different problem"):
        TC.resume(path, TCfg.REFERENCE_CONFIG.replace(integrand="sin"),
                  **CPU)


def test_resume_finished_run_warns(tmp_path, golden):
    _ref, full = golden
    path = str(tmp_path / "run.ckpt")
    ckpt = TC.Checkpointer(path, config=TCfg.REFERENCE_CONFIG)
    TH.integrate(TCfg.REFERENCE_CONFIG, on_round=ckpt.hook, **CPU)
    with pytest.warns(UserWarning, match="empty frontier"):
        res = TC.resume(path, TCfg.REFERENCE_CONFIG, **CPU)
    assert res.area == full.area


# ---------------------------------------------------------------------------
# the integrand registry
# ---------------------------------------------------------------------------

BOUNDS = {"cosh4": (0.0, 5.0), "sin": (0.0, 1.0), "sin_recip": (1e-4, 1.0),
          "gauss_peak": (0.0, 1.0), "poly3": (0.0, 2.0), "exp": (0.0, 1.0),
          "runge": (-1.0, 1.0)}


def test_registry_names_and_lookup():
    assert set(BOUNDS) <= set(TI.INTEGRANDS)
    assert set(RI.INTEGRANDS) - set(TI.INTEGRANDS) == set()
    with pytest.raises(KeyError, match="unknown integrand"):
        TI.get_integrand("nope")
    e = TI.register_integrand("_test_sq", lambda x: x * x,
                              lambda x: x ** 3 / 3.0)
    try:
        assert TI.get_integrand("_test_sq") is e and e.exact(0, 3) == 9.0
    finally:
        del TI.INTEGRANDS["_test_sq"]


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_integrand_values_and_exact_match_reference(name):
    """Values on numpy-seeded points within 4 float64 ulps of the
    reference's (cosh4: 16, the fourth power multiplies the two
    libraries' cosh rounding by 4); closed forms within 1e-13 relative
    (sin_recip: scipy's cosine integral against the reference's
    40-digit mpmath)."""
    a, b = BOUNDS[name]
    x = np.random.default_rng(7).uniform(a, b, 257)
    x[0] = max(a, 1e-4)
    got = TI.get_integrand(name).fn(torch.from_numpy(x)).numpy()
    ref = np.asarray(RI.get_integrand(name).fn(jnp.asarray(x)))
    # XLA on the CPU flushes subnormal results to zero, PyTorch keeps
    # them: below the smallest normal only the absolute gap is held
    tiny = np.finfo(np.float64).tiny
    normal = np.abs(ref) >= tiny
    np.testing.assert_array_max_ulp(
        got[normal], ref[normal], maxulp=16 if name == "cosh4" else 4)
    assert np.all(np.abs(got[~normal] - ref[~normal]) < tiny)
    e_got = TI.get_integrand(name).exact(a, b)
    e_ref = RI.get_integrand(name).exact(a, b)
    assert abs(e_got - e_ref) <= 1e-13 * abs(e_ref)
    if name == "sin_recip":
        for lo in (1e-4, 1e-3, 0.5):
            r = RI.get_integrand(name).exact(lo, 1.0)
            assert abs(TI.get_integrand(name).exact(lo, 1.0) - r) \
                <= 1e-13 * abs(r)
        with pytest.raises(ValueError):
            TI.get_integrand(name).exact(-1.0, 1.0)
