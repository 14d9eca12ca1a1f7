"""The many-theta walker (``theta_block`` = T > 1) of the port against
the reference, on the CPU.

Groups of T adjacent lanes walk one interval with T thetas; a node
splits when any unretired theta fails its own test (the union vote), a
theta whose own test passed credits there and retires for the subtree,
and credit lands in m * T accumulators. Held here, on numpy-seeded
inputs carried to both packages:

* the ``sin_scaled`` family: float64 form, ds and scout twins bit-equal
  to the reference's run op by op, closed form;
* the theta helpers: the same errors and messages, the same votes and
  retire masks, a bit-equal theta deal, the union-refinement float64
  drain (equal tasks and splits, areas within 1e-13);
* the plain theta segment against the reference kernel in interpret
  mode (``run_segment_rf(theta_block=8)``);
* the whole slice at tests/test_theta_walker.py's configuration (T = 8,
  sin(theta x) on [0, 1], eps 1e-6, 256 lanes, R = 2): the per-theta
  quality contract against the port's own solo runs, the reference
  walker's schedule (equal tasks, kernel steps and waste) and areas,
  tasks == splits + leaves, reconciling waste with a live
  theta_overwalk bucket, a bit-identical rerun, scouting and
  double-buffered banks within 1e-9 of the plain theta run.

The reference runs with the tuning table off and in interpret mode,
where XLA degrades its ds arithmetic toward float32: on this
configuration its areas sit up to 1.35e-9 from a plain float64 sum over
the same per-theta leaf sets, the port's within 2.2e-14 (measured). So
the port is held to that float64 sum at 1e-13, and to the reference at
the walker contract's 3e-9 (tests/test_walker.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu.config import Rule as RefRule
from ppls_tpu.models import integrands as RI
from ppls_tpu.ops import ds_kernel as jdk
from ppls_tpu.ops import scout_kernel as jsk
from ppls_tpu.parallel import walker as RW
from ppls_tpu.parallel.bag_engine import initial_bag as ref_initial_bag
from ppls_tpu_torch import interop
from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models import integrands as TI
from ppls_tpu_torch.ops import ds_kernel as tdk
from ppls_tpu_torch.ops import scout_kernel as tsk
from ppls_tpu_torch.parallel import walker as TW
from ppls_tpu_torch.parallel.bag_engine import initial_bag

FAM = "sin_scaled"
B = (0.0, 1.0)
EPS = 1e-6
T = 8
KW = dict(capacity=1 << 16, lanes=256, roots_per_lane=2, refill_slots=2,
          seg_iters=2048, min_active_frac=0.05)
TH = np.linspace(1.0, 4.0, T).reshape(1, T)
N = 4096


def _leaf_sums(thetas, eps, n_roots=64):
    """Each theta's area over the leaf set the theta walk credits it:
    split-only breeding to ``n_roots`` equal roots, then its own
    trapezoid test top-down, all in float64."""
    out = []
    for t in np.asarray(thetas, dtype=np.float64).reshape(-1):
        l = np.arange(n_roots) / n_roots
        r = l + 1.0 / n_roots
        area = 0.0
        while l.size:
            mid = (l + r) * 0.5
            fl, fm, fr = np.sin(t * l), np.sin(t * mid), np.sin(t * r)
            val = (fl + fm) * ((mid - l) * 0.5) + (fm + fr) * ((r - mid) * 0.5)
            split = np.abs(val - (fl + fr) * ((r - l) * 0.5)) > eps
            area += val[~split].sum()
            l, r = (np.concatenate([l[split], mid[split]]),
                    np.concatenate([mid[split], r[split]]))
        out.append(area)
    return np.asarray(out)


def _port(theta=TH, eps=EPS, **over):
    return TW.integrate_family_walker(
        TI.get_family(FAM), TI.get_family_ds(FAM), theta, B, eps,
        device="cpu", **dict(KW, theta_block=T, **over))


def _ref(eps=EPS, **over):
    return RW.integrate_family_walker(
        RI.get_family(FAM), RI.get_family_ds(FAM), TH, B, eps,
        **dict(KW, theta_block=T, **over))


# --- the sin_scaled family ----------------------------------------------


def _pair(x):
    hi = x.astype(np.float32)
    return hi, (x - hi.astype(np.float64)).astype(np.float32)


def test_sin_scaled_float64_and_closed_form():
    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 1.0, N)
    th = rng.uniform(1.0, 4.0, N)
    got = TI.get_family(FAM)(torch.from_numpy(x), torch.from_numpy(th))
    ref = np.asarray(RI.get_family(FAM)(jnp.asarray(x), jnp.asarray(th)))
    assert np.max(np.abs(got.numpy() - ref)) <= 2e-16
    assert np.max(np.abs(got.numpy() - np.sin(th * x))) <= 2e-16
    thetas = np.linspace(0.0, 4.0, 33).reshape(3, 11)
    assert np.array_equal(
        TI.family_exact(FAM, 0.0, 1.0, thetas),
        np.asarray(RI._sin_scaled_exact_vec(0.0, 1.0, thetas)))
    assert TI.family_exact(FAM, 0.0, 1.0, [0.0])[0] == 0.0


def test_sin_scaled_ds_and_scout_twins_bit_equal_to_reference():
    # run op by op (eager jax), the reference's twins round exactly as
    # the port's do; the kernel's integrand id is the header's
    rng = np.random.default_rng(12)
    x = _pair(rng.uniform(0.0, 1.0, N))
    th = _pair(rng.uniform(1.0, 4.0, N))
    f_ds, r_ds = TI.get_family_ds(FAM), RI.get_family_ds(FAM)
    assert f_ds.kernel_family == TI.KERNEL_SIN_SCALED == 2
    t = lambda p: tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in p)
    j = lambda p: tuple(jnp.asarray(v) for v in p)
    for dsm_t, dsm_j in ((tdk, jdk), (tsk, jsk)):
        if dsm_t is tsk:
            x, th = (x[0], 0 * x[1]), (th[0], 0 * th[1])
        got = f_ds(t(x), t(th), dsm=dsm_t)
        ref = r_ds(j(x), j(th), dsm=dsm_j)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy().view(np.int32),
                                  np.asarray(r).view(np.int32))
    val = got[0].numpy().astype(np.float64)
    assert np.max(np.abs(val - np.sin(th[0].astype(np.float64)
                                      * x[0].astype(np.float64)))) < 2e-6


def test_sin_scaled_domain_check_matches_reference():
    for bounds, theta in (((0.0, 1.0), [4.0]), ((0.0, 2e6), [4.0])):
        b = np.asarray([bounds], dtype=np.float64)
        th = np.asarray(theta, dtype=np.float64)
        err = []
        for fn in (TI._sin_scaled_domain, RI._sin_scaled_domain):
            try:
                fn(b, th)
                err.append(None)
            except ValueError as e:
                err.append(str(e).split(" (")[0])
        assert err[0] == err[1]
    with pytest.raises(ValueError, match="Cody-Waite"):
        TI.check_ds_domain(TI.get_family_ds(FAM), [[0.0, 2e6]], [4.0])


# --- the theta helpers ---------------------------------------------------


@pytest.mark.parametrize("T_,lanes,R,rule,m", [
    (6, 256, 2, "trapezoid", 1),          # not a power of two
    (512, 256, 2, "trapezoid", 1),        # does not divide lanes
    (8, 256, 0, "trapezoid", 1),          # boundary refill
    (8, 256, 2, "simpson", 1),            # Simpson
    (2048, 4096, 2, "trapezoid", 64),     # m * T beyond the fam field
    (0, 256, 2, "trapezoid", 1),
])
def test_validate_theta_block_same_errors(T_, lanes, R, rule, m):
    msgs = []
    for fn, rl in ((TW.validate_theta_block, Rule(rule)),
                   (RW.validate_theta_block, RefRule(rule))):
        with pytest.raises(ValueError) as e:
            fn(T_, lanes=lanes, refill_slots=R, rule=rl, m=m)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert TW.validate_theta_block(1, lanes=256, refill_slots=0,
                                   rule=Rule.SIMPSON, m=1) == 1


@pytest.mark.parametrize("theta,T_", [
    ([1.0, 2.0, 3.0], 1), ([1.0, 2.0], 2), ([[1.0, 2.0], [3.0, 4.0]], 2),
    ([1.0, 2.0, 3.0], 2), ([[1.0, 2.0, 3.0]], 2),
])
def test_normalize_theta_batch_same_results(theta, T_):
    try:
        want = RW.normalize_theta_batch(theta, T_)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TW.normalize_theta_batch(theta, T_)
        assert str(got.value) == str(e)
        return
    got = TW.normalize_theta_batch(theta, T_)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert TW.theta_drain_chunk(1 << 15, T_) == RW.theta_drain_chunk(
        1 << 15, T_)
    assert TW.theta_breed_target(4096, 8, 2048, T_) == \
        RW.theta_breed_target(4096, 8, 2048, T_)


@pytest.mark.parametrize("T_", [2, 8, 64, 256])
def test_group_any_and_theta_retired_match_reference(T_):
    rng = np.random.default_rng(T_)
    lanes = 512
    mask = rng.random((lanes // 128, 128)) < 0.05
    got = TW._group_any(torch.from_numpy(mask.reshape(-1)), T_)
    ref = np.asarray(RW._group_any(jnp.asarray(mask), T_))
    assert np.array_equal(interop.lanes_to_numpy(got), ref)
    # retire markers: the node (i, d) against (mk_i, mk_d), ancestors,
    # stale markers and unset ones
    fields = [np.array(x) for x in jax.device_get(
        tuple(RW._fresh_lanes(lanes)))]
    f = {n: j for j, n in enumerate(RW.WalkState._fields)}
    d = rng.integers(0, 31, lanes)
    i = rng.integers(0, 1 << 20, lanes) % (1 << d)
    mk_d = rng.integers(-1, 31, lanes)
    shift = np.clip(d - mk_d, 0, 31)
    mk_i = np.where(rng.random(lanes) < 0.5, i >> shift,
                    rng.integers(0, 1 << 10, lanes))
    for name, v in (("i", i), ("d", d), ("mk_i", mk_i), ("mk_d", mk_d)):
        fields[f[name]] = v.astype(np.int32).reshape(-1, 128)
    ret_ref = np.asarray(RW._theta_retired(
        RW.WalkState(*(jnp.asarray(x) for x in fields))))
    ret = TW._theta_retired(interop.walk_state_from_numpy(fields))
    assert np.array_equal(interop.lanes_to_numpy(ret), ret_ref)
    assert 0 < int(ret.sum()) < lanes


def _frontier_bag(rng, count, m, lanes=256):
    """A frontier bag in the reference layout: ``count`` live rows of m
    slots (fam < m), with the slot's representative theta."""
    bag = jax.device_get(ref_initial_bag(
        np.tile([[0.0, 1.0]], (m, 1)), 4096, m * T, 512,
        theta=np.linspace(1.0, 4.0, m)))
    cols = bag._asdict()
    n = cols["bag_l"].shape[0]
    l = rng.uniform(0.0, 0.9, n)
    cols["bag_l"] = l
    cols["bag_r"] = l + rng.uniform(1e-4, 0.1, n)
    cols["bag_th"] = rng.uniform(1.0, 4.0, n)
    cols["bag_meta"] = ((rng.integers(0, m, n) << 14)
                        + rng.integers(0, 30, n)).astype(np.int32)
    cols["count"] = np.int32(count)
    return cols


@pytest.mark.parametrize("count,offset,min_active,R", [
    (1000, 0, 3, 4),        # a full deal: 4 slots x 32 groups
    (50, 0, 3, 4),          # a partial deal (50 of 128 roots)
    (300, 170, 3, 2),       # a shadow half behind an offset
    (2, 0, 3, 4),           # below the engagement floor: nothing dealt
])
def test_deal_root_bank_theta_bit_equal_to_reference(count, offset,
                                                     min_active, R):
    rng = np.random.default_rng(count)
    m = 5
    cols = _frontier_bag(rng, count, m)
    table = rng.uniform(1.0, 4.0, (m, T))
    ref = jax.device_get(RW.deal_root_bank(
        RW.BagState(**{k: jnp.asarray(v) for k, v in cols.items()}),
        refill_slots=R, lanes=256, min_active=min_active, offset=offset,
        theta_block=T, theta_table=jnp.asarray(table)))
    got = TW.deal_root_bank(
        interop.bag_state_from_numpy(cols), refill_slots=R, lanes=256,
        min_active=min_active, offset=offset, theta_block=T,
        theta_table=interop.theta_table_from_numpy(table))
    for g, r in zip(interop.bank_to_numpy(got[0]), ref[0]):
        assert np.array_equal(g.view(np.int32), r.view(np.int32))
    assert np.array_equal(interop.lanes_to_numpy(got[1]), ref[1])
    assert got[2] == int(ref[2])
    for g, r in zip(got[3], ref[3]):
        assert np.array_equal(g.numpy(), np.asarray(r))
    # a group holds one root per slot, replicated over its T lanes
    nsl = got[1].reshape(-1, T)
    assert bool((nsl == nsl[:, :1]).all())


def test_run_theta_bag_matches_reference():
    # the union-refinement float64 drain from the seed rows of 3 slots of
    # T thetas each: equal tasks (rows x T), splits (per-theta failures)
    # and rounds, areas within 1e-13
    m, chunk, cap = 3, 64, 1 << 14
    table = np.linspace(1.0, 4.0, m * T).reshape(m, T)
    bounds = np.tile([[0.0, 1.0]], (m, 1))
    ref = jax.device_get(RW._run_theta_bag(
        ref_initial_bag(bounds, cap, m * T, chunk, theta=table[:, 0]),
        theta_table=jnp.asarray(table), theta_block=T,
        f_theta=RI.get_family(FAM), eps=EPS, chunk=chunk, capacity=cap,
        max_iters=1 << 20))
    syncs = TW.HostSyncs()
    got = TW._run_theta_bag(
        initial_bag(bounds, cap, m * T, chunk, theta=table[:, 0],
                    device="cpu"),
        theta_table=interop.theta_table_from_numpy(table), theta_block=T,
        f_theta=TI.get_family(FAM), eps=EPS, chunk=chunk, capacity=cap,
        max_iters=1 << 20, syncs=syncs)
    assert got.count == int(ref.count) == 0
    assert (got.tasks, got.splits, got.iters) == (
        int(ref.tasks), int(ref.splits), int(ref.iters))
    assert got.tasks % T == 0 and got.splits > 0
    assert np.max(np.abs(got.acc.numpy() - np.asarray(ref.acc))) < 1e-13
    exact = TI.family_exact(FAM, 0.0, 1.0, table).reshape(-1)
    assert np.max(np.abs(got.acc.numpy() - exact)) < 1e-4
    assert syncs.n == got.iters              # one read per round


# In interpret mode XLA contracts the kernel's float32 multiply-adds and
# degrades ds toward float32 (tests/test_torch_walk_segment.py); on the
# theta deal of sin(theta x) below every lane decides alike in both modes
# (seeds of the theta table checked: this one and 0-3), so integer
# fields, the slot cursors and every counter are held equal.
@pytest.mark.parametrize("scout", [False, True])
def test_plain_theta_segment_matches_reference_kernel(scout):
    cap = 64
    base = TW.first_phase_inputs(
        TI.get_family(FAM), np.linspace(1.0, 4.0, 4 * T).reshape(4, T), B,
        1e-9, lanes=256, roots_per_lane=2, refill_slots=2, capacity=1 << 16,
        scout=scout, min_active_frac=0.05, theta_block=T, device="cpu")
    state = interop.walk_state_to_numpy(base["state"])
    bank = interop.bank_to_numpy(base["bank"])
    nslots = interop.lanes_to_numpy(base["nslots"])
    slot0 = np.zeros_like(nslots)
    resm = tuple(interop.lanes_to_numpy(t) for t in base["resm"])
    run = RW.make_walk_kernel(RI.get_family_ds(FAM), 1e-9, cap,
                              interpret=True, refill_slots=2, scout=scout,
                              theta_block=T)
    (r_state, r_slot, r_resh, r_resl, _r_resm, r_steps, r_waste,
     r_evals) = jax.device_get(run(
         RW.WalkState(*(jnp.asarray(x) for x in state)), jnp.asarray(slot0),
         jnp.int32(base["thresh"]), jnp.int32(cap), jnp.int32(base["batch"]),
         jnp.asarray(nslots), tuple(jnp.asarray(x) for x in bank),
         tuple(jnp.asarray(x) for x in resm)))

    resh, resl, ctr = TW.run_segment_rf(
        base["state"], base["slot"], base["thresh"], cap, base["batch"],
        base["nslots"], base["bank"], base["resm"],
        f_ds=TI.get_family_ds(FAM), eps=1e-9, scout=scout, theta_block=T)
    ctr = ctr.tolist()
    assert ctr[0] == int(r_steps) == cap
    assert ctr[1:6] == [int(v) for v in r_waste]
    assert ctr[5] > 0                       # retired lanes walked on
    assert ctr[6:8] == [int(v) for v in r_evals]
    assert np.array_equal(interop.lanes_to_numpy(base["slot"]), r_slot)
    got = interop.walk_state_to_numpy(base["state"])
    for j, name in enumerate(TW.WalkState._fields):
        if j >= TW.N_F32_FIELDS:
            assert np.array_equal(got[j], r_state[j]), name
    for f in ("acc", "fl", "fr"):
        k = TW.WalkState._fields.index(f + "_h")
        v = got[k].astype(np.float64) + got[k + 1].astype(np.float64)
        rv = (r_state[k].astype(np.float64)
              + r_state[k + 1].astype(np.float64))
        assert np.max(np.abs(v - rv)) <= 1e-7 * max(1.0, np.abs(rv).max())
    v = interop.lanes_to_numpy(resh).astype(np.float64) \
        + interop.lanes_to_numpy(resl)
    assert np.max(np.abs(v - (r_resh.astype(np.float64) + r_resl))) < 1e-7


# --- the whole slice -------------------------------------------------------


@pytest.fixture(scope="module")
def ref_runs():
    """The reference walker at T = 8: eps 1e-6 and 1e-7 (two calls)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PPLS_TUNING_TABLE", "off")
    try:
        return {eps: _ref(eps) for eps in (EPS, 1e-7)}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_base():
    return _port()


def test_theta_slice_matches_reference_walker(ref_runs, port_base):
    got, ref = port_base, ref_runs[EPS]
    assert got.areas.shape == ref.areas.shape == (1, T)
    assert np.max(np.abs(got.areas[0] - _leaf_sums(TH, EPS))) < 1e-13
    assert np.max(np.abs(got.areas - ref.areas)) < 3e-9
    assert abs(got.metrics.tasks - ref.metrics.tasks) \
        / ref.metrics.tasks < 1e-3
    assert got.metrics.tasks == got.metrics.splits + got.metrics.leaves
    # the port walks the reference's schedule here
    assert got.kernel_steps == ref.kernel_steps
    assert np.array_equal(got.waste, ref.waste)
    assert got.attribution()["reconciles"]
    exact = TI.family_exact(FAM, *B, TH)
    assert np.max(np.abs(got.areas - exact)) < 1e-4


def test_theta_waste_reconciles_with_live_overwalk(ref_runs):
    got = _port(eps=1e-7)
    att = got.attribution()
    assert att["reconciles"]
    assert int(got.waste.sum()) == got.kernel_steps * got.lanes
    assert int(got.waste[4]) > 0
    assert np.array_equal(got.waste, ref_runs[1e-7].waste)
    assert np.max(np.abs(got.areas[0] - _leaf_sums(TH, 1e-7))) < 1e-13
    assert np.max(np.abs(got.areas - ref_runs[1e-7].areas)) < 3e-9
    solo = TW.integrate_family_walker(
        TI.get_family(FAM), TI.get_family_ds(FAM), [1.5], B, 1e-7,
        device="cpu", **KW)
    assert int(solo.waste[4]) == 0 and solo.attribution()["reconciles"]


def test_theta_per_theta_quality_against_solo_runs():
    # each theta's batched leaf set is at least as refined as its solo
    # run's: batched error vs exact <= solo error + eps
    rng = np.random.default_rng(1337)
    th = np.sort(rng.uniform(1.0, 4.0, T))
    r = _port(theta=th.reshape(1, T))
    ex = TI.family_exact(FAM, *B, th)
    solo = np.array([TW.integrate_family_walker(
        TI.get_family(FAM), TI.get_family_ds(FAM), [t], B, EPS,
        device="cpu", **KW).areas[0] for t in th])
    solo_err = np.abs(solo - ex)
    batched_err = np.abs(r.areas[0] - ex)
    assert np.all(batched_err <= solo_err + EPS), (batched_err, solo_err)
    assert np.all(np.abs(r.areas[0] - solo) <= solo_err + EPS)


def test_theta_rerun_bit_identical(port_base):
    again = _port()
    assert np.array_equal(again.areas, port_base.areas)
    assert again.metrics.tasks == port_base.metrics.tasks
    assert np.array_equal(again.waste, port_base.waste)


def test_theta_scout_and_double_buffer_compose(port_base):
    sc = _port(scout_dtype="f32")
    db = _port(double_buffer=True)
    assert np.max(np.abs(port_base.areas - sc.areas)) <= 1e-9
    assert np.max(np.abs(port_base.areas - db.areas)) <= 1e-9
    assert sc.scout_evals > 0
    assert sc.attribution()["reconciles"] and db.attribution()["reconciles"]


def test_theta_budget_expiry_mid_root_raises():
    # a one-launch step budget suspends theta lanes mid-root: their
    # retired lanes' markers cannot go back to the bag, so the run stops
    # with the reference's overflow error
    with pytest.raises(RuntimeError, match="step budget"):
        _port(seg_iters=4, max_segments=1)
