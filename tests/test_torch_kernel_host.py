"""The walk kernels' own arithmetic, checked on the CPU: the step
machine of ``csrc/walk_step.cuh`` (the code the CUDA kernels run per
lane), built with g++ -O2 -ffp-contract=off into a host library of plain
sequential loops (``csrc/walk_host.cpp``), held bit for bit against the
plain PyTorch segments on the same seeded lanes, launch after launch:
K1 in its three step machines (trapezoid, scouting, Simpson), K2 in the
same three, K3 in trapezoid and Simpson, for every integrand the kernels
compile in (each family's ds twin and the range-reduced twins); and K1's
theta mode (theta_block T in 1, 8, 64, 256: evaluate every lane, OR each
group's votes, commit every lane) in the trapezoid and scouting machines
on sin(theta x), its reduced twin and sin(theta / x).

The ``cuda`` tests hold the CUDA kernels themselves against the plain
segments, the walker on the card against the walker on the CPU, and a
walker killed and resumed on the card (through K1 and K2) against its
uninterrupted run; they skip where there is no card. This file imports nothing of JAX, so
on a machine without it the card tests run with
``python -m pytest --noconftest tests/test_torch_kernel_host.py -m cuda``.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import get_family, get_family_ds
from ppls_tpu_torch.ops.ds_kernel import f32
from ppls_tpu_torch.parallel import walker as W

# (rule, scout) of each step machine
MODES = {"trapezoid": (Rule.TRAPEZOID, False),
         "scout": (Rule.TRAPEZOID, True),
         "simpson": (Rule.SIMPSON, False)}


def _eps(eps, rule):
    # Simpson's O(h^6) accepts end these workloads in the breed at the
    # trapezoid eps; 1e-12 (tests/test_tpu_lane.py's Simpson eps) leaves
    # the walker real work
    return 1e-12 if rule == Rule.SIMPSON else eps

# (twin, theta, bounds, eps); a twin is "<family>" or "<family>@reduced"
CASES = [
    ("sin_recip_scaled", 1.0 + np.arange(8) / 8.0, (1e-2, 1.0), 1e-7),
    ("cosh4_scaled", 0.5 + np.arange(4) / 4.0, (0.0, 3.0), 1e-6),
    ("sin_recip_scaled@reduced", 1.0 + np.arange(8) / 8.0, (1e-2, 1.0),
     1e-7),
    ("cosh4_scaled@reduced", 0.5 + np.arange(4) / 4.0, (0.0, 3.0), 1e-6),
    ("sin_scaled@reduced", np.linspace(1.0, 8.0, 64), (0.0, 1.0), 1e-7),
    ("gauss_center", np.linspace(0.4995, 0.5005, 64), (0.4, 0.6), 1e-9),
    ("quad_scaled", 1.0 + np.arange(8) / 4.0, (0.0, 1.0), 1e-9),
]


def _simpson_exact(fam, rule):
    """Simpson with Richardson is exact on theta x^2 (in float64 and, on
    dyadic nodes, in ds): its breed accepts every root, so these cases
    breed with the trapezoid rule and each walk tests one node."""
    return _family(fam) == "quad_scaled" and rule == Rule.SIMPSON


def _family(twin):
    return twin.partition("@")[0]


def _twin(twin):
    fam, _, tag = twin.partition("@")
    return get_family_ds(fam, reduced=tag == "reduced")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the K1 step "
                    "machine cannot be made")
    from ppls_tpu_torch.utils.cuda_build import build_walk_host
    return build_walk_host(tmp_path_factory.mktemp("walk_host")).lib


def _inputs(fam, theta, bounds, eps, scout, device="cpu", refill_slots=4,
            rule=Rule.TRAPEZOID):
    if _simpson_exact(fam, rule):
        rule = Rule.TRAPEZOID
    return W.first_phase_inputs(
        get_family(_family(fam)), theta, bounds, eps, lanes=256,
        roots_per_lane=4,
        refill_slots=refill_slots, capacity=1 << 16, scout=scout,
        rule=rule, min_active_frac=0.05, device=device)


def _clone(inp):
    out = dict(inp)
    out["state"] = W.WalkState(*(t.clone() for t in inp["state"]))
    for k in ("slot", "nslots"):
        if k in inp:
            out[k] = inp[k].clone()
    for k in ("bank", "resm"):
        if k in inp:
            out[k] = tuple(t.clone() for t in inp[k])
    return out


def _table(ops):
    return (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])


def _run_host(lib, inp, cap, f_ds, eps, scout, rule=Rule.TRAPEZOID):
    R, lanes = inp["bank"][0].shape
    T = inp["theta_block"]
    resh = torch.zeros((R, lanes), dtype=torch.float32)
    resl = torch.zeros((R, lanes), dtype=torch.float32)
    ctr = torch.zeros(8, dtype=torch.int32)
    sync = torch.zeros(3, dtype=torch.int64)
    votes = torch.zeros(3 * (lanes // T), dtype=torch.int32)
    ops = (*inp["state"], inp["nslots"], inp["slot"], *inp["bank"],
           *inp["resm"], resh, resl, ctr, sync, votes)
    rc = _host_rf(lib, _table(ops), lanes, R, f_ds, W.step_mode(rule, scout),
                  eps, inp["thresh"], cap, inp["batch"], T)
    assert rc == 0
    return resh, resl, ctr


def _host_rf(lib, table, lanes, R, f_ds, mode, eps, thresh, cap, batch, T):
    return lib.walk_rf_host(ctypes.cast(table, ctypes.c_void_p), lanes, R,
                            f_ds.kernel_family, mode, f32(eps), thresh, cap,
                            batch, T)


def _run_host_ee(lib, state, thresh, cap, f_ds, eps, mode):
    ctr = torch.zeros(7, dtype=torch.int32)
    sync = torch.zeros(3, dtype=torch.int64)
    table = _table((*state, ctr, sync))
    rc = lib.walk_ee_host(ctypes.cast(table, ctypes.c_void_p),
                          state.a_h.shape[0], f_ds.kernel_family, mode,
                          f32(eps), thresh, cap, 1)
    assert rc == 0
    return ctr


def _run_host_seg(lib, state, iters, f_ds, eps, mode):
    table = _table(tuple(state))
    return lib.walk_seg_host(ctypes.cast(table, ctypes.c_void_p),
                             state.a_h.shape[0], f_ds.kernel_family, mode,
                             f32(eps), iters)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bit_equal(a, b, outs_a, outs_b):
    for name, x, y in zip(W.WalkState._fields, a["state"], b["state"]):
        assert torch.equal(_bits(x), _bits(y)), name
    assert torch.equal(a["slot"], b["slot"])
    for x, y in zip(a["resm"], b["resm"]):
        assert torch.equal(_bits(x), _bits(y))
    for x, y in zip(outs_a, outs_b):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fam,theta,bounds,eps", CASES)
def test_host_step_machine_bit_equal_to_plain_segment(host_lib, fam, theta,
                                                      bounds, eps, mode):
    rule, scout = MODES[mode]
    f_ds = _twin(fam)
    eps = _eps(eps, rule)
    base = _inputs(fam, theta, bounds, eps, scout, rule=rule)
    a, b = _clone(base), _clone(base)
    steps = 0
    for cap in (24, 24, 64):          # consecutive launches on one state
        outs_a = W.segment_rf_plain(a["state"], a["slot"], a["thresh"], cap,
                                    a["batch"], a["nslots"], a["bank"],
                                    a["resm"], f_ds=f_ds, eps=eps,
                                    scout=scout, rule=rule)
        outs_b = _run_host(host_lib, b, cap, f_ds, eps, scout, rule)
        _assert_bit_equal(a, b, outs_a, outs_b)
        steps += int(outs_a[2][0])
    assert int(a["slot"].sum()) > 256       # refills happened
    if _simpson_exact(fam, rule):
        assert int(a["state"].splits.sum()) == 0 and steps > 16
    else:
        assert steps > 24


def _assert_state_bit_equal(a, b):
    for name, x, y in zip(W.WalkState._fields, a, b):
        assert torch.equal(_bits(x), _bits(y)), name


# theta mode: (family, bounds, eps, theta range); m = max(2, 64 // T)
# slots of T thetas each over 512 lanes, R = 4
THETA_CASES = [("sin_scaled", (0.0, 1.0), 1e-9, (1.0, 4.0)),
               ("sin_recip_scaled", (1e-2, 1.0), 1e-7, (1.0, 2.0)),
               ("sin_scaled@reduced", (0.0, 1.0), 1e-9, (1.0, 4.0))]


def _theta_inputs(fam, bounds, eps, span, T, scout, device="cpu"):
    m = max(2, 64 // T)
    theta = np.linspace(*span, m * T)
    return W.first_phase_inputs(
        get_family(_family(fam)), theta.reshape(m, T) if T > 1 else theta,
        bounds,
        eps, lanes=512, roots_per_lane=4, refill_slots=4, capacity=1 << 16,
        scout=scout, min_active_frac=0.05, theta_block=T, device=device)


@pytest.mark.parametrize("scout", [False, True])
@pytest.mark.parametrize("T", [1, 8, 64, 128, 256])
@pytest.mark.parametrize("fam,bounds,eps,span", THETA_CASES)
def test_host_theta_loop_bit_equal_to_plain_segment(host_lib, fam, bounds,
                                                    eps, span, T, scout):
    # T = 1 runs the variant without votes; on the card T = 8 votes
    # inside a warp, 64 across warps, 128 across the block, 256 across
    # blocks
    f_ds = _twin(fam)
    base = _theta_inputs(fam, bounds, eps, span, T, scout)
    a, b = _clone(base), _clone(base)
    steps = over = 0
    for cap in (24, 24, 64):
        outs_a = W.segment_rf_plain(a["state"], a["slot"], a["thresh"], cap,
                                    a["batch"], a["nslots"], a["bank"],
                                    a["resm"], f_ds=f_ds, eps=eps,
                                    scout=scout, theta_block=T)
        outs_b = _run_host(host_lib, b, cap, f_ds, eps, scout)
        _assert_bit_equal(a, b, outs_a, outs_b)
        ctr = outs_a[2].tolist()
        assert sum(ctr[1:6]) == ctr[0] * 512
        steps += ctr[0]
        over += ctr[5]
    assert steps > 48
    assert int(a["slot"].sum()) >= 512        # every lane took a root
    assert (over > 0) == (T > 1)              # retired lanes walked on
    for f in ("i", "d", "flags"):             # a group walks one node
        g = getattr(a["state"], f).reshape(-1, T)
        assert bool((g == g[:, :1]).all()), f


def test_host_theta_loop_refuses_bad_blocks(host_lib):
    # Simpson has no theta mode; T must be a power of two dividing lanes
    inp = _inputs(*CASES[0], scout=False)
    f_ds = get_family_ds(CASES[0][0])
    R, lanes = inp["bank"][0].shape
    table = _table((*inp["state"], inp["nslots"], inp["slot"], *inp["bank"],
                    *inp["resm"]))
    for T, mode, want in ((8, W.STEP_SIMPSON, -2), (3, W.STEP_TRAP, -3),
                          (1024, W.STEP_TRAP, -3)):
        assert _host_rf(host_lib, table, lanes, R, f_ds, mode, 1e-7, 0, 4, 1,
                        T) == want


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("fam,theta,bounds,eps", CASES)
def test_host_k2_bit_equal_to_plain_segment(host_lib, fam, theta, bounds,
                                            eps, mode):
    # K2 on the seeded lanes of a boundary-refill phase, three launches
    # in a row at the exit threshold: every state field and counter equal
    rule, scout = MODES[mode]
    f_ds = _twin(fam)
    eps = _eps(eps, rule)
    base = _inputs(fam, theta, bounds, eps, scout, refill_slots=0,
                   rule=rule)
    a, b = _clone(base)["state"], _clone(base)["state"]
    steps = 0
    for cap in (16, 16, 48):
        ctr_a = W.segment_ee_plain(a, base["thresh"], cap, f_ds=f_ds,
                                   eps=eps, scout=scout, rule=rule)
        ctr_b = _run_host_ee(host_lib, b, base["thresh"], cap, f_ds, eps,
                             W.step_mode(rule, scout))
        _assert_state_bit_equal(a, b)
        assert torch.equal(ctr_a, ctr_b)
        assert int(ctr_a[1:5].sum()) == int(ctr_a[0]) * 256
        steps += int(ctr_a[0])
    if _simpson_exact(fam, rule):           # every lane tests its root once
        assert int(a.tasks.sum()) == 256 and int(a.splits.sum()) == 0
    else:
        assert steps > 16
        assert int(a.tasks.sum()) > 0


# --- K3 at its edges ---------------------------------------------------------
#
# K3 held bit for bit (no tolerance) to the plain segment through the host
# build: every integrand body the kernels compile in, launches of every
# length from none and one step to past a whole walk, lanes that reach the
# depth cap or finish mid-launch, NaN thetas, and lanes that split beside
# a point where the integrand is NaN (a K3 that works out the next step's
# point ahead, under both decisions, must leave no trace of the untaken
# one; tools/k3_split.cu times such steps).

# every integrand body: CASES and sin(theta x)'s own twin
BODY_CASES = CASES + [
    ("sin_scaled", np.linspace(1.0, 8.0, 64), (0.0, 1.0), 1e-7)]
# K3 launch lengths: no step, one step, odd and even counts, a launch
# past the 256-step segment
K3_LAUNCHES = (0, 1, 7, 8, 40, 257)
RULES = [Rule.TRAPEZOID, Rule.SIMPSON]


def _assert_state_bit_equal_nan(a, b):
    """Every field bit-equal, but that a NaN matches any NaN: its sign is
    the platform's (the plain segments' CPU kernels give x86's negative
    default NaN where the host build's scalar code gives a positive
    one)."""
    for name, x, y in zip(W.WalkState._fields, a, b):
        if x.is_floating_point():
            nan = torch.isnan(x)
            assert torch.equal(nan, torch.isnan(y)), name
            x, y = x[~nan], y[~nan]
        assert torch.equal(_bits(x), _bits(y)), name


def _k3_pair(lib, base, launches, f_ds, eps, rule,
             check=_assert_state_bit_equal):
    """The plain segment and the host build's K3 on copies of ``base``,
    launch after launch, every field held bit-equal (``check``) after
    each; returns the two states."""
    a, b = _clone(base)["state"], _clone(base)["state"]
    for iters in launches:
        W.segment_plain(a, iters, f_ds=f_ds, eps=eps, rule=rule)
        assert _run_host_seg(lib, b, iters, f_ds, eps,
                             W.step_mode(rule, False)) == 0
        check(a, b)
    return a, b


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("fam,theta,bounds,eps", BODY_CASES)
def test_host_k3_bit_equal_to_plain_segment(host_lib, fam, theta, bounds,
                                            eps, rule):
    f_ds = _twin(fam)
    eps = _eps(eps, rule)
    base = _inputs(fam, theta, bounds, eps, False, refill_slots=0,
                   rule=rule)
    a, b = _k3_pair(host_lib, base, K3_LAUNCHES, f_ds, eps, rule)
    assert int(a.tasks.sum()) > int(base["state"].tasks.sum())
    # scouting has no K3 variant, in the host build as in the wrapper
    assert _run_host_seg(host_lib, b, 1, f_ds, eps, W.STEP_SCOUT) == -2


# eps = 1e-30: every test splits, so lanes walk to MAX_REL_DEPTH and park
# as OVF; eps = 1e-1: lanes accept their nodes and finish mid-launch,
# then take parked steps to the launch's end
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("walk_eps,ends", [(1e-30, "overflow"),
                                           (1e-1, "finish")])
@pytest.mark.parametrize("fam", ["sin_recip_scaled", "gauss_center"])
def test_host_k3_overflow_and_finish_bit_equal_to_plain_segment(
        host_lib, fam, walk_eps, ends, rule):
    _, theta, bounds, eps = next(c for c in CASES if c[0] == fam)
    f_ds = _twin(fam)
    base = _inputs(fam, theta, bounds, _eps(eps, rule), False,
                   refill_slots=0, rule=rule)
    before = base["state"].flags
    a, _ = _k3_pair(host_lib, base, (7, 257), f_ds, walk_eps, rule)
    live0 = (before & W._PARKED) == 0
    parked = (a.flags & W._PARKED) != 0
    ovf = (a.flags & W._OVF) != 0
    if ends == "overflow":
        assert bool((live0 & ovf).any())
        assert int(a.maxd[ovf].max()) >= W.MAX_REL_DEPTH
    else:
        assert bool((live0 & parked & ~ovf).any())


def _split_lanes_beside_zero(lanes, rule, device="cpu"):
    """Lanes of sin(theta / x) at theta 1 on a reversed root that ends at
    or crosses 0 ([1, 0] trapezoid, [0.75, -0.25] Simpson), each testing
    its node (i 0, d 1) with finite caches: at eps 1e-30 it splits, and
    the decision it did not take, the advance to the node (1, 1), has
    the point x = 0 (the trapezoid's right end, Simpson's midpoint),
    where theta / x is inf and the integrand NaN."""
    simpson = rule == Rule.SIMPSON
    s = W._fresh_lanes(lanes, device)
    vals = dict(a_h=0.75 if simpson else 1.0, w_h=-1.0, th_h=1.0,
                fl_h=0.5, fr_h=0.25, fm_h=0.375, fq_h=0.4375)
    for name, v in vals.items():
        getattr(s, name).fill_(v)
    s.d.fill_(1)
    s.flags.fill_(W._MODE_TESTB if simpson else 0)
    return s


def test_host_k3_nan_lanes_bit_equal_to_plain_segment(host_lib):
    """Lanes that split beside a point with a NaN integrand, and NaN
    thetas among healthy lanes: the state stays bit-equal to the plain
    segment's, the split lanes keep finite values, the healthy lanes
    finite sums."""
    fam, theta, bounds, eps = CASES[0]
    f_ds = _twin(fam)
    zero = torch.zeros(1, dtype=torch.float32)
    g = f_ds((zero, zero), (zero + 1.0, zero))
    assert not bool(torch.isfinite(g[0]).all())
    for rule in RULES:
        s = _split_lanes_beside_zero(8, rule)
        a, _ = _k3_pair(host_lib, {"state": s}, (2, 5), f_ds, 1e-30, rule)
        assert bool((a.d >= 2).all()) and bool((a.i == 0).all())
        for name in ("fl_h", "fr_h", "fm_h", "fq_h", "acc_h"):
            assert bool(torch.isfinite(getattr(a, name)).all()), name
    for rule in RULES:
        base = _inputs(fam, theta, bounds, _eps(eps, rule), False,
                       refill_slots=0, rule=rule)
        base["state"].th_h[3::16] = float("nan")
        a, _ = _k3_pair(host_lib, base, (1, 40, 64), f_ds,
                        _eps(eps, rule), rule, _assert_state_bit_equal_nan)
        poisoned = torch.zeros_like(a.th_h, dtype=torch.bool)
        poisoned[3::16] = True
        assert not bool(torch.isfinite(a.acc_h[poisoned]).all())
        assert bool(torch.isfinite(a.acc_h[~poisoned]).all())


# --- the kernels' grid primitives and the three-point confirm, on the host --

def _fp(t):
    return ctypes.c_void_p(t.data_ptr())


def _points(fam, n, seed):
    """n (a multiple of 3) ds points, seeded at random in the family's
    range and with edge inputs first, and a theta."""
    rng = np.random.default_rng(seed)
    lo, hi = {"sin_recip_scaled": (1e-4, 1.0), "sin_scaled": (0.0, 1.0),
              "cosh4_scaled": (0.0, 3.0), "gauss_center": (0.49, 0.51),
              "quad_scaled": (0.0, 1.0)}[_family(fam)]
    th = (0.4995, 0.5005) if _family(fam) == "gauss_center" else (1.0, 2.0)
    if fam == "cosh4_scaled@reduced":   # its whole domain, |theta x| <= 22
        lo, hi, th = -5.0, 5.0, (1.0, 4.4)
    edges = [lo, hi, 0.5, 0.25, 2.0 ** -20, 1.0 - 2.0 ** -24, 1e-30, 0.0,
             -0.75, 1e4, 3e-39, 1.0 + 2.0 ** -23]
    if _family(fam) == "cosh4_scaled":          # keep cosh^4 finite
        edges = [e for e in edges if abs(e) < 20.0]
    x = np.concatenate([edges, rng.uniform(lo, hi, n)])[:n]
    x = x[: len(x) - len(x) % 3]
    h = torch.tensor(x, dtype=torch.float32)
    lo_limb = torch.tensor(x - h.double().numpy(), dtype=torch.float32)
    return h, lo_limb, float(rng.uniform(*th))


def _same_floats(a, b):
    """Bit-equal where not NaN, NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(_bits(a)[~na], _bits(b)[~nb])


def _fma_two_prod(a, b):
    """The kernels' FMA two-product computed independently of them: p
    and the exact a * b - p (a float64 product of two float32 values is
    exact, and so is its difference from p) rounded once to float32."""
    p = a * b
    b64 = (b if isinstance(b, torch.Tensor)
           else torch.tensor(b, dtype=torch.float32)).double()
    return p, (a.double() * b64 - p.double()).float()


def _split_overflow(fn, *args):
    """Run ``fn(*args)`` (a plain twin over n points) twice: as it is,
    and with its two-product in the FMA form (``_fma_two_prod``). Mark
    the points whose arithmetic took Dekker's split of an operand past
    the float32 range (4097 |a| = inf for a finite a). There Dekker's
    two-product is NaN, and the kernels' FMA two-product
    (csrc/walk_step.cuh two_prod), which needs no split, is not: the one
    place the two forms part above the subnormal range. Returns (fn's
    result, its result in the FMA form, the mask)."""
    from ppls_tpu_torch.ops import ds_kernel, scout_kernel
    two_prod = ds_kernel.two_prod
    mask = None

    def probe(a, b):
        nonlocal mask
        hit = torch.isfinite(a) & torch.isinf(ds_kernel._SPLIT * a)
        if isinstance(b, torch.Tensor):
            hit = hit | (torch.isfinite(b) & torch.isinf(ds_kernel._SPLIT * b))
        mask = hit if mask is None else mask | hit
        return two_prod(a, b)

    outs = []
    for form in (probe, _fma_two_prod):
        ds_kernel.two_prod = scout_kernel.two_prod = form
        try:
            outs.append(fn(*args))
        finally:
            ds_kernel.two_prod = scout_kernel.two_prod = two_prod
    if mask is None:                      # no two-product on this path
        mask = torch.zeros((outs[0][0] if isinstance(outs[0], tuple)
                            else outs[0]).shape, dtype=torch.bool)
    return outs[0], outs[1], mask


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fam", ["sin_recip_scaled", "sin_scaled",
                                 "cosh4_scaled", "sin_recip_scaled@reduced",
                                 "sin_scaled@reduced", "cosh4_scaled@reduced",
                                 "gauss_center", "quad_scaled"])
def test_host_three_point_confirm_bit_equal_to_single_evals(host_lib, fam,
                                                            seed):
    # the scouting confirm evaluates x0, mid, x1 side by side
    # (f_ds_n<FAM, 3>, and f_sc_n for the float32 scout evals): each
    # point bit-equal to a single evaluation and to the plain twin
    f_ds = _twin(fam)
    x_h, x_l, th = _points(fam, 600, seed)
    th_h = f32(th)
    th_l = f32(th - float(th_h))
    n = x_h.numel()
    outs = {}
    for wide in (1, 0):
        oh, ol = torch.empty(n), torch.empty(n)
        assert host_lib.ws_f_ds_host(f_ds.kernel_family, wide, n, _fp(x_h),
                                     _fp(x_l), th_h, th_l, _fp(oh),
                                     _fp(ol)) == 0
        sc = torch.empty(n)
        assert host_lib.ws_f_sc_host(f_ds.kernel_family, wide, n, _fp(x_h),
                                     th_h, _fp(sc)) == 0
        outs[wide] = (oh, ol, sc)
    for a, b in zip(outs[1], outs[0]):
        assert _same_floats(a, b)
    # against the plain twins, whose two-product is Dekker's: bit-equal
    # but where Dekker's split overflowed (the plain twin NaN there); in
    # a body that keeps Dekker, everywhere. A body in the FMA form is
    # held at every point, those included, to the plain twin run with
    # the FMA form: there sin(theta / x)'s scout eval (x = 3e-39, theta /
    # x ~ 3.4e38) is inf where the reference's is NaN
    fma = host_lib.ws_fma_product(f_ds.kernel_family) == 1
    th_t = (torch.full((n,), th_h), torch.full((n,), th_l))
    zero = torch.zeros(n)
    (ph, pl), (fh, fl), over_ds = _split_overflow(f_ds, (x_h, x_l), th_t)
    psc, fsc, over_sc = _split_overflow(
        lambda *a: W.scout_twin(f_ds)(*a)[0], (x_h, zero), (th_t[0], zero))
    for got, want, want_fma, over in ((outs[1][0], ph, fh, over_ds),
                                      (outs[1][1], pl, fl, over_ds),
                                      (outs[1][2], psc, fsc, over_sc)):
        keep = ~over if fma else torch.ones_like(over)
        assert _same_floats(got[keep], want[keep])
        assert bool(torch.isnan(want[~keep]).all())
        if fma:
            assert _same_floats(got, want_fma)
    if _family(fam) == "sin_recip_scaled" and seed == 0:
        assert bool(over_sc.any())        # the edge x = 3e-39 reaches it
    if fma and bool(over_sc.any()):
        assert bool(torch.isinf(outs[1][2][over_sc]).all())
    assert int(torch.isfinite(outs[1][0]).sum()) > n - 12


def test_packed_count_round_trips_at_field_limits(host_lib):
    lim = (ctypes.c_int * 5)()
    host_lib.wg_limits(lim)
    assert list(lim) == [W.PACKED_ARRIVAL_BITS, W.PACKED_COUNT_BITS,
                         W.PACKED_MAX_BLOCKS, W.PACKED_MAX_LANES,
                         W.KERNEL_THREADS]
    assert lim[0] + 2 * lim[1] == 64

    # a step's gain in a never-cleared word: from 0, from a word whose
    # fields are full, and across the 64-bit wrap, earlier carries cancel
    bases = [0, (1 << 64) - 1, (1 << 64) - 3 * (1 << 48) - 5,
             (lim[2] << 48) | (lim[3] << 24) | lim[3]]

    def pack_sum(live, nref):
        live = torch.tensor(live, dtype=torch.int32)
        nref = torch.tensor(nref, dtype=torch.int32)
        outs = set()
        for base in bases:
            out = (ctypes.c_int * 3)()
            host_lib.wg_pack_sum(base, live.numel(), _fp(live), _fp(nref),
                                 out)
            outs.add(tuple(out))
        assert len(outs) == 1
        return list(outs.pop())

    full, nmax = W.KERNEL_THREADS, W.PACKED_MAX_BLOCKS
    assert pack_sum([0], [0]) == [1, 0, 0]
    assert pack_sum([W.PACKED_MAX_LANES], [W.PACKED_MAX_LANES]) == [
        1, W.PACKED_MAX_LANES, W.PACKED_MAX_LANES]
    assert pack_sum([W.PACKED_MAX_LANES], [0]) == [1, W.PACKED_MAX_LANES, 0]
    assert pack_sum([0], [W.PACKED_MAX_LANES]) == [1, 0, W.PACKED_MAX_LANES]
    # the largest grid, every lane live and refillable: no field carries
    assert pack_sum([full] * nmax, [full] * nmax) == [nmax, nmax * full,
                                                      nmax * full]
    rng = np.random.default_rng(3)
    live = rng.integers(0, full + 1, 1000)
    nref = rng.integers(0, full + 1, 1000)
    assert pack_sum(live.tolist(), nref.tolist()) == [
        1000, int(live.sum()), int(nref.sum())]
    # the launch limit, in the header and in the wrapper
    for lanes in (full, nmax * full, (nmax + 1) * full, W.PACKED_MAX_LANES,
                  W.PACKED_MAX_LANES + 1):
        fits = bool(host_lib.wg_packed_fits(lanes))
        assert fits == (lanes <= nmax * full)
        if fits:
            W._check_packed_limits("K1", lanes)
        else:
            with pytest.raises(ValueError, match="packed grid count"):
                W._check_packed_limits("K1", lanes)


def test_wrappers_raise_past_the_packed_count_limits(monkeypatch):
    # on the card path, before any operand check or launch; the state is
    # stride-0 views, so no memory is taken
    monkeypatch.setattr(W, "_cpu_or_cuda", lambda what, device: False)
    f_ds = get_family_ds("sin_recip_scaled")
    for lanes in ((W.PACKED_MAX_BLOCKS + 1) * W.KERNEL_THREADS,
                  W.PACKED_MAX_LANES + 1):
        state = W.WalkState(*(
            torch.zeros(1, dtype=torch.float32 if j < W.N_F32_FIELDS
                        else torch.int32).expand(lanes)
            for j in range(len(W.WalkState._fields))))
        lane_i = torch.zeros(1, dtype=torch.int32).expand(lanes)
        bank = tuple(torch.zeros(1, 1) for _ in range(7))
        with pytest.raises(ValueError, match="K1: .* packed grid count"):
            W.run_segment_rf(state, lane_i, 0, 4, 1, lane_i, bank,
                             (state.a_h, state.a_h, lane_i), f_ds=f_ds,
                             eps=1e-7, scout=False)
        with pytest.raises(ValueError, match="K2: .* packed grid count"):
            W.run_segment_ee(state, 0, 4, f_ds=f_ds, eps=1e-7, scout=False)


@pytest.mark.parametrize("T", [256, 1024, 2048])
def test_group_vote_words_match_the_group_or(host_lib, T):
    # the vote words K1 uses beyond one block (each block adds an arrival
    # and its vote into its group's word; three rotating sets, never
    # cleared: a vote is a word's gain since the set's previous vote)
    # against the OR over each group of T adjacent lanes, over rounds of
    # sparse, empty and full votes
    lanes, rounds = 4096, 11
    rng = np.random.default_rng(T)
    votes = (rng.random((rounds, lanes)) < 5e-4).astype(np.int32)
    votes[0, 7] = 1
    votes[2] = 0
    votes[3] = 1
    votes[5, ::T] = 1                           # one lane per group
    votes_t = torch.from_numpy(votes)
    want = np.repeat(votes.reshape(rounds, lanes // T, T).any(axis=2), T,
                     axis=1)
    # words from 0 as on the card, and near the 32-bit wrap and with the
    # arrival field full, where earlier votes' carries must cancel
    for init in (0, 0xFFFFFFF0, 0x0000FFFF):
        got = torch.zeros((rounds, lanes), dtype=torch.int32)
        assert host_lib.wg_group_any_host(_fp(votes_t), lanes, T, rounds,
                                          init, _fp(got)) == 0
        assert np.array_equal(got.numpy() != 0, want), init
    assert want[0].any() and not want[2].any() and want[3].all()
    assert not want[[0, 1, 4, 6]].all()        # sparse rounds leave groups
    for bad in (128, 96, 8192):
        assert host_lib.wg_group_any_host(_fp(votes_t), lanes, bad, 1, 0,
                                          _fp(got)) == -3


@pytest.mark.parametrize("scout", [False, True])
@pytest.mark.parametrize("T", [1024, 2048])
def test_host_theta_loop_group_words_bit_equal_to_plain_segment(host_lib, T,
                                                                scout):
    # the host K1 loop votes through the kernel's group words when a
    # group spans blocks: T = 1024 and 2048 over 4096 lanes (4 and 2
    # groups of 8 and 16 blocks), bit-equal to the plain theta segment
    fam, bounds, eps, span = THETA_CASES[0]
    f_ds = get_family_ds(fam)
    m = 4096 // T
    theta = np.linspace(*span, m * T).reshape(m, T)
    base = W.first_phase_inputs(
        get_family(fam), theta, bounds, eps, lanes=4096, roots_per_lane=2,
        refill_slots=2, capacity=1 << 16, scout=scout, min_active_frac=0.05,
        theta_block=T, device="cpu")
    a, b = _clone(base), _clone(base)
    steps = 0
    for cap in (16, 48):
        outs_a = W.segment_rf_plain(a["state"], a["slot"], a["thresh"], cap,
                                    a["batch"], a["nslots"], a["bank"],
                                    a["resm"], f_ds=f_ds, eps=eps,
                                    scout=scout, theta_block=T)
        outs_b = _run_host(host_lib, b, cap, f_ds, eps, scout)
        _assert_bit_equal(a, b, outs_a, outs_b)
        steps += int(outs_a[2][0])
    assert steps > 16
    for f in ("i", "d", "flags"):
        g = getattr(a["state"], f).reshape(-1, T)
        assert bool((g == g[:, :1]).all()), f


def test_k1_wrapper_on_cpu_is_the_plain_segment():
    f_ds = get_family_ds("sin_recip_scaled")
    base = _inputs(*CASES[0], scout=True)
    a, b = _clone(base), _clone(base)
    before = W.run_segment_rf.launches
    outs_a = W.run_segment_rf(a["state"], a["slot"], a["thresh"], 16,
                              a["batch"], a["nslots"], a["bank"], a["resm"],
                              f_ds=f_ds, eps=1e-7, scout=True)
    outs_b = W.segment_rf_plain(b["state"], b["slot"], b["thresh"], 16,
                                b["batch"], b["nslots"], b["bank"],
                                b["resm"], f_ds=f_ds, eps=1e-7, scout=True)
    _assert_bit_equal(a, b, outs_a, outs_b)
    assert W.run_segment_rf.launches == before   # no kernel launched


def test_k2_k3_wrappers_on_cpu_are_the_plain_segments():
    f_ds = get_family_ds("sin_recip_scaled")
    base = _inputs(*CASES[0], scout=False, refill_slots=0)
    a, b = _clone(base)["state"], _clone(base)["state"]
    before = (W.run_segment_ee.launches, W.run_segment.launches)
    out, steps, waste, evals = W.run_segment_ee(a, base["thresh"], 16,
                                                f_ds=f_ds, eps=1e-7,
                                                scout=False)
    ctr = W.segment_ee_plain(b, base["thresh"], 16, f_ds=f_ds, eps=1e-7,
                             scout=False)
    assert out is a
    _assert_state_bit_equal(a, b)
    assert torch.equal(torch.cat([steps.reshape(1), waste, evals]), ctr)
    W.run_segment(a, 8, f_ds=f_ds, eps=1e-7)
    W.segment_plain(b, 8, f_ds=f_ds, eps=1e-7)
    _assert_state_bit_equal(a, b)
    assert (W.run_segment_ee.launches, W.run_segment.launches) == before
    with pytest.raises(ValueError, match="no eval counters"):
        W.run_segment(a, 8, f_ds=f_ds, eps=1e-7, scout=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python3 -m pytest "
                    "--noconftest tests/test_torch_kernel_host.py -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scout", [False, True])
def test_cuda_kernel_bit_equal_to_plain_segment(cuda_device, scout):
    fam, theta, bounds, eps = CASES[0]
    f_ds = get_family_ds(fam)
    base = _inputs(fam, theta, bounds, eps, scout, device=cuda_device)
    a, b = _clone(base), _clone(base)
    before = W.run_segment_rf.launches
    for cap in (24, 64):
        outs_a = W.run_segment_rf(a["state"], a["slot"], a["thresh"], cap,
                                  a["batch"], a["nslots"], a["bank"],
                                  a["resm"], f_ds=f_ds, eps=eps, scout=scout)
        outs_b = W.segment_rf_plain(b["state"], b["slot"], b["thresh"], cap,
                                    b["batch"], b["nslots"], b["bank"],
                                    b["resm"], f_ds=f_ds, eps=eps,
                                    scout=scout)
        torch.cuda.synchronize()
        _assert_bit_equal(a, b, outs_a, outs_b)
    assert W.run_segment_rf.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("scout", [False, True])
@pytest.mark.parametrize("T", [8, 64, 128, 256])
def test_cuda_theta_kernel_bit_equal_to_plain_segment(cuda_device, T, scout):
    # the card twin of the host theta check, one case per vote scope
    fam, bounds, eps, span = THETA_CASES[0]
    f_ds = get_family_ds(fam)
    base = _theta_inputs(fam, bounds, eps, span, T, scout,
                         device=cuda_device)
    a, b = _clone(base), _clone(base)
    before = W.run_segment_rf.launches
    for cap in (24, 64):
        outs_a = W.run_segment_rf(a["state"], a["slot"], a["thresh"], cap,
                                  a["batch"], a["nslots"], a["bank"],
                                  a["resm"], f_ds=f_ds, eps=eps, scout=scout,
                                  theta_block=T)
        outs_b = W.segment_rf_plain(b["state"], b["slot"], b["thresh"], cap,
                                    b["batch"], b["nslots"], b["bank"],
                                    b["resm"], f_ds=f_ds, eps=eps,
                                    scout=scout, theta_block=T)
        torch.cuda.synchronize()
        _assert_bit_equal(a, b, outs_a, outs_b)
    assert W.run_segment_rf.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("scout", [False, True])
@pytest.mark.parametrize("T", [1024, 2048])
def test_cuda_theta_group_words_bit_equal_to_plain_segment(cuda_device, T,
                                                           scout):
    # the card twin of the host group-word check: groups of 8 and 16
    # blocks voting through their words, 4096 lanes
    fam, bounds, eps, span = THETA_CASES[0]
    f_ds = get_family_ds(fam)
    theta = np.linspace(*span, 4096).reshape(4096 // T, T)
    base = W.first_phase_inputs(
        get_family(fam), theta, bounds, eps, lanes=4096, roots_per_lane=2,
        refill_slots=2, capacity=1 << 16, scout=scout, min_active_frac=0.05,
        theta_block=T, device=cuda_device)
    a, b = _clone(base), _clone(base)
    for cap in (16, 48):
        outs_a = W.run_segment_rf(a["state"], a["slot"], a["thresh"], cap,
                                  a["batch"], a["nslots"], a["bank"],
                                  a["resm"], f_ds=f_ds, eps=eps, scout=scout,
                                  theta_block=T)
        outs_b = W.segment_rf_plain(b["state"], b["slot"], b["thresh"], cap,
                                    b["batch"], b["nslots"], b["bank"],
                                    b["resm"], f_ds=f_ds, eps=eps,
                                    scout=scout, theta_block=T)
        torch.cuda.synchronize()
        _assert_bit_equal(a, b, outs_a, outs_b)


@pytest.mark.cuda
def test_cuda_walker_matches_cpu_walker(cuda_device, monkeypatch):
    # the whole slice on the card (K1) and on the CPU (plain segment):
    # the same decisions, so the same task count, and areas equal up to
    # the float64 reduction order of the two devices. Both take the hand
    # cadence: the tuning table's cpu rows would move the CPU's schedule
    # (scouting f32 with refill_slots > 0), which the card has no rows for
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    fam, theta, bounds, eps = CASES[0]
    kw = dict(capacity=1 << 16, lanes=256, roots_per_lane=2,
              refill_slots=2, seg_iters=32, min_active_frac=0.05,
              scout_dtype="f32", double_buffer=True)
    before = W.run_segment_rf.launches
    gpu = W.integrate_family_walker(get_family(fam), get_family_ds(fam),
                                    theta, bounds, eps, device=cuda_device,
                                    **kw)
    assert W.run_segment_rf.launches > before
    cpu = W.integrate_family_walker(get_family(fam), get_family_ds(fam),
                                    theta, bounds, eps, device="cpu", **kw)
    assert gpu.metrics.tasks == cpu.metrics.tasks
    assert gpu.kernel_steps == cpu.kernel_steps
    assert np.array_equal(gpu.waste, cpu.waste)
    assert np.max(np.abs(gpu.areas - cpu.areas)) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_cuda_k2_bit_equal_to_plain_segment(cuda_device, mode):
    rule, scout = MODES[mode]
    fam, theta, bounds, eps = CASES[0]
    f_ds = get_family_ds(fam)
    eps = _eps(eps, rule)
    base = _inputs(fam, theta, bounds, eps, scout, device=cuda_device,
                   refill_slots=0, rule=rule)
    a, b = _clone(base)["state"], _clone(base)["state"]
    before = W.run_segment_ee.launches
    for cap in (16, 48):
        _, steps, waste, evals = W.run_segment_ee(
            a, base["thresh"], cap, f_ds=f_ds, eps=eps, scout=scout,
            rule=rule)
        ctr = W.segment_ee_plain(b, base["thresh"], cap, f_ds=f_ds, eps=eps,
                                 scout=scout, rule=rule)
        torch.cuda.synchronize()
        _assert_state_bit_equal(a, b)
        assert torch.equal(torch.cat([steps.reshape(1), waste, evals]), ctr)
    assert W.run_segment_ee.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("twin", [c[0] for c in BODY_CASES])
def test_cuda_k3_bit_equal_to_plain_segment(cuda_device, twin, rule):
    # K3 on the card, every body, launches of every length
    fam, theta, bounds, eps = next(c for c in BODY_CASES if c[0] == twin)
    f_ds = _twin(fam)
    eps = _eps(eps, rule)
    base = _inputs(fam, theta, bounds, eps, False, device=cuda_device,
                   refill_slots=0, rule=rule)
    a, b = _clone(base)["state"], _clone(base)["state"]
    before = W.run_segment.launches
    for iters in K3_LAUNCHES:
        W.run_segment(a, iters, f_ds=f_ds, eps=eps, rule=rule)
        W.segment_plain(b, iters, f_ds=f_ds, eps=eps, rule=rule)
        torch.cuda.synchronize()
        _assert_state_bit_equal(a, b)
    assert W.run_segment.launches == before + len(K3_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", RULES)
def test_cuda_k3_edge_lanes_bit_equal_to_plain_segment(cuda_device, rule):
    # on the card: lanes that split beside a point with a NaN integrand,
    # lanes that walk
    # to the depth cap, lanes that finish mid-launch (a NaN's sign is the
    # platform's, as in the host build's check)
    fam, theta, bounds, eps = CASES[0]
    f_ds = _twin(fam)
    cases = [({"state": _split_lanes_beside_zero(128, rule, cuda_device)},
              1e-30)]
    for walk_eps in (1e-30, 1e-1):
        cases.append((_inputs(fam, theta, bounds, _eps(eps, rule), False,
                              device=cuda_device, refill_slots=0,
                              rule=rule), walk_eps))
    for base, walk_eps in cases:
        a, b = _clone(base)["state"], _clone(base)["state"]
        for iters in (2, 7, 257):
            W.run_segment(a, iters, f_ds=f_ds, eps=walk_eps, rule=rule)
            W.segment_plain(b, iters, f_ds=f_ds, eps=walk_eps, rule=rule)
            torch.cuda.synchronize()
            _assert_state_bit_equal_nan(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [dict(refill_slots=0),
                                  dict(refill_slots=0, scout_dtype="f32"),
                                  dict(rule=Rule.SIMPSON),
                                  dict(rule=Rule.SIMPSON, refill_slots=0),
                                  dict(theta_block=8),
                                  dict(theta_block=8, scout_dtype="f32")])
def test_cuda_walker_modes_match_cpu_walker(cuda_device, over):
    # the boundary-refill walker (K2) and the Simpson walker (K1 or K2 in
    # Simpson mode) on the card and on the CPU: the same decisions, and
    # areas equal up to the float64 reduction order of the two devices
    fam, theta, bounds, _ = CASES[0]
    eps = 1e-12 if over.get("rule") == Rule.SIMPSON else 1e-7
    kw = dict(capacity=1 << 16, lanes=256, roots_per_lane=2,
              refill_slots=2, seg_iters=32, min_active_frac=0.05)
    kw.update(over)
    counter = W.run_segment_ee if kw["refill_slots"] == 0 \
        else W.run_segment_rf
    before = counter.launches
    gpu = W.integrate_family_walker(get_family(fam), get_family_ds(fam),
                                    theta, bounds, eps, device=cuda_device,
                                    **kw)
    assert counter.launches > before
    cpu = W.integrate_family_walker(get_family(fam), get_family_ds(fam),
                                    theta, bounds, eps, device="cpu", **kw)
    assert gpu.metrics.tasks == cpu.metrics.tasks
    assert gpu.kernel_steps == cpu.kernel_steps
    assert np.array_equal(gpu.waste, cpu.waste)
    assert np.max(np.abs(gpu.areas - cpu.areas)) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("twin", [c[0] for c in CASES[2:]])
def test_cuda_bodies_bit_equal_to_plain_segment(cuda_device, twin, mode):
    # each integrand body the kernels gained (the range-reduced twins,
    # gauss_center, quad_scaled) in K1, K2 and, but for scouting, K3
    fam, theta, bounds, eps = next(c for c in CASES if c[0] == twin)
    rule, scout = MODES[mode]
    f_ds = _twin(fam)
    eps = _eps(eps, rule)
    base = _inputs(fam, theta, bounds, eps, scout, device=cuda_device,
                   rule=rule)
    a, b = _clone(base), _clone(base)
    counters = (W.run_segment_rf, W.run_segment_ee, W.run_segment)
    before = [k.launches for k in counters]
    for cap in (24, 64):
        outs_a = W.run_segment_rf(a["state"], a["slot"], a["thresh"], cap,
                                  a["batch"], a["nslots"], a["bank"],
                                  a["resm"], f_ds=f_ds, eps=eps, scout=scout,
                                  rule=rule)
        outs_b = W.segment_rf_plain(b["state"], b["slot"], b["thresh"], cap,
                                    b["batch"], b["nslots"], b["bank"],
                                    b["resm"], f_ds=f_ds, eps=eps,
                                    scout=scout, rule=rule)
        torch.cuda.synchronize()
        _assert_bit_equal(a, b, outs_a, outs_b)
    seeded = _inputs(fam, theta, bounds, eps, scout, device=cuda_device,
                     refill_slots=0, rule=rule)
    a, b = _clone(seeded)["state"], _clone(seeded)["state"]
    for cap in (16, 48):
        _, steps, waste, evals = W.run_segment_ee(
            a, seeded["thresh"], cap, f_ds=f_ds, eps=eps, scout=scout,
            rule=rule)
        ctr = W.segment_ee_plain(b, seeded["thresh"], cap, f_ds=f_ds,
                                 eps=eps, scout=scout, rule=rule)
        torch.cuda.synchronize()
        _assert_state_bit_equal(a, b)
        assert torch.equal(torch.cat([steps.reshape(1), waste, evals]), ctr)
    if not scout:
        W.run_segment(a, 40, f_ds=f_ds, eps=eps, rule=rule)
        W.segment_plain(b, 40, f_ds=f_ds, eps=eps, rule=rule)
        torch.cuda.synchronize()
        _assert_state_bit_equal(a, b)
    assert [k.launches - n for k, n in zip(counters, before)] \
        == [2, 2, 0 if scout else 1]


@pytest.mark.cuda
@pytest.mark.parametrize("twin", [c[0] for c in CASES[2:]])
def test_cuda_body_walkers_match_cpu_walker(cuda_device, twin, monkeypatch):
    # the walker through each new body on the card (K1, scouting, double
    # buffer) and on the CPU: the same decisions, areas equal up to the
    # float64 reduction order of the two devices (the hand cadence on
    # both, as in test_cuda_walker_matches_cpu_walker)
    monkeypatch.setenv("PPLS_TUNING_TABLE", "off")
    fam, theta, bounds, eps = next(c for c in CASES if c[0] == twin)
    kw = dict(capacity=1 << 16, lanes=256, roots_per_lane=2,
              refill_slots=2, seg_iters=32, min_active_frac=0.05,
              scout_dtype="f32", double_buffer=True)
    before = W.run_segment_rf.launches
    gpu = W.integrate_family_walker(get_family(_family(fam)), _twin(fam),
                                    theta, bounds, eps, device=cuda_device,
                                    **kw)
    assert W.run_segment_rf.launches > before
    cpu = W.integrate_family_walker(get_family(_family(fam)), _twin(fam),
                                    theta, bounds, eps, device="cpu", **kw)
    assert gpu.metrics.tasks == cpu.metrics.tasks
    assert gpu.kernel_steps == cpu.kernel_steps
    assert np.array_equal(gpu.waste, cpu.waste)
    assert np.max(np.abs(gpu.areas - cpu.areas)
                  / np.maximum(np.abs(cpu.areas), 1.0)) < 1e-12


def test_ceiling_probe_state_and_card_requirement(monkeypatch):
    # the probe's lanes carry the whole 26-field state (mk_i = 0,
    # mk_d = -1) and start testing at once; K3 on them is K2 with no
    # exit (thresh -1) step for step
    from ppls_tpu_torch.tools import profile_walker as P
    f_ds = get_family_ds(P.FAMILY)
    a = P.ceiling_state(256, device="cpu")
    assert len(a) == len(W.WalkState._fields)
    assert int(a.mk_i.abs().sum()) == 0 and bool((a.mk_d == -1).all())
    assert int(a.flags.abs().sum()) == 0
    b = W.WalkState(*(t.clone() for t in a))
    W.run_segment(a, 24, f_ds=f_ds, eps=1e-10)
    ctr = W.segment_ee_plain(b, -1, 24, f_ds=f_ds, eps=1e-10, scout=False)
    _assert_state_bit_equal(a, b)
    assert int(ctr[0]) == 24 and int(ctr[1]) > 24 * 128
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card measurement"):
        P.kernel_ceiling(lanes=256, outer=2)


@pytest.mark.cuda
def test_cuda_ceiling_probe_runs(cuda_device):
    from ppls_tpu_torch.tools import profile_walker as P
    before = W.run_segment.launches
    s = P.kernel_ceiling_slope(lanes=1 << 12, outer_lo=4, outer_hi=16)
    assert s["lane_steps_per_sec"] > 0 and s["us_per_step"] > 0
    assert W.run_segment.launches == before + s["launches"]


@pytest.mark.cuda
@pytest.mark.parametrize("refill_slots", [1, 0])
def test_cuda_walker_kill_and_resume_bit_identical(tmp_path, cuda_device,
                                                   refill_slots):
    """tests/test_device_checkpoint.py's walker configuration through K1
    (in-kernel refill) and K2 (boundary refill): killed after 2 legs of 2
    cycles and resumed, bit-identical to the uninterrupted run, the two
    legs launching as often as it."""
    kernel = W.run_segment_rf if refill_slots else W.run_segment_ee
    fam = "sin_recip_scaled"
    args = (get_family(fam), get_family_ds(fam), 1.0 + np.arange(4) / 4.0,
            (1e-2, 1.0), 1e-7)
    kw = dict(capacity=1 << 16, lanes=256, roots_per_lane=1, seg_iters=8,
              max_segments=1, max_cycles=256, min_active_frac=0.05,
              refill_slots=refill_slots, device=cuda_device)
    n0 = kernel.launches
    base = W.integrate_family_walker(*args, **kw)
    n1 = kernel.launches
    path = str(tmp_path / "w.ckpt")
    with pytest.raises(RuntimeError, match="simulated crash"):
        W.integrate_family_walker(*args, checkpoint_path=path,
                                  checkpoint_every=2, _crash_after_legs=2,
                                  **kw)
    res = W.resume_family_walker(path, *args, checkpoint_every=2, **kw)
    assert np.array_equal(res.areas, base.areas)
    assert (res.metrics.tasks, res.cycles, res.kernel_steps) == (
        base.metrics.tasks, base.cycles, base.kernel_steps)
    assert np.array_equal(res.waste, base.waste)
    assert n1 > n0 and kernel.launches - n1 == n1 - n0


# tests/test_multitenant.py's serve configuration with the stream leg's
# knobs (scout f32, double buffer), at 256 lanes
SERVE_CARD_ARGS = ["serve", "--family", "sin_recip_scaled", "--slots", "8",
                   "--chunk", "512", "--capacity", "65536", "--lanes", "256",
                   "--refill-slots", "2", "--scout-dtype", "f32",
                   "--double-buffer", "--eps", "1e-7", "-a", "1e-2",
                   "-b", "1.0", "--synthetic", "8", "--arrival-rate", "2",
                   "--seed", "17"]


def _serve(argv):
    import contextlib
    import io
    import json

    from ppls_tpu_torch import __main__ as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


@pytest.mark.cuda
def test_cuda_serve_cli_matches_engine_and_cpu(cuda_device):
    """``serve`` on the card through K1: every retire record bit-equal to
    an in-process ``StreamEngine.run`` on the same requests, and the same
    records as ``serve --device cpu`` with areas within 1e-12."""
    from ppls_tpu_torch.runtime.stream import StreamEngine
    before = W.run_segment_rf.launches
    card = _serve(SERVE_CARD_ARGS)
    assert W.run_segment_rf.launches > before
    cpu = _serve(SERVE_CARD_ARGS + ["--device", "cpu"])
    theta = np.linspace(1.0, 2.0, 8, endpoint=False)
    gaps = np.random.default_rng(17).exponential(0.5, 8)
    arrivals = np.floor(np.cumsum(gaps) - gaps[0]).astype(int).tolist()
    res = StreamEngine(
        "sin_recip_scaled", 1e-7, slots=8, chunk=512, capacity=65536,
        lanes=256, refill_slots=2, scout_dtype="f32", double_buffer=True,
        device=cuda_device).run([(float(t), (1e-2, 1.0)) for t in theta],
                                arrival_phase=arrivals)
    by_rid = {c.rid: c for c in res.completed}
    recs = card[:-1]
    assert len(recs) == 8 and card[-1]["completed"] == 8
    for r in recs:
        c = by_rid[r["rid"]]
        assert (r["area"], r["admit_phase"], r["retire_phase"]) == (
            c.area, c.admit_phase, c.retire_phase)
    assert card[-1]["totals"] == res.totals
    assert card[-1]["phases"] == res.phases == cpu[-1]["phases"]
    for a, b in zip(recs, cpu[:-1]):
        assert a["rid"] == b["rid"] and abs(a["area"] - b["area"]) < 1e-12
        assert (a["admit_phase"], a["retire_phase"]) == (
            b["admit_phase"], b["retire_phase"])


@pytest.mark.cuda
@pytest.mark.parametrize("refill_slots", [2, 0])
def test_cuda_nan_poison_matches_plain_segments(cuda_device, refill_slots):
    """A NaN-poisoned request through K1 (R = 2) and K2 (R = 0) on the
    card: the same failed rid, records and totals as the plain segments
    on the CPU, healthy areas within 1e-12."""
    from ppls_tpu_torch.runtime.faults import FaultInjector, FaultPlan
    from ppls_tpu_torch.runtime.stream import StreamEngine
    kernel = W.run_segment_rf if refill_slots else W.run_segment_ee
    reqs = [(1.0 + i / 8, (1e-2, 1.0)) for i in range(8)]

    def run(device):
        inj = FaultInjector(FaultPlan.from_events(
            [{"kind": "nan_poison", "at": 2}]))
        return StreamEngine(
            "sin_recip_scaled", 1e-6, slots=4, chunk=1024, capacity=65536,
            lanes=256, roots_per_lane=2, refill_slots=refill_slots,
            seg_iters=32, min_active_frac=0.05, quarantine=True,
            fault_injector=inj, device=device).run(
                reqs, arrival_phase=[0, 0, 1, 1, 2, 3, 3, 4])

    before = kernel.launches
    card = run(cuda_device)
    assert kernel.launches > before
    cpu = run("cpu")

    def recs(r):
        return {c.rid: (c.admit_phase, c.retire_phase, c.failed, c.failure)
                for c in r.completed}

    assert recs(card) == recs(cpu)
    assert [c.rid for c in card.completed if c.failed] == [2]
    assert card.totals == cpu.totals
    ok = [c.rid for c in cpu.completed if not c.failed]
    a = {c.rid: c.area for c in card.completed}
    b = {c.rid: c.area for c in cpu.completed}
    assert max(abs(a[k] - b[k]) for k in ok) < 1e-12


@pytest.mark.cuda
def test_cuda_cluster_workers_launch_k1(cuda_device):
    """Two cluster workers on one card (``runtime/cluster.py``) walk
    tests/test_cluster.py's dyadic requests through K1: each worker
    reports K1 launches, its device is cuda:0, and the areas equal the
    CPU cluster's bit for bit."""
    from ppls_tpu_torch.runtime.cluster import ClusterStreamEngine
    kw = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
              roots_per_lane=2, refill_slots=2, seg_iters=32,
              min_active_frac=0.05, f64_rounds=0)
    reqs = [(t, (0.0, 1.0)) for t in (1.0, 1.25, 1.5, 2.0, 0.75, 3.0)]
    out, rows = {}, {}
    for dev in ("cuda", "cpu"):
        with ClusterStreamEngine("quad_scaled", 1e-9, n_processes=2,
                                 worker_kw=kw, device=dev) as eng:
            out[dev] = eng.run(reqs, arrival_phase=[0, 0, 1, 2, 3, 4])
            rows[dev] = eng.manifest.describe()["processes"]
    assert [r["platform"] for r in rows["cuda"]] == ["gpu", "gpu"]
    assert all(r["device"].startswith("cuda:") for r in rows["cuda"])
    launches = out["cuda"].cluster["launches"]
    assert all(v["run_segment_rf"] > 0 for v in launches.values())
    assert np.array_equal(out["cuda"].areas, out["cpu"].areas)
