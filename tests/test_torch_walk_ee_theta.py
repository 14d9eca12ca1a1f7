"""K2's theta variant (``theta_block`` T > 1 in ``csrc/walk_ee.cu``; the
reference's ``kernel_ee`` theta branch, ppls_tpu/parallel/walker.py:1320-
1324): groups of T adjacent lanes walk one node sequence under the union
vote, and a live lane whose theta has retired counts its step as
theta_overwalk instead of eval_active.

- The host build of the kernel's step machine (``walk_ee_host``,
  ``csrc/walk_host.cpp``) against the plain segment
  (``walker.segment_ee_plain(theta_block=T)``), bit for bit: every state
  field and all six counters, launch after launch, at T = 2 and 4 (warp
  ballots), 64 (the lanes' barrier) and 256 (vote words across blocks),
  in the trapezoid and scouting machines; NaN thetas (a NaN matches any
  NaN) and lanes that finish their root mid-launch included.
- The plain segment against the reference's own kernel,
  ``make_walk_kernel(..., early_exit=True, theta_block=T,
  interpret=True)``, on the same numpy-seeded theta lanes carried across
  by ``ppls_tpu_torch.interop``: the step count, the waste buckets
  (theta_overwalk > 0), the eval counters and every integer field equal;
  ds values within 1e-7 relative. That is the contract of
  tests/test_torch_walk_segment.py: in interpret mode XLA contracts the
  kernel's float32 multiply-adds, so the float fields differ in their
  last bits (ROADMAP Queue 3). On the seeds below no lane decides
  otherwise; on seed 2 at T = 2 in the scouting machine the reference
  counts 3 more confirm evals (7704 against 7701), one such flip.
- The wrappers: ``run_segment_ee(theta_block=T)`` on a CPU tensor is the
  plain segment; T must be a power of two dividing the lanes, with the
  trapezoid rule.
- The ``cuda`` tests hold the CUDA kernel itself bit-equal to the plain
  segment on the card (skipped where there is no card); this file
  imports JAX only inside the reference test, so on the card they run
  with ``python -m pytest --noconftest tests/test_torch_walk_ee_theta.py
  -m cuda``.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from ppls_tpu_torch import interop
from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import get_family, get_family_ds
from ppls_tpu_torch.ops.ds_kernel import f32
from ppls_tpu_torch.parallel import walker as W

LANES = 512
THRESH = 100
CAPS = (16, 16, 48)
# (family, bounds, eps, theta span): sin(theta / x) over a theta spread
# wide enough that lanes of one group accept where the group splits
FAMILY = ("sin_recip_scaled", (1e-2, 1.0), 1e-7, (1.0, 2.0))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the K2 step "
                    "machine cannot be made")
    from ppls_tpu_torch.utils.cuda_build import build_walk_host
    return build_walk_host(tmp_path_factory.mktemp("walk_host")).lib


def _theta_lanes(T, scout, device="cpu", walk_eps=None):
    """K2's theta lanes mid-walk: a bred and dealt theta bank (m = 64 / T
    slots of T thetas over 512 lanes, R = 4), then 12 K1 steps, so every
    group holds a root part-walked and some lanes carry accept markers.
    Returns (state, eps)."""
    fam, bounds, eps, span = FAMILY
    eps = eps if walk_eps is None else walk_eps
    m = max(2, 64 // T)
    theta = np.linspace(*span, m * T).reshape(m, T)
    inp = W.first_phase_inputs(
        get_family(fam), theta, bounds, FAMILY[2], lanes=LANES,
        roots_per_lane=4, refill_slots=4, capacity=1 << 16, scout=scout,
        min_active_frac=0.05, theta_block=T, device=device)
    W.segment_rf_plain(inp["state"], inp["slot"], inp["thresh"], 12,
                       inp["batch"], inp["nslots"], inp["bank"],
                       inp["resm"], f_ds=get_family_ds(fam), eps=FAMILY[2],
                       scout=scout, theta_block=T)
    return inp["state"], eps


def _clone(state):
    return W.WalkState(*(t.clone() for t in state))


def _table(ops):
    return (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])


def _run_host(lib, state, cap, f_ds, eps, scout, T, thresh=THRESH):
    ctr = torch.zeros(7, dtype=torch.int32)
    sync = torch.zeros(3, dtype=torch.int64)
    votes = torch.zeros(3 * (state.a_h.shape[0] // T), dtype=torch.int32)
    rc = lib.walk_ee_host(
        ctypes.cast(_table((*state, ctr, sync, votes)), ctypes.c_void_p),
        state.a_h.shape[0], f_ds.kernel_family,
        W.step_mode(Rule.TRAPEZOID, scout), f32(eps), thresh, cap, T)
    assert rc == 0
    return ctr


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_state_bit_equal(a, b):
    """Every field bit-equal, but that a NaN matches any NaN (the plain
    segments' CPU kernels and the host build's scalar code give NaNs of
    another sign)."""
    for name, x, y in zip(W.WalkState._fields, a, b):
        if x.is_floating_point():
            nan = torch.isnan(x)
            assert torch.equal(nan, torch.isnan(y)), name
            x, y = x[~nan], y[~nan]
        assert torch.equal(_bits(x), _bits(y)), name


@pytest.mark.parametrize("scout", [False, True])
@pytest.mark.parametrize("T", [2, 4, 64, 256])
def test_host_k2_theta_bit_equal_to_plain_segment(host_lib, T, scout):
    f_ds = get_family_ds(FAMILY[0])
    base, eps = _theta_lanes(T, scout)
    a, b = _clone(base), _clone(base)
    over = 0
    for cap in CAPS:
        ctr_a = W.segment_ee_plain(a, THRESH, cap, f_ds=f_ds, eps=eps,
                                   scout=scout, theta_block=T)
        ctr_b = _run_host(host_lib, b, cap, f_ds, eps, scout, T)
        _assert_state_bit_equal(a, b)
        assert torch.equal(ctr_a, ctr_b)
        assert int(ctr_a[1:5].sum()) == int(ctr_a[0]) * LANES
        over += int(ctr_a[4])
    assert over > 0                          # retired lanes walked on
    for f in ("i", "d"):                     # a group walks one node
        g = getattr(a, f).reshape(-1, T)
        assert bool((g == g[:, :1]).all()), f


@pytest.mark.parametrize("T", [2, 4])
def test_host_k2_theta_nan_and_finish_lanes(host_lib, T):
    """NaN thetas in some lanes; and eps 1e-1, where lanes accept their
    nodes and finish their root mid-launch, then take parked steps."""
    f_ds = get_family_ds(FAMILY[0])
    base, eps = _theta_lanes(T, False)
    base.th_h[3::16] = float("nan")
    a, b = _clone(base), _clone(base)
    for cap in CAPS:
        ctr_a = W.segment_ee_plain(a, THRESH, cap, f_ds=f_ds, eps=eps,
                                   scout=False, theta_block=T)
        ctr_b = _run_host(host_lib, b, cap, f_ds, eps, False, T)
        _assert_state_bit_equal(a, b)
        assert torch.equal(ctr_a, ctr_b)
    poisoned = torch.zeros_like(a.th_h, dtype=torch.bool)
    poisoned[3::16] = True
    assert not bool(torch.isfinite(a.acc_h[poisoned]).all())
    base, eps = _theta_lanes(T, False, walk_eps=1e-1)
    live0 = (base.flags & W._PARKED) == 0
    a, b = _clone(base), _clone(base)
    ctr_a = W.segment_ee_plain(a, 0, 64, f_ds=f_ds, eps=eps, scout=False,
                               theta_block=T)
    ctr_b = _run_host(host_lib, b, 64, f_ds, eps, False, T, thresh=0)
    _assert_state_bit_equal(a, b)
    assert torch.equal(ctr_a, ctr_b)
    finished = live0 & ((a.flags & W._PARKED) != 0) & ((a.flags & W._OVF)
                                                        == 0)
    assert bool(finished.any())


def test_host_k2_theta_refuses_bad_blocks(host_lib):
    # Simpson has no theta mode; T must be a power of two dividing lanes
    f_ds = get_family_ds(FAMILY[0])
    state, eps = _theta_lanes(2, False)
    table = _table((*state, torch.zeros(7, dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int64)))
    for T, mode, want in ((2, W.STEP_SIMPSON, -2), (3, W.STEP_TRAP, -3),
                          (1024, W.STEP_TRAP, -3)):
        assert host_lib.walk_ee_host(
            ctypes.cast(table, ctypes.c_void_p), LANES, f_ds.kernel_family,
            mode, f32(eps), THRESH, 4, T) == want


def test_k2_theta_wrapper_on_cpu_is_the_plain_segment():
    f_ds = get_family_ds(FAMILY[0])
    base, eps = _theta_lanes(4, True)
    a, b = _clone(base), _clone(base)
    before = W.run_segment_ee.launches
    _, steps, waste, evals = W.run_segment_ee(a, THRESH, 32, f_ds=f_ds,
                                              eps=eps, scout=True,
                                              theta_block=4)
    ctr = W.segment_ee_plain(b, THRESH, 32, f_ds=f_ds, eps=eps, scout=True,
                             theta_block=4)
    _assert_state_bit_equal(a, b)
    assert torch.equal(torch.cat([steps.reshape(1), waste, evals]), ctr)
    assert W.run_segment_ee.launches == before     # plain runs count none
    for T, rule in ((3, Rule.TRAPEZOID), (1024, Rule.TRAPEZOID),
                    (2, Rule.SIMPSON)):
        with pytest.raises(ValueError):
            W.run_segment_ee(_clone(base), THRESH, 4, f_ds=f_ds, eps=eps,
                             scout=False, rule=rule, theta_block=T)


# --- against the reference's kernel in interpret mode -----------------------

REF_LANES = 256
REF_CAP = 64
# (T, scout, seed): seeds on which interpret mode decides every lane as
# the port does (seed 2 at T = 2, scouting, flips three confirm evals)
REF_CASES = [(2, False, 0), (4, True, 1)]


def _ref_theta_lanes(seed, T, walker, lo=0.1, hi=0.8, idle=8):
    """Numpy-seeded theta lanes of sin(theta / x) as a deal leaves them:
    groups of T lanes share a fresh root (endpoint, width, depth, slot)
    in INIT mode, each lane its own theta in [1, 2); ``idle`` lanes'
    groups parked with no root."""
    rng = np.random.default_rng(seed)
    g = REF_LANES // T

    def split(x):
        hi_ = x.astype(np.float32)
        lo_ = (x - hi_.astype(np.float64)).astype(np.float32)
        return hi_.reshape(-1, 128), lo_.reshape(-1, 128)

    f = {n: j for j, n in enumerate(W.WalkState._fields)}
    state = [np.array(x) for x in interop.walk_state_to_numpy(
        W._fresh_lanes(REF_LANES, "cpu"))]
    state = [x.reshape(-1, 128) for x in state]
    cols = dict(a=np.repeat(rng.uniform(lo, hi, g), T),
                w=np.repeat(rng.uniform(0.02, 0.1, g) * (hi - lo), T),
                th=rng.uniform(1.0, 2.0, REF_LANES))
    for name, x in cols.items():
        state[f[name + "_h"]], state[f[name + "_l"]] = split(x)
    state[f["fam"]] = (np.arange(REF_LANES) // T % 8).astype(
        np.int32).reshape(-1, 128)
    state[f["base_d"]] = np.repeat(rng.integers(0, 6, g), T).astype(
        np.int32).reshape(-1, 128)
    flags = np.full(REF_LANES, walker._MODE_INIT, np.int32)
    for q in rng.choice(g, max(1, idle // T), replace=False):
        flags[q * T:(q + 1) * T] = walker._PARKED | walker._NO_ROOT
    state[f["flags"]] = flags.reshape(-1, 128)
    return state


@pytest.mark.parametrize("T,scout,seed", REF_CASES)
def test_plain_k2_theta_matches_reference_kernel(T, scout, seed):
    import jax
    import jax.numpy as jnp

    from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
    from ppls_tpu.parallel import walker as RW
    fam, eps = "sin_recip_scaled", 1e-6
    state = _ref_theta_lanes(seed, T, RW)
    thresh = REF_LANES // 8
    run = RW.make_walk_kernel(ref_family_ds(fam), eps, REF_CAP,
                              interpret=True, early_exit=True, scout=scout,
                              theta_block=T)
    r_state, r_steps, r_waste, r_evals = jax.device_get(run(
        RW.WalkState(*(jnp.asarray(x) for x in state)), jnp.int32(thresh),
        jnp.int32(REF_CAP)))

    t_state = interop.walk_state_from_numpy(state)
    _, steps, waste, evals = W.run_segment_ee(
        t_state, thresh, REF_CAP, f_ds=get_family_ds(fam), eps=eps,
        scout=scout, theta_block=T)
    assert int(steps) == int(r_steps) and 16 < int(steps) <= REF_CAP
    assert waste.tolist() == [int(v) for v in r_waste]
    assert evals.tolist() == [int(v) for v in r_evals]
    assert int(waste.sum()) == int(steps) * REF_LANES
    assert int(waste[3]) > 0                  # theta_overwalk
    got = interop.walk_state_to_numpy(t_state)
    for j, name in enumerate(W.WalkState._fields):
        if j >= W.N_F32_FIELDS:
            assert np.array_equal(got[j].reshape(-1),
                                  np.asarray(r_state[j]).reshape(-1)), name
    for f in ("a", "w", "th", "fl", "fr", "fm", "fq", "acc"):
        i = W.WalkState._fields.index(f + "_h")
        v = (got[i].astype(np.float64) + got[i + 1].astype(np.float64))
        rv = (np.asarray(r_state[i], np.float64)
              + np.asarray(r_state[i + 1], np.float64))
        v, rv = v.reshape(-1), rv.reshape(-1)
        scale = max(1.0, float(np.max(np.abs(rv))))
        assert np.max(np.abs(v - rv)) <= 1e-7 * scale, f


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python3 -m pytest "
                    "--noconftest tests/test_torch_walk_ee_theta.py -m "
                    "cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scout", [False, True])
@pytest.mark.parametrize("T", [2, 4, 64, 256])
def test_cuda_k2_theta_bit_equal_to_plain_segment(cuda_device, T, scout):
    # every vote scope: warp ballots (2, 4), the lanes' barrier (64),
    # vote words across blocks (256)
    f_ds = get_family_ds(FAMILY[0])
    base, eps = _theta_lanes(T, scout, device=cuda_device)
    a, b = _clone(base), _clone(base)
    before = W.run_segment_ee.launches
    over = 0
    for cap in CAPS:
        _, steps, waste, evals = W.run_segment_ee(
            a, THRESH, cap, f_ds=f_ds, eps=eps, scout=scout, theta_block=T)
        ctr = W.segment_ee_plain(b, THRESH, cap, f_ds=f_ds, eps=eps,
                                 scout=scout, theta_block=T)
        torch.cuda.synchronize()
        _assert_state_bit_equal(a, b)
        assert torch.equal(torch.cat([steps.reshape(1), waste, evals]), ctr)
        over += int(ctr[4])
    assert over > 0
    assert W.run_segment_ee.launches == before + len(CAPS)


@pytest.mark.cuda
def test_cuda_k2_theta_nan_lanes_bit_equal_to_plain_segment(cuda_device):
    f_ds = get_family_ds(FAMILY[0])
    base, eps = _theta_lanes(4, True, device=cuda_device)
    base.th_h[3::16] = float("nan")
    a, b = _clone(base), _clone(base)
    for cap in CAPS:
        _, steps, waste, evals = W.run_segment_ee(
            a, THRESH, cap, f_ds=f_ds, eps=eps, scout=True, theta_block=4)
        ctr = W.segment_ee_plain(b, THRESH, cap, f_ds=f_ds, eps=eps,
                                 scout=True, theta_block=4)
        torch.cuda.synchronize()
        _assert_state_bit_equal(a, b)
        assert torch.equal(torch.cat([steps.reshape(1), waste, evals]), ctr)
