"""The walk kernels' two-product and K2's speculate-then-commit loop,
checked on the CPU through the host (g++) build of csrc/walk_step.cuh.

The kernels compute the error of a float32 product with one FMA,
e = fma(a, b, -p); the plain segments (ppls_tpu_torch/ops/ds_kernel.py)
and the reference (ppls_tpu/ops/ds_kernel.py) use Dekker's split. Held
here: the two give the same bits on seeded pairs over [2^-40, 2^40];
where they part (products below ~2^-100, whose error is subnormal, and
operands past Dekker's split range, where Dekker is NaN) the FMA's error
is the exact residual rounded once; gauss_center, whose tails reach the
first range, keeps Dekker, and every other body's walks stay out of it.

K2 (csrc/walk_ee.cu) computes step k + 1 on a copy while the live count
after step k is in flight and keeps it only if the count says go on;
the host build's K2 loop takes the same order and is held bit for bit
(state and the 7 counters) against segment_ee_plain at the loop's edges:
cap 0 and 1, a threshold above the live count (one step), thresh -1 (no
exit), in every step machine and every integrand body.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu.ops import ds_kernel as ref_dk
from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import get_family, get_family_ds
from ppls_tpu_torch.ops import ds_kernel as dk
from ppls_tpu_torch.ops import scout_kernel as sk
from ppls_tpu_torch.ops.ds_kernel import f32
from ppls_tpu_torch.parallel import walker as W

MODES = {"trapezoid": (Rule.TRAPEZOID, False),
         "scout": (Rule.TRAPEZOID, True),
         "simpson": (Rule.SIMPSON, False)}

# every body the kernels compile in: (twin, thetas, bounds, eps)
BODIES = [
    ("sin_recip_scaled", 1.0 + np.arange(8) / 8.0, (1e-2, 1.0), 1e-7),
    ("sin_recip_scaled@reduced", 1.0 + np.arange(8) / 8.0, (1e-2, 1.0),
     1e-7),
    ("cosh4_scaled", 0.5 + np.arange(4) / 4.0, (0.0, 3.0), 1e-6),
    ("cosh4_scaled@reduced", 0.5 + np.arange(4) / 4.0, (0.0, 3.0), 1e-6),
    ("sin_scaled", np.linspace(1.0, 8.0, 64), (0.0, 1.0), 1e-7),
    ("sin_scaled@reduced", np.linspace(1.0, 8.0, 64), (0.0, 1.0), 1e-7),
    ("gauss_center", np.linspace(0.4995, 0.5005, 64), (0.4, 0.6), 1e-9),
    ("quad_scaled", 1.0 + np.arange(8) / 4.0, (0.0, 1.0), 1e-9),
]
LANES = 256
SPLIT_LIMIT = 2.0 ** 128 / 4097       # 4097 |a| overflows float32 above


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host build of the kernels' "
                    "step machine cannot be made")
    from ppls_tpu_torch.utils.cuda_build import build_walk_host
    return build_walk_host(tmp_path_factory.mktemp("walk_host")).lib


def _fp(t):
    return ctypes.c_void_p(t.data_ptr())


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _host_two_prod(lib, a, b, fma):
    p, e = torch.empty_like(a), torch.empty_like(a)
    lib.ws_two_prod_host(int(fma), a.numel(), _fp(a), _fp(b), _fp(p), _fp(e))
    return p, e


def _residual(a, b, p):
    """a * b - p rounded once to float32: the float64 product of two
    float32 values is exact, and so is its difference from p."""
    return (a.double() * b.double() - p.double()).float()


def _pairs(seed, n, lo, hi):
    """n seeded float32 pairs of random sign, |a| and |b| log-uniform
    over [2^lo, 2^hi]."""
    rng = np.random.default_rng(seed)

    def one():
        mag = 2.0 ** rng.uniform(lo, hi, n)
        return torch.tensor(mag * rng.choice([-1.0, 1.0], n),
                            dtype=torch.float32)
    return one(), one()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fma_two_prod_bit_equal_to_dekker(host_lib, seed):
    # the FMA form, Dekker's in the kernels' code, the plain twin and the
    # reference: the same bits on every pair, and p + e exact
    a, b = _pairs(seed, 200_000, -40, 40)
    p, e = _host_two_prod(host_lib, a, b, fma=True)
    p_dk, e_dk = _host_two_prod(host_lib, a, b, fma=False)
    p_pl, e_pl = dk.two_prod(a, b)
    p_ref, e_ref = ref_dk.two_prod(jnp.asarray(a.numpy()),
                                   jnp.asarray(b.numpy()))
    for got in (p_dk, p_pl, torch.tensor(np.asarray(p_ref))):
        assert torch.equal(_bits(p), _bits(got))
    for got in (e_dk, e_pl, torch.tensor(np.asarray(e_ref))):
        assert torch.equal(_bits(e), _bits(got))
    assert torch.equal(p.double() + e.double(), a.double() * b.double())


def test_two_prod_forms_part_below_the_normal_range(host_lib):
    # products of 2^-140 .. 2^-100: the FMA's error is the exact residual
    # rounded once (a subnormal); Dekker's partial products round there
    # too and its error differs on some pairs, all below 2^-100
    a, b = _pairs(3, 200_000, -70, -50)
    p, e = _host_two_prod(host_lib, a, b, fma=True)
    assert torch.equal(_bits(e), _bits(_residual(a, b, p)))
    p_dk, e_dk = _host_two_prod(host_lib, a, b, fma=False)
    _, e_pl = dk.two_prod(a, b)
    assert torch.equal(_bits(p), _bits(p_dk))
    assert torch.equal(_bits(e_dk), _bits(e_pl))
    parted = _bits(e) != _bits(e_dk)
    assert int(parted.sum()) > 1000
    assert float(p[parted].abs().max()) < 2.0 ** -100


def test_two_prod_forms_part_where_the_split_overflows(host_lib):
    # |a| past 2^128 / 4097: Dekker's 4097 a is inf and its error NaN (in
    # the kernels' Dekker and the plain twin); the FMA's stays the exact
    # residual while p is finite
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.uniform(1.0, 1.9, 1000) * 2.0 ** 117,
                     dtype=torch.float32)
    b = torch.tensor(rng.uniform(0.25, 2.0, 1000), dtype=torch.float32)
    assert bool((a > SPLIT_LIMIT).all())
    p, e = _host_two_prod(host_lib, a, b, fma=True)
    assert bool(torch.isfinite(p).all())
    assert torch.equal(_bits(e), _bits(_residual(a, b, p)))
    _, e_dk = _host_two_prod(host_lib, a, b, fma=False)
    _, e_pl = dk.two_prod(a, b)
    assert bool(torch.isnan(e_dk).all()) and bool(torch.isnan(e_pl).all())


def _twin(twin):
    fam, _, tag = twin.partition("@")
    return get_family_ds(fam, reduced=tag == "reduced")


def test_fma_product_is_chosen_per_body(host_lib):
    # a compile-time choice per body: FMA everywhere but gauss_center
    for twin, *_ in BODIES:
        want = 0 if twin == "gauss_center" else 1
        assert host_lib.ws_fma_product(_twin(twin).kernel_family) == want
    assert host_lib.ws_fma_product(99) == -2


class _PartedCount:
    """Patches the plain twins' two-product to count the products at which
    the FMA form would part from Dekker's (finite operands only)."""

    def __init__(self):
        self.parted = 0
        self.products = 0

    def probe(self, a, b):
        p, e = self._two_prod(a, b)
        bb = b if isinstance(b, torch.Tensor) else torch.full_like(a, b)
        ok = torch.isfinite(p) & torch.isfinite(e)
        self.products += int(ok.sum())
        self.parted += int((ok & (_bits(_residual(a, bb, p))
                                  != _bits(e))).sum())
        return p, e

    def __enter__(self):
        self._two_prod = dk.two_prod
        dk.two_prod = sk.two_prod = self.probe
        return self

    def __exit__(self, *exc):
        dk.two_prod = sk.two_prod = self._two_prod


_SEEDED = {}


def _seeded(twin, theta, bounds, eps, rule):
    """The seeded lanes of a body's first boundary refill (bred once per
    body and rule in this process; callers clone the state)."""
    if twin == "quad_scaled" and rule == Rule.SIMPSON:
        rule = Rule.TRAPEZOID        # Simpson's breed accepts every root
    key = (twin, eps, rule)
    if key not in _SEEDED:
        _SEEDED[key] = W.first_phase_inputs(
            get_family(twin.partition("@")[0]), theta, bounds, eps,
            lanes=LANES, roots_per_lane=4, refill_slots=0,
            capacity=1 << 16, scout=False, rule=rule, min_active_frac=0.05,
            device="cpu")
    return _SEEDED[key]


def _eps(eps, rule):
    return 1e-12 if rule == Rule.SIMPSON else eps


def _clone(state):
    return W.WalkState(*(t.clone() for t in state))


def _run_host_ee(lib, state, thresh, cap, f_ds, eps, mode):
    ctr = torch.zeros(7, dtype=torch.int32)
    sync = torch.zeros(3, dtype=torch.int64)
    ops = (*state, ctr, sync)
    table = (ctypes.c_void_p * len(ops))(*[t.data_ptr() for t in ops])
    rc = lib.walk_ee_host(ctypes.cast(table, ctypes.c_void_p),
                          state.a_h.shape[0], f_ds.kernel_family, mode,
                          f32(eps), thresh, cap, 1)
    assert rc == 0
    return ctr


def _assert_same(a, b, ctr_a, ctr_b):
    for name, x, y in zip(W.WalkState._fields, a, b):
        assert torch.equal(_bits(x), _bits(y)), name
    assert torch.equal(ctr_a, ctr_b)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("twin,theta,bounds,eps",
                         [c for c in BODIES if c[0] != "gauss_center"])
def test_fma_bodies_stay_above_the_parting_range(twin, theta, bounds, eps,
                                                 mode):
    # a K2 segment of each FMA body on its seeded lanes: no two-product
    # of the plain segment lands where the forms part
    rule, scout = MODES[mode]
    eps = _eps(eps, rule)
    state = _clone(_seeded(twin, theta, bounds, eps, rule)["state"])
    with _PartedCount() as count:
        ctr = W.segment_ee_plain(state, -1, 32, f_ds=_twin(twin), eps=eps,
                                 scout=scout, rule=rule)
    assert int(ctr[1]) > 0 and count.products > 10_000
    assert count.parted == 0


def _gauss_tail_lanes(n, seed):
    """n fresh lanes of gauss_center (centre 0.5) on roots in its tail,
    0.0117-0.0134 left of the centre, where exp(-500000 d^2) lies between
    2^-100 and its float32 floor, of widths 2^-21 .. 2^-8."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5 - 0.0134, 0.5 - 0.0117, n)
    a_h = torch.tensor(a, dtype=torch.float32)
    a_l = torch.tensor(a - a_h.double().numpy(), dtype=torch.float32)
    w = torch.tensor(2.0 ** -rng.integers(8, 22, n), dtype=torch.float32)
    return W._fresh_lanes(n, "cpu")._replace(
        a_h=a_h, a_l=a_l, w_h=w, th_h=torch.full((n,), 0.5),
        flags=torch.full((n,), 16, dtype=torch.int32))   # MODE_INIT


@pytest.mark.parametrize("mode", list(MODES))
def test_gauss_center_keeps_dekker_in_its_tails(host_lib, mode):
    # roots in the tail: the plain segment's products reach the range
    # where the forms part, so the body keeps Dekker, and the host K2
    # (Dekker for this body) stays bit-equal to the plain segment
    rule, scout = MODES[mode]
    f_ds = get_family_ds("gauss_center")
    base = _gauss_tail_lanes(LANES, 5)
    a, b = _clone(base), _clone(base)
    with _PartedCount() as count:
        ctr_a = W.segment_ee_plain(a, -1, 12, f_ds=f_ds, eps=1e-12,
                                   scout=scout, rule=rule)
    assert count.parted > 0
    ctr_b = _run_host_ee(host_lib, b, -1, 12, f_ds, 1e-12,
                         W.step_mode(rule, scout))
    _assert_same(a, b, ctr_a, ctr_b)


# (cap, thresh): thresh None is the seeding's exit threshold
K2_EDGES = {"cap0": (0, None), "cap1": (1, None),
            "thresh_above_live": (24, LANES), "no_exit": (24, -1),
            "normal": (24, None)}


@pytest.mark.parametrize("edge", list(K2_EDGES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("twin,theta,bounds,eps", BODIES)
def test_host_k2_speculation_bit_equal_at_the_edges(host_lib, twin, theta,
                                                    bounds, eps, mode, edge):
    rule, scout = MODES[mode]
    eps = _eps(eps, rule)
    f_ds = _twin(twin)
    seeded = _seeded(twin, theta, bounds, eps, rule)
    cap, thresh = K2_EDGES[edge]
    thresh = seeded["thresh"] if thresh is None else thresh
    a, b = _clone(seeded["state"]), _clone(seeded["state"])
    ctr_a = W.segment_ee_plain(a, thresh, cap, f_ds=f_ds, eps=eps,
                               scout=scout, rule=rule)
    ctr_b = _run_host_ee(host_lib, b, thresh, cap, f_ds, eps,
                         W.step_mode(rule, scout))
    _assert_same(a, b, ctr_a, ctr_b)
    steps = int(ctr_a[0])
    assert int(ctr_a[1:5].sum()) == steps * LANES
    if edge in ("cap0", "cap1", "thresh_above_live"):
        assert steps == 1                     # the first step always runs
    elif edge == "no_exit":
        assert steps == cap
