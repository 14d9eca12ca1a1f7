"""Port ds arithmetic (ppls_tpu_torch/ops) against float64 ground truth
and against the reference's fenced ds library (ppls_tpu/ops/ds.py).

The port's ``ops/ds_kernel.py`` is the plain version of the walk
kernel's device library; the reference's XLA-level ``ops/ds.py`` runs
the same algorithms with NaN fences. Inputs are made with numpy from a
seed and handed to both. Tolerance: 1e-13 relative (ds carries ~48
mantissa bits, ~7e-15); a sum's error is taken relative to its operands
and a transcendental's as 1e-13 * max(1, |truth|).

Against the reference's kernel library (``ops/ds_kernel.py``,
``ops/scout_kernel.py``) run op by op, the port is bit-equal, except
that XLA on the CPU flushes subnormal float32 results to zero and the
port (like the card, built with -ftz=false) keeps them: where the two
differ, both values must be below the float32 normal range.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu.ops import ds as jds
from ppls_tpu_torch.models import integrands as tint
from ppls_tpu_torch.ops import ds as tds
from ppls_tpu_torch.ops import ds_kernel as tdk
from ppls_tpu_torch.ops import scout_kernel as tsk
from ppls_tpu_torch.ops.pow2 import pow2_f32, pow2_f64

N = 4096
TOL = 1e-13


def _split(x64):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _rand(rng, lo, hi, signed=True):
    x = rng.uniform(lo, hi, N)
    if signed:
        x = x * rng.choice([-1.0, 1.0], N)
    return x


def _value(pair):
    """float64 value of a (hi, lo) pair of torch or jax arrays."""
    return (np.asarray(pair[0], dtype=np.float64)
            + np.asarray(pair[1], dtype=np.float64))


def _t(pair):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in pair)


def _j(pair):
    return tuple(jnp.asarray(p) for p in pair)


def _rel(got, want, floor=0.0):
    return np.max(np.abs(got - want) / np.maximum(np.abs(want), floor))


_TINY = np.finfo(np.float32).tiny


def _bits_equal_but_ftz(got, ref):
    """float32 arrays bit-equal except where XLA flushed a subnormal:
    there both must lie below the normal range. Returns the number of
    such lanes."""
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    diff = got.view(np.int32) != ref.view(np.int32)
    assert np.all(np.abs(got[diff]) < _TINY), got[diff][:8]
    assert np.all(np.abs(ref[diff]) < _TINY), ref[diff][:8]
    return int(diff.sum())


def _twin(name):
    """A ds twin by test name: "<family>" or "<family>@reduced"."""
    fam, _, tag = name.partition("@")
    return fam, tint.get_family_ds(fam, reduced=tag == "reduced")


def _ref_twin(name):
    from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
    fam, _, tag = name.partition("@")
    return ref_family_ds(fam, reduced=tag == "reduced")


# the theta range of a family's twin checks where 0.5-1.5 does not fit:
# gauss_center's theta is its centre
TH_RANGE = {"gauss_center": (0.4995, 0.5005)}


BINARY = {
    "ds_add": (np.add, (0.1, 10.0)),
    "ds_sub": (np.subtract, (0.1, 10.0)),
    "ds_mul": (np.multiply, (0.1, 10.0)),
    "ds_div": (np.divide, (0.1, 10.0)),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_ops_vs_f64_and_reference(name):
    rng = np.random.default_rng(1)
    fn, (lo, hi) = BINARY[name]
    x = _split(_rand(rng, lo, hi))
    y = _split(_rand(rng, lo, hi))
    want = fn(_value(x), _value(y))
    got = _value(getattr(tdk, name)(_t(x), _t(y)))
    ref = _value(getattr(jds, name)(_j(x), _j(y)))
    # a sum's error is relative to its operands' magnitude (cancellation)
    scale = (np.abs(_value(x)) + np.abs(_value(y))
             if name in ("ds_add", "ds_sub") else np.abs(want))
    assert np.max(np.abs(got - want) / scale) <= TOL
    assert np.max(np.abs(got - ref) / scale) <= TOL


def test_mixed_precision_ops():
    rng = np.random.default_rng(2)
    x = _split(_rand(rng, 0.1, 10.0))
    b = _rand(rng, 0.1, 10.0).astype(np.float32)
    tb = torch.from_numpy(b)
    for name, fn in (("ds_add_f32", np.add), ("ds_mul_f32", np.multiply)):
        want = fn(_value(x), b.astype(np.float64))
        got = _value(getattr(tdk, name)(_t(x), tb))
        ref = _value(getattr(jds, name)(_j(x), jnp.asarray(b)))
        assert _rel(got, want) <= TOL, name
        assert _rel(got, ref) <= TOL, name
    # exact scaling by powers of two, negation, |x|, select
    assert np.array_equal(_value(tdk.ds_mul_pow2(_t(x), 0.25)),
                          _value(x) * 0.25)
    assert np.array_equal(_value(tdk.ds_neg(_t(x))), -_value(x))
    assert np.array_equal(_value(tdk.ds_abs(_t(x))), np.abs(_value(x)))
    c = rng.random(N) < 0.5
    sel = tdk.ds_where(torch.from_numpy(c), _t(x), tdk.ds_neg(_t(x)))
    assert np.array_equal(_value(sel), np.where(c, _value(x), -_value(x)))


def test_error_free_transforms_are_exact():
    rng = np.random.default_rng(3)
    a = _rand(rng, 1e-3, 1e3).astype(np.float32)
    b = _rand(rng, 1e-3, 1e3).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    s, e = tdk.two_sum(ta, tb)
    assert np.array_equal(_value((s, e)), a64 + b64)
    p, e = tdk.two_prod(ta, tb)
    assert np.array_equal(_value((p, e)), a64 * b64)
    # the scalar path (float32 constants split in float32) agrees with
    # the tensor path bit for bit
    k = float(np.float32(1.5707963267948966))
    p1, e1 = tdk.two_prod(ta, k)
    p2, e2 = tdk.two_prod(ta, torch.full_like(ta, k))
    assert torch.equal(p1, p2) and torch.equal(e1, e2)


# ds_sin's own accuracy against float64 truth is ~4e-13 absolute in the
# reference algorithm (measured over |x| <= 1e3; beyond that the
# three-limb pi/2, whose residual is 6.1e-17, adds |x| * 4e-17): its
# truth bound is 1e-12. Against the reference library the port is held
# to 1e-13 over the whole validity range.
@pytest.mark.parametrize("name,hi,hi_ref,truth,tol", [
    ("ds_sin", 100.0, 2e4, np.sin, 1e-12),
    ("ds_exp", 20.0, 80.0, np.exp, TOL),
])
def test_transcendentals_vs_f64_and_reference(name, hi, hi_ref, truth, tol):
    rng = np.random.default_rng(4)
    x = _split(_rand(rng, 1e-3, hi))
    got = _value(getattr(tdk, name)(_t(x)))
    assert _rel(got, truth(_value(x)), floor=1.0) <= tol
    x = _split(_rand(rng, 1e-3, hi_ref))
    got = _value(getattr(tdk, name)(_t(x)))
    ref = _value(getattr(jds, name)(_j(x)))
    assert _rel(got, ref, floor=1.0) <= TOL


@pytest.mark.parametrize("fam,lo,hi,truth,tol", [
    # |theta / x| <= 100; ds_sin's own bound (see above)
    ("sin_recip_scaled", 2e-2, 1.0, lambda x, t: np.sin(t / x), 1e-12),
    # cosh^4(u) turns the ds rounding of u = theta x into 4 u times as
    # much relative error: ~2e-13 at u = 7.5
    ("cosh4_scaled", 0.0, 5.0, lambda x, t: np.cosh(t * x) ** 4, 4e-13),
    # the range-reduced twins, held as their reference twins
    ("sin_recip_scaled@reduced", 2e-2, 1.0, lambda x, t: np.sin(t / x),
     1e-12),
    ("cosh4_scaled@reduced", 0.0, 5.0, lambda x, t: np.cosh(t * x) ** 4,
     4e-13),
    # |theta x| <= 75
    ("sin_scaled", 0.0, 50.0, lambda x, t: np.sin(t * x), 1e-12),
    ("sin_scaled@reduced", 0.0, 50.0, lambda x, t: np.sin(t * x), 1e-12),
    # x - c cancels: the float32 sum of the lo limbs (~2e-15 absolute)
    # on |d| <= 2.5e-3 puts up to ~5e-12 on z = -500000 d^2, so on
    # exp(z) <= 1 (measured 1.1e-12)
    ("gauss_center", 0.498, 0.502,
     lambda x, c: np.exp(-0.5 * ((x - c) / 1e-3) ** 2), 1e-11),
    ("quad_scaled", 0.0, 1.0, lambda x, t: t * x * x, TOL),
])
def test_integrand_ds_twins_vs_f64_and_reference(fam, lo, hi, truth, tol):
    # against float64 truth, against the reference's fenced ds library
    # (which has no ds_sin_pi: there its reduced sin twins use ds_sin),
    # and bit for bit against the reference's kernel library op by op
    from ppls_tpu.ops import ds_kernel as jdk
    rng = np.random.default_rng(5)
    x = _split(rng.uniform(lo, hi, N))
    th = _split(rng.uniform(*TH_RANGE.get(fam.partition("@")[0],
                                          (0.5, 1.5)), N))
    got_pair = _twin(fam)[1](_t(x), _t(th))
    got = _value(got_pair)
    assert _rel(got, truth(_value(x), _value(th)), floor=1.0) <= tol
    # the fenced library has no ds_sin_pi: there the reduced sin twins
    # run ds_sin, another algorithm, held at the twin's truth bound
    ref = _value(_ref_twin(fam)(_j(x), _j(th), dsm=jds))
    assert _rel(got, ref, floor=1.0) <= (tol if "@" in fam else TOL)
    ref_pair = _ref_twin(fam)(_j(x), _j(th), dsm=jdk)
    for g, r in zip(got_pair, ref_pair):
        assert _bits_equal_but_ftz(g.numpy(), r) == 0


@pytest.mark.parametrize("fam,lo,hi", [("sin_recip_scaled", 1e-2, 1.0),
                                       ("cosh4_scaled", 0.0, 5.0)])
def test_scout_twins_are_float32_accurate(fam, lo, hi):
    # the scout pass is plain float32: ~1e-6 relative to the function's
    # magnitude, with every lo limb +0.0
    rng = np.random.default_rng(6)
    x = rng.uniform(lo, hi, N).astype(np.float32)
    th = rng.uniform(1.0, 1.5, N).astype(np.float32)
    z = torch.zeros(N, dtype=torch.float32)
    f_sc = tint.get_family_ds(fam)
    hi_t, lo_t = f_sc((torch.from_numpy(x), z), (torch.from_numpy(th), z),
                      dsm=tsk)
    want = tint.get_family(fam)(torch.from_numpy(x).double(),
                                torch.from_numpy(th).double()).numpy()
    assert np.all(lo_t.numpy() == 0.0)
    scale = np.maximum(np.abs(want), 1.0)
    assert np.max(np.abs(hi_t.numpy() - want) / scale) < 2e-5


@pytest.mark.parametrize("fam,sample", [
    # the flagship's small-x end: x in [1e-4, 1e-2], |theta / x| to 2e4
    ("sin_recip_scaled", lambda rng: 10.0 ** rng.uniform(-4.0, -2.0, N)),
    ("cosh4_scaled", lambda rng: rng.uniform(0.0, 5.0, N)),
    ("sin_recip_scaled@reduced",
     lambda rng: 10.0 ** rng.uniform(-4.0, -2.0, N)),
    ("cosh4_scaled@reduced", lambda rng: rng.uniform(-5.0, 5.0, N)),
    ("sin_scaled", lambda rng: rng.uniform(0.0, 50.0, N)),
    ("sin_scaled@reduced", lambda rng: rng.uniform(0.0, 50.0, N)),
    # out to the underflow of exp(-500000 (x - c)^2)
    ("gauss_center", lambda rng: rng.uniform(0.48, 0.52, N)),
    ("quad_scaled", lambda rng: rng.uniform(0.0, 1.0, N)),
])
def test_scout_twins_bit_equal_to_reference(fam, sample):
    # run op by op (eager jax), the reference's scout surface rounds
    # exactly as the port's does; only gauss_center, whose exp reaches the
    # subnormal range in float32, may differ where XLA flushed one
    from ppls_tpu.ops import scout_kernel as jsk
    rng = np.random.default_rng(8)
    x = sample(rng).astype(np.float32)
    lo, hi = TH_RANGE.get(fam.partition("@")[0], (1.0, 2.0))
    th = rng.uniform(lo, hi, N).astype(np.float32)
    z = np.zeros(N, dtype=np.float32)
    got = _twin(fam)[1](_t((x, z)), _t((th, z)), dsm=tsk)
    ref = _ref_twin(fam)(_j((x, z)), _j((th, z)), dsm=jsk)
    flushed = _bits_equal_but_ftz(got[0].numpy(), ref[0])
    if fam != "gauss_center":
        assert flushed == 0
    assert np.all(got[1].numpy() == 0.0)
    if fam.startswith("sin_recip_scaled"):
        # the float32 rounding of theta / x alone moves sin by up to ~1e-3
        # here (measured 9.6e-4), far beyond the 64-ulp guard band the
        # walker's scout test assumes: there its decisive splits follow
        # rounding noise, in both packages alike
        truth = np.sin(th.astype(np.float64) / x.astype(np.float64))
        assert np.max(np.abs(got[0].numpy() - truth)) > 1e-4


# test_reduced_integrands.py's inputs: +-50, +-2^22 and the pi multiples
# -8 pi .. 8 pi where the reduction switches k
def _sin_pi_inputs():
    rng = np.random.default_rng(5)
    return np.concatenate([rng.uniform(-50.0, 50.0, 2000),
                           rng.uniform(-2.0 ** 22, 2.0 ** 22, 2000),
                           np.pi * np.arange(-8, 9)])


@pytest.mark.parametrize("module", ["ds", "scout"])
def test_ds_sin_pi_bit_equal_to_reference_and_vs_f64(module):
    # op by op against the reference's kernel library; against float64
    # sin of the value the pair holds: ds within 1e-13 up to |x| = 50
    # and 4e-13 * |x| beyond (as ds_sin, the three-limb pi's residual
    # grows with k), float32 within 2e-7 * max(1, |x|) (the float32
    # product k * pi_2 and the rounding of x itself)
    from ppls_tpu.ops import ds_kernel as jdk
    from ppls_tpu.ops import scout_kernel as jsk
    x = _sin_pi_inputs()
    pair = _split(x)
    if module == "scout":
        pair = (pair[0], np.zeros_like(pair[1]))
    t_mod, j_mod = (tdk, jdk) if module == "ds" else (tsk, jsk)
    got = t_mod.ds_sin_pi(_t(pair))
    ref = j_mod.ds_sin_pi(_j(pair))
    flushed = [_bits_equal_but_ftz(g.numpy(), r) for g, r in zip(got, ref)]
    assert flushed[0] == 0 and flushed[1] <= 16
    held = _value(pair)
    err = np.abs(_value(got) - np.sin(held))
    if module == "ds":
        assert np.max(err[:2000]) < 1e-13
        assert np.all(err <= 4e-13 * np.maximum(np.abs(held), 1.0))
        # the ds_sin it replaces, on the same pairs
        assert np.max(np.abs(_value(got) - _value(tdk.ds_sin(_t(pair))))
                      / np.maximum(np.abs(held), 1.0)) < 4e-13
    else:
        assert np.all(got[1].numpy() == 0.0)
        assert np.all(err <= 2e-7 * np.maximum(np.abs(held), 1.0))


def test_pow2_exact():
    k = torch.arange(-130, 130, dtype=torch.int32)
    want = np.where(k.numpy() < -126, 0.0,
                    np.ldexp(1.0, np.clip(k.numpy(), -126, 127)))
    assert np.array_equal(pow2_f32(k).double().numpy(), want)
    k = torch.arange(-252, 253, dtype=torch.int32)
    assert np.array_equal(pow2_f64(k).numpy(), np.ldexp(1.0, k.numpy()))


def test_host_split_helpers_match_reference():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1e3, 1e3, N)
    got = tds.ds_from_f64(torch.from_numpy(x))
    ref = jds.ds_from_f64(jnp.asarray(x))
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert np.array_equal(tds.ds_to_f64(got).numpy(),
                          np.asarray(jds.ds_to_f64(ref)))
    assert int(tdk.mask_count(torch.from_numpy(x > 0))) == int(np.sum(x > 0))


def test_kernel_header_constants_match_python():
    # csrc/walk_step.cuh spells the float32 constants as hex literals;
    # each must be exactly the Python modules' value
    src = (Path(tdk.__file__).resolve().parent.parent / "csrc"
           / "walk_step.cuh").read_text()
    lits = dict(re.findall(r"(K_\w+) = (-?0x[0-9a-fp.+-]+|-?[0-9.]+)f",
                           src))

    def c(name):
        return float.fromhex(lits[name]) if "0x" in lits[name] \
            else float(lits[name])

    pairs = {"K_PI_1": tdk._PI_1, "K_PI_2": tdk._PI_2, "K_PI_3": tdk._PI_3,
             "K_INV_PI": tdk._INV_PI, "K_S15P": tdk._S15P,
             "K_S17P": tdk._S17P, "K_S19P": tdk._S19P, "K_S21P": tdk._S21P,
             "K_GAUSS_SCALE": -500000.0,
             "K_PIO2_1": tdk._PIO2_1, "K_PIO2_2": tdk._PIO2_2,
             "K_PIO2_3": tdk._PIO2_3, "K_TWO_OVER_PI": tdk._TWO_OVER_PI,
             "K_S11": tdk._S11, "K_S13": tdk._S13, "K_C10": tdk._C10,
             "K_C12": tdk._C12, "K_LN2_1": tdk._LN2_1,
             "K_LN2_2": tdk._LN2_2, "K_LN2_3": tdk._LN2_3,
             "K_LOG2E": tdk._LOG2E, "K_E10": tdk._E10, "K_E11": tdk._E11,
             "K_E12": tdk._E12}
    for n in ("S3", "S5", "S7", "S9", "C2", "C4", "C6", "C8", "E3", "E4",
              "E5", "E6", "E7", "E8", "E9", "S11P", "S13P"):
        hi, lo = getattr(tdk, "_" + n)
        pairs[f"K_{n}_H"], pairs[f"K_{n}_L"] = hi, lo
    # ds_sin_pi's S3..S9 are ds_sin's limbs, which the header shares
    for n in ("S3", "S5", "S7", "S9"):
        assert getattr(tdk, f"_{n}P") == getattr(tdk, "_" + n), n
    for n in ("S3", "S5", "S7", "S9", "S11", "S13", "C2", "C4", "C6", "C8",
              "C10", "E2", "E3", "E4", "E5", "E6", "E7"):
        pairs[f"K_SC_{n}"] = getattr(tsk, "_" + n)
    from ppls_tpu_torch.parallel import walker as TW
    pairs["K_SCOUT_BAND"] = TW._SCOUT_BAND
    # the Simpson scalings: the port's limbs and the reference's dsc()
    # construction (walker.py step_simpson), hi and lo
    for n, x in (("SIXTH", 6.0), ("TWELFTH", 12.0), ("FIFTEENTH", 15.0)):
        hi, lo = getattr(TW, f"SIMPSON_{n}")
        ref_hi = np.float32(1.0 / x)
        assert (hi, lo) == (float(ref_hi), float(np.float32(
            1.0 / x - np.float64(ref_hi)))), n
        pairs[f"K_{n}_H"], pairs[f"K_{n}_L"] = hi, lo
    for name, want in pairs.items():
        assert c(name) == want, name
    # lane flags and step machines
    ints = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    for name in ("MODE_LOAD", "PARKED", "NO_ROOT", "OVF", "MODE_INIT",
                 "MODE_LOADM", "MODE_TESTB"):
        assert int(ints[name]) == getattr(TW, "_" + name), name
    for name in ("STEP_TRAP", "STEP_SCOUT", "STEP_SIMPSON"):
        assert int(ints[name]) == getattr(TW, name), name
    # the integrand ids the kernels dispatch on, one per ds twin
    from ppls_tpu_torch.models import integrands as TI
    for name, fam in (("FAMILY_SIN_RECIP", "sin_recip_scaled"),
                      ("FAMILY_COSH4", "cosh4_scaled"),
                      ("FAMILY_SIN_SCALED", "sin_scaled"),
                      ("FAMILY_QUAD_SCALED", "quad_scaled"),
                      ("FAMILY_GAUSS_CENTER", "gauss_center"),
                      ("FAMILY_SIN_RECIP_REDUCED", "sin_recip_scaled"),
                      ("FAMILY_COSH4_REDUCED", "cosh4_scaled"),
                      ("FAMILY_SIN_SCALED_REDUCED", "sin_scaled")):
        want = getattr(TI, "KERNEL_" + name[len("FAMILY_"):])
        twin = TI.get_family_ds(fam, reduced=name.endswith("_REDUCED"))
        assert int(ints[name]) == want == twin.kernel_family, name
    assert len({int(v) for n, v in ints.items()
                if n.startswith("FAMILY_")}) \
        == len(TI.DS_FAMILIES) + len(TI.DS_FAMILIES_REDUCED)


# --- the registry, the closed forms and the float64 models ------------------

@pytest.mark.parametrize("name", ["sin_recip_scaled", "sin_scaled",
                                  "cosh4_scaled", "gauss_center",
                                  "quad_scaled"])
def test_reduced_registry_fallback_and_domain_checks(name):
    # reduced=True picks a family's range-reduced twin where it has one,
    # else its ds twin itself; the reduced twins carry their families'
    # domain checks, with the same messages
    from ppls_tpu.models import integrands as RI
    from ppls_tpu_torch.parallel.walker import _is_reduced_twin
    plain = tint.get_family_ds(name)
    reduced = tint.get_family_ds(name, reduced=True)
    has = name in RI.DS_FAMILIES_REDUCED
    assert (name in tint.DS_FAMILIES_REDUCED) == has
    assert (reduced is plain) == (not has)
    assert _is_reduced_twin(reduced) == has and not _is_reduced_twin(plain)
    if has:
        assert reduced.kernel_family != plain.kernel_family
    bad = {"sin_recip_scaled": ([[1e-9, 1.0]], [100.0]),
           "sin_scaled": ([[0.0, 1e6]], [100.0]),
           "cosh4_scaled": ([[0.0, 5.0]], [5.0])}.get(name)
    for twin, ref in ((plain, RI.get_family_ds(name)),
                      (reduced, RI.get_family_ds(name, reduced=True))):
        if bad is None:
            # gauss_center and quad_scaled: every input is in the domain
            assert getattr(twin, "ds_domain_check", None) is None
            assert getattr(ref, "ds_domain_check", None) is None
            tint.check_ds_domain(twin, [[-1e30, 1e30]], [1e30])
            continue
        with pytest.raises(ValueError) as got:
            tint.check_ds_domain(twin, *bad)
        with pytest.raises(ValueError) as want:
            ref.ds_domain_check(np.array(bad[0]), np.array(bad[1]))
        assert str(got.value) == str(pytest.raises(
            ValueError, tint.check_ds_domain, plain, *bad).value)
        head = str(got.value).split(":")[0]
        assert str(want.value).startswith(head)
        if name != "cosh4_scaled":
            assert "Cody-Waite" in str(got.value)
    with pytest.raises(KeyError, match="no ds twin"):
        tint.get_family_ds("no_such_family", reduced=True)


@pytest.mark.parametrize("name,a,b,theta", [
    ("sin_recip_scaled", 1e-2, 1.0, [1.0, 1.5]),
    ("sin_scaled", 0.0, 1.0, [1.0, 4.0]),
    ("cosh4_scaled", 0.0, 5.0, [1.0, 2.0]),
    ("gauss_center", 0.4, 0.6, [0.4995, 0.5, 0.5005]),
    ("quad_scaled", 0.0, 1.0, list(1.0 + np.arange(8) / 4.0)),
])
def test_closed_forms_match_reference(name, a, b, theta):
    # the vectorised forms equal the reference's, and lie within 1e-13
    # relative of the reference's 40-digit mpmath forms
    from ppls_tpu.models import integrands as RI
    vec = tint.family_exact(name, a, b, theta)
    assert np.array_equal(vec, RI.family_exact(name, a, b, theta,
                                               prefer_vec=True))
    mp = RI.family_exact(name, a, b, theta, prefer_vec=False)
    assert np.max(np.abs(vec - mp) / np.abs(mp)) < 1e-13
    if name == "quad_scaled":
        assert np.array_equal(vec, np.asarray(theta) / 3.0)


def test_reduced_f64_models_match_reference():
    # the float64 models of the reduced forms equal the reference's, and
    # hold its ulp protocol (tests/test_reduced_integrands.py): sin within
    # 1 ulp of numpy's sin(theta / x) on the flagship's domain, cosh^4
    # within 2 ulp of 40-digit truth on u in [0, 10]
    import mpmath
    from ppls_tpu.models import integrands as RI
    rng = np.random.default_rng(12)
    u = rng.uniform(0.0, 10.0, 200)
    red = tint.cosh4_scaled_reduced_f64(u, 1.0)
    assert np.array_equal(red, RI.cosh4_scaled_reduced_f64(u, 1.0))
    with mpmath.workdps(40):
        truth = np.array([float(mpmath.cosh(mpmath.mpf(float(v))) ** 4)
                          for v in u])
    assert np.max(np.abs(red - truth) / np.spacing(truth)) <= 2.0
    x = rng.uniform(1e-4, 1.0, 4000)
    for th in (1.0, 1.5, 1.9999):
        red = tint.sin_recip_scaled_reduced_f64(x, th)
        assert np.array_equal(red, RI.sin_recip_scaled_reduced_f64(x, th))
        ref = np.sin(th / x)
        assert np.max(np.abs(red - ref) / np.spacing(
            np.maximum(np.abs(ref), 1e-300))) <= 1.0
    a, b = rng.uniform(-1e3, 1e3, (2, 1000))
    p, e = tint._two_prod_f64(a, b)
    rp, re_ = RI._two_prod_f64(a, b)
    assert np.array_equal(p, rp) and np.array_equal(e, re_)
