"""Port ds arithmetic (ppls_tpu_torch/ops) against float64 ground truth
and against the reference's fenced ds library (ppls_tpu/ops/ds.py).

The port's ``ops/ds_kernel.py`` is the plain version of the walk
kernel's device library; the reference's XLA-level ``ops/ds.py`` runs
the same algorithms with NaN fences. Inputs are made with numpy from a
seed and handed to both. Tolerance: 1e-13 relative (ds carries ~48
mantissa bits, ~7e-15); a sum's error is taken relative to its operands
and a transcendental's as 1e-13 * max(1, |truth|).
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
])
def test_integrand_ds_twins_vs_f64_and_reference(fam, lo, hi, truth, tol):
    from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
    rng = np.random.default_rng(5)
    x = _split(rng.uniform(lo, hi, N))
    th = _split(rng.uniform(0.5, 1.5, N))
    got = _value(tint.get_family_ds(fam)(_t(x), _t(th)))
    assert _rel(got, truth(_value(x), _value(th)), floor=1.0) <= tol
    ref = _value(ref_family_ds(fam)(_j(x), _j(th), dsm=jds))
    assert _rel(got, ref, floor=1.0) <= TOL


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
])
def test_scout_twins_bit_equal_to_reference(fam, sample):
    # run op by op (eager jax), the reference's scout surface rounds
    # exactly as the port's does
    from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
    from ppls_tpu.ops import scout_kernel as jsk
    rng = np.random.default_rng(8)
    x = sample(rng).astype(np.float32)
    th = rng.uniform(1.0, 2.0, N).astype(np.float32)
    z = np.zeros(N, dtype=np.float32)
    got = tint.get_family_ds(fam)(_t((x, z)), _t((th, z)), dsm=tsk)[0]
    ref = ref_family_ds(fam)(_j((x, z)), _j((th, z)), dsm=jsk)[0]
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(ref).view(np.int32))
    if fam == "sin_recip_scaled":
        # the float32 rounding of theta / x alone moves sin by up to ~1e-3
        # here (measured 9.6e-4), far beyond the 64-ulp guard band the
        # walker's scout test assumes: there its decisive splits follow
        # rounding noise, in both packages alike
        truth = np.sin(th.astype(np.float64) / x.astype(np.float64))
        assert np.max(np.abs(got.numpy() - truth)) > 1e-4


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

    pairs = {"K_PIO2_1": tdk._PIO2_1, "K_PIO2_2": tdk._PIO2_2,
             "K_PIO2_3": tdk._PIO2_3, "K_TWO_OVER_PI": tdk._TWO_OVER_PI,
             "K_S11": tdk._S11, "K_S13": tdk._S13, "K_C10": tdk._C10,
             "K_C12": tdk._C12, "K_LN2_1": tdk._LN2_1,
             "K_LN2_2": tdk._LN2_2, "K_LN2_3": tdk._LN2_3,
             "K_LOG2E": tdk._LOG2E, "K_E10": tdk._E10, "K_E11": tdk._E11,
             "K_E12": tdk._E12}
    for n in ("S3", "S5", "S7", "S9", "C2", "C4", "C6", "C8", "E3", "E4",
              "E5", "E6", "E7", "E8", "E9"):
        hi, lo = getattr(tdk, "_" + n)
        pairs[f"K_{n}_H"], pairs[f"K_{n}_L"] = hi, lo
    for n in ("S3", "S5", "S7", "S9", "S11", "C2", "C4", "C6", "C8", "C10",
              "E2", "E3", "E4", "E5", "E6", "E7"):
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
                      ("FAMILY_SIN_SCALED", "sin_scaled")):
        want = getattr(TI, "KERNEL_" + name[len("FAMILY_"):])
        assert int(ints[name]) == want \
            == TI.get_family_ds(fam).kernel_family, name
    assert len({int(v) for n, v in ints.items()
                if n.startswith("FAMILY_")}) == len(TI.DS_FAMILIES)
