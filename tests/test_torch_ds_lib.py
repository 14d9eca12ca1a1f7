"""The port's host-level ds library (ppls_tpu_torch/ops/ds.py) against
the reference's (ppls_tpu/ops/ds.py), on seeded numpy inputs.

* Op by op (the reference with ``jax.disable_jit``): every function of
  the library is bit-equal, except that XLA on the CPU flushes subnormal
  float32 results to zero and PyTorch keeps them; where the two differ,
  both values lie below the float32 normal range
  (tests/test_torch_ds.py ``_bits_equal_but_ftz``).
* Under ``jax.jit``: the fenced transforms and every function built only
  of them are bit-equal; XLA contracts the unfenced cross products of
  ds_mul, ds_mul_f32 and ds_div (and so of ds_sin, ds_cos and ds_exp)
  into FMAs, so those are held to 8 units of ulp(hi) * 2^-24 (one ds
  ulp; measured: at most 4), on normal-range results.
* Accuracy against numpy: the checks of tests/test_ds.py, with the
  reference's tolerances, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu.ops import ds as jds
from ppls_tpu_torch.ops import ds as tds

from test_torch_ds import _bits_equal_but_ftz

N = 1 << 14
JIT_ULPS = 8


def _split(x64):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _t(pair):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in pair)


def _j(pair):
    return tuple(jnp.asarray(p) for p in pair)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = _split(rng.uniform(-100.0, 100.0, N))
    y = _split(rng.uniform(0.1, 100.0, N) * rng.choice([-1.0, 1.0], N))
    return x, y, rng


def _cases():
    """name -> (args from (x, y, rng), function of the ds module): every
    function of the library, on seeded pairs (x, y)."""
    def cond(x, y, rng):
        return (rng.random(N) < 0.5, x, y)

    def ds_arg(lo, hi):
        return lambda x, y, rng: (_split(rng.uniform(lo, hi, N)),)
    return {
        "two_sum": (lambda x, y, rng: (x[0], y[0]), "two_sum"),
        "quick_two_sum": (lambda x, y, rng: (x[0], y[1]), "quick_two_sum"),
        "two_prod": (lambda x, y, rng: (x[0], y[0]), "two_prod"),
        "ds_neg": (lambda x, y, rng: (x,), "ds_neg"),
        "ds_add": (lambda x, y, rng: (x, y), "ds_add"),
        "ds_sub": (lambda x, y, rng: (x, y), "ds_sub"),
        "ds_add_f32": (lambda x, y, rng: (x, y[0]), "ds_add_f32"),
        "ds_mul": (lambda x, y, rng: (x, y), "ds_mul"),
        "ds_mul_f32": (lambda x, y, rng: (x, y[0]), "ds_mul_f32"),
        "ds_mul_pow2": (lambda x, y, rng: (x, 0.125), "ds_mul_pow2"),
        "ds_div": (lambda x, y, rng: (x, y), "ds_div"),
        "ds_abs": (lambda x, y, rng: (y,), "ds_abs"),
        "ds_lt": (lambda x, y, rng: (x, (x[0], y[1])), "ds_lt"),
        "ds_gt": (lambda x, y, rng: (x, (x[0], y[1])), "ds_gt"),
        "ds_where": (cond, "ds_where"),
        "ds_sin": (ds_arg(-30.0, 30.0), "ds_sin"),
        "ds_sin_large": (ds_arg(1.0, 2e4), "ds_sin"),
        "ds_cos": (ds_arg(-10.0, 10.0), "ds_cos"),
        "ds_exp": (ds_arg(-50.0, 5.0), "ds_exp"),
        "ds_exp_deep": (ds_arg(-85.0, -50.0), "ds_exp"),
    }


CASES = _cases()
# built only of fenced transforms: bit-equal under jit as well
JIT_EXACT = {"two_sum", "quick_two_sum", "two_prod", "ds_neg", "ds_add",
             "ds_sub", "ds_add_f32", "ds_mul_pow2", "ds_abs", "ds_lt",
             "ds_gt", "ds_where"}


def _conv(v, to):
    if isinstance(v, tuple):
        return tuple(_conv(p, to) for p in v)
    if isinstance(v, np.ndarray):
        return (torch.from_numpy(np.ascontiguousarray(v)) if to == "t"
                else jnp.asarray(v))
    return v


def _run(name, seed, jit):
    make, fname = CASES[name]
    x, y, rng = _inputs(seed)
    args = make(x, y, rng)
    got = getattr(tds, fname)(*_conv(args, "t"))
    ref_fn = getattr(jds, fname)
    if jit:
        ref = jax.jit(lambda *a: ref_fn(*a))(*_conv(args, "j"))
    else:
        with jax.disable_jit():
            ref = ref_fn(*_conv(args, "j"))
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("name", sorted(CASES))
def test_bit_equal_op_by_op(name):
    got, ref = _run(name, 3, jit=False)
    for g, r in zip(got, ref):
        if g.dtype == np.bool_:
            assert np.array_equal(g, r)
        else:
            assert g.dtype == np.float32
            _bits_equal_but_ftz(g, r)


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if n != "ds_exp_deep"))
def test_under_jit(name):
    got, ref = _run(name, 4, jit=True)
    if name in JIT_EXACT:
        for g, r in zip(got, ref):
            assert np.array_equal(g.view(np.uint8), r.view(np.uint8))
        return
    value = got[0].astype(np.float64) + got[1].astype(np.float64)
    rvalue = ref[0].astype(np.float64) + ref[1].astype(np.float64)
    unit = np.spacing(np.abs(got[0])).astype(np.float64) * 2.0 ** -24
    assert np.all(np.abs(value - rvalue) <= JIT_ULPS * unit)


def test_ds_const_and_zero_like():
    like = torch.zeros(3, 5)
    for v in (0.1, -1.0 / 3.0, 1e-30, 7.0):
        got = tds.ds_const(v, like=like)
        ref = jds.ds_const(v, like=jnp.zeros((3, 5), jnp.float32))
        for g, r in zip(got, ref):
            assert g.shape == (3, 5) and g.dtype == torch.float32
            assert np.array_equal(g.numpy(), np.asarray(r))
        pair = tds.ds_const(v, like=(like, like))
        assert pair[0].shape == (3, 5)
        scalar = tds.ds_const(v)
        rs = jds.ds_const(v)
        assert scalar[0].shape == () and float(scalar[0]) == float(rs[0])
        assert float(scalar[1]) == float(rs[1])
    z = tds.ds_zero_like(torch.ones(4, dtype=torch.float32))
    assert z[0].dtype == torch.float32 and not z[0].any() \
        and not z[1].any()


# ---------------------------------------------------------------------------
# accuracy, tests/test_ds.py's checks on the port
# ---------------------------------------------------------------------------


def _rand(n, lo, hi, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, n)


def _to_ds(x):
    return tds.ds_from_f64(torch.from_numpy(np.asarray(x, np.float64)))


def _rep(x):
    hi, lo = _to_ds(x)
    return hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)


def _err(ds_val, ref):
    return np.abs(tds.ds_to_f64(ds_val).numpy() - ref)


def test_split_roundtrip():
    x = _rand(1000, -1e6, 1e6)
    np.testing.assert_allclose(_rep(x), x, rtol=2 ** -47)


@pytest.mark.parametrize("op,ref", [
    ("ds_add", np.add), ("ds_sub", np.subtract),
    ("ds_mul", np.multiply), ("ds_div", np.divide)])
def test_arith_close_to_f64(op, ref):
    a = _rand(4096, -100.0, 100.0, seed=1)
    b = _rand(4096, 0.1, 100.0, seed=2)
    got = getattr(tds, op)(_to_ds(a), _to_ds(b))
    expected = ref(_rep(a), _rep(b))
    scale = np.maximum(np.maximum(np.abs(_rep(a)), np.abs(_rep(b))),
                       np.abs(expected))
    assert (_err(got, expected) / scale).max() < 2 ** -46


def test_mul_exactness_small_ints():
    a = np.arange(1.0, 100.0)
    got = tds.ds_to_f64(tds.ds_mul(_to_ds(a), _to_ds(a))).numpy()
    np.testing.assert_array_equal(got, a * a)


def test_comparisons():
    a = np.array([1.0, 1.0, 2.0])
    b = np.array([1.0 + 1e-12, 1.0, 1.0])
    assert tds.ds_lt(_to_ds(a), _to_ds(b)).tolist() == [True, False, False]
    assert tds.ds_gt(_to_ds(a), _to_ds(b)).tolist() == [False, False, True]


@pytest.mark.parametrize("lo,hi,seed,tol", [
    (-0.78, 0.78, 3, 5e-14),       # small arguments
    (-30.0, 30.0, 4, 5e-13),       # medium
    (1.0, 2e4, 5, 2e-11),          # the deep-quadrature regime
    (1e-4, 2e-3, 6, 1e-14),        # small magnitudes
])
def test_ds_sin_accuracy(lo, hi, seed, tol):
    x = _rand(1 << 14, lo, hi, seed=seed)
    assert _err(tds.ds_sin(_to_ds(x)), np.sin(_rep(x))).max() < tol


def test_ds_cos():
    x = _rand(1 << 12, -10.0, 10.0, seed=7)
    assert _err(tds.ds_cos(_to_ds(x)), np.cos(_rep(x))).max() < 5e-13


def test_ds_exp_accuracy():
    x = np.concatenate([np.linspace(-50.0, 5.0, 8192),
                        np.linspace(-1e-3, 1e-3, 512)])
    got = tds.ds_to_f64(tds.ds_exp(_to_ds(x))).numpy()
    ref = np.exp(x)
    assert (np.abs(got - ref) / np.abs(ref)).max() < 1e-12
    # below exp(-50) the lo limb runs out of range: f32-hi accuracy
    xt = np.linspace(-85.0, -50.0, 1024)
    got = tds.ds_to_f64(tds.ds_exp(_to_ds(xt))).numpy()
    assert np.abs(got - np.exp(xt)).max() < 1e-28
