"""Port reductions (ppls_tpu_torch/ops/reduction.py) against the
reference (ppls_tpu/ops/reduction.py), bit for bit.

``exact_segment_sum`` is error-free in both packages (every partial sum
of its digit-plane product is an integer below 2^24), so the port must
reproduce the reference's result exactly on arbitrary leaves.
``segment_sum_auto``'s m == 1 and m <= 256 tiers are ordinary float64
reductions whose order the backend picks; they are held bit-equal on
leaves whose sums are exact in any order (dyadic values), and the
m > 256 tier (the exact one) on arbitrary leaves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu.ops import reduction as jred
from ppls_tpu_torch.ops import reduction as tred


def _leaves(rng, n, dyadic=False):
    if dyadic:
        return rng.integers(-2 ** 20, 2 ** 20, n) * 2.0 ** -30
    mag = 10.0 ** rng.uniform(-12, 2, n)
    leaf = mag * rng.choice([-1.0, 1.0], n)
    leaf[rng.random(n) < 0.1] = 0.0
    return leaf


@pytest.mark.parametrize("m,n", [(1024, 4096), (300, 1000), (8, 512),
                                 (65536, 2048), (5, 147456)])
def test_exact_segment_sum_bit_equal(m, n):
    rng = np.random.default_rng(m + n)
    fam = rng.integers(0, m, n).astype(np.int32)
    leaf = _leaves(rng, n)
    got = tred.exact_segment_sum(torch.from_numpy(fam),
                                 torch.from_numpy(leaf), m, n).numpy()
    ref = np.asarray(jred.exact_segment_sum(jnp.asarray(fam),
                                            jnp.asarray(leaf), m, n))
    assert got.dtype == np.float64 and got.shape == (m,)
    assert np.array_equal(got, ref)


POISONS = {"nan": [np.nan], "inf": [np.inf], "-inf": [-np.inf],
           "both_infs": [np.inf, -np.inf], "nan_and_inf": [np.nan, np.inf]}


@pytest.mark.parametrize("poison", list(POISONS))
def test_exact_segment_sum_keeps_non_finite_leaves_in_their_segment(poison):
    """A non-finite leaf makes its own segment NaN and no other
    (nan_policy's quarantine rests on it), every other segment bit-equal
    to the sum without it; the reference's contraction scales by the
    largest |leaf|, so there the poison reaches every segment
    (pinned)."""
    m, n = 300, 1000
    rng = np.random.default_rng(7)
    fam = rng.integers(0, m, n).astype(np.int32)
    fam[:2] = 17                       # the poisoned segment
    clean = _leaves(rng, n)
    clean[:2] = 0.0
    leaf = clean.copy()
    vals = POISONS[poison]
    leaf[:len(vals)] = vals
    got = tred.exact_segment_sum(torch.from_numpy(fam),
                                 torch.from_numpy(leaf), m, n).numpy()
    base = tred.exact_segment_sum(torch.from_numpy(fam),
                                  torch.from_numpy(clean), m, n).numpy()
    others = np.arange(m) != 17
    assert np.array_equal(got[others], base[others])
    assert np.isnan(got[17])
    ref = np.asarray(jred.exact_segment_sum(jnp.asarray(fam),
                                            jnp.asarray(leaf), m, n))
    assert not np.isfinite(ref).any()


def test_exact_segment_sum_all_zero_is_zero():
    fam = torch.zeros(64, dtype=torch.int32)
    out = tred.exact_segment_sum(fam, torch.zeros(64, dtype=torch.float64),
                                 300, 64)
    assert torch.equal(out, torch.zeros(300, dtype=torch.float64))


@pytest.mark.parametrize("m,dyadic", [(1, True), (8, True), (256, True),
                                      (1024, False)])
def test_segment_sum_auto_bit_equal(m, dyadic):
    rng = np.random.default_rng(m)
    n = 8192
    fam = rng.integers(0, m, n).astype(np.int32)
    leaf = _leaves(rng, n, dyadic=dyadic)
    got = tred.segment_sum_auto(torch.from_numpy(fam),
                                torch.from_numpy(leaf), m, n).numpy()
    ref = np.asarray(jred.segment_sum_auto(jnp.asarray(fam),
                                           jnp.asarray(leaf), m, n,
                                           force_exact=False))
    assert np.array_equal(got, ref)


def test_segment_sum_auto_plain_tiers_within_one_ulp():
    # arbitrary leaves through the plain float64 tiers: a different
    # summation order may move the last bits only
    rng = np.random.default_rng(11)
    n, m = 8192, 64
    fam = rng.integers(0, m, n).astype(np.int32)
    leaf = _leaves(rng, n)
    got = tred.segment_sum_auto(torch.from_numpy(fam),
                                torch.from_numpy(leaf), m, n).numpy()
    exact = np.asarray(jred.exact_segment_sum(jnp.asarray(fam),
                                              jnp.asarray(leaf), m, n))
    scale = np.array([np.sum(np.abs(leaf[fam == j])) for j in range(m)])
    assert np.all(np.abs(got - exact) <= 1e-15 * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ground_truth(fam, leaf, m):
    """Per-segment sums in arrival order (exact on dyadic leaves, whose
    every partial sum is representable; tests/test_reduction.py)."""
    out = np.zeros(m)
    np.add.at(out, fam, leaf)
    return out


def _dyadic24(rng, n):
    return rng.integers(-(1 << 20), 1 << 20, n) * 2.0 ** -24


def test_segment_sum_auto_force_exact_routes_small_m():
    """tests/test_reduction.py:88: force_exact sends the m == 1 and
    m <= 256 tiers through the digit-plane path; held to the port's
    exact_segment_sum and to the reference's forced sums, bit for
    bit."""
    rng = np.random.default_rng(11)
    n = 1 << 10
    for m in (1, 64, 256):
        fam = rng.integers(0, m, n).astype(np.int32)
        leaf = rng.uniform(-1, 1, n) * 10.0 ** rng.uniform(-9, -3, n)
        forced = tred.segment_sum_auto(_t(fam), _t(leaf), m, n,
                                       force_exact=True).numpy()
        direct = tred.exact_segment_sum(_t(fam), _t(leaf), m, n).numpy()
        ref = np.asarray(jred.segment_sum_auto(
            jnp.asarray(fam), jnp.asarray(leaf), m, n, force_exact=True))
        assert np.array_equal(forced, direct), m
        assert np.array_equal(forced, ref), m


def test_segment_sum_auto_force_exact_mesh_bit_equality():
    """tests/test_reduction.py:105: with force_exact one card's m = 1024
    and eight shards' m = 128 give the same slices to the bit, and the
    right ones."""
    rng = np.random.default_rng(23)
    n, m, shards = 1 << 12, 1024, 8
    m_local = m // shards
    fam = rng.integers(0, m, n).astype(np.int32)
    leaf = _dyadic24(rng, n)
    whole = tred.segment_sum_auto(_t(fam), _t(leaf), m, n,
                                  force_exact=True).numpy()
    for d in range(shards):
        pick = (fam // m_local) == d
        lf, lv = fam[pick] % m_local, leaf[pick]
        local = tred.segment_sum_auto(_t(lf), _t(lv), m_local, len(lv),
                                      force_exact=True).numpy()
        assert np.array_equal(local,
                              whole[d * m_local:(d + 1) * m_local]), d
    assert np.array_equal(whole, _ground_truth(fam, leaf, m))


@pytest.mark.parametrize("m,n", [(1, 777), (100, 4096)])
def test_segment_sum_auto_forced_bit_equal_to_reference(m, n):
    """Forced sums on arbitrary finite leaves: the reference's bits."""
    rng = np.random.default_rng(m * 7 + n)
    fam = rng.integers(0, m, n).astype(np.int32)
    leaf = _leaves(rng, n)
    got = tred.segment_sum_auto(_t(fam), _t(leaf), m, n,
                                force_exact=True).numpy()
    ref = np.asarray(jred.segment_sum_auto(
        jnp.asarray(fam), jnp.asarray(leaf), m, n, force_exact=True))
    assert np.array_equal(got, ref)


def test_segment_sum_auto_env_knob(monkeypatch):
    """tests/test_reduction.py:133: PPLS_EXACT_SEGSUM=1 forces the
    exact tier; unset, 0, off and false keep the default routing."""
    rng = np.random.default_rng(5)
    n, m = 512, 128
    fam = rng.integers(0, m, n).astype(np.int32)
    leaf = rng.uniform(-1, 1, n) * 1e-6
    exact = tred.exact_segment_sum(_t(fam), _t(leaf), m, n).numpy()
    monkeypatch.setenv("PPLS_EXACT_SEGSUM", "1")
    assert tred._env_force_exact()
    via_env = tred.segment_sum_auto(_t(fam), _t(leaf), m, n).numpy()
    assert np.array_equal(via_env, exact)
    for off in ("0", "off", "false", " OFF ", ""):
        monkeypatch.setenv("PPLS_EXACT_SEGSUM", off)
        assert not tred._env_force_exact()
        default = tred.segment_sum_auto(_t(fam), _t(leaf), m, n).numpy()
        assert np.abs(default - exact).max() < 1e-18
    monkeypatch.delenv("PPLS_EXACT_SEGSUM")
    assert not tred._env_force_exact()


def test_kahan_add_bit_equal():
    rng = np.random.default_rng(12)
    xs = _leaves(rng, 200)
    t_acc = (torch.zeros((), dtype=torch.float64),) * 2
    j_acc = (jnp.zeros((), jnp.float64),) * 2
    for x in xs:
        t_acc = tred.kahan_add(t_acc, torch.tensor(x, dtype=torch.float64))
        j_acc = jred.kahan_add(j_acc, jnp.asarray(x))
    assert float(t_acc[0]) == float(j_acc[0])
    assert float(t_acc[1]) == float(j_acc[1])
