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
