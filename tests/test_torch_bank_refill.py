"""The boundary of a boundary-refill walk: the port's ``_bank_and_refill``
against the reference's, bit for bit, on seeded lane states.

The lanes mix live walks, finished lanes with a root, depth-overflowed
(OVF) lanes and idle lanes with no root; the queue holds fewer roots
than there are refillable lanes in one case and more roots than lanes
in the other. Every state column, the cursor and the credited
accumulator must be equal: the boundary is integer bookkeeping, float64
splits and an exact segment sum, with nothing left to rounding order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppls_tpu.parallel import walker as RW
from ppls_tpu.parallel.bag_engine import initial_bag as ref_initial_bag
from ppls_tpu_torch import interop
from ppls_tpu_torch.parallel import walker as TW

LANES = 256


def _lanes(rng, m):
    """A seeded mid-walk lane state in the reference layout."""
    state = [np.array(x) for x in
             jax.device_get(tuple(RW._fresh_lanes(LANES)))]
    for j in range(TW.N_F32_FIELDS):
        state[j] = rng.standard_normal(state[j].shape).astype(np.float32)
    f = {n: j for j, n in enumerate(RW.WalkState._fields)}
    shape = state[0].shape
    kinds = rng.choice(4, LANES, p=[0.4, 0.3, 0.1, 0.2])
    flags = np.choose(kinds, [
        rng.choice([0, RW._MODE_LOAD, RW._MODE_INIT], LANES),   # live
        np.full(LANES, RW._PARKED),                   # finished, has root
        np.full(LANES, RW._PARKED | RW._OVF),          # depth overflow
        np.full(LANES, RW._PARKED | RW._NO_ROOT),      # idle
    ]).astype(np.int32)
    state[f["flags"]] = flags.reshape(shape)
    for name, hi in (("i", 1 << 20), ("d", 30), ("base_d", 40),
                     ("tasks", 1000), ("splits", 500), ("maxd", 60),
                     ("mk_i", 9)):
        state[f[name]] = rng.integers(0, hi, shape).astype(np.int32)
    state[f["fam"]] = rng.integers(0, m, shape).astype(np.int32)
    state[f["mk_d"]] = rng.integers(-1, 5, shape).astype(np.int32)
    return state, kinds


def _bag(rng, count, m, store_chunk=512):
    bag = jax.device_get(ref_initial_bag(
        np.tile([[0.1, 1.0]], (m, 1)), 4096, m, store_chunk,
        theta=1.0 + np.arange(m) / m))
    cols = bag._asdict()
    n = cols["bag_l"].shape[0]
    l = rng.uniform(0.1, 0.9, n)
    cols["bag_l"] = l
    cols["bag_r"] = l + rng.uniform(1e-6, 0.1, n)
    cols["bag_th"] = rng.uniform(1.0, 2.0, n)
    cols["bag_meta"] = ((rng.integers(0, m, n) << 14)
                        + rng.integers(0, 30, n)).astype(np.int32)
    cols["count"] = np.int32(count)
    return cols


@pytest.mark.parametrize("m", [7, 300])     # mask-sum and exact tiers
@pytest.mark.parametrize("count,cursor", [
    (1000, 980),      # avail 20 < the refillable lanes
    (1500, 100),      # avail 1400 > lanes
    (50, 50),         # dry queue: every refillable lane retires
])
def test_bank_and_refill_bit_equal_to_reference(m, count, cursor):
    rng = np.random.default_rng(count + m)
    state, kinds = _lanes(rng, m)
    cols = _bag(rng, count, m)
    acc0 = rng.standard_normal(m)

    ref_bag = RW.BagState(**{k: jnp.asarray(v) for k, v in cols.items()})
    carry = RW._WalkCarry(
        lanes=RW.WalkState(*(jnp.asarray(x) for x in state)), bag=ref_bag,
        cursor=jnp.int32(cursor), acc=jnp.asarray(acc0),
        segs=jnp.int32(0), steps=jnp.int32(0), gsegs=jnp.int32(0),
        seg_stats=jnp.zeros((4, 4), jnp.int32),
        waste=jnp.zeros(RW.N_WASTE, jnp.int64),
        evals=jnp.zeros(2, jnp.int64))
    ref = jax.device_get(RW._bank_and_refill(carry, m, LANES))

    got, acc, n_taken = TW._bank_and_refill(
        interop.walk_state_from_numpy(state),
        torch.tensor(acc0, dtype=torch.float64),
        interop.bag_state_from_numpy(cols), cursor, m)

    got_np = interop.walk_state_to_numpy(got)
    for name, a, b in zip(TW.WalkState._fields, got_np, ref.lanes):
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.int32), b.view(np.int32)), name
    assert cursor + int(n_taken) == int(ref.cursor)
    assert np.array_equal(acc.numpy(), np.asarray(ref.acc))
    n_ref = int(np.sum((kinds == 1) | (kinds == 3)))
    assert int(n_taken) == min(n_ref, count - cursor)
