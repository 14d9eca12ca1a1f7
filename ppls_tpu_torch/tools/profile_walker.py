"""Walk-kernel probe: the lane-step rate of K3 (``csrc/walk_seg.cu``),
the fixed-length segment, on the reference probe's restarted lanes.

It restarts the same K3 segment ``outer`` times (each restart resets the
lanes' DFS position and endpoint caches to the start state) and times
the whole run with CUDA events. ``kernel_ceiling_slope`` times two
restart counts and takes the slope, so every constant cost (launch
latency, the first launch's warm-up) cancels (``dd_kernel_ceiling_slope``
takes it at the dd walker's 2^12 lanes a rank):

    rate = (steps_hi - steps_lo) / (time_hi - time_lo)

The slope includes the seven small copies of each restart, as the
reference's includes its state reset. It is not the all-live rate:
most of these lanes finish their root and park within the first few
dozen steps of each restart (about two thirds of them by step 64 at
256 lanes), and a parked lane's step is cheap. The all-live rate of K3,
and its time per step against K2's (the grid barrier's share), are
measured on the flagship's seeded lanes by ``chip_smoke.py``.

    python -m ppls_tpu_torch.tools.profile_walker      # needs a card

The reference probe is ``tools/profile_walker.py``; its state omits the
``mk_i``/``mk_d`` markers the 26-field state now has, which this one
fills with 0 / -1.
"""

from __future__ import annotations

import numpy as np
import torch

from ppls_tpu_torch.config import Rule
from ppls_tpu_torch.models.integrands import get_family_ds
from ppls_tpu_torch.ops.ds import ds_from_f64
from ppls_tpu_torch.parallel.walker import WalkState, run_segment

FAMILY = "sin_recip_scaled"
RESTART_FIELDS = ("i", "d", "flags", "fl_h", "fl_l", "fr_h", "fr_l")


def ceiling_state(lanes: int, seed: int = 0, device="cuda") -> WalkState:
    """The probe's lanes: roots of width 2e-6 at x in [1e-4, 3.1e-3] of
    sin(theta / x), theta in [1, 2), endpoint caches loaded, every lane
    about to test its root (the reference probe's state)."""
    rng = np.random.default_rng(seed)
    a64 = 1e-4 * (1.0 + 30.0 * rng.random(lanes))
    w64 = np.full(lanes, 2e-6)
    th64 = 1.0 + rng.random(lanes)
    dev = torch.device(device)

    def ds(x):
        return tuple(t.to(dev) for t in ds_from_f64(torch.from_numpy(x)))

    def f32(x):
        return torch.tensor(x.astype(np.float32), device=dev)

    z = torch.zeros(lanes, dtype=torch.float32, device=dev)
    zi = torch.zeros(lanes, dtype=torch.int32, device=dev)
    (a_h, a_l), (w_h, w_l), (th_h, th_l) = ds(a64), ds(w64), ds(th64)
    return WalkState(
        a_h=a_h, a_l=a_l, w_h=w_h, w_l=w_l, th_h=th_h, th_l=th_l,
        fl_h=f32(np.sin(th64 / a64)), fl_l=z.clone(),
        fr_h=f32(np.sin(th64 / (a64 + w64))), fr_l=z.clone(),
        fm_h=z.clone(), fm_l=z.clone(), fq_h=z.clone(), fq_l=z.clone(),
        acc_h=z.clone(), acc_l=z.clone(), i=zi.clone(), d=zi.clone(),
        base_d=zi.clone(), fam=zi.clone(), flags=zi.clone(),
        tasks=zi.clone(), splits=zi.clone(), maxd=zi.clone(),
        mk_i=zi.clone(), mk_d=torch.full_like(zi, -1))


def _restarted(s0: WalkState, outer: int, seg_iters: int, eps: float,
               f_ds) -> float:
    """Milliseconds (CUDA events) of ``outer`` restarted K3 segments."""
    s = WalkState(*(t.clone() for t in s0))
    restart = [(getattr(s, n), getattr(s0, n)) for n in RESTART_FIELDS]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(outer):
        run_segment(s, seg_iters, f_ds=f_ds, eps=eps, rule=Rule.TRAPEZOID)
        for dst, src in restart:
            dst.copy_(src)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def kernel_ceiling(lanes: int = 1 << 15, seg_iters: int = 256,
                   outer: int = 32, eps: float = 1e-10) -> dict:
    """Lane-steps per second of ``outer`` restarted K3 segments, after
    one warm-up run (the single-run number; quote the slope)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel ceiling is a card measurement: "
                           "torch.cuda.is_available() is False")
    f_ds = get_family_ds(FAMILY)
    s0 = ceiling_state(lanes, device="cuda")
    _restarted(s0, 1, seg_iters, eps, f_ds)            # build + warm up
    ms = _restarted(s0, outer, seg_iters, eps, f_ds)
    steps = outer * seg_iters * lanes
    return {"lane_steps_per_sec": steps / (ms * 1e-3), "ms": ms,
            "lanes": lanes, "seg_iters": seg_iters, "outer": outer,
            "device": torch.cuda.get_device_name(0)}


def kernel_ceiling_slope(lanes: int = 1 << 14, seg_iters: int = 256,
                         outer_lo: int = 64, outer_hi: int = 512,
                         eps: float = 1e-10) -> dict:
    """The two-point slope of restarted K3 segments: lane-steps per
    second and microseconds per step (all lanes), the number to quote."""
    lo = kernel_ceiling(lanes, seg_iters, outer_lo, eps)
    hi = kernel_ceiling(lanes, seg_iters, outer_hi, eps)
    d_ms = hi["ms"] - lo["ms"]
    if d_ms <= 0:
        raise RuntimeError(f"non-positive slope window ({d_ms:.4f} ms "
                           f"between outer={outer_lo} and {outer_hi})")
    d_steps = (outer_hi - outer_lo) * seg_iters
    return {"lane_steps_per_sec": d_steps * lanes / (d_ms * 1e-3),
            "us_per_step": 1e3 * d_ms / d_steps,
            "method": "two-point-slope", "outer_lo": outer_lo,
            "outer_hi": outer_hi, "ms_lo": lo["ms"], "ms_hi": hi["ms"],
            "lanes": lanes, "seg_iters": seg_iters,
            "launches": 2 + outer_lo + outer_hi, "device": lo["device"],
            "single_run_lo": lo["lane_steps_per_sec"],
            "single_run_hi": hi["lane_steps_per_sec"]}


def dd_kernel_ceiling_slope(lanes: int = 1 << 12, **kw) -> dict:
    """The slope at the demand-driven walker's lane count per rank (2^12,
    where the single-card flagship runs 2^14): a dd leg's headroom split
    rates against the lane count it runs (the reference's
    ``dd_kernel_ceiling_slope``)."""
    return kernel_ceiling_slope(lanes=lanes, **kw)


if __name__ == "__main__":
    s = kernel_ceiling_slope()
    print(f"K3 on the probe's restarted lanes, {s['device']}: "
          f"{s['lane_steps_per_sec'] / 1e9:.3f} G lane-steps/s, "
          f"{s['us_per_step']:.3f} us per step at lanes={s['lanes']} "
          f"(slope of outer {s['outer_lo']} vs {s['outer_hi']})")
