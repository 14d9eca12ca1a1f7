"""The demand-driven walker at one rank against the single walker, on the
flagship workload (M = 1024 sin(theta / x), eps 1e-10 on [1e-4, 1]):

    python ppls_tpu_torch/tools/characterize_dd.py [--device cuda]

At one rank the dd engine's collectives are degenerate, so this bounds
the engine structure's own cost (the collective breed, the per-leg host
reads) apart from any transport. Three configurations, each run once to
build and warm, then timed three times (the median): the single walker
(capacity 2^23, its defaults), the dd walker at the single walker's
sizing (lanes 2^14, chunk 2^15, capacity 2^22, roots_per_lane 12) and at
its shipped sizing (lanes 2^12, capacity 2^22). All run in one world of
one rank (``parallel/mesh.py``; NCCL in this process on a card), so the
walls are the engines' own (``metrics.wall_time_s``); the median of
five synchronised one-element device-to-host round trips is subtracted
from each, as ``analyze_occupancy.py`` measures it. It prints a row per
configuration and the summary against the single walker, as the JAX
package's ``tools/characterize_dd.py`` does. Without a card and without
``--device cpu`` it exits 2 with ``resolve_device``'s message.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FAMILY = "sin_recip_scaled"
M = 1024
EPS = 1e-10
BOUNDS = (1e-4, 1.0)
REPEATS = 3
CONFIGS = (
    ("single-chip walker", "single", dict(capacity=1 << 23)),
    ("dd mesh=1 matched (lanes=2^14)", "dd",
     dict(chunk=1 << 15, capacity=1 << 22, lanes=1 << 14,
          roots_per_lane=12)),
    ("dd mesh=1 shipped (lanes=2^12)", "dd", dict(capacity=1 << 22)),
)


def _single(theta, device, **kw):
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    from ppls_tpu_torch.parallel.walker import integrate_family_walker
    return integrate_family_walker(get_family(FAMILY),
                                   get_family_ds(FAMILY), theta, BOUNDS,
                                   EPS, device=device, **kw)


def characterize(device="cuda", m: int = M, configs=CONFIGS,
                 repeats: int = REPEATS) -> list:
    """Each configuration of ``configs`` (label, "single" or "dd", kw) on
    ``m`` thetas: one warm run, then ``repeats`` timed runs, all in one
    world of one rank on ``device``. Prints and returns one row per
    configuration: label, tasks, median wall, rate net of the round
    trip, walker fraction, lane efficiency, and the timed runs."""
    import numpy as np

    from ppls_tpu_torch.parallel import mesh as MESH
    from ppls_tpu_torch.parallel.sharded_walker import (
        integrate_family_walker_dd)
    from ppls_tpu_torch.tools.analyze_occupancy import round_trip_s
    from ppls_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    theta = 1.0 + np.arange(m) / m
    rtt, _ = round_trip_s(dev)
    print(f"RTT ~{rtt*1e3:.0f} ms", flush=True)
    calls = []
    for _, kind, kw in configs:
        for _ in range(1 + repeats):
            if kind == "single":
                calls.append((_single, (theta, str(dev)), kw))
            else:
                calls.append((integrate_family_walker_dd,
                              (FAMILY, theta, BOUNDS, EPS),
                              dict(kw, n_devices=1, device=str(dev))))
    outs = MESH.launch(MESH.run_calls, 1, dev, (calls,))
    rows = []
    for j, (name, _, _) in enumerate(configs):
        runs = outs[j * (1 + repeats):(j + 1) * (1 + repeats)]
        for o in runs:
            if isinstance(o, Exception):
                raise RuntimeError(f"{name}: {o!r}")
        print(f"{name}: compile+run {runs[0].metrics.wall_time_s:.0f}s",
              flush=True)
        walls = [o.metrics.wall_time_s for o in runs[1:]]
        wall = float(np.median(walls))
        r = runs[1 + int(np.argsort(walls)[len(walls) // 2])]
        net = max(wall - rtt, 1e-9)
        rate = r.metrics.tasks / net
        rows.append(dict(name=name, tasks=r.metrics.tasks, wall_s=wall,
                         rate=rate, walker_fraction=r.walker_fraction,
                         lane_efficiency=r.lane_efficiency, runs=runs[1:],
                         walls_s=walls))
        print(f"{name}: median wall {wall:.3f}s (-RTT {net:.3f}s) "
              f"-> {rate/1e6:.0f} M subint/s, tasks={r.metrics.tasks}, "
              f"wfrac={r.walker_fraction:.3f}, "
              f"laneeff={r.lane_efficiency:.3f}", flush=True)
    base = rows[0]["rate"]
    print("\nsummary (rate vs single-chip):")
    for row in rows:
        print(f"  {row['name']}: {row['rate']/1e6:7.0f} M/s  "
              f"({row['rate']/base*100:5.1f}%)")
    return rows


def main(argv=None) -> int:
    """``argv`` without the program name: ``[--device D]``."""
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        characterize(args.device)
    except RuntimeError as e:
        if "CUDA is not available" not in str(e):
            raise
        print(f"characterize_dd: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
