"""Time K1 launches (theta_block = 1) on the flagship's dealt bank, for
the checkout given by ``--root``, so two checkouts can be timed in
alternation on one card:

    python ppls_tpu_torch/tools/time_k1.py --root PATH [--launches N]

It imports ``ppls_tpu_torch`` from PATH (default: the checkout this file
is in), deals the flagship's first bank (sin(theta/x), 1024 thetas on
[1e-4, 1], eps 1e-10, 16384 lanes, R = 8), and times ``--launches``
256-step launches of the trapezoid and the scouting machine by CUDA
events after one warm-up launch each. Prints one JSON line: the root and
the launch times in ms per machine. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--launches", type=int, default=11)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    from ppls_tpu_torch.parallel import walker as W

    if not torch.cuda.is_available():
        print("time_k1: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    f, f_ds = get_family("sin_recip_scaled"), get_family_ds("sin_recip_scaled")
    theta = 1.0 + np.arange(1024) / 1024
    out = {"root": args.root}
    for mode, scout in (("step", False), ("step_scout", True)):
        base = W.first_phase_inputs(f, theta, (1e-4, 1.0), 1e-10,
                                    lanes=1 << 14, roots_per_lane=12,
                                    refill_slots=8, capacity=1 << 23,
                                    scout=scout, device="cuda")
        times = []
        for j in range(args.launches + 1):
            state = W.WalkState(*(t.clone() for t in base["state"]))
            slot = base["slot"].clone()
            bank = tuple(t.clone() for t in base["bank"])
            resm = tuple(t.clone() for t in base["resm"])
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            W.run_segment_rf(state, slot, base["thresh"], 256, base["batch"],
                             base["nslots"], bank, resm, f_ds=f_ds,
                             eps=1e-10, scout=scout)
            stop.record()
            torch.cuda.synchronize()
            if j:                              # the first launch warms up
                times.append(start.elapsed_time(stop))
        out[mode] = times
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
