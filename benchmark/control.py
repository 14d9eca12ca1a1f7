"""The control of the check: the plain reference in float32, the
precision below the configuration's, put in the program's place.

    python3 benchmark/control.py --workload NAME --seeds N [N ...] [--calls K]

For each seed it draws the problems a run of the cell would draw (K batch
calls, or K requests), samples the answers the check would sample, and
compares the float32 reference's areas with the float64 reference's by
the check's own numbers. A sound control comes out not correct. The
benchmark's runs never run it.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def problems(cfg: dict, mix: dict, seed: int, k: int) -> dict:
    """A record shaped as a driver's, with the window's problems and no
    answers (the control supplies them)."""
    import numpy as np

    import generate
    from drivers.stream import requests

    if mix["driver"] == "family":
        m = int(mix["members_per_chip"])
        gen = generate.rng(seed, "window")
        th = [generate.thetas(mix["theta"], gen, m) for _ in range(k)]
        return {"calls": [{}] * k, "thetas": th,
                "areas": [np.zeros(m) for _ in th]}
    draw = requests(mix, seed)
    reqs = [next(draw) for _ in range(k)]
    return {"answers": [{"thetas": t, "areas": np.zeros(len(t))}
                        for t in reqs]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--calls", type=int, default=None,
                   help="batch calls or requests drawn (default: 30 "
                        "calls, 1200 requests)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    import check
    import generate
    import harness

    manifest = harness.load_manifest()
    cell = harness.find(manifest["workloads"], args.workload)
    cfg = harness.load_config(manifest, cell["config"])
    mix = generate.load_mix(cell["traffic"])
    k = args.calls or (30 if mix["driver"] == "family" else 1200)
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = problems(cfg, mix, seed, k)
        v = check.run(cfg, mix, rec, seed, args.device,
                      answer_dtype=torch.float32)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": v["correct"],
                          "area_gap": v["numbers"]["area_gap"],
                          "seconds": round(time.perf_counter() - t0, 2)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
