"""Time the walker-dd stream across ranks at the reference bench's stream
leg, and check that the transport moves no bit:

    python ppls_tpu_torch/tools/time_dd_stream.py [--worlds 1 4]
        [--repeats 3] [--one-card] [--out FILE]

For each world size in ``--worlds`` it builds one
``StreamEngine(engine="walker-dd", n_devices=N)`` (its ranks live as long
as the engine, ``parallel/mesh.py`` ``World``: NCCL when every rank owns
a card, gloo staged through host memory when ranks share one), runs the
stream leg once to start the ranks and load the kernels, then
``--repeats`` timed runs on the same engine: 24 requests of sin(theta/x),
theta = 1 + i/24, on [1e-4, 1], eps 1e-10, slots 64, chunk 2^13,
capacity 2^22 and lanes 2^14 per rank, R = 8, scout f32, double buffer,
all admitted at once (bench.py:1098-1108 with ``engine="walker-dd"``).
Per run it records the host wall around the run (synchronised),
requests/s, phases, tasks, and per rank the K1 launches, host syncs and
collective calls, the transport, and sha256 prefixes of the areas' and
the phase rows' bytes (equal hashes: bit-equal).

With ``--one-card`` every world runs again in a child process that sees
only the first card (``CUDA_VISIBLE_DEVICES``), so on a machine with
several cards a world of N runs once on N cards over NCCL and once on
one card over gloo: every count and hash must agree. It prints one JSON
line per world and transport, then the card's ``nvidia-smi`` name and
power limit, and writes all of it to ``--out``. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FAMILY = "sin_recip_scaled"
K = 24
EPS = 1e-10
BOUNDS = (1e-4, 1.0)
KW = dict(slots=64, chunk=1 << 13, capacity=1 << 22, lanes=1 << 14,
          refill_slots=8, scout_dtype="f32", double_buffer=True,
          engine="walker-dd")
TIMEOUT = 900
_SCHEDULE = ("phases", "tasks", "areas_sha256", "rows_sha256",
             "launches_per_rank")


def _sha(a) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def run_world(n: int, repeats: int) -> dict:
    """One engine of ``n`` ranks: a warm-up run, then ``repeats`` timed
    runs, each recorded from the engine's counters before and after."""
    import numpy as np
    import torch
    from ppls_tpu_torch.runtime.stream import StreamEngine
    reqs = [(float(t), BOUNDS) for t in 1.0 + np.arange(K) / K]
    runs = []
    with StreamEngine(FAMILY, EPS, n_devices=n, device="cuda",
                      **KW) as eng:
        for _ in range(1 + repeats):
            a = eng.result()
            t0 = time.perf_counter()
            eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b = eng.result()
            m, m0 = b.mesh, a.mesh or {}

            def delta(key, sub=None):
                now = m[key] if sub is None else m[key][sub]
                was = (m0.get(key) if sub is None
                       else (m0.get(key) or {}).get(sub)) or [0] * n
                return [x - y for x, y in zip(now, was)]
            done = b.completed[len(a.completed):]
            runs.append(dict(
                wall_s=wall, requests_per_sec=K / wall,
                phases=b.phases - a.phases,
                tasks=b.totals["tasks"] - a.totals["tasks"],
                launches_per_rank=delta("launches", "run_segment_rf"),
                host_syncs_per_rank=delta("host_syncs"),
                collective_calls={k: delta("collective_calls", k)
                                  for k in m["collective_calls"]},
                backend=m["backend"], host_staged=m["host_staged"],
                areas_sha256=_sha(np.array([c.area for c in sorted(
                    done, key=lambda c: c.rid)])),
                rows_sha256=_sha(b.phase_stats[a.phase_stats.shape[0]:])))
    timed = runs[1:]
    keys = {tuple(json.dumps(r[k]) for k in _SCHEDULE) for r in timed}
    walls = [r["wall_s"] for r in timed]
    return {"world": n, "warm_up": runs[0], "runs": timed,
            "same_schedule_every_run": len(keys) == 1,
            "median_wall_s": statistics.median(walls),
            "median_requests_per_sec": K / statistics.median(walls)}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _child(worlds, repeats) -> list:
    """The same worlds in a process that sees only the first card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    cmd = [sys.executable, os.path.abspath(__file__), "--repeats",
           str(repeats), "--worlds", *map(str, worlds)]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT * len(worlds), check=True, cwd=ROOT)
    return [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 4])
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--one-card", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("time_dd_stream: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from ppls_tpu_torch.utils.cuda_build import load_all_kernels
    load_all_kernels()              # once, before any rank starts
    results = [run_world(n, args.repeats) for n in args.worlds]
    for r in results:
        print(json.dumps(r), flush=True)
    if args.one_card:
        shared = _child(args.worlds, args.repeats)
        for mine, one in zip(results, shared):
            for a, b in zip(mine["runs"], one["runs"]):
                differ = [k for k in _SCHEDULE if a[k] != b[k]]
                if differ:
                    raise RuntimeError(
                        f"world {mine['world']}: {a['backend']} and "
                        f"one-card {b['backend']} differ in {differ}")
            print(json.dumps(dict(one, one_card=True)), flush=True)
        results += [dict(r, one_card=True) for r in shared]
    smi = _smi()
    print(smi)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"smi": smi, "device_count": torch.cuda.device_count(),
                       "results": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
