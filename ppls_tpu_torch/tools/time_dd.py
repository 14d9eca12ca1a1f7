"""Time the demand-driven walker across ranks at the reference bench's dd
leg (bench.py:961-981), and check that the transport moves no bit:

    python ppls_tpu_torch/tools/time_dd.py [--worlds 1 4] [--repeats 3]
        [--one-card] [--out FILE]

For each world size in ``--worlds`` it launches that many ranks once
(``parallel/mesh.py``; rank r on ``cuda:(r % device_count)``: NCCL when
every rank owns a card, gloo staged through host memory when ranks share
one) and runs, in that one world, a warm-up of each leg and then
``--repeats`` timed runs of the refill leg (R = 8, scout f32, double
buffer: K1) and of the legacy leg (R = 0: K2), alternated: 64 thetas
1 + i/64 of sin(theta/x) on [1e-4, 1], eps 1e-10, chunk 2^12, capacity
2^20, lanes 2^12 and roots_per_lane 12 per rank. Per run it records the
engine's wall (rank 0's), tasks, cycles, kernel steps, tasks per rank,
collective rounds, K1/K2 launches and host syncs per rank, the
transport, rank 0's collective calls, and a sha256 of the areas' bytes
(equal hashes: equal areas bit for bit).

With ``--one-card`` it also runs every world again in a child process
that sees only the first card (``CUDA_VISIBLE_DEVICES`` set to it), so
on a machine with several cards a world of N runs once on N cards over
NCCL and once on one card over gloo: the two must agree in every count
and hash (each rank's arithmetic is the same; the collectives move exact
values). It prints one JSON line per world and transport, then the
card's ``nvidia-smi`` name and power limit, and writes all of it to
``--out``. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FAMILY = "sin_recip_scaled"
M = 64
EPS = 1e-10
BOUNDS = (1e-4, 1.0)
KW = dict(chunk=1 << 12, capacity=1 << 20, lanes=1 << 12,
          roots_per_lane=12)
LEGS = {"refill": dict(refill_slots=8, scout_dtype="f32",
                       double_buffer=True),
        "legacy": dict(refill_slots=0, scout_dtype="f64")}
TIMEOUT = 900
DEVICE = "cuda"


def _record(r) -> dict:
    m = r.mesh
    return dict(
        wall_s=r.metrics.wall_time_s, tasks=r.metrics.tasks,
        cycles=r.cycles, kernel_steps=r.kernel_steps,
        tasks_per_rank=r.metrics.tasks_per_chip,
        collective_rounds=r.collective_rounds, launches=m["launches"],
        host_syncs=m["host_syncs"], backend=m["backend"],
        host_staged=m["host_staged"], collective_calls=m["collective_calls"],
        areas_sha256=hashlib.sha256(r.areas.tobytes()).hexdigest()[:16])


def run_world(n: int, repeats: int) -> dict:
    """One launch of ``n`` ranks: a warm-up of each leg, then
    ``repeats`` alternated timed runs of both."""
    import numpy as np
    from ppls_tpu_torch.parallel import mesh as MESH
    from ppls_tpu_torch.parallel.sharded_walker import (
        integrate_family_walker_dd)
    theta = 1.0 + np.arange(M) / M
    args = (FAMILY, theta, BOUNDS, EPS)
    order = list(LEGS) + [leg for _ in range(repeats) for leg in LEGS]
    calls = [(integrate_family_walker_dd, args,
              dict(KW, **LEGS[leg], n_devices=n, device=DEVICE))
             for leg in order]
    outs = MESH.launch(MESH.run_calls, n, DEVICE, (calls,),
                       timeout=TIMEOUT)
    for leg, o in zip(order, outs):
        if isinstance(o, Exception):
            raise RuntimeError(f"world {n} {leg}: {o!r}")
    recs = {leg: [_record(o) for lg, o in zip(order[len(LEGS):],
                                            outs[len(LEGS):]) if lg == leg]
            for leg in LEGS}
    out = {"world": n, "legs": {}}
    for leg, rs in recs.items():
        keys = {(r["tasks"], r["areas_sha256"]) for r in rs}
        if len(keys) != 1:
            raise RuntimeError(f"world {n} {leg}: runs differ {keys}")
        walls = [r["wall_s"] for r in rs]
        out["legs"][leg] = dict(rs[0], walls_s=walls,
                                median_wall_s=statistics.median(walls))
    return out


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
        print("time_dd: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from ppls_tpu_torch.utils.cuda_build import load_all_kernels
    load_all_kernels()              # once, before any rank starts
    results = [run_world(n, args.repeats) for n in args.worlds]
    for r in results:
        print(json.dumps(r), flush=True)
    if args.one_card:
        shared = _child(args.worlds, args.repeats)
        for mine, one in zip(results, shared):
            for leg in LEGS:
                a, b = mine["legs"][leg], one["legs"][leg]
                differ = [k for k in ("tasks", "cycles", "kernel_steps",
                                    "tasks_per_rank", "collective_rounds",
                                    "areas_sha256") if a[k] != b[k]]
                if differ:
                    raise RuntimeError(
                        f"world {mine['world']} {leg}: {a['backend']} and "
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
