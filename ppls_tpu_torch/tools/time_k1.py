"""Time the walk kernels of one checkout, or of several checkouts in
alternation on one card:

    python ppls_tpu_torch/tools/time_k1.py [--root PATH] [--launches N]
        [--family NAME] [--reduced]
    python ppls_tpu_torch/tools/time_k1.py --compare PARENT CHANGE \\
        [--rounds 3] [--out FILE] [--family NAME] [--reduced]

With ``--root`` (default: the checkout this file is in) it imports
``ppls_tpu_torch`` from PATH and times, by CUDA events around each
launch's device work (:func:`kernel_times`) after one warm-up launch
each, ``--launches`` 256-step launches of:

- K1 at T = 1 on the first dealt bank of ``--family`` (default the
  flagship's: sin(theta/x), 1024 thetas on [1e-4, 1], eps 1e-10; the
  other families' banks are ``body_bank``'s), 16384 lanes, R = 8:
  ``step`` (trapezoid) and ``step_scout``; with ``--reduced`` also
  ``step_reduced`` and ``step_scout_reduced``, the family's range-reduced
  ds twin on the same bank, each launched in alternation with its
  reference twin;
- K1's theta trapezoid at T = 128 and T = 256 (``theta_128``,
  ``theta_256``) on a dealt theta bank of sin(theta x) on [0, 1], eps
  1e-5, thetas linspace(1, 4, 16384), R = 8;
- K2 on the family's seeded lanes (the first boundary refill):
  ``k2_step`` and ``k2_step_scout`` at thresh 0.80 * lanes (with
  ``--reduced`` their ``_reduced`` twins too), and ``k2_noexit`` (thresh
  -1) beside ``k3_step``, K3 on the same lanes: the same work with and
  without the grid count and barrier; and ``k3_step_simpson``, K3's
  Simpson machine on the family's Simpson-seeded lanes (its Simpson
  eps);
- ``k1_main_path`` and ``k2_main_path``: the flagship of chip_smoke.py
  phase 4 (M = 1024 thetas of sin(theta/x) on [1e-4, 1], eps 1e-10,
  16384 lanes, 12 roots a lane, refill_slots=8, scout f32,
  double-buffered) and its fallback of phase 6 (refill_slots=0, scout
  f64), each run once to warm up, ``MAIN_RUNS`` times on the host clock
  around a synchronised ``integrate_family_walker`` call, then once
  under ``torch.profiler``: the kernel's summed time over that run, its
  kernel steps and launches, the device busy time (every device event's
  self time), the idle share of the run's wall, the tasks and a sha256
  of the areas' bytes (equal hashes: equal areas bit for bit).

It prints one JSON line: the root and, per kernel, the launch times in
ms and the launch's steps (and the main paths' other numbers). Only the
wrappers' public signatures are used, so a parent checkout that lacks
newer kernel code is timed the same way.

With ``--compare`` it runs one such process per root in the order
given, then in reverse, ``--rounds`` times (two roots, three rounds:
A B B A A B B A A B B A), and prints per root and kernel the median and
interquartile range of the per-process median times and the us per
step (for the main paths also each process's busy time, idle share and
median wall, and the distinct tasks and area hashes), and the card's
``nvidia-smi`` name and power limit. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CAP = 256
LANES = 1 << 14
SPIN_CYCLES = 4_000_000      # ~2 ms of the card's clock before each launch
DEVICE = "cuda"
BODY_M = 1024
MAIN_RUNS = 5


def body_bank(family: str, m: int = BODY_M):
    """(thetas, bounds, eps, Simpson eps) of the bank each integrand body
    is timed and checked on (chip_smoke.py phase 12): the flagship's
    domain for sin(theta / x); sin(theta x) on the theta leg's [0, 1];
    cosh^4 on [0, 5] with theta <= 2.5, so |theta x| <= 12.5; Gaussians of
    width 1e-3 centred in [0.4995, 0.5005] on [0.4, 0.6]; theta x^2 on
    [0, 1] with theta = 1 + i/4. The eps keep most lanes walking through
    a 256-step launch where the family allows: on the smooth families
    Simpson's breed accepts every root at the trapezoid's eps, so its
    eps is the ds rounding's (1e-16). cosh^4's lanes at theta above ~3
    split to the depth cap and park and would end its launches early;
    theta x^2 is exact under Simpson at any eps."""
    import numpy as np
    i = np.arange(m)
    return {
        "sin_recip_scaled": (1.0 + i / m, (1e-4, 1.0), 1e-10, 1e-10),
        "sin_scaled": (np.linspace(1.0, 4.0, m), (0.0, 1.0), 1e-12, 1e-16),
        "cosh4_scaled": (np.linspace(0.5, 2.5, m), (0.0, 5.0), 1e-6, 1e-6),
        "gauss_center": (np.linspace(0.4995, 0.5005, m), (0.4, 0.6), 1e-12,
                         1e-16),
        "quad_scaled": (1.0 + i / 4.0, (0.0, 1.0), 1e-12, 1e-12),
    }[family]


def kernel_times(fns):
    """Call each of ``fns`` in turn, each launching one walk kernel and
    returning without waiting for it, and time it by CUDA events: (their
    results, the ms of each). Before each start event the card spins
    (``torch.cuda._sleep``, ~2 ms) while the host runs the wrapper, so
    the launch's device work (the wrapper's zeroed counters, its
    pointer-table copy, the kernel) is queued when the start event fires
    and the events hold that work only. With the wrapper's host work
    inside them (operand checks, the launch call), during which the card
    waited, a 256-step launch read up to twice its kernel time
    (PERF.md)."""
    import torch
    outs, ms = [], []
    for fn in fns:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        outs.append(fn())
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    return outs, ms


def _timed_pairs(prepares, launches: int):
    """Kernel times in ms (:func:`kernel_times`), and the last launch's
    steps, of launches + 1 launches of each kernel (the first warms up),
    in alternation (A B, then B A, ...) so that a reduced twin and its
    reference twin see the card alike. ``prepares[name]()`` copies the
    inputs and returns the launch, which returns its step count:
    {name: (times, steps)}."""
    names = list(prepares)
    order = [name for j in range(launches + 1)
             for name in (names if j % 2 == 0 else names[::-1])]
    outs, ms = kernel_times([prepares[name]() for name in order])
    steps = [int(n) for n in outs]
    times = {n: [] for n in names}
    for j, (name, t) in enumerate(zip(order, ms)):
        if j >= len(names):                  # the first round warms up
            times[name].append(t)
    last = {name: n for name, n in zip(order, steps)}
    return {n: (times[n], last[n]) for n in names}


def k1_prepare(base, f_ds, eps, scout, T=1, **rule):
    """A ``_timed_pairs`` prepare: copies of K1's dealt bank ``base``,
    and one CAP-step launch of the ds twin ``f_ds`` on them."""
    from ppls_tpu_torch.parallel import walker as W

    def prepare():
        state = W.WalkState(*(t.clone() for t in base["state"]))
        slot = base["slot"].clone()
        bank = tuple(t.clone() for t in base["bank"])
        resm = tuple(t.clone() for t in base["resm"])
        kw = dict(theta_block=T) if T > 1 else {}

        def launch():
            out = W.run_segment_rf(state, slot, base["thresh"], CAP,
                                   base["batch"], base["nslots"], bank,
                                   resm, f_ds=f_ds, eps=eps, scout=scout,
                                   **kw, **rule)
            return out[2][0]
        return launch
    return prepare


def k2_prepare(base, f_ds, eps, scout, thresh, **rule):
    """As :func:`k1_prepare`, for K2 on the seeded lanes ``base``."""
    from ppls_tpu_torch.parallel import walker as W

    def prepare():
        state = W.WalkState(*(t.clone() for t in base["state"]))

        def launch():
            return W.run_segment_ee(state, thresh, CAP, f_ds=f_ds, eps=eps,
                                    scout=scout, **rule)[1]
        return launch
    return prepare


def main_path(**kw) -> dict:
    """One flagship walk with ``kw`` (after a warm-up run): its host
    walls, and by ``torch.profiler`` the walk kernel's summed time, its
    kernel steps and launches, the device busy time and idle share, the
    tasks and the areas' sha256."""
    import hashlib
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    from ppls_tpu_torch.parallel import walker as W
    from ppls_tpu_torch.utils.tracing import device_busy_us, device_self_us
    f, f_ds = get_family("sin_recip_scaled"), get_family_ds("sin_recip_scaled")
    theta = 1.0 + np.arange(BODY_M) / BODY_M
    seg, kernel = ((W.run_segment_rf, "walk_rf_kernel") if kw["refill_slots"]
                   else (W.run_segment_ee, "walk_ee_kernel"))

    def run():
        res = W.integrate_family_walker(
            f, f_ds, theta, (1e-4, 1.0), 1e-10, lanes=LANES,
            roots_per_lane=12, capacity=1 << 23, device=DEVICE, **kw)
        torch.cuda.synchronize()
        return res
    run()
    walls = []
    for _ in range(MAIN_RUNS):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    before = seg.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = seg.launches - before

    events = prof.key_averages()
    busy_ms = device_busy_us(events) / 1e3
    return {"ms": [sum(device_self_us(e) for e in events
                       if kernel in e.key) / 1e3],
            "steps": res.kernel_steps, "launches": launches,
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "walls_s": walls, "tasks": res.metrics.tasks,
            "areas_sha256": hashlib.sha256(
                np.asarray(res.areas).tobytes()).hexdigest()}


def time_root(launches: int, family: str = "sin_recip_scaled",
              reduced: bool = False) -> dict:
    import numpy as np
    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    from ppls_tpu_torch.parallel import walker as W

    def k3(base, f_ds, eps, **rule):
        def prepare():
            state = W.WalkState(*(t.clone() for t in base["state"]))

            def launch():
                W.run_segment(state, CAP, f_ds=f_ds, eps=eps, **rule)
                return CAP
            return launch
        return prepare

    f, f_ds = get_family(family), get_family_ds(family)
    theta, bounds, eps, eps_simpson = body_bank(family)
    # the family's ds twin, and with --reduced its range-reduced twin on
    # the same banks
    twins = {"": f_ds}
    if reduced:
        twins["_reduced"] = get_family_ds(family, reduced=True)
    flagship = dict(lanes=LANES, roots_per_lane=12, capacity=1 << 23,
                    device=DEVICE)
    runs = {}
    for mode, scout in (("step", False), ("step_scout", True)):
        base = W.first_phase_inputs(f, theta, bounds, eps, refill_slots=8,
                                    scout=scout, **flagship)
        for tag, twin in twins.items():
            runs[mode + tag] = k1_prepare(base, twin, eps, scout)
    fs, fs_ds = get_family("sin_scaled"), get_family_ds("sin_scaled")
    for T in (128, 256):
        thetas = np.linspace(1.0, 4.0, LANES).reshape(LANES // T, T)
        base = W.first_phase_inputs(fs, thetas, (0.0, 1.0), 1e-5,
                                    refill_slots=8, scout=False,
                                    theta_block=T, **flagship)
        runs[f"theta_{T}"] = k1_prepare(base, fs_ds, 1e-5, False, T)
    seeded = W.first_phase_inputs(f, theta, bounds, eps, refill_slots=0,
                                  scout=False, **flagship)
    for tag, twin in twins.items():
        runs["k2_step" + tag] = k2_prepare(seeded, twin, eps, False,
                                           seeded["thresh"])
        runs["k2_step_scout" + tag] = k2_prepare(seeded, twin, eps, True,
                                                 seeded["thresh"])
    runs["k2_noexit"] = k2_prepare(seeded, f_ds, eps, False, -1)
    runs["k3_step"] = k3(seeded, f_ds, eps)
    simpson = Rule.SIMPSON
    seeded_s = W.first_phase_inputs(f, theta, bounds, eps_simpson,
                                    refill_slots=0, scout=False,
                                    rule=simpson, **flagship)
    runs["k3_step_simpson"] = k3(seeded_s, f_ds, eps_simpson, rule=simpson)
    out = {}
    for name, prepare in runs.items():
        if name.endswith("_reduced"):
            continue                     # timed with its reference twin
        pair = {name: prepare}
        if name + "_reduced" in runs:
            pair[name + "_reduced"] = runs[name + "_reduced"]
        for n, (times, steps) in _timed_pairs(pair, launches).items():
            out[n] = {"ms": times, "steps": steps}
    out["k1_main_path"] = main_path(refill_slots=8, double_buffer=True,
                                    scout_dtype="f32")
    out["k2_main_path"] = main_path(refill_slots=0, scout_dtype="f64")
    return out


def compare(roots, rounds: int, launches: int, out_path,
            body_args=()) -> int:
    import numpy as np
    order = [r for _ in range(rounds) for r in (*roots, *roots[::-1])]
    per_root = {r: [] for r in roots}
    for root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--launches", str(launches), *body_args],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        per_root[root].append(rec)
        print(json.dumps(rec), flush=True)
    summary = {}
    for root, recs in per_root.items():
        summary[root] = {}
        for name in recs[0]:
            if name == "root":
                continue
            meds = [float(np.median(r[name]["ms"])) for r in recs]
            q25, q50, q75 = np.percentile(meds, [25, 50, 75])
            steps = recs[0][name]["steps"]
            summary[root][name] = dict(
                median_ms=float(q50), iqr_ms=float(q75 - q25),
                us_per_step=1e3 * float(q50) / steps, steps=steps,
                process_medians_ms=meds)
            if "busy_ms" in recs[0][name]:            # a main path
                summary[root][name].update(
                    busy_ms=[r[name]["busy_ms"] for r in recs],
                    idle_share=[r[name]["idle_share"] for r in recs],
                    median_wall_s=[float(np.median(r[name]["walls_s"]))
                                   for r in recs],
                    tasks=sorted({r[name]["tasks"] for r in recs}),
                    areas_sha256=sorted({r[name]["areas_sha256"]
                                         for r in recs}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    result = {"order": order, "launches": launches, "smi": smi,
              "summary": summary}
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(result, fh, indent=1)
    for name in summary[roots[0]]:
        cells = "; ".join(
            f"{os.path.basename(os.path.normpath(r))}: "
            f"{summary[r][name]['median_ms']:.4f} ms (IQR "
            f"{summary[r][name]['iqr_ms']:.4f}), "
            f"{summary[r][name]['us_per_step']:.3f} us/step"
            for r in roots)
        print(f"[time_k1] {name} ({summary[roots[0]][name]['steps']} "
              f"steps): {cells}", flush=True)
    print(smi, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--launches", type=int, default=11)
    ap.add_argument("--compare", nargs="+", metavar="ROOT")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--family", default="sin_recip_scaled",
                    help="the integrand of the K1 and K2 banks")
    ap.add_argument("--reduced", action="store_true",
                    help="also time the family's range-reduced ds twin on "
                         "the same banks")
    args = ap.parse_args(argv)
    # passed on only when asked for: a parent checkout may predate them
    body_args = (["--family", args.family]
                 if args.family != "sin_recip_scaled" else []) \
        + (["--reduced"] if args.reduced else [])
    if args.compare:
        return compare([os.path.abspath(r) for r in args.compare],
                       args.rounds, args.launches, args.out, body_args)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("time_k1: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    out = {"root": args.root, **time_root(args.launches, args.family,
                                          args.reduced)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
