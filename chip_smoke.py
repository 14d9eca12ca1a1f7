#!/usr/bin/env python3
"""Drive the PyTorch port (ppls_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits nonzero):

1. Device: the card's name and power limit.
2. Build: compile the K1 walk-segment kernel (csrc/walk_rf.cu) from the
   checkout with nvcc and load it.
3. Kernel vs plain: breed and deal a flagship-config root bank
   (lanes=16384, R=8), run one K1 launch and the plain PyTorch segment
   on identical copies with cap=256, in the trapezoid and the scouting
   step modes, and require bit-equality of every output.
4. Main path: ``integrate_family_walker`` at the flagship configuration
   (sin_recip_scaled, M=1024 thetas on [1e-4, 1], eps=1e-10, lanes=2^14,
   R=8, scout f32, double-buffered banks): a warm-up run, then a timed
   run with the K1 launch count read around it. Areas must be finite and
   within 1e-3 of the closed form, and the waste buckets must reconcile
   to lanes x kernel steps. The same configuration with scouting off
   must agree with the port's float64 bag engine within 3e-9 on every
   128th member. The scouting run's distance from the bag is printed,
   not held (see phase 5).
5. Scout schedule: at |theta/x| ~ 1e4 the float32 scout error exceeds
   the reference's guard band, so its decisive splits over-refine by
   rounding noise, in the reference walker as in the port. The
   configuration of tests/test_torch_walker.py's flagship-regime test
   (every 256th theta, lanes=1024), where the CPU port reproduces the
   reference walker's tasks and areas, runs on the card and on the CPU:
   the same tasks, kernel steps and waste, and areas within 1e-12.
6. Profile: one more main-path run under ``torch.profiler``: device busy
   time, idle share and the kernels that take it.

Before the last line it prints one JSON object describing each kernel
(time, plain time, bound, launches on the main path) and the card's
``nvidia-smi`` name and power limit; the last line is the
``{"ok": true, "device": ...}`` record. Details go to chiprun_out/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

M = 1024
EPS = 1e-10
BOUNDS = (1e-4, 1.0)
LANES = 1 << 14
REFILL_SLOTS = 8
ROOTS_PER_LANE = 12
CAPACITY = 1 << 23
CMP_CAP = 256                  # steps of the kernel-vs-plain launch
AREA_TOL_BAG = 3e-9
AREA_TOL_EXACT = 1e-3
AREA_TOL_DEVICES = 1e-12       # card vs CPU: float64 reduction order only
SCHEDULE_STRIDE = 256          # phase 5: every 256th theta ...
SCHEDULE_LANES = 1024          # ... over 1024 lanes
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
# operations/s outside the tensor cores (an FMA counted as two)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def clone_inputs(inp: dict) -> dict:
    from ppls_tpu_torch.parallel.walker import WalkState
    return dict(
        state=WalkState(*(t.clone() for t in inp["state"])),
        slot=inp["slot"].clone(), nslots=inp["nslots"].clone(),
        bank=tuple(t.clone() for t in inp["bank"]),
        resm=tuple(t.clone() for t in inp["resm"]),
        thresh=inp["thresh"], batch=inp["batch"])


def run_k1(fn, inp: dict, f_ds, scout: bool):
    """Launch ``fn`` (the kernel wrapper or the plain segment) on
    ``inp``; returns (outputs, milliseconds by CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    resh, resl, ctr = fn(inp["state"], inp["slot"], inp["thresh"], CMP_CAP,
                         inp["batch"], inp["nslots"], inp["bank"],
                         inp["resm"], f_ds=f_ds, eps=EPS, scout=scout)
    stop.record()
    torch.cuda.synchronize()
    outs = [*inp["state"], inp["slot"], *inp["resm"], resh, resl, ctr]
    return outs, start.elapsed_time(stop)


def k1_operation_counts(f_ds) -> dict:
    """float32 arithmetic operations (add, sub, mul, div, neg, abs,
    round) of one ds eval, one scout eval and one trapezoid step's
    non-eval work, counted by running the plain PyTorch twins on one
    lane under a counting function mode."""
    import torch
    from torch.overrides import TorchFunctionMode
    from ppls_tpu_torch.parallel import walker as W

    arith = {"add", "sub", "mul", "div", "true_divide", "neg", "abs",
             "round", "__radd__", "__rsub__", "__rmul__", "__rtruediv__"}

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in arith and any(
                    isinstance(a, torch.Tensor) and a.is_floating_point()
                    for a in args):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    def count(fn, *args):
        Count.n = 0
        with Count():
            fn(*args)
        return Count.n

    one = torch.full((1,), 0.5, dtype=torch.float32)
    zero = torch.zeros(1, dtype=torch.float32)
    x, th = (one, zero), (one * 2, zero)
    ds_eval = count(f_ds, x, th)
    sc_eval = count(W.scout_twin(f_ds), x, th)
    s = W._fresh_lanes(1, "cpu")._replace(
        flags=torch.zeros(1, dtype=torch.int32),
        w_h=torch.full((1,), 0.25, dtype=torch.float32))
    step = count(W._step_trap, s, f_ds, 1e-10)
    return dict(ds_eval=ds_eval, scout_eval=sc_eval,
                step_overhead=step - ds_eval)


def k1_bound_ms(inp: dict, ctr: list, ops: dict, scout: bool):
    """Least time for the launch's work: bytes moved (inputs read once,
    outputs written once) over HBM bandwidth, or the float32 operations
    this run's data needed over the float32 peak, whichever is larger.
    Returns (bound_ms, "bytes" or "operations")."""
    lanes = inp["slot"].shape[0]
    R = inp["bank"][0].shape[0]
    lane_bytes = 26 * 4 + 2 * 4 + 3 * 4          # state, slot/nslots, resm
    bytes_in = lanes * lane_bytes + 7 * 4 * R * lanes
    bytes_out = lanes * (26 * 4 + 4 + 3 * 4) + 2 * 4 * R * lanes + 8 * 4
    live_steps = ctr[1]                        # eval_active lane-steps
    if scout:
        n_ops = (ctr[6] * ops["scout_eval"] + ctr[7] * ops["ds_eval"]
                 + live_steps * ops["step_overhead"])
    else:
        n_ops = live_steps * (ops["ds_eval"] + ops["step_overhead"])
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES
    t_ops = n_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ppls_tpu_torch.models.integrands import (family_exact, get_family,
                                                  get_family_ds)
    from ppls_tpu_torch.parallel import walker as W
    from ppls_tpu_torch.parallel.bag_engine import integrate_family
    from ppls_tpu_torch.utils.cuda_build import load_walk_rf

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[smoke] device: {kind} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    built = load_walk_rf()
    log(f"[smoke] K1 build: {built.build_seconds:.1f} s -> {built.path}")
    with open(os.path.join(out_dir, "walk_rf_build.log"), "w") as fh:
        fh.write(built.log)
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[smoke] ptxas: {line.strip()}")

    f_theta = get_family("sin_recip_scaled")
    f_ds = get_family_ds("sin_recip_scaled")
    theta = 1.0 + np.arange(M) / M

    # 3. kernel vs plain on the card, both step modes
    ops = k1_operation_counts(f_ds)
    log(f"[smoke] float32 ops: ds eval {ops['ds_eval']}, scout eval "
        f"{ops['scout_eval']}, step overhead {ops['step_overhead']}")
    cmp = {}
    for scout in (False, True):
        mode = "step_scout" if scout else "step"
        t0 = time.perf_counter()
        base = W.first_phase_inputs(
            f_theta, theta, BOUNDS, EPS, lanes=LANES,
            roots_per_lane=ROOTS_PER_LANE, refill_slots=REFILL_SLOTS,
            capacity=CAPACITY, scout=scout, device="cuda")
        log(f"[smoke] flagship bank dealt in "
            f"{time.perf_counter() - t0:.1f} s: "
            f"{int(base['nslots'].sum())} roots over {LANES} lanes x "
            f"{REFILL_SLOTS} slots, thresh {base['thresh']}, batch "
            f"{base['batch']}")
        outs_k = None
        times = []
        for _ in range(3):
            inp = clone_inputs(base)
            outs_k, ms = run_k1(W.run_segment_rf, inp, f_ds, scout)
            times.append(ms)
        inp_p = clone_inputs(base)
        outs_p, plain_ms = run_k1(W.segment_rf_plain, inp_p, f_ds, scout)
        max_err = 0.0
        for a, b in zip(outs_k, outs_p):
            if a.dtype == torch.float32:
                same = torch.equal(a.view(torch.int32), b.view(torch.int32))
                max_err = max(max_err, float((a - b).abs().max()))
            else:
                same = torch.equal(a, b)
            if not same:
                raise AssertionError(
                    f"K1 {mode}: kernel and plain segment differ")
        ctr = outs_k[-1].tolist()
        kernel_ms = float(np.median(times))
        bound, bound_by = k1_bound_ms(base, ctr, ops, scout)
        cmp[mode] = dict(ms=kernel_ms, plain_ms=plain_ms, max_abs_err=max_err,
                         bound_ms=bound, bound_by=bound_by, counters=ctr)
        log(f"[smoke] K1 {mode}: bit-equal to the plain segment; "
            f"{ctr[0]} steps; kernel {kernel_ms:.3f} ms (runs "
            f"{', '.join(f'{t:.3f}' for t in times)}), plain "
            f"{plain_ms:.1f} ms, bound {bound:.4f} ms; counters {ctr}")
    log("[smoke] library_ms: no single PyTorch call computes the walk "
        "segment, so there is none")

    # 4. main path: the flagship, scouting on, double-buffered banks
    kw = dict(capacity=CAPACITY, lanes=LANES, refill_slots=REFILL_SLOTS,
              roots_per_lane=ROOTS_PER_LANE, double_buffer=True,
              device="cuda")
    t0 = time.perf_counter()
    W.integrate_family_walker(f_theta, f_ds, theta, BOUNDS, EPS,
                              scout_dtype="f32", **kw)
    torch.cuda.synchronize()
    log(f"[smoke] warm-up run: {time.perf_counter() - t0:.2f} s")
    W.run_segment_rf.launches = 0
    t0 = time.perf_counter()
    res = W.integrate_family_walker(f_theta, f_ds, theta, BOUNDS, EPS,
                                    scout_dtype="f32", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = W.run_segment_rf.launches
    mt = res.metrics
    areas = np.asarray(res.areas)
    if not np.all(np.isfinite(areas)) or areas.shape != (M,):
        raise AssertionError("main path: non-finite or misshapen areas")
    if mt.tasks != mt.splits + mt.leaves:
        raise AssertionError("main path: tasks != splits + leaves")
    att = res.attribution()
    if not att["reconciles"]:
        raise AssertionError(f"main path: waste does not reconcile {att}")
    if launches <= 0:
        raise AssertionError("main path: K1 was never launched")
    log(f"[smoke] main path: wall {wall:.3f} s, {mt.tasks} tasks "
        f"({mt.tasks / wall / 1e6:.2f} M tasks/s), kernel steps "
        f"{res.kernel_steps}, cycles {res.cycles}, K1 launches {launches}, "
        f"host syncs {res.host_syncs} (per cycle "
        f"{res.host_syncs_per_cycle}), lane efficiency "
        f"{res.lane_efficiency:.4f}, walker fraction "
        f"{res.walker_fraction:.4f}, scout evals {res.scout_evals}, "
        f"confirm evals {res.confirm_evals}")
    log(f"[smoke] waste buckets: {att['buckets']}")

    # the same configuration with scouting off: the ds walk holds the
    # float64 bag. The scouting run's distance from the bag is printed
    # only; phase 5 checks its schedule.
    t0 = time.perf_counter()
    res_ds = W.integrate_family_walker(f_theta, f_ds, theta, BOUNDS, EPS,
                                       scout_dtype="f64", **kw)
    torch.cuda.synchronize()
    wall_ds = time.perf_counter() - t0
    sample = np.arange(0, M, 128)
    bag = integrate_family(f_theta, theta[sample], BOUNDS, EPS,
                           capacity=1 << 22, device="cuda")
    exact = family_exact("sin_recip_scaled", *BOUNDS, theta)
    d_exact = float(np.max(np.abs(areas - exact)))
    d_bag_ds = float(np.max(np.abs(np.asarray(res_ds.areas)[sample]
                                   - bag.areas)))
    d_bag = float(np.max(np.abs(areas[sample] - bag.areas)))
    err_w = float(np.max(np.abs(areas[sample] - exact[sample])))
    err_b = float(np.max(np.abs(bag.areas - exact[sample])))
    log(f"[smoke] scouting off: wall {wall_ds:.3f} s, "
        f"{res_ds.metrics.tasks} tasks, kernel steps "
        f"{res_ds.kernel_steps}, lane efficiency "
        f"{res_ds.lane_efficiency:.4f}; scouting on: "
        f"{mt.tasks - res_ds.metrics.tasks:+d} tasks")
    log(f"[smoke] on {len(sample)} members: max |walker(ds) - f64 bag| "
        f"{d_bag_ds:.3e} (tol {AREA_TOL_BAG}); max |walker(scout) - f64 "
        f"bag| {d_bag:.3e} (not held: over-refinement, phase 5); max "
        f"|walker(scout) - closed form| {err_w:.3e}, the bag's {err_b:.3e}; "
        f"all {M}: max |walker(scout) - closed form| {d_exact:.3e} (tol "
        f"{AREA_TOL_EXACT})")
    if not d_bag_ds < AREA_TOL_BAG:
        raise AssertionError("ds walk: areas disagree with the f64 bag")
    if not d_exact < AREA_TOL_EXACT:
        raise AssertionError("main path: areas disagree with closed form")

    # 5. scout schedule: the card against the plain segment on the CPU at
    # the configuration where the CPU port reproduces the reference walker
    sub = theta[::SCHEDULE_STRIDE]
    skw = dict(kw, lanes=SCHEDULE_LANES, capacity=1 << 22,
               scout_dtype="f32")
    t0 = time.perf_counter()
    on_card = W.integrate_family_walker(f_theta, f_ds, sub, BOUNDS, EPS,
                                        **skw)
    skw["device"] = "cpu"
    on_cpu = W.integrate_family_walker(f_theta, f_ds, sub, BOUNDS, EPS,
                                       **skw)
    sub_bag = integrate_family(f_theta, sub, BOUNDS, EPS, capacity=1 << 22,
                               device="cuda")
    d_dev = float(np.max(np.abs(on_card.areas - on_cpu.areas)))
    log(f"[smoke] scout schedule on {len(sub)} members, "
        f"{SCHEDULE_LANES} lanes ({time.perf_counter() - t0:.1f} s): card "
        f"{on_card.metrics.tasks} tasks / {on_card.kernel_steps} steps, "
        f"CPU {on_cpu.metrics.tasks} / {on_cpu.kernel_steps}, max |card - "
        f"CPU| {d_dev:.3e} (tol {AREA_TOL_DEVICES}); vs the f64 bag: "
        f"{on_card.metrics.tasks - sub_bag.metrics.tasks:+d} tasks, |card "
        f"- bag| per member "
        f"{np.array2string(np.abs(on_card.areas - sub_bag.areas), precision=3)}")
    if (on_card.metrics.tasks != on_cpu.metrics.tasks
            or on_card.kernel_steps != on_cpu.kernel_steps
            or not np.array_equal(on_card.waste, on_cpu.waste)):
        raise AssertionError("scout schedule: card and CPU walks differ")
    if not d_dev < AREA_TOL_DEVICES:
        raise AssertionError("scout schedule: card and CPU areas differ")

    # 6. where the time goes: one more main-path run under the profiler
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        W.integrate_family_walker(f_theta, f_ds, theta, BOUNDS, EPS,
                                  scout_dtype="f32", **kw)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    busy_ms = sum(dev_us(e) for e in events) / 1e3
    k1_ms = sum(dev_us(e) for e in events if "walk_rf_kernel" in e.key) / 1e3
    by_dev = sorted(events, key=dev_us, reverse=True)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as fh:
        for e in by_dev[:40]:
            fh.write(f"{dev_us(e) / 1e3:12.3f} ms  {e.count:8d}  {e.key}\n")
    if busy_ms > 0:
        log(f"[smoke] profile: wall {wall_prof * 1e3:.1f} ms, device busy "
            f"{busy_ms:.1f} ms (idle share "
            f"{1 - busy_ms / (wall_prof * 1e3):.3f}), K1 {k1_ms:.1f} ms")
        for e in by_dev[:8]:
            log(f"[smoke]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{e.key[:80]}")
    else:
        log("[smoke] profile: the profiler recorded no device time "
            "(device busy share not measured)")
    with open(os.path.join(out_dir, "chip_smoke_main.json"), "w") as fh:
        json.dump(dict(wall_s=wall, tasks=mt.tasks,
                       kernel_steps=res.kernel_steps, cycles=res.cycles,
                       launches=launches, host_syncs=res.host_syncs,
                       host_syncs_per_cycle=res.host_syncs_per_cycle,
                       waste=att["buckets"],
                       lane_efficiency=res.lane_efficiency,
                       walker_fraction=res.walker_fraction,
                       seg_stats=res.seg_stats.tolist(),
                       cycle_stats=res.cycle_stats.tolist(),
                       ds_run=dict(wall_s=wall_ds,
                                   tasks=res_ds.metrics.tasks,
                                   kernel_steps=res_ds.kernel_steps,
                                   waste=res_ds.attribution()["buckets"]),
                       d_bag_ds=d_bag_ds, d_bag=d_bag, err_w=err_w,
                       err_b=err_b, d_exact=d_exact,
                       schedule=dict(tasks=on_card.metrics.tasks,
                                     bag_tasks=sub_bag.metrics.tasks,
                                     d_card_cpu=d_dev,
                                     d_bag=np.abs(on_card.areas
                                                  - sub_bag.areas).tolist()),
                       profile=dict(wall_ms=wall_prof * 1e3,
                                    busy_ms=busy_ms, k1_ms=k1_ms),
                       k1=cmp, device=kind, smi=smi), fh, indent=1)
    log(f"[smoke] total {time.perf_counter() - t_start:.1f} s")

    scout = cmp["step_scout"]
    print(json.dumps({"kernels": [{
        "name": "walk_rf", "route": "cuda",
        "source": "ppls_tpu_torch/csrc/walk_rf.cu",
        "replaces": "ppls_tpu/parallel/walker.py:993",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cmp.values()),
        "ms": scout["ms"], "plain_ms": scout["plain_ms"],
        "bound_ms": scout["bound_ms"], "bound_by": scout["bound_by"],
        "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
