"""The family driver: a closed loop of back-to-back batch calls.

Each call integrates a fresh batch of members drawn from the seed, through
``integrate_family_walker`` on one card. A warm call of the same size
comes first and counts as set-up; the window then runs whole calls
until ``seconds`` have passed, and its length is from the first call's
start to the last call's end, so the rate holds all the work and all the
time of the window.
"""

from __future__ import annotations

import time

import numpy as np

import generate
import devtrace as tr


def _kw(cfg: dict) -> dict:
    kw = dict(cfg["batch"])
    kw["scout_dtype"] = cfg["scout_dtype"]
    kw["double_buffer"] = cfg["double_buffer"]
    return kw


def _call_record(res, wall_s: float) -> dict:
    """What the readers and the check take from one call's result."""
    segs = res.seg_stats
    return {
        "tasks": int(res.metrics.tasks),
        "host_syncs": int(res.host_syncs),
        "lane_efficiency": float(res.lane_efficiency),
        "kernel_steps": int(res.kernel_steps),
        "lanes": int(res.lanes),
        "eval_active": int(res.waste[0]) if res.waste is not None else 0,
        "scout_evals": int(res.scout_evals),
        "confirm_evals": int(res.confirm_evals),
        "launches": int(len(segs)) if segs is not None else 0,
        "cycles": int(res.cycles),
        "wall_s": wall_s,
    }


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device: str, stamp) -> dict:
    import torch
    import ppls_tpu_torch as pt

    f, f_ds = pt.get_family(cfg["family"]), pt.get_family_ds(cfg["family"])
    kw, bounds, eps = _kw(cfg), tuple(cfg["bounds"]), float(cfg["eps"])
    stamp("import")
    if device != "cpu":
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats()
    stamp("cuda_context")
    if device != "cpu":
        from ppls_tpu_torch.utils import cuda_build
        cuda_build.load_walk_rf()
    stamp("kernel_library")

    def call(th):
        with tr.maybe(traced, lambda: tr.span("integrate_family_walker")):
            out = pt.integrate_family_walker(f, f_ds, th, bounds, eps,
                                             device=device, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        return out

    spec, members = mix["theta"], int(mix["members_per_chip"])
    call(generate.thetas(spec, generate.rng(seed, "warm"), members))
    stamp("warm_call")
    draw = generate.rng(seed, "window")
    calls, areas, thetas = [], [], []
    prof = tr.profiler() if traced else None
    if prof is not None:
        prof.start()
    with tr.maybe(traced, lambda: tr.span(tr.WINDOW)):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            th = generate.thetas(spec, draw, members)
            c0 = time.perf_counter()
            res = call(th)
            now = time.perf_counter()
            calls.append(_call_record(res, now - c0))
            areas.append(np.asarray(res.areas, dtype=np.float64).reshape(-1))
            thetas.append(th)
            if now >= deadline:
                break
        t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    walls = [c["wall_s"] for c in calls]
    return {"window_s": t1 - t0, "window_t0": t0, "calls": calls, "areas": areas, "thetas": thetas,
            "profile": prof,
            "notes": {"calls": len(calls), "call_s_min_p50_max": [
                min(walls), float(np.median(walls)), max(walls)],
                "host_syncs": [c["host_syncs"] for c in calls][:4],
                "cycles": [c["cycles"] for c in calls][:4]}}
