"""The stream driver: a closed loop of clients on one ``StreamEngine``.

Each of the mix's ``clients`` holds one request at a time: a theta batch
from ``requests``, submitted through ``StreamEngine.submit``. When the
phase that retires it ends, the client takes its areas and sends its
next request at once, so the engine always has a queue and the rate is
what it sustains. A request's latency runs from its submit to the end of
the phase that retired it, on the client's clock.

Set-up builds the engine, sends every client's first request and runs
``warm_phases`` phases of the loop (every shape the window uses, and the
queue in its steady state). The window then runs whole phases until
``seconds`` have passed; its rate counts the requests retired in it. The
requests still in flight when it closes are waited for (their phases run
on, with no new sends) up to ``LATE_S`` seconds, so that the check sees
every answer that was asked for.
"""

from __future__ import annotations

import time

import numpy as np

import devtrace as tr
import generate

LATE_S = 60.0     # the longest wait for the requests in flight at the close


def _engine_kw(cfg: dict, mix: dict) -> dict:
    kw = dict(cfg["stream"])
    kw.update(scout_dtype=cfg["scout_dtype"],
              double_buffer=cfg["double_buffer"],
              theta_block=int(mix["thetas_per_request"]))
    return kw


def requests(mix: dict, seed: int):
    """The run's requests, in the order the clients send them: an endless
    stream of stratified theta batches. Every seed sends the same requests
    in each block of ``block`` sends (one phase's admissions), drawn once
    for all seeds, so every seed asks for the same work; the seed orders
    the requests within the block and the thetas within each request."""
    deck = generate.rng(0, "requests")
    order = generate.rng(seed, "requests")
    spec, per = mix["theta"], int(mix["thetas_per_request"])
    block = int(mix["block"])
    while True:
        reqs = [generate.thetas(spec, deck, per) for _ in range(block)]
        for i in order.permutation(block):
            yield order.permutation(reqs[i])


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device: str, stamp) -> dict:
    import torch
    import ppls_tpu_torch as pt

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

    eng = pt.StreamEngine(cfg["family"], float(cfg["eps"]), device=device,
                          **_engine_kw(cfg, mix))
    bounds = tuple(cfg["bounds"])
    draw = requests(mix, seed)
    sent = {}                          # rid -> (submit time, thetas)
    phase_s = []

    def send(n: int) -> None:
        for _ in range(n):
            th = next(draw)
            sent[eng.submit(tuple(th), bounds)] = (time.perf_counter(), th)

    def phase(out: list) -> int:
        """One phase; its retired requests go to ``out``; returns how
        many retired."""
        p0 = time.perf_counter()
        retired = eng.step()
        if device != "cpu":
            torch.cuda.synchronize()
        now = time.perf_counter()
        phase_s.append(now - p0)
        for c in retired:
            t, th = sent.pop(c.rid)
            out.append({"rid": c.rid, "latency_s": now - t, "thetas": th,
                        "areas": c.areas, "failed": bool(c.failed)})
        return len(retired)

    send(int(mix["clients"]))
    warm = []
    for _ in range(int(mix["warm_phases"])):
        send(phase(warm))
    stamp("warm_phases")

    def totals():
        return {k: int(v) for k, v in eng.result().totals.items()}

    before, syncs0 = totals(), len(eng.result().host_syncs_per_phase)
    phases0, done = len(phase_s), []
    prof = tr.profiler() if traced else None
    if prof is not None:
        prof.start()
    with tr.maybe(traced, lambda: tr.span(tr.WINDOW)):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            with tr.maybe(traced, lambda: tr.span("StreamEngine.step")):
                n = phase(done)
            send(n)
        t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    res = eng.result()
    after = {k: int(v) for k, v in res.totals.items()}
    window_phases = phase_s[phases0:]
    in_flight = len(sent)
    # the requests in flight at the close: their phases run on, no sends
    late = []
    give_up = time.perf_counter() + LATE_S
    while sent and time.perf_counter() < give_up:
        phase(late)
    never = [{"rid": rid, "latency_s": float("inf"), "thetas": th,
              "areas": None, "failed": True}
             for rid, (_, th) in sent.items()]
    rec = {
        "window_s": t1 - t0, "window_t0": t0, "profile": prof,
        "requests": done, "answers": done + late + never,
        "phase_syncs": [int(n) for n in res.host_syncs_per_phase[syncs0:]],
        "totals": {k: after[k] - before.get(k, 0) for k in after},
        "lanes": int(eng.lanes),
    }
    lat = np.array([r["latency_s"] for r in done]) if done else np.zeros(1)
    rec["notes"] = {
        "retired": len(done), "phases": len(window_phases),
        "phase_s_p50_max": [float(np.median(window_phases or [0])),
                            float(max(window_phases or [0]))],
        "latency_s_p50_p95_max": [float(np.percentile(lat, 50)),
                                  float(np.percentile(lat, 95)),
                                  float(lat.max())],
        "in_flight_at_close": in_flight, "late": len(late),
        "never": len(never),
        "window_phase_s": [round(x, 3) for x in window_phases]}
    eng.close()
    return rec
