"""One run of one cell: the driver its traffic names, the check, the
metrics its ``BENCHMARK.json`` entry asks for, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name: ``configs/<file>`` (from the manifest),
``traffic/<name>.json`` (its ``driver`` names ``drivers/<driver>.py``)
and ``metrics/<metric>.py`` (``read(record)`` returns the value, or None
when the run holds nothing to read).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import check
import devtrace
import generate
import roofline

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def find(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(name)


def load_config(manifest: dict, name: str) -> dict:
    entry = find(manifest["configs"], name)
    with open(os.path.join(ROOT, entry["file"])) as fh:
        return json.load(fh)


def load_reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(manifest: dict, cell: str, traced: bool) -> list:
    """The metric entries this cell reports in a run of this kind."""
    entries = manifest["per_layer"] if traced else manifest["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def failed_run(e: BaseException) -> dict:
    """The result of a run whose program raised: not correct, no
    metrics, the error under the check."""
    return {"correct": False, "attempted": 1, "failed": 1, "metrics": {},
            "device": {}, "check": {"run_error": {
                "value": f"{type(e).__name__}: {e}"[:300], "limit": None}}}


def run_cell(manifest: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, *, device: str = "cuda", t_start: float,
             overrides: dict = None, log=None) -> dict:
    """One run; returns the result line's object (``check`` last)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = find(manifest["workloads"], cell_name)
    cfg = load_config(manifest, cell["config"])
    mix = generate.load_mix(cell["traffic"])
    overrides = overrides or {}
    cfg = merge(cfg, overrides.get("config", {}))
    mix = merge(mix, overrides.get("traffic", {}))
    driver = importlib.import_module(f"drivers.{mix['driver']}")

    stamps = {}
    last = [t_start]

    def stamp(name, seconds_=None):
        now = time.perf_counter()
        stamps[name] = now - last[0] if seconds_ is None else seconds_
        last[0] = now

    stamp("import_torch")
    try:
        rec = driver.run(cfg, mix, int(seed), float(seconds), bool(traced),
                         device, stamp)
    except Exception as e:  # noqa: BLE001 -- a failed run is not correct
        log(f"run failed: {e!r}")
        return failed_run(e)
    rec["setup_s"] = rec["window_t0"] - t_start
    log("setup: " + json.dumps({k: round(v, 3) for k, v in stamps.items()})
        + f" total {rec['setup_s']:.3f} s")
    if rec.get("notes"):
        log("run: " + json.dumps(rec["notes"]))
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    prof = rec.pop("profile", None)
    if prof is not None:
        t0 = time.perf_counter()
        rec["trace"] = devtrace.summarize(prof)
        log(f"trace reduced in {time.perf_counter() - t0:.1f} s")
    del prof
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    verdict = check.run(cfg, mix, rec, int(seed), device)
    log(f"check took {time.perf_counter() - t0:.1f} s")

    rec.update(cfg=cfg, roofline=roofline.load())
    metrics = {}
    for m in metrics_for(manifest, cell_name, traced):
        value = load_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": int(peak)}
    if device != "cpu":
        dev.update(platform="gpu", kind=torch.cuda.get_device_name(0),
                   power=power_limit())
    out = {"correct": verdict["correct"], "attempted": verdict["attempted"],
           "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if traced:
        tr = rec.get("trace") or {"busy_s": 0.0, "window_s": 0.0,
                                  "device_ops": [], "idle_gaps": []}
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["check"] = verdict["numbers"]
    return out
