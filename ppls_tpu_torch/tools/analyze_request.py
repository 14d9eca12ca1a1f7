"""Offline per-request critical-path analyzer: where did one request's
latency go?

It replays a ``serve --events`` timeline (the request-scoped trace:
detached ``request`` spans and their child events) with no device, and
prints:

* the PER-RID LATENCY DECOMPOSITION: submit -> admit (backlog wait
  against token-bucket wait) -> compute phases (engine residency or the
  spillover hand-off) -> retirement, with the redeal, quarantine and
  deadline trail annotated. The components are exact phase counts that
  sum to the recorded retire latency::

      backlog_wait + token_wait + in_flight == latency_phases

  (``--check`` exits 1 on any rid where they do not);
* the TOP-K SLOWEST requests with their decompositions;
* PER-TENANT and PER-CLASS rollups (count, failed, shed, mean and max
  latency, mean queue wait);
* the incomplete set: rids with an opened trace but no terminal event,
  the shape a crashed prefix leaves (reported, never fatal; crashed and
  resumed multi-segment timelines work, replayed events deduped by rid).

Usage::

    python ppls_tpu_torch/tools/analyze_request.py EVENTS.jsonl
        [MORE.jsonl ...] [--top K] [--json] [--check] [--tenant NAME]

Rolled segments (``--events-max-mb``) are picked up automatically:
passing ``EVENTS.jsonl`` also reads ``EVENTS.jsonl.1`` ... in order. The
functions, flags, output and exit codes are those of the JAX package's
``tools/analyze_request.py``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

# the per-rid trace vocabulary: one definition, shared with the
# rid-linkage validator so the analyzer and the schema check cannot
# drift apart
from ppls_tpu_torch.utils.artifact_schema import (
    RID_TRACE_EVENTS as TRACE_EVENTS,
    dedup_replayed,
)


def expand_paths(paths: List[str]) -> List[str]:
    """Auto-include rolled segment siblings (``<p>.1`` ...) BEFORE the
    active file — rolled files are the older part of the timeline."""
    out: List[str] = []
    for p in paths:
        rolled = []
        for s in glob.glob(f"{p}.*"):
            suffix = s[len(p) + 1:]
            if suffix.isdigit():
                rolled.append((int(suffix), s))
        out.extend(s for _, s in sorted(rolled))
        out.append(p)
    return out


def load_trace(paths: List[str]) -> Dict[int, dict]:
    """Parse the per-rid trace out of one or more event files.

    Returns ``{rid: {"open": attrs|None, "events": {name: attrs or
    [attrs...]}, "phases": sorted [phase...], "redeals": [...],
    "token_waits": n}}`` with replayed duplicates (resume re-emits
    nothing, but a supervisor retry may re-append restored spans)
    deduped by rid / (rid, phase)."""
    rids: Dict[int, dict] = {}

    def rec_for(rid: int) -> dict:
        return rids.setdefault(int(rid), {
            "open": None, "terminal": None, "events": {},
            "phases": set(), "processes": set(), "redeals": [],
            "token_wait_events": set()})

    sid_rid: Dict[int, int] = {}
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if not isinstance(rec, dict):
                    continue
                ev = rec.get("ev")
                if ev == "meta":
                    sid_rid.clear()      # span ids restart per segment
                    continue
                attrs = rec.get("attrs") or {}
                if ev == "span_open" and rec.get("name") == "request":
                    rid = attrs.get("rid")
                    if rid is None:
                        continue
                    sid_rid[rec.get("id")] = int(rid)
                    r = rec_for(rid)
                    if r["open"] is None:
                        r["open"] = dict(attrs)
                    continue
                if ev != "event":
                    continue
                name = rec.get("name")
                rid = attrs.get("rid")
                if name not in TRACE_EVENTS or rid is None:
                    continue
                r = rec_for(rid)
                if name in ("retire", "request_shed"):
                    if r["terminal"] is None:
                        r["terminal"] = (name, dict(attrs))
                elif name in ("admit", "request_dealt",
                              "spillover_enqueued"):
                    r["events"].setdefault(name, dict(attrs))
                elif name == "request_phase":
                    r["phases"].add(int(attrs.get("phase", -1)))
                    if "process" in attrs:
                        r["processes"].add(attrs["process"])
                elif name == "token_wait":
                    r["token_wait_events"].add(
                        int(attrs.get("phase", -1)))
                elif name == "request_redeal":
                    r["redeals"].append(dict(attrs))
                else:   # quarantine / deadline_exceeded
                    r["events"].setdefault(name, dict(attrs))
    # replay dedup (shared helper): a resumed segment re-emits the
    # post-snapshot redeal events; one record per (phase, process)
    # survives, first (original) occurrence wins
    for r in rids.values():
        r["redeals"] = dedup_replayed(
            r["redeals"],
            lambda d: (d.get("phase"), d.get("process")))
    return rids


def decompose(rid: int, r: dict) -> Optional[dict]:
    """One rid's critical-path decomposition (None for non-retired
    rids — shed and incomplete traces are reported separately).

    EXACTNESS contract: ``backlog_wait + token_wait + in_flight ==
    latency_phases`` where latency_phases is the retire event's own
    recorded value — integers, no estimation."""
    if r["terminal"] is None or r["terminal"][0] != "retire":
        return None
    t = r["terminal"][1]
    admit_ev = r["events"].get("admit") or r["events"].get(
        "request_dealt") or {}
    submit = int(t.get("submit_phase",
                       admit_ev.get("submit_phase", 0)))
    admit = int(t.get("admit_phase", admit_ev.get("phase", submit)))
    retire = int(t.get("retire_phase", admit))
    latency = int(t.get("latency_phases", retire - submit + 1))
    token_wait = int(admit_ev.get("token_wait_phases",
                                  len(r["token_wait_events"])))
    queue_wait = admit - submit
    backlog_wait = queue_wait - token_wait
    in_flight = retire - admit + 1
    out = {
        "rid": int(rid),
        "tenant": t.get("tenant", "default"),
        "priority": t.get("priority", 1),
        "submit_phase": submit, "admit_phase": admit,
        "retire_phase": retire,
        "latency_phases": latency,
        "components": {
            "backlog_wait": backlog_wait,
            "token_wait": token_wait,
            "in_flight": in_flight,
        },
        "exact": backlog_wait + token_wait + in_flight == latency,
        "compute_phases": len(r["phases"]),
        "failed": bool(t.get("failed")),
        "failure": t.get("failure"),
        "spillover": bool(t.get("spillover")
                          or "spillover_enqueued" in r["events"]),
        "redeals": len(r["redeals"]),
    }
    if r["processes"]:
        out["processes"] = sorted(r["processes"], key=str)
    return out


def analyze(paths: List[str], top: int = 5) -> dict:
    """The whole report as one dict (the ``--json`` document and the
    test surface)."""
    rids = load_trace(paths)
    rows, shed, incomplete = [], [], []
    for rid in sorted(rids):
        r = rids[rid]
        d = decompose(rid, r)
        if d is not None:
            rows.append(d)
        elif r["terminal"] is not None:      # request_shed
            t = r["terminal"][1]
            shed.append({"rid": int(rid),
                         "tenant": t.get("tenant", "default"),
                         "reason": t.get("reason"),
                         "phase": t.get("phase")})
        else:
            incomplete.append(int(rid))

    def rollup(key_fn):
        acc: Dict[str, dict] = {}
        for d in rows:
            k = str(key_fn(d))
            a = acc.setdefault(k, {
                "count": 0, "failed": 0, "spillover": 0,
                "latency_sum": 0, "latency_max": 0,
                "queue_wait_sum": 0, "in_flight_sum": 0})
            a["count"] += 1
            a["failed"] += int(d["failed"])
            a["spillover"] += int(d["spillover"])
            a["latency_sum"] += d["latency_phases"]
            a["latency_max"] = max(a["latency_max"],
                                   d["latency_phases"])
            a["queue_wait_sum"] += (d["components"]["backlog_wait"]
                                    + d["components"]["token_wait"])
            a["in_flight_sum"] += d["components"]["in_flight"]
        for k, a in acc.items():
            n = max(a["count"], 1)
            a["latency_mean"] = round(a["latency_sum"] / n, 3)
            a["queue_wait_mean"] = round(a["queue_wait_sum"] / n, 3)
        for s in shed:
            if key_fn(s) is not None:
                acc.setdefault(str(key_fn(s)), {"count": 0}) \
                    .setdefault("shed", 0)
                acc[str(key_fn(s))]["shed"] = \
                    acc[str(key_fn(s))].get("shed", 0) + 1
        return dict(sorted(acc.items()))

    slowest = sorted(rows, key=lambda d: (-d["latency_phases"],
                                          d["rid"]))[:top]
    return {
        "requests": rows,
        "shed": shed,
        "incomplete": incomplete,
        "exact": all(d["exact"] for d in rows),
        "top_slowest": slowest,
        "by_tenant": rollup(lambda d: d.get("tenant")),
        "by_class": rollup(lambda d: d.get("priority")),
    }


def _fmt_row(d: dict) -> str:
    c = d["components"]
    trail = []
    if d["spillover"]:
        trail.append("spillover")
    if d["redeals"]:
        trail.append(f"redeal x{d['redeals']}")
    if d["failure"]:
        trail.append(d["failure"])
    return (f"  rid {d['rid']:>5}  {d['tenant']:<10} "
            f"p{d['priority']}  "
            f"lat={d['latency_phases']:>4}  "
            f"= backlog {c['backlog_wait']} + token "
            f"{c['token_wait']} + in-flight {c['in_flight']}"
            f"{'  [' + ', '.join(trail) + ']' if trail else ''}"
            f"{'' if d['exact'] else '  ** DOES NOT SUM **'}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ppls_tpu_torch/tools/analyze_request.py",
        description="per-request critical-path decomposition from a "
                    "serve --events timeline")
    p.add_argument("events", nargs="+", help="event file(s); rolled "
                   "segments (<file>.N) are auto-included")
    p.add_argument("--top", type=int, default=5)
    p.add_argument("--tenant", default=None,
                   help="restrict the per-rid table to one tenant")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless every decomposition sums "
                        "exactly to its recorded retire latency")
    args = p.parse_args(argv)

    paths = expand_paths(args.events)
    missing = [q for q in paths if not os.path.exists(q)]
    if missing:
        print(f"analyze_request: no such file: {missing[0]}",
              file=sys.stderr)
        return 2
    rep = analyze(paths, top=args.top)

    if args.as_json:
        print(json.dumps(rep, indent=1, sort_keys=True))
    else:
        rows = [d for d in rep["requests"]
                if args.tenant is None or d["tenant"] == args.tenant]
        print(f"=== request critical paths: "
              f"{', '.join(os.path.basename(q) for q in paths)} ===")
        print(f"retired={len(rep['requests'])} shed={len(rep['shed'])}"
              f" incomplete={len(rep['incomplete'])} "
              f"exact={'yes' if rep['exact'] else 'NO'}")
        for d in rows:
            print(_fmt_row(d))
        if rep["top_slowest"]:
            print(f"--- top {len(rep['top_slowest'])} slowest ---")
            for d in rep["top_slowest"]:
                print(_fmt_row(d))
        for title, block in (("tenant", rep["by_tenant"]),
                             ("class", rep["by_class"])):
            print(f"--- by {title} ---")
            for k, a in block.items():
                print(f"  {k:<10} n={a.get('count', 0):>4} "
                      f"failed={a.get('failed', 0)} "
                      f"shed={a.get('shed', 0)} "
                      f"lat mean/max="
                      f"{a.get('latency_mean', 0)}/"
                      f"{a.get('latency_max', 0)} "
                      f"queue mean={a.get('queue_wait_mean', 0)}")
        if rep["incomplete"]:
            print(f"--- incomplete (crashed prefix?) --- "
                  f"{rep['incomplete'][:16]}")
    if args.check and not rep["exact"]:
        bad = [d["rid"] for d in rep["requests"] if not d["exact"]]
        print(f"analyze_request: decomposition does not sum for "
              f"rid(s) {bad[:8]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
