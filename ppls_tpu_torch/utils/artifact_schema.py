"""Schema checks for the serve contract's documents (the telemetry
event log of ``serve --events`` and the serve stdout ledger) and for
tuning tables.

The port's copy of the part of the JAX package's
``utils/artifact_schema.py`` that ``python -m ppls_tpu_torch serve``
and ``chip_smoke.py`` read (host-only Python, unchanged):
:func:`validate_events_text` checks the span/event JSONL shape (record
kinds, required keys, per-segment monotonic timestamps, span-nesting
balance), :func:`validate_serve_output_text` the retire/shed/rejection
records and the summary's accounting, and :func:`dedup_by_rid` collapses
the lines a resume replays; :func:`validate_tuning_table_json` checks a
tuning table (``tools/tune_table.py``'s output). The bench-record
envelope (:func:`validate_record`, :func:`validate_artifact_text`: the
``BENCH_r*.json`` / ``MULTICHIP_r*.json`` artifacts and bench stdout) and
the graftlint JSON ledger (:func:`validate_graftlint_json`,
:func:`validate_graftlint_text`) are checked here too, with the JAX
package's error texts, so ``ppls_tpu_torch/tools/check_artifacts.py``
reads every document type the reference's checker reads.
"""

from __future__ import annotations

import json
import math
from typing import List


class ArtifactSchemaError(ValueError):
    """A bench/multichip record violates the artifact envelope."""


def _is_finite_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def validate_record(rec: dict, *, where: str = "record",
                    require_vs_baseline: bool = True) -> dict:
    """Validate one bench record envelope; returns ``rec`` unchanged so
    call sites can wrap their final ``print(json.dumps(...))``.
    Raises :class:`ArtifactSchemaError` with the offending field."""
    if not isinstance(rec, dict):
        raise ArtifactSchemaError(f"{where}: not a JSON object")
    if "error" in rec and not isinstance(rec.get("error"), str):
        raise ArtifactSchemaError(f"{where}: 'error' must be a string")
    if not isinstance(rec.get("metric"), str) or not rec["metric"]:
        raise ArtifactSchemaError(f"{where}: missing/empty 'metric'")
    if not _is_finite_number(rec.get("value")):
        raise ArtifactSchemaError(
            f"{where}: 'value' must be a finite number, got "
            f"{rec.get('value')!r}")
    if not isinstance(rec.get("unit"), str) or not rec["unit"]:
        raise ArtifactSchemaError(f"{where}: missing/empty 'unit'")
    if require_vs_baseline and "error" not in rec \
            and not _is_finite_number(rec.get("vs_baseline")):
        raise ArtifactSchemaError(
            f"{where}: 'vs_baseline' must be a finite number, got "
            f"{rec.get('vs_baseline')!r}")
    sec = rec.get("secondary")
    if sec is not None:
        if not isinstance(sec, dict):
            raise ArtifactSchemaError(f"{where}: 'secondary' must be "
                                      f"an object")
        for name, sub in sec.items():
            if not isinstance(sub, dict):
                raise ArtifactSchemaError(
                    f"{where}.secondary.{name}: not an object")
            if "error" in sub or "skipped" in sub:
                continue
            # secondaries carry heterogeneous payloads (some are
            # records, some comparison blocks): require the metric
            # label, and check 'value' finiteness only when present —
            # a NaN/None value is the silent-poison case
            if not isinstance(sub.get("metric"), str) \
                    or not sub["metric"]:
                raise ArtifactSchemaError(
                    f"{where}.secondary.{name}: missing/empty 'metric'")
            if "value" in sub and not _is_finite_number(sub["value"]):
                raise ArtifactSchemaError(
                    f"{where}.secondary.{name}: 'value' must be a "
                    f"finite number, got {sub.get('value')!r}")
    return rec


def validate_artifact_text(text: str, *, where: str = "artifact",
                           require_records: bool = True) -> List[str]:
    """Validate every bench record found in an artifact's text.

    Two shapes are handled: a round's WRAPPER object (one
    pretty-printed JSON object whose ``tail`` string holds the bench's
    stdout/stderr tail — the records are JSON lines inside it), and a
    raw line stream (bench stdout piped directly). Only lines parsing
    as objects with a ``metric`` key are treated as bench records.
    Returns a list of problem strings (empty = clean);
    ``require_records`` flags an artifact with no records at all (the
    silent-drop outcome) — disable it for artifacts that legitimately
    carry none (e.g. the multichip dryrun log).
    """
    try:
        wrapper = json.loads(text)
    except json.JSONDecodeError:
        wrapper = None
    problems: List[str] = []
    found = 0
    if isinstance(wrapper, dict):
        if "metric" in wrapper:
            found += 1
            try:
                validate_record(wrapper, where=where)
            except ArtifactSchemaError as e:
                problems.append(str(e))
        tail = wrapper.get("tail")
        if isinstance(tail, str):
            sub, sub_found = _scan_lines(tail, f"{where}:tail")
            problems += sub
            found += sub_found
    else:
        sub, sub_found = _scan_lines(text, where)
        problems += sub
        found += sub_found
    if require_records and not found:
        problems.append(f"{where}: no bench records found")
    return problems


EVENT_KINDS = ("meta", "span_open", "span_close", "event")

# the per-rid trace event vocabulary: every one of these
# must link to an OPEN request span for its rid when the rid-linkage
# check is armed
RID_TRACE_EVENTS = ("admit", "request_dealt", "token_wait",
                    "request_phase", "spillover_enqueued",
                    "request_redeal", "quarantine",
                    "deadline_exceeded", "retire", "request_shed")


def validate_events_text(text: str, *, where: str = "events",
                         require_balanced: bool = True,
                         check_rid_linkage: bool = False) -> List[str]:
    """Validate a telemetry event log (``obs.spans`` JSONL timeline).

    Per line: a JSON object with ``ev`` in :data:`EVENT_KINDS`; every
    non-meta record carries a finite ``t`` that is non-decreasing
    WITHIN its segment (a ``meta`` line starts a new segment — the
    serve resume path appends one, restarting the monotonic clock);
    ``span_open`` carries int ``id``, non-empty ``name`` and a
    ``parent`` that is null or an OPEN span id; ``span_close`` closes
    an open id; ``event`` carries a non-empty ``name``; ``attrs``
    (when present) is an object. ``require_balanced=False`` tolerates
    unclosed spans — the shape a killed run leaves behind.

    ``check_rid_linkage=True`` additionally enforces the
    REQUEST-TRACE contract on timelines that carry it: every
    rid-bearing trace event (:data:`RID_TRACE_EVENTS`) must link to a
    ``request`` span OPEN for that rid in its segment (resumed
    segments re-open live rids' spans, so this holds across
    kill-and-resume), and a terminal event (retire / request_shed)
    must be followed by that rid's span close within the segment —
    zero orphan spans, zero orphan hops. Timelines predating the
    request-trace tier fail this check; leave it off for them.

    Returns a list of problem strings (empty = clean).
    """
    problems: List[str] = []
    open_spans: set = set()
    last_t = None
    found = 0
    # rid-linkage state (reset per segment, like span ids)
    req_sids: dict = {}          # open request-span id -> rid
    rid_open: set = set()        # rids with an open request span
    rid_terminal_open: set = set()   # terminal seen, span still open
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            problems.append(f"{where}:{i}: unparseable event line")
            continue
        if not isinstance(rec, dict):
            problems.append(f"{where}:{i}: not a JSON object")
            continue
        found += 1
        ev = rec.get("ev")
        if ev not in EVENT_KINDS:
            problems.append(f"{where}:{i}: unknown ev {ev!r}")
            continue
        if ev == "meta":
            # new segment (the resume-append path): the monotonic
            # clock AND the span-id space restart. Spans the previous
            # segment left open are the crashed-run shape — flagged
            # only under require_balanced, then forgotten so the new
            # segment's ids (restarting at 0) don't read as reopens.
            last_t = None
            if require_balanced and open_spans:
                problems.append(
                    f"{where}:{i}: {len(open_spans)} span(s) left "
                    f"open at segment boundary: {sorted(open_spans)}")
            open_spans.clear()
            if check_rid_linkage and rid_terminal_open:
                problems.append(
                    f"{where}:{i}: request span(s) for retired/shed "
                    f"rid(s) {sorted(rid_terminal_open)[:8]} never "
                    f"closed in their segment")
            req_sids.clear()
            rid_open.clear()
            rid_terminal_open.clear()
            if rec.get("schema") != "ppls-events-v1":
                problems.append(f"{where}:{i}: meta without "
                                f"schema=ppls-events-v1")
            continue
        t = rec.get("t")
        if not _is_finite_number(t):
            problems.append(f"{where}:{i}: missing/non-finite 't'")
        elif last_t is not None and t < last_t:
            problems.append(f"{where}:{i}: timestamp goes backwards "
                            f"({t} < {last_t})")
        else:
            last_t = t
        attrs = rec.get("attrs")
        if attrs is not None and not isinstance(attrs, dict):
            problems.append(f"{where}:{i}: 'attrs' must be an object")
        if ev == "span_open":
            sid = rec.get("id")
            if not isinstance(sid, int):
                problems.append(f"{where}:{i}: span_open without int "
                                f"'id'")
                continue
            parent = rec.get("parent")
            if parent is not None and parent not in open_spans:
                problems.append(f"{where}:{i}: parent {parent} is not "
                                f"an open span")
            if not isinstance(rec.get("name"), str) or not rec["name"]:
                problems.append(f"{where}:{i}: span_open without "
                                f"'name'")
            if sid in open_spans:
                problems.append(f"{where}:{i}: span id {sid} reopened")
            open_spans.add(sid)
            if check_rid_linkage and rec.get("name") == "request":
                rid = (attrs or {}).get("rid")
                if not isinstance(rid, int):
                    problems.append(f"{where}:{i}: request span "
                                    f"without int 'rid'")
                else:
                    req_sids[sid] = rid
                    rid_open.add(rid)
        elif ev == "span_close":
            sid = rec.get("id")
            if sid not in open_spans:
                problems.append(f"{where}:{i}: span_close for "
                                f"unopened id {sid!r}")
            else:
                open_spans.discard(sid)
            if check_rid_linkage and sid in req_sids:
                rid = req_sids.pop(sid)
                rid_open.discard(rid)
                rid_terminal_open.discard(rid)
        elif ev == "event":
            if not isinstance(rec.get("name"), str) or not rec["name"]:
                problems.append(f"{where}:{i}: event without 'name'")
            elif check_rid_linkage \
                    and rec["name"] in RID_TRACE_EVENTS:
                rid = (attrs or {}).get("rid")
                if not isinstance(rid, int):
                    problems.append(
                        f"{where}:{i}: trace event "
                        f"{rec['name']!r} without int 'rid'")
                elif rid not in rid_open:
                    problems.append(
                        f"{where}:{i}: orphan trace event "
                        f"{rec['name']!r} — rid {rid} has no open "
                        f"request span in this segment")
                elif rec["name"] in ("retire", "request_shed"):
                    rid_terminal_open.add(rid)
    if not found:
        problems.append(f"{where}: no event records found")
    elif require_balanced and open_spans:
        problems.append(f"{where}: {len(open_spans)} span(s) never "
                        f"closed: {sorted(open_spans)}")
    if check_rid_linkage and rid_terminal_open:
        problems.append(
            f"{where}: request span(s) for retired/shed rid(s) "
            f"{sorted(rid_terminal_open)[:8]} never closed")
    return problems


def validate_serve_output_text(text: str, *, where: str = "serve"
                               ) -> List[str]:
    """Validate a ``serve`` stdout stream: the JSONL request ledger a
    multi-tenant overload run leaves behind.

    Shape: every JSON line is a RETIRE record (``rid`` + ``area``),
    a SHED record (``shed: true`` with rid/tenant/reason — the
    explicit rejection every load-shed request must get), a REJECTION
    (``rejected: true`` with an error — malformed input lines), or
    the single SUMMARY line (``summary: true``). Accounting
    invariants, deduped by rid because a watchdog/supervisor resume
    may legitimately replay post-snapshot lines: distinct retire rids
    == ``summary.completed``; distinct shed rids == ``summary.shed``
    (when reported); no rid both retires and sheds; failed retire
    records carry ``area: null``. Returns problem strings (empty =
    clean).

    SCOPE: one ledger must cover one PROCESS LINEAGE's whole request
    set. In-process supervisor resumes are covered (their stdout
    accumulates every line). A zero-downtime RESTART (SIGTERM + new
    process) splits the ledger: the second process's summary counts
    snapshot-restored records its own stdout never printed —
    CONCATENATE the processes' outputs (minus the earlier summaries)
    before validating, as the restart tests do."""
    problems: List[str] = []
    summaries = []
    retire_rids, shed_rids = set(), set()
    failed_rids = set()
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            problems.append(f"{where}:{i}: unparseable JSON line")
            continue
        if not isinstance(rec, dict):
            problems.append(f"{where}:{i}: not a JSON object")
            continue
        if rec.get("summary"):
            summaries.append((i, rec))
        elif rec.get("shed"):
            if not isinstance(rec.get("rid"), int) \
                    or not isinstance(rec.get("tenant"), str) \
                    or not isinstance(rec.get("reason"), str):
                problems.append(f"{where}:{i}: shed record without "
                                f"rid/tenant/reason")
            else:
                shed_rids.add(rec["rid"])
        elif rec.get("rejected"):
            if not isinstance(rec.get("error"), str):
                problems.append(f"{where}:{i}: rejection record "
                                f"without 'error'")
        elif "rid" in rec and "area" in rec:
            if not isinstance(rec["rid"], int):
                problems.append(f"{where}:{i}: non-int rid")
                continue
            retire_rids.add(rec["rid"])
            if rec.get("failed"):
                failed_rids.add(rec["rid"])
                if rec["area"] is not None:
                    problems.append(
                        f"{where}:{i}: failed retire record must "
                        f"carry area null, got {rec['area']!r}")
            elif not _is_finite_number(rec.get("area")):
                problems.append(
                    f"{where}:{i}: retire record with non-finite "
                    f"area {rec.get('area')!r}")
        else:
            problems.append(f"{where}:{i}: unrecognized serve record "
                            f"shape (not retire/shed/rejected/"
                            f"summary)")
    if len(summaries) != 1:
        problems.append(f"{where}: expected exactly 1 summary line, "
                        f"found {len(summaries)}")
        return problems
    _, s = summaries[0]
    for key in ("completed", "phases", "totals", "latency"):
        if key not in s:
            problems.append(f"{where}: summary missing {key!r}")
    if isinstance(s.get("completed"), int) \
            and len(retire_rids) != s["completed"]:
        problems.append(
            f"{where}: summary.completed={s['completed']} but "
            f"{len(retire_rids)} distinct retire rids in the stream")
    if isinstance(s.get("shed"), int) \
            and len(shed_rids) != s["shed"]:
        problems.append(
            f"{where}: summary.shed={s['shed']} but "
            f"{len(shed_rids)} distinct shed rids in the stream")
    both = retire_rids & shed_rids
    if both:
        problems.append(f"{where}: rid(s) both retired and shed: "
                        f"{sorted(both)[:8]}")
    if isinstance(s.get("failed"), int) \
            and len(failed_rids) != s["failed"]:
        problems.append(
            f"{where}: summary.failed={s['failed']} but "
            f"{len(failed_rids)} distinct failed retire rids")
    return problems


def _scan_lines(text: str, where: str):
    """Scan a raw log/stdout stream for bench-record JSON lines;
    returns (problems, records_found)."""
    problems: List[str] = []
    found = 0
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            if '"metric"' in line:
                # a truncated/garbled bench record is exactly the
                # silent-drop failure mode this check exists for
                problems.append(f"{where}:{i}: unparseable bench "
                                f"record line")
            continue
        if not isinstance(obj, dict) or "metric" not in obj:
            continue                 # some other JSON block (e.g. logs)
        found += 1
        try:
            validate_record(obj, where=f"{where}:{i}")
        except ArtifactSchemaError as e:
            problems.append(str(e))
    return problems, found


def dedup_replayed(records: List[dict], key_fn) -> List[dict]:
    """Collapse replayed duplicates out of an events stream: after a
    kill-and-resume, the replayed turns re-emit their events with
    IDENTICAL content (that is the determinism contract), so each
    record collapses onto its original. First occurrence wins — file
    order is emission order, so the original precedes its replay —
    which also keeps the analyzers order-stable. Records whose key is
    None are kept verbatim (no identity to collapse on).

    One definition for every reader of a replayed ledger or
    timeline."""
    out: List[dict] = []
    seen = set()
    for r in records:
        k = key_fn(r)
        if k is None:
            out.append(r)
            continue
        if k in seen:
            continue
        seen.add(k)
        out.append(r)
    return out


def dedup_by_rid(records: List[dict]) -> List[dict]:
    """Replay dedup keyed on the request id — the common case: one
    retire/shed event per rid survives, replays collapse."""
    return dedup_replayed(records, lambda r: r.get("rid"))


def validate_graftlint_json(doc, where: str = "graftlint") -> List[str]:
    """Validate a ``python -m tools.graftlint --format json`` document:
    the machine-readable lint ledger ci.sh feeds to annotation tooling.
    One record per violation with the full line-free key, counts that
    reconcile with the record list, and an ``ok`` flag consistent with
    the new-violation count — a malformed or self-inconsistent ledger
    must fail CI loudly, exactly like a malformed bench record."""
    import re
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"{where}: document is not a JSON object"]
    if doc.get("schema") != "graftlint-v1":
        problems.append(f"{where}: schema != 'graftlint-v1' "
                        f"({doc.get('schema')!r})")
    if not isinstance(doc.get("target"), str) or not doc.get("target"):
        problems.append(f"{where}: missing/empty 'target'")
    if not isinstance(doc.get("deep"), bool):
        problems.append(f"{where}: 'deep' must be a bool")
    # "runtime" arrived with the GL12-GL14 tier; older ledgers
    # legitimately lack it, but a present field must be a bool
    if "runtime" in doc and not isinstance(doc["runtime"], bool):
        problems.append(f"{where}: 'runtime' must be a bool")
    vs = doc.get("violations")
    if not isinstance(vs, list):
        return problems + [f"{where}: 'violations' must be a list"]
    code_re = re.compile(r"^GL\d{2}$")
    n_new = n_known = 0
    for i, v in enumerate(vs):
        w = f"{where}: violations[{i}]"
        if not isinstance(v, dict):
            problems.append(f"{w}: not an object")
            continue
        for k, t in (("key", str), ("code", str), ("path", str),
                     ("symbol", str), ("message", str), ("line", int),
                     ("grandfathered", bool)):
            if not isinstance(v.get(k), t) or (t is str and not v[k]):
                problems.append(f"{w}: missing/invalid {k!r}")
        code = v.get("code")
        if isinstance(code, str) and not code_re.match(code):
            problems.append(f"{w}: code {code!r} is not GLxx")
        # "tier" is optional (newer ledgers carry it) but a
        # present value must be a known tier name
        if "tier" in v and v["tier"] not in ("ast", "deep", "runtime"):
            problems.append(f"{w}: tier {v.get('tier')!r} is not one "
                            f"of ast/deep/runtime")
        key = v.get("key")
        if isinstance(key, str) and isinstance(code, str) \
                and isinstance(v.get("path"), str) \
                and isinstance(v.get("symbol"), str) \
                and key != f"{code}:{v['path']}:{v['symbol']}":
            problems.append(f"{w}: key {key!r} != code:path:symbol")
        if v.get("grandfathered") is True:
            n_known += 1
            if not isinstance(v.get("reason"), str):
                problems.append(f"{w}: grandfathered record lacks a "
                                f"'reason'")
        elif v.get("grandfathered") is False:
            n_new += 1
    stale = doc.get("stale")
    if not isinstance(stale, list) \
            or not all(isinstance(s, str) for s in stale):
        problems.append(f"{where}: 'stale' must be a list of keys")
    counts = doc.get("counts")
    if not isinstance(counts, dict):
        problems.append(f"{where}: missing 'counts'")
    else:
        expect = {"total": n_new + n_known, "new": n_new,
                  "grandfathered": n_known,
                  "stale": len(stale) if isinstance(stale, list)
                  else counts.get("stale")}
        for k, e in expect.items():
            if counts.get(k) != e:
                problems.append(
                    f"{where}: counts.{k}={counts.get(k)!r} does not "
                    f"reconcile with the record list ({e})")
    if isinstance(doc.get("ok"), bool) and doc["ok"] != (n_new == 0):
        problems.append(f"{where}: ok={doc['ok']} but {n_new} new "
                        f"violation record(s)")
    elif not isinstance(doc.get("ok"), bool):
        problems.append(f"{where}: 'ok' must be a bool")
    return problems


def validate_graftlint_text(text: str,
                            where: str = "graftlint") -> List[str]:
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        return [f"{where}: unparseable JSON: {e}"]
    return validate_graftlint_json(doc, where=where)


def validate_tuning_table_json(doc, where: str = "tuning") -> List[str]:
    """Validate a tuning-table document (``tools/tune_table.py``'s
    output, or the committed table): the knob store the cadence
    resolution reads. Each entry must carry its full signature (the key
    string must round-trip from it), the tuned knob values, baseline and
    tuned quick proxies, and the sweep's provenance (trial count,
    recompile count, reconciliation status, seed, budget): a table whose
    provenance is missing cannot be audited. Returns the problems found,
    in the JAX package's wording; an empty list means valid."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"{where}: document is not a JSON object"]
    if doc.get("schema") != "ppls-tuning-table-v1":
        problems.append(f"{where}: schema != 'ppls-tuning-table-v1' "
                        f"({doc.get('schema')!r})")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        return problems + [f"{where}: 'entries' must be an object"]
    sig_fields = ("family", "eps_band", "rule", "theta_band",
                  "mesh_shape", "mode")
    for key in sorted(entries):
        e = entries[key]
        w = f"{where}: entries[{key!r}]"
        if not isinstance(e, dict):
            problems.append(f"{w}: not an object")
            continue
        if e.get("schema") != "ppls-tuning-entry-v1":
            problems.append(f"{w}: entry schema != "
                            f"'ppls-tuning-entry-v1'")
        sig = e.get("signature")
        if not isinstance(sig, dict):
            problems.append(f"{w}: missing 'signature'")
        else:
            for k in sig_fields:
                if k not in sig:
                    problems.append(f"{w}: signature lacks {k!r}")
            dev = e.get("device_kind")
            if not isinstance(dev, str) or not dev:
                problems.append(f"{w}: missing 'device_kind'")
            elif all(k in sig for k in sig_fields):
                expect = "|".join(
                    [f"{k}={sig[k]}" for k in sig_fields]
                    + [f"device={dev}"])
                if key != expect:
                    problems.append(f"{w}: key does not round-trip "
                                    f"from its signature ({expect!r})")
        knobs = e.get("knobs")
        if not isinstance(knobs, dict) or not knobs:
            problems.append(f"{w}: missing 'knobs'")
        for blk in ("baseline", "tuned"):
            b = e.get(blk)
            if not isinstance(b, dict):
                problems.append(f"{w}: missing {blk!r} proxies")
                continue
            for k in ("tasks", "kernel_steps", "lane_efficiency"):
                v = b.get(k)
                if not isinstance(v, (int, float)) \
                        or isinstance(v, bool) or v < 0:
                    problems.append(f"{w}: {blk}.{k} missing or "
                                    f"non-numeric")
        prov = e.get("provenance")
        if not isinstance(prov, dict):
            problems.append(f"{w}: missing 'provenance'")
            continue
        for k, t in (("trials", int), ("recompiles", int),
                     ("reconciles", bool), ("seed", int),
                     ("budget", int), ("improved", bool)):
            if not isinstance(prov.get(k), t) \
                    or (t is int and isinstance(prov.get(k), bool)):
                problems.append(f"{w}: provenance.{k} missing/invalid")
        if isinstance(prov.get("trials"), int) \
                and not isinstance(prov.get("trials"), bool) \
                and prov["trials"] < 1:
            problems.append(f"{w}: provenance.trials < 1")
        path = prov.get("path")
        if not isinstance(path, list):
            problems.append(f"{w}: provenance.path must be a list")
        elif isinstance(prov.get("trials"), int) \
                and not isinstance(prov.get("trials"), bool) \
                and len(path) != prov["trials"] - 1:
            problems.append(
                f"{w}: provenance.path has {len(path)} move(s) but "
                f"trials={prov['trials']} (expected trials - 1)")
    return problems


def validate_tuning_table_text(text: str,
                               where: str = "tuning") -> List[str]:
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        return [f"{where}: unparseable JSON: {e}"]
    return validate_tuning_table_json(doc, where=where)
