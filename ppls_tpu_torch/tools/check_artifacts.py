"""Validate the repo's artifact documents against their schemas
(``ppls_tpu_torch/utils/artifact_schema.py``), so that a malformed record
fails loudly instead of dropping silently out of a trajectory:

    python ppls_tpu_torch/tools/check_artifacts.py [FILE ...]
        # bench artifacts; default: the repo root's BENCH_r*.json and
        # MULTICHIP_r*.json
    some-bench | python ppls_tpu_torch/tools/check_artifacts.py -
        # bench records on stdin
    python ppls_tpu_torch/tools/check_artifacts.py --events EVENTS.jsonl
        # a `serve --events` timeline (--unbalanced-ok tolerates the
        # unclosed spans a killed run leaves; --rid-linkage also holds
        # the request-trace contract: every rid-bearing trace event linked
        # to an open request span, terminal events closing it)
    python ppls_tpu_torch/tools/check_artifacts.py --serve SERVE.jsonl
        # a `serve` stdout ledger: every line a retire, shed, rejection
        # or summary record, the rid-deduped accounting consistent
    python ppls_tpu_torch/tools/check_artifacts.py --graftlint LINT.json
        # a graftlint `--format json` ledger (counts reconcile,
        # grandfathered records carry reasons)
    python ppls_tpu_torch/tools/check_artifacts.py --tuning TABLE.json
        # a tuning table (keys round-trip from their signatures; knobs,
        # proxies and sweep provenance present)

The flags, messages and exit codes are those of the JAX package's
``tools/check_artifacts.py``: 0 when every file is clean, 1 when any
problem was found (each printed to stderr), 2 when a flag lacks its
FILE. It reads files only and touches no device.
"""

from __future__ import annotations

import glob
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _take(args: list, flag: str):
    """Remove every ``flag FILE`` pair from ``args``; the FILEs, or None
    when a flag has no FILE after it."""
    paths = []
    while flag in args:
        i = args.index(flag)
        if i + 1 >= len(args):
            return None
        paths.append(args[i + 1])
        del args[i:i + 2]
    return paths


def main(argv=None) -> int:
    """``argv`` without the program name (``sys.argv[1:]`` by default)."""
    sys.path.insert(0, ROOT)
    from ppls_tpu_torch.utils.artifact_schema import (
        validate_artifact_text, validate_events_text,
        validate_graftlint_text, validate_serve_output_text,
        validate_tuning_table_text)

    args = list(sys.argv[1:] if argv is None else argv)
    balanced = "--unbalanced-ok" not in args
    if not balanced:
        args.remove("--unbalanced-ok")
    rid_linkage = "--rid-linkage" in args
    if rid_linkage:
        args.remove("--rid-linkage")
    taken = {}
    for flag in ("--events", "--serve", "--graftlint", "--tuning"):
        taken[flag] = _take(args, flag)
        if taken[flag] is None:
            print(f"check_artifacts: {flag} requires a FILE",
                  file=sys.stderr)
            return 2
    paths = args
    problems = []

    def read(p):
        with open(p) as fh:
            return fh.read()

    for p in taken["--events"]:
        problems += validate_events_text(
            read(p), where=os.path.basename(p), require_balanced=balanced,
            check_rid_linkage=rid_linkage)
    for p in taken["--serve"]:
        problems += validate_serve_output_text(read(p),
                                               where=os.path.basename(p))
    for p in taken["--graftlint"]:
        problems += validate_graftlint_text(read(p),
                                            where=os.path.basename(p))
    for p in taken["--tuning"]:
        problems += validate_tuning_table_text(read(p),
                                               where=os.path.basename(p))
    docs = sum(taken.values(), [])
    if docs and not paths:
        for msg in problems:
            print(f"check_artifacts: {msg}", file=sys.stderr)
        print(f"check_artifacts: {len(docs)} event log(s), "
              f"{len(problems)} problem(s)")
        return 1 if problems else 0
    if not paths:
        paths = sorted(glob.glob(os.path.join(ROOT, "BENCH_r*.json"))
                       + glob.glob(os.path.join(ROOT, "MULTICHIP_r*.json")))
        if not paths:
            print("check_artifacts: no artifact files found", flush=True)
            return 0
    for p in paths:
        if p == "-":
            problems += validate_artifact_text(sys.stdin.read(),
                                               where="<stdin>")
            continue
        base = os.path.basename(p)
        # a MULTICHIP dry-run log carries no bench records legitimately
        problems += validate_artifact_text(
            read(p), where=base, require_records=base.startswith("BENCH"))
    for msg in problems:
        print(f"check_artifacts: {msg}", file=sys.stderr)
    print(f"check_artifacts: {len(paths) + len(docs)} file(s), "
          f"{len(problems)} problem(s)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
