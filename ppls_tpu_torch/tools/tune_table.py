"""Run the offline tuning search and write its entries into a tuning table:

    python ppls_tpu_torch/tools/tune_table.py --out PATH [--quick]
        [--budget N] [--families a,b] [--device cuda|cpu]

The counterpart of the JAX package's ``bench.py tune``. It sweeps the
tune workloads (``runtime/tune.py`` ``TUNE_WORKLOADS``: every one, or
those ``--families`` names) with ``tune_workload`` on ``--device`` (CUDA
by default; ``--device cpu`` runs the walker's plain segments), at
``--budget`` trials a workload (16; ``--quick``: 5). Each entry is
merged into the table at ``--out`` (created if missing; the entries of
other keys stay). The committed ``tools/tuning_table.json`` belongs to
the JAX package, so ``--out`` is required and may not name it.

After writing, every swept workload must resolve its cadence through
the written file on the run device with the tier ``exact``, and the file
must pass ``utils/artifact_schema.validate_tuning_table_json``; either
failure exits 1. It prints one JSON record (the reference's: metric,
value, unit, vs_baseline, and per family the baseline and tuned proxies,
knobs, key and ``tier_after``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_sweep(out: str, budget: int, families=None, device="cuda") -> dict:
    """Sweep, merge into ``out``, write it, check it; returns the record.
    Raises ``ValueError`` for the reference's table or an empty
    selection, and ``RuntimeError`` when the written file fails its
    checks."""
    import numpy as np

    from ppls_tpu_torch.runtime import tune
    from ppls_tpu_torch.utils.artifact_schema import (
        validate_tuning_table_json)

    if os.path.realpath(out) == os.path.realpath(tune.DEFAULT_TABLE_PATH):
        raise ValueError(f"{out} is the JAX package's committed tuning "
                         f"table; write the port's sweep elsewhere")
    workloads = [w for w in tune.TUNE_WORKLOADS
                 if families is None or w[0] in families]
    if not workloads:
        raise ValueError(f"no tune workloads selected from {families!r}")
    table = tune.load_tuning_table(out)       # merge into an existing file
    fams, gains, improved = {}, [], 0
    for fam, eps, bounds in workloads:
        entry = tune.tune_workload(fam, eps, bounds, budget=budget,
                                   device=device)
        table = tune.update_table(table, entry)
        prov = entry["provenance"]
        improved += bool(prov["improved"])
        gains.append(entry["tuned"]["lane_efficiency"]
                     - entry["baseline"]["lane_efficiency"])
        fams[fam] = {
            "eps": float(eps),
            "improved": bool(prov["improved"]),
            "trials": int(prov["trials"]),
            "recompiles": int(prov["recompiles"]),
            "baseline": entry["baseline"],
            "tuned": entry["tuned"],
            "knobs": entry["knobs"],
            "key": tune.entry_key(entry),
        }
    tune.write_table(out, table)
    # the post-write check: every swept workload resolves through its own
    # entry; another tier means the table's round trip is broken
    sizing = tune.TUNE_SIZING
    bad = []
    for fam, eps, _bounds in workloads:
        sig = tune.workload_signature(
            fam, eps, "trapezoid", theta_block=1, mesh_shape=1,
            scout=sizing["scout_dtype"] == "f32",
            refill_slots=sizing["refill_slots"])
        _, _, tier = tune.resolve_cadence_tuned(
            None, None, True, sizing["refill_slots"], signature=sig,
            path=out, device=device)
        fams[fam]["tier_after"] = tier
        if tier != "exact":
            bad.append(f"{fam} resolves {tier!r}")
    with open(out, encoding="utf-8") as fh:
        bad += validate_tuning_table_json(json.load(fh), where=out)
    if bad:
        raise RuntimeError(f"the written table fails its checks: {bad}")
    return {
        "metric": "closed-loop autotuning: staged sweep on the quick "
                  "proxies",
        "value": float(improved),
        "unit": "families where tuned Pareto-beats the hand default "
                "(lane_efficiency + kernel_steps, device-counted)",
        "vs_baseline": float(np.mean(gains)) if gains else 0.0,
        "device": tune.device_kind(device),
        "tuning": {"budget": int(budget), "table": str(out),
                   "written": True, "families": fams},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True,
                   help="the table to write (merged into if it exists)")
    p.add_argument("--quick", action="store_true", help="budget 5")
    p.add_argument("--budget", type=int, default=None,
                   help="trials per workload (default 16)")
    p.add_argument("--families", default=None,
                   help="comma-separated tune workloads (default: all)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    budget = args.budget or (5 if args.quick else 16)
    families = args.families.split(",") if args.families else None
    try:
        rec = run_sweep(args.out, budget, families, args.device)
    except (ValueError, RuntimeError) as e:
        print(f"tune_table: {e}", file=sys.stderr)
        return 1
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
