"""The benchmark of ``ppls_tpu_torch``, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell ``NAME`` of ``BENCHMARK.json``
names a configuration and a traffic mix; the run loads, warms up the
cell's shapes, measures for ``S`` seconds, checks the window's answers
against the plain reference, and prints one JSON line last: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics from a
profiled window (``--trace 1``). It exits non-zero and prints no result
without enough CUDA cards, when JAX or the JAX package was loaded, or
when the program raised (as it does where the port is absent).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402 -- the clock starts before any import
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ppls_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``ppls_tpu_torch`` is not ``ppls_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    if ROOT not in sys.path:
        sys.path.append(ROOT)
    import harness

    try:
        manifest = harness.load_manifest()
        cell = harness.find(manifest["workloads"], args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"no cell {args.workload!r} in BENCHMARK.json: {e!r}",
              file=sys.stderr)
        return 2
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"cell {args.workload} needs {cell['chips']} CUDA card(s), "
              f"found {have}", file=sys.stderr)
        return 3
    out = harness.run_cell(manifest, args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 4
    if "run_error" in out["check"]:
        print(f"the run raised: {out['check']['run_error']['value']}",
              file=sys.stderr)
        return 5
    for name, n in out["check"].items():
        print(f"check {name}: {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
