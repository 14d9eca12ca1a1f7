"""Time phases of the ``chip_smoke.py`` of one checkout, alone, on the
card: 21 (the walker-dd stream), 22 (the pool dispatcher) and, where
the checkout has them, 24 (the diagnosis tools) and 25 (the ds library,
exact segment sums on demand, the workers' distributed bootstrap):

    python3 ppls_tpu_torch/tools/time_smoke_phases.py ROOT [PHASE ...]

It imports ROOT's ``chip_smoke.py`` and package, builds ROOT's kernels,
runs the phases (21 and 22 by default) as ``chip_smoke.main`` does
(phase 22's comparator stubbed: its single-engine wall only scales a
printed ratio; phase 24's comparators, phases 4 and 6's walks and phase
14a's serve command, run before its clock starts), and prints one line
``P2122 {json}``: per phase its seconds and the mesh worlds it built
(those that spawned ranks, and those of one rank). To compare two
checkouts on one card, run it once per root in one call, in the order
parent, change, change, parent (PERF.md). Needs an NVIDIA GPU."""
import json
import os
import shutil
import sys
import tempfile
import time


def main():
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import chip_smoke as C
    from ppls_tpu_torch.models.integrands import get_family_ds
    from ppls_tpu_torch.parallel import mesh as MESH
    from ppls_tpu_torch.parallel import walker as W
    from ppls_tpu_torch.runtime import stream as TS
    from ppls_tpu_torch.utils.cuda_build import load_all_kernels
    assert C.__file__.startswith(root), C.__file__
    load_all_kernels()
    ops = C.operation_counts(get_family_ds("sin_recip_scaled"))
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    counts = {"spawned": 0, "single": 0}
    init = MESH.World.__init__

    def counting(w, n, *a, **k):
        counts["spawned" if int(n) > 1 else "single"] += 1
        init(w, n, *a, **k)
    MESH.World.__init__ = counting
    res = {"root": os.path.basename(root)}
    phases = {"21": lambda d: C.phase_dd_stream(W, TS, d, out_dir, ops),
              "22": lambda d: C.phase_dispatch(
                  W, TS, d, out_dir, ops, {"ds_walk": {"wall_s": 1.0}})}
    if hasattr(C, "phase_tools"):
        phases["24"] = lambda d: C.phase_tools(W, TS, d, out_dir, *tools_in)
    if hasattr(C, "phase_surface"):
        phases["25"] = lambda d: C.phase_surface(W)
    chosen = sys.argv[2:] or ["21", "22"]
    for ph in chosen:
        fn = phases[ph]
        before = dict(counts)
        d = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=root)
        if ph == "24":
            import numpy as np
            from ppls_tpu_torch.models.integrands import get_family
            f = "sin_recip_scaled"
            tools_in = (C.tools_base(W, get_family(f), get_family_ds(f),
                                     1.0 + np.arange(C.M) / C.M),
                        C.tools_serve_artifacts(W, TS, d))
        t0 = time.perf_counter()
        try:
            fn(d)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        res[ph] = dict(seconds=time.perf_counter() - t0,
                       worlds={k: counts[k] - before[k] for k in counts})
    print("P2122 " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
