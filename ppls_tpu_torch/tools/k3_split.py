"""Split K3's step into its parts on the card, and read what the compiler
made of it:

    python ppls_tpu_torch/tools/k3_split.py [--launches 11] [--out FILE]

It builds ``tools/k3_split.cu`` (variants of K3's step loop on the
flagship's body, sin(theta / x); see that file) with the kernels' own
nvcc flags, and K3 itself (``csrc/walk_seg.cu``), then

- prints ptxas's registers and spills of every variant and of K3;
- reads ``cuobjdump -sass`` of both libraries: per kernel, the
  instructions of its step loop (the body of its widest backward
  branch) by opcode, the IEEE divisions in it (``MUFU.RCP`` ... ``FCHK``)
  and the dependent depth of one division's fast path, traced through
  its registers (the operations ``chip_smoke.py`` counts a division as);
- times, on the flagship's seeded lanes (``tools/time_k1.py``'s
  ``k3_step`` lanes: 16384 lanes, one root each off the queue top) and
  their Simpson twins, 256-step launches of every variant and of K3
  (``run_segment``), ``--launches`` each after a warm-up, in alternation,
  by CUDA events around each launch's device work after a ~2 ms spin
  (``time_k1.kernel_times``), with ``nvidia-smi --query-gpu=clocks.sm,
  power.draw,power.limit`` sampled beside them;
- holds the state after 256 steps of the pipelined variants and of K3
  bit-equal to the plain variant's;
- times K3 at 16384, 32768 and 65536 of the flagship's seeded lanes
  (one, two and four warps per SM scheduler): us per step and lane-steps
  per second.

It prints one JSON line (and writes it to ``--out``): per step machine
and variant the median ms and us per step. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
VARIANTS = ("plain", "ahead", "eval1", "eval2", "noeval", "both", "first")
STEPS = 256
SMI_QUERY = "clocks.sm,power.draw,power.limit"
LANE_COUNTS = (1 << 14, 1 << 15, 1 << 16)    # 1, 2, 4 warps per scheduler


def build():
    """(the variants' library, K3's library), built at first use."""
    from pathlib import Path
    from ppls_tpu_torch.utils import cuda_build as CB
    nvcc = CB.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    lib = CB.build_library("k3_split", nvcc, CB.NVCC_FLAGS,
                           [Path(HERE) / "k3_split.cu"], CB.DEVICE_HEADERS,
                           CB.BUILD_DIR)
    lib.lib.k3_variant_launch.argtypes = [ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib, CB.load_walk_seg()


def ptxas_lines(log: str) -> list:
    """(entry, registers, spill stores, spill loads) per kernel of an
    nvcc -Xptxas -v log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spills = m.group(1), (None, None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1)), *spills))
            entry = None
    return out


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                       r"\s*([^;]*);")


def sass_functions(path: str, tool: str) -> dict:
    """{function name: [(address, opcode, operands), ...]} from
    ``cuobjdump -sass``."""
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = SASS_LINE.search(line)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(3),
                                m.group(4).strip()))
    return funcs


def _regs(operands: str) -> list:
    return re.findall(r"\bR(\d+)\b", operands)


def division_depth(body: list, at: int) -> tuple:
    """The dependent depth of the division fast path that starts at
    ``body[at]`` (its MUFU.RCP), up to its FCHK's branch: each
    instruction one deeper than the deepest in-window instruction that
    wrote one of its source registers. Returns (depth, instructions)."""
    depth, writer, window = 0, {}, []
    for addr, op, operands in body[at:]:
        window.append(f"{op} {operands}")
        regs = _regs(operands)
        if op.startswith("BRA") or op.startswith("CALL"):
            break
        dst, srcs = (regs[0], regs[1:]) if regs else (None, [])
        if op.startswith("FCHK") or op.startswith("FSETP"):
            dst, srcs = None, regs
        d = 1 + max([writer.get(r, 0) for r in srcs] + [0])
        if dst is not None:
            writer[dst] = d
        depth = max(depth, d)
    return depth, window


def step_loop(code: list) -> dict:
    """The kernel's step loop: the body of its widest backward branch,
    its instructions by opcode (the predicate-guarded ones too), and its
    divisions."""
    best = None
    for j, (addr, op, operands) in enumerate(code):
        m = re.match(r"(0x)?([0-9a-f]+)", operands)
        if op.startswith("BRA") and m:
            target = int(m.group(2), 16)
            if target < addr and (best is None or addr - target > best[1]):
                best = (j, addr - target, target)
    if best is None:
        return {"loop_instructions": 0}
    j, _, target = best
    body = [c for c in code[:j + 1] if c[0] >= target]
    ops = collections.Counter(op.split(".")[0] for _, op, _ in body)
    rcp = [k for k, c in enumerate(body) if c[1].startswith("MUFU.RCP")]
    out = dict(loop_instructions=len(body),
               by_opcode=dict(ops.most_common()),
               divisions=len(rcp),
               fchk=sum(1 for _, op, _ in body if op.startswith("FCHK")),
               calls=sum(1 for _, op, _ in body if op.startswith("CALL")))
    if rcp:
        out["division_depth"], out["division_sequence"] = \
            division_depth(body, rcp[0])
    return out


def sass_report(paths: dict) -> dict:
    from ppls_tpu_torch.utils.cuda_build import find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    out = {}
    for lib_name, path in paths.items():
        for fn, code in sass_functions(str(path), tool).items():
            if "kernel" not in fn:
                continue
            rec = step_loop(code)
            rec["function_instructions"] = len(code)
            out[f"{lib_name}:{fn}"] = rec
    return out


class SmiSampler:
    """``nvidia-smi --query-gpu=SMI_QUERY`` read every ``period`` s on a
    thread while the block runs."""

    def __init__(self, period: float = 0.25):
        self.period, self.rows = period, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, check=False).stdout.strip().splitlines()
            except OSError:                      # no nvidia-smi here
                return
            try:
                self.rows.append([float(v) for v in out[0].split(",")])
            except (IndexError, ValueError):     # no reading this time
                pass
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def summary(self) -> dict:
        import numpy as np
        if not self.rows:
            return {}
        a = np.array(self.rows)
        return {k: dict(min=float(a[:, j].min()),
                        median=float(np.median(a[:, j])),
                        max=float(a[:, j].max()))
                for j, k in enumerate(SMI_QUERY.split(","))} | {
                    "samples": len(self.rows)}


def seeded(rule, lanes: int = 1 << 14):
    import numpy as np
    from ppls_tpu_torch.models.integrands import get_family
    from ppls_tpu_torch.parallel import walker as W
    from ppls_tpu_torch.tools.time_k1 import body_bank
    theta, bounds, eps, eps_simpson = body_bank("sin_recip_scaled")
    eps = eps_simpson if rule.name == "SIMPSON" else eps
    base = W.first_phase_inputs(
        get_family("sin_recip_scaled"), np.asarray(theta), bounds, eps,
        lanes=lanes, roots_per_lane=12, refill_slots=0, capacity=1 << 23,
        scout=False, rule=rule, device="cuda")
    return base["state"], eps


def lane_sweep(rule, lane_counts, launches: int) -> dict:
    """K3 (run_segment) at each lane count of the flagship's seeded
    lanes: 16384 lanes are one warp per SM scheduler (128 blocks of 128
    threads), twice and four times as many are two and four. Per lane
    count the median ms of a 256-step launch, us per step and lane-steps
    per second."""
    import numpy as np
    from ppls_tpu_torch.models.integrands import get_family_ds
    from ppls_tpu_torch.parallel import walker as W
    from ppls_tpu_torch.tools.time_k1 import kernel_times
    f_ds = get_family_ds("sin_recip_scaled")
    out = {}
    for lanes in lane_counts:
        state, eps = seeded(rule, lanes)

        def prepare():
            st = W.WalkState(*(t.clone() for t in state))
            return lambda: W.run_segment(st, STEPS, f_ds=f_ds, eps=eps,
                                         rule=rule)
        _, ms = kernel_times([prepare() for _ in range(launches + 1)])
        med = float(np.median(ms[1:]))
        out[str(lanes)] = dict(ms=med, us_per_step=1e3 * med / STEPS,
                               lane_steps_per_s=lanes * STEPS / med * 1e3,
                               live_lanes=int(((state.flags & W._PARKED)
                                               == 0).sum()), runs=ms[1:])
    return out


def time_mode(lib, rule, launches: int) -> dict:
    import numpy as np
    import torch
    from ppls_tpu_torch.models.integrands import get_family_ds
    from ppls_tpu_torch.ops.ds_kernel import f32
    from ppls_tpu_torch.parallel import walker as W
    from ppls_tpu_torch.tools.time_k1 import kernel_times
    f_ds = get_family_ds("sin_recip_scaled")
    state, eps = seeded(rule)
    mode = W.step_mode(rule, False)
    lanes = state.a_h.shape[0]

    def prepare(variant):
        st = W.WalkState(*(t.clone() for t in state))
        if variant == "k3":
            return st, lambda: W.run_segment(st, STEPS, f_ds=f_ds, eps=eps,
                                             rule=rule)
        ptrs = W._pointer_table(st, st.a_h.device)
        v = VARIANTS.index(variant)

        def launch():
            W._launch("k3_split", st.a_h.device, lambda stream:
                      lib.k3_variant_launch(ptrs.data_ptr(), lanes, mode, v,
                                            f32(eps), STEPS, stream))
        return st, launch

    names = (*VARIANTS, "k3")
    order = [n for j in range(launches + 1)
             for n in (names if j % 2 == 0 else names[::-1])]
    preps = [prepare(n) for n in order]
    with SmiSampler() as smi:
        _, ms = kernel_times([launch for _, launch in preps])
    last = {n: st for n, (st, _) in zip(order, preps)}
    for other in ("ahead", "both", "first", "k3"):
        for name, a, b in zip(W.WalkState._fields, last["plain"],
                              last[other]):
            if not torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b):
                raise AssertionError(f"{rule.name}: {other} differs from "
                                     f"the plain step in {name}")
    out = {}
    for n in names:
        t = [m for j, (o, m) in enumerate(zip(order, ms))
             if o == n and j >= len(names)]
        med = float(np.median(t))
        out[n] = dict(ms=med, us_per_step=1e3 * med / STEPS, runs=t)
    out["live_lanes"] = int(((state.flags & W._PARKED) == 0).sum())
    out["smi"] = smi.summary()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=11)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("k3_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from ppls_tpu_torch.config import Rule
    t0 = time.perf_counter()
    split, seg = build()
    rep = {"device": torch.cuda.get_device_name(0),
           "build_s": time.perf_counter() - t0,
           "ptxas": {"k3_split": ptxas_lines(split.log),
                     "walk_seg": ptxas_lines(seg.log)},
           "sass": sass_report({"k3_split": split.path,
                                "walk_seg": seg.path})}
    for rule in (Rule.TRAPEZOID, Rule.SIMPSON):
        rep[rule.name.lower()] = time_mode(split.lib, rule, args.launches)
    rep["lanes"] = lane_sweep(Rule.TRAPEZOID, LANE_COUNTS, args.launches)
    rep["smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    for entry, regs, st, ld in rep["ptxas"]["k3_split"] + \
            rep["ptxas"]["walk_seg"]:
        print(f"[k3_split] ptxas {entry}: {regs} registers, spill "
              f"stores {st} B, loads {ld} B")
    for fn, rec in rep["sass"].items():
        print(f"[k3_split] sass {fn}: loop {rec.get('loop_instructions')} "
              f"instructions, divisions {rec.get('divisions')} (depth "
              f"{rec.get('division_depth')}), calls {rec.get('calls')}, "
              f"function {rec['function_instructions']}")
    for mode in ("trapezoid", "simpson"):
        r = rep[mode]
        print(f"[k3_split] {mode}: " + ", ".join(
            f"{n} {r[n]['us_per_step']:.4f} us/step" for n in
            (*VARIANTS, "k3")) + f"; {r['live_lanes']} live lanes; smi "
            f"{r['smi']}")
    for lanes, r in rep["lanes"].items():
        print(f"[k3_split] K3 trapezoid at {lanes} lanes: "
              f"{r['us_per_step']:.4f} us/step, "
              f"{r['lane_steps_per_s'] / 1e9:.3f} G lane-steps/s, "
              f"{r['live_lanes']} live")
    print(rep["smi"])
    line = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
