"""The yardstick of the kernels' rooflines: frozen operation counts per
eval and bytes per launch (``roofline.json``), and the H100's published
peaks. A roofline share is the least time the chip could take for the
work the device counters report, over the kernel's profiled time."""

from __future__ import annotations

import json
import os
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def load() -> dict:
    with open(os.path.join(HERE, "roofline.json")) as fh:
        return json.load(fh)


def k1_least_seconds(data: dict, family: str, *, live_steps: int,
                     scout_evals: int, confirm_evals: int, launches: int,
                     lanes: int, refill_slots: int) -> float:
    """Least time of K1's work: its float32 operations at the float32
    peak or its bytes at HBM bandwidth, whichever is larger. A scouting
    run (``scout_evals`` > 0) counts scout and confirm evals apart; a
    plain run evaluates once per live lane-step."""
    ops = data["ops_per_eval"][family]
    if scout_evals:
        n_ops = (scout_evals * ops["scout_eval"]
                 + confirm_evals * ops["ds_eval"]
                 + live_steps * ops["step_overhead"])
    else:
        n_ops = live_steps * (ops["ds_eval"] + ops["step_overhead"])
    b = data["k1_bytes"]
    n_bytes = launches * (lanes * (b["lane_in"] + b["lane_out"])
                          + lanes * refill_slots * (b["bank_in_per_slot"]
                                                    + b["bank_out_per_slot"])
                          + b["fixed_out"])
    peaks = data["peaks"]
    return max(n_ops / peaks["f32_ops_per_s"], n_bytes / peaks["bytes_per_s"])


def share_pct(least_s: float, kernel_s: float) -> Optional[float]:
    """The least time as a percentage of the kernel's time; None when the
    trace holds no time for the kernel."""
    if not kernel_s or kernel_s <= 0 or not least_s:
        return None
    return 100.0 * least_s / kernel_s


def kernel_seconds(trace: Optional[dict], marker: str) -> float:
    """Device seconds of the kernels whose name holds ``marker``."""
    if not trace:
        return 0.0
    return sum(s for name, s in trace["kernel_s"].items() if marker in name)
