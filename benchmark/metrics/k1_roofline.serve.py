"""K1's (theta variant's) share of its roofline in the served phases:
every live lane-step of the theta groups in the window (the stream's
device counters), at the H100's peaks, over K1's device time there."""

import roofline


def read(rec):
    tot, trace = rec.get("totals"), rec.get("trace")
    if not tot or not trace or "requests" not in rec:
        return None
    least = roofline.k1_least_seconds(
        rec["roofline"], rec["cfg"]["family"],
        live_steps=tot["eval_active"], scout_evals=tot["scout_evals"],
        confirm_evals=tot["confirm_evals"], launches=tot["segs"],
        lanes=rec["lanes"],
        refill_slots=rec["cfg"]["stream"]["refill_slots"])
    return roofline.share_pct(
        least, roofline.kernel_seconds(trace, "walk_rf_kernel"))
