"""K1's share of its roofline in the batch calls (one card): the least
time of the live lane-steps' float32 operations (or of the launches'
bytes) at the H100's peaks, over K1's device time in the traced window."""

import roofline


def read(rec):
    calls, trace = rec.get("calls"), rec.get("trace")
    if not calls or not trace:
        return None
    least = sum(roofline.k1_least_seconds(
        rec["roofline"], rec["cfg"]["family"], live_steps=c["eval_active"],
        scout_evals=c["scout_evals"], confirm_evals=c["confirm_evals"],
        launches=c["launches"], lanes=c["lanes"],
        refill_slots=rec["cfg"]["batch"]["refill_slots"]) for c in calls)
    return roofline.share_pct(
        least, roofline.kernel_seconds(trace, "walk_rf_kernel"))
