"""Walker tasks per kernel lane-step over the window's calls (one card):
``WalkerResult.lane_efficiency`` weighted by each call's lane-steps."""


def read(rec):
    calls = rec.get("calls")
    if not calls:
        return None
    steps = sum(c["kernel_steps"] * c["lanes"] for c in calls)
    if not steps:
        return None
    return sum(c["lane_efficiency"] * c["kernel_steps"] * c["lanes"]
               for c in calls) / steps
