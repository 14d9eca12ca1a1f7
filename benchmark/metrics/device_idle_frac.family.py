"""The card's idle share in the batch calls' traced window (one card):
1 - the union of every device activity over the window."""


def read(rec):
    trace = rec.get("trace")
    if not rec.get("calls") or not trace or not trace["window_s"]:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
