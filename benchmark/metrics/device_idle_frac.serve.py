"""The card's idle share in the served phases' traced window (the closed
loop): 1 - the union of every device activity over the window."""


def read(rec):
    trace = rec.get("trace")
    if "requests" not in rec or not trace or not trace["window_s"]:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
