"""Subintervals (tasks) completed per second over the window: every
call's tasks over the window's length."""


def read(rec):
    calls = rec.get("calls")
    if not calls:
        return None
    return sum(c["tasks"] for c in calls) / rec["window_s"]
