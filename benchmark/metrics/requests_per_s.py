"""Requests retired per second over the window: every request the stream
retired between the window's first phase and its last, over the window's
length."""


def read(rec):
    if "requests" not in rec:
        return None
    return len(rec["requests"]) / rec["window_s"]
