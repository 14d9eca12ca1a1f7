"""Device reads by the host loop per batch call (one card): the cycle
loop's round trips, ``WalkerResult.host_syncs``, mean over the calls."""


def read(rec):
    calls = rec.get("calls")
    if not calls:
        return None
    return sum(c["host_syncs"] for c in calls) / len(calls)
