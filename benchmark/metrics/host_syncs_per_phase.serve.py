"""Device reads by the stream engine's host loop per phase of the window:
``StreamResult.host_syncs_per_phase``, mean over the window's phases."""


def read(rec):
    syncs = rec.get("phase_syncs")
    if not syncs:
        return None
    return sum(syncs) / len(syncs)
