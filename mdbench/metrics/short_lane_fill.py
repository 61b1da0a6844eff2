"""short_lane_fill (%): the share of the short lists' slots (rows x Ks,
the program's nbr.short_slots) that hold a partner within the short list's
radius (nbr.short_lanes), over the compactions of stages.py's stretch with
spans on and no profiler."""
from mdbench import stages


def read(ctx):
    r = stages.readings(ctx)
    if r is None or not r.counts.get("nbr.short_slots"):
        return None
    return 100.0 * r.counts.get("nbr.short_lanes", 0) \
        / r.counts["nbr.short_slots"]
