"""Share of the measured window that the host spent in Python's garbage
collector, read through ``gc.callbacks``.  Set-up's objects are frozen
(``gc.freeze``) before the window, so a pause is the window's own
garbage."""

LAYER = "host runtime"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "audio_s_per_s"


def read(ctx):
    c = ctx["counters"]
    if not c.get("gc_pauses") or c["window_s"] <= 0:
        return None
    return 100.0 * c["gc_s"] / c["window_s"]
