"""Share of the traced window in which nothing ran on the device
(``torch.profiler``: kernels, copies and sets merged)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "audio_s_per_s"


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
