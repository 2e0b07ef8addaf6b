"""The serving forward's share of the card's peak over the measured window:
the forward's operations per window (``counters.forward_flops``, from
shapes) times the windows of the recordings finished, over the window's
time and the compute dtype's peak (bf16 989 TFLOP/s; f32 against TF32's
495, the ceiling of the 3xTF32 products)."""

from portbench import counters

LAYER = "serving forward"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "audio_s_per_s"


def read(ctx):
    c, config = ctx["counters"], ctx["config"]
    if not c["windows"] or c["window_s"] <= 0:
        return None
    samples = round(config["data"]["window_s"] * config["data"]["sample_rate"])
    flops = counters.forward_flops(config["model"], samples) * c["windows"]
    peak = counters.PEAK_FLOPS[config["precision"]["compute_dtype"]]
    return 100.0 * flops / c["window_s"] / peak
