"""The training step's share of the card's peak over the measured window:
forward and backward operations per window (``counters.train_flops``, from
shapes) times the windows trained in whole steps, over the window's time and
the compute dtype's peak (bf16 989 TFLOP/s)."""

from portbench import counters

LAYER = "train/step + train/optim"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_windows_per_s"


def read(ctx):
    c, config = ctx["counters"], ctx["config"]
    if not c["windows"] or c["window_s"] <= 0:
        return None
    samples = round(config["data"]["window_s"] * config["data"]["sample_rate"])
    flops = counters.train_flops(config["model"], samples) * c["windows"]
    peak = counters.PEAK_FLOPS[config["precision"]["compute_dtype"]]
    return 100.0 * flops / c["window_s"] / peak
