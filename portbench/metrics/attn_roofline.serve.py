"""The attention kernels' share of their roofline in the traced window: the
least time of every ``a2m::global_attention_fwd`` and
``a2m::local_two_phase_fwd`` call (the larger of its operations over the
compute dtype's peak and its bytes over 3.35 TB/s, from the shapes the
trace recorded) over the device time of the kernels launched under them."""

from portbench import counters

LAYER = "ops/attention_kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "audio_s_per_s"


def read(ctx):
    trace, config = ctx["trace"], ctx["config"]
    if trace is None:
        return None
    dtype = config["precision"]["compute_dtype"]
    peak, elt = counters.PEAK_FLOPS[dtype], counters.BYTES[dtype]
    window = config["model"]["local_context_window"]
    least = spent = 0.0
    for name, calls in trace["ops"].items():
        for shapes, seconds in calls:
            q = shapes[0]
            if name == "a2m::global_attention_fwd":
                flops, nbytes = counters.global_attention_work(q, elt)
            else:
                flops, nbytes = counters.local_attention_work(q, window, elt)
            least += max(flops / peak, nbytes / counters.PEAK_BYTES)
            spent += seconds
    if spent <= 0:
        return None
    return 100.0 * least / spent
