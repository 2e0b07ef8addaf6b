"""Host-clock time of the resampler per recording, over the traced cycle:
the program's span ``frontend.resample`` (``ops/frontend.resample_poly``,
its index table built on the host and copied included) over the calls of
its root ``serve.transcribe``.  The spans are on only while the profiler
records, which stretches the host."""

LAYER = "ops/frontend"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s"


def read(ctx):
    if ctx["trace"] is None:   # spans are recorded in the traced cycle only
        return None
    try:
        from audio_to_midi_tpu_torch.utils.profiling import summary
    except ImportError:   # a program without the span recorder
        return None
    spans = summary()
    calls = spans.get("serve.transcribe", {}).get("calls", 0)
    if not calls or "frontend.resample" not in spans:
        return None
    return spans["frontend.resample"]["total_ns"] / calls / 1e6
