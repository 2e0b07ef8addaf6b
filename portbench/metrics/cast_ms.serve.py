"""Host-clock time of the model's cast copy per recording, over the traced
cycle: the program's span ``serve.cast_model`` (a deep copy of the model and
a cast of its leaves to the compute dtype, where that is not the
parameters') over the calls of its root ``serve.transcribe``; None where no
cast ran.  The spans are on only while the profiler records, which
stretches the host."""

LAYER = "serving entry"
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
    if not calls or "serve.cast_model" not in spans:
        return None
    return spans["serve.cast_model"]["total_ns"] / calls / 1e6
