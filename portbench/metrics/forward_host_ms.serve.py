"""Host-clock time of the forward per recording, over the traced cycle: the
program's span ``model.forward`` (the windows' cast and the model's
launches, which return before the card has finished) over the calls of its
root ``serve.transcribe``.  The spans are on only while the profiler
records, which stretches the host."""

LAYER = "serving forward"
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
    if not calls or "model.forward" not in spans:
        return None
    return spans["model.forward"]["total_ns"] / calls / 1e6
