"""Host-clock time of ``ops/eventize.extract_events`` per recording over the
measured window: the card eventizes the stitched probabilities and the note
table comes back (the forward has finished before the span opens)."""

LAYER = "ops/eventize"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s"


def read(ctx):
    spans = ctx["spans"]
    count = spans.count.get("extract_events", 0)
    if not count:
        return None
    return 1000.0 * spans.total["extract_events"] / count
