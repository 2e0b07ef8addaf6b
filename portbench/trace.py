"""Reading a ``torch.profiler`` trace of the traced window.

* busy: the union of every device activity (kernels, copies, sets) inside
  the window, which is the ``record_function`` range ``WINDOW``.  The
  ranges' own marks on the device's timeline are not activity;
* idle gaps: the holes in that union, each named by the innermost span of
  ``spans.Spans`` around its midpoint (``outside_any_span`` where none);
* device operations: time by name;
* operator calls: for each operator of a given name (outermost of that name
  only), its input shapes and the device time of the kernels launched under
  it and its children.
"""

from __future__ import annotations

from collections import defaultdict

WINDOW = "traced_window"
TOP = 10


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _device_time_us(evt) -> float:
    total = getattr(evt, "device_time_total", None)
    return float(total if total is not None else evt.cuda_time_total)


def summarize(prof, span_names, op_names) -> dict:
    """The window's busy and idle seconds, the longest idle gaps, the device
    operations that took most time, and the calls of each operator in
    ``op_names`` as (input shapes, device seconds)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = [(e.start_ns(), e.end_ns()) for e in events
              if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not window:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    w0, w1 = window[0]
    device, spans = [], []
    ranges = set(span_names) | {WINDOW}
    for e in events:
        annotation = "annotation" in str(getattr(e, "activity_type", lambda: "")()).lower()
        if e.device_type() == DeviceType.CUDA and not annotation and e.name() not in ranges:
            start, end = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if end > start:
                device.append((start, end, e.name()))
        elif e.device_type() == DeviceType.CPU and e.name() in span_names:
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    busy = _union([(s, e) for s, e, _ in device])
    busy_ns = sum(e - s for s, e in busy)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = []
    for start, end in zip(edges[0::2], edges[1::2]):
        if end > start:
            mid = (start + end) / 2
            around = [s for s in spans if s[0] <= mid <= s[1]]
            name = min(around, key=lambda s: s[1] - s[0])[2] if around else "outside_any_span"
            gaps.append((name, (end - start) / 1e9))
    by_name = defaultdict(int)
    for start, end, name in device:
        by_name[name] += end - start
    ops = defaultdict(list)
    for evt in prof.events() if op_names else ():
        if evt.name in op_names:
            parent = evt.cpu_parent
            while parent is not None and parent.name != evt.name:
                parent = parent.cpu_parent
            if parent is None:
                ops[evt.name].append((evt.input_shapes, _device_time_us(evt) / 1e6))
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:TOP],
        "device_ops": sorted(((n, t / 1e9) for n, t in by_name.items()), key=lambda g: -g[1])[:TOP],
        "ops": dict(ops),
    }
