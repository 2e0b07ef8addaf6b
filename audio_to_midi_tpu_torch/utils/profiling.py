"""Profiling and tracing.

Counterpart of ``audio_to_midi_tpu/utils/profiling.py``:
  * ``span(name)`` -- a host-clock span around one layer's work, kept in
    memory as per-name totals (``summary()``, ``reset()``): calls, total and
    self nanoseconds (``time.perf_counter_ns``), and the counts added with
    ``s.add(key, n)``.  A span's parent is the innermost span open on its
    thread; a root span takes a fresh request id, which its children
    inherit.  Spans are on only while a ``torch.profiler`` profile records
    on the calling thread, where each span is also a range of the trace,
    on the clock of its kernels and copies (with ``{"request": id}`` in its
    args where the profile records shapes), and inside a ``recording()``
    block, in every thread.  Off, a span reads no clock, allocates nothing
    and opens no range; it never synchronizes the device;
  * ``annotate`` -- the decorator form of ``span``;
  * ``trace(log_dir)`` -- a ``torch.profiler`` window over the CPU and, where
    there is one, the card, written as a Chrome / Perfetto trace (JSON) into
    ``log_dir``, with shapes recorded (so the spans carry their request
    ids);
  * ``start_server(port)`` / ``capture(port, duration_ms, log_dir)`` -- capture
    on demand: a thread of the profiled process listens on
    ``127.0.0.1:port`` and, asked by ``capture`` from another process, runs
    the profiler for that window and writes the trace.

The profiler records CPU operators per thread, so a capture started by the
server's thread holds none of the other threads' operators or spans; it
records the card's kernels (CUPTI) for the whole process.  Nothing here opens
a link to a trace viewer: the trace's path is logged and returned.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import socket
import tempfile
import threading
import time
from pathlib import Path
from typing import Iterator

import torch
from torch._C._profiler import _RecordFunctionFast

log = logging.getLogger(__name__)

_clock = time.perf_counter_ns
_profiler_on = torch._C._autograd._profiler_enabled
_recording = 0        # recording() blocks open, in any thread
_lock = threading.Lock()
_local = threading.local()   # .stack: the spans open on this thread
_requests = itertools.count(1)
_totals: dict[str, dict] = {}


class _Off:
    """What :func:`span` gives while spans are off: it does nothing."""

    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, key: str, n: int) -> None:
        pass


_OFF = _Off()


class Span:
    """One open span (see :func:`span`).  After it closes, ``ns`` holds its
    duration."""

    __slots__ = ("name", "request", "counts", "ns", "_t0", "_children_ns", "_parent", "_range")
    on = True

    def __init__(self, name: str):
        self.name = name
        self.counts: dict[str, int] = {}
        self.ns = self._children_ns = 0

    def add(self, key: str, n: int) -> None:
        """Add ``n`` to this span's count ``key``."""
        self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._parent = stack[-1] if stack else None
        self.request = self._parent.request if self._parent else next(_requests)
        self._range = None
        if _profiler_on():
            # record_function's args string reaches no trace; keyword values
            # do, where the profile records shapes.
            self._range = _RecordFunctionFast(self.name, (), {"request": self.request})
            self._range.__enter__()
        stack.append(self)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.ns = _clock() - self._t0
        _local.stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._parent is not None:
            self._parent._children_ns += self.ns
        with _lock:
            total = _totals.get(self.name)
            if total is None:
                total = _totals[self.name] = {"calls": 0, "total_ns": 0, "self_ns": 0,
                                              "counts": {}}
            total["calls"] += 1
            total["total_ns"] += self.ns
            total["self_ns"] += self.ns - self._children_ns
            for key, n in self.counts.items():
                total["counts"][key] = total["counts"].get(key, 0) + n
        return False


def span(name: str) -> Span | _Off:
    """A context manager around one layer's work: a :class:`Span` while
    spans are on (a profiler recording on this thread, or a
    :func:`recording` block open), else a shared object that does nothing.
    Either takes ``add(key, n)``; ``.on`` tells them apart, for counts that
    cost work to compute."""
    if _recording or _profiler_on():
        return Span(name)
    return _OFF


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans on, in every thread, for the enclosed block, without a
    profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def summary() -> dict[str, dict]:
    """The spans closed since the last :func:`reset`, by name: ``calls``,
    ``total_ns``, ``self_ns`` (total less the time its child spans cover)
    and ``counts`` (the sums of what was added)."""
    with _lock:
        return {name: dict(t, counts=dict(t["counts"])) for name, t in _totals.items()}


def reset() -> None:
    """Forget every span closed so far."""
    with _lock:
        _totals.clear()


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "torch-trace")


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_file(log_dir: str | Path) -> Path:
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    return out / f"trace-{os.getpid()}-{time.time_ns()}.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None, create_perfetto_link: bool = False) -> Iterator[None]:
    """Profile the enclosed block; on exit write its trace into ``log_dir``
    (default ``$TMPDIR/torch-trace``).  ``create_perfetto_link`` only logs
    the file's path: there is no viewer to link to."""
    path = _trace_file(log_dir or _default_dir())
    with torch.profiler.profile(activities=_activities(), record_shapes=True) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    log.info("Wrote the trace to %s%s", path,
             " (open it in Perfetto: no link is made)" if create_perfetto_link else "")


def annotate(name: str):
    """Decorator: each call of the function is a :func:`span` named
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class ProfilerServer:
    """A daemon thread on ``127.0.0.1:port`` that answers each
    :func:`capture` by profiling the process for the asked window and
    writing the trace; ``close`` stops it."""

    def __init__(self, port: int = 9999):
        self._sock = socket.create_server(("127.0.0.1", port))
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, name="a2m-profiler-server",
                                        daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:  # closed
                return
            with conn:
                try:
                    request = json.loads(conn.makefile("r").readline())
                    path = _trace_file(request.get("log_dir") or _default_dir())
                    with torch.profiler.profile(activities=_activities()) as prof:
                        time.sleep(float(request["duration_ms"]) / 1e3)
                    prof.export_chrome_trace(str(path))
                    reply = {"path": str(path)}
                except Exception as e:  # a bad request must not stop the server
                    log.exception("profiler capture failed")
                    reply = {"error": repr(e)}
                conn.sendall((json.dumps(reply) + "\n").encode())

    def close(self) -> None:
        try:  # wakes the thread's accept, which close alone does not
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._thread.join(timeout=10)


def start_server(port: int = 9999) -> ProfilerServer:
    """Serve captures on demand from another process (port 0: any free
    port, read back from ``.port``)."""
    return ProfilerServer(port)


def capture(port: int, duration_ms: float, log_dir: str | None = None,
            timeout: float = 120.0) -> str:
    """Ask the :func:`start_server` of the process on ``127.0.0.1:port`` for a
    trace of the next ``duration_ms``; returns the trace's path."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as conn:
        conn.sendall((json.dumps({"duration_ms": duration_ms, "log_dir": log_dir}) + "\n").encode())
        reply = json.loads(conn.makefile("r").readline())
    if "error" in reply:
        raise RuntimeError(f"profiler capture failed: {reply['error']}")
    return reply["path"]
