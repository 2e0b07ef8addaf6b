"""Profiling and tracing.

Counterpart of ``audio_to_midi_tpu/utils/profiling.py``:
  * ``trace(log_dir)`` -- a ``torch.profiler`` window over the CPU and, where
    there is one, the card, written as a Chrome / Perfetto trace (JSON) into
    ``log_dir``;
  * ``start_server(port)`` / ``capture(port, duration_ms, log_dir)`` -- capture
    on demand: a thread of the profiled process listens on
    ``127.0.0.1:port`` and, asked by ``capture`` from another process, runs
    the profiler for that window and writes the trace;
  * ``annotate`` -- a decorator that names a function's span in a trace
    (``torch.profiler.record_function``);
  * ``StepTimer`` -- a wall-time EMA per step.

The profiler records CPU operators per thread, so a capture started by the
server's thread holds none of the other threads' operators; it records the
card's kernels (CUPTI) for the whole process.  Nothing here opens a link to a trace viewer: the
trace's path is logged and returned.
"""

from __future__ import annotations

import contextlib
import functools
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

log = logging.getLogger(__name__)


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
    with torch.profiler.profile(activities=_activities()) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    log.info("Wrote the trace to %s%s", path,
             " (open it in Perfetto: no link is made)" if create_perfetto_link else "")


def annotate(name: str):
    """Decorator: the function's calls appear in a trace as spans named
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
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


class StepTimer:
    """EMA step timer with steps/sec and items/sec accessors."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self._last = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        self._last = now
        return self.ema

    @property
    def steps_per_sec(self) -> float | None:
        return None if not self.ema else 1.0 / self.ema
