"""``utils/profiling.py``'s exporters: a trace is written and parses,
``annotate`` names its spans in it, and one ``start_server`` / ``capture``
round from another process writes a trace on the CPU."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from audio_to_midi_tpu_torch.utils import profiling

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def test_trace_writes_a_trace_that_names_the_annotated_spans(tmp_path):
    @profiling.annotate("a2m.test_span")
    def work(x):
        return (x @ x).relu().sum()

    assert work.__name__ == "work"
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), create_perfetto_link=True):
        work(x)
    (path,) = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "a2m.test_span" in names and "aten::mm" in names


def test_capture_on_demand_from_another_process(tmp_path):
    server = profiling.start_server(0)
    try:
        client = subprocess.Popen(
            [sys.executable, "-c", "from audio_to_midi_tpu_torch.utils.profiling import capture; "
             f"print(capture({server.port}, 300, {str(tmp_path)!r}))"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        x = torch.randn(128, 128)
        while client.poll() is None:
            x = (x @ x).tanh()
        out, err = client.communicate(timeout=120)
        assert client.returncode == 0, err
        path = Path(out.strip().splitlines()[-1])
        assert path.parent == tmp_path and "traceEvents" in json.loads(path.read_text())
        # A request the server cannot read is answered with its error, and
        # the server serves on.
        with socket.create_connection(("127.0.0.1", server.port), timeout=30) as conn:
            conn.sendall(b"not json\n")
            assert "error" in json.loads(conn.makefile("r").readline())
        assert Path(profiling.capture(server.port, 10, str(tmp_path))).exists()
    finally:
        server.close()
    with pytest.raises(OSError):
        profiling.capture(server.port, 10, str(tmp_path), timeout=5)
