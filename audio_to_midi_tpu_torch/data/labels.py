"""CSV MIDI-event label parsing: the JAX package's ``data/labels.py``.

Reference semantics (python.rs:39-103): per-sample ``<name>.csv`` with rows
``time,duration,key,velocity`` — no header, ``%`` comment lines, whitespace
trimmed, and (quirk preserved on purpose) the FIRST data record is skipped
(python.rs:72 ``.skip(1)``; the datasets carry a header-ish first row).
Quantization: attack = round(time / dpf), key -> key - 21 (piano A0..C8 ->
0..87), duration -> round(duration / dpf) clamped to >= 1, velocity ->
round(velocity * 10); rounds are half-away-from-zero like Rust's ``.round()``.

Faithfulness details (python.rs:39-55,71-84), matched exactly by this parser
and the C++ twin (``a2m_parse_events_csv``):

* ``time``/``duration``/``velocity`` deserialize as **f32** and the
  quantization arithmetic runs in f32 (``frame_position`` takes f32), so
  half-boundary rows quantize like the reference, not like a f64 port.
  Rust's float parse never errors on magnitude — ``1e40`` is ``inf`` — so
  overflowing tokens KEEP the row and saturate.
* ``key`` deserializes as **u32**: a non-integer / negative / out-of-range
  key token is a serde error that skips the whole row.
* A row whose field count differs from 4 is a csv ``UnequalLengths`` error:
  the row is skipped (default non-flexible reader).
* Tokens with trailing garbage (``60abc``) are serde errors: row skipped.
* The ``as u32`` casts saturate (NaN -> 0, negative -> 0, inf -> u32::MAX).
  We cap at i32::MAX instead of u32::MAX so events stay int32-typed across
  the C ABI; every consumer (rasterizer, eventizer, window offsetting)
  ignores frames beyond the raster, so the two caps are behaviorally
  identical.  Likewise ``key - 21`` is stored signed instead of u32-wrapped
  (python.rs:50): both representations are out of the 0..88 vocab for
  key < 21 and are ignored identically downstream.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

Event = tuple[int, int, int, int]  # (attack_frame, key, duration_frames, velocity)

_I32_MAX = 2**31 - 1
_U32_MAX = 2**32 - 1
_DIGITS = frozenset("0123456789")


def _parse_f32(tok: str) -> np.float32:
    """Strict full-token f32 parse with Rust semantics: trailing garbage and
    underscores are errors; overflow saturates to +/-inf (never an error)."""
    if "_" in tok or not tok.isascii():
        raise ValueError(tok)  # Rust rejects underscores and unicode digits
    v = float(tok)  # strict: raises on partial tokens, accepts inf/nan
    with np.errstate(over="ignore"):
        return np.float32(v)


def _parse_u32(tok: str) -> int:
    """Rust ``str::parse::<u32>``: optional '+', ASCII digits, <= u32::MAX."""
    t = tok[1:] if tok.startswith("+") else tok
    if not t or not all(c in _DIGITS for c in t):
        raise ValueError(tok)
    v = int(t)
    if v > _U32_MAX:
        raise ValueError(tok)
    return v


def _round_u32_sat(x: float) -> int:
    """``x.round() as u32`` (Rust): half-away round, NaN -> 0, negative -> 0,
    overflow saturates.  Capped at i32::MAX (see module docstring)."""
    if math.isnan(x):
        return 0
    if math.isinf(x):
        return _I32_MAX if x > 0 else 0
    r = math.floor(x + 0.5) if x >= 0 else -math.floor(-x + 0.5)
    if r <= 0:
        return 0
    if r >= _I32_MAX:
        return _I32_MAX
    return int(r)


def parse_events_csv(path: str | Path, duration_per_frame: float) -> list[Event]:
    events: list[Event] = []
    first_record = True
    dpf = np.float32(duration_per_frame)
    for raw_line in Path(path).read_text().splitlines():
        line = raw_line.strip()
        if not line or line.startswith("%"):
            continue
        if first_record:
            first_record = False  # reference skips the first data row
            continue
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != 4:  # csv UnequalLengths -> row skipped
            continue
        try:
            time = _parse_f32(parts[0])
            duration = _parse_f32(parts[1])
            key = _parse_u32(parts[2])
            velocity = _parse_f32(parts[3])
        except ValueError:
            continue  # serde deserialize error -> row skipped
        with np.errstate(invalid="ignore", over="ignore"):
            attack = _round_u32_sat(float(time / dpf))
            duration_frames = max(_round_u32_sat(float(duration / dpf)), 1)
            vel = _round_u32_sat(float(velocity * np.float32(10.0)))
        events.append((attack, min(key - 21, _I32_MAX), duration_frames, vel))
    events.sort()
    return events


def write_events_csv(path: str | Path, events_seconds, header: bool = True) -> None:
    """Write (time_s, duration_s, midi_key, velocity01) rows.

    When ``header`` is True a dummy first row is included so the parser's
    skip-first-record behaviour lines up (as the reference datasets do).
    """
    lines = ["% time,duration,key,velocity"]
    if header:
        lines.append("0.0,0.0,21,0.0")
    for t, d, k, v in events_seconds:
        lines.append(f"{t},{d},{k},{v}")
    Path(path).write_text("\n".join(lines) + "\n")
