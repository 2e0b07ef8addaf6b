"""Standard MIDI File writer and reader, in the standard library only.

Counterpart of ``audio_to_midi_tpu/ops/midi_io.py``, byte for byte the same
output.  Replaces the reference's mido usage (infer.py:46-83): fixed 120 BPM 4/4,
set_tempo + time_signature meta events, frame->tick conversion, key biased by
+21, velocity scaled from the 10 reference categories to 0..127, delta-time
sorted note_on/note_off stream.
"""

from __future__ import annotations

import struct
from pathlib import Path

from ..config import NUM_VELOCITY_CATEGORIES

TICKS_PER_BEAT = 480  # mido default ticks_per_beat
DEFAULT_TEMPO_BPM = 120
DEFAULT_TIME_SIGNATURE = (4, 4)


def _var_len(value: int) -> bytes:
    """MIDI variable-length quantity encoding."""
    if value < 0:
        raise ValueError("negative delta time")
    chunks = [value & 0x7F]
    value >>= 7
    while value:
        chunks.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(chunks))


def bpm_to_tempo(bpm: float) -> int:
    """Microseconds per quarter note (mido.bpm2tempo equivalent)."""
    return int(round(60_000_000 / bpm))


def second_to_tick(seconds: float, ticks_per_beat: int, tempo: int) -> int:
    """mido.second2tick equivalent (rounded to int)."""
    scale = tempo * 1e-6 / ticks_per_beat
    return int(round(seconds / scale))


def write_midi_file(
    events: list[tuple[int, int, int, int]],
    duration_per_frame: float,
    output_file: str | Path,
    tempo_bpm: float = DEFAULT_TEMPO_BPM,
    time_signature: tuple[int, int] = DEFAULT_TIME_SIGNATURE,
) -> None:
    """events: (attack_frame, key, duration_frames, velocity-category)."""
    tempo = bpm_to_tempo(tempo_bpm)

    def frame_to_tick(frame: int) -> int:
        return second_to_tick(frame * duration_per_frame, TICKS_PER_BEAT, tempo)

    # (tick, type-order, key, velocity); sort matches the reference's tuple
    # sort over (time, 'note_off' < 'note_on', ...) — string comparison in the
    # reference means note_off sorts before note_on at equal times.
    out_of_order = []
    for attack_frame, key, duration_frames, velocity in events:
        midi_key = int(key) + 21
        midi_velocity = int(round((velocity / NUM_VELOCITY_CATEGORIES) * 127))
        out_of_order.append((frame_to_tick(attack_frame), 1, midi_key, midi_velocity))
        out_of_order.append(
            (frame_to_tick(attack_frame + duration_frames), 0, midi_key, midi_velocity)
        )

    track = bytearray()
    # Meta: set_tempo (delta 0)
    track += _var_len(0) + bytes([0xFF, 0x51, 0x03]) + tempo.to_bytes(3, "big")
    # Meta: time_signature (delta 0): numerator, log2(denominator),
    # clocks_per_click=24, notated_32nd_notes_per_beat=8
    num, den = time_signature
    den_pow = den.bit_length() - 1
    if den <= 0 or den != 1 << den_pow:
        # SMF stores log2(denominator); non-powers-of-2 are unrepresentable
        # (mido, the reference's writer at infer.py:57, rejects them too).
        raise ValueError(f"time signature denominator must be a power of 2, got {den}")
    track += _var_len(0) + bytes([0xFF, 0x58, 0x04, num, den_pow, 24, 8])

    current = 0
    for tick, is_on, key, velocity in sorted(out_of_order):
        delta = tick - current
        status = 0x90 if is_on else 0x80
        track += _var_len(delta) + bytes([status, key & 0x7F, velocity & 0x7F])
        current = tick
    # End of track
    track += _var_len(0) + bytes([0xFF, 0x2F, 0x00])

    header = struct.pack(">4sIHHH", b"MThd", 6, 1, 1, TICKS_PER_BEAT)
    chunk = struct.pack(">4sI", b"MTrk", len(track)) + bytes(track)
    Path(output_file).write_bytes(header + chunk)


def read_midi_file(path: str | Path) -> list[tuple[int, str, int, int]]:
    """SMF reader returning (tick, type, key, velocity).

    Notes come back as ``note_on``/``note_off`` events (zero-velocity
    note-on normalized to note_off); meta events as ``meta_<type>``.  Other
    channel messages (program change, CC, pitch bend, aftertouch) and sysex
    are parsed and skipped with their correct operand counts, and meta/sysex
    cancel running status per the SMF spec — so files written by other
    software read cleanly, not just :func:`write_midi_file` round-trips."""
    data = Path(path).read_bytes()
    # Clean ValueError on malformed files (asserts vanish under -O, and a
    # truncated file must not surface as IndexError/TypeError).
    if data[:4] != b"MThd" or len(data) < 14:
        raise ValueError(f"{path}: not a standard MIDI file")
    ntracks = struct.unpack(">H", data[10:12])[0]
    pos = 8 + struct.unpack(">I", data[4:8])[0]
    events = []
    for _ in range(ntracks):
        if data[pos : pos + 4] != b"MTrk" or pos + 8 > len(data):
            raise ValueError(f"{path}: truncated/malformed track chunk")
        length = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        end = pos + 8 + length
        pos += 8
        tick = 0
        running = None
        if end > len(data):
            raise ValueError(f"{path}: track length past end of file")

        # Every read below goes through these, so a truncated varint/payload
        # at the declared track end (or EOF) raises a clean ValueError and an
        # event can never silently consume the next track's bytes.
        def _byte() -> int:
            nonlocal pos
            if pos >= end:
                raise ValueError(f"{path}: event data past declared track end")
            b = data[pos]
            pos += 1
            return b

        def _varint() -> int:
            v = 0
            for _ in range(4):  # SMF varints are at most 4 bytes
                b = _byte()
                v = (v << 7) | (b & 0x7F)
                if not (b & 0x80):
                    return v
            raise ValueError(f"{path}: unterminated variable-length quantity")

        while pos < end:
            tick += _varint()
            status = _byte()
            if status & 0x80:
                running = status
            else:
                if running is None:
                    raise ValueError(f"{path}: data byte before any status")
                status = running
                pos -= 1  # the byte was event data, not a status
            if status == 0xFF:
                running = None  # meta events cancel running status (SMF spec)
                meta_type = _byte()
                mlen = _varint()
                if pos + mlen > end:
                    raise ValueError(f"{path}: meta event past declared track end")
                pos += mlen
                events.append((tick, f"meta_{meta_type:02x}", 0, 0))
            elif status in (0xF0, 0xF7):
                running = None  # sysex cancels running status too
                slen = _varint()
                if pos + slen > end:
                    raise ValueError(f"{path}: sysex event past declared track end")
                pos += slen
            elif status & 0xF0 in (0x80, 0x90):
                key, vel = _byte(), _byte()
                kind = "note_on" if (status & 0xF0) == 0x90 and vel > 0 else "note_off"
                events.append((tick, kind, key, vel))
            elif status & 0xF0 in (0xA0, 0xB0, 0xE0):
                _byte(), _byte()  # aftertouch / controller / pitch bend: skipped
            elif status & 0xF0 in (0xC0, 0xD0):
                _byte()  # program change / channel pressure: skipped
            else:
                raise ValueError(f"unhandled MIDI status {status:#x}")
    return events
