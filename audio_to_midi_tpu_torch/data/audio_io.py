"""Host audio decoding, in numpy (and scipy for resampling) or through the
C++ decode plane.

Counterpart of ``audio_to_midi_tpu/data/audio_io.py`` and of
``data/loader.load_full_audio_f16``: WAV and AIFF/AIFC (PCM) decode, scipy
polyphase resampling to the model rate, loudness normalization and the f16
round trip of the reference's decode (python.rs:236-264).

:func:`decode_audio` and :func:`load_full_audio_f16` take the native plane
(``native.py``) under the JAX package's rule: when it is built, and for the
suffixes it decodes (``NATIVE_SUFFIXES``).  At the model rate both paths
give the same bits; a file at another rate is resampled by the plane's own
filter, which differs from scipy's (at 44.1 kHz by up to 0.84 on
unit-variance audio).  Compressed formats (through ffmpeg) are not ported
yet.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .. import native
from ..config import SAMPLE_RATE

NATIVE_SUFFIXES = (".wav", ".wave", ".aif", ".aiff", ".aifc")
NO_CACHE = 3  # bitmask into the native loader: skip the cache read and write


def use_native(path: str | Path) -> bool:
    """The native plane takes ``path``: it is built (and not turned off by
    ``A2M_DISABLE_NATIVE``) and decodes the file's suffix."""
    return Path(path).suffix.lower() in NATIVE_SUFFIXES and native.available()


class AudioDecodeError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# WAV
# ---------------------------------------------------------------------------


def _decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioDecodeError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise AudioDecodeError("missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(body) >= 26:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", body[24:26])[0]
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(samples, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(samples, np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(samples, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(samples, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise AudioDecodeError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # float
        x = np.frombuffer(samples, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise AudioDecodeError(f"unsupported WAV format {audio_format}")
    x = x.reshape(-1, channels).T  # (channels, N)
    return np.ascontiguousarray(x), rate


# ---------------------------------------------------------------------------
# AIFF / AIFC (PCM only)
# ---------------------------------------------------------------------------


def _read_extended80(b: bytes) -> float:
    """80-bit IEEE 754 extended float (AIFF sample rate field)."""
    exponent = struct.unpack(">H", b[:2])[0]
    mantissa = struct.unpack(">Q", b[2:10])[0]
    sign = -1.0 if exponent & 0x8000 else 1.0
    exponent &= 0x7FFF
    if exponent == 0 and mantissa == 0:
        return 0.0
    return sign * mantissa * 2.0 ** (exponent - 16383 - 63)


def _decode_aiff(data: bytes) -> tuple[np.ndarray, int]:
    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise AudioDecodeError("not an AIFF/AIFC file")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    channels = rate = bits = None
    compression = b"NONE"
    frames = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"COMM":
            channels, _nframes, bits = struct.unpack(">HIH", body[:8])
            rate = int(round(_read_extended80(body[8:18])))
            if is_aifc and len(body) >= 22:
                compression = body[18:22]
        elif chunk_id == b"SSND":
            offset = struct.unpack(">I", body[:4])[0]
            frames = body[8 + offset :]
        pos += 8 + size + (size & 1)
    if channels is None or frames is None:
        raise AudioDecodeError("missing COMM/SSND chunk")
    if compression not in (b"NONE", b"sowt"):
        raise AudioDecodeError(f"unsupported AIFC compression {compression!r}")
    endian = "<" if compression == b"sowt" else ">"
    if bits == 16:
        x = np.frombuffer(frames, f"{endian}i2").astype(np.float32) / 32768.0
    elif bits == 24:
        raw = np.frombuffer(frames, np.uint8)
        raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
        if endian == ">":
            raw = raw[:, ::-1]
        x = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    elif bits == 32:
        x = np.frombuffer(frames, f"{endian}i4").astype(np.float32) / 2147483648.0
    elif bits == 8:
        x = np.frombuffer(frames, np.int8).astype(np.float32) / 128.0
    else:
        raise AudioDecodeError(f"unsupported AIFF bit depth {bits}")
    n = (x.shape[0] // channels) * channels
    x = x[:n].reshape(-1, channels).T
    return np.ascontiguousarray(x), rate


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def decode_audio(path: str | Path, sample_rate: int) -> np.ndarray:
    """Decode an audio file to stereo float32 at ``sample_rate``.  (2, N)."""
    if use_native(path):
        return native.decode_audio(path, sample_rate)
    path = str(path)
    suffix = Path(path).suffix.lower()
    if suffix in (".wav", ".wave"):
        x, rate = _decode_wav(Path(path).read_bytes())
    elif suffix in (".aif", ".aiff", ".aifc"):
        x, rate = _decode_aiff(Path(path).read_bytes())
    else:
        raise AudioDecodeError(f"cannot decode {path}: the port decodes wav and aif")

    # Malformed headers can declare rate 0 (zero-divide in the polyphase
    # ratio) or garbage.
    if not 0 < rate <= 50_000_000:
        raise AudioDecodeError(f"implausible sample rate {rate} in {path}")

    if x.shape[0] == 1:
        x = np.repeat(x, 2, axis=0)
    elif x.shape[0] > 2:
        x = x[:2]

    if rate != sample_rate:
        x = _resample_host(x, rate, sample_rate)
    return x.astype(np.float32)


def _resample_host(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resample on host (scipy) — used for decode-time rate changes."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(src_rate, dst_rate)
    return resample_poly(x, dst_rate // g, src_rate // g, axis=1).astype(np.float32)


def normalize_loudness_np(samples: np.ndarray) -> np.ndarray:
    """Host mirror of ops.frontend.normalize_loudness (python.rs:236-264)."""
    peak = np.max(np.abs(samples)) if samples.size else 0.0
    if peak <= 0.05:
        return samples.astype(np.float32)
    variance = float(np.mean(np.square(samples, dtype=np.float64)))
    return (samples * np.sqrt(1.0 / variance)).astype(np.float32)


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int) -> None:
    """Write (channels, N) float32 as 16-bit PCM WAV (used by tests/synthetic)."""
    x = np.clip(samples, -1.0, 1.0)
    pcm = (x.T * 32767.0).astype("<i2").tobytes()
    channels = samples.shape[0]
    byte_rate = sample_rate * channels * 2
    header = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16, 1, channels,
        sample_rate, byte_rate, channels * 2, 16, b"data", len(pcm),
    )
    Path(path).write_bytes(header + pcm)


def load_full_audio_f16(file: str | Path, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Decode -> normalize -> float16, (2, N): the serving input.  Equal to
    the JAX package's ``data.loader.load_full_audio_f16`` on the same path
    (native or numpy)."""
    if use_native(file):
        return native.load_audio_sample_f16(str(file), sample_rate, NO_CACHE)
    return normalize_loudness_np(decode_audio(file, sample_rate)).astype(np.float16)
