"""ctypes binding of the C++ host data plane (``cpp/a2m_native.cpp``).

Counterpart of the JAX package's ``native.py``: the same eleven functions
over the same library, with the semantics of the numpy host code in
``data/`` and ``ops/``.  The library is built at first use from the repo's
``cpp/`` sources (its ``CMakeLists.txt`` with cmake + ninja, or bare g++
with the same flags) into ``build/native/`` -- the port's own directory, so
that its build never races the JAX package's ``cpp/build/``.  Two processes
that build at once take a file lock; the library is linked under a
temporary name and moved into place with ``os.replace``, so a reader never
loads half a file.

``A2M_DISABLE_NATIVE=1`` turns the plane off.  A failed build logs a
warning and :func:`available` is then False: the callers take the numpy
path, the JAX package's rule for host code.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_REPO_ROOT = Path(__file__).resolve().parent.parent
_CPP_DIR = _REPO_ROOT / "cpp"
_BUILD_DIR = _REPO_ROOT / "build" / "native"
_SOURCES = ("a2m_native.cpp", "a2m_native.h", "CMakeLists.txt")
_LIB = None
_LOAD_FAILED = False


def lib_path() -> Path:
    return _BUILD_DIR / "liba2m_native.so"


def _stale(out: Path) -> bool:
    if not out.exists():
        return True
    built = out.stat().st_mtime
    return any((_CPP_DIR / name).stat().st_mtime > built for name in _SOURCES)


def _compile(tmp_dir: Path) -> Path:
    """Build the shared library inside ``tmp_dir``; returns its path."""
    try:
        subprocess.run(
            ["cmake", "-G", "Ninja", "-DCMAKE_BUILD_TYPE=Release", "-S", str(_CPP_DIR),
             "-B", str(tmp_dir)],
            check=True, capture_output=True,
        )
        subprocess.run(["ninja", "-C", str(tmp_dir), "a2m_native"], check=True,
                       capture_output=True)
        return tmp_dir / "liba2m_native.so"
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        log.info("cmake build failed (%s); trying bare g++", e)
    out = tmp_dir / "liba2m_native.so"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-fno-math-errno", "-std=c++17", "-shared", "-fPIC",
         str(_CPP_DIR / "a2m_native.cpp"), "-o", str(out)],
        check=True, capture_output=True,
    )
    return out


def build(force: bool = False) -> Path:
    """Build ``build/native/liba2m_native.so`` unless it is newer than its
    sources; safe when several processes call it at once."""
    out = lib_path()
    if not force and not _stale(out):
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not _stale(out):  # another process built it meanwhile
            return out
        tmp_dir = Path(tempfile.mkdtemp(prefix="build-", dir=_BUILD_DIR))
        try:
            built = _compile(tmp_dir)
            staged = _BUILD_DIR / f".liba2m_native.so.{os.getpid()}"
            shutil.copy2(built, staged)
            os.replace(staged, out)
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    return out


def _load():
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    if os.environ.get("A2M_DISABLE_NATIVE"):
        _LOAD_FAILED = True
        return None
    try:
        lib = ctypes.CDLL(str(build()))
    except Exception as e:  # no toolchain, or the build failed
        log.warning("native data plane unavailable, the numpy path runs: %s", e)
        _LOAD_FAILED = True
        return None

    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_f32p = ctypes.POINTER(ctypes.c_float)
    c_u16p = ctypes.POINTER(ctypes.c_uint16)
    c_f32pp = ctypes.POINTER(c_f32p)
    c_i32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
    c_u32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32))

    lib.a2m_free.argtypes = [ctypes.c_void_p]
    lib.a2m_decode_audio.argtypes = [ctypes.c_char_p, ctypes.c_int, c_f32pp, c_i64p]
    lib.a2m_normalize_loudness.argtypes = [c_f32p, ctypes.c_int64]
    lib.a2m_load_audio_sample.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, c_f32pp, c_i64p]
    lib.a2m_load_audio_sample_f16.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(c_u16p), c_i64p]
    lib.a2m_f16_to_f32_buf.argtypes = [c_u16p, c_f32p, ctypes.c_int64]
    lib.a2m_f32_to_f16_buf.argtypes = [c_f32p, c_u16p, ctypes.c_int64]
    lib.a2m_parse_events_csv.argtypes = [ctypes.c_char_p, ctypes.c_double, c_i32pp, c_i64p]
    lib.a2m_rasterize.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, c_f32p]
    lib.a2m_transform_for_training.argtypes = [
        c_f32p, c_f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_uint64]
    lib.a2m_stitch_probs.argtypes = [
        c_f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_double, c_f32pp, c_i64p]
    lib.a2m_extract_events.argtypes = [c_f32p, ctypes.c_int64, ctypes.c_int64, c_u32pp, c_i64p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _take_f32(lib, ptr, shape) -> np.ndarray:
    n = int(np.prod(shape))
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).astype(np.float32).reshape(shape)
    lib.a2m_free(ptr)
    return arr


def _take_rows(lib, ptr, n: int) -> list[tuple[int, int, int, int]]:
    if n == 0:
        lib.a2m_free(ptr)
        return []
    arr = np.ctypeslib.as_array(ptr, shape=(n, 4)).copy()
    lib.a2m_free(ptr)
    return [tuple(int(v) for v in row) for row in arr]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: {rc}")


def decode_audio(path: str | Path, sample_rate: int) -> np.ndarray:
    """(2, N) float32 at ``sample_rate``."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    _check(lib.a2m_decode_audio(str(path).encode(), sample_rate, ctypes.byref(out),
                                ctypes.byref(n)), f"a2m_decode_audio({path})")
    return _take_f32(lib, out, (2, n.value))


def load_audio_sample(path: str | Path, sample_rate: int,
                      skip_cache: int | bool = False) -> np.ndarray:
    """Decode + normalize, f16-rounded, (2, N) float32.  ``skip_cache`` is a
    bitmask: bit 0 skips the cache read, bit 1 the cache write (True: skip
    the read, still write)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    _check(lib.a2m_load_audio_sample(str(path).encode(), sample_rate, int(skip_cache),
                                     ctypes.byref(out), ctypes.byref(n)),
           f"a2m_load_audio_sample({path})")
    return _take_f32(lib, out, (2, n.value))


def load_audio_sample_f16(path: str | Path, sample_rate: int,
                          skip_cache: int | bool = False) -> np.ndarray:
    """:func:`load_audio_sample` left in float16, (2, N): the serving wire
    format."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_uint16)()
    n = ctypes.c_int64()
    _check(lib.a2m_load_audio_sample_f16(str(path).encode(), sample_rate, int(skip_cache),
                                         ctypes.byref(out), ctypes.byref(n)),
           f"a2m_load_audio_sample_f16({path})")
    arr = np.ctypeslib.as_array(out, shape=(2 * n.value,)).view(np.float16).copy()
    lib.a2m_free(out)
    return arr.reshape(2, n.value)


def f16_to_f32_buf(h: np.ndarray) -> np.ndarray:
    lib = _load()
    h = np.ascontiguousarray(h, np.float16)
    out = np.empty(h.shape, np.float32)
    lib.a2m_f16_to_f32_buf(h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), _f32p(out), h.size)
    return out


def f32_to_f16_buf(f: np.ndarray) -> np.ndarray:
    lib = _load()
    f = np.ascontiguousarray(f, np.float32)
    out = np.empty(f.shape, np.uint16)
    lib.a2m_f32_to_f16_buf(_f32p(f), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), f.size)
    return out.view(np.float16)


def normalize_loudness(samples: np.ndarray) -> np.ndarray:
    lib = _load()
    buf = np.ascontiguousarray(samples, np.float32).copy()
    lib.a2m_normalize_loudness(_f32p(buf), buf.shape[1])
    return buf


def parse_events_csv(path: str | Path,
                     duration_per_frame: float) -> list[tuple[int, int, int, int]]:
    lib = _load()
    out = ctypes.POINTER(ctypes.c_int32)()
    n = ctypes.c_int64()
    _check(lib.a2m_parse_events_csv(str(path).encode(), duration_per_frame, ctypes.byref(out),
                                    ctypes.byref(n)), f"a2m_parse_events_csv({path})")
    return _take_rows(lib, out, n.value)


def rasterize_events(events, num_frames: int, start_frame: int = 0,
                     backing_frames: int | None = None, num_keys: int = 90) -> np.ndarray:
    lib = _load()
    if backing_frames is None:
        backing_frames = num_frames
    ev = np.ascontiguousarray(np.asarray(events, np.int32).reshape(-1, 4))
    out = np.zeros((num_frames, num_keys), np.float32)
    lib.a2m_rasterize(ev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ev.shape[0],
                      num_frames, start_frame, backing_frames, num_keys, _f32p(out))
    return out


def transform_for_training(audio: np.ndarray, labels: np.ndarray, settings,
                           seed: int = 0) -> None:
    """In place on (B, 2, N) audio and (B, F, K) labels, float32 C order."""
    lib = _load()
    if not (audio.flags.c_contiguous and labels.flags.c_contiguous
            and audio.dtype == np.float32 and labels.dtype == np.float32):
        raise ValueError("transform_for_training takes C-contiguous float32 arrays")
    s = np.asarray(settings.as_tuple(), np.float64)
    _check(lib.a2m_transform_for_training(
        _f32p(audio), _f32p(labels), audio.shape[0], audio.shape[2], labels.shape[1],
        labels.shape[2], s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(settings.parity_pan_uses_channel_switch_probability), seed),
        "a2m_transform_for_training")


def stitch_probs(all_probs: np.ndarray, overlap: float,
                 duration_per_frame: float) -> np.ndarray:
    lib = _load()
    probs = np.ascontiguousarray(all_probs, np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64()
    _check(lib.a2m_stitch_probs(_f32p(probs), *probs.shape, overlap, duration_per_frame,
                                ctypes.byref(out), ctypes.byref(frames)), "a2m_stitch_probs")
    return _take_f32(lib, out, (frames.value, probs.shape[2]))


def extract_events(probs: np.ndarray) -> list[tuple[int, int, int, int]]:
    lib = _load()
    p = np.ascontiguousarray(probs, np.float32)
    out = ctypes.POINTER(ctypes.c_uint32)()
    n = ctypes.c_int64()
    _check(lib.a2m_extract_events(_f32p(p), p.shape[0], p.shape[1], ctypes.byref(out),
                                  ctypes.byref(n)), "a2m_extract_events")
    return _take_rows(lib, out, n.value)
