"""Builds and loads the port's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, from the package's own sources, into ``build/torch_kernels/``
beside the package; the library's file name carries a hash of the sources
and flags, so an edited source builds anew.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"liba2m_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet.  The
    compiler's output goes to a ``.log`` beside the library."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    target.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    return target


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.a2m_global_attention.argtypes = [ptr] * 4 + [i32] * 6 + [f32, i32, ptr]
    lib.a2m_global_attention.restype = i32
    lib.a2m_local_two_phase.argtypes = [ptr] * 6 + [i32] * 4 + [f32, i32, ptr]
    lib.a2m_local_two_phase.restype = i32
    lib.a2m_error_string.argtypes = [i32]
    lib.a2m_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry returned a nonzero cudaError_t."""
    if code != 0:
        msg = library().a2m_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
