"""Builds and loads the port's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``), one compiler
process per source and all at once, and link into one shared library with a
plain C interface, loaded with ``ctypes``.  The build runs at first use, from
the package's own sources, into ``build/torch_kernels/`` beside the package;
the library's file name carries a hash of the sources and flags, so an
edited source builds anew.  Nothing here runs at import.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    compilers' output goes to a ``.log`` beside the library."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        compiles = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            compiles.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = None
        for cmd, _, proc in compiles:  # wait for every compiler, also after a failure
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0 and failed is None:
                failed = f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{out[-4000:]}"
        if failed is None:
            lib = Path(tmp) / "lib.so"
            cmd = [nvcc, "-shared", "-o", str(lib), *[str(obj) for _, obj, _ in compiles]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed = f"nvcc failed to link ({proc.returncode}):\n{proc.stderr[-4000:]}"
        target.with_suffix(".log").write_text("\n".join(log))
        if failed is not None:
            raise RuntimeError(failed)
        os.replace(lib, target)  # atomic: a concurrent build sees all or nothing
    return target


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # Pointers (inputs, mask sources, outputs), ints, the scale, dtype code, stream.
    entries = {
        "a2m_global_attention": [ptr] * 6 + [i32] * 7 + [f32, i32, ptr],
        "a2m_local_two_phase": [ptr] * 9 + [i32] * 5 + [f32, i32, ptr],
        "a2m_global_attention_grads": [ptr] * 10 + [i32] * 7 + [f32, i32, ptr],
        "a2m_local_two_phase_grads": [ptr] * 14 + [i32] * 5 + [f32, i32, ptr],
        "a2m_philox_dump": [ptr] * 2 + [i32] * 3 + [ptr],
        # q, k, v, out; G, H, S, hd, block.
        "a2m_head_major_attention": [ptr] * 4 + [i32] * 5 + [f32, i32, ptr],
        # q, k, v, cos, sin, workspace, out; G, S, H, hd, block.
        "a2m_rope_attention": [ptr] * 7 + [i32] * 5 + [f32, i32, ptr],
        # carries, dy, 8 weights, dx, 8 gradients, workspace; depth, B, L, C, H, K, dtype.
        "a2m_convnext_stage_bwd": [ptr] * 20 + [i32] * 7 + [ptr],
        # x, 8 weights, out, workspace; depth, B, L, C, H, K, dtype.
        "a2m_convnext_stage_fwd": [ptr] * 11 + [i32] * 7 + [ptr],
        # x, 5 weights, cos, sin, out, workspace; B, P, D, H, hd, C, valid_len,
        # window, table rows; scale, dtype, stream.
        "a2m_attention_block": [ptr] * 10 + [i32] * 9 + [f32, i32, ptr],
        # x, ln, 5 weights, 4 (local) or 2 (global) tables, out, workspace;
        # B, P, D, H, hd, C, S, pad_l; scale, dtype, stream.
        "a2m_fused_local_sublayer": [ptr] * 13 + [i32] * 8 + [f32, i32, ptr],
        "a2m_fused_global_sublayer": [ptr] * 11 + [i32] * 8 + [f32, i32, ptr],
        # x, the arrays of 22 weight and 6 table pointers, out, workspace;
        # B, P, D, H, hd, C, I, S, pad_l; scale, dtype, stream.
        "a2m_transformer_pair": [ptr] * 5 + [i32] * 9 + [f32, i32, ptr],
        # p, fired, attack, duration, final_active, final_started, workspace; N, K; stream.
        "a2m_eventize": [ptr] * 7 + [i32] * 2 + [ptr],
        # x, weights, y; channels, N, out_len; up, down, taps, pad, threads, outputs
        # a block; stream.
        "a2m_resample": [ptr] * 3 + [i64] * 3 + [i32] * 6 + [ptr],
    }
    for name, argtypes in entries.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i32
    # Geometry and dtype -> workspace bytes (0: not taken).
    workspaces = {
        "a2m_convnext_stage_bwd_workspace": 5,     # B, L, C, H, dtype
        "a2m_convnext_stage_fwd_workspace": 5,
        "a2m_attention_block_workspace": 7,        # B, P, D, H, hd, C, dtype
        "a2m_fused_sublayer_workspace": 7,
        "a2m_transformer_pair_workspace": 8,       # B, P, D, H, hd, C, I, dtype
        "a2m_eventize_workspace": 2,               # N, K
    }
    for name, count in workspaces.items():
        getattr(lib, name).argtypes = [i32] * count
        getattr(lib, name).restype = ctypes.c_longlong
    lib.a2m_error_string.argtypes = [i32]
    lib.a2m_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry returned a nonzero cudaError_t."""
    if code != 0:
        msg = library().a2m_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
