#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels,
checks them against their plain versions, runs the full-width model, and
transcribes a synthetic file to MIDI through the port's CLI.

    python3 chip_smoke.py

Needs one CUDA device (Hopper, sm_90a) and nvcc; imports no JAX.  Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. kernels: build from csrc/, then each kernel against its plain version
     at the serving shapes (16 windows, S=250 / P=256, 4 heads x 64), f32
     and bf16, with its time beside the plain version's (CUDA events);
  3. forward: the default model (~11.6 M params) from seeded weights on 16
     seeded windows (16, 2, 80000), kernel path vs plain path, bf16 and f32,
     and 8 launches of each kernel per forward;
  4. end to end: ~30 s of synthetic stereo piano tones written as WAV, the
     seeded weights saved as a port checkpoint, then the CLI
     (file -> MIDI, f32) with its launches counted; the MIDI is read back and
     the stitched probabilities are held against the plain path's.
Prints one JSON line of kernel results, then {"ok": true, "device": ...}
as the last line.  Artifacts go to build/smoke/ in the checkout.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"
BATCH, SEQ, PADDED, HEADS, HEAD_DIM = 16, 250, 256, 4, 64
EVENT_THRESHOLDS = (0.1, 0.4, 0.5)
# Max abs error of a kernel vs its plain version on O(1) inputs.  f32: both
# accumulate in fp32 and differ only in summation order.  bf16: outputs round
# to 8 mantissa bits (one ulp near 1 is 7.8e-3).
KERNEL_TOL = {"f32": 1e-5, "bf16": 2e-2}
# Whole-model probabilities, kernel path vs plain path on the card.  f32 (TF32
# off): per-layer differences of ~1e-6 carried through 16 attention layers.
# bf16: a 1-ulp flip in any of ~60 bf16 roundings per layer moves the
# residual stream by ~1e-2 relative.
FORWARD_TOL = {"f32": 1e-4, "bf16": 5e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of fn() in ms, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def randn(*shape, seed: int, dtype: torch.dtype) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(device="cuda", dtype=dtype)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_kernels(ak) -> dict[str, dict]:
    """Phase 2: each kernel vs its plain version at the serving shapes."""
    width = HEADS * HEAD_DIM
    results = {}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for name, dt in dtypes.items():
        q, k, v = (randn(BATCH, SEQ, width, seed=i, dtype=dt) for i in range(3))
        cases = {
            "global S=250": (lambda q=q, k=k, v=v: ak.global_attention(q, k, v, HEADS),
                             lambda q=q, k=k, v=v: ak.global_attention_plain(q, k, v, HEADS)),
            "global S=250 valid_len=200": (
                lambda q=q, k=k, v=v: ak.global_attention(q, k, v, HEADS, 0, 200),
                lambda q=q, k=k, v=v: ak.global_attention_plain(q, k, v, HEADS, 0, 200)),
        }
        fq, fk, fv = (randn(BATCH, 31 * 16, width, seed=10 + i, dtype=dt) for i in range(3))
        cases["global S=496 block=16"] = (
            lambda: ak.global_attention(fq, fk, fv, HEADS, 16),
            lambda: ak.global_attention_plain(fq, fk, fv, HEADS, 16))
        ts = [randn(BATCH, PADDED, width, seed=20 + i, dtype=dt) for i in range(5)]
        cases["local P=256"] = (lambda: ak.local_two_phase(*ts, HEADS, 16),
                                lambda: ak.local_two_phase_plain(*ts, HEADS, 16))
        for case, (kernel, plain) in cases.items():
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            err = max_err(out, ref)
            ok = bool(torch.isfinite(out.float()).all()) and err <= KERNEL_TOL[name]
            ms, plain_ms = time_ms(kernel), time_ms(plain)
            log(f"kernel {case} {name}: max_abs_err {err:.3e} (tol {KERNEL_TOL[name]:.0e}) "
                f"{'OK' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if not ok:
                raise AssertionError(f"kernel {case} {name} disagrees with its plain version")
            results[f"{case} {name}"] = {"err": err, "ms": ms, "plain_ms": plain_ms}
    return results


def check_forward(ak, model_lib, cfg, model) -> None:
    """Phase 3: full-width forward, kernel path vs plain path, 8 launches."""
    from audio_to_midi_tpu_torch.infer import _parity_precision

    plain_cfg = dataclasses.replace(cfg.model, attention_impl="xla")
    rope = model_lib.make_rope(cfg.model, "cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    audio = (torch.randn(BATCH, 2, 80_000, generator=gen) * 0.5).cuda()
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        m = model if dt == torch.float32 else model_lib.cast_params(copy.deepcopy(model), dt)
        x = audio.to(dt)
        with torch.inference_mode(), _parity_precision(dt):
            for fn in ak.KERNELS:
                fn.launches = 0
            t0 = time.perf_counter()
            _, probs = model_lib.forward(m, cfg.model, x, rope)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = [fn.launches for fn in ak.KERNELS]
            _, ref = model_lib.forward(m, plain_cfg, x, rope)
        err = max_err(probs, ref)
        ok = (tuple(probs.shape) == (BATCH, SEQ, cfg.model.output_vocab)
              and bool(torch.isfinite(probs.float()).all()) and err <= FORWARD_TOL[name])
        log(f"forward {name} {tuple(x.shape)} -> {tuple(probs.shape)}: kernel vs plain "
            f"max_abs_err {err:.3e} (tol {FORWARD_TOL[name]:.0e}), launches "
            f"{dict(zip((fn.__name__ for fn in ak.KERNELS), launches))}, "
            f"first-call wall {wall:.3f} s {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} forward: kernel path disagrees with the plain path")
        expected = [cfg.model.num_transformer_layers] * len(ak.KERNELS)
        if launches != expected:
            raise AssertionError(f"{name} forward launched {launches}, expected {expected}")
        if name == "f32":
            log(f"forward f32 probs mean {probs.mean().item():.4f} "
                f"min {probs.min().item():.4f} max {probs.max().item():.4f}")


def synth_audio(seconds: float, rate: int, seed: int) -> np.ndarray:
    """Stereo decaying sines at a few piano pitches, one note every 0.5 s."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    out = np.zeros((2, n), np.float64)
    for start in np.arange(0.0, seconds - 1.0, 0.5):
        key = int(rng.integers(30, 70))  # piano key index (MIDI key - 21)
        freq = 440.0 * 2 ** ((key + 21 - 69) / 12)
        since = np.maximum(t - start, 0.0)
        tone = np.where(t >= start, np.exp(-since * 3.0), 0.0) * np.sin(2 * np.pi * freq * since)
        pan = rng.uniform(0.3, 0.7)
        out[0] += pan * tone
        out[1] += (1 - pan) * tone
    return (0.5 * out / np.abs(out).max()).astype(np.float32)


def end_to_end(ak, model_lib, cfg, model, card: str) -> dict[str, int]:
    """Phase 4: WAV -> CLI -> MIDI; returns the launches of that run."""
    from audio_to_midi_tpu_torch import convert
    from audio_to_midi_tpu_torch.cli.audio_to_midi import main as cli_main
    from audio_to_midi_tpu_torch.data.audio_io import write_wav
    from audio_to_midi_tpu_torch.infer import transcribe_file
    from audio_to_midi_tpu_torch.ops.midi_io import read_midi_file

    WORK.mkdir(parents=True, exist_ok=True)
    wav, ckpt, mid = WORK / "synth.wav", WORK / "params.npz", WORK / "out.mid"
    write_wav(wav, synth_audio(30.0, cfg.data.sample_rate, seed=2), cfg.data.sample_rate)
    convert.save_npz(ckpt, convert.state_dict_to_jax(model.state_dict()))

    for fn in ak.KERNELS:
        fn.launches = 0
    captured = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = cli_main([str(wav), str(mid), "--checkpoint", str(ckpt)])
    torch.cuda.synchronize()
    cli_wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ak.KERNELS}
    cli_out = captured.getvalue()
    log("cli: " + " | ".join(cli_out.strip().splitlines()))
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    n_events = int(cli_out.split("Extracted ")[1].split()[0])

    midi = read_midi_file(mid)
    ons = sum(1 for e in midi if e[1] == "note_on")
    offs = sum(1 for e in midi if e[1] == "note_off")
    metas = {e[1] for e in midi if e[1].startswith("meta_")}
    log(f"midi: {mid.name} {mid.stat().st_size} bytes, {ons} note_on, {offs} note_off, "
        f"metas {sorted(metas)}")
    if ons != n_events or offs != n_events or not {"meta_51", "meta_58"} <= metas:
        raise AssertionError("MIDI read back does not hold the events the CLI extracted")

    # The same file through the kernel path (warm) and the plain path.
    from audio_to_midi_tpu_torch.infer import load_params

    m32 = load_params(ckpt, cfg, "cuda", torch.float32)
    t0 = time.perf_counter()
    stitched, _dpf, events = transcribe_file(m32, cfg, wav)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attention_impl="xla"))
    ref, _, ref_events = transcribe_file(m32, plain_cfg, wav)
    err = float(np.abs(stitched - ref).max())
    near = min(float(np.abs(ref - t).min()) for t in EVENT_THRESHOLDS)
    log(f"transcribe: stitched {stitched.shape}, {len(events)} events, kernel vs plain "
        f"stitched max_abs_err {err:.3e} (tol {FORWARD_TOL['f32']:.0e}), events identical "
        f"{events == ref_events} (closest prob to a threshold {near:.2e})")
    if stitched.shape[1] != cfg.model.output_vocab or not np.isfinite(stitched).all():
        raise AssertionError("stitched probabilities are not finite (frames, 90)")
    if err > FORWARD_TOL["f32"]:
        raise AssertionError("end-to-end kernel path disagrees with the plain path")
    if near > FORWARD_TOL["f32"] and events != ref_events:
        raise AssertionError("events differ though no probability is near a threshold")
    if len(events) != n_events:
        raise AssertionError("the CLI and transcribe_file extracted different events")
    audio_s = 30.0
    log(f"e2e wall: CLI {cli_wall:.3f} s (cold: checkpoint load + first call), "
        f"transcribe_file {warm_wall:.3f} s warm for {audio_s:.0f} s of audio "
        f"({audio_s / warm_wall:.1f}x realtime), f32, on {card}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.ops import attention_kernels as ak
    from audio_to_midi_tpu_torch.ops import cuda_build

    card = card_line()
    log(card)  # nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    lib = cuda_build.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    kernel_results = check_kernels(ak)

    cfg = DEFAULT_CONFIG
    model = model_lib.Model(cfg.model, torch.Generator().manual_seed(0)).cuda().eval()
    log(f"model: {model_lib.param_count(model):,} params, dims {cfg.model.dims}, "
        f"depths {cfg.model.depths}, {cfg.model.num_transformer_layers} pairs")
    check_forward(ak, model_lib, cfg, model)
    launches = end_to_end(ak, model_lib, cfg, model, card)
    log(f"main-path launches: {launches}")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the path was never launched: {launches}")

    sources = {
        "global_attention": ("audio_to_midi_tpu_torch/csrc/global_attention.cu",
                             "audio_to_midi_tpu/ops/pallas_attention.py:140", "global S=250 f32"),
        "local_two_phase": ("audio_to_midi_tpu_torch/csrc/local_attention.cu",
                            "audio_to_midi_tpu/ops/pallas_attention.py:608", "local P=256 f32"),
    }
    kernels = []
    for name, (source, replaces, case) in sources.items():
        r = kernel_results[case]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "case": case})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
