#!/usr/bin/env python3
"""Times the global attention backward (TPU kernels 9 and 16) of this
checkout beside another checkout's, in turns on one card.

    python3 tools/torch_attention_bwd_turns.py --other DIR [--out OUT]

DIR is a checkout of another commit (for example ``git archive`` of the
parent unpacked into a directory that ``.gitignore`` lists).  Both trees
build their kernels from their own sources, in parallel; then one process
per turn (other, this, this, other) times, on the same seeded inputs, the
kernels at the shapes of ``chip_smoke.py`` phase 2: 32 windows, S = 250,
4 heads x 64 (no mask, precomputed bits, valid_len 200, the seeded mask)
and 16 windows, S = 496, block 16, f32 and bf16, by CUDA events over 50
back-to-back launches, beside F.scaled_dot_product_attention's backward
on the same tensors, and the dq and dk/dv kernels apart (device time per
launch by torch.profiler, no mask and the seeded mask).  Also counts, in
this tree's SASS, each backward kernel's HMMA, LDGSTS, LDSM and atomic
instructions.  Prints one line per case and writes
``attention_bwd_turns.json`` to --out.  Needs one CUDA device; imports no
JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
THRESHOLD = 26  # round(0.1 * 256)


def worker(root: Path) -> None:
    """Times the cases with the package of ``root`` and prints one JSON line."""
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from audio_to_midi_tpu_torch.ops import attention_kernels as ak

    def randn(*shape, seed, dtype):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randn(*shape, generator=gen).to(device="cuda", dtype=dtype)

    def time_ms(fn, iters=50):
        for _ in range(5):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)  # the card waits while the host queues the launches
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    times, profiled = {}, []
    seed = torch.tensor([20260, -7], dtype=torch.int32, device="cuda")
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, g = (randn(32, 250, 256, seed=30 + i, dtype=dt) for i in range(4))
        fq, fk, fv, fg = (randn(16, 496, 256, seed=10 + i, dtype=dt) for i in range(4))
        gen = torch.Generator(device="cpu").manual_seed(40)
        bits = torch.randint(0, 256, (32, 4, 250, 250), generator=gen, dtype=torch.uint8).cuda()
        heads4 = lambda t: t.reshape(t.shape[0], t.shape[1], 4, 64).transpose(1, 2)
        q4, k4, v4 = (heads4(t).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q4, k4, v4)
        out_drop = F.scaled_dot_product_attention(q4, k4, v4, dropout_p=THRESHOLD / 256)
        cases = {
            "grads S=250": lambda: ak.global_attention_grads(q, k, v, g, 4),
            "grads S=250 bits": lambda: ak.global_attention_grads(q, k, v, g, 4, 0, None, bits,
                                                                  THRESHOLD),
            "grads S=250 valid_len=200": lambda: ak.global_attention_grads(q, k, v, g, 4, 0, 200),
            "grads S=496 block=16": lambda: ak.global_attention_grads(fq, fk, fv, fg, 4, 16),
            "grads prng S=250": lambda: ak.global_attention_grads_prng(
                q, k, v, seed, g, 4, threshold=THRESHOLD),
            "grads prng S=250 valid_len=200": lambda: ak.global_attention_grads_prng(
                q, k, v, seed, g, 4, 0, 200, threshold=THRESHOLD),
            "grads prng S=496 block=16": lambda: ak.global_attention_grads_prng(
                fq, fk, fv, seed, fg, 4, 16, threshold=THRESHOLD),
            "SDPA backward S=250": lambda: torch.autograd.grad(out, (q4, k4, v4), heads4(g),
                                                               retain_graph=True),
            "SDPA backward S=250 dropout": lambda: torch.autograd.grad(
                out_drop, (q4, k4, v4), heads4(g), retain_graph=True),
        }
        for case, fn in cases.items():
            times[f"{case} {name}"] = time_ms(fn)
        # Arguments bound now: the lambdas above read this iteration's tensors late.
        profiled += [functools.partial(ak.global_attention_grads, q, k, v, g, 4),
                     functools.partial(ak.global_attention_grads_prng, q, k, v, seed, g, 4,
                                       threshold=THRESHOLD)]
    # The dq and dk/dv kernels apart: device time per launch, by torch.profiler
    # in one session, told apart by their template arguments (dtype, hd 64,
    # mask source 0: none, 2: seeded).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in profiled:
            for _ in range(10):
                fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for kernel in ("dq", "dkv"):
            for name, dtype in (("f32", "float"), ("bf16", "__nv_bfloat16")):
                for case, mask in (("grads S=250", 0), ("grads prng S=250", 2)):
                    if f"global_attention_{kernel}_kernel<{dtype}, 64, {mask}>" in ev.key:
                        us = getattr(ev, "device_time_total", None) or ev.cuda_time_total
                        times[f"{case} {name}, its {kernel} kernel"] = us / ev.count / 1e3
    print(json.dumps(times))


def sass_counts(library: Path) -> dict[str, dict[str, int]]:
    """Per kernel of the global backward in ``library``: its tensor-core
    products (HMMA), asynchronous copies (LDGSTS), ldmatrix loads (LDSM)
    and atomics (ATOM / RED), counted in the SASS that cuobjdump prints."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if "global_attention_d" in name else None
            if name:
                counts[name] = {op: 0 for op in ("HMMA", "LDGSTS", "LDSM", "ATOM/RED")}
        elif name:
            for op in ("HMMA", "LDGSTS", "LDSM"):
                counts[name][op] += f" {op}." in line or f" {op} " in line
            counts[name]["ATOM/RED"] += any(f" {op}" in line for op in ("ATOM", "RED."))
    return counts


def build(root: Path) -> subprocess.Popen:
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            "from audio_to_midi_tpu_torch.ops import cuda_build; cuda_build.build()")
    return subprocess.Popen([sys.executable, "-c", code])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="a checkout of another commit")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "smoke")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available() or args.other is None:
        print("needs a CUDA device and --other", file=sys.stderr)
        return 1
    trees = {"other": args.other.resolve(), "this": ROOT}
    builds = [build(root) for root in trees.values()]
    if any(proc.wait() != 0 for proc in builds):
        print("a build failed", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from audio_to_midi_tpu_torch.ops import cuda_build

    try:
        sass = sass_counts(cuda_build.library_path())
    except (OSError, subprocess.CalledProcessError) as err:
        print(f"sass not counted: {err}")
        sass = {}
    for kernel, ops in sass.items():
        print(f"sass {kernel}: {ops}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    turns = {"other": [], "this": []}
    for label in ("other", "this", "this", "other"):
        run = subprocess.run([sys.executable, __file__, "--worker", str(trees[label])],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        turns[label].append(json.loads(run.stdout.strip().splitlines()[-1]))
    for case in sorted({c for t in turns["this"] + turns["other"] for c in t}, key=str):
        other = [t.get(case) for t in turns["other"]]
        this = [t.get(case) for t in turns["this"]]
        if None in other + this:  # the profiler recorded no such kernel in a turn
            print(f"{case}: other {other} ms; this {this} ms; not recorded in every turn")
            continue
        print(f"{case}: other {other[0]:.4f}, {other[1]:.4f} ms; this {this[0]:.4f}, "
              f"{this[1]:.4f} ms; other / this {sum(other) / sum(this):.2f}")
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "attention_bwd_turns.json").write_text(json.dumps(
        {"card": card, "other": str(args.other), "turns": turns, "sass": sass}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
