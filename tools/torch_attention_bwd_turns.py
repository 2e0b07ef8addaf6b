#!/usr/bin/env python3
"""Times the kernels of this checkout beside another checkout's, in turns
on one card: the global attention forward (TPU kernels 1, 3, 4 and 15, and
10 beside them) and backward (9 and 16), the local two-phase forward (2, 12
and 5) and backward (7, 13 and 8), the ConvNeXt stage kernels (20 and 19),
the Philox bits dump (14), the fused transformer-layer kernels (11, 18 and
17), and the serving forward of the model by attention route.

    python3 tools/torch_attention_bwd_turns.py --other DIR [--out OUT]
        [--cases PREFIX ...]

DIR is a checkout of another commit (for example ``git archive`` of the
parent unpacked into a directory that ``.gitignore`` lists).  Both trees
build their kernels from their own sources, in parallel; then one process
per turn (other, this, this, other) runs, on the same seeded inputs:
  * the forward kernels at S = 250, 4 heads x 64, f32 and bf16: kernel 1
    (``global_attention``) and kernel 3 (``head_major_attention``, on the
    head-major copies) at 16, 32 and 128 windows, beside
    F.scaled_dot_product_attention on the same tensors; kernel 1 at 16
    windows of S = 496 with block 16 and without a block; kernels 15 and 4
    (the seeded and the precomputed-bits dropout forms) at 32 windows, S =
    250 with and without valid_len 200, and at 16 windows of S = 496 with
    block 16, beside SDPA with dropout_p = 26/256; kernel 10
    (``rope_attention``) at 16, beside the "pallas" route's rope on q and k
    then kernel 1 (``forward after rope``), whose bits kernel 10 must give;
  * the backward kernels at the shapes of ``chip_smoke.py`` phase 2: 32
    windows, S = 250 (no mask, precomputed bits, valid_len 200, the seeded
    mask), S = 65, and 16 windows, S = 496, block 16, beside SDPA's
    backward; the dq and dk/dv kernels apart (device time per launch by
    torch.profiler, no mask and the seeded mask);
  * the local two-phase forward at 16, 32 and 128 windows, P = 256: kernel
    2 (``local P=256``), 12 (``local dropout``, the seeded mask), 5
    (``local dropout bits``, random bits) and 6 (``local rw``, on kernel 2's
    tensors), and each one's device time per launch by torch.profiler, one
    profile per case;
  * the local two-phase backward at the training shapes, 32 windows, P =
    256: kernel 7 (no mask), 13 (the seeded mask) and 8 (random bits), and
    each one's device time per launch by torch.profiler;
  * kernel 20 (``stage_bwd``) at stages 5 and 6 of the default model, 32
    windows, f32 and bf16, beside autograd through the plain block loop;
    the device time of each of the ten launches of one stage-5 block (the
    products against the row kernels, torch.profiler over 10 calls); kernel
    19 (``stage_fwd``) at stages 4, 5 and 6, 16 windows, beside the loop's
    forward, and the device time of each of the three launches of one
    stage-5 block (``row kernel``, ``GELU product``, ``residual product``,
    by the same names in either tree);
  * kernel 14 (``philox_bits``) at (32, 4, 250, 250) and (32, 8, 256, 256),
    beside torch.randint of the same shape;
  * the fused transformer-layer kernels at the default widths (D 256, 4
    heads x 64, kv 64, FFN 512; S = 250 -> P = 256, pad_l 3) at 16 and 128
    windows, f32 and bf16: kernel 11 (``attention block local P=256``,
    ``attention block global S=250``), 18 (``fused local|global sublayer``)
    and 17 (``transformer pair``), and the device time of each of an entry's
    launches by kernel name (products, LayerNorm, GLU, local and global
    core), torch.profiler over 10 calls, one session per case;
  * the serving forward of the default model (seeded weights) by
    attention_impl ("pallas", "pallas_block", "pallas_fused",
    "pallas_pair"), and "pallas" with cnn_impl "pallas_stage" (kernel 19 in
    stages 4, 5, 6), at 16 and 128 windows, bf16 and f32: the median and
    quartiles of 20 forwards, each timed by CUDA events, then 3 forwards
    under torch.profiler: device busy time, the idle share against the
    median, the global and the local attention's and the fused layers'
    shares of device time, the largest kernels.
Kernels by CUDA events over 50 back-to-back launches.  ``--cases`` keeps
only the kernel cases whose names start with one of the prefixes (for
example ``"local grads"``), and then skips the serving forward.  Each turn also hashes
(SHA-256) the bytes of every kernel output; the tool compares the trees'
hashes and exits 1 where a tree does not repeat its own bits, where two
builds of kernels whose outputs must not change give different bits --
against the tree before kernel 19's products moved to the tensor cores and
kernel 6 onto kernel 2's body, every kernel but 19 and 6; against the tree
before kernel 10 moved onto kernel 1's body, every kernel but 10 (SAME_CODE)
-- or where kernel 6 does not give kernel 2's bits, or kernel 10 kernel 1's
on the same roped rows, in this tree.  From the two
builds it reports, per instantiation of the global attention kernels, the
local forward and backward, the tensor-core product (``mma_gemm_kernel``:
kernel 20's, kernel 19's and the fused layers'), the stage kernels' row
kernels and the fused layers' global core and RoPE pass, the SASS counts
of HMMA (tensor core products), LDGSTS (cp.async copies), LDSM (ldmatrix)
and FFMA, and the registers and spill bytes ``-Xptxas -v`` wrote to the
build log; it exits 1 where the SASS of such a kernel that both trees build
differs (SAME_SASS), and names the instantiations that only one tree builds
(new, or gone).  Prints one line per case and writes
``attention_turns.json`` to --out.  Needs one CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
THRESHOLD = 26  # round(0.1 * 256)
# The cases (by their first words) whose outputs must agree bit for bit with
# the other tree's, against the tree before kernel 10 moved onto kernel 1's
# body: kernels 1 ("forward", and "forward after rope": kernel 1 on the rows
# the "pallas" route ropes), 3 ("head major"), 4 and 15 ("dropout"), 9 and
# 16 ("grads"), 2, 12 and 5 ("local P=256", "local dropout"), 6 ("local
# rw"), 7, 13 and 8 ("local grads"), 14 ("philox bits"), 20 and 19 ("stage
# bwd", "stage fwd") and 11, 18 and 17 ("attention block", "fused",
# "transformer pair").  Kernel 10 ("rope") may differ from the other tree;
# it must repeat itself and give kernel 1's bits on the roped rows
# (ROPE_AS_KERNEL_1), as kernel 6 gives kernel 2's (RW_AS_KERNEL_2).
SAME_CODE = ("forward", "head major", "dropout", "grads", "local P=256", "local dropout",
             "local rw", "local grads", "philox bits", "stage bwd", "stage fwd",
             "attention block", "fused", "transformer pair")
# Kernel 6's case and kernel 2's on the same tensors, and kernel 10's and
# kernel 1's on the rows rope_with gives, whose bits this tree must make equal.
RW_AS_KERNEL_2 = ("local rw P=256", "local P=256")
ROPE_AS_KERNEL_1 = ("rope S=250 B=16", "forward after rope S=250 B=16")
# Cases timed beside a kernel and never hashed: library calls and the paths
# the kernels replace.
NOT_HASHED = ("SDPA", "library")
# (depth, L, C, H) of the ConvNeXt stages of the default model that kernel
# 19 takes (cnn_impl "pallas_stage"); kernel 20 takes 5 and 6.
STAGES = {4: (3, 1000, 64, 128), 5: (21, 500, 128, 256), 6: (3, 250, 256, 512)}
BWD_STAGES = (5, 6)


def worker(root: Path, only: list[str] | None) -> None:
    """Times the cases with the package of ``root`` (those whose names start
    with a prefix in ``only``, if given) and prints one JSON line."""
    sys.path.insert(0, str(root))
    import copy
    import dataclasses

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.models.rope import precompute_frequencies, rope_with
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

    def digest(out) -> str:
        sha = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            sha.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
        return sha.hexdigest()

    def selected(case: str) -> bool:
        return not only or case.startswith(tuple(only))

    times, digests, profiled = {}, {}, []
    seed = torch.tensor([20260, -7], dtype=torch.int32, device="cuda")
    heads4 = lambda t: t.reshape(t.shape[0], t.shape[1], 4, 64).transpose(1, 2)
    freqs = precompute_frequencies(64, 250, device="cuda")
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cases = {}
        # --- the forward kernels ---
        for n in (16, 32, 128):
            fq_, fk_, fv_ = (randn(n, 250, 256, seed=n + i, dtype=dt) for i in range(3))
            hq, hk, hv = (heads4(t).contiguous() for t in (fq_, fk_, fv_))
            cases |= {
                f"forward S=250 B={n}": functools.partial(ak.global_attention, fq_, fk_, fv_, 4),
                f"head major S=250 B={n}": functools.partial(ak.head_major_attention, hq, hk, hv),
                f"SDPA forward S=250 B={n}": functools.partial(
                    F.scaled_dot_product_attention, hq, hk, hv),
            }
        bq, bk, bv = (randn(16, 496, 256, seed=60 + i, dtype=dt) for i in range(3))
        cases |= {
            "forward S=496 block=16 B=16": functools.partial(ak.global_attention, bq, bk, bv, 4,
                                                             16),
            "forward S=496 B=16": functools.partial(ak.global_attention, bq, bk, bv, 4),
        }
        q, k, v, g = (randn(32, 250, 256, seed=30 + i, dtype=dt) for i in range(4))
        fq, fk, fv, fg = (randn(16, 496, 256, seed=10 + i, dtype=dt) for i in range(4))
        rq, rk, rv, rg = (randn(32, 65, 256, seed=70 + i, dtype=dt) for i in range(4))
        gen = torch.Generator(device="cpu").manual_seed(40)
        bits = torch.randint(0, 256, (32, 4, 250, 250), generator=gen, dtype=torch.uint8).cuda()
        bits496 = torch.randint(0, 256, (16, 4, 496, 496), generator=gen,
                                dtype=torch.uint8).cuda()
        sq, sk, sv = (randn(16, 250, 256, seed=90 + i, dtype=dt) for i in range(3))
        drop, drop_bits = ak.global_attention_dropout, ak.global_attention_dropout_bits
        cases |= {
            "dropout prng S=250 B=32": functools.partial(drop, q, k, v, seed, 4,
                                                         threshold=THRESHOLD),
            "dropout bits S=250 B=32": functools.partial(drop_bits, q, k, v, bits, 4,
                                                         threshold=THRESHOLD),
            "dropout prng S=250 valid_len=200 B=32": functools.partial(
                drop, q, k, v, seed, 4, 0, 200, threshold=THRESHOLD),
            "dropout bits S=250 valid_len=200 B=32": functools.partial(
                drop_bits, q, k, v, bits, 4, 0, 200, threshold=THRESHOLD),
            "dropout prng S=496 block=16 B=16": functools.partial(
                drop, fq, fk, fv, seed, 4, 16, threshold=THRESHOLD),
            "dropout bits S=496 block=16 B=16": functools.partial(
                drop_bits, fq, fk, fv, bits496, 4, 16, threshold=THRESHOLD),
            "SDPA forward dropout S=250 B=32": functools.partial(
                F.scaled_dot_product_attention, *(heads4(t) for t in (q, k, v)),
                dropout_p=THRESHOLD / 256),
            "rope S=250 B=16": functools.partial(ak.rope_attention, sq, sk, sv, freqs.cos,
                                                 freqs.sin, 4),
            # The "pallas" route: rope_with on q and k, then kernel 1.
            "forward after rope S=250 B=16": functools.partial(
                lambda q_, k_, v_: ak.global_attention(
                    *(rope_with(t.reshape(16, 250, 4, 64), freqs.cos, freqs.sin).reshape(t.shape)
                      for t in (q_, k_)), v_, 4), sq, sk, sv),
        }
        # --- the backward kernels ---
        q4, k4, v4 = (heads4(t).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q4, k4, v4)
        out_drop = F.scaled_dot_product_attention(q4, k4, v4, dropout_p=THRESHOLD / 256)
        grads = ak.global_attention_grads
        prng = functools.partial(ak.global_attention_grads_prng, threshold=THRESHOLD)
        cases |= {
            "grads S=250": functools.partial(grads, q, k, v, g, 4),
            "grads S=250 bits": functools.partial(grads, q, k, v, g, 4, 0, None, bits, THRESHOLD),
            "grads S=250 valid_len=200": functools.partial(grads, q, k, v, g, 4, 0, 200),
            "grads S=496 block=16": functools.partial(grads, fq, fk, fv, fg, 4, 16),
            "grads S=65": functools.partial(grads, rq, rk, rv, rg, 4),
            "grads prng S=250": functools.partial(prng, q, k, v, seed, g, 4),
            "grads prng S=250 valid_len=200": functools.partial(prng, q, k, v, seed, g, 4, 0, 200),
            "grads prng S=496 block=16": functools.partial(prng, fq, fk, fv, seed, fg, 4, 16),
            "grads prng S=65": functools.partial(prng, rq, rk, rv, seed, rg, 4),
            "SDPA backward S=250": lambda out=out, q4=q4, k4=k4, v4=v4, g=g: torch.autograd.grad(
                out, (q4, k4, v4), heads4(g), retain_graph=True),
            "SDPA backward S=250 dropout": lambda out=out_drop, q4=q4, k4=k4, v4=v4, g=g:
                torch.autograd.grad(out, (q4, k4, v4), heads4(g), retain_graph=True),
        }
        # Kernels 7, 13 and 8 at the training shapes.
        ts = [randn(32, 256, 256, seed=50 + i, dtype=dt) for i in range(6)]
        lbits = torch.randint(0, 256, (2, 32, 4, 256, 256), generator=gen,
                              dtype=torch.uint8).cuda()
        cases |= {
            "local grads P=256": functools.partial(ak.local_two_phase_grads, *ts, 4, 16),
            "local grads prng P=256": functools.partial(
                ak.local_two_phase_grads_prng, *ts[:5], seed, ts[5], 4, 16, threshold=THRESHOLD),
            "local grads bits P=256": functools.partial(
                ak.local_two_phase_grads_bits, *ts[:5], lbits[0], lbits[1], ts[5], 4, 16,
                threshold=THRESHOLD),
        }
        # Kernels 2, 12 and 5 at 16, 32 and 128 windows, P = 256.
        fgen = torch.Generator(device="cpu").manual_seed(43)
        for n in (16, 32, 128):
            fts = [randn(n, 256, 256, seed=100 + n + i, dtype=dt) for i in range(5)]
            fbits = torch.randint(0, 256, (2, n, 4, 256, 256), generator=fgen,
                                  dtype=torch.uint8).cuda()
            cases |= {
                f"local P=256 B={n}": functools.partial(ak.local_two_phase, *fts, 4, 16),
                f"local rw P=256 B={n}": functools.partial(ak.local_two_phase_rw, *fts, 4, 16),
                f"local dropout P=256 B={n}": functools.partial(
                    ak.local_two_phase_dropout, *fts, seed, 4, 16, threshold=THRESHOLD),
                f"local dropout bits P=256 B={n}": functools.partial(
                    ak.local_two_phase_dropout_bits, *fts, fbits[0], fbits[1], 4, 16,
                    threshold=THRESHOLD),
            }
        for n in (16, 128):
            cases |= fused_cases(n, dt, randn)
        cases = {case: fn for case, fn in cases.items() if selected(case)}
        for case, fn in cases.items():
            if not case.startswith(NOT_HASHED):
                digests[f"{case} {name}"] = digest(fn())
            times[f"{case} {name}"] = time_ms(fn)
        profiled += [cases[c] for c in PROFILED if c in cases]
        # The local forward's device time per launch, one profiler session per
        # case: its three geometries launch the same kernel instantiation.
        for case, fn in cases.items():
            if not case.startswith(("local P=256", "local dropout", "local rw")):
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            us = sum(ev.device_time_total for ev in prof.key_averages()
                     if re.search(LOCAL_FORWARD_KERNEL, ev.key))
            times[f"{case} {name}, per launch"] = us / 10 / 1e3
        # The fused layers' device time per call, kernel by kernel, one
        # profiler session per case (kernel names are the tree's own).
        for case, fn in cases.items():
            if not case.startswith(FUSED_CASES):
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                if ev.device_time_total > 0 and "a2m::" in ev.key:
                    times[f"{case} {name}, {short(ev.key)} x{ev.count // 10}"] = (
                        ev.device_time_total / 10 / 1e3)
        del cases
        torch.cuda.empty_cache()
        if selected("stage"):
            convnext_cases(name, dt, times, digests, time_ms, digest)
    # Kernel 14 at the bits route's two geometries (the global attention's
    # 4 heads at S = 250, the two-phase local attention's 2 x 4 at P = 256),
    # beside torch.randint of the same shape.
    for samples, cores, p_len in ((32, 4, 250), (32, 8, 256)):
        if not selected("philox bits"):
            break
        shape = (samples, cores, p_len, p_len)
        bits_case = functools.partial(ak.philox_bits, seed, samples, cores, p_len)
        digests[f"philox bits {shape}"] = digest(bits_case())
        times[f"philox bits {shape}"] = time_ms(bits_case)
        times[f"library randint {shape}"] = time_ms(functools.partial(
            torch.randint, 0, 256, shape, dtype=torch.uint8, device="cuda"))
    # Device time per launch, by torch.profiler in one session: the global
    # backward's dq and dk/dv kernels apart, and the local backward's kernel,
    # told apart by their template arguments (dtype, hd 64, mask source 0:
    # none, 1: bits, 2: seeded; the local kernel's rows per block follow).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in profiled:
            for _ in range(10):
                fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for name, dtype in (("f32", "float"), ("bf16", "__nv_bfloat16")):
            for kernel in ("dq", "dkv"):
                for case, mask in (("grads S=250", 0), ("grads prng S=250", 2)):
                    if f"global_attention_{kernel}_kernel<{dtype}, 64, {mask}>" in ev.key:
                        us = ev.device_time_total
                        times[f"{case} {name}, its {kernel} kernel"] = us / ev.count / 1e3
            for case, mask in (("local grads P=256", 0), ("local grads bits P=256", 1),
                               ("local grads prng P=256", 2)):
                if re.search(rf"local_two_phase_grads_kernel<{dtype}, 64, {mask}[,>]", ev.key):
                    times[f"{case} {name}, per launch"] = ev.device_time_total / ev.count / 1e3
    serving = {}
    if only:
        print(json.dumps({"times": times, "digests": digests, "serving": serving}))
        return
    # The serving forward by attention route at 16 and 128 windows, the
    # median and quartiles of 20 forwards timed one by one.
    base = DEFAULT_CONFIG.model
    model = model_lib.Model(base, torch.Generator().manual_seed(0)).cuda().eval()
    rope = model_lib.make_rope(base, "cuda")
    gen = torch.Generator(device="cpu").manual_seed(5)
    windows = torch.randn(128, 2, 80_000, generator=gen) * 0.5
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        m = model if dt == torch.float32 else model_lib.cast_params(copy.deepcopy(model), dt)
        for n in (16, 128):
            x = windows[:n].to(device="cuda", dtype=dt)
            for impl in SERVING_ROUTES:
                cfg = (dataclasses.replace(base, cnn_impl=impl) if impl == "pallas_stage"
                       else dataclasses.replace(base, attention_impl=impl))
                serving[f"serving forward {impl} {n} windows {name}"] = serving_forward(
                    m, cfg, x, rope)
            del x
        del m
        torch.cuda.empty_cache()
    print(json.dumps({"times": times, "digests": digests, "serving": serving}))


def serving_forward(model, cfg, x, rope) -> dict:
    """The median and quartiles of 20 forwards (CUDA events, after 3), then
    where the device time of 3 profiled forwards goes: busy time, the idle
    share against the median, the attention kernels' and the fused layers'
    shares, the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_to_midi_tpu_torch.infer import _parity_precision
    from audio_to_midi_tpu_torch.models import model as model_lib

    per = []
    with torch.inference_mode(), _parity_precision(x.dtype):
        for i in range(23):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model_lib.forward(model, cfg, x, rope)
            end.record()
            torch.cuda.synchronize()
            if i >= 3:  # warm-up
                per.append(start.elapsed_time(end))
    q1, median, q3 = statistics.quantiles(per, n=4)
    with torch.inference_mode(), _parity_precision(x.dtype), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model_lib.forward(model, cfg, x, rope)
        torch.cuda.synchronize()
    kernels = {ev.key: ev.self_device_time_total / 3e3 for ev in prof.key_averages()
               if ev.self_device_time_total > 0}
    busy = sum(kernels.values())
    share = lambda pattern: sum(ms for key, ms in kernels.items() if re.search(pattern, key))
    attention, local, fused = (share(r"global_attention_fwd_kernel<"),
                               share(LOCAL_FORWARD_KERNEL), share(r"a2m::fl::"))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"median": median, "q1": q1, "q3": q3, "device_busy_ms": busy,
            "idle_share": 1 - busy / median, "global_attention_ms": attention,
            "global_attention_share": attention / busy, "local_attention_ms": local,
            "local_attention_share": local / busy, "fused_layers_ms": fused,
            "fused_layers_share": fused / busy,
            "top_kernels": [(key[:120], ms / busy) for key, ms in top]}


def fused_cases(n: int, dt, randn) -> dict:
    """Kernels 11, 18 and 17 at the default widths on n windows of S = 250
    (P = 256, pad_l 3): a seeded pair with its LayerNorms off the identity,
    as ``chip_smoke.py`` phase 2 makes it."""
    import torch
    import torch.nn.functional as F

    from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG
    from audio_to_midi_tpu_torch.models import attention as attn_lib
    from audio_to_midi_tpu_torch.models import model as model_lib
    from audio_to_midi_tpu_torch.models import transformer as tf_lib
    from audio_to_midi_tpu_torch.ops import fused_layer_kernels as flk

    c = DEFAULT_CONFIG.model
    gen = torch.Generator().manual_seed(71)
    pair = tf_lib.AlternatingLayer(c, gen)
    with torch.no_grad():
        for pname, prm in pair.named_parameters():
            if "norm" in pname:
                prm.add_(0.1 * torch.randn(prm.shape, generator=gen))
    pair = pair.cuda()
    rope = model_lib.make_rope(c, "cuda")
    seq, window, heads = 250, c.local_context_window, c.num_transformer_heads
    pad_l, pad_r = attn_lib._local_padding(seq, window)
    p_len = seq + pad_l + pad_r
    tables = tf_lib._pair_rope_tables(rope, c, p_len, pad_l)
    x = randn(n, seq, c.transformer_hidden_dim, seed=72 + n, dtype=dt)
    xp = F.pad(x, (0, 0, pad_l, pad_r))
    att = pair.get_submodule("local").attention
    ws = [lin.w.to(dt) for lin in (att.q_up, att.kv_down, att.k_up, att.v_up, att.out)]
    cos_w, sin_w = attn_lib._rope_tables(rope, (p_len // (window // 2) - 1) * window, window)
    cos_g, sin_g = attn_lib._rope_tables(rope, seq, 0)
    geometry = dict(num_heads=heads, valid_len=seq, pad_l=pad_l)
    sub = lambda side: flk.sublayer_weights(pair.get_submodule(side), dt)
    return {
        f"attention block local P=256 B={n}": functools.partial(
            flk.attention_block, xp, *ws, cos_w, sin_w, heads, p_len, window),
        f"attention block global S=250 B={n}": functools.partial(
            flk.attention_block, x, *ws, cos_g, sin_g, heads, seq, 0),
        f"fused local sublayer P=256 B={n}": functools.partial(
            flk.fused_local_sublayer, xp, sub("local"), tables[:4], window=window, **geometry),
        f"fused global sublayer P=256 B={n}": functools.partial(
            flk.fused_global_sublayer, xp, sub("global"), tables[4:], **geometry),
        f"transformer pair P=256 B={n}": functools.partial(
            flk.transformer_pair, xp, flk.pair_weights(pair, dt), tables, window=window,
            **geometry),
    }


def stage_operands(depth, b, l, c, hidden, dtype, seed):
    """Seeded (carries, weights, dy) of a ConvNeXt stage on the card, as
    ``chip_smoke.py`` makes them: weights at the init's scales, gamma in
    (0.5, 1.5), a LayerNorm off the identity."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    uni = lambda scale, *shape: (torch.rand(*shape, generator=gen) * 2 - 1) * scale
    normal = lambda *shape: torch.randn(*shape, generator=gen)
    weights = (uni(7 ** -0.5, depth, 7, c), uni(7 ** -0.5, depth, 1, c),
               torch.stack([1 + 0.1 * normal(depth, c), 0.1 * normal(depth, c)], 1),
               uni(c ** -0.5, depth, c, hidden), uni(c ** -0.5, depth, 1, hidden),
               uni(hidden ** -0.5, depth, hidden, c), uni(hidden ** -0.5, depth, 1, c),
               0.5 + torch.rand(depth, 1, c, generator=gen))
    weights = tuple((w.to(dtype).float() if i == 2 else w.to(dtype)).cuda().contiguous()
                    for i, w in enumerate(weights))   # 2: ln stays fp32
    return (normal(depth, b, l, c).to(device="cuda", dtype=dtype), weights,
            normal(b, l, c).to(device="cuda", dtype=dtype))


def convnext_cases(name, dt, times, digests, time_ms, digest) -> None:
    """Kernel 20 at stages 5 and 6, 32 windows, beside autograd through the
    plain block loop; kernel 19 at stages 4, 5 and 6, 16 windows, beside the
    loop's forward; and the device time of each of the ten launches of one
    stage-5 block of kernel 20 and of the three of kernel 19 (torch.profiler,
    10 calls), as ``<kernel> ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_to_midi_tpu_torch.ops import convnext_kernels as ck

    flat = lambda out: (out[0], *out[1])   # (dx, grads) -> the nine outputs
    for stage in BWD_STAGES:
        depth, l, c, hidden = STAGES[stage]
        carries, weights, dy = stage_operands(depth, 32, l, c, hidden, dt, seed=60 + stage)
        kernel = functools.partial(lambda *a: flat(ck.stage_bwd(*a)), carries, weights, dy)
        digests[f"stage bwd stage {stage} B=32 {name}"] = digest(kernel())
        times[f"stage bwd stage {stage} B=32 {name}"] = time_ms(kernel)
        leaves = [t.clone().requires_grad_() for t in (carries[0].contiguous(), *weights)]
        looped = ck.plain_stage(leaves[0], leaves[1:])
        times[f"library autograd stage {stage} B=32 {name}"] = time_ms(
            lambda: torch.autograd.grad(looped, leaves, dy, retain_graph=True))
        del carries, weights, dy, leaves, looped
        torch.cuda.empty_cache()
    for stage, (depth, l, c, hidden) in STAGES.items():
        carries, weights, _ = stage_operands(depth, 16, l, c, hidden, dt, seed=60 + stage)
        x = carries[0].contiguous()
        digests[f"stage fwd stage {stage} B=16 {name}"] = digest(ck.stage_fwd(x, weights))
        times[f"stage fwd stage {stage} B=16 {name}"] = time_ms(
            functools.partial(ck.stage_fwd, x, weights))

        def loop_forward():
            with torch.no_grad():
                return ck.plain_stage(x, weights)
        times[f"library block loop stage {stage} B=16 {name}"] = time_ms(loop_forward)
        del carries, weights, x
    depth, l, c, hidden = STAGES[5]
    for what, batch in (("bwd", 32), ("fwd", 16)):
        carries, weights, dy = stage_operands(1, batch, l, c, hidden, dt, seed=7)
        call = (functools.partial(ck.stage_bwd, carries, weights, dy) if what == "bwd"
                else functools.partial(ck.stage_fwd, carries[0].contiguous(), weights))
        call()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "a2m::cnx" in ev.key:   # the block's launches, and nothing of PyTorch's
                label = short(ev.key) if what == "bwd" else stage_fwd_launch(ev.key)
                times[f"stage {what} one stage-5 block {name}, {label}"] = (
                    ev.device_time_total / 10 / 1e3)
        del carries, weights, dy
    torch.cuda.empty_cache()


def stage_fwd_launch(kernel: str) -> str:
    """The part of kernel 19's block a launch is, by the same name in a tree
    of any design: the row kernel (conv + LayerNorm), the GELU product or
    the residual product."""
    if "Gelu" in kernel:
        return "GELU product"
    if "Residual" in kernel:
        return "residual product"
    return "row kernel" if "conv_ln" in kernel else short(kernel)


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names
    return out if len(out) == len(names) else names


def short(name: str) -> str:
    """``void (anonymous namespace)::global_attention_fwd_kernel<float, (int)64,
    (int)0>(...)`` -> ``global_attention_fwd_kernel<float, 64, 0>``, ``void
    a2m::cnx_bwd::reduce_kernel(...)`` -> ``reduce_kernel``; the casts
    cu++filt writes into template arguments go first."""
    for cast, plain in (("(bool)0", "false"), ("(bool)1", "true"), ("(int)", "")):
        name = name.replace(cast, plain)
    hit = re.search(r"[A-Za-z_]\w*<[^()]*>", name) or re.search(r"[A-Za-z_]\w*(?=\()", name)
    return hit.group(0) if hit else name


# The stage kernels' row kernels: kernel 20's four (conv_ln_kernel<T, true>
# among them), kernel 19's (conv_ln_tile_kernel; conv_ln_kernel<T, false>
# before it).
STAGE_ROW_KERNELS = ("conv_ln_kernel", "ln_bwd_kernel", "conv_bwd_kernel", "reduce_kernel",
                     "conv_ln_tile_kernel")
KERNELS_OF_INTEREST = ("global_attention", "rope_attention", "gemm_kernel",
                       "local_two_phase_grads", "local_two_phase_fwd_kernel",
                       "local_two_phase_kernel", "local_two_phase_rw_kernel",
                       "global_core_kernel", "rope_rows_kernel", "eventize_kernel",
                       *STAGE_ROW_KERNELS)
# The kernels (by the start of their demangled names) that both trees build
# whose SASS must be the other tree's: those of kernels 1, 3, 4, 15, 9, 16
# (and 10, which runs kernel 1's body after the RoPE pass), the tensor-core
# products of kernels 20 and 19 and of the fused layers (mma_gemm_kernel),
# kernels 20's and 19's row kernels, the local forward (2, 12, 5) and
# backward (7, 13, 8), and the fused layers' global core and RoPE pass
# (rope_rows_kernel, which kernel 10 launches too).  An instantiation that
# only one tree builds (kernel 10's scalar body, rope_attention_kernel) has
# nothing to be compared with: it is reported as new or gone.
SAME_SASS = ("global_attention", "rope_attention", "mma_gemm_kernel", "local_two_phase_grads",
             "local_two_phase_fwd_kernel", "global_core_kernel", "rope_rows_kernel",
             *STAGE_ROW_KERNELS)
# The local forward's kernel, in this tree and in trees before their
# redesigns (the scalar bodies: local_two_phase_kernel, and kernel 6's
# local_two_phase_rw_kernel).
LOCAL_FORWARD_KERNEL = r"local_two_phase(_fwd|_rw)?_kernel<"
# The fused layers' cases (kernels 11, 18, 17) and the serving routes.
FUSED_CASES = ("attention block", "fused", "transformer pair")
# The serving routes: attention_impl, and "pallas_stage" for attention_impl
# "pallas" with cnn_impl "pallas_stage".
SERVING_ROUTES = ("pallas", "pallas_block", "pallas_fused", "pallas_pair", "pallas_stage")
# The cases whose kernels torch.profiler times launch by launch.
PROFILED = ("grads S=250", "grads prng S=250", "local grads P=256", "local grads bits P=256",
            "local grads prng P=256")


def sass_counts(library: Path) -> dict[str, dict]:
    """Per kernel of interest in ``library``: its tensor-core products
    (HMMA), asynchronous copies (LDGSTS), ldmatrix loads (LDSM), fp32 FMAs
    (FFMA) and atomics (ATOM / RED), counted in the SASS that cuobjdump
    prints, and the sorted SHA-256s of that SASS (``sha256``), one per
    object that compiles the kernel (a template instantiated in two sources,
    as rope_rows_kernel is since kernel 10 launches it too, has two)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    ops = ("HMMA", "LDGSTS", "LDSM", "FFMA")
    counts, texts, name = {}, {}, None
    for line in sass.splitlines():
        if line.startswith("Fatbin"):
            # The next object's header: it ends the function before it, whose
            # text would otherwise depend on which objects follow in the library.
            name = None
        elif "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if any(k in name for k in KERNELS_OF_INTEREST) else None
            if name:
                counts[name] = {op: 0 for op in (*ops, "ATOM/RED")}
                texts.setdefault(name, []).append(hashlib.sha256())
        elif name:
            if ";" in line:  # an instruction: not the separators after an object's last function
                texts[name][-1].update(line.encode())
            for op in ops:
                counts[name][op] += f" {op}." in line or f" {op} " in line
            counts[name]["ATOM/RED"] += any(f" {op}" in line for op in ("ATOM", "RED."))
    for key in counts:
        counts[key]["sha256"] = sorted({h.hexdigest() for h in texts[key]})
    return dict(zip(map(short, demangle(list(counts))), counts.values()))


def library_of(root: Path) -> Path:
    """The kernel library that ``root``'s own build step writes."""
    spec = importlib.util.spec_from_file_location(
        f"cuda_build_{abs(hash(root))}", root / "audio_to_midi_tpu_torch" / "ops" / "cuda_build.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.library_path()


def ptxas_usage(log: Path) -> dict[str, dict[str, int]]:
    """Registers and spill bytes per kernel of interest, from the build
    log's ``-Xptxas -v`` lines."""
    usage, name = {}, None
    for line in log.read_text().splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1) if any(k in hit.group(1) for k in KERNELS_OF_INTEREST) else None
            if name:
                usage[name] = {}
        elif name:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                usage[name] |= {"spill_stores": int(spill[1]), "spill_loads": int(spill[2])}
            if regs:
                usage[name]["registers"] = int(regs[1])
    return dict(zip(map(short, demangle(list(usage))), usage.values()))


def build(root: Path) -> subprocess.Popen:
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            "from audio_to_midi_tpu_torch.ops import cuda_build; cuda_build.build()")
    return subprocess.Popen([sys.executable, "-c", code])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="a checkout of another commit")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "smoke")
    ap.add_argument("--cases", nargs="+", help="only the kernel cases with these prefixes")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.cases)
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
    library = library_of(ROOT)
    try:
        sass, other_sass = sass_counts(library), sass_counts(library_of(trees["other"]))
    except (OSError, subprocess.CalledProcessError) as err:
        print(f"sass not counted: {err}")
        sass, other_sass = {}, {}
    usage = ptxas_usage(library.with_suffix(".log"))
    for kernel in sorted(set(sass) | set(usage)):
        print(f"{kernel}: sass {sass.get(kernel)}; ptxas {usage.get(kernel)}")
    # The SASS of the kernels that share the product's primitives, tree by tree.
    failed = []
    for kernel in sorted(k for k in set(sass) & set(other_sass) if k.startswith(SAME_SASS)):
        # Every object's SASS of the other tree is still built; an object
        # that only this tree has may compile it otherwise.
        same = set(other_sass[kernel]["sha256"]) <= set(sass[kernel]["sha256"])
        extra = len(set(sass[kernel]["sha256"]) - set(other_sass[kernel]["sha256"]))
        print(f"sass {kernel}: identical to the other tree {same} (must be)"
              + (f"; {extra} other compilation(s) in this tree" if extra else ""))
        if not same:
            failed.append(f"sass {kernel}")
    for kernel in sorted(set(sass) ^ set(other_sass)):
        print(f"sass {kernel}: {'new in this tree' if kernel in sass else 'gone from this tree'}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    turns = {"other": [], "this": []}
    for label in ("other", "this", "this", "other"):
        run = subprocess.run([sys.executable, __file__, "--worker", str(trees[label]),
                              *(["--cases", *args.cases] if args.cases else [])],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        turns[label].append(json.loads(run.stdout.strip().splitlines()[-1]))
    for case in sorted({c for t in turns["this"] + turns["other"] for c in t["times"]}, key=str):
        other = [t["times"].get(case) for t in turns["other"]]
        this = [t["times"].get(case) for t in turns["this"]]
        if None in other + this:  # the profiler recorded no such kernel in a turn
            print(f"{case}: other {other} ms; this {this} ms; not recorded in every turn")
            continue
        print(f"{case}: other {other[0]:.4f}, {other[1]:.4f} ms; this {this[0]:.4f}, "
              f"{this[1]:.4f} ms; other / this {sum(other) / sum(this):.2f}")
    for case in turns["this"][0]["serving"]:
        shown = {label: ", ".join(f"{t['serving'][case]['median']:.2f} "
                                  f"({t['serving'][case]['q1']:.2f}-{t['serving'][case]['q3']:.2f})"
                                  for t in turns[label]) for label in turns}
        print(f"{case}, ms per forward, median (quartiles) of 20: other {shown['other']}; "
              f"this {shown['this']}")
        for label in turns:
            for t in turns[label]:
                r = t["serving"][case]
                print(f"  {label}: device busy {r['device_busy_ms']:.2f} ms per forward, idle "
                      f"share {r['idle_share']:.3f}, global attention {r['global_attention_ms']:.2f}"
                      f" ms ({r['global_attention_share']:.1%} of device time), local attention "
                      f"{r['local_attention_ms']:.2f} ms ({r['local_attention_share']:.1%}), fused "
                      f"layers {r['fused_layers_ms']:.2f} ms ({r['fused_layers_share']:.1%}); "
                      "largest " + ", ".join(f"{k[:60]} {v:.1%}" for k, v in r["top_kernels"]))
    # The bits: each tree's two turns agree with themselves, and the trees
    # agree where their device code is the same.
    bits = {}
    for case in sorted(turns["this"][0]["digests"]):
        hashes = {label: {t["digests"].get(case) for t in turns[label]} for label in turns}
        repeat = all(len(h) == 1 for h in hashes.values())
        same = repeat and hashes["this"] == hashes["other"]
        bits[case] = {"repeats": repeat, "same_as_other": same}
        must = case.startswith(SAME_CODE)
        print(f"bits {case}: each tree repeats {repeat}; identical to the other tree {same}"
              + (" (same device code: must be)" if must else ""))
        if not repeat or (must and not same):
            failed.append(case)
    # Kernel 10 runs kernel 1's body on the roped rows in this tree.
    rope, after_rope = ROPE_AS_KERNEL_1
    for case in sorted(c for c in turns["this"][0]["digests"] if c.startswith(rope)):
        same = all(t["digests"][case] == t["digests"].get(after_rope + case[len(rope):])
                   for t in turns["this"])
        print(f"bits {case}: kernel 1's bits on the roped rows {same} (must be)")
        if not same:
            failed.append(case)
    # Kernel 6 runs kernel 2's body in this tree: the same bits on the same tensors.
    rw, local = RW_AS_KERNEL_2
    for case in sorted(c for c in turns["this"][0]["digests"] if c.startswith(rw)):
        same = all(t["digests"][case] == t["digests"].get(local + case[len(rw):])
                   for t in turns["this"])
        print(f"bits {case}: kernel 2's bits on the same tensors {same} (must be)")
        if not same:
            failed.append(case)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "attention_turns.json").write_text(json.dumps(
        {"card": card, "other": str(args.other), "turns": turns, "bits": bits, "sass": sass,
         "other_sass": other_sass, "ptxas": usage}, indent=1))
    if failed:
        print(f"different bits or SASS where the device code must be the same, or a tree "
              f"that does not repeat itself: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
